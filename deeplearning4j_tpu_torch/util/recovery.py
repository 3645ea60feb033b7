"""Failure recovery: checkpointed training that survives preemption
(counterpart of the JAX package's ``util/recovery.py``).

Atomic rolling checkpoints (params + updater state + counters, the
checkpoint zip) and a ``fit`` wrapper that resumes from the newest one,
skipping completed epochs.

Exactness contract: for a SEEKABLE data source (the ``state()``/
``restore()`` cursor protocol — see ``util.durable``),
``RecoverableTrainer`` also writes mid-epoch
:class:`~deeplearning4j_tpu_torch.util.durable.TrainingState` snapshots
that carry the data-source cursor, and resume is bit-exact AT ANY STEP:
the restored run replays zero batches, skips none, and reproduces the
uninterrupted run's loss trajectory and final params bit for bit. The
``periodic_*``/``checkpoint_*`` zips are still written; non-seekable
sources fall back to epoch-boundary resume. A recovery point that
validates but fails to load falls back to the next older one, across
kinds.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional

from . import faults as _faults
from .serialization import (CheckpointInvalid, load_model, save_model,
                            verify_checkpoint)

logger = logging.getLogger("deeplearning4j_tpu_torch")

_KIND_RES = {
    "boundary": re.compile(r"^checkpoint_epoch(\d+)_iter(\d+)\.zip$"),
    "periodic": re.compile(r"^periodic_epoch(\d+)_iter(\d+)\.zip$"),
}


class CheckpointRecovery:
    """Rolling checkpoint store in one directory (single writer).

    ``latest()`` picks the newest checkpoint by (epoch, iteration);
    ``restore()`` / ``latest_valid()`` additionally validate integrity
    (zip CRC + sha256 manifest) and fall back to the newest VALID one, so
    a corrupt or truncated latest never blocks recovery. ``save(net)``
    writes atomically (tmp + rename) and prunes each kind to ``keep``
    newest — a crash mid-write never corrupts a recovery point. Stale
    ``.tmp_*``/``.wip_*`` files from crashed writers are swept on
    construction (the directory has one writer at a time by contract).
    """

    def __init__(self, directory: str, keep: int = 2, device="cuda"):
        self.directory = directory
        self.keep = max(1, int(keep))
        self.device = device        # where restore() builds the network
        os.makedirs(directory, exist_ok=True)
        for name in os.listdir(directory):
            if name.startswith((".tmp_", ".wip_")):
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:
                    pass

    def _checkpoints(self, kind: str) -> List[str]:
        rx = _KIND_RES[kind]
        out = [n for n in os.listdir(self.directory) if rx.match(n)]
        out.sort(key=lambda n: tuple(map(int, rx.match(n).groups())))
        return out

    def latest(self, kind: str = "boundary") -> Optional[str]:
        cps = self._checkpoints(kind)
        return os.path.join(self.directory, cps[-1]) if cps else None

    def latest_valid(self, kind: str = "boundary") -> Optional[str]:
        """Newest checkpoint that passes integrity validation (zip CRC +
        checksum manifest). Invalid files — truncated by a torn write,
        flipped bytes, empty — are skipped with a warning, so a corrupt
        latest never blocks recovery while an older valid point exists."""
        for name in reversed(self._checkpoints(kind)):
            path = os.path.join(self.directory, name)
            try:
                verify_checkpoint(path)
                return path
            except CheckpointInvalid as e:
                logger.warning(
                    "skipping corrupt checkpoint %s (%s) — falling back "
                    "to the previous one", path, e)
        return None

    def save(self, net, kind: str = "boundary") -> str:
        prefix = "checkpoint" if kind == "boundary" else "periodic"
        name = (f"{prefix}_epoch{net.epoch_count}"
                f"_iter{net.iteration_count}.zip")
        final = os.path.join(self.directory, name)
        tmp = os.path.join(self.directory, f".tmp_{os.getpid()}_{name}")
        save_model(net, tmp, save_updater=True)
        os.replace(tmp, final)
        for stale in self._checkpoints(kind)[:-self.keep]:
            try:
                os.remove(os.path.join(self.directory, stale))
            except OSError:
                pass
        return final

    def restore(self, kind: str = "boundary"):
        """Newest VALID checkpointed model of the given kind, or None.
        Corrupt/truncated checkpoints are skipped (see
        :meth:`latest_valid`); a checkpoint that validates but still fails
        to load falls back to the next older one the same way."""
        for name in reversed(self._checkpoints(kind)):
            path = os.path.join(self.directory, name)
            try:
                verify_checkpoint(path)
                _faults.check("recovery.restore", {"path": path})
                return load_model(path, device=self.device)
            except Exception as e:
                logger.warning(
                    "checkpoint %s unusable (%s: %s) — falling back to "
                    "the previous one", path, type(e).__name__, e)
        return None


class RecoverableTrainer:
    """``fit`` with automatic resume: restores the newest recovery point on construction, then
    trains the remaining epochs, checkpointing every ``frequency``
    iterations and at each epoch end.

    Recovery points, newest-wins: durable ``state_*`` snapshots
    (``util.durable.TrainingState`` — params + updater + RNG counters +
    data cursor; exact at any step) and legacy epoch-boundary
    ``checkpoint_*`` zips. A mid-epoch snapshot resumes EXACTLY when
    ``fit`` is then given a seekable data source: the cursor is restored
    and the partial epoch continues from the precise batch where the
    process died."""

    def __init__(self, net, checkpoint_dir: str, *, frequency: int = 100,
                 keep: int = 2):
        from . import durable as _durable
        device = getattr(net, "device", "cuda")
        self.recovery = CheckpointRecovery(checkpoint_dir, keep=keep,
                                           device=device)
        self.store = _durable.CheckpointStore(checkpoint_dir, keep=keep,
                                              device=device)
        self._resume_cursor: Optional[dict] = None
        restored = None
        # every candidate, newest-wins by the (epoch, iteration) in its
        # NAME (no model deserialization just to compare recency; durable
        # snapshots win ties — they carry the cursor). A candidate that
        # validates but fails to load falls back to the next older one
        # ACROSS kinds — never silently past a newer valid snapshot.
        for _, kind, path in self._recovery_points():
            try:
                if kind == "durable":
                    loaded = self.store.load(path)
                    restored = loaded.net
                    self._resume_cursor = loaded.cursor
                else:
                    verify_checkpoint(path)
                    _faults.check("recovery.restore", {"path": path})
                    restored = load_model(path, device=device)
                break
            except Exception as e:
                self._resume_cursor = None
                logger.warning(
                    "recovery point %s unusable (%s: %s) — falling back "
                    "to the next older one", path, type(e).__name__, e)
        if restored is not None:
            net = restored
        self.net = net
        self.frequency = max(1, int(frequency))
        self.resumed = restored is not None

    def _recovery_points(self) -> List[tuple]:
        """All recovery points in the directory, newest first:
        ``((epoch, iter, durable?), kind, path)`` for durable ``state_*``
        snapshot dirs and legacy boundary ``checkpoint_*`` zips."""
        from . import durable as _durable
        points = []
        for name in self.store.snapshots():
            m = _durable._STATE_RE.match(name)
            points.append(((int(m.group(1)), int(m.group(2)), 1),
                           "durable",
                           os.path.join(self.store.directory, name)))
        for name in self.recovery._checkpoints("boundary"):
            e, i = self._parse(name)
            points.append(((e, i, 0), "legacy",
                           os.path.join(self.recovery.directory, name)))
        points.sort(reverse=True)
        return points

    @staticmethod
    def _parse(path: str) -> tuple:
        m = _KIND_RES["boundary"].match(os.path.basename(path))
        return tuple(map(int, m.groups())) if m else (-1, -1)

    def fit(self, data, labels=None, *, epochs: int = 1, mask=None):
        """Train until ``epochs`` TOTAL epochs are recorded on the model
        (a resumed model with epoch_count >= epochs trains zero epochs).
        A mid-epoch resume restores the data cursor first — the source
        must then be seekable (every in-tree iterator is)."""
        from . import durable as _durable
        net = self.net
        kwargs = _durable.mask_fit_kwargs(net, mask)
        resumed_mid = self._resume_cursor is not None
        if resumed_mid:
            if not _durable.is_seekable(data):
                raise ValueError(
                    "resuming a mid-epoch snapshot needs a seekable data "
                    f"source (state()/restore()) — got "
                    f"{type(data).__name__}")
            data.restore(self._resume_cursor)
            self._resume_cursor = None
        hook = _CheckpointListener(self.recovery, net, self.frequency)
        net.add_listener(hook)
        seekable = _durable.is_seekable(data)
        writer = (_durable.AsyncCheckpointWriter(self.store)
                  if seekable else None)
        try:
            while net.epoch_count < epochs:
                if seekable:
                    # exact mid-epoch recovery points (cursor-carrying
                    # TrainingState snapshots) ride along with the legacy
                    # periodic zips, written off the critical path
                    kwargs["session"] = _durable.DurableSession(
                        net, self.store, data=data,
                        frequency=self.frequency, writer=writer,
                        resuming=resumed_mid)
                    resumed_mid = False
                net.fit(data, labels, epochs=1, **kwargs)
                self.recovery.save(net, kind="boundary")
                if hasattr(data, "reset"):
                    data.reset()
        finally:
            net.listeners.remove(hook)
            if writer is not None:
                writer.close()
        return net


class _CheckpointListener:
    """TrainingListener shim writing a checkpoint every N iterations."""

    def __init__(self, recovery: CheckpointRecovery, net, frequency: int):
        self.recovery = recovery
        self.net = net
        self.frequency = frequency

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.frequency == 0:
            self.recovery.save(self.net, kind="periodic")

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass

    def on_forward_pass(self, model, activations) -> None:
        pass

    def on_gradient_calculation(self, model) -> None:
        pass

    def on_backward_pass(self, model) -> None:
        pass
