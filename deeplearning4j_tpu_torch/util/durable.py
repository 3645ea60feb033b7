"""Durable training: any ``fit()`` is killable at any step and resumable
bit-exactly (counterpart of the JAX package's ``util/durable.py``).

- :class:`TrainingState` — a versioned snapshot of everything a step
  depends on: params (the f32 masters), updater state, layer state (BN
  statistics), the iteration/epoch/update counters the step generators
  derive from (``named_generator(seed, f"update_{n}")``), and the
  data-source cursor (the ``state()``/``restore()`` seekable protocol of
  the in-tree iterators and the sharded-record pipeline). Restoring a
  snapshot replays zero batches and skips none. ``capture`` clones the
  tensors on the card, on the step's stream, and records an event after
  the clones; the writer thread waits on that event before it copies
  anything to the host, on a stream of its own.
- :class:`CheckpointStore` — multi-file snapshot directories committed
  atomically, in the reference's layout: ``model.zip`` and
  ``cursor.json`` (the same keys) land in a ``.wipstate_*`` directory, a
  ``COMMIT`` marker carrying the sha256 manifest is written LAST, and only
  then does the directory rename to ``state_epoch{E}_iter{I}``;
  ``STATE_VERSION = 1``. A snapshot written by either package resumes in
  the other: validation goes through the manifest. The ``digest`` in
  ``cursor.json`` is each package's own (the reference hashes jax's
  treedef string), and no load compares digests across packages.
- :class:`AsyncCheckpointWriter` — a single-outstanding background
  writer (``would_drop`` lets a caller skip the device copy of a
  snapshot that would be dropped); ``checkpoint_write_seconds`` /
  ``checkpoint_commits_total`` land in the metrics registry.
- :class:`PreemptionHandler` — SIGTERM/SIGINT set a drain flag; the fit
  loop finishes the in-flight window, writes a final snapshot and
  returns. A second signal aborts.
- :class:`StepWatchdog` — a no-progress deadline around dispatch/ingest:
  on expiry it dumps queue depths, breaker states and the active span,
  raises :class:`WatchdogTimeout`, and interrupts a hung main thread
  (the in-flight window polls its events, so the interrupt lands).
- :class:`DurableSession` / :class:`DurableTrainer` — the wiring into
  ``util.ingest.run_fit_loop`` and the resume-on-construction trainer.
  On multi-process runs (``torch.distributed`` initialised with more than
  one rank) every rank must agree on the step digest before a commit
  publishes.

The fit loop's ``"training.step"`` fault seam lets tests kill at exact
step boundaries (raise, ``os._exit``, or self-SIGTERM).
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import queue
import re
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from . import faults as _faults
from . import flightrecorder as _flight
from . import metrics as _metrics
from .resilience import SYSTEM_CLOCK, Clock
from .serialization import (CheckpointInvalid, _flatten,
                            _write_file_atomic, load_model, save_model,
                            verify_checkpoint)

logger = logging.getLogger("deeplearning4j_tpu_torch")

STATE_VERSION = 1

# Set by an expiring StepWatchdog just before it interrupts the main
# thread; consumed by PreemptionHandler._handle so the simulated SIGINT
# unwinds the hung dispatch (KeyboardInterrupt) instead of being absorbed
# as a graceful-drain request that a hung loop can never observe.
_WATCHDOG_INTERRUPT = threading.Event()

_MODEL_ENTRY = "model.zip"
_CURSOR_ENTRY = "cursor.json"
_COMMIT_ENTRY = "COMMIT"
_STATE_RE = re.compile(r"^state_epoch(\d+)_iter(\d+)$")


# ----------------------------------------------------------------------
# seekable protocol
# ----------------------------------------------------------------------

def is_seekable(source: Any) -> bool:
    """True when ``source`` implements the cursor protocol
    (``state() -> dict`` / ``restore(state)``) — required for exact
    mid-epoch resume. The in-tree dataset/datavec iterators and the Async
    wrappers all do. A source may veto via a ``seekable()`` method (the
    Async wrapper does, when its BASE has no cursor)."""
    probe = getattr(source, "seekable", None)
    if callable(probe):
        try:
            if not probe():
                return False
        except Exception:
            return False
    return (callable(getattr(source, "state", None))
            and callable(getattr(source, "restore", None)))


def mask_fit_kwargs(net, mask) -> dict:
    """Validate the optional ``mask`` kwarg against the runtime's fit
    signature (ComputationGraph.fit has none — masks ride in DataSet
    batches) and return it in kwargs form. Shared by the durable and
    recoverable trainers."""
    if mask is None:
        return {}
    import inspect
    if "mask" not in inspect.signature(net.fit).parameters:
        raise ValueError(
            "mask kwarg is only supported for MultiLayerNetwork; "
            "pass masks via DataSet batches for graphs")
    return {"mask": mask}


# ----------------------------------------------------------------------
# digests
# ----------------------------------------------------------------------

def _sha256_file(path: str, chunk: int = 1 << 26) -> str:
    """sha256 of a file in fixed-size chunks — a multi-GB model artifact
    must never be slurped into RAM just to hash it. The chunks are large
    because each one hands the GIL back and forth: on a writer thread,
    every reacquisition can stall a training loop that dispatches from the
    main thread."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def _leaves(tree, prefix: str) -> List[tuple]:
    out: Dict[str, Any] = {}
    _flatten(prefix, tree, out)
    return sorted(out.items())


def _on_helper(fn, *args):
    """Start ``fn(*args)`` on a helper thread; returns a callable that
    waits for it and gives its result (or raises its exception)."""
    box: Dict[str, Any] = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:      # re-raised on the caller
            box["error"] = e
    t = threading.Thread(target=run, name="durable-helper", daemon=True)
    t.start()

    def result():
        t.join()
        if "error" in box:
            raise box["error"]
        return box.get("value")
    return result


def params_digest(params, updater_state=None, update_count: int = 0) -> str:
    """sha256 over every parameter and updater leaf in sorted path order
    (dtype, shape and the values widened to f32 bytes), after the update
    counter — the value all ranks must agree on before a multi-process
    commit, and the served model's digest (``serving/server.py``)."""
    h = hashlib.sha256()
    h.update(str(int(update_count)).encode())
    for prefix, tree in (("params", params), ("updater", updater_state)):
        if tree is None:
            continue
        for key, t in _leaves(tree, prefix):
            t = torch.as_tensor(t).detach().cpu()
            h.update(f"{key}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.float().contiguous().numpy())
    return h.hexdigest()


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def agree_on_digest(digest: str) -> bool:
    """True when every rank of the default process group presents the
    same ``digest`` (a collective: every rank must call it)."""
    got: List[Optional[str]] = [None] * _world_size()
    torch.distributed.all_gather_object(got, digest)
    return all(d == digest for d in got)


def default_commit_gate() -> Callable[[str], bool]:
    """The pre-commit agreement check: single-process runs always pass;
    multi-process runs require every rank to present the same digest."""
    def gate(digest: str) -> bool:
        return _world_size() == 1 or agree_on_digest(digest)
    return gate


# ----------------------------------------------------------------------
# metric families
# ----------------------------------------------------------------------

_WRITE_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                  5.0, 10.0, 30.0)


def _reg(registry=None) -> _metrics.MetricsRegistry:
    return registry if registry is not None else _metrics.REGISTRY


def write_seconds_histogram(registry=None) -> _metrics.Histogram:
    return _reg(registry).histogram(
        "checkpoint_write_seconds",
        "Wall time of one TrainingState write (device-to-host copy + "
        "serialize + fsync + commit), off the critical path",
        buckets=_WRITE_BUCKETS)


def commits_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "checkpoint_commits_total",
        "TrainingState snapshots committed (COMMIT marker renamed into "
        "place)", ("kind",))


def skipped_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "checkpoint_writes_skipped_total",
        "Snapshot submissions dropped because a write was already "
        "outstanding (single-outstanding writer)")


def failures_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "checkpoint_write_failures_total",
        "TrainingState writes that raised (training continues; the "
        "previous valid snapshot remains the recovery point)")


# ----------------------------------------------------------------------
# TrainingState
# ----------------------------------------------------------------------

def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().clone()
    return tree


# a snapshot's device-to-host copies go through two pinned slots of this
# many bytes (:func:`_to_host`)
_HOST_SLOT_BYTES = 64 << 20


def _host_leaves(tree, pieces: list):
    """``tree`` with every tensor replaced by an empty pageable host tensor
    of its shape; appends each (device bytes, host bytes) pair of flat
    views to ``pieces``."""
    if isinstance(tree, dict):
        return {k: _host_leaves(v, pieces) for k, v in tree.items()}
    if torch.is_tensor(tree):
        src = tree.detach()
        out = torch.empty(src.shape, dtype=src.dtype, device="cpu")
        if src.numel():
            pieces.append((src.contiguous().reshape(-1).view(torch.uint8),
                           out.reshape(-1).view(torch.uint8)))
        return out
    return tree


def _land(landing: list, k: int) -> None:
    """Wait for slot ``k``'s copies from the device, then move its bytes to
    their host tensors."""
    if landing[k] is None:
        return
    from .ingest import wait_event
    event, outs = landing[k]
    landing[k] = None
    wait_event(event)
    for dst, src in outs:
        dst.copy_(src)


def _to_host(trees: tuple, device) -> list:
    """Host copies of the device tensors of ``trees`` (a capture's clones).
    The bytes go through two pinned slots on a stream of this thread's
    own: a slot's copy from the device is an asynchronous DMA this thread
    polls for (``ingest.wait_event``), and its bytes then move into
    pageable host memory by a host copy while the other slot's DMA runs.
    A copy from the device straight into pageable memory stays inside the
    CUDA driver for its whole length, and the training thread's kernel
    launches wait behind it (PERF.md §6)."""
    pieces: list = []
    host = [_host_leaves(t, pieces) for t in trees]
    stream = torch.cuda.Stream(device)
    slots = [torch.empty(_HOST_SLOT_BYTES, dtype=torch.uint8,
                         pin_memory=True) for _ in range(2)]
    landing: list = [None, None]     # per slot: (event, [(host, pinned)])
    k, off, outs = 0, 0, []
    for i, (src, dst) in enumerate(pieces):
        pos = 0
        while pos < src.numel():
            n = min(src.numel() - pos, _HOST_SLOT_BYTES - off)
            view = slots[k][off:off + n]
            with torch.cuda.stream(stream):
                view.copy_(src[pos:pos + n], non_blocking=True)
            outs.append((dst[pos:pos + n], view))
            off += n
            pos += n
            if off == _HOST_SLOT_BYTES or (i == len(pieces) - 1
                                           and pos == src.numel()):
                event = torch.cuda.Event()
                event.record(stream)
                landing[k] = (event, outs)
                k, off, outs = 1 - k, 0, []
                _land(landing, k)   # the next slot's bytes are out
    _land(landing, 1 - k)
    return host


class TrainingState:
    """One resumable instant of a training run.

    ``capture()`` clones the param/updater/layer-state tensors ON THE
    DEVICE, on the current (the step's) stream, and records an event
    after the clones: the next step updates the live tensors in place,
    so a background writer must never read them. ``to_host()`` — on
    whatever thread writes — waits for that event and copies the clones
    to the host on a stream of its own, so the copy overlaps the steps
    that follow instead of queueing behind them.
    """

    __slots__ = ("model_class", "conf", "params", "layer_state",
                 "updater_state", "iteration_count", "epoch_count",
                 "update_count", "seed", "cursor", "kind", "event",
                 "device")

    def __init__(self, *, model_class, conf, params, layer_state,
                 updater_state, iteration_count, epoch_count, update_count,
                 seed, cursor, kind="step", event=None, device=None):
        self.model_class = model_class
        self.conf = conf
        self.params = params
        self.layer_state = layer_state
        self.updater_state = updater_state
        self.iteration_count = int(iteration_count)
        self.epoch_count = int(epoch_count)
        self.update_count = int(update_count)
        self.seed = seed
        self.cursor = cursor
        self.kind = kind
        self.event = event
        self.device = device

    @classmethod
    def capture(cls, net, *, cursor: Optional[dict] = None,
                kind: str = "step") -> "TrainingState":
        device = torch.device(getattr(net, "device", "cpu"))
        event = None
        params = _clone_tree(net.params)
        layer_state = _clone_tree(net.state)
        updater_state = _clone_tree(net.updater_state)
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        return cls(
            model_class=type(net).__name__, conf=net.conf,
            params=params, layer_state=layer_state,
            updater_state=updater_state,
            iteration_count=getattr(net, "iteration_count", 0),
            epoch_count=getattr(net, "epoch_count", 0),
            update_count=getattr(net, "_update_count", 0),
            seed=getattr(net.training, "seed", 0), cursor=cursor, kind=kind,
            event=event, device=device)

    @property
    def name(self) -> str:
        return f"state_epoch{self.epoch_count}_iter{self.iteration_count}"

    def to_host(self) -> None:
        """Replace the device clones by host copies (idempotent)."""
        if self.event is None:
            return
        from .ingest import wait_event
        wait_event(self.event)
        self.params, self.layer_state, self.updater_state = _to_host(
            (self.params, self.layer_state, self.updater_state), self.device)
        self.event = None

    def _shim(self):
        """Duck-typed stand-in ``save_model`` accepts."""
        class _Snapshot:
            pass
        s = _Snapshot()
        s.conf = self.conf
        s.params = self.params
        s.state = self.layer_state
        s.updater_state = self.updater_state
        s.iteration_count = self.iteration_count
        s.epoch_count = self.epoch_count
        s._update_count = self.update_count
        return s

    def digest(self) -> str:
        self.to_host()
        return params_digest(self.params, self.updater_state,
                             self.update_count)


class LoadedState(NamedTuple):
    net: Any
    cursor: Optional[dict]
    epoch_count: int
    iteration_count: int
    update_count: int
    digest: str
    path: str


# ----------------------------------------------------------------------
# CheckpointStore: the atomic multi-file commit protocol
# ----------------------------------------------------------------------

class CheckpointStore:
    """Rolling TrainingState snapshots in one directory (single writer).

    ``load`` builds the network on ``device`` (``"cuda"`` by default).

    Commit protocol: every file of a snapshot (``model.zip``,
    ``cursor.json``) is written inside a ``.wipstate_*`` staging dir; the
    ``COMMIT`` marker — a sha256 manifest of the other files — is written
    last; only then does the staging dir rename to its final
    ``state_epoch{E}_iter{I}`` name. A reader therefore never sees a torn
    multi-file state: either the rename happened (and the manifest proves
    every file complete) or the snapshot does not exist. Stale staging
    dirs from crashed writers are swept on construction.
    """

    def __init__(self, directory: str, keep: int = 2, device="cuda"):
        self.directory = directory
        self.keep = max(1, int(keep))
        self.device = device        # where load() builds the network
        os.makedirs(directory, exist_ok=True)
        for name in os.listdir(directory):
            if name.startswith(".wipstate_"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    # -- enumeration ---------------------------------------------------

    def snapshots(self) -> List[str]:
        out = [n for n in os.listdir(self.directory) if _STATE_RE.match(n)]
        out.sort(key=lambda n: tuple(map(int, _STATE_RE.match(n).groups())))
        return out

    def latest_valid(self) -> Optional[str]:
        for name in reversed(self.snapshots()):
            path = os.path.join(self.directory, name)
            try:
                self.validate(path)
                return path
            except CheckpointInvalid as e:
                logger.warning(
                    "skipping torn/invalid snapshot %s (%s) — falling "
                    "back to the previous one", path, e)
        return None

    # -- validation ----------------------------------------------------

    def _manifest(self, path: str) -> dict:
        """The COMMIT marker's manifest, after the cheap checks (marker
        present and readable, version, both entries named)."""
        commit = os.path.join(path, _COMMIT_ENTRY)
        try:
            with open(commit, "r") as f:
                marker = json.load(f)
        except FileNotFoundError:
            raise CheckpointInvalid(f"{path}: no COMMIT marker "
                                    "(torn or in-progress write)")
        except Exception as e:
            raise CheckpointInvalid(
                f"{path}: unreadable COMMIT marker ({e})")
        if marker.get("version") != STATE_VERSION:
            raise CheckpointInvalid(
                f"{path}: unsupported state version "
                f"{marker.get('version')!r}")
        manifest = marker.get("manifest", {})
        for entry in (_MODEL_ENTRY, _CURSOR_ENTRY):
            if entry not in manifest:
                raise CheckpointInvalid(
                    f"{path}: COMMIT manifest missing {entry!r}")
        return manifest

    def _check_manifest(self, path: str, manifest: dict) -> None:
        for entry, want in manifest.items():
            fp = os.path.join(path, entry)
            try:
                got = _sha256_file(fp)
            except FileNotFoundError:
                raise CheckpointInvalid(
                    f"{path}: manifest names missing file {entry!r}")
            if got != want:
                raise CheckpointInvalid(
                    f"{path}: sha256 mismatch for {entry!r}")

    def validate(self, path: str) -> None:
        """Raise :class:`CheckpointInvalid` unless ``path`` is a fully
        committed, manifest-verified snapshot."""
        self._check_manifest(path, self._manifest(path))
        verify_checkpoint(os.path.join(path, _MODEL_ENTRY))

    # -- write ---------------------------------------------------------

    def save(self, state: TrainingState, *,
             commit_gate: Optional[Callable[[str], bool]] = None,
             registry=None) -> Optional[str]:
        """Serialize, manifest, gate, commit. Returns the committed path,
        or None when the commit gate refused (host digest disagreement)."""
        t0 = time.perf_counter()
        final = os.path.join(self.directory, state.name)
        if os.path.isdir(final):
            return final            # same step already committed
        wip = os.path.join(self.directory,
                           f".wipstate_{os.getpid()}_{state.name}")
        shutil.rmtree(wip, ignore_errors=True)
        os.makedirs(wip)
        try:
            # the host transfer happens HERE, on the writing thread
            state.to_host()
            digest = params_digest(state.params, state.updater_state,
                                   state.update_count)
            model_path = os.path.join(wip, _MODEL_ENTRY)
            save_model(state._shim(), model_path, save_updater=True,
                       model_class=state.model_class)
            cursor_doc = {
                "version": STATE_VERSION,
                "kind": state.kind,
                "model_class": state.model_class,
                "epoch_count": state.epoch_count,
                "iteration_count": state.iteration_count,
                "update_count": state.update_count,
                "cursor": state.cursor,
                "rng": {"seed": state.seed,
                        "update_count": state.update_count},
                "digest": digest,
            }
            cursor_path = os.path.join(wip, _CURSOR_ENTRY)
            _write_file_atomic(cursor_path,
                               json.dumps(cursor_doc, indent=2).encode())
            manifest = {}
            for entry in (_MODEL_ENTRY, _CURSOR_ENTRY):
                manifest[entry] = _sha256_file(os.path.join(wip, entry))
            gate = commit_gate
            if gate is not None and not gate(digest):
                logger.error(
                    "checkpoint %s NOT committed: hosts disagree on the "
                    "step digest — refusing to publish a diverged state",
                    state.name)
                return None
            # COMMIT marker last: its presence asserts every prior byte
            _write_file_atomic(
                os.path.join(wip, _COMMIT_ENTRY),
                json.dumps({"version": STATE_VERSION,
                            "manifest": manifest}, indent=2).encode())
            os.rename(wip, final)
        finally:
            shutil.rmtree(wip, ignore_errors=True)
        commits_counter(registry).inc(kind=state.kind)
        dt = time.perf_counter() - t0
        write_seconds_histogram(registry).observe(dt)
        _flight.record("checkpoint_commit", name=state.name,
                       snapshot_kind=state.kind,
                       write_seconds=round(dt, 4))
        for stale in self.snapshots()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, stale),
                          ignore_errors=True)
        return final

    # -- read ----------------------------------------------------------

    def load(self, path: str) -> LoadedState:
        """The snapshot at ``path``: the COMMIT manifest's hashes are
        checked on a helper thread while ``load_model`` reads the
        artifact (which verifies the artifact's own checksums as it
        goes, so it is not walked a third time); a torn or corrupt
        snapshot raises :class:`CheckpointInvalid`."""
        checked = _on_helper(self._check_manifest, path,
                             self._manifest(path))
        try:
            _faults.check("recovery.restore", {"path": path})
            with open(os.path.join(path, _CURSOR_ENTRY), "r") as f:
                doc = json.load(f)
            net = load_model(os.path.join(path, _MODEL_ENTRY),
                             device=self.device)
        except BaseException:
            checked()           # a failed manifest is the reason to give
            raise
        checked()
        return LoadedState(
            net=net, cursor=doc.get("cursor"),
            epoch_count=int(doc.get("epoch_count", 0)),
            iteration_count=int(doc.get("iteration_count", 0)),
            update_count=int(doc.get("update_count", 0)),
            digest=doc.get("digest", ""), path=path)

    def load_latest(self) -> Optional[LoadedState]:
        """Newest snapshot that validates AND loads; torn commits and
        corrupt artifacts fall back to the previous one."""
        for name in reversed(self.snapshots()):
            path = os.path.join(self.directory, name)
            try:
                return self.load(path)
            except Exception as e:
                logger.warning(
                    "snapshot %s unusable (%s: %s) — falling back to the "
                    "previous one", path, type(e).__name__, e)
        return None


# ----------------------------------------------------------------------
# AsyncCheckpointWriter
# ----------------------------------------------------------------------

class AsyncCheckpointWriter:
    """Single-outstanding background snapshot writer.

    ``submit(state)`` hands one captured :class:`TrainingState` to the
    writer thread and returns immediately; while a write is queued or in
    progress further submissions return False (and count into
    ``checkpoint_writes_skipped_total``) — checkpointing never queues up
    behind a slow filesystem. Write errors are logged and counted, never
    raised into the training loop; the previous valid snapshot remains
    the recovery point.

    Multi-process caveat: the commit gate is a COLLECTIVE
    (``all_gather_object``), so the busy-skip must not be a host-local
    decision — one slow host skipping while the others enter the
    collective would hang them. With a gate on a multi-process run,
    ``submit`` therefore WAITS for the outstanding write instead of
    skipping, keeping every host's attempt count identical.
    """

    def __init__(self, store: CheckpointStore, *,
                 commit_gate: Optional[Callable[[str], bool]] = None,
                 registry=None, collective: Optional[bool] = None):
        self.store = store
        self.commit_gate = commit_gate
        self.registry = registry
        if collective is None:
            collective = commit_gate is not None and _world_size() > 1
        self.collective = collective
        self.last_error: Optional[BaseException] = None
        self.last_path: Optional[str] = None
        self._q: "queue.Queue" = queue.Queue()
        self._busy = False
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._closed = False
        self._thread = threading.Thread(target=self._worker,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    def would_drop(self) -> bool:
        """True when ``submit()`` would busy-skip right now — callers can
        avoid paying ``TrainingState.capture`` (a whole-model device
        copy) for a snapshot that would be dropped. Counts the skip."""
        with self._lock:
            busy = self._busy and not self._closed
        if busy and not self.collective:
            skipped_counter(self.registry).inc()
            return True
        return False

    def submit(self, state: TrainingState) -> bool:
        while True:
            with self._lock:
                if self._closed:
                    raise RuntimeError("writer is closed")
                if not self._busy:
                    self._busy = True
                    break
            if not self.collective:
                skipped_counter(self.registry).inc()
                return False
            # every host must attempt every checkpoint (collective gate)
            if not self.drain(60.0):
                logger.warning(
                    "checkpoint write still outstanding after 60s — "
                    "waiting (collective commit gate forbids skipping)")
        self._q.put(state)
        return True

    def _worker(self) -> None:
        while True:
            state = self._q.get()
            if state is None:
                return
            try:
                self.last_path = self.store.save(
                    state, commit_gate=self.commit_gate,
                    registry=self.registry)
            except BaseException as e:
                self.last_error = e
                failures_counter(self.registry).inc()
                logger.error(
                    "async checkpoint write failed (%s: %s) — training "
                    "continues from the previous valid snapshot",
                    type(e).__name__, e)
            finally:
                with self._idle:
                    self._busy = False
                    self._idle.notify_all()

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait for the in-flight write (if any) to finish."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    def close(self, timeout: float = 60.0) -> None:
        self.drain(timeout)
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)
        self._thread.join(timeout=timeout)


# ----------------------------------------------------------------------
# StepWatchdog
# ----------------------------------------------------------------------

class WatchdogTimeout(RuntimeError):
    """No training progress within the deadline. ``dump`` carries the
    diagnostic snapshot taken at expiry."""

    def __init__(self, msg: str, dump: Optional[dict] = None):
        super().__init__(msg)
        self.dump = dump or {}


class StepWatchdog:
    """No-progress deadline around the dispatch/ingest loop.

    The fit loop calls ``pet()`` once per dispatched step (which also
    captures the active tracing span via the faults seam-context
    providers). If no pet arrives within ``deadline_s``, the watchdog
    builds a diagnostic dump — elapsed time, ingest queue depths, live
    circuit-breaker states, the span active at the last pet — logs it,
    and raises :class:`WatchdogTimeout` at the next ``pet()``/``check()``.
    With the monitor thread enabled (default when armed against the real
    clock) it ALSO interrupts the main thread, so a dispatch hung waiting
    on the card (the in-flight window polls its events) unwinds instead of
    hanging forever.
    """

    def __init__(self, deadline_s: float, *, clock: Clock = SYSTEM_CLOCK,
                 registry=None,
                 context_provider: Optional[Callable[[], dict]] = None,
                 on_timeout: Optional[Callable[[dict], None]] = None,
                 interrupt_main: bool = True,
                 poll_interval_s: Optional[float] = None,
                 thread: Optional[bool] = None):
        self.deadline_s = float(deadline_s)
        self.clock = clock
        self.registry = registry
        self.context_provider = (context_provider if context_provider
                                 is not None else _faults.seam_context)
        self.on_timeout = on_timeout
        self.interrupt_main = interrupt_main
        self.poll_interval_s = (poll_interval_s if poll_interval_s
                                is not None else max(0.05,
                                                     self.deadline_s / 4))
        # monitor thread defaults ON against the real clock (a hung
        # dispatch never calls pet() again, so only a thread can notice);
        # a test-injected manual clock advances synchronously, so expiry
        # is evaluated in pet()/check() instead
        self._use_thread = (clock is SYSTEM_CLOCK if thread is None
                            else thread)
        self._lock = threading.Lock()
        self._last: Optional[float] = None       # None = disarmed
        self._last_context: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_dump: Optional[dict] = None
        self._raised = False
        self._expiring = False

    # -- lifecycle -----------------------------------------------------

    def arm(self) -> None:
        with self._lock:
            self._last = self.clock.monotonic()
            self.last_dump = None
            self._raised = False
            self._expiring = False
        if self._use_thread and (self._thread is None
                                 or not self._thread.is_alive()):
            self._stop.clear()
            self._thread = threading.Thread(target=self._monitor,
                                            name="step-watchdog",
                                            daemon=True)
            self._thread.start()

    def disarm(self) -> None:
        with self._lock:
            self._last = None
        _WATCHDOG_INTERRUPT.clear()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StepWatchdog":
        self.arm()
        return self

    def __exit__(self, *exc) -> bool:
        self.disarm()
        return False

    # -- progress ------------------------------------------------------

    def pet(self) -> None:
        """Mark progress (raises first if the deadline already expired)."""
        self.check()
        ctx = {}
        try:
            ctx = self.context_provider() or {}
        except Exception:
            pass
        with self._lock:
            self._last = self.clock.monotonic()
            self._last_context = ctx

    def check(self) -> None:
        with self._lock:
            expired = (self._last is not None and not self._raised
                       and self.clock.monotonic() - self._last
                       >= self.deadline_s)
        if expired:
            self._expire()
        if self.last_dump is not None and not self._raised:
            self._raised = True
            raise WatchdogTimeout(
                f"no training progress for >= {self.deadline_s:.1f}s",
                self.last_dump)

    # -- expiry --------------------------------------------------------

    def dump(self) -> dict:
        """The diagnostic snapshot: elapsed, ingest queue depths, breaker
        states, and the span active at the last progress mark."""
        from . import resilience as _resilience
        with self._lock:
            elapsed = (None if self._last is None
                       else self.clock.monotonic() - self._last)
            ctx = dict(self._last_context)
        queues = {}
        g = _reg(self.registry).get("ingest_queue_depth")
        if g is not None:
            try:
                for s in g.snapshot().get("series", []):
                    queues[s["labels"].get("stage", "?")] = s["value"]
            except Exception:
                pass
        return {"deadline_s": self.deadline_s, "elapsed_s": elapsed,
                "queue_depths": queues,
                "breakers": _resilience.breaker_states(),
                "active_span": ctx.get("span"),
                # elastic fleets stamp {host, round, phase, waiting_on}
                # via their context provider, so a watchdog expiry names
                # the peer that stalled the sync round without reading
                # the flight-recorder dump
                "elastic": ctx.get("elastic"),
                "context": ctx}

    def _expire(self) -> None:
        # claim the expiry under the lock: the monitor thread and a
        # main-thread check() racing here must not both fire the
        # interrupt/on_timeout action
        with self._lock:
            if self._expiring or self.last_dump is not None:
                return
            self._expiring = True
        d = self.dump()
        self.last_dump = d
        logger.error(
            "step watchdog expired after %.1fs without progress — queue "
            "depths: %s, breakers: %s, active span: %s",
            self.deadline_s, d["queue_depths"], d["breakers"],
            d["active_span"])
        # the black-box path: a hung dispatch may never unwind, so the
        # ring is written to disk HERE, before any interrupt/raise — the
        # last train_step event in the dump names the step that hung
        _flight.record("watchdog_expired", deadline_s=self.deadline_s,
                       elapsed_s=d["elapsed_s"],
                       queue_depths=d["queue_depths"],
                       breakers=d["breakers"],
                       active_span=d["active_span"])
        _flight.dump(reason="watchdog_expired")
        if self.on_timeout is not None:
            try:
                self.on_timeout(d)
            except Exception:
                logger.exception("watchdog on_timeout hook failed")
        elif (self.interrupt_main and self._use_thread
              and threading.current_thread()
              is not threading.main_thread()):
            # monitor-thread expiry: interrupt the (possibly hung) main
            # thread. Synchronous expiry via pet()/check() skips this —
            # the caller's own raise unwinds, and a self-interrupt would
            # leave a stray KeyboardInterrupt pending for cleanup code.
            # A REAL signal (os.kill), not _thread.interrupt_main():
            # interrupt_main only sets the pending flag, which a main
            # thread blocked inside a C call (a hung device dispatch,
            # time.sleep) never reaches — the kernel-delivered SIGINT
            # EINTRs the blocking call so the handler actually runs
            # (pinned by the fork-and-kill hang test)
            _WATCHDOG_INTERRUPT.set()
            try:
                os.kill(os.getpid(), signal.SIGINT)
            except Exception:
                import _thread
                _thread.interrupt_main()

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            with self._lock:
                expired = (self._last is not None
                           and self.clock.monotonic() - self._last
                           >= self.deadline_s)
            if expired:
                self._expire()
                return


# ----------------------------------------------------------------------
# PreemptionHandler
# ----------------------------------------------------------------------

class PreemptionHandler:
    """SIGTERM/SIGINT → graceful drain flag.

    The first signal sets ``requested``; the fit loop notices at the next
    step boundary, drains the in-flight window, writes a final snapshot
    and returns. A second signal raises ``KeyboardInterrupt`` immediately
    (the operator insisting). Install is a no-op off the main thread
    (Python only delivers signals there).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._previous: Dict[int, Any] = {}
        self.installed = False

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Programmatic preemption (tests; cluster agents that learn of
        preemption out-of-band)."""
        self._event.set()

    def _handle(self, signum, frame) -> None:
        if _WATCHDOG_INTERRUPT.is_set():
            # not the operator: an expired StepWatchdog interrupting a
            # hung dispatch — unwind it, don't absorb it as a drain flag
            _WATCHDOG_INTERRUPT.clear()
            raise KeyboardInterrupt(
                "step watchdog expired — unwinding hung dispatch")
        if self._event.is_set():
            _flight.record("preemption_abort", signum=int(signum))
            _flight.dump(reason="second_signal")
            raise KeyboardInterrupt(
                f"second signal {signum} during drain — aborting")
        logger.warning(
            "signal %d: draining in-flight work and writing a final "
            "checkpoint (send again to abort)", signum)
        # black-box the preemption instant: if the drain itself wedges or
        # the enclosing job is hard-killed mid-drain, the dump already
        # names the last dispatched step
        _flight.record("preemption_signal", signum=int(signum))
        _flight.dump(reason="preemption")
        self._event.set()

    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            return self
        _WATCHDOG_INTERRUPT.clear()
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handle)
        self.installed = True
        return self

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._previous.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False


# ----------------------------------------------------------------------
# DurableSession: the run_fit_loop wiring
# ----------------------------------------------------------------------

class DurableSession:
    """Per-``fit()`` glue between the dispatch loop and the durable
    machinery. ``run_fit_loop`` calls :meth:`tap` around the batch
    source (BEFORE ingest staging, so cursors are recorded in production
    order), :meth:`on_step` after every dispatched step, and
    :meth:`on_epoch_boundary` after each completed epoch.
    """

    def __init__(self, net, store: Optional[CheckpointStore] = None, *,
                 data=None, frequency: int = 100,
                 writer: Optional[AsyncCheckpointWriter] = None,
                 watchdog: Optional[StepWatchdog] = None,
                 preemption: Optional[PreemptionHandler] = None,
                 max_steps: Optional[int] = None,
                 commit_gate: Optional[Callable[[str], bool]] = None,
                 resuming: bool = False, registry=None):
        if store is None and writer is not None:
            store = writer.store
        self.net = net
        self.store = store
        self.writer = writer
        self.frequency = max(1, int(frequency))
        self.watchdog = watchdog
        self.preemption = preemption
        self.max_steps = max_steps
        self.commit_gate = commit_gate
        self.registry = registry
        self.data = data
        self.seekable = data is not None and is_seekable(data)
        # True for the first epoch after a cursor restore: run_fit_loop
        # must not "revive" an exhausted iterator then — a cursor at the
        # exact end of an epoch means zero batches remain, not restart
        self.resuming = resuming
        self.stopped = False
        self.stop_reason: Optional[str] = None
        self.steps = 0
        self._in_partial_epoch = False
        self._cursors: collections.deque = collections.deque()
        self._cursor: Optional[dict] = None
        # cadence anchor: set from the first observed iteration_count so
        # a resumed run doesn't immediately re-checkpoint
        self._last_cp_iter: Optional[int] = None

    # -- cursor tap ----------------------------------------------------

    def tap(self, batches, data=None):
        """Wrap the batch iterable so each produced batch's post-read
        cursor is recorded (in production order — consumption order is
        identical, so the k-th ``on_step`` pop is the k-th batch's
        cursor). Pass-through for non-seekable sources. ``data`` rebinds
        the cursor source to the iterator the fit loop actually runs
        over (they can differ from the construction-time one)."""
        if data is not None and data is not self.data:
            self.data = data
            self.seekable = is_seekable(data)
        if not self.seekable:
            return batches
        source = self.data

        def gen():
            for b in batches:
                self._cursors.append(source.state())
                yield b
        return gen()

    # -- step/epoch hooks ----------------------------------------------

    def on_step(self, net, n_consumed: int = 1) -> bool:
        """Bookkeeping after one dispatched step (which consumed
        ``n_consumed`` source batches). Returns False when the loop must
        stop cleanly (preemption, max_steps) — the caller drains the
        in-flight window and returns."""
        for _ in range(n_consumed):
            if self._cursors:
                self._cursor = self._cursors.popleft()
        self.steps += n_consumed
        self._in_partial_epoch = True
        if self.watchdog is not None:
            self.watchdog.pet()
        it = getattr(net, "iteration_count", self.steps)
        if self._last_cp_iter is None:
            self._last_cp_iter = it - n_consumed
        # mid-epoch snapshots only when the cursor makes them EXACTLY
        # resumable; non-seekable sources get epoch boundaries only.
        # Crossing test, not divisibility: a coalesced scan advances the
        # counter by k per step, which can stride over every multiple
        if (self.seekable and (self.writer or self.store) is not None
                and it // self.frequency > self._last_cp_iter // self.frequency):
            self._last_cp_iter = it
            if self.writer is not None:
                if not self.writer.would_drop():
                    self.writer.submit(TrainingState.capture(
                        net, cursor=self._cursor, kind="step"))
            else:           # sync mode: deterministic, on the step path
                self.store.save(
                    TrainingState.capture(net, cursor=self._cursor,
                                          kind="step"),
                    commit_gate=self.commit_gate, registry=self.registry)
        if self.preemption is not None and self.preemption.requested:
            self.stopped, self.stop_reason = True, "preempted"
            return False
        if self.max_steps is not None and self.steps >= self.max_steps:
            self.stopped, self.stop_reason = True, "max_steps"
            return False
        return True

    def on_epoch_boundary(self, net) -> None:
        """Called after ``epoch_count`` incremented: an epoch-boundary
        snapshot (cursor None = start of the next epoch), and stale
        read-ahead cursors from the finished epoch are dropped."""
        self._cursors.clear()
        self._cursor = None
        self._in_partial_epoch = False
        if self.watchdog is not None:
            self.watchdog.pet()
        if (self.writer or self.store) is None:
            return          # store-less streaming session: nothing to
                            # snapshot INTO — skip the device copies
        if self.writer is not None:
            if not self.writer.would_drop():
                self.writer.submit(TrainingState.capture(
                    net, cursor=None, kind="boundary"))
        else:
            self.store.save(
                TrainingState.capture(net, cursor=None, kind="boundary"),
                commit_gate=self.commit_gate, registry=self.registry)

    # -- final snapshot ------------------------------------------------

    def final_snapshot(self, net) -> Optional[str]:
        """Synchronous write of the exact stop instant (after the
        in-flight window drained). Used on preemption."""
        if self.store is None:
            return None
        if self.writer is not None:
            self.writer.drain()
        if self._in_partial_epoch and not self.seekable:
            # a mid-epoch snapshot WITHOUT a cursor would be newer than
            # the last boundary snapshot but impossible to resume
            # exactly — the restarted epoch would re-apply its first
            # batches on top of the partial updates. Keep the boundary
            # snapshot as the recovery point instead.
            logger.warning(
                "preempted mid-epoch over a non-seekable data source — "
                "not writing a mid-epoch snapshot (exact resume needs "
                "state()/restore()); the last epoch-boundary snapshot "
                "remains the recovery point")
            return None
        state = TrainingState.capture(
            net, cursor=self._cursor if self.seekable else None,
            kind="final")
        return self.store.save(state, commit_gate=self.commit_gate,
                               registry=self.registry)


# ----------------------------------------------------------------------
# DurableTrainer: resume-on-construction fit
# ----------------------------------------------------------------------

class DurableTrainer:
    """``fit()`` that is killable at any step and resumes bit-exactly.

    Construction restores the newest valid :class:`TrainingState` from
    ``directory`` (falling back past torn commits). ``fit(data,
    epochs=N)`` trains until N TOTAL epochs are recorded, checkpointing
    asynchronously every ``frequency`` iterations (with the data-source
    cursor when the source is seekable) and at every epoch boundary;
    SIGTERM/SIGINT drain the in-flight window, write a final snapshot and
    return cleanly (``preempted`` is then True). An optional step
    watchdog bounds no-progress time.
    """

    def __init__(self, net, directory: str, *, frequency: int = 100,
                 keep: int = 2, async_writes: bool = True,
                 watchdog_s: Optional[float] = None,
                 handle_signals: bool = True,
                 commit_gate: Optional[Callable[[str], bool]] = "default",
                 registry=None):
        self.store = CheckpointStore(directory, keep=keep,
                                     device=getattr(net, "device", "cuda"))
        # a durable run is exactly the kind whose crash needs a black
        # box: any unhandled exception dumps the flight recorder
        _flight.install_excepthook()
        self.frequency = max(1, int(frequency))
        self.async_writes = async_writes
        self.watchdog_s = watchdog_s
        self.handle_signals = handle_signals
        self.registry = registry
        self.commit_gate = (default_commit_gate()
                            if commit_gate == "default" else commit_gate)
        loaded = self.store.load_latest()
        self.resumed = loaded is not None
        self.net = loaded.net if loaded is not None else net
        self._resume_cursor = loaded.cursor if loaded is not None else None
        self.preempted = False
        self.session: Optional[DurableSession] = None

    def fit(self, data, labels=None, *, epochs: int = 1, mask=None,
            coalesce: Optional[int] = None):
        """Train until ``epochs`` TOTAL epochs are recorded on the model.
        A run resumed mid-epoch continues that epoch from the restored
        cursor — replaying zero batches and skipping none — which requires
        the data source to be seekable."""
        net = self.net
        if net.params is None:
            net.init()
        resuming_mid_epoch = self._resume_cursor is not None
        if resuming_mid_epoch:
            if not is_seekable(data):
                raise ValueError(
                    "resuming a mid-epoch snapshot needs a seekable data "
                    "source (state()/restore()) — got "
                    f"{type(data).__name__}; pass the same seekable "
                    "iterator the interrupted run used")
            data.restore(self._resume_cursor)
            self._resume_cursor = None
        writer = (AsyncCheckpointWriter(self.store,
                                        commit_gate=self.commit_gate,
                                        registry=self.registry)
                  if self.async_writes else None)
        watchdog = (StepWatchdog(self.watchdog_s, registry=self.registry,
                                 thread=True)
                    if self.watchdog_s else None)
        preemption = PreemptionHandler() if self.handle_signals else None
        session = DurableSession(
            net, self.store, data=data, frequency=self.frequency,
            writer=writer, watchdog=watchdog, preemption=preemption,
            commit_gate=self.commit_gate,
            resuming=resuming_mid_epoch, registry=self.registry)
        self.session = session
        kwargs = {"session": session}
        if coalesce is not None:
            kwargs["coalesce"] = coalesce
        kwargs.update(mask_fit_kwargs(net, mask))
        if preemption is not None:
            preemption.install()
        if watchdog is not None:
            watchdog.arm()
        try:
            remaining = epochs - net.epoch_count
            if remaining > 0:
                try:
                    net.fit(data, labels, epochs=remaining, **kwargs)
                except KeyboardInterrupt:
                    if watchdog is not None and watchdog.last_dump:
                        raise WatchdogTimeout(
                            f"no training progress for >= "
                            f"{self.watchdog_s:.1f}s", watchdog.last_dump
                        ) from None
                    raise
            if session.stopped and session.stop_reason == "preempted":
                self.preempted = True
            if remaining > 0:
                # preempted: the exact stop instant (with cursor); clean
                # finish: the last epoch boundary, in case the async
                # writer was busy when it fired (same-name saves dedup)
                session.final_snapshot(net)
        finally:
            if watchdog is not None:
                watchdog.disarm()
            if preemption is not None:
                preemption.uninstall()
            if writer is not None:
                writer.close()
        return net
