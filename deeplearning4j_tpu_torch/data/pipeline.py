"""Composable input pipeline over sharded record files (counterpart of
the JAX package's ``data/pipeline.py``).

1. **Per-host shard assignment** — :func:`shard_assignment` is a pure
   function of (num_shards, member set, host): strided over the SORTED
   member list, so it is disjoint and covering by construction and every
   host computes the same answer with no coordination
   (:func:`assignment_for_round` derives the member set from an elastic
   membership log).
2. **Epoch-seeded shuffles** — the shard ORDER is permuted per epoch and
   a bounded shuffle buffer mixes records, both from numpy generators
   seeded by blake2s of (seed, epoch) exactly as the reference seeds
   them, so for the same seed both packages read the records in the same
   order and build byte-identical batches.
3. **An augmentation stage** (:class:`Augment`) — random crop,
   horizontal flip, scale/normalize in plain PyTorch, its draws from an
   explicit generator keyed by the GLOBAL batch counter, which rides the
   cursor — so a resumed run re-augments batch n bit-identically. (The
   draws are not jax's; given the same offsets and flips the arithmetic
   is the reference's.)
4. **Batching into ``DataSet``** — :class:`RecordDataSetIterator` is a
   normal ``DataSetIterator``: ``fit()`` wraps it in ``util.ingest``'s
   staging (record decode and augmentation run on the staging producer
   thread, overlapping the step in flight), and it implements the FULL
   seekable-cursor protocol — ``state()`` / ``restore()`` capture
   (epoch, shard position, record offset, shuffle buffer refs + rng
   state, batch counter) under the reference's keys, so
   ``DurableSession`` resumes a preempted mid-epoch run replaying zero
   batches and skipping none, and a cursor from either package restores
   the other.

Cursor note: the shuffle buffer holds READ-AHEAD records; ``state()``
records each buffered record's (shard-position, record-index) REFERENCE
and ``restore()`` re-fetches them — O(buffer) index-backed seeks.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..datasets.dataset import DataSet
from ..datasets.iterator import DataSetIterator
from ..util import ingest as _ingest
from ..util.netutil import named_generator
from .records import ShardSet, decode_example

_CURSOR_VERSION = 1


def _stable_seed(*parts) -> int:
    """Process-restart-stable 31-bit seed from arbitrary parts (python
    ``hash()`` is salted per interpreter — the elastic determinism trap)."""
    h = hashlib.blake2s("\x1f".join(str(p) for p in parts).encode(),
                        digest_size=4).digest()
    return int.from_bytes(h, "big") & 0x7FFFFFFF


# ----------------------------------------------------------------------
# per-host shard assignment
# ----------------------------------------------------------------------

def shard_assignment(num_shards: int, members: Sequence[str],
                     host: str) -> Tuple[int, ...]:
    """The shards ``host`` owns among ``members``: strided over the
    sorted member list. Disjoint and covering by construction,
    order-insensitive in ``members``, and a pure function — every host
    computes the fleet's whole assignment without coordination."""
    ms = sorted(set(members))
    if host not in ms:
        raise ValueError(f"host {host!r} not in members {ms}")
    if num_shards < len(ms):
        raise ValueError(
            f"{num_shards} shard(s) cannot feed {len(ms)} hosts — every "
            "host must own at least one shard (write more shards)")
    i = ms.index(host)
    return tuple(s for s in range(num_shards) if s % len(ms) == i)


def assignment_for_round(num_shards: int, coordinator, round_: int,
                         host: str) -> Tuple[int, ...]:
    """Shard assignment under the elastic membership log: the member set
    is ``ElasticCoordinator.members_for_round(round_)``, so every
    surviving host derives the same post-eviction assignment at the same
    effective round (the log is the shared truth; no extra agreement)."""
    return shard_assignment(
        num_shards, coordinator.members_for_round(round_), host)


# ----------------------------------------------------------------------
# augmentation
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Augment:
    """Per-batch augmentation config.

    ``crop_pad``/``flip`` need NHWC image batches ``[b, h, w, c]``;
    ``scale``/``mean``/``std`` apply to any shape (flat feature vectors
    included). ``scale`` is applied first (e.g. ``1/255`` for uint8
    image records — store bytes, normalize after decode).
    """
    crop_pad: int = 0
    flip: bool = False
    scale: Optional[float] = None
    mean: Optional[Tuple[float, ...]] = None
    std: Optional[Tuple[float, ...]] = None

    @property
    def needs_images(self) -> bool:
        return bool(self.crop_pad or self.flip)


class AugmentStage:
    """The stage: ``stage(features, batch_index)`` returns the augmented
    f32 batch as a host tensor (the fit loop's stager then puts it on the
    card).

    Its draws come from an explicit ``torch.Generator`` seeded by (seed,
    ``"augment"``, batch counter): crop offsets first (``[b, 2]`` integers
    in ``[0, 2·crop_pad]``), then flips (a uniform below 0.5 per example),
    so a run resumed from a cursor re-augments batch n bit-identically.
    They are not jax's draws: :meth:`draws` and :meth:`apply` separate the
    drawing from the arithmetic, which given the same offsets and flips is
    the reference's (scale, zero pad, crop, flip along the width,
    ``(x - mean) / std``, all in f32).
    """

    def __init__(self, aug: Augment, seed: int, *,
                 stage_name: str = "records", registry=None):
        from ..util import xla as _xla
        self.aug = aug
        self.seed = int(seed)
        self.stage_name = stage_name
        self._seconds = _ingest.augment_seconds_counter(registry)
        self._fn = _xla.retrace_guard(self._run, "pipeline.augment",
                                      registry)
        self._mean = (None if aug.mean is None
                      else torch.tensor(aug.mean, dtype=torch.float32))
        self._std = (None if aug.std is None
                     else torch.tensor(aug.std, dtype=torch.float32))

    def draws(self, batch: int, batch_index: int):
        """(offsets [b, 2] int64 or None, flips [b] bool or None) of batch
        ``batch_index``."""
        gen = named_generator("cpu", self.seed,
                              f"augment/{int(batch_index)}")
        offsets = flips = None
        if self.aug.crop_pad:
            offsets = torch.randint(0, 2 * self.aug.crop_pad + 1,
                                    (batch, 2), generator=gen)
        if self.aug.flip:
            flips = torch.rand(batch, generator=gen) < 0.5
        return offsets, flips

    def apply(self, x, offsets=None, flips=None) -> torch.Tensor:
        """The augmentation of ``x`` given its crop offsets and flips."""
        aug = self.aug
        x = torch.as_tensor(x if torch.is_tensor(x)
                            else np.asarray(x)).to(torch.float32)
        if aug.scale is not None:
            x = x * torch.tensor(aug.scale, dtype=torch.float32)
        if aug.crop_pad:
            p = aug.crop_pad
            b, h, w, _ = x.shape
            padded = torch.nn.functional.pad(x, (0, 0, p, p, p, p))
            off = torch.as_tensor(offsets).long()
            rows = off[:, 0, None] + torch.arange(h)
            cols = off[:, 1, None] + torch.arange(w)
            x = padded[torch.arange(b)[:, None, None], rows[:, :, None],
                       cols[:, None, :]]
        if aug.flip:
            m = torch.as_tensor(flips).bool()
            x = torch.where(m[:, None, None, None], x.flip(2), x)
        if self._mean is not None:
            x = x - self._mean
        if self._std is not None:
            x = x / self._std
        return x

    def _run(self, features, batch_index: int) -> torch.Tensor:
        offsets, flips = self.draws(int(features.shape[0]), batch_index)
        return self.apply(features, offsets, flips)

    def __call__(self, features, batch_index: int) -> torch.Tensor:
        if self.aug.needs_images and features.ndim != 4:
            raise ValueError(
                "crop/flip augmentation needs NHWC image batches "
                f"[b, h, w, c]; got shape {features.shape}")
        t0 = time.perf_counter()
        out = self._fn(features, int(batch_index))
        self._seconds.inc(time.perf_counter() - t0, stage=self.stage_name)
        return out


# ----------------------------------------------------------------------
# the iterator
# ----------------------------------------------------------------------

class RecordDataSetIterator(DataSetIterator):
    """``DataSetIterator`` over this host's shards of a record set.

    Per epoch: the assigned shards are read in an epoch-seeded permuted
    order; records pass through a bounded shuffle buffer (deterministic
    swap-pop draws from a seeded rng); ``batch_size`` examples stack
    into one ``DataSet``, optionally through the :class:`Augment` stage. ``reset()`` advances to the next epoch's
    shuffles (``reshuffle_each_epoch=False`` replays the same epoch —
    evaluation semantics).

    Seekable-cursor protocol: ``state()`` (cheap, JSON-serializable) /
    ``restore(state)`` on an equivalently-constructed iterator reproduce
    the remaining batch stream bit-exactly — including augmentation,
    whose rng is keyed by the global batch counter in the cursor.
    """

    def __init__(self, directory: str, name: Optional[str] = None, *,
                 batch_size: int, features_key: str = "features",
                 labels_key: Optional[str] = "labels",
                 hosts: Sequence[str] = ("host0",),
                 host: Optional[str] = None,
                 seed: int = 0, shuffle_shards: bool = True,
                 shuffle_buffer: int = 0, augment: Optional[Augment] = None,
                 drop_remainder: bool = False,
                 reshuffle_each_epoch: bool = True,
                 corrupt: str = "raise", stage_name: str = "records",
                 registry=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._set = ShardSet(directory, name, corrupt=corrupt)
        self.hosts = tuple(hosts)
        self.host = self.hosts[0] if host is None else host
        self.assigned = shard_assignment(self._set.num_shards, self.hosts,
                                         self.host)
        self._batch = int(batch_size)
        self.features_key = features_key
        self.labels_key = labels_key
        self.seed = int(seed)
        self.shuffle_shards = shuffle_shards
        self.shuffle_buffer = max(0, int(shuffle_buffer))
        self.drop_remainder = drop_remainder
        self.reshuffle_each_epoch = reshuffle_each_epoch
        self.stage_name = stage_name
        self._counts = {s: self._set.record_count(s) for s in self.assigned}
        self._epoch_total = sum(self._counts.values())
        if augment is None or isinstance(augment, AugmentStage):
            # a pre-built stage may be SHARED across iterators
            self._augment = augment
        else:
            self._augment = AugmentStage(augment, seed,
                                         stage_name=stage_name,
                                         registry=registry)
        self._read_ctr = _ingest.records_read_counter(registry)
        self._skip_ctr = _ingest.records_skipped_counter(registry)
        self._batch_ctr = _ingest.pipeline_batches_counter(registry)
        self._skipped_seen = 0
        self._batch_index = 0           # GLOBAL: the augmentation counter
        self._init_epoch(0)

    # -- epoch machinery ------------------------------------------------

    def _init_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        order = list(self.assigned)
        if self.shuffle_shards:
            perm = np.random.default_rng(_stable_seed(
                self.seed, "shards", epoch)).permutation(len(order))
            order = [order[i] for i in perm]
        self._perm: List[int] = order
        self._rng = (np.random.default_rng(_stable_seed(
            self.seed, "buffer", epoch)) if self.shuffle_buffer else None)
        self._shard_pos = 0             # index into self._perm
        self._rec_idx = 0               # next record within current shard
        self._buffer: List[Tuple[Tuple[int, int], Dict[str, np.ndarray]]] = []
        self._emitted = 0

    def reset(self) -> None:
        self._init_epoch(self._epoch + 1 if self.reshuffle_each_epoch
                         else self._epoch)

    # -- record stream --------------------------------------------------

    def _fetch(self, shard_pos: int, rec_idx: int) \
            -> Optional[Dict[str, np.ndarray]]:
        payload = self._set.reader(self._perm[shard_pos]).read(rec_idx)
        if payload is None:             # corrupt-skip policy
            return None
        return decode_example(payload)

    def _pull(self) -> Optional[Tuple[Tuple[int, int],
                                      Dict[str, np.ndarray]]]:
        while self._shard_pos < len(self._perm):
            shard = self._perm[self._shard_pos]
            if self._rec_idx >= self._counts[shard]:
                self._shard_pos += 1
                self._rec_idx = 0
                continue
            ref = (self._shard_pos, self._rec_idx)
            self._rec_idx += 1
            ex = self._fetch(*ref)
            if ex is None:
                continue
            self._read_ctr.inc(stage=self.stage_name)
            return ref, ex
        return None

    def _remaining_stream(self) -> int:
        done = sum(self._counts[s] for s in self._perm[:self._shard_pos])
        return self._epoch_total - done - self._rec_idx

    def _next_example(self) -> Optional[Dict[str, np.ndarray]]:
        if self.shuffle_buffer <= 0:
            r = self._pull()
            return None if r is None else r[1]
        while len(self._buffer) < self.shuffle_buffer:
            r = self._pull()
            if r is None:
                break
            self._buffer.append(r)
        if not self._buffer:
            return None
        j = int(self._rng.integers(len(self._buffer)))
        _, ex = self._buffer.pop(j)
        return ex

    # -- DataSetIterator contract ---------------------------------------

    @property
    def batch_size(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        """Records this host owns per epoch (pre-corrupt-skip)."""
        return self._epoch_total

    def has_next(self) -> bool:
        remaining = len(self._buffer) + self._remaining_stream()
        need = self._batch if self.drop_remainder else 1
        return remaining >= need

    def __iter__(self):
        # has_next() counts corrupt records it cannot see past (the skip
        # policy only discovers them on read), so a fully-corrupt tail
        # can make next() come up empty AFTER has_next() said True — end
        # the stream instead of letting the StopIteration escape inside
        # a generator frame (PEP 479 would turn it into a RuntimeError)
        while self.has_next():
            try:
                yield self.next()
            except StopIteration:
                return

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        feats, labels = [], []
        for _ in range(self._batch):
            ex = self._next_example()
            if ex is None:
                break
            feats.append(ex[self.features_key])
            if self.labels_key is not None:
                labels.append(ex[self.labels_key])
        # surface corrupt-skips into the registry BEFORE any end-of-stream
        # raise — a fully-corrupt tail must still show up on monitoring
        self._flush_skips()
        if not feats or (self.drop_remainder and len(feats) < self._batch):
            raise StopIteration
        x = np.stack(feats)
        y = np.stack(labels) if labels else None
        if self._augment is not None:
            x = self._augment(x, self._batch_index)
        self._batch_index += 1
        self._emitted += len(feats)
        self._batch_ctr.inc(stage=self.stage_name)
        return DataSet(x, y)

    def _flush_skips(self) -> None:
        skipped = self._set.skipped
        if skipped > self._skipped_seen:
            self._skip_ctr.inc(skipped - self._skipped_seen,
                               stage=self.stage_name)
            self._skipped_seen = skipped

    # -- seekable cursor protocol ---------------------------------------

    def state(self) -> dict:
        rng_state = None
        if self._rng is not None:
            rng_state = self._rng.bit_generator.state
        return {
            "version": _CURSOR_VERSION,
            "num_shards": self._set.num_shards,
            "host": self.host,
            "members": sorted(set(self.hosts)),
            "epoch": self._epoch,
            "shard_pos": self._shard_pos,
            "rec_idx": self._rec_idx,
            "buffer": [[sp, ri] for (sp, ri), _ in self._buffer],
            "rng": rng_state,
            "batch_index": self._batch_index,
            "emitted": self._emitted,
        }

    def restore(self, state: dict) -> None:
        if state.get("version") != _CURSOR_VERSION:
            raise ValueError(
                f"unsupported cursor version {state.get('version')!r}")
        if state.get("num_shards") != self._set.num_shards \
                or state.get("host") != self.host:
            raise ValueError(
                "cursor belongs to a different pipeline: cursor is "
                f"host={state.get('host')!r} over {state.get('num_shards')}"
                f" shards, this iterator is host={self.host!r} over "
                f"{self._set.num_shards}")
        if state.get("members") != sorted(set(self.hosts)):
            # same host name + shard count but a DIFFERENT member set
            # changes the shard assignment: shard_pos/buffer refs would
            # silently resolve to other hosts' records
            raise ValueError(
                "cursor belongs to a different fleet membership: cursor "
                f"saw members {state.get('members')}, this iterator has "
                f"{sorted(set(self.hosts))} — resuming across a resize "
                "needs a fresh epoch, not a cursor restore")
        if state["buffer"] and self.shuffle_buffer <= 0:
            raise ValueError(
                "cursor carries shuffle-buffer contents but this iterator "
                "was built with shuffle_buffer=0 — same pipeline config "
                "required for exact resume")
        self._init_epoch(int(state["epoch"]))
        self._shard_pos = int(state["shard_pos"])
        self._rec_idx = int(state["rec_idx"])
        for sp, ri in state["buffer"]:
            ex = self._fetch(int(sp), int(ri))
            if ex is None:
                raise ValueError(
                    f"cursor references record {(sp, ri)} that no longer "
                    "decodes — the shard set changed since the snapshot")
            self._buffer.append(((int(sp), int(ri)), ex))
        if self._rng is not None:
            if state.get("rng") is None:
                raise ValueError(
                    "cursor has no shuffle-buffer rng state but this "
                    "iterator shuffles — same pipeline config required")
            self._rng.bit_generator.state = state["rng"]
        self._batch_index = int(state["batch_index"])
        self._emitted = int(state["emitted"])

    def close(self) -> None:
        self._set.close()
