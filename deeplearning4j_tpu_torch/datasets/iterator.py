"""DataSetIterator framework and async prefetch (counterpart of the JAX
package's ``datasets/iterator.py``).

The ``DataSetIterator`` contract, ``ArrayDataSetIterator``,
``ListDataSetIterator``, ``ExistingDataSetIterator``,
``MultipleEpochsIterator``, ``SamplingDataSetIterator`` and the
background-thread ``AsyncDataSetIterator`` / ``AsyncMultiDataSetIterator``
(the reference's ``IteratorRunnable`` thread and bounded queue). With
``device_put=True`` the async producer puts each batch on the card through
``util.ingest.DeviceStager`` — pinned memory, its own CUDA stream, an
event the consumer's stream waits on — so the next step's copy overlaps
the current step.

Seekable cursor protocol (``util.durable``): every in-tree iterator also
implements ``state() -> dict`` / ``restore(state)`` — a JSON-serializable
cursor, the same keys as the reference's, such that restoring it on a
freshly built iterator reproduces the remaining batch stream exactly
(replays zero batches, skips none), and a cursor taken in either package
restores the other. The async wrapper tags each prefetched batch with the
base cursor captured right after producing it, so ``state()`` always
reflects what the CONSUMER has seen, never the producer's read-ahead.
"""

from __future__ import annotations

import threading
from typing import Iterable, Iterator, List, Optional

import numpy as np

from .dataset import DataSet


class DataSetIterator:
    """Iterator contract (parity: ND4J ``DataSetIterator``).

    Subclasses implement ``next()`` / ``has_next()`` / ``reset()``.
    Iterating with ``for`` restarts from the current cursor; call ``reset()``
    for a fresh epoch (``MultiLayerNetwork.fit`` resets between epochs).
    """

    def next(self) -> DataSet:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    # Seekable cursor protocol (optional — ``util.durable.is_seekable``
    # probes for the METHODS, so subclasses without a cursor simply don't
    # define them): ``state() -> dict`` returns a JSON-serializable
    # cursor; ``restore(state)`` on an equivalently built iterator
    # reproduces the remaining batch stream exactly.

    @property
    def batch_size(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        while self.has_next():
            yield self.next()


class ArrayDataSetIterator(DataSetIterator):
    """Batches over in-memory arrays (parity: ``INDArrayDataSetIterator``)."""

    def __init__(self, features, labels, batch_size: int,
                 features_mask=None, labels_mask=None):
        self._data = DataSet(features, labels, features_mask, labels_mask)
        self._batch = int(batch_size)
        self._cursor = 0

    @property
    def batch_size(self) -> int:
        return self._batch

    def total_examples(self) -> int:
        return self._data.num_examples()

    def has_next(self) -> bool:
        return self._cursor < self._data.num_examples()

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        end = min(self._cursor + self._batch, self._data.num_examples())
        out = self._data._take(slice(self._cursor, end))
        self._cursor = end
        return out

    def reset(self) -> None:
        self._cursor = 0

    def state(self) -> dict:
        # the cursor indexes the CURRENT example order; a caller that
        # shuffles per epoch must re-apply the same seeded shuffle before
        # restore() for the stream to reproduce
        return {"cursor": int(self._cursor)}

    def restore(self, state: dict) -> None:
        self._cursor = int(state["cursor"])

    def shuffle(self, seed: Optional[int] = None) -> None:
        self._data.shuffle(seed)
        self._cursor = 0


class ListDataSetIterator(DataSetIterator):
    """Iterator over a pre-batched list (parity: ``ListDataSetIterator``)."""

    def __init__(self, datasets: Iterable[DataSet], batch_size: Optional[int] = None):
        self._list: List[DataSet] = list(datasets)
        self._batch = batch_size or (self._list[0].num_examples() if self._list else 0)
        self._cursor = 0

    @property
    def batch_size(self) -> int:
        return self._batch

    def has_next(self) -> bool:
        return self._cursor < len(self._list)

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        out = self._list[self._cursor]
        self._cursor += 1
        return out

    def reset(self) -> None:
        self._cursor = 0

    def state(self) -> dict:
        return {"cursor": int(self._cursor)}

    def restore(self, state: dict) -> None:
        self._cursor = int(state["cursor"])


class ExistingDataSetIterator(DataSetIterator):
    """Wrap a plain python iterable of DataSets (parity:
    ``ExistingDataSetIterator``). Resettable only if the source is re-iterable."""

    def __init__(self, source: Iterable[DataSet]):
        self._source = source
        self._iter = iter(source)
        self._peek: Optional[DataSet] = None

    @property
    def batch_size(self) -> int:
        return -1

    def has_next(self) -> bool:
        if self._peek is None:
            try:
                self._peek = next(self._iter)
            except StopIteration:
                return False
        return True

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        out, self._peek = self._peek, None
        return out

    def reset(self) -> None:
        self._iter = iter(self._source)
        self._peek = None


class MultipleEpochsIterator(DataSetIterator):
    """Repeat an underlying iterator N times (parity: ``MultipleEpochsIterator``)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self.epochs = int(epochs)
        self.base = base
        self._epoch = 0

    @property
    def batch_size(self) -> int:
        return self.base.batch_size

    def has_next(self) -> bool:
        if self.base.has_next():
            return True
        if self._epoch + 1 < self.epochs:
            self._epoch += 1
            self.base.reset()
            return self.base.has_next()
        return False

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.base.next()

    def reset(self) -> None:
        self._epoch = 0
        self.base.reset()

    def seekable(self) -> bool:
        """Only as seekable as the base — state() delegates to it."""
        from ..util.durable import is_seekable
        return is_seekable(self.base)

    def state(self) -> dict:
        return {"epoch": int(self._epoch), "base": self.base.state()}

    def restore(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self.base.restore(state["base"])


class SamplingDataSetIterator(DataSetIterator):
    """Random with-replacement samples from one DataSet (parity:
    ``SamplingDataSetIterator``)."""

    def __init__(self, data: DataSet, batch_size: int, total_batches: int,
                 seed: Optional[int] = None):
        self._data = data
        self._batch = int(batch_size)
        self._total = int(total_batches)
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._count = 0

    @property
    def batch_size(self) -> int:
        return self._batch

    def has_next(self) -> bool:
        return self._count < self._total

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        self._count += 1
        idx = self._rng.choice(self._data.num_examples(), size=self._batch,
                               replace=True)
        return self._data._take(idx)

    def reset(self) -> None:
        self._count = 0
        self._rng = np.random.default_rng(self._seed)

    def state(self) -> dict:
        # bit_generator.state is a JSON-friendly dict (ints + strings), so
        # restore reproduces the EXACT sample stream, not just the count
        return {"count": int(self._count),
                "rng": self._rng.bit_generator.state}

    def restore(self, state: dict) -> None:
        self._count = int(state["count"])
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch + optional device placement.

    A producer thread drains the base iterator into a bounded queue while
    the training loop consumes. With ``device_put=True`` the producer also
    puts each batch on ``device`` (``"cuda"`` by default) through a
    :class:`~..util.ingest.DeviceStager`, so the next step's copy overlaps
    the current step; the consumer's stream waits for the copy when the
    batch is handed out.

    The producer watches a stop flag between puts, so ``reset()`` is
    O(queue_size): it poisons the running producer, discards the staged
    queue, and restarts on a reset base — it does NOT drain the rest of
    the epoch through the consumer. Producer errors are raised on the
    consumer as soon as they are observed (fail fast), not deferred until
    every already-staged batch has been drained.

    Seekable: when the base iterator is, the producer tags every queued
    batch with ``base.state()`` captured right after producing it, and the
    consumer records the tag as each batch is handed out — so ``state()``
    is always the cursor of the last CONSUMED batch (prefetched-but-unread
    batches are replayed after a ``restore()``, never skipped).
    """

    def __init__(self, base: DataSetIterator, queue_size: int = 2,
                 device_put: bool = False, device="cuda"):
        self.base = base
        self.queue_size = max(1, int(queue_size))
        self.device_put = device_put
        self.device = device
        self._stager = None
        if device_put:
            from ..util.ingest import DeviceStager
            self._stager = DeviceStager(device, stage_name="async_iterator")
        self._peek = None
        self._start()

    def _stage(self, ds):
        (f, l, fm, lm), event = self._stager.stage(
            (ds.features, ds.labels, ds.features_mask, ds.labels_mask))
        return DataSet(f, l, fm, lm), event

    def _adopt(self, ds, event) -> None:
        self._stager.adopt((ds.features, ds.labels, ds.features_mask,
                            ds.labels_mask), event)

    def _producer(self, pq) -> None:
        try:
            seekable = self._base_seekable
            for ds in self.base:
                if pq.stop.is_set():
                    return
                # post-read cursor of THIS batch (the base's __iter__
                # advances exactly one item per yield)
                cursor = self.base.state() if seekable else None
                event = None
                if self.device_put:
                    ds, event = self._stage(ds)
                if not pq.put((ds, cursor, event)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            pq.fail(e)
        finally:
            pq.finish()

    def _start(self) -> None:
        from ..util.ingest import ProducerQueue
        # the shared probe (both protocol halves + the base's own veto):
        # a base with state() but no restore() must NOT be reported
        # seekable — the failure would otherwise surface as an
        # AttributeError at resume time
        from ..util.durable import is_seekable
        self._base_seekable = is_seekable(self.base)
        # cursor of "nothing consumed yet" — captured BEFORE the producer
        # thread starts racing ahead on the base
        self._cursor = self.base.state() if self._base_seekable else None
        self._pq = ProducerQueue(self.queue_size)
        self._thread = threading.Thread(
            target=self._producer, args=(self._pq,), daemon=True)
        self._thread.start()

    @property
    def batch_size(self) -> int:
        return self.base.batch_size

    def has_next(self) -> bool:
        if self._peek is None:
            try:
                # fail fast: a producer error raises here as soon as it
                # is observed, even with staged batches still queued
                self._peek = self._pq.get()
            except BaseException:
                self._peek = self._pq.SENTINEL   # stream over after error
                raise
        return self._peek is not self._pq.SENTINEL

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        (out, cursor, event), self._peek = self._peek, None
        if cursor is not None:
            self._cursor = cursor
        if event is not None:
            self._adopt(out, event)
        return out

    def reset(self) -> None:
        if not self._pq.drain_and_join(self._thread):
            # restarting would race a second producer against the same
            # base iterator — refuse instead of corrupting it
            raise RuntimeError(
                "async producer did not stop within 5s (base iterator "
                "blocked in next()?) — cannot safely reset")
        self._peek = None
        self.base.reset()
        self._start()

    def seekable(self) -> bool:
        """The wrapper is only as seekable as its base
        (``util.durable.is_seekable`` probes this)."""
        return self._base_seekable

    def state(self) -> dict:
        """Cursor of the last batch the CONSUMER took (prefetched batches
        still in the queue are not consumed and will be replayed)."""
        if not self._base_seekable:
            raise NotImplementedError(
                f"base {type(self.base).__name__} has no seekable cursor")
        return self._cursor

    def restore(self, state: dict) -> None:
        if not self._pq.drain_and_join(self._thread):
            raise RuntimeError(
                "async producer did not stop within 5s (base iterator "
                "blocked in next()?) — cannot safely restore")
        self._peek = None
        self.base.restore(state)
        self._start()

    def close(self) -> None:
        """Stop the producer without restarting (for abandoned epochs).
        Best effort: nothing restarts over the base, so a stuck producer
        is left to die with the process."""
        self._pq.drain_and_join(self._thread)
        self._peek = self._pq.SENTINEL


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """Background prefetch for MultiDataSet iterators — the multi-input/
    multi-output ComputationGraph feed (parity:
    ``AsyncMultiDataSetIterator.java``). Same producer/queue machinery as
    :class:`AsyncDataSetIterator`; only the device staging differs."""

    def _stage(self, mds):
        from .dataset import MultiDataSet
        staged, event = self._stager.stage(
            (mds.features, mds.labels, mds.features_masks, mds.labels_masks))
        return MultiDataSet(*staged), event

    def _adopt(self, mds, event) -> None:
        self._stager.adopt((mds.features, mds.labels, mds.features_masks,
                            mds.labels_masks), event)
