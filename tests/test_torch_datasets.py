"""The port's ``datasets/`` against the JAX package's, on the CPU: the
non-fetcher cases of ``tests/test_datasets.py``, and for every iterator
the same batches, byte for byte, from the same inputs and seed; cursors
taken by one package's ``state()`` restore the other's iterator to the
same next batch. Everything here is exact (host numpy orders and
copies); no tolerance is involved.
"""

import json
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as J
from deeplearning4j_tpu_torch.datasets import (
    ArrayDataSetIterator, AsyncDataSetIterator, AsyncMultiDataSetIterator,
    DataSet, ExistingDataSetIterator, ListDataSetIterator, MultiDataSet,
    MultipleEpochsIterator, SamplingDataSetIterator)
import deeplearning4j_tpu_torch.datasets as T


def _xy(n=23, f=3, c=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    return x, y


def _bytes(batches):
    return [(np.asarray(b.features).tobytes(), np.asarray(b.labels).tobytes(),
             None if b.features_mask is None
             else np.asarray(b.features_mask).tobytes()) for b in batches]


def _build(pkg, kind, seed=3):
    x, y = _xy()
    m = (np.arange(23 * 3) % 2).reshape(23, 3).astype(np.float32)
    if kind == "array":
        return pkg.ArrayDataSetIterator(x, y, 5, features_mask=m)
    if kind == "list":
        return pkg.ListDataSetIterator(pkg.DataSet(x, y).batch_by(6))
    if kind == "existing":
        return pkg.ExistingDataSetIterator(pkg.DataSet(x, y).batch_by(4))
    if kind == "epochs":
        return pkg.MultipleEpochsIterator(
            3, pkg.ArrayDataSetIterator(x, y, 7))
    if kind == "sampling":
        return pkg.SamplingDataSetIterator(pkg.DataSet(x, y), batch_size=6,
                                           total_batches=5, seed=seed)
    if kind == "async":
        return pkg.AsyncDataSetIterator(pkg.ArrayDataSetIterator(x, y, 4),
                                        queue_size=2)
    raise ValueError(kind)


KINDS = ["array", "list", "existing", "epochs", "sampling", "async"]
SEEKABLE = ["array", "list", "epochs", "sampling", "async"]


class TestDataSet:
    def test_split_test_and_train(self):
        ds = DataSet(np.arange(20).reshape(10, 2), np.eye(10))
        tr, te = ds.split_test_and_train(0.7)
        assert tr.num_examples() == 7 and te.num_examples() == 3
        tr2, te2 = ds.split_test_and_train(4)
        assert tr2.num_examples() == 4 and te2.num_examples() == 6

    def test_batch_by_and_merge_roundtrip(self):
        ds = DataSet(np.arange(30).reshape(10, 3), np.eye(10))
        batches = ds.batch_by(4)
        assert [b.num_examples() for b in batches] == [4, 4, 2]
        merged = DataSet.merge(batches)
        assert np.array_equal(merged.features, ds.features)

    def test_shuffle_and_sample_equal_reference(self):
        x, y = _xy(17)
        a, b = DataSet(x.copy(), y.copy()), J.DataSet(x.copy(), y.copy())
        a.shuffle(seed=5)
        b.shuffle(seed=5)
        assert a.features.tobytes() == b.features.tobytes()
        assert a.labels.tobytes() == b.labels.tobytes()
        sa, sb = a.sample(9, seed=2), b.sample(9, seed=2)
        assert sa.features.tobytes() == sb.features.tobytes()

    def test_normalization_equals_reference(self):
        x, y = _xy(11)
        for op in ("scale_min_max", "normalize_zero_mean_unit_variance"):
            a, b = DataSet(x.copy(), y), J.DataSet(x.copy(), y)
            getattr(a, op)()
            getattr(b, op)()
            assert a.features.tobytes() == b.features.tobytes(), op

    def test_multidataset_merge_equals_reference(self):
        x, y = _xy(8)
        parts = [(x[:4], y[:4]), (x[4:], y[4:])]
        a = MultiDataSet.merge([MultiDataSet([p, p[:, :1]], [q])
                                for p, q in parts])
        b = J.MultiDataSet.merge([J.MultiDataSet([p, p[:, :1]], [q])
                                  for p, q in parts])
        assert a.num_inputs() == b.num_inputs() == 2
        for u, v in zip(a.features + a.labels, b.features + b.labels):
            assert u.tobytes() == v.tobytes()


class TestIteratorsEqualReference:
    @pytest.mark.parametrize("kind", KINDS)
    def test_same_batches_byte_for_byte(self, kind):
        a, b = _build(T, kind), _build(J, kind)
        got, want = _bytes(a), _bytes(b)
        assert len(got) == len(want) > 0
        assert got == want
        a.reset()
        b.reset()
        assert _bytes(a) == _bytes(b)

    @pytest.mark.parametrize("kind", SEEKABLE)
    @pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
    def test_cursor_restores_across_packages(self, kind, direction):
        src_pkg, dst_pkg = (J, T) if direction == "ref_to_port" else (T, J)
        src = _build(src_pkg, kind)
        for _ in range(2):
            src.next()
        cursor = json.loads(json.dumps(src.state()))
        want = _bytes(list(src))
        dst = _build(dst_pkg, kind)
        dst.restore(cursor)
        assert _bytes(list(dst)) == want

    def test_existing_iterator_is_not_seekable(self):
        from deeplearning4j_tpu_torch.util.durable import is_seekable
        assert not is_seekable(_build(T, "existing"))
        assert is_seekable(_build(T, "array"))

    def test_array_iterator_batching(self):
        it = ArrayDataSetIterator(np.zeros((25, 4)), np.zeros((25, 2)), 10)
        assert [b.num_examples() for b in it] == [10, 10, 5]
        it.reset()
        assert sum(1 for _ in it) == 3

    def test_sampling_restores_exact_rng_stream(self):
        it = _build(T, "sampling")
        it.next()
        st = it.state()
        rest = _bytes(list(it))
        it2 = _build(T, "sampling", seed=99)
        it2.restore(st)
        assert _bytes(list(it2)) == rest


class TestAsyncIterator:
    def test_same_content_as_sync(self):
        feats = np.arange(40).reshape(20, 2).astype(float)
        base = ArrayDataSetIterator(feats, np.zeros((20, 2)), 6)
        sync = [b.features.copy() for b in base]
        base.reset()
        got = [np.asarray(b.features)
               for b in AsyncDataSetIterator(base, queue_size=3)]
        assert len(got) == len(sync)
        for a, b in zip(got, sync):
            assert np.array_equal(a, b)

    def test_reset_restarts(self):
        base = ArrayDataSetIterator(np.zeros((12, 2)), np.zeros((12, 2)), 4)
        it = AsyncDataSetIterator(base)
        assert sum(1 for _ in it) == 3
        it.reset()
        assert sum(1 for _ in it) == 3

    def test_error_propagates(self):
        class Boom(ArrayDataSetIterator):
            def next(self):
                raise RuntimeError("boom")
        it = AsyncDataSetIterator(Boom(np.zeros((4, 1)), np.zeros((4, 1)), 2))
        with pytest.raises(RuntimeError, match="boom"):
            list(it)

    def test_device_put_stages_tensors(self):
        base = ArrayDataSetIterator(np.ones((8, 3)), np.zeros((8, 2)), 4)
        it = AsyncDataSetIterator(base, device_put=True, device="cpu")
        b = it.next()
        assert torch.is_tensor(b.features) and torch.is_tensor(b.labels)
        np.testing.assert_array_equal(b.features.numpy(), np.ones((4, 3)))

    def test_device_put_to_a_missing_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        base = ArrayDataSetIterator(np.ones((8, 3)), np.zeros((8, 2)), 4)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            AsyncDataSetIterator(base, device_put=True)

    def test_reset_under_load_is_o_queue(self):
        class Counting(ArrayDataSetIterator):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.consumed = 0

            def next(self):
                self.consumed += 1
                return super().next()
        base = Counting(np.zeros((10_000, 1)), np.zeros((10_000, 1)), 1)
        it = AsyncDataSetIterator(base, queue_size=2)
        for _ in range(3):
            it.next()
        it.reset()
        assert base.consumed < 100
        assert sum(1 for _ in it) == 10_000
        assert base.consumed < 10_100

    def test_error_surfaces_before_queue_drains(self):
        class BoomAfter(ArrayDataSetIterator):
            def next(self):
                if self._cursor >= 2:
                    raise RuntimeError("late boom")
                return super().next()
        it = AsyncDataSetIterator(
            BoomAfter(np.zeros((50, 1)), np.zeros((50, 1)), 1), queue_size=2)
        for _ in range(200):
            if it._pq.error is not None:
                break
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="late boom"):
            while it.has_next():
                it.next()
        assert not it.has_next()

    def test_multiple_epochs_under_async_streams_continuously(self):
        class Counting(ArrayDataSetIterator):
            resets = 0

            def reset(self):
                type(self).resets += 1
                super().reset()
        base = Counting(np.zeros((20, 1)), np.zeros((20, 1)), 4)
        it = AsyncDataSetIterator(MultipleEpochsIterator(3, base),
                                  queue_size=2)
        thread_at_start = it._thread
        assert sum(1 for _ in it) == 15
        assert Counting.resets == 2
        assert it._thread is thread_at_start

    def test_close_stops_producer(self):
        base = ArrayDataSetIterator(np.zeros((1000, 1)), np.zeros((1000, 1)),
                                    1)
        it = AsyncDataSetIterator(base, queue_size=2)
        it.next()
        it.close()
        assert not it._thread.is_alive()
        assert not it.has_next()

    def test_tracks_consumer_not_prefetch(self):
        base = ArrayDataSetIterator(np.zeros((30, 1)), np.zeros((30, 1)), 3)
        it = AsyncDataSetIterator(base, queue_size=4)
        it.next()
        it.next()
        time.sleep(0.05)                 # the producer runs ahead
        assert it.state() == {"cursor": 6}


class _ListMultiIter:
    batch_size = 4

    def __init__(self, items):
        self._items = items
        self._i = 0

    def has_next(self):
        return self._i < len(self._items)

    def next(self):
        self._i += 1
        return self._items[self._i - 1]

    def reset(self):
        self._i = 0

    def __iter__(self):
        while self.has_next():
            yield self.next()


class TestAsyncMultiDataSetIterator:
    def test_prefetch_and_graph_feed(self):
        from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                      NeuralNetConfiguration)
        from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
        from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                             OutputLayer)
        from deeplearning4j_tpu_torch.nn.graph_runtime import \
            ComputationGraph
        rng = np.random.default_rng(4)
        mds = [MultiDataSet(
            [rng.normal(size=(4, 3)).astype(np.float32),
             rng.normal(size=(4, 2)).astype(np.float32)],
            [np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]])
            for _ in range(5)]
        it = AsyncMultiDataSetIterator(_ListMultiIter(mds), queue_size=2,
                                       device_put=True, device="cpu")
        got = [it.next() for _ in range(5)]
        assert not it.has_next()
        for a, b in zip(mds, got):
            np.testing.assert_array_equal(a.features[0], b.features[0])
            np.testing.assert_array_equal(a.labels[0], b.labels[0])
        conf = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.05)
                .graph_builder().add_inputs("a", "b")
                .add_layer("da", DenseLayer(n_out=4, activation="tanh"), "a")
                .add_layer("db", DenseLayer(n_out=4, activation="tanh"), "b")
                .add_vertex("m", MergeVertex(), "da", "db")
                .add_layer("out", OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "m")
                .set_outputs("out")
                .set_input_types(InputType.feed_forward(3),
                                 InputType.feed_forward(2)).build())
        net = ComputationGraph(conf, device="cpu").init()
        it.reset()
        for m in it:
            loss = net.fit_batch(m.features, m.labels)
        assert np.isfinite(float(loss))

    def test_producer_error_propagates(self):
        class BoomIter:
            batch_size = 2

            def __iter__(self):
                raise RuntimeError("multi boom")

            def has_next(self):
                return True

            def reset(self):
                pass
        it = AsyncMultiDataSetIterator(BoomIter(), queue_size=2)
        with pytest.raises(RuntimeError, match="multi boom"):
            it.next()
        assert not it.has_next()

    def test_reset_under_load(self):
        class Source(_ListMultiIter):
            def __init__(self):
                super().__init__([])
                self.consumed = 0

            def has_next(self):
                return self._i < 5000

            def next(self):
                self.consumed += 1
                self._i += 1
                return MultiDataSet([np.zeros((2, 2), np.float32)],
                                    [np.zeros((2, 1), np.float32)])
        src = Source()
        it = AsyncMultiDataSetIterator(src, queue_size=2)
        it.next()
        it.reset()
        assert src.consumed < 100
        assert sum(1 for _ in it) == 5000
