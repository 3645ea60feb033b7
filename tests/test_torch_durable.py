"""The port's durable training (``util/durable.py``) on the CPU: the cases
of ``tests/test_durable.py``, the kill-and-resume chaos at exact step
boundaries (in process and in a child process — this file run as a
script is the child, PyTorch only), and snapshots across packages.

Within the port everything is bit for bit: a resumed run's per-step
losses and final parameters equal an uninterrupted run's exactly.
Across packages (a snapshot written by the reference's
``DurableTrainer`` resumed by the port, and one written by the port
loaded by the reference's ``CheckpointStore``), the two continuations are
compared within 1e-4 relative — the adam-step bound of
``tests/test_torch_multilayer.py`` (adam divides by sqrt(v) + eps, which
grows a summation-order difference); the resumed counters, cursor and
parameters at the resume point are exact. The ``digest`` stays each
package's own and is never compared across packages.

The last test is the port of ``tests/test_serving.py::
test_unbounded_stream_fit_with_mid_training_hot_swap``.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (AsyncDataSetIterator, DataSet,
                                               ExistingDataSetIterator,
                                               ListDataSetIterator,
                                               MultipleEpochsIterator,
                                               SamplingDataSetIterator)
from deeplearning4j_tpu_torch.util import faults
from deeplearning4j_tpu_torch.util.durable import (
    AsyncCheckpointWriter, CheckpointStore, DurableSession, DurableTrainer,
    PreemptionHandler, StepWatchdog, TrainingState, WatchdogTimeout,
    is_seekable, params_digest)
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.serialization import CheckpointInvalid

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
N_BATCHES, BATCH, FEATURES, CLASSES = 6, 8, 5, 3
XPKG_TOL = 1e-4


# ----------------------------------------------------------------------
# the toy problem (shared by the child process and the parent)
# ----------------------------------------------------------------------

def build_net(seed=7, device="cpu"):
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(seed).updater("adam")
            .learning_rate(0.01).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=CLASSES, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(FEATURES)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _toy_arrays(seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_BATCHES * BATCH, FEATURES)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[
        rng.integers(0, CLASSES, N_BATCHES * BATCH)]
    return x, y


def build_iterator(seed=7, pkg=None):
    x, y = _toy_arrays(seed)
    if pkg is None:
        return ListDataSetIterator(
            [DataSet(x[i * BATCH:(i + 1) * BATCH],
                     y[i * BATCH:(i + 1) * BATCH])
             for i in range(N_BATCHES)], batch_size=BATCH)
    return pkg.ListDataSetIterator(
        [pkg.DataSet(x[i * BATCH:(i + 1) * BATCH],
                     y[i * BATCH:(i + 1) * BATCH])
         for i in range(N_BATCHES)], batch_size=BATCH)


REC_IMAGE = 3


def build_conv_net(seed=7):
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                         GlobalPoolingLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(seed).updater("adam")
            .learning_rate(0.01).list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(2, 2),
                                    border_mode="same", activation="relu"))
            .layer(GlobalPoolingLayer(pooling_type="avg"))
            .layer(OutputLayer(n_out=CLASSES, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(REC_IMAGE, REC_IMAGE, 1))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def write_records(records_dir, seed=7):
    from deeplearning4j_tpu_torch.data.records import write_shard_set
    rng = np.random.default_rng(seed)
    n = N_BATCHES * BATCH
    imgs = rng.integers(0, 256, (n, REC_IMAGE, REC_IMAGE, 1), dtype=np.uint8)
    labels = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]
    return write_shard_set(records_dir, "toy",
                           [{"features": imgs[i], "labels": labels[i]}
                            for i in range(n)], 3)


def build_records_iterator(records_dir, seed=7):
    from deeplearning4j_tpu_torch.data.pipeline import (Augment,
                                                        RecordDataSetIterator)
    return RecordDataSetIterator(
        records_dir, "toy", batch_size=BATCH, seed=seed, shuffle_shards=True,
        shuffle_buffer=10, augment=Augment(crop_pad=1, flip=True,
                                           scale=1 / 255.0))


class Scores:
    def __init__(self, sink):
        self.sink = sink

    def iteration_done(self, model, iteration, score):
        self.sink.append(float(score))

    def on_epoch_start(self, *a):
        pass

    def on_epoch_end(self, *a):
        pass


def params_sha(net):
    h = hashlib.sha256()
    for v in sorted(net.params):
        for k in sorted(net.params[v]):
            h.update(net.params[v][k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _reference_run(epochs, records_dir=None):
    net = build_conv_net() if records_dir else build_net()
    scores = []
    net.add_listener(Scores(scores))
    net.fit(build_records_iterator(records_dir) if records_dir
            else build_iterator(), epochs=epochs)
    return net, scores


def _assert_same_params(a, b):
    for v in a.params:
        for k in a.params[v]:
            assert torch.equal(a.params[v][k], b.params[v][k]), (v, k)


# ----------------------------------------------------------------------
# the child process: python tests/test_torch_durable.py '<json config>'
# ----------------------------------------------------------------------

def _child_main(cfg):
    from deeplearning4j_tpu_torch.util import faults as _faults
    d = cfg["checkpoint_dir"]
    os.environ["DL4JTPU_FLIGHT_DIR"] = d
    records = cfg.get("records_dir")
    net = build_conv_net() if records else build_net()
    data = build_records_iterator(records) if records else build_iterator()
    trainer = DurableTrainer(net, d, frequency=cfg["frequency"],
                             handle_signals=True,
                             async_writes=cfg.get("async", True))
    scores = []
    trainer.net.add_listener(Scores(scores))
    plan = _faults.FaultPlan()
    mode, kill_at = cfg.get("kill_mode"), cfg.get("kill_at_iteration")

    def at_step(payload):
        if payload["iteration"] != kill_at:
            return
        if mode == "exit":
            os._exit(9)
        if mode == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
    if mode in ("exit", "sigterm"):
        plan.always("training.step", exc=at_step)
    if mode == "tear":
        def tear(payload):
            with open(payload["path"], "wb") as f:
                f.write(payload["data"][:max(1, len(payload["data"]) // 3)])
            os._exit(9)
        plan.fail("checkpoint.write", after=cfg["tear_after"], times=1,
                  exc=tear)
    with plan.active():
        trainer.fit(data, epochs=cfg["total_epochs"])
    with open(os.path.join(d, "result.json"), "w") as f:
        json.dump({"resumed": trainer.resumed,
                   "preempted": trainer.preempted,
                   "iteration_count": trainer.net.iteration_count,
                   "epoch_count": trainer.net.epoch_count,
                   "scores": scores,
                   "params_sha": params_sha(trainer.net)}, f)


def run_child(cfg, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    proc = subprocess.run([sys.executable, HERE, json.dumps(cfg)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=REPO)
    return proc.returncode, proc.stderr


# ----------------------------------------------------------------------
# seekable protocol
# ----------------------------------------------------------------------

class TestSeekableSources:
    def _batches(self, n=6):
        return [DataSet(np.full((2, 3), i, np.float32),
                        np.ones((2, 1), np.float32)) for i in range(n)]

    def test_list_iterator_roundtrip(self):
        it = ListDataSetIterator(self._batches(), batch_size=2)
        assert is_seekable(it)
        it.next(), it.next()
        st = it.state()
        rest = [it.next().features[0, 0] for _ in range(4)]
        it2 = ListDataSetIterator(self._batches(), batch_size=2)
        it2.restore(st)
        assert [it2.next().features[0, 0] for _ in range(4)] == rest
        assert not it2.has_next()

    def test_async_wrapper_half_protocol_base_not_seekable(self):
        batches = self._batches(3)

        class HalfSeekable:
            batch_size = 2

            def __init__(self):
                self.pos = 0

            def __iter__(self):
                while self.pos < len(batches):
                    b = batches[self.pos]
                    self.pos += 1
                    yield b

            def has_next(self):
                return self.pos < len(batches)

            def reset(self):
                self.pos = 0

            def state(self):
                return {"pos": self.pos}

        it = AsyncDataSetIterator(HalfSeekable())
        try:
            assert not it.seekable()
            assert not is_seekable(it)
        finally:
            it.close()

    def test_multiple_epochs_over_non_seekable_base_not_seekable(self):
        it = MultipleEpochsIterator(
            2, ExistingDataSetIterator(self._batches(3)))
        assert not is_seekable(it)
        it2 = MultipleEpochsIterator(
            2, ListDataSetIterator(self._batches(3), batch_size=2))
        assert is_seekable(it2)

    def test_multiple_epochs_cursor_carries_epoch(self):
        it = MultipleEpochsIterator(
            2, ListDataSetIterator(self._batches(3), batch_size=2))
        for _ in range(4):
            it.next()
        st = it.state()
        assert st["epoch"] == 1
        rest = [it.next().features[0, 0] for _ in range(2)]
        it2 = MultipleEpochsIterator(
            2, ListDataSetIterator(self._batches(3), batch_size=2))
        it2.restore(st)
        assert [it2.next().features[0, 0] for _ in range(2)] == rest
        assert not it2.has_next()

    def test_sampling_iterator_restores_exact_rng_stream(self):
        data = DataSet(np.arange(40, dtype=np.float32).reshape(20, 2),
                       np.ones((20, 1), np.float32))
        it = SamplingDataSetIterator(data, batch_size=4, total_batches=6,
                                     seed=3)
        it.next(), it.next()
        st = it.state()
        rest = [np.asarray(it.next().features) for _ in range(4)]
        it2 = SamplingDataSetIterator(data, batch_size=4, total_batches=6,
                                      seed=3)
        it2.restore(st)
        for want in rest:
            np.testing.assert_array_equal(np.asarray(it2.next().features),
                                          want)
        assert not it2.has_next()

    def test_async_wrapper_tracks_consumer_not_prefetch(self):
        base = ListDataSetIterator(self._batches(8), batch_size=2)
        it = AsyncDataSetIterator(base, queue_size=4)
        consumed = [it.next() for _ in range(3)]
        st = it.state()
        assert st == {"cursor": 3}
        rest = [it.next().features[0, 0] for _ in range(5)]
        it2 = AsyncDataSetIterator(
            ListDataSetIterator(self._batches(8), batch_size=2),
            queue_size=4)
        it2.restore(st)
        assert [it2.next().features[0, 0] for _ in range(5)] == rest
        assert not it2.has_next()
        assert consumed[0].features[0, 0] == 0.0


# ----------------------------------------------------------------------
# commit protocol
# ----------------------------------------------------------------------

class TestCommitProtocol:
    def _two_snapshots(self, tmp_path):
        net = build_net()
        it = build_iterator()
        store = CheckpointStore(str(tmp_path), keep=5, device="cpu")
        net.fit(it, epochs=1)
        first = store.save(TrainingState.capture(net, cursor=None))
        it.reset()
        net.fit(it, epochs=1)
        second = store.save(TrainingState.capture(net, cursor={"cursor": 6}))
        return store, net, first, second

    def test_roundtrip_restores_counters_cursor_digest(self, tmp_path):
        store, net, first, second = self._two_snapshots(tmp_path)
        loaded = store.load_latest()
        assert loaded.path == second
        assert loaded.cursor == {"cursor": 6}
        assert loaded.epoch_count == net.epoch_count
        assert loaded.iteration_count == net.iteration_count
        assert loaded.update_count == net._update_count
        assert loaded.digest == params_digest(net.params, net.updater_state,
                                              net._update_count)
        _assert_same_params(net, loaded.net)
        for v, ps in net.updater_state.items():
            assert set(ps) == set(loaded.net.updater_state[v])

    def test_layout_matches_the_reference(self, tmp_path):
        store, net, first, second = self._two_snapshots(tmp_path)
        assert sorted(os.listdir(second)) == ["COMMIT", "cursor.json",
                                              "model.zip"]
        assert os.path.basename(second) == "state_epoch2_iter12"
        doc = json.load(open(os.path.join(second, "cursor.json")))
        assert set(doc) == {"version", "kind", "model_class", "epoch_count",
                            "iteration_count", "update_count", "cursor",
                            "rng", "digest"}
        assert doc["version"] == 1 and doc["model_class"] == \
            "MultiLayerNetwork"
        marker = json.load(open(os.path.join(second, "COMMIT")))
        assert marker["version"] == 1
        assert set(marker["manifest"]) == {"model.zip", "cursor.json"}

    def test_missing_commit_marker_falls_back(self, tmp_path):
        store, net, first, second = self._two_snapshots(tmp_path)
        os.remove(os.path.join(second, "COMMIT"))
        with pytest.raises(CheckpointInvalid, match="COMMIT"):
            store.validate(second)
        assert store.latest_valid() == first
        assert store.load_latest().path == first

    def test_corrupt_model_bytes_fall_back(self, tmp_path):
        store, net, first, second = self._two_snapshots(tmp_path)
        mp = os.path.join(second, "model.zip")
        blob = bytearray(open(mp, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(mp, "wb").write(bytes(blob))
        assert store.latest_valid() == first

    def test_fault_during_write_leaves_previous_valid(self, tmp_path):
        store, net, first, second = self._two_snapshots(tmp_path)
        it = build_iterator()
        net.fit(it, epochs=1)
        plan = faults.FaultPlan().fail("checkpoint.write",
                                       exc=IOError("disk gone"))
        with plan.active():
            with pytest.raises(IOError, match="disk gone"):
                store.save(TrainingState.capture(net, cursor=None))
        assert plan.triggered == [("checkpoint.write", 1)]
        assert not [n for n in os.listdir(tmp_path)
                    if n.startswith(".wipstate_")]
        assert store.load_latest().path == second

    def test_commit_gate_refusal_publishes_nothing(self, tmp_path):
        store, net, first, second = self._two_snapshots(tmp_path)
        before = store.snapshots()
        net.fit(build_iterator(), epochs=1)
        out = store.save(TrainingState.capture(net, cursor=None),
                         commit_gate=lambda digest: False)
        assert out is None
        assert store.snapshots() == before

    @pytest.mark.cuda
    @pytest.mark.parametrize("slot_bytes", [40, 1 << 26])
    def test_to_host_on_the_card_copies_the_capture(self, monkeypatch,
                                                    slot_bytes):
        """The writer's copy through the two pinned slots, at a slot size
        that splits tensors across slots and at the package's, lands the
        capture's values while the net trains on in place."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        from deeplearning4j_tpu_torch.util import durable
        monkeypatch.setattr(durable, "_HOST_SLOT_BYTES", slot_bytes)
        net = build_net(device="cuda")
        net.fit(build_iterator(), epochs=1)
        state = TrainingState.capture(net)
        want = [[(k, t.detach().cpu().clone()) for k, t in
                 durable._leaves(tree, "")]
                for tree in (net.params, net.state, net.updater_state)]
        net.fit(build_iterator(), epochs=1)      # updates in place
        state.to_host()
        for tree, w in zip((state.params, state.layer_state,
                            state.updater_state), want):
            got = durable._leaves(tree, "")
            assert [k for k, _ in got] == [k for k, _ in w]
            for (_, g), (_, x) in zip(got, w):
                assert g.device.type == "cpu" and torch.equal(g, x)

    def test_capture_is_a_copy(self, tmp_path):
        net = build_net()
        state = TrainingState.capture(net)
        before = {v: {k: p.clone() for k, p in ps.items()}
                  for v, ps in net.params.items()}
        net.fit(build_iterator(), epochs=1)      # updates in place
        for v, ps in state.params.items():
            for k, p in ps.items():
                assert torch.equal(p, before[v][k])


# ----------------------------------------------------------------------
# snapshots across packages
# ----------------------------------------------------------------------

def _ref_net_and_iter():
    import _kill_harness as harness
    return harness.build_net(), harness.build_iterator()


def _ref_params(jnet):
    return {v: {k: np.asarray(a, np.float64) for k, a in ps.items()}
            for v, ps in jnet.params.items()}


def _close(got, want, tol=XPKG_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= tol


class TestAcrossPackages:
    def test_reference_snapshot_resumes_in_the_port(self, tmp_path):
        """The reference's DurableTrainer is preempted mid-epoch 2; the
        port resumes the snapshot (its cursor included) and finishes, and
        so does the reference: the two continuations agree."""
        import deeplearning4j_tpu.datasets as J
        from deeplearning4j_tpu.util import faults as jfaults
        from deeplearning4j_tpu.util.durable import \
            DurableTrainer as JTrainer
        import shutil
        ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
        jnet, _ = _ref_net_and_iter()
        t1 = JTrainer(jnet, str(ref_dir), frequency=100,
                      handle_signals=True)
        plan = jfaults.FaultPlan()

        def preempt(payload):
            if payload["iteration"] == 8:
                t1.session.preemption.request()
        plan.always("training.step", exc=preempt)
        with plan.active():
            t1.fit(build_iterator(pkg=J), epochs=2)
        assert t1.preempted and t1.net.iteration_count == 9
        snap = sorted(n for n in os.listdir(ref_dir)
                      if n.startswith("state_"))[-1]
        assert snap == "state_epoch1_iter9"
        shutil.copytree(ref_dir, port_dir)

        port = DurableTrainer(build_net(), str(port_dir), frequency=100,
                              handle_signals=False)
        assert port.resumed and port.net.iteration_count == 9
        assert port.net.epoch_count == 1
        for v, ps in _ref_params(t1.net).items():
            for k, a in ps.items():    # the resume point is exact
                np.testing.assert_array_equal(
                    port.net.params[v][k].detach().numpy().astype(np.float64), a)
        ts = []
        port.net.add_listener(Scores(ts))
        port.fit(build_iterator(), epochs=2)

        jcont = JTrainer(_ref_net_and_iter()[0], str(ref_dir),
                         frequency=100, handle_signals=False)
        assert jcont.resumed
        js = []
        jcont.net.add_listener(Scores(js))
        jcont.fit(build_iterator(pkg=J), epochs=2)
        assert port.net.iteration_count == jcont.net.iteration_count == 12
        assert len(ts) == len(js) == 3
        _close(ts, js)
        for v, ps in _ref_params(jcont.net).items():
            for k, a in ps.items():
                _close(port.net.params[v][k].detach().numpy(), a)

    def test_port_snapshot_loads_in_the_reference(self, tmp_path):
        import deeplearning4j_tpu.datasets as J
        from deeplearning4j_tpu.util.durable import \
            CheckpointStore as JStore
        t1 = DurableTrainer(build_net(), str(tmp_path), frequency=100,
                            handle_signals=True)
        plan = faults.FaultPlan()

        def preempt(payload):
            if payload["iteration"] == 8:
                t1.session.preemption.request()
        plan.always("training.step", exc=preempt)
        with plan.active():
            t1.fit(build_iterator(), epochs=2)
        assert t1.preempted
        loaded = JStore(str(tmp_path)).load_latest()
        assert loaded is not None
        assert (loaded.epoch_count, loaded.iteration_count,
                loaded.update_count) == (1, 9, 9)
        assert loaded.cursor == {"cursor": 3}
        for v, ps in _ref_params(loaded.net).items():
            for k, a in ps.items():
                np.testing.assert_array_equal(
                    t1.net.params[v][k].detach().numpy().astype(np.float64), a)
        # both packages continue from it: the continuations agree
        it = build_iterator(pkg=J)
        it.restore(loaded.cursor)
        js = []
        loaded.net.add_listener(Scores(js))
        loaded.net.fit(it, epochs=1)
        t2 = DurableTrainer(build_net(), str(tmp_path), frequency=100,
                            handle_signals=False)
        ts = []
        t2.net.add_listener(Scores(ts))
        t2.fit(build_iterator(), epochs=2)
        assert len(ts) == len(js) == 3
        _close(ts, js)


# ----------------------------------------------------------------------
# async writer
# ----------------------------------------------------------------------

class TestAsyncCheckpointWriter:
    def test_single_outstanding(self, tmp_path):
        gate = threading.Event()

        class SlowStore(CheckpointStore):
            def save(self, state, **kw):
                gate.wait(10.0)
                return super().save(state, **kw)

        reg = MetricsRegistry()
        net = build_net()
        net.fit(build_iterator(), epochs=1)
        w = AsyncCheckpointWriter(SlowStore(str(tmp_path), device="cpu"),
                                  registry=reg)
        try:
            assert w.submit(TrainingState.capture(net))
            assert w.would_drop()
            assert not w.submit(TrainingState.capture(net))
            skipped = reg.get("checkpoint_writes_skipped_total")
            assert skipped.snapshot()["series"][0]["value"] == 2
            gate.set()
            assert w.drain(timeout=10.0)
            net.fit(build_iterator(), epochs=2)
            assert w.submit(TrainingState.capture(net))
            assert w.drain(timeout=10.0)
        finally:
            gate.set()
            w.close()
        commits = reg.get("checkpoint_commits_total").snapshot()["series"]
        assert sum(s["value"] for s in commits) == 2
        hist = reg.get("checkpoint_write_seconds").snapshot()["series"][0]
        assert hist["count"] == 2

    def test_collective_mode_waits_instead_of_skipping(self, tmp_path):
        gate = threading.Event()
        first_started = threading.Event()

        class SlowStore(CheckpointStore):
            def save(self, state, **kw):
                first_started.set()
                gate.wait(10.0)
                return super().save(state, **kw)

        reg = MetricsRegistry()
        net = build_net()
        net.fit(build_iterator(), epochs=1)
        w = AsyncCheckpointWriter(SlowStore(str(tmp_path), keep=8,
                                            device="cpu"),
                                  registry=reg, collective=True)
        try:
            assert w.submit(TrainingState.capture(net))
            first_started.wait(10.0)
            threading.Timer(0.2, gate.set).start()
            net.fit(build_iterator(), epochs=2)
            assert w.submit(TrainingState.capture(net))
            assert w.drain(timeout=10.0)
        finally:
            gate.set()
            w.close()
        assert reg.get("checkpoint_writes_skipped_total") is None
        commits = reg.get("checkpoint_commits_total").snapshot()["series"]
        assert sum(s["value"] for s in commits) == 2

    def test_write_failure_is_contained(self, tmp_path):
        reg = MetricsRegistry()
        net = build_net()
        net.fit(build_iterator(), epochs=1)
        w = AsyncCheckpointWriter(CheckpointStore(str(tmp_path),
                                                  device="cpu"),
                                  registry=reg)
        plan = faults.FaultPlan().fail("checkpoint.write",
                                       exc=IOError("enospc"))
        try:
            with plan.active():
                assert w.submit(TrainingState.capture(net))
                assert w.drain(timeout=10.0)
        finally:
            w.close()
        assert isinstance(w.last_error, IOError)
        failures = reg.get("checkpoint_write_failures_total")
        assert failures.snapshot()["series"][0]["value"] == 1


# ----------------------------------------------------------------------
# watchdog
# ----------------------------------------------------------------------

class TestStepWatchdog:
    def test_expiry_dump_names_queues_breakers_and_span(self):
        from deeplearning4j_tpu_torch.util.resilience import (CircuitBreaker,
                                                              ManualClock)
        from deeplearning4j_tpu_torch.util.tracing import Tracer
        clock = ManualClock()
        breaker = CircuitBreaker(name="wd-test-breaker", failure_threshold=1)
        breaker.record_failure()
        tracer = Tracer()
        wd = StepWatchdog(5.0, clock=clock)
        wd.arm()
        with tracer.span("fit.step", attributes={"iteration": 3}):
            wd.pet()
        clock.advance(5.1)
        with pytest.raises(WatchdogTimeout) as ei:
            wd.check()
        dump = ei.value.dump
        assert dump["breakers"]["wd-test-breaker"] == "open"
        assert dump["active_span"]["name"] == "fit.step"
        assert "queue_depths" in dump
        assert dump["deadline_s"] == 5.0
        wd.disarm()

    def test_progress_keeps_it_quiet(self):
        from deeplearning4j_tpu_torch.util.resilience import ManualClock
        clock = ManualClock()
        wd = StepWatchdog(5.0, clock=clock)
        wd.arm()
        for _ in range(10):
            clock.advance(4.0)
            wd.pet()
        wd.check()
        wd.disarm()

    def test_threaded_expiry_unwinds_hung_dispatch_despite_handler(self):
        handler = PreemptionHandler().install()
        wd = StepWatchdog(0.2, thread=True, poll_interval_s=0.02)
        try:
            wd.arm()
            with pytest.raises(KeyboardInterrupt):
                time.sleep(10)
            assert not handler.requested
            assert wd.last_dump is not None
        finally:
            wd.disarm()
            handler.uninstall()

    def test_rearm_after_expiry_restarts_monitor_thread(self):
        fired = []
        wd = StepWatchdog(0.05, thread=True, poll_interval_s=0.01,
                          on_timeout=fired.append)
        wd.arm()
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fired
        wd._thread.join(timeout=5.0)
        wd.arm()
        assert wd._thread.is_alive()
        wd.disarm()

    def test_earlystopping_trainer_pets_watchdog(self):
        from deeplearning4j_tpu_torch.earlystopping import (
            DataSetLossCalculator, EarlyStoppingConfiguration,
            EarlyStoppingTrainer, InMemoryModelSaver,
            MaxEpochsTerminationCondition)
        from deeplearning4j_tpu_torch.util.resilience import ManualClock
        cfg = EarlyStoppingConfiguration(
            epoch_termination_conditions=[MaxEpochsTerminationCondition(1)],
            score_calculator=DataSetLossCalculator(build_iterator()),
            model_saver=InMemoryModelSaver())
        clock = ManualClock()
        wd = StepWatchdog(5.0, clock=clock)
        pets = []
        real_pet = wd.pet
        wd.pet = lambda: (pets.append(1), real_pet())
        plan = faults.FaultPlan()
        trainer = EarlyStoppingTrainer(cfg, build_net(), build_iterator(),
                                       watchdog=wd)
        with plan.active():
            trainer.fit()
        assert plan.calls("training.step") == N_BATCHES
        assert len(pets) == N_BATCHES

    def test_hung_source_raises_watchdog_timeout(self, tmp_path):
        """A source that hangs forever under DurableTrainer(watchdog_s=…)
        surfaces as WatchdogTimeout with its dump, signal handling on."""
        release = threading.Event()

        class Hung(ListDataSetIterator):
            def next(self):
                if self._cursor == 2:
                    release.wait(30.0)
                return super().next()
        x, y = _toy_arrays()
        it = Hung([DataSet(x[i * BATCH:(i + 1) * BATCH],
                           y[i * BATCH:(i + 1) * BATCH])
                   for i in range(N_BATCHES)], batch_size=BATCH)
        os.environ["DL4JTPU_INGEST"] = "0"    # hang on the main thread
        try:
            t = DurableTrainer(build_net(), str(tmp_path), frequency=100,
                               watchdog_s=0.5, handle_signals=True)
            t0 = time.monotonic()
            with pytest.raises(WatchdogTimeout) as ei:
                t.fit(it, epochs=1)
            assert time.monotonic() - t0 < 10.0
            assert "queue_depths" in ei.value.dump
        finally:
            release.set()
            del os.environ["DL4JTPU_INGEST"]


# ----------------------------------------------------------------------
# kill-and-resume exactness, in process
# ----------------------------------------------------------------------

class TestKillResumeExactness:
    EPOCHS = 2
    TOTAL = 2 * N_BATCHES

    def _resume_and_finish(self, tmp_path, scores):
        t2 = DurableTrainer(build_net(), str(tmp_path), frequency=2,
                            handle_signals=False, async_writes=False)
        assert t2.resumed
        resumed_from = t2.net.iteration_count
        t2.net.add_listener(Scores(scores))
        t2.fit(build_iterator(), epochs=self.EPOCHS)
        return t2.net, resumed_from

    def test_kill_at_mid_epoch_step_boundary(self, tmp_path):
        ref_net, ref_scores = _reference_run(self.EPOCHS)
        scores = []
        t1 = DurableTrainer(build_net(), str(tmp_path), frequency=2,
                            handle_signals=False, async_writes=False)
        t1.net.add_listener(Scores(scores))
        plan = faults.FaultPlan()

        def die(payload):
            if payload["iteration"] == 9:
                raise faults.InjectedFault("preempted at step boundary")
        plan.always("training.step", exc=die)
        with plan.active():
            with pytest.raises(faults.InjectedFault):
                t1.fit(build_iterator(), epochs=self.EPOCHS)
        assert ("training.step", 10) in plan.triggered
        assert len(scores) == 9
        net, resumed_from = self._resume_and_finish(tmp_path, scores)
        assert resumed_from == 8
        assert net.iteration_count == self.TOTAL
        assert scores[:9] == ref_scores[:9]
        assert scores[9 + (9 - resumed_from):] == ref_scores[9:]
        _assert_same_params(ref_net, net)

    def test_kill_during_checkpoint_write_falls_back_exactly(self,
                                                             tmp_path):
        ref_net, ref_scores = _reference_run(self.EPOCHS)
        scores = []
        t1 = DurableTrainer(build_net(), str(tmp_path), frequency=2,
                            handle_signals=False, async_writes=False)
        t1.net.add_listener(Scores(scores))

        def tear(payload):
            with open(payload["path"], "wb") as f:
                f.write(payload["data"][:max(1, len(payload["data"]) // 3)])
            raise IOError("writer killed mid-stream")
        # snapshots at iter 2, 4, 6 (periodic), 6 (boundary), 8: three
        # checkpoint.write calls each; call 13 is the iter-8 model.zip
        plan = faults.FaultPlan().fail("checkpoint.write", after=12,
                                       times=1, exc=tear)
        with plan.active():
            with pytest.raises(IOError, match="mid-stream"):
                t1.fit(build_iterator(), epochs=self.EPOCHS)
        assert plan.triggered == [("checkpoint.write", 13)]
        assert len(scores) == 8
        net, resumed_from = self._resume_and_finish(tmp_path, scores)
        assert resumed_from == 6
        assert net.iteration_count == self.TOTAL
        assert scores[:8] == ref_scores[:8]
        assert scores[8 + (8 - resumed_from):] == ref_scores[8:]
        _assert_same_params(ref_net, net)

    def test_programmatic_preemption_drains_and_resumes_exactly(
            self, tmp_path):
        ref_net, ref_scores = _reference_run(self.EPOCHS)
        scores = []
        t1 = DurableTrainer(build_net(), str(tmp_path), frequency=100,
                            handle_signals=True)
        t1.net.add_listener(Scores(scores))
        plan = faults.FaultPlan()

        def preempt(payload):
            if payload["iteration"] == 8:
                t1.session.preemption.request()
        plan.always("training.step", exc=preempt)
        with plan.active():
            t1.fit(build_iterator(), epochs=self.EPOCHS)
        assert t1.preempted
        assert t1.net.iteration_count == 9
        t2 = DurableTrainer(build_net(), str(tmp_path), frequency=100,
                            handle_signals=False)
        assert t2.resumed and t2.net.iteration_count == 9
        t2.net.add_listener(Scores(scores))
        t2.fit(build_iterator(), epochs=self.EPOCHS)
        assert not t2.preempted
        assert t2.net.iteration_count == self.TOTAL
        assert scores == ref_scores
        _assert_same_params(ref_net, t2.net)

    def test_async_writes_resume_exactly(self, tmp_path):
        """The default async writer (device clones, host copy and
        serialization on the writer thread) leaves snapshots that resume
        exactly."""
        ref_net, ref_scores = _reference_run(self.EPOCHS)
        scores = []
        t1 = DurableTrainer(build_net(), str(tmp_path), frequency=2,
                            handle_signals=False)
        t1.net.add_listener(Scores(scores))
        plan = faults.FaultPlan()

        def die(payload):
            if payload["iteration"] == 10:
                raise faults.InjectedFault("crash")
        plan.always("training.step", exc=die)
        with plan.active():
            with pytest.raises(faults.InjectedFault):
                t1.fit(build_iterator(), epochs=self.EPOCHS)
        t1.session.writer.drain(10.0)
        t2 = DurableTrainer(build_net(), str(tmp_path), frequency=2,
                            handle_signals=False)
        assert t2.resumed
        k = t2.net.iteration_count
        assert 0 < k <= 10
        tail = []
        t2.net.add_listener(Scores(tail))
        t2.fit(build_iterator(), epochs=self.EPOCHS)
        assert tail == ref_scores[k:]
        _assert_same_params(ref_net, t2.net)


# ----------------------------------------------------------------------
# kill-and-resume in a child process
# ----------------------------------------------------------------------

class TestSubprocessKillResume:
    def test_hard_kill_then_fresh_process_resume_matches(self, tmp_path):
        d = str(tmp_path)
        rc, err = run_child({"checkpoint_dir": d, "total_epochs": 2,
                             "frequency": 2, "kill_mode": "exit",
                             "kill_at_iteration": 5, "async": False})
        assert rc == 9, err
        assert not os.path.exists(os.path.join(d, "result.json"))
        assert [n for n in os.listdir(d) if n.startswith("state_")]
        t2 = DurableTrainer(build_net(), d, frequency=2,
                            handle_signals=False)
        assert t2.resumed and t2.net.iteration_count == 4
        tail = []
        t2.net.add_listener(Scores(tail))
        t2.fit(build_iterator(), epochs=2)
        ref_net, ref_scores = _reference_run(2)
        assert tail == ref_scores[4:]
        assert params_sha(t2.net) == params_sha(ref_net)

    def test_kill_during_write_in_child_falls_back(self, tmp_path):
        d = str(tmp_path)
        rc, err = run_child({"checkpoint_dir": d, "total_epochs": 2,
                             "frequency": 2, "kill_mode": "tear",
                             "tear_after": 12, "async": False})
        assert rc == 9, err
        rc, err = run_child({"checkpoint_dir": d, "total_epochs": 2,
                             "frequency": 2})
        assert rc == 0, err
        result = json.load(open(os.path.join(d, "result.json")))
        assert result["resumed"] and result["iteration_count"] == 12
        ref_net, ref_scores = _reference_run(2)
        assert result["params_sha"] == params_sha(ref_net)
        assert result["scores"] == ref_scores[6:]

    def test_sigterm_with_inflight_drains_then_resumes(self, tmp_path):
        d = str(tmp_path)
        rc, err = run_child({"checkpoint_dir": d, "total_epochs": 2,
                             "frequency": 100, "kill_mode": "sigterm",
                             "kill_at_iteration": 8})
        assert rc == 0, err
        result = json.load(open(os.path.join(d, "result.json")))
        assert result["preempted"] and result["iteration_count"] == 9
        t2 = DurableTrainer(build_net(), d, frequency=100,
                            handle_signals=False)
        assert t2.resumed and t2.net.iteration_count == 9
        scores = list(result["scores"])
        t2.net.add_listener(Scores(scores))
        t2.fit(build_iterator(), epochs=2)
        ref_net, ref_scores = _reference_run(2)
        assert scores == ref_scores
        _assert_same_params(ref_net, t2.net)

    def test_sigterm_mid_epoch_over_records_resumes_bit_identical(
            self, tmp_path):
        """The record pipeline (shard shuffle, shuffle buffer, augment
        draws keyed by the batch counter) under a SIGTERM mid-epoch: the
        resumed run equals the uninterrupted one."""
        rec = str(tmp_path / "records")
        write_records(rec)
        d = str(tmp_path / "ckpt")
        rc, err = run_child({"checkpoint_dir": d, "records_dir": rec,
                             "total_epochs": 2, "frequency": 100,
                             "kill_mode": "sigterm",
                             "kill_at_iteration": 8})
        assert rc == 0, err
        result = json.load(open(os.path.join(d, "result.json")))
        assert result["preempted"] and result["iteration_count"] == 9
        t2 = DurableTrainer(build_conv_net(), d, frequency=100,
                            handle_signals=False)
        scores = list(result["scores"])
        t2.net.add_listener(Scores(scores))
        t2.fit(build_records_iterator(rec), epochs=2)
        ref_net, ref_scores = _reference_run(2, records_dir=rec)
        assert scores == ref_scores
        assert params_sha(t2.net) == params_sha(ref_net)


# ----------------------------------------------------------------------
# preemption handler and session mechanics
# ----------------------------------------------------------------------

class TestPreemptionHandler:
    def test_signal_sets_flag_second_signal_raises(self):
        h = PreemptionHandler(signals=(signal.SIGUSR1,))
        with h:
            assert not h.requested
            os.kill(os.getpid(), signal.SIGUSR1)
            deadline = time.monotonic() + 2.0
            while not h.requested and time.monotonic() < deadline:
                pass
            assert h.requested
            with pytest.raises(KeyboardInterrupt):
                h._handle(signal.SIGUSR1, None)
        assert not h.installed

    def test_install_off_the_main_thread_is_a_no_op(self):
        out = []
        t = threading.Thread(
            target=lambda: out.append(PreemptionHandler().install()))
        t.start()
        t.join()
        assert not out[0].installed

    def test_session_max_steps_stops_cleanly(self, tmp_path):
        net = build_net()
        store = CheckpointStore(str(tmp_path), device="cpu")
        it = build_iterator()
        session = DurableSession(net, store, data=it, max_steps=4)
        net.fit(it, epochs=2, session=session)
        assert session.stopped and session.stop_reason == "max_steps"
        assert net.iteration_count == 4
        assert net.epoch_count == 0

    def test_mid_epoch_preempt_non_seekable_keeps_boundary_snapshot(
            self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=8, device="cpu")
        net = build_net()
        data = ExistingDataSetIterator(
            [DataSet(np.ones((2, 5), np.float32),
                     np.ones((2, 3), np.float32))])
        session = DurableSession(net, store, data=data, frequency=1)
        assert not session.seekable
        session.on_epoch_boundary(net)
        assert len(store.snapshots()) == 1
        net.iteration_count += 1
        session.on_step(net)
        assert session.final_snapshot(net) is None
        assert len(store.snapshots()) == 1

    def test_coalesced_stride_checkpoints_every_frequency_window(
            self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep=8, device="cpu")
        net = build_net()
        session = DurableSession(net, store, data=build_iterator(),
                                 frequency=4)
        for _ in range(5):
            net.iteration_count += 3
            session.on_step(net, n_consumed=3)
        assert len(store.snapshots()) == 3

    def test_graph_preempt_and_exact_resume(self, tmp_path):
        from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                             OutputLayer)
        from deeplearning4j_tpu_torch.nn.graph_runtime import \
            ComputationGraph

        def gnet():
            b = (NeuralNetConfiguration.builder().seed(3).updater("adam")
                 .learning_rate(0.01).graph_builder().add_inputs("in")
                 .add_layer("d", DenseLayer(n_in=5, n_out=8,
                                            activation="tanh"), "in")
                 .add_layer("out", OutputLayer(n_in=8, n_out=3,
                                               activation="softmax",
                                               loss="mcxent"), "d")
                 .set_outputs("out"))
            return ComputationGraph(b.build(), device="cpu").init()

        straight = gnet()
        straight.fit(build_iterator(), epochs=1)
        t1 = DurableTrainer(gnet(), str(tmp_path), frequency=2,
                            handle_signals=True, async_writes=False)
        plan = faults.FaultPlan()

        def preempt(payload):
            if payload["iteration"] == 3:
                t1.session.preemption.request()
        plan.always("training.step", exc=preempt)
        with plan.active():
            t1.fit(build_iterator(), epochs=1)
        assert t1.preempted and t1.net.iteration_count == 4
        t2 = DurableTrainer(gnet(), str(tmp_path), frequency=2,
                            handle_signals=False, async_writes=False)
        assert t2.resumed
        assert type(t2.net).__name__ == "ComputationGraph"
        t2.fit(build_iterator(), epochs=1)
        assert t2.net.iteration_count == N_BATCHES
        _assert_same_params(straight, t2.net)


# ----------------------------------------------------------------------
# serving: hot swap while a DurableSession streams an unbounded fit
# ----------------------------------------------------------------------

def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _serve_net(seed):
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(seed).updater("sgd")
            .learning_rate(0.1).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_unbounded_stream_fit_with_mid_training_hot_swap(tmp_path):
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.util.serialization import (load_model,
                                                             save_model)

    def endless():
        gen = np.random.default_rng(42)
        while True:          # unbounded: only the step budget ends fit
            x = gen.normal(size=(8, 5)).astype(np.float32)
            y = np.eye(3, dtype=np.float32)[gen.integers(0, 3, 8)]
            yield DataSet(x, y)

    net = _serve_net(seed=7)
    stream = AsyncDataSetIterator(ExistingDataSetIterator(endless()),
                                  queue_size=2)
    ckpt = str(tmp_path / "mid_training.zip")
    swapped = threading.Event()
    errors = []

    class SwapAt:
        def iteration_done(self, model, iteration, score):
            if iteration == 5:
                save_model(net, ckpt)
                swapped.set()

    net.add_listener(SwapAt())
    session = DurableSession(net, None, data=stream, max_steps=12)

    def train():
        try:
            net.fit(stream, epochs=1, session=session)
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=train)
    t.start()
    try:
        assert swapped.wait(60.0), "training never reached iteration 5"
        server = InferenceServer(_serve_net(seed=1), port=0, device="cpu")
        base = f"http://127.0.0.1:{server.port}"
        try:
            assert _post(base, "/model", {"path": ckpt})["ok"]
            x = np.random.default_rng(3).normal(size=(3, 5)).astype(
                np.float32)
            out = _post(base, "/predict", {"inputs": x.tolist()})["outputs"]
            ref = load_model(ckpt, device="cpu").output(x).numpy()
            assert np.allclose(np.asarray(out), ref, atol=1e-5)
        finally:
            server.stop()
    finally:
        t.join(timeout=120.0)
        stream.close()
    assert not errors, errors
    assert not t.is_alive()
    assert session.stopped and session.stop_reason == "max_steps"
    assert net.iteration_count == 12
    assert net.epoch_count == 0


if __name__ == "__main__":
    _child_main(json.loads(sys.argv[1]))
