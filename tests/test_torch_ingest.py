"""The port's ingest stage and async fit loop (``util/ingest.py``,
``util/xla.py``) on the CPU, the cases of ``tests/test_ingest.py``, and a
staged ``fit`` of a small transformer LM against the JAX package's.

The LM starts from a reference checkpoint (the two packages' generators
differ); both packages fit the same ``ListDataSetIterator`` of numpy
batches; the per-step losses and the final parameters are held to 1e-4
relative (the 20-step adam parity bound of ``tests/test_torch_training.py``:
adam divides by sqrt(v) + eps, which grows a summation-order difference).
Everything else is exact: counts, orders and byte-equal batches.

The card tests (marker ``cuda``) plant faults in the stager — no
``record_stream``, no wait on the copy — and see the gate catch them;
they import no jax, so they run with ``--noconftest`` on a machine
without it.
"""

import logging
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator, DataSet,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.util import ingest
from deeplearning4j_tpu_torch.util import metrics as _metrics
from deeplearning4j_tpu_torch.util.xla import pow2_bucket, retrace_guard

LM_TOL = 1e-4


def _mln(seed=1, n_in=4, n_out=3, device="cpu"):
    conf = (NeuralNetConfiguration.builder().seed(seed).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_in=n_in, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=n_out, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _data(n=64, n_in=4, n_out=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]
    return x, y


def _retraces(fn_name):
    c = _metrics.REGISTRY.get("jit_retraces_total")
    return 0.0 if c is None else c.value(fn=fn_name)


def _syncs():
    return ingest.sync_counter().value()


class CountingSyncListener(TrainingListener):
    """Reads the score every ``read_every`` iterations (0 = never)."""

    def __init__(self, read_every: int = 0):
        self.read_every = read_every
        self.seen = []
        self.iterations = 0

    def iteration_done(self, model, iteration, score):
        self.iterations += 1
        if self.read_every and iteration % self.read_every == 0:
            self.seen.append(float(score))


class TestMovedHomes:
    def test_reexports_point_at_the_new_homes(self):
        from deeplearning4j_tpu_torch.optimize import listeners
        from deeplearning4j_tpu_torch.serving import decode, server
        from deeplearning4j_tpu_torch.util import durable, xla
        assert listeners.LazyScore is ingest.LazyScore
        assert listeners.as_listener_score is ingest.as_listener_score
        assert server.params_digest is durable.params_digest
        assert decode.pow2_bucket is xla.pow2_bucket
        assert pow2_bucket(5, 64) == 8 and pow2_bucket(100, 64) == 64

    def test_pow2_bucket_matches_reference(self):
        from deeplearning4j_tpu.util.xla import pow2_bucket as j_bucket
        for n in range(1, 70):
            for cap in (1, 2, 16, 64):
                assert pow2_bucket(n, cap) == j_bucket(n, cap)
        with pytest.raises(ValueError):
            pow2_bucket(0, 8)
        with pytest.raises(ValueError):
            pow2_bucket(3, 12)

    def test_trace_env_key_matches_reference(self, monkeypatch):
        from deeplearning4j_tpu.util.xla import trace_env_key as j_key
        from deeplearning4j_tpu_torch.util.xla import trace_env_key
        assert trace_env_key() == j_key()
        monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "0")
        assert trace_env_key() == j_key() and "fa=0" in trace_env_key()


class TestLazyScore:
    def test_sync_only_on_read(self):
        before = _syncs()
        s = ingest.LazyScore(torch.tensor(2.5))
        assert not s.resolved
        assert _syncs() == before
        assert float(s) == 2.5
        assert s.resolved
        assert _syncs() == before + 1
        assert float(s) == 2.5              # cached: still one sync
        assert _syncs() == before + 1
        assert "2.5" in repr(s)

    def test_host_scalars_pass_through(self):
        assert ingest.as_listener_score(1.25) == 1.25
        assert ingest.as_listener_score(np.float32(1.5)) == 1.5
        assert isinstance(ingest.as_listener_score(torch.tensor(1.0)),
                          ingest.LazyScore)


class TestInflightWindow:
    def test_bounds_pending(self):
        w = ingest.InflightWindow(max_inflight=2)
        for i in range(10):
            w.push(torch.tensor(float(i)) * 2)
            assert len(w) <= 2
        w.drain()
        assert len(w) == 0

    def test_env_default(self, monkeypatch):
        monkeypatch.setenv("DL4JTPU_MAX_INFLIGHT", "5")
        assert ingest.InflightWindow().max_inflight == 5
        monkeypatch.setenv("DL4JTPU_MAX_INFLIGHT", "0")
        with pytest.raises(ValueError):
            ingest.max_inflight_default()


class TestStage:
    def test_batches_staged_in_order(self):
        batches = [(np.full((2, 3), i, np.float32),
                    np.full((2, 1), i, np.float32), None) for i in range(7)]
        staged = ingest.stage(iter(batches), stage_name="t_order",
                              device="cpu")
        got = list(staged)
        assert len(got) == 7
        for i, (x, y, m) in enumerate(got):
            assert torch.is_tensor(x) and torch.is_tensor(y)
            assert m is None
            assert float(x[0, 0]) == i
        bytes_c = _metrics.REGISTRY.get("ingest_h2d_bytes_total")
        assert bytes_c.value(stage="t_order") == sum(
            b[0].nbytes + b[1].nbytes for b in batches)
        assert _metrics.REGISTRY.get("ingest_batches_staged_total").value(
            stage="t_order") == 7

    def test_nested_multi_input_batches_stage(self):
        xs = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.ones((2, 2), np.int32)]
        got = list(ingest.stage(iter([(xs, [xs[0][:, :1]], None)]),
                                stage_name="t_nested", device="cpu"))
        (gx, gy, gm), = got
        assert isinstance(gx, list) and len(gx) == 2
        np.testing.assert_array_equal(gx[0].numpy(), xs[0])
        assert gx[1].dtype == torch.int32
        np.testing.assert_array_equal(gy[0].numpy(), xs[0][:, :1])

    def test_source_error_propagates(self):
        def boom():
            yield (np.zeros((2, 2), np.float32),
                   np.zeros((2, 1), np.float32), None)
            raise RuntimeError("producer exploded")
        it = iter(ingest.stage(boom(), stage_name="t_err", device="cpu"))
        with pytest.raises(RuntimeError, match="producer exploded"):
            for _ in range(5):
                next(it)
        with pytest.raises(StopIteration):
            next(it)

    def test_close_stops_producer(self):
        pulled = []

        def source():
            for i in range(10_000):
                pulled.append(i)
                yield (np.zeros((2, 2), np.float32),
                       np.zeros((2, 1), np.float32), None)
        staged = ingest.stage(source(), stage_name="t_close", queue_size=2,
                              device="cpu")
        next(iter(staged))
        staged.close()
        n = len(pulled)
        assert n < 100
        time.sleep(0.1)
        assert len(pulled) == n

    def test_device_put_false_keeps_host(self):
        batches = [(np.zeros((2, 2), np.float32), None, None)]
        got = list(ingest.stage(iter(batches), stage_name="t_host",
                                device_put=False))
        assert isinstance(got[0][0], np.ndarray)

    def test_spans_when_traced(self):
        from deeplearning4j_tpu_torch.util.tracing import Tracer
        tracer = Tracer()
        batches = [(np.zeros((4, 2), np.float32), None, None)] * 3
        list(ingest.stage(iter(batches), stage_name="t_span", tracer=tracer,
                          device="cpu"))
        spans = tracer.find("ingest.stage")
        assert len(spans) == 3
        assert spans[0].attributes["bytes"] == 4 * 2 * 4

    def test_cuda_target_without_a_card_raises(self, monkeypatch):
        """No fallback that hides the card: a stager asked for a CUDA
        device that is not there refuses instead of staying on the
        host."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ingest.stage(iter([]), stage_name="t_nocard", device="cuda")


class TestCoalesced:
    def _b(self, shape=(4, 2)):
        return (np.zeros(shape, np.float32),
                np.zeros((shape[0], 1), np.float32), None)

    def test_exact_runs_become_scans(self):
        out = list(ingest.coalesced([self._b() for _ in range(5)], 2))
        assert [k for k, _ in out] == ["scan", "scan", "step"]
        xs, ys = out[0][1]
        assert xs.shape == (2, 4, 2) and ys.shape == (2, 4, 1)

    def test_tensor_runs_stack_as_tensors(self):
        b = tuple(None if a is None else torch.from_numpy(a)
                  for a in self._b())
        (kind, (xs, ys)), = list(ingest.coalesced([b, b], 2))
        assert kind == "scan" and torch.is_tensor(xs)
        assert tuple(xs.shape) == (2, 4, 2)

    def test_shape_change_flushes(self):
        batches = [self._b((4, 2)), self._b((4, 2)), self._b((3, 2)),
                   self._b((3, 2))]
        assert [k for k, _ in ingest.coalesced(batches, 2)] == ["scan",
                                                                 "scan"]
        batches = [self._b((4, 2)), self._b((3, 2))]
        assert [k for k, _ in ingest.coalesced(batches, 2)] == ["step",
                                                                 "step"]

    def test_masked_batches_never_coalesce(self):
        m = np.ones((4,), np.float32)
        batches = [(np.zeros((4, 2), np.float32),
                    np.zeros((4, 1), np.float32), m)] * 3
        assert [k for k, _ in ingest.coalesced(batches, 2)] == ["step"] * 3

    def test_k_below_two_is_identity(self):
        batches = [self._b(), self._b()]
        out = list(ingest.coalesced(iter(batches), 0))
        assert [k for k, _ in out] == ["step", "step"]
        assert out[0][1] is batches[0]


class TestRetraceGuard:
    def test_counts_distinct_signatures(self):
        guarded = retrace_guard(lambda x: x * 2, "t_guard.f")
        before = _retraces("t_guard.f")
        a = torch.zeros((3, 2))
        guarded(a)
        guarded(a + 1)
        guarded(torch.zeros((3, 2)))
        assert _retraces("t_guard.f") == before + 1
        guarded(torch.zeros((4, 2)))
        assert _retraces("t_guard.f") == before + 2
        guarded(torch.zeros((3, 2), dtype=torch.float64))
        assert _retraces("t_guard.f") == before + 3
        assert len(guarded.signatures_seen) == 3

    def test_warn_logs_differing_signature(self, monkeypatch, caplog):
        monkeypatch.setenv("DL4JTPU_RETRACE_WARN", "1")
        guarded = retrace_guard(lambda x: x + 1, "t_guard.warn")
        with caplog.at_level(logging.WARNING,
                             logger="deeplearning4j_tpu_torch"):
            guarded(torch.zeros((2, 2)))
            assert not caplog.records
            guarded(torch.zeros((5, 2)))
        msg = next(r.getMessage() for r in caplog.records
                   if "t_guard.warn" in r.getMessage())
        assert "retrace #1 of t_guard.warn" in msg
        assert "(5, 2)" in msg and "(2, 2)" in msg

    def test_first_call_counts_flops(self):
        reg = _metrics.MetricsRegistry()
        a, b = torch.ones((8, 16)), torch.ones((16, 4))
        guarded = retrace_guard(lambda x, y: x @ y, "t_guard.mm", reg)
        out = guarded(a, b)
        torch.testing.assert_close(out, a @ b)
        assert guarded.compiled_costs == {"flops": 2.0 * 8 * 16 * 4}
        assert reg.get("compiled_flops").value(fn="t_guard.mm") == 1024.0
        assert reg.get("xla_compile_seconds").count(fn="t_guard.mm") == 1

    def test_first_call_counts_reported_kernel_flops(self):
        # a kernel launched outside the dispatcher reports its FLOPs; they
        # join the count of the call in progress and nothing else
        from deeplearning4j_tpu_torch.util import xla as _xla
        reg = _metrics.MetricsRegistry()
        a, b = torch.ones((8, 16)), torch.ones((16, 4))

        def step(x, y):
            _xla.count_kernel_flops(1000.0)
            return x @ y
        guarded = retrace_guard(step, "t_guard.kernel", reg)
        guarded(a, b)
        assert guarded.compiled_costs == {"flops": 1024.0 + 1000.0}
        guarded(a, b)      # not counted again, and not left in any tally
        _xla.count_kernel_flops(7.0)
        assert reg.get("compiled_flops").value(fn="t_guard.kernel") == 2024.0
        _, costs = _xla.compiled_costs(lambda: a @ b)
        assert costs == {"flops": 1024.0}


class TestAsyncFitLoop:
    def test_steady_state_fit_one_signature(self):
        net = _mln()
        x, y = _data(64)
        before = _retraces("MultiLayerNetwork.train_step")
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=3)
        assert net.iteration_count == 12
        assert _retraces("MultiLayerNetwork.train_step") == before + 1

    def test_graph_steady_state_one_signature(self):
        conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.1)
                .graph_builder().add_inputs("in")
                .add_layer("d", DenseLayer(n_out=8, activation="tanh"), "in")
                .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "d")
                .set_outputs("out")
                .set_input_types(InputType.feed_forward(4)).build())
        net = ComputationGraph(conf, device="cpu").init()
        x, y = _data(48)
        before = _retraces("ComputationGraph.train_step")
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=2)
        assert net.iteration_count == 6
        assert _retraces("ComputationGraph.train_step") == before + 1

    def test_silent_listener_forces_zero_host_syncs(self):
        net = _mln()
        silent = CountingSyncListener(read_every=0)
        net.set_listeners(silent)
        x, y = _data(64)
        before = _syncs()
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=2)
        assert silent.iterations == 8
        assert _syncs() == before

    def test_frequency_listener_syncs_once_per_window(self):
        net = _mln()
        reader = CountingSyncListener(read_every=4)
        net.set_listeners(reader)
        x, y = _data(64)
        before = _syncs()
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=3)
        assert reader.iterations == 12
        assert len(reader.seen) == 3
        assert _syncs() == before + 3
        assert all(np.isfinite(v) for v in reader.seen)

    def test_final_epoch_skips_reset(self):
        class CountingIter(ArrayDataSetIterator):
            resets = 0

            def reset(self):
                type(self).resets += 1
                super().reset()
        x, y = _data(32)
        it = CountingIter(x, y, 16)
        net = _mln()
        net.fit(it, epochs=3)
        assert CountingIter.resets == 2
        net.fit(it, epochs=1)          # revives the exhausted iterator
        assert net.iteration_count == 8

    def test_coalesced_fit_matches_update_count(self):
        net = _mln()
        x, y = _data(64)
        before = _retraces("MultiLayerNetwork.train_scan")
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=2, coalesce=4)
        assert net._update_count == 8
        assert net.iteration_count == 8
        assert _retraces("MultiLayerNetwork.train_scan") == before + 1

    def test_coalesced_fit_equals_per_step_fit(self):
        """The port's fit_scan is K ordinary steps, each drawing from its
        own update count: coalescing changes the dispatch, not the
        result."""
        x, y = _data(64)
        a, b = _mln(), _mln()
        a.fit(ArrayDataSetIterator(x, y, 16), epochs=2)
        b.fit(ArrayDataSetIterator(x, y, 16), epochs=2, coalesce=4)
        for v in a.params:
            for k in a.params[v]:
                assert torch.equal(a.params[v][k], b.params[v][k])

    def test_fit_learns_with_staging(self):
        net = _mln()
        x, y = _data(96)
        net.fit(ArrayDataSetIterator(x, y, 32), epochs=1)
        first = net.score()
        net.fit(ArrayDataSetIterator(x, y, 32), epochs=20)
        assert net.score() < first

    def test_staging_disabled_still_trains_identically(self, monkeypatch):
        x, y = _data(32)
        a = _mln()
        a.fit(ArrayDataSetIterator(x, y, 16), epochs=2)
        monkeypatch.setenv("DL4JTPU_INGEST", "0")
        staged_before = _metrics.REGISTRY.get(
            "ingest_batches_staged_total").value(stage="fit")
        b = _mln()
        b.fit(ArrayDataSetIterator(x, y, 16), epochs=2)
        assert b.iteration_count == 4
        assert _metrics.REGISTRY.get("ingest_batches_staged_total").value(
            stage="fit") == staged_before
        for v in a.params:
            for k in a.params[v]:
                assert torch.equal(a.params[v][k], b.params[v][k])

    def test_host_gap_histogram_recorded(self):
        h = ingest.host_gap_histogram()
        before = h.count(model="MultiLayerNetwork")
        net = _mln()
        x, y = _data(64)
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=1)
        assert h.count(model="MultiLayerNetwork") == before + 3

    def test_train_step_events_and_step_seam(self):
        from deeplearning4j_tpu_torch.util import faults, flightrecorder
        net = _mln()
        x, y = _data(32)
        plan = faults.FaultPlan()
        with plan.active():
            net.fit(ArrayDataSetIterator(x, y, 16), epochs=1)
        assert plan.calls("training.step") == 2
        ev = [e for e in flightrecorder.events("train_step")
              if e.get("model") == "MultiLayerNetwork"]
        assert ev and ev[-1]["iteration"] == 1 and ev[-1]["dispatch"] == "step"

    def test_profile_steps_env_brackets_the_range(self, monkeypatch,
                                                  tmp_path):
        monkeypatch.setenv("DL4JTPU_PROFILE_STEPS", f"1:3:{tmp_path}")
        net = _mln()
        x, y = _data(64)
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=1)
        runs = list(tmp_path.iterdir())
        assert len(runs) == 1 and (runs[0] / "trace.json").exists()

    def test_measured_flop_rate_is_live(self):
        net = _mln()
        x, y = _data(64)
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=1)
        assert _metrics.REGISTRY.get("compiled_flops").value(
            fn="MultiLayerNetwork.train_step") > 0
        assert _metrics.REGISTRY.get("measured_flops_per_sec").value(
            model="MultiLayerNetwork") > 0


class TestEarlyStoppingIngest:
    def test_trainer_runs_through_staged_batches(self):
        from deeplearning4j_tpu_torch.earlystopping import (
            DataSetLossCalculator, EarlyStoppingConfiguration,
            EarlyStoppingTrainer, MaxEpochsTerminationCondition)
        x, y = _data(64)
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(
                   DataSetLossCalculator(ArrayDataSetIterator(x, y, 32)))
               .epoch_termination_conditions(
                   MaxEpochsTerminationCondition(2))
               .build())
        before = _metrics.REGISTRY.counter(
            "ingest_batches_staged_total", "", ("stage",)).value(
                stage="earlystopping")
        result = EarlyStoppingTrainer(
            cfg, _mln(), ArrayDataSetIterator(x, y, 16)).fit()
        assert result.total_epochs >= 1
        assert _metrics.REGISTRY.get("ingest_batches_staged_total").value(
            stage="earlystopping") > before


# ----------------------------------------------------------------------
# a staged fit of a small transformer LM against the reference's fit
# ----------------------------------------------------------------------

def _lm_batches(V, T, n, seed=11):
    ids = np.random.default_rng(seed).integers(
        0, V, (n, 2, T + 1)).astype(np.int32)
    return [(b[:, :-1], b[:, 1:]) for b in ids]


@pytest.mark.parametrize("staging", ["1", "0"])
def test_staged_lm_fit_tracks_reference_fit(tmp_path, monkeypatch, staging):
    """Both packages ``fit`` the same 6 batches for 2 epochs through their
    own loops (the port's staged on a producer thread, or not): losses
    step by step and the final parameters within 1e-4."""
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterator import \
        ListDataSetIterator as JList
    from deeplearning4j_tpu.models import transformer_lm as j_lm
    from deeplearning4j_tpu.nn.graph_runtime import ComputationGraph as JCG
    from deeplearning4j_tpu.util.serialization import save_model as j_save
    from deeplearning4j_tpu_torch.util.serialization import load_model
    V, T = 128, 32
    jnet = JCG(j_lm(V, n_layers=2, d_model=32, n_heads=2, d_ff=64,
                    dtype="float32", input_ids=True, seed=5,
                    learning_rate=1e-3)).init()
    j_save(jnet, str(tmp_path / "lm.zip"))
    tnet = load_model(str(tmp_path / "lm.zip"), device="cpu")
    batches = _lm_batches(V, T, 6)

    class Sink:
        def __init__(self):
            self.scores = []

        def iteration_done(self, model, iteration, score):
            self.scores.append(float(score))

        def on_epoch_start(self, *a):
            pass

        def on_epoch_end(self, *a):
            pass

    js, ts = Sink(), Sink()
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    jnet.fit(JList([JDataSet(x, y) for x, y in batches]), epochs=2)
    monkeypatch.setenv("DL4JTPU_INGEST", staging)
    tnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]),
             epochs=2)
    assert tnet.iteration_count == jnet.iteration_count == 12
    assert tnet.epoch_count == jnet.epoch_count == 2
    np.testing.assert_allclose(ts.scores, js.scores, rtol=LM_TOL)
    jp = {v: {k: np.asarray(a) for k, a in ps.items()}
          for v, ps in jnet.params.items()}
    for v, ps in tnet.params.items():
        for k, p in ps.items():
            want = jp[v][k]
            err = np.abs(p.detach().numpy() - want).max()
            assert err <= LM_TOL * max(np.abs(want).max(), 1e-30), (v, k)


# ----------------------------------------------------------------------
# on the card: the staging gate catches planted faults
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _staging_gate(plant, n=6, elems=1 << 22):
    """One batch at a time through a DeviceStager: the training stream
    sleeps (~25 ms) then sums the batch; the batch is dropped and the next
    one staged at once. Returns (batches whose sum disagrees, times the
    next copy got the memory of the pending read)."""
    stager = ingest.DeviceStager("cuda", stage_name="t_gate", _plant=plant)
    bad = reused = 0
    for i in range(n):
        torch.cuda.empty_cache()    # the dropped batch's block is the only
        (x, _, _), event = stager.stage(   # free one of its size
            (np.full((elems,), float(i), np.float32), None, None))
        stager.adopt((x, None, None), event)
        ptr = x.data_ptr()
        torch.cuda._sleep(50_000_000)
        s = x.sum()
        del x
        (nx, _, _), _ = stager.stage(
            (np.full((elems,), -1.0, np.float32), None, None))
        reused += nx.data_ptr() == ptr
        del nx
        bad += float(s) != float(i) * elems
    torch.cuda.synchronize()
    return bad, reused


@pytest.mark.cuda
class TestStagingGateOnTheCard:
    def test_staged_batches_are_read_intact(self, cuda):
        assert _staging_gate(None)[0] == 0

    def test_gate_catches_missing_record_stream(self, cuda):
        """Without record_stream the allocator hands a batch's memory to
        the next copy while the step's read of it is still pending, and
        the read sees the next batch."""
        bad, reused = _staging_gate("no_record")
        assert bad > 0 and reused > 0

    def test_gate_catches_missing_wait(self, cuda):
        """Without the waits the training stream reads a batch whose copy
        has not landed: the producer's copy is queued behind a sleep on
        its stream, so the sum reads the buffer before the copy."""
        src = [(np.full((1 << 22,), 1.0, np.float32), None, None)]
        stager = ingest.DeviceStager("cuda", stage_name="t_gate_wait",
                                     _plant="no_wait")
        stager._stream = torch.cuda.Stream()
        with torch.cuda.stream(stager._stream):
            torch.cuda._sleep(200_000_000)
        (x, _, _), event = stager.stage(src[0])
        stager.adopt((x, None, None), event)
        bad = float(x.sum())
        torch.cuda.synchronize()
        good = float(x.sum())
        assert good == float(1 << 22) and bad != good

    def test_inflight_window_polls_events(self, cuda):
        w = ingest.InflightWindow(max_inflight=1)
        a = torch.ones(1 << 20, device="cuda")
        torch.cuda._sleep(100_000_000)
        w.push(a.sum())
        t0 = time.perf_counter()
        w.push(a.sum())                         # waits for the first
        assert time.perf_counter() - t0 > 0.01
        w.drain()
        assert len(w) == 0

    def test_fit_on_the_card_has_no_host_sync(self, cuda):
        net = _mln(device="cuda")
        net.set_listeners(CountingSyncListener(read_every=0))
        x, y = _data(64)
        net.fit(ArrayDataSetIterator(x, y, 16), epochs=1)   # warm
        before = _syncs()
        torch.cuda.set_sync_debug_mode("error")
        try:
            net.fit(ArrayDataSetIterator(x, y, 16), epochs=2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert _syncs() == before and net.iteration_count == 12
