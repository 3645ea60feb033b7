"""The port's training-health telemetry against the JAX package's, on the
CPU: ``util/health.py``'s per-layer stats from the same weights and batch,
the health rules, NaN layer-of-origin attribution, and the listener
contract of ``optimize/listeners.py`` that fires them.

The model is the kill harness's serving LM (``tests/_kill_harness.py``:
``transformer_lm(32, n_layers=1, d_model=32, n_heads=2, d_ff=64)``),
adam at its default lr 3e-4; the reference initialises it, saves it, and
the port loads the checkpoint. Tolerances: L2 norms and ratios within
1e-5 relative (the same f32 sums in another order); non-finite counts and
the log10 histograms exactly — an element within f32 rounding of a bucket
edge (|log10|x| - k| < 1e-6) could fall either side, and the tests name
every such element (there is none in these batches: LayerNorm gains
start exactly at the 10^0 edge, where both packages agree, and leave it
with the first update). Activation moments within 1e-5 relative plus
1e-6 absolute (a mean near 0 has no relative precision).
"""

import math

import numpy as np
import pytest
import torch

import _kill_harness as harness
from deeplearning4j_tpu.util import health as j_health
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

from deeplearning4j_tpu_torch.optimize import listeners as t_listeners
from deeplearning4j_tpu_torch.util import health as t_health
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.serialization import load_model

NORM_FIELDS = ("param_norm", "grad_norm", "update_norm", "update_ratio")
ACT_FIELDS = ("act_mean", "act_std", "act_zero_frac")
REL = 1e-5


def _batch(seed=0, b=4, t=8):
    ids = np.random.default_rng(seed).integers(
        0, harness.SERVE_VOCAB, (b, t + 1)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("health") / "lm.zip")
    j_save_model(harness.build_lm_net(5), path)
    return path


def _pair(ckpt):
    from deeplearning4j_tpu.util.serialization import load_model as j_load
    return j_load(ckpt), load_model(ckpt, device="cpu")


def _near_edges(arr):
    """Indices of the finite non-zero elements within f32 rounding of a
    log10 bucket edge."""
    a = np.abs(np.asarray(arr, np.float64).ravel())
    ok = np.isfinite(a) & (a > 0)
    lg = np.log10(np.where(ok, a, 1.0))
    return np.flatnonzero(ok & (np.abs(lg - np.round(lg)) < 1e-6)
                          & (lg >= -12) & (lg <= 4))


def _assert_stats_match(ref, got, edge_free):
    assert set(got) == set(ref)
    for layer, e in ref.items():
        g = got[layer]
        assert set(g) == set(e), layer
        for field, want in e.items():
            have = g[field]
            if field in NORM_FIELDS or field in ("grad_norm", "loss"):
                assert math.isclose(have, want, rel_tol=REL,
                                    abs_tol=1e-12), (layer, field, have,
                                                     want)
            elif field in ACT_FIELDS:
                assert math.isclose(have, want, rel_tol=REL, abs_tol=1e-6), \
                    (layer, field, have, want)
            elif field.endswith("_hist"):
                if edge_free:
                    assert list(have) == list(want), (layer, field)
                else:
                    assert sum(have) == sum(want)
            else:                                   # counts
                assert have == want, (layer, field)


class TestStatsAgainstReference:
    def test_one_step_stats_equal(self, ckpt):
        jnet, tnet = _pair(ckpt)
        x, y = _batch()
        jnet.enable_health_stats()
        tnet.enable_health_stats()
        jnet.fit_batch(x, y)
        tnet.fit_batch(x, y)
        ref = j_health.latest_stats(jnet).value()
        got = t_health.latest_stats(tnet).value()
        # no element of the updated parameters sits on a bucket edge
        for v, ps in tnet.params.items():
            for k, p in ps.items():
                assert _near_edges(p.detach().numpy()).size == 0, (v, k)
        _assert_stats_match(ref, got, edge_free=True)
        assert got[t_health.MODEL_KEY]["grad_nonfinite"] == 0
        n_embed = tnet.params["embed"]["W"].numel()
        assert sum(got["embed"]["param_hist"]) == n_embed
        assert len(got["embed"]["param_hist"]) == t_health.HIST_LEN

    def test_nonfinite_counts_and_overflow_bucket(self, ckpt):
        """A poisoned parameter reaches the non-finite gradient counts and
        the overflow bucket of the parameter histogram in both packages."""
        jnet, tnet = _pair(ckpt)
        x, y = _batch(1)
        w = np.asarray(tnet.params["blk0_ff2"]["W"].detach()).copy()
        w[0, :3] = [np.nan, np.inf, -np.inf]
        jnet.params["blk0_ff2"]["W"] = w.copy()
        with torch.no_grad():
            tnet.params["blk0_ff2"]["W"].copy_(torch.from_numpy(w))
        for net in (jnet, tnet):
            net.enable_health_stats()
            net.fit_batch(x, y)
        ref = j_health.latest_stats(jnet).value()
        got = t_health.latest_stats(tnet).value()
        for layer, e in ref.items():
            assert got[layer].get("grad_nonfinite") == \
                e.get("grad_nonfinite"), layer
        assert got[t_health.MODEL_KEY]["grad_nonfinite"] == \
            ref[t_health.MODEL_KEY]["grad_nonfinite"] > 0
        assert got["blk0_ff2"]["param_hist"] == ref["blk0_ff2"]["param_hist"]
        assert got["blk0_ff2"]["param_hist"][-1] >= 3

    def test_fit_repeated_keeps_the_last_steps_stats(self, ckpt):
        jnet, tnet = _pair(ckpt)
        x, y = _batch(2)
        for net in (jnet, tnet):
            net.enable_health_stats()
            net.fit_repeated(x, y, 3)
        ds = t_health.latest_stats(tnet)
        assert ds.iteration == 3 == tnet.iteration_count
        _assert_stats_match(j_health.latest_stats(jnet).value(), ds.value(),
                            edge_free=False)
        # the same as stats taken on the third of three single steps
        _, solo = _pair(ckpt)
        solo.fit_batch(x, y)
        solo.fit_batch(x, y)
        solo.enable_health_stats()
        solo.fit_batch(x, y)
        assert t_health.latest_stats(solo).value() == ds.value()

    def test_fit_scan_keeps_the_last_steps_stats(self, ckpt):
        _, tnet = _pair(ckpt)
        (x0, y0), (x1, y1) = _batch(3), _batch(4)
        tnet.enable_health_stats()
        tnet.fit_scan(np.stack([x0, x1]), np.stack([y0, y1]))
        ds = t_health.latest_stats(tnet)
        assert ds.iteration == 2
        _, solo = _pair(ckpt)
        solo.fit_batch(x0, y0)
        solo.enable_health_stats()
        solo.fit_batch(x1, y1)
        assert t_health.latest_stats(solo).value() == ds.value()

    def test_stats_step_is_bit_identical_to_plain_step(self, ckpt):
        _, a = _pair(ckpt)
        _, b = _pair(ckpt)
        b.enable_health_stats()
        x, y = _batch(5)
        for _ in range(3):
            la, lb = a.fit_batch(x, y), b.fit_batch(x, y)
        assert torch.equal(la, lb)
        for pa, pb in zip(a.parameters(), b.parameters()):
            assert torch.equal(pa, pb)
        b.disable_health_stats()
        b.fit_batch(x, y)
        assert t_health.latest_stats(b).iteration == 3

    def test_histogram_buckets_equal_reference(self):
        """The fixed-edge histogram of values across every bucket, zeros,
        tiny, huge and non-finite values, against the reference's."""
        rng = np.random.default_rng(0)
        x = (10.0 ** rng.uniform(-14, 6, 4000)
             * rng.choice([-1, 1], 4000)).astype(np.float32)
        x[:6] = [0.0, np.nan, np.inf, -np.inf, 1.0, 1e-30]
        assert _near_edges(x).tolist() == [4]       # 1.0, exactly 10^0
        want = np.asarray(j_health.log_histogram(x))
        got = t_health.log_histogram(torch.from_numpy(x)).numpy()
        assert got.tolist() == want.tolist()


class TestListenerContract:
    def test_one_sync_per_window_and_none_for_a_silent_listener(self, ckpt):
        _, net = _pair(ckpt)
        x, y = _batch(6)
        syncs = t_listeners.sync_counter()

        class Silent(t_listeners.TrainingListener):
            pass

        net.set_listeners(Silent())
        s0 = syncs.total()
        for _ in range(4):
            net.fit_batch(x, y)
        assert syncs.total() == s0

        listener = t_health.HealthListener(frequency=3, model="w",
                                           registry=MetricsRegistry())
        net.set_listeners(listener)
        s0 = syncs.total()
        for _ in range(6):
            net.fit_batch(x, y)
        # iteration 4 turns the stats on; windows at 6 and 9 read them
        assert syncs.total() - s0 == 2
        assert listener.engine.last_report["iteration"] == 9

    def test_score_listener_reads_the_loss_once_per_window(self, ckpt):
        _, net = _pair(ckpt)
        x, y = _batch(7)
        seen = []
        net.set_listeners(t_listeners.CollectScoresIterationListener(2),
                          t_listeners.ScoreIterationListener(
                              2, log_fn=seen.append))
        syncs = t_listeners.sync_counter()
        s0 = syncs.total()
        losses = [float(net.fit_batch(x, y)) for _ in range(4)]
        assert syncs.total() - s0 == 2          # iterations 2 and 4
        scores = net.listeners[0].scores
        assert [i for i, _ in scores] == [2, 4]
        assert [s for _, s in scores] == [losses[1], losses[3]]
        assert len(seen) == 2

    def test_fit_repeated_replays_listener_fires(self, ckpt):
        _, net = _pair(ckpt)
        x, y = _batch(8)
        collect = t_listeners.CollectScoresIterationListener(1)
        perf = t_listeners.PerformanceListener(frequency=1,
                                               log_fn=lambda s: None)
        net.set_listeners(t_listeners.ComposableIterationListener(
            collect, perf))
        losses = net.fit_repeated(x, y, 3).numpy().tolist()
        assert collect.scores == [(1, losses[0]), (2, losses[1]),
                                  (3, losses[2])]
        assert net.iteration_count == 3
        assert perf.last_batches_per_sec is not None


def _mk_snapshot(**layers):
    snap = {name: dict(e) for name, e in layers.items()}
    snap.setdefault("_model_", {"grad_norm": 1.0, "grad_nonfinite": 0,
                                "loss": 1.0})
    return snap


_HEALTHY = {"param_norm": 3.0, "grad_norm": 0.5, "update_norm": 0.003,
            "update_ratio": 1e-3, "grad_nonfinite": 0,
            "act_zero_frac": 0.3}

# the samples of tests/test_health.py::TestHealthRules
_SAMPLES = [
    (_mk_snapshot(l0=dict(_HEALTHY), l1=dict(_HEALTHY, update_ratio=0.5),
                  l2=dict(_HEALTHY, update_ratio=5e-5)), 50, ()),
    (_mk_snapshot(l0=dict(_HEALTHY, update_ratio=0.5)), 3, ()),
    (_mk_snapshot(l0=dict(_HEALTHY, grad_norm=1e-8),
                  l1=dict(_HEALTHY, grad_norm=5e3),
                  l2=dict(_HEALTHY, grad_norm=float("inf"))), 50, ()),
    (_mk_snapshot(l0=dict(_HEALTHY, grad_norm=1e-9),
                  l1=dict(_HEALTHY, grad_norm=10.0)), 50, ()),
    (_mk_snapshot(l0=dict(_HEALTHY, act_zero_frac=1.0),
                  l1=dict(_HEALTHY, act_zero_frac=0.95),
                  l2=dict(_HEALTHY, grad_nonfinite=7)), 50, ()),
    (_mk_snapshot(l0=dict(_HEALTHY)), 20, (1.0, 0.9, 0.8, 0.7, 0.6, 0.5)),
    (_mk_snapshot(l0=dict(_HEALTHY)), 20, (1.0, 1.0, 1.0, 5.0, 6.0, 7.0)),
    (_mk_snapshot(l0=dict(_HEALTHY)), 20,
     (1.0, 1.0, 1.0, 200.0, 300.0, 400.0)),
    (_mk_snapshot(l0=dict(_HEALTHY)), 20, (1.0, float("nan"))),
]


class TestRulesAgainstReference:
    @pytest.mark.parametrize("i", range(len(_SAMPLES)))
    def test_identical_verdicts(self, i):
        stats, it, losses = _SAMPLES[i]
        for jr, tr in zip(j_health.default_rules(),
                          t_health.default_rules()):
            assert tr.name == jr.name
            want = [tuple(v) for v in
                    jr.evaluate(j_health.HealthSample(stats, it, losses))]
            got = [tuple(v) for v in
                   tr.evaluate(t_health.HealthSample(stats, it, losses))]
            assert got == want, tr.name

    def test_engine_reports_and_transitions_equal(self):
        from deeplearning4j_tpu.util.metrics import \
            MetricsRegistry as JRegistry
        je = j_health.HealthEngine(model="u", registry=JRegistry())
        te = t_health.HealthEngine(model="u", registry=MetricsRegistry())
        for stats, it, _ in _SAMPLES:
            want = je.observe(stats, iteration=it)
            got = te.observe(stats, iteration=it)
            want.pop("t"), got.pop("t")
            assert got == want
        assert te._states == je._states


class TestAttributionAgainstReference:
    @pytest.fixture(scope="class")
    def pair(self, ckpt):
        return _pair(ckpt)

    def _both(self, pair, x, y, mask=None, poison=None):
        jnet, tnet = pair
        out = []
        for net in (jnet, tnet):
            params = None
            if poison is not None:
                params = {v: {k: np.array(t.detach() if torch.is_tensor(t)
                                          else t) for k, t in ps.items()}
                          for v, ps in net.params.items()}
                poison(params)
            r = (j_health if net is jnet else t_health).attribute_nonfinite(
                net, x, y, mask, params=params, record=False)
            out.append((r.quantity, r.layer, r.param))
        return out

    def test_param_origin(self, pair):
        def poison(p):
            p["blk0_ff1"]["W"][0, 0] = np.nan
        x, y = _batch(9)
        ref, got = self._both(pair, x, y, poison=poison)
        assert got == ref == ("param", "blk0_ff1", "W")

    def test_activation_origin(self, pair):
        def poison(p):
            p["blk0_ff1"]["W"][...] = 3e38
        x, y = _batch(9)
        ref, got = self._both(pair, x, y, poison=poison)
        assert got == ref == ("activation", "blk0_ff1", None)

    def test_gradient_origin_is_closest_to_the_loss(self, pair):
        x, y = _batch(9)
        mask = np.ones(x.shape, np.float32)
        mask[0, 3] = np.nan
        ref, got = self._both(pair, x, y, mask=mask)
        assert got == ref
        assert got[0] == "gradient" and got[1] == "out"

    def test_input_origin(self, pair):
        x, y = _batch(9)
        xf = x.astype(np.float32)
        xf[0, 0] = np.inf
        ref, got = self._both(pair, xf, y)
        assert got == ref == ("input", None, None)

    def test_finite_batch_is_unknown(self, pair):
        x, y = _batch(9)
        ref, got = self._both(pair, x, y)
        assert got == ref == ("unknown", None, None)

    def test_recorded_attribution_reaches_the_debug_payload(self, pair):
        _, tnet = pair
        t_health.reset_debug_state()
        x, y = _batch(9)
        params = {v: {k: t.detach().clone() for k, t in ps.items()}
                  for v, ps in tnet.params.items()}
        params["blk0_attn"][next(iter(params["blk0_attn"]))][0] = np.nan
        t_health.attribute_nonfinite(tnet, x, y, params=params)
        payload = t_health.debug_payload()
        assert payload["attribution"]["layer"] == "blk0_attn"
        assert payload["attribution"]["quantity"] == "param"
        assert len(payload["histogram_log10_edges"]) == \
            t_health.HIST_LOG_BUCKETS + 1
