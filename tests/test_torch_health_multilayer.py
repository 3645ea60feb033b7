"""The MultiLayerNetwork scenarios of ``tests/test_health.py`` on the
port: the per-layer training-health stats of ``util/health.py`` from a
``MultiLayerNetwork``'s training step, the listener contract, the golden
scenarios (healthy baseline, exploding gradients, dead ReLUs) and NaN
layer-of-origin attribution — each held to the reference's answer on the
same weights and batch where the reference gives one.

The model is the reference test's MLP (dense 16 relu → dense 8 tanh →
softmax output over 5 inputs, adam 1e-3); the reference initialises and
saves it, the port loads the checkpoint. Tolerances as in
``tests/test_torch_health.py``: L2 norms and ratios within 1e-5
relative, counts exactly, histograms exactly where no updated element
sits within f32 rounding of a bucket edge (else their totals),
activation moments within 1e-5 relative plus 1e-6 absolute.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util import health as j_health
from deeplearning4j_tpu.util.serialization import load_model as j_load
from deeplearning4j_tpu.util.serialization import save_model as j_save

from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import listeners as t_listeners
from deeplearning4j_tpu_torch.util import health as t_health
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.serialization import load_model

REL = 1e-5
LAYERS = ("layer_0", "layer_1", "layer_2")


def _jconf(seed=1, lr=1e-3, updater="adam"):
    return (JNNC.builder().seed(seed).updater(updater).learning_rate(lr)
            .list()
            .layer(JDense(n_out=16, activation="relu"))
            .layer(JDense(n_out=8, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(5)).build())


def _batch(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 5)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mlp") / "mlp.zip")
    j_save(JMLN(_jconf()).init(), path)
    return path


@pytest.fixture(scope="module")
def stats_run(ckpt):
    """One stats run: 30 iterations with a HealthListener at frequency 10
    (also the healthy-baseline golden scenario)."""
    net = load_model(ckpt, device="cpu")
    listener = t_health.HealthListener(frequency=10, model="fixture",
                                       registry=MetricsRegistry())
    net.set_listeners(listener)
    x, y = _batch()
    syncs = t_listeners.sync_counter()
    s0 = syncs.total()
    for _ in range(30):
        net.fit_batch(x, y)
    return {"net": net, "engine": listener.engine, "x": x, "y": y,
            "syncs": syncs.total() - s0,
            "snapshot": t_health.latest_stats(net).value()}


def _near_edges(arr):
    a = np.abs(np.asarray(arr, np.float64).ravel())
    ok = np.isfinite(a) & (a > 0)
    lg = np.log10(np.where(ok, a, 1.0))
    return np.flatnonzero(ok & (np.abs(lg - np.round(lg)) < 1e-6))


def _assert_stats_match(ref, got, edge_free):
    assert set(got) == set(ref)
    for layer, e in ref.items():
        g = got[layer]
        assert set(g) == set(e), layer
        for field, want in e.items():
            have = g[field]
            if field.startswith("act_"):
                assert math.isclose(have, want, rel_tol=REL, abs_tol=1e-6), \
                    (layer, field, have, want)
            elif field.endswith("_hist"):
                assert (list(have) == list(want) if edge_free
                        else sum(have) == sum(want)), (layer, field)
            elif isinstance(want, float):
                assert math.isclose(have, want, rel_tol=REL,
                                    abs_tol=1e-12), (layer, field, have, want)
            else:
                assert have == want, (layer, field)


class TestStats:
    def test_snapshot_contents(self, stats_run):
        snap = stats_run["snapshot"]
        assert set(snap) == set(LAYERS) | {t_health.MODEL_KEY}
        for name in LAYERS:
            e = snap[name]
            assert e["param_norm"] > 0 and e["grad_norm"] > 0
            assert e["update_ratio"] == pytest.approx(
                e["update_norm"] / e["param_norm"], rel=1e-4)
            assert e["grad_nonfinite"] == 0
            n = sum(p.numel() for p in stats_run["net"].params[name].values())
            assert sum(e["param_hist"]) == sum(e["update_hist"]) == n
            assert len(e["param_hist"]) == t_health.HIST_LEN
        assert 0.0 <= snap["layer_0"]["act_zero_frac"] <= 1.0
        assert snap["layer_1"]["act_std"] > 0
        assert "act_mean" not in snap["layer_2"]
        assert np.isfinite(snap[t_health.MODEL_KEY]["loss"])

    def test_one_sync_per_listener_window(self, stats_run):
        # the listener turns the stats on at its first call; the windows
        # at 10, 20 and 30 read them: three host syncs in all
        assert stats_run["syncs"] == 3

    def test_one_step_stats_equal_reference(self, ckpt):
        jnet, tnet = j_load(ckpt), load_model(ckpt, device="cpu")
        x, y = _batch(1)
        for net in (jnet, tnet):
            net.enable_health_stats()
            net.fit_batch(x, y)
        edge_free = not any(
            _near_edges(p.detach().numpy()).size
            for ps in tnet.params.values() for p in ps.values())
        _assert_stats_match(j_health.latest_stats(jnet).value(),
                            t_health.latest_stats(tnet).value(), edge_free)

    def test_fit_repeated_and_fit_scan_keep_the_last_steps_stats(self, ckpt):
        jnet, tnet = j_load(ckpt), load_model(ckpt, device="cpu")
        x, y = _batch(2)
        for net in (jnet, tnet):
            net.enable_health_stats()
            net.fit_repeated(x, y, 3)
        ds = t_health.latest_stats(tnet)
        assert ds.iteration == 3 == tnet.iteration_count
        _assert_stats_match(j_health.latest_stats(jnet).value(), ds.value(),
                            edge_free=False)
        (x0, y0), (x1, y1) = _batch(3), _batch(4)
        scan = load_model(ckpt, device="cpu")
        scan.enable_health_stats()
        scan.fit_scan(np.stack([x0, x1]), np.stack([y0, y1]))
        assert t_health.latest_stats(scan).iteration == 2
        solo = load_model(ckpt, device="cpu")
        solo.fit_batch(x0, y0)
        solo.enable_health_stats()
        solo.fit_batch(x1, y1)
        assert (t_health.latest_stats(solo).value()
                == t_health.latest_stats(scan).value())

    def test_stats_step_is_bit_identical(self, ckpt):
        a, b = load_model(ckpt, device="cpu"), load_model(ckpt, device="cpu")
        b.enable_health_stats()
        x, y = _batch(5)
        for _ in range(3):
            la, lb = a.fit_batch(x, y), b.fit_batch(x, y)
        assert torch.equal(la, lb)
        for pa, pb in zip(a.parameters(), b.parameters()):
            assert torch.equal(pa, pb)

    def test_listener_ignores_stale_snapshot(self, stats_run):
        listener = t_health.HealthListener(frequency=1, model="stale",
                                           registry=MetricsRegistry())
        listener.iteration_done(stats_run["net"],
                                stats_run["net"].iteration_count + 999, 0.0)
        assert listener.engine.last_report is None


class TestGoldenScenarios:
    def test_healthy_baseline_all_rules_ok(self, stats_run):
        report = stats_run["engine"].last_report
        assert report is not None and report["state"] == t_health.OK
        assert report["iteration"] == 30
        for rule, r in report["rules"].items():
            assert r["state"] == t_health.OK, (rule, r)

    def test_exploding_grad_lr(self):
        conf = (NeuralNetConfiguration.builder().seed(5).updater("sgd")
                .learning_rate(1e4).list()
                .layer(DenseLayer(n_out=16, activation="identity"))
                .layer(DenseLayer(n_out=8, activation="identity"))
                .layer(OutputLayer(n_out=3, activation="identity",
                                   loss="mse"))
                .set_input_type(InputType.feed_forward(5)).build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        net.enable_health_stats()
        listener = t_health.HealthListener(frequency=1, model="exploding",
                                           registry=MetricsRegistry())
        net.set_listeners(listener)
        x, y = _batch(6)
        for _ in range(8):
            net.fit_batch(x, y)
        report = listener.engine.last_report
        assert report["state"] == t_health.CRITICAL
        states = {r: report["rules"][r]["state"] for r in report["rules"]}
        assert t_health.CRITICAL in (states["exploding_gradients"],
                                     states["nonfinite_grads"])

    def test_dead_relu_init(self, ckpt):
        net = load_model(ckpt, device="cpu")
        with torch.no_grad():
            net.params["layer_0"]["W"].zero_()
            net.params["layer_0"]["b"].fill_(-5.0)
        net.enable_health_stats()
        listener = t_health.HealthListener(frequency=1, model="dead",
                                           registry=MetricsRegistry())
        net.set_listeners(listener)
        x, y = _batch(7)
        net.fit_batch(x, y)
        dead = listener.engine.last_report["rules"]["dead_units"]
        assert dead["state"] == t_health.CRITICAL
        assert dead["layers"]["layer_0"]["state"] == t_health.CRITICAL
        assert t_health.latest_stats(net).value()["layer_0"][
            "act_zero_frac"] == 1.0


class TestAttribution:
    @pytest.fixture(scope="class")
    def pair(self, ckpt):
        return j_load(ckpt), load_model(ckpt, device="cpu")

    def _both(self, pair, x, y, poison=None):
        out = []
        for net, mod in zip(pair, (j_health, t_health)):
            params = None
            if poison is not None:
                params = {k: {n: np.array(t.detach() if torch.is_tensor(t)
                                          else t) for n, t in ps.items()}
                          for k, ps in net.params.items()}
                poison(params)
            r = mod.attribute_nonfinite(net, x, y, params=params,
                                        record=False)
            out.append((r.quantity, r.layer, r.param))
        return out

    def test_param_origin(self, pair):
        def poison(p):
            p["layer_1"]["W"][0, 0] = np.nan
        ref, got = self._both(pair, *_batch(8), poison=poison)
        assert got == ref == ("param", "layer_1", "W")

    def test_activation_origin(self, pair):
        def poison(p):
            p["layer_0"]["W"][...] = 3e38
        ref, got = self._both(pair, *_batch(9), poison=poison)
        assert got == ref == ("activation", "layer_0", None)

    def test_gradient_origin_is_closest_to_the_loss(self, pair):
        x, y = _batch(10)
        y[0, 0] = np.nan
        ref, got = self._both(pair, x, y)
        assert got == ref and got[:2] == ("gradient", "layer_2")

    def test_input_origin(self, pair):
        x, y = _batch(11)
        x[0, 0] = np.inf
        ref, got = self._both(pair, x, y)
        assert got == ref and got[:2] == ("input", None)
