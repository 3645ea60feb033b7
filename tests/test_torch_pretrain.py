"""The port's pretrain layers (AutoEncoder, RBM) and layerwise pretraining
against the JAX package's, on the CPU: the cases of
``tests/test_pretrain.py``, and parity of every deterministic piece.

``prop_up``, ``prop_down``, ``free_energy``, the reconstruction losses and
the autoencoder's loss gradient are compared from the reference's
parameters within 1e-6 (f32; the same sums in another order). The random
draws cannot match jax's threefry, so CD-k and the corruption mask are
compared by the same uniforms (and normals): the test makes the
reference's own draws with jax — ``bernoulli`` is ``uniform < p`` — and
hands them to the port in its draw order (h0, then v and h per Gibbs
step) through ``pretrain.draw_uniform``/``draw_normal``. Everything else
is held to the reference tests' own statistical assertions (lower
reconstruction error, lower free energy).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import rng as j_rng
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.conf.pretrain import RBM as JRBM
from deeplearning4j_tpu.nn.conf.pretrain import AutoEncoder as JAE
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util.serialization import save_model as j_save

from deeplearning4j_tpu_torch.nn.conf import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf import pretrain as tpre
from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.pretrain import RBM, AutoEncoder
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.serialization import load_model

TOL = 1e-6


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _structured_data(rng, n=64, d=12):
    """Low-rank structured inputs in [0, 1] (reconstructable)."""
    basis = rng.normal(size=(3, d))
    codes = rng.normal(size=(n, 3))
    x = codes @ basis + 0.05 * rng.normal(size=(n, d))
    return ((x - x.min()) / (x.max() - x.min())).astype(np.float32)


def _layer_pair(kind, seed=0, **kw):
    jl = (JAE if kind == "ae" else JRBM)(n_in=12, n_out=6,
                                         activation="sigmoid",
                                         weight_init="XAVIER", **kw)
    tl = (AutoEncoder if kind == "ae" else RBM)(n_in=12, n_out=6,
                                                activation="sigmoid",
                                                weight_init="XAVIER", **kw)
    jp = jl.init_params(j_rng.key(seed))
    jp = dict(jp, b=jnp.linspace(-0.3, 0.3, 6, dtype=jnp.float32),
              vb=jnp.linspace(0.2, -0.2, 12, dtype=jnp.float32))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    return jl, jp, tl, tp


class _Draws:
    """Feeds pre-made draws to the port, in order, checking each shape."""

    def __init__(self, monkeypatch, uniforms, normals=()):
        self.u, self.n = list(uniforms), list(normals)
        monkeypatch.setattr(tpre, "draw_uniform", self._uniform)
        monkeypatch.setattr(tpre, "draw_normal", self._normal)

    def _take(self, pool, shape, dtype):
        a = pool.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(np.array(a)).to(dtype)

    def _uniform(self, gen, shape, dtype, device):
        return self._take(self.u, shape, dtype)

    def _normal(self, gen, shape, dtype, device):
        return self._take(self.n, shape, dtype)


# --------------------------------------------------------------------------
# the layers against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ae", "rbm"])
def test_json_equals_reference(kind):
    def conf(nnc, layer, out, it):
        return (nnc.builder().seed(3).list()
                .layer(layer(n_out=6, **({"corruption_level": 0.4}
                                         if kind == "ae" else {"k": 3})))
                .layer(out(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(it.feed_forward(10)).build())
    got = conf(TNNC, AutoEncoder if kind == "ae" else RBM, OutputLayer,
               TInputType)
    want = conf(JNNC, JAE if kind == "ae" else JRBM, JOutputLayer, JInputType)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    back = MultiLayerConfiguration.from_json(want.to_json())
    assert isinstance(back.layers[0], AutoEncoder if kind == "ae" else RBM)
    assert json.loads(back.to_json()) == json.loads(want.to_json())


@pytest.mark.parametrize("loss", ["mse", "xent", "mse_act"])
def test_forward_and_reconstruction_equal_reference(loss):
    jl, jp, tl, tp = _layer_pair("ae", loss=loss)
    x = _structured_data(np.random.default_rng(1), n=16)
    jh, _ = jl.apply(jp, jnp.asarray(x))
    th, _ = tl.apply(tp, torch.from_numpy(x))
    assert set(tp) == {"W", "b", "vb"} and tuple(th.shape) == (16, 6)
    assert _rel(th.numpy(), jh) <= TOL
    assert _rel(float(tl.reconstruction_error(tp, torch.from_numpy(x))),
                float(jl.reconstruction_error(jp, jnp.asarray(x)))) <= TOL


@pytest.mark.parametrize("corruption", [0.0, 0.3])
def test_autoencoder_loss_and_gradient_equal_reference(monkeypatch,
                                                       corruption):
    """The same corruption mask (the reference's uniforms): the loss and
    its gradient."""
    jl, jp, tl, tp = _layer_pair("ae", corruption_level=corruption)
    x = _structured_data(np.random.default_rng(2), n=16)
    key = j_rng.key(7)
    jloss, jg = jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), key))(jp)
    u = np.asarray(jax.random.uniform(key, x.shape,
                                      jax.lax.dtype(1.0 - corruption)))
    _Draws(monkeypatch, [u] if corruption > 0 else [])
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tloss = tl.pretrain_loss(live, torch.from_numpy(x),
                             torch.Generator().manual_seed(0))
    tg = dict(zip(live, torch.autograd.grad(tloss, list(live.values()))))
    assert _rel(float(tloss.detach()), float(jloss)) <= TOL
    for k in tg:
        assert _rel(tg[k].numpy(), jg[k]) <= 1e-5, k


@pytest.mark.parametrize("visible", ["binary", "gaussian"])
def test_rbm_prop_and_free_energy_equal_reference(visible):
    jl, jp, tl, tp = _layer_pair("rbm", visible_unit=visible)
    v = (_structured_data(np.random.default_rng(3), n=16) > 0.5).astype(
        np.float32)
    h = np.random.default_rng(4).random((16, 6)).astype(np.float32)
    assert _rel(tl.prop_up(tp, torch.from_numpy(v)).numpy(),
                jl.prop_up(jp, jnp.asarray(v))) <= TOL
    assert _rel(tl.prop_down(tp, torch.from_numpy(h)).numpy(),
                jl.prop_down(jp, jnp.asarray(h))) <= TOL
    assert _rel(float(tl.free_energy(tp, torch.from_numpy(v))),
                float(jl.free_energy(jp, jnp.asarray(v)))) <= TOL


def _reference_draws(rbm, jp, v0, key):
    """The reference's CD-k draws, in the port's order: h0's uniforms,
    then per Gibbs step v's (uniforms, or normals for gaussian units) and
    h's (none for rectified units)."""
    uniforms, normals = [], []
    n_h, n_v = jp["W"].shape[1], jp["W"].shape[0]
    b = v0.shape[0]
    u = lambda k, n: np.asarray(jax.random.uniform(   # noqa: E731
        k, (b, n), jnp.float32))
    if rbm.hidden_unit == "binary":
        uniforms.append(u(jax.random.fold_in(key, 0), n_h))
    for i in range(rbm.k):
        kv = jax.random.fold_in(key, 2 * i + 1)
        if rbm.visible_unit == "gaussian":
            normals.append(np.asarray(jax.random.normal(kv, (b, n_v),
                                                        jnp.float32)))
        else:
            uniforms.append(u(kv, n_v))
        if rbm.hidden_unit == "binary":
            uniforms.append(u(jax.random.fold_in(key, 2 * i + 2), n_h))
    return uniforms, normals


@pytest.mark.parametrize("k,visible,hidden", [
    (1, "binary", "binary"), (3, "binary", "binary"),
    (2, "gaussian", "binary"), (2, "binary", "rectified")])
def test_cd_k_by_the_same_draws_equals_reference(monkeypatch, k, visible,
                                                 hidden):
    jl, jp, tl, tp = _layer_pair("rbm", k=k, visible_unit=visible,
                                 hidden_unit=hidden)
    v0 = (_structured_data(np.random.default_rng(5), n=16) > 0.5).astype(
        np.float32)
    key = j_rng.key(11)
    jg = jl.contrastive_divergence_grads(jp, jnp.asarray(v0), key)
    _Draws(monkeypatch, *_reference_draws(jl, jp, v0, key))
    tg = tl.contrastive_divergence_grads(tp, torch.from_numpy(v0),
                                         torch.Generator().manual_seed(0))
    assert set(tg) == {"W", "b", "vb"}
    for name in tg:
        assert _rel(tg[name].numpy(), jg[name]) <= 1e-5, name


def test_cd_at_saturated_probabilities_equals_reference():
    """Weights of 40 and a visible unit on in every example pin every
    hidden and visible draw to 1: CD-2 with the packages' own generators
    gives the reference's statistics."""
    jl, jp, tl, tp = _layer_pair("rbm", k=2)
    w = np.full(np.asarray(jp["W"]).shape, 40.0, np.float32)
    jp = dict(jp, W=jnp.asarray(w))
    tp = dict(tp, W=torch.from_numpy(w))
    v0 = (_structured_data(np.random.default_rng(6), n=16) > 0.5).astype(
        np.float32)
    v0[:, 0] = 1.0
    jg = jl.contrastive_divergence_grads(jp, jnp.asarray(v0), j_rng.key(1))
    tg = tl.contrastive_divergence_grads(tp, torch.from_numpy(v0),
                                         torch.Generator().manual_seed(1))
    for name in tg:
        assert _rel(tg[name].numpy(), jg[name]) <= TOL, name


# --------------------------------------------------------------------------
# the reference's own cases, on the port
# --------------------------------------------------------------------------


def test_cd_lowers_the_free_energy():
    x = (_structured_data(np.random.default_rng(12345)) > 0.5).astype(
        np.float32)
    rbm = RBM(n_in=12, n_out=6, activation="sigmoid", weight_init="XAVIER",
              k=1)
    params = rbm.init_params(torch.Generator().manual_seed(1))
    v = torch.from_numpy(x)
    e0 = float(rbm.free_energy(params, v))
    step = tpre.make_pretrain_step(rbm, 0.1)
    gen = torch.Generator().manual_seed(2)
    for _ in range(80):
        step(params, v, gen)
    assert float(rbm.free_energy(params, v)) < e0


def test_gaussian_visible_cd_is_finite():
    rbm = RBM(n_in=8, n_out=4, activation="sigmoid", weight_init="XAVIER",
              visible_unit="gaussian")
    params = rbm.init_params(torch.Generator().manual_seed(3))
    v = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 8)).astype(np.float32))
    grads = rbm.contrastive_divergence_grads(
        params, v, torch.Generator().manual_seed(4))
    assert grads["W"].shape == (8, 4)
    assert torch.isfinite(grads["W"]).all()


def _ae_mln(nnc, ae, out, it, *, seed=5, updater="sgd", lr=0.5,
            corruption=0.2):
    return (nnc.builder().seed(seed).updater(updater).learning_rate(lr)
            .list()
            .layer(ae(n_out=6, activation="sigmoid",
                      corruption_level=corruption, loss="mse"))
            .layer(out(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(it.feed_forward(12)).build())


def test_mln_pretrain_reduces_reconstruction_error():
    x = _structured_data(np.random.default_rng(12345))
    net = MultiLayerNetwork(_ae_mln(TNNC, AutoEncoder, OutputLayer,
                                    TInputType), device="cpu").init()
    ae = net.layers[0]
    out_before = net.clone_params()["layer_1"]
    e0 = float(ae.reconstruction_error(net.params["layer_0"],
                                       torch.from_numpy(x)))
    net.pretrain((x, np.zeros((64, 3), np.float32)), epochs=60)
    e1 = float(ae.reconstruction_error(net.params["layer_0"],
                                       torch.from_numpy(x)))
    assert e1 < e0 * 0.7, (e0, e1)
    # only the pretrainable layer moved
    for k, p in net.params["layer_1"].items():
        assert torch.equal(p, out_before[k]), k


def test_mln_pretrain_without_corruption_equals_reference(tmp_path):
    """No corruption, no draws: the reference's pretrain SGD and the
    port's from the same checkpoint, then one fine-tuning step."""
    x = _structured_data(np.random.default_rng(8), n=32)
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(9).integers(
        0, 3, 32)]
    jnet = JMLN(_ae_mln(JNNC, JAE, JOutputLayer, JInputType,
                        corruption=0.0)).init()
    path = str(tmp_path / "ae.zip")
    j_save(jnet, path)
    tnet = load_model(path, device="cpu")
    jnet.pretrain((x, y), epochs=4)
    tnet.pretrain((x, y), epochs=4)
    for k, p in tnet.params["layer_0"].items():
        assert _rel(p.detach().numpy(), jnet.params["layer_0"][k]) <= 1e-5, k
    assert _rel(float(tnet.fit_batch(x, y)), float(jnet.fit_batch(x, y))) \
        <= 1e-5


def test_mln_pretrain_then_finetune():
    rng = np.random.default_rng(12345)
    x = _structured_data(rng)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    conf = (TNNC.builder().seed(6).updater("adam").learning_rate(0.01).list()
            .layer(AutoEncoder(n_out=8, activation="sigmoid"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(TInputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.pretrain((x, y), epochs=20)
    s0 = net.score_for(x, y)
    for _ in range(30):
        net.fit_batch(x, y)
    assert net.score() < s0


def test_ae_rbm_stack_pretrains_layer_by_layer_then_finetunes():
    """AE → RBM → output: each pretrainable layer moves while the layers
    below it are frozen; fine-tuning lowers the loss."""
    rng = np.random.default_rng(10)
    x = _structured_data(rng)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 64)]
    conf = (TNNC.builder().seed(7).updater("adam").learning_rate(1e-2).list()
            .layer(AutoEncoder(n_out=8, activation="sigmoid",
                               corruption_level=0.1))
            .layer(RBM(n_out=6, activation="sigmoid", k=2))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(TInputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    before = net.clone_params()
    seen = []
    orig = net._activation_upto

    def spy(x_, i):
        seen.append((i, {k: v.clone() for k, v in net.params["layer_0"]
                         .items()}))
        return orig(x_, i)
    net._activation_upto = spy
    net.pretrain([(x[:32], y[:32]), (x[32:], y[32:])], epochs=3)
    assert sorted({i for i, _ in seen}) == [0, 1]
    # the RBM trained on the AE's final weights
    for i, p0 in seen:
        if i == 1:
            for k, p in net.params["layer_0"].items():
                assert torch.equal(p, p0[k])
    for key in ("layer_0", "layer_1"):
        assert not torch.equal(net.params[key]["W"], before[key]["W"]), key
    assert torch.equal(net.params["layer_2"]["W"], before["layer_2"]["W"])
    losses = [float(net.fit_batch(x, y)) for _ in range(10)]
    assert losses[-1] < losses[0]


def test_rbm_in_network_pretrain():
    rng = np.random.default_rng(12345)
    x = (_structured_data(rng) > 0.5).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 64)]
    conf = (TNNC.builder().seed(7).updater("sgd").learning_rate(0.1).list()
            .layer(RBM(n_out=6, activation="sigmoid", k=2))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(TInputType.feed_forward(12)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    w0 = net.params["layer_0"]["W"].detach().clone()
    net.pretrain((x, y), epochs=5)
    assert not torch.allclose(w0, net.params["layer_0"]["W"])
    assert np.isfinite(float(net.fit_batch(x, y)))


def test_graph_pretrain_reduces_reconstruction_error():
    x = _structured_data(np.random.default_rng(12345))
    conf = (TNNC.builder().seed(5).updater("sgd").learning_rate(0.5)
            .graph_builder().add_inputs("in")
            .add_layer("ae1", AutoEncoder(n_in=12, n_out=6,
                                          activation="sigmoid",
                                          corruption_level=0.2, loss="mse"),
                       "in")
            .add_layer("ae2", AutoEncoder(n_in=6, n_out=4,
                                          activation="sigmoid", loss="mse"),
                       "ae1")
            .add_layer("out", OutputLayer(n_in=4, n_out=3,
                                          activation="softmax",
                                          loss="mcxent"), "ae2")
            .set_outputs("out").build())
    net = ComputationGraph(conf, device="cpu").init()
    out_w = net.params["out"]["W"].detach().clone()
    ae1 = net.conf.vertices["ae1"].layer
    e0 = float(ae1.reconstruction_error(net.params["ae1"],
                                        torch.from_numpy(x)))
    net.pretrain(([x], np.zeros((64, 3), np.float32)), epochs=60)
    e1 = float(ae1.reconstruction_error(net.params["ae1"],
                                        torch.from_numpy(x)))
    assert e1 < e0 * 0.7, (e0, e1)
    ae2 = net.conf.vertices["ae2"].layer
    h = net.feed_forward([x])["ae1"]
    with torch.no_grad():
        assert np.isfinite(float(ae2.reconstruction_error(net.params["ae2"],
                                                          h)))
    assert torch.equal(net.params["out"]["W"], out_w)
    assert torch.equal(net._vertex_input_activation("ae2",
                                                    [torch.from_numpy(x)]),
                       h)
