"""The port's classic model zoo against the JAX package's, on the CPU: the
configurations of ``models/`` (LeNet-5, ResNet, char-RNN, AlexNet, VGG-16,
the deep autoencoder) as parsed JSON; ``resnet_tiny``'s forward, step-0
gradients, parameters and BatchNormalization running statistics after
three nesterovs steps from a reference checkpoint; VGG-16's forward from
one; and the space-to-depth stem.

Tolerances, relative to the largest magnitude compared: forward, loss and
step-0 gradients 1e-5 in f32 (the same sums in another order; the ResNet
has 18 BN layers whose batch statistics each reorder a sum); parameters and
running statistics after three steps 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.models as J
from deeplearning4j_tpu.models.resnet import fold_stem_7x7_to_s2d as j_fold
from deeplearning4j_tpu.nn.graph_runtime import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util.serialization import load_model as j_load
from deeplearning4j_tpu.util.serialization import save_model as j_save

import deeplearning4j_tpu_torch.models as T
from deeplearning4j_tpu_torch.nn.conf.layers import SpaceToDepthLayer
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import convops
from deeplearning4j_tpu_torch.util.serialization import load_model

F32 = 1e-5
STEPS = 1e-4

ZOO = {
    "lenet": ("lenet", {}),
    "resnet50": ("resnet50", {}),
    "resnet50_s2d": ("resnet50", {"stem": "space_to_depth"}),
    "resnet_tiny": ("resnet_tiny", {"dtype": "float32"}),
    "char_rnn": ("char_rnn_lstm", {"vocab_size": 80, "hidden": 512,
                                   "layers": 2, "tbptt_length": 64,
                                   "dtype": "mixed_bf16"}),
    "alexnet": ("alexnet", {}),
    "vgg16": ("vgg16", {}),
    "deep_autoencoder": ("deep_autoencoder", {}),
}


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_json_equals_reference(name):
    fn, kw = ZOO[name]
    want = json.loads(getattr(J, fn)(**kw).to_json())
    got_conf = getattr(T, fn)(**kw)
    assert json.loads(got_conf.to_json()) == want
    assert json.loads(type(got_conf).from_json(json.dumps(want)).to_json()) \
        == want


def test_lenet_params_and_forward():
    net = MultiLayerNetwork(T.lenet(), device="cpu").init()
    expect = (5 * 5 * 1 * 20 + 20) + (5 * 5 * 20 * 50 + 50) \
        + (4 * 4 * 50 * 500 + 500) + (500 * 10 + 10)
    assert net.num_params() == expect
    out = net.output(np.random.default_rng(0).normal(
        size=(4, 784)).astype(np.float32))
    assert out.shape == (4, 10)
    torch.testing.assert_close(out.sum(1), torch.ones(4))


def test_resnet50_builds_and_infers_shapes():
    conf = T.resnet50(dtype="float32")
    net = ComputationGraph(conf, device="cpu")
    n = sum(int(np.prod(s)) for v in conf.vertices.values()
            for s in v.param_shapes().values())
    assert 25_000_000 < n < 26_000_000, n
    bn = [k for k, st in net.state.items() if st]
    assert len(bn) == 53                       # one BN per conv
    types = T.resnet((1, 1), height=32, width=32, channels=3, n_classes=10,
                     width_base=8, dtype="float32").infer_shapes()
    assert types["s1b0_relu"].height == 4
    assert types["s1b0_relu"].channels == 8 * 2 * 4


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    conf = J.resnet_tiny(height=16, width=16, n_classes=4, width_base=8,
                         dtype="float32", learning_rate=0.05)
    jnet = JCG(conf).init()
    path = str(tmp_path_factory.mktemp("resnet") / "tiny.zip")
    j_save(jnet, path)
    return jnet, path


def _tiny_batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(6, 16, 16, 3)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)])


def test_resnet_tiny_forward_and_step0_gradients_match_reference(tiny_pair):
    jnet, path = tiny_pair
    tnet = load_model(path, device="cpu")
    x, y = _tiny_batch()
    _close(tnet.output(x).numpy(), np.asarray(jnet.output(jnp.asarray(x))),
           F32, "output")
    states = jnet._states_map()
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jnet._loss_fn(
        p, states, [jnp.asarray(x)], [jnp.asarray(y)], None, None)[0]))(
            jnet.params)
    tl, tg = tnet._loss_and_grads([torch.from_numpy(x)],
                                  [torch.from_numpy(y)], None)
    _close(float(tl), float(jl), F32, "loss")
    assert tnet.evaluate(x, y).stats() == jnet.evaluate(x, y).stats()
    assert set(tg) == set(jg)
    for v, gs in tg.items():
        for k, g in gs.items():
            _close(g.numpy(), np.asarray(jg[v][k]), F32, f"grad {v}/{k}")


def test_resnet_tiny_three_steps_move_bn_state_as_reference(tiny_pair):
    _, path = tiny_pair
    jnet = j_load(path)
    tnet = load_model(path, device="cpu")
    x, y = _tiny_batch(1)
    before = {v: {k: t.clone() for k, t in st.items()}
              for v, st in tnet.state.items() if st}
    jl = [float(jnet.fit_batch(x, y)) for _ in range(3)]
    tl = [float(tnet.fit_batch(x, y)) for _ in range(3)]
    _close(tl, jl, STEPS, "losses")
    for v, ps in tnet.params.items():
        for k, p in ps.items():
            _close(p.detach().numpy(), np.asarray(jnet.params[v][k]), STEPS,
                   f"param {v}/{k}")
    for v in before:
        for k in ("mean", "var"):
            _close(tnet.state[v][k].numpy(), np.asarray(jnet.state[v][k]),
                   STEPS, f"state {v}/{k}")
            assert not torch.equal(tnet.state[v][k], before[v][k])
    # output() leaves the running statistics alone
    snap = {v: tnet.state[v]["mean"].clone() for v in before}
    tnet.output(x)
    assert all(torch.equal(tnet.state[v]["mean"], snap[v]) for v in snap)


def test_vgg16_forward_matches_reference(tmp_path):
    conf = J.vgg16(height=32, width=32, n_classes=4, dtype="float32")
    jnet = JMLN(conf).init()
    path = str(tmp_path / "vgg.zip")
    j_save(jnet, path)
    tnet = load_model(path, device="cpu")
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    _close(tnet.output(x).numpy(), np.asarray(jnet.output(jnp.asarray(x))),
           F32, "vgg16 output")


def test_space_to_depth_stem_is_exact():
    """7×7/2 SAME conv == s2d(2×2) + 4×4/1 SAME conv with folded weights;
    the port's fold is the reference's."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    w7 = rng.normal(size=(7, 7, 3, 16)).astype(np.float32)
    w4 = T.fold_stem_7x7_to_s2d(w7)
    np.testing.assert_array_equal(w4, j_fold(w7))
    ref = convops.conv2d(x, torch.from_numpy(w7), (2, 2), "same")
    s2d, _ = SpaceToDepthLayer(block_size=2).apply({}, x)
    out = convops.conv2d(s2d, torch.from_numpy(w4), (1, 1), "same")
    assert out.shape == ref.shape == (2, 16, 16, 16)
    assert float((out - ref).abs().max()) <= 1e-4


def test_resnet_s2d_stem_and_char_rnn_train():
    rng = np.random.default_rng(4)
    net = ComputationGraph(T.resnet((1, 1), height=32, width=32,
                                    width_base=8, n_classes=4,
                                    dtype="float32",
                                    stem="space_to_depth"),
                           device="cpu").init()
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 4)]
    l0, l1 = float(net.fit_batch(x, y)), float(net.fit_batch(x, y))
    assert np.isfinite(l1) and l1 < l0 * 1.5
    conf = T.char_rnn_lstm(vocab_size=12, hidden=8, layers=2, tbptt_length=5)
    rnn = MultiLayerNetwork(conf, device="cpu").init()
    xs = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (4, 12))]
    rnn.fit_batch(xs, xs)                      # 12 steps > 5: three chunks
    assert rnn._update_count == 3 and np.isfinite(rnn.score())
    assert rnn.rnn_time_step(xs[:, 0]).shape == (4, 12)


def test_classic_zoo_runs():
    rng = np.random.default_rng(5)
    alex = MultiLayerNetwork(T.alexnet(height=64, width=64, n_classes=7,
                                       dtype="float32"), device="cpu").init()
    out = alex.output(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    assert out.shape == (2, 7)
    torch.testing.assert_close(out.sum(1), torch.ones(2))
    ae = MultiLayerNetwork(T.deep_autoencoder(n_in=32, hidden=(16, 8)),
                           device="cpu").init()
    x = rng.random((16, 32)).astype(np.float32)
    first = float(ae.fit_batch(x, x))
    for _ in range(15):
        last = float(ae.fit_batch(x, x))
    assert last < first


def test_resnet_tiny_train_mode_output_matches_reference(tiny_pair):
    """``output(train=True)``: BN on the batch's own statistics, the
    running statistics untouched."""
    jnet, path = tiny_pair
    tnet = load_model(path, device="cpu")
    x, _ = _tiny_batch(3)
    snap = {v: {k: t.clone() for k, t in st.items()}
            for v, st in tnet.state.items() if st}
    _close(tnet.output(x, train=True).numpy(),
           np.asarray(jnet.output(jnp.asarray(x), train=True)), F32,
           "train-mode output")
    assert all(torch.equal(tnet.state[v][k], t)
               for v, st in snap.items() for k, t in st.items())


def test_resnet50_bf16_gap_is_the_references_own(tmp_path):
    """ResNet-50 (224², fresh weights, train-mode forward of 2 examples):
    the port's mixed-bf16 output differs from its f32 output about as much
    as the reference's bf16 output differs from the reference's f32 output
    — 53 bf16 conv+BN layers move the probabilities by tens of bf16 steps
    in both packages (the bound of ``chip_smoke.py``'s classic phase rests
    on this). Held: the port's gap within twice the reference's; the two
    packages' f32 outputs within 5e-4 of the largest probability (53 BN
    batch sums in another order; observed ≈ 1.2e-4)."""
    jnet = JCG(J.resnet50(dtype="mixed_bf16")).init()
    path = str(tmp_path / "r50.zip")
    j_save(jnet, path)
    x = np.random.default_rng(6).normal(size=(2, 224, 224, 3)).astype(
        np.float32)
    outs = {}
    for dtype in ("mixed_bf16", "float32"):
        jconf = J.resnet50(dtype=dtype)
        jn = JCG(jconf)
        jn.params, jn.state = jnet.params, jnet.state
        outs["ref", dtype] = np.asarray(
            jn.output(jnp.asarray(x), train=True), np.float32)
        tnet = load_model(path, device="cpu")
        if dtype == "float32":
            from deeplearning4j_tpu_torch.nn.conf.graph import \
                ComputationGraphConfiguration
            conf = ComputationGraphConfiguration.from_json(
                T.resnet50(dtype=dtype).to_json())
            f32 = ComputationGraph(conf, device="cpu")
            f32.set_params({k: dict(ps) for k, ps in tnet.params.items()})
            tnet = f32
        outs["port", dtype] = tnet.output(x, train=True).float().numpy()
    p = float(outs["ref", "float32"].max())
    ref_gap = float(np.abs(outs["ref", "mixed_bf16"]
                           - outs["ref", "float32"]).max())
    port_gap = float(np.abs(outs["port", "mixed_bf16"]
                            - outs["port", "float32"]).max())
    f32_gap = float(np.abs(outs["port", "float32"]
                           - outs["ref", "float32"]).max())
    print(f"max p {p:.4g}; bf16 vs f32: reference {ref_gap:.4g}, port "
          f"{port_gap:.4g}; f32 port vs reference {f32_gap:.4g}")
    assert ref_gap > 20 * 2.0 ** (np.floor(np.log2(p)) - 7)
    assert port_gap <= 2 * ref_gap
    assert f32_gap <= 5e-4 * p
