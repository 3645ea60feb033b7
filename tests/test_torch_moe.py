"""The port's MoELayer and the MoE transformer LM against the JAX
package's, on the CPU: the cases of ``tests/test_moe.py`` (all but the
expert-parallel class), and parity from reference checkpoints.

Parity runs from the reference's weights: a reference net (or layer) is
initialised and saved (or its parameters copied), and the port loads them.
Inputs are made from numpy seeds; dropout is off.

Tolerances: f32 probabilities within 1e-5, the loss within 1e-5
relative, step-0 gradients within 1e-4 of each leaf's largest magnitude
(the experts' sums run in another order: the port folds the sum over
experts into one GEMM), five adam steps' losses within 1e-4 relative; the
layer alone within 1e-5 (f32) and 1e-10 (f64); the f64 finite-difference
check at the reference's rel 1e-4, abs 1e-7. Greedy decode tokens and
the expert choices are compared exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as j_dtypes
from deeplearning4j_tpu.models import transformer_lm as j_transformer_lm
from deeplearning4j_tpu.models.transformer import generate as j_generate
from deeplearning4j_tpu.nn.conf.builders import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.conf.moe import MoELayer as JMoE
from deeplearning4j_tpu.nn.graph_runtime import \
    ComputationGraph as JComputationGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util import health as j_health
from deeplearning4j_tpu.util.serialization import load_model as j_load
from deeplearning4j_tpu.util.serialization import save_model as j_save

from deeplearning4j_tpu_torch import dtypes as t_dtypes
from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.models.transformer import (
    draft_transformer_lm, generate)
from deeplearning4j_tpu_torch.nn.conf import (ComputationGraphConfiguration,
                                              InputType,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.conf.moe import MoELayer, topk_keep
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving.decode import (DecodeScheduler,
                                                     PagedDecodeEngine)
from deeplearning4j_tpu_torch.util import health as t_health
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.resilience import ManualClock
from deeplearning4j_tpu_torch.util.serialization import (load_model,
                                                         save_model)

V, T, B = 11, 8, 4
F32 = 1e-5
GRAD = 1e-4
STEPS = 1e-4


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _jconf(pkg_lm=j_transformer_lm, experts=4, top_k=2, **kw):
    args = dict(n_layers=2, d_model=16, n_heads=2, d_ff=32, seed=5,
                moe_experts=experts, moe_top_k=top_k, input_ids=True,
                updater="adam", learning_rate=1e-2)
    args.update(kw)
    return pkg_lm(V, **args)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference MoE LM checkpoint (d 16, 4 experts, top-2), with one
    adam step in its updater state, and a batch."""
    jnet = JComputationGraph(_jconf(max_cache_t=32)).init()
    ids = np.random.default_rng(0).integers(0, V, (B, T + 1)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    jnet.fit_batch([x], [y])
    path = str(tmp_path_factory.mktemp("moe") / "ref.zip")
    j_save(jnet, path)
    return path, x, y


def _pair(ckpt):
    path = ckpt[0]
    return j_load(path), load_model(path, device="cpu")


# --------------------------------------------------------------------------
# the layer alone
# --------------------------------------------------------------------------


def _layers(n_in=8, d_hidden=16, experts=4, top_k=2, it=None, seed=0):
    it = it or JInputType.recurrent(n_in, 4)
    jl = JMoE(n_in=n_in, d_hidden=d_hidden, n_experts=experts, top_k=top_k)
    jl.set_n_in(it)
    tl = MoELayer(n_in=n_in, d_hidden=d_hidden, n_experts=experts,
                  top_k=top_k)
    tl.set_n_in(InputType(**it.__dict__))
    jp = jl.init_params(jax.random.key(seed))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    return jl, jp, tl, tp


@pytest.mark.parametrize("shape,top_k,masked", [
    ((2, 4, 8), 2, False), ((6, 8), 2, False), ((2, 4, 8), 2, True),
    ((3, 5, 8), 4, False), ((3, 5, 8), 1, True), ((3, 5, 8), 3, False)])
def test_layer_equals_reference(shape, top_k, masked):
    jl, jp, tl, tp = _layers(top_k=top_k)
    rng = np.random.default_rng(sum(shape) + top_k)
    x = rng.normal(size=shape).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random(shape[:2]) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
    jy, jst = jl.apply(jp, jnp.asarray(x),
                       mask=None if mask is None else jnp.asarray(mask))
    ty, tst = tl.apply(tp, torch.from_numpy(x),
                       mask=None if mask is None else torch.from_numpy(mask))
    assert tuple(ty.shape) == tuple(jy.shape)
    assert _rel(ty.numpy(), jy) <= F32
    assert _rel(float(tst["aux_loss"]), float(jst["aux_loss"])) <= F32
    if masked:
        assert np.all(ty.numpy()[mask == 0] == 0.0)


def test_uniform_gates_fire_exactly_top_k_lowest_first():
    """A zero router gives equal gates: exactly top_k experts fire, the
    lowest-indexed ones, as lax.top_k picks them — in the layer and in
    its output against the reference's."""
    jl, jp, tl, tp = _layers(experts=5, top_k=2)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(3).normal(size=(2, 4, 8)).astype(np.float32)
    gates, keep, weights = tl.route(tp, torch.from_numpy(x))
    assert torch.all(keep.sum(-1) == 2)
    assert torch.all(keep[..., :2]) and not torch.any(keep[..., 2:])
    assert torch.allclose(weights[..., :2], torch.full_like(weights[..., :2],
                                                            0.5))
    jy, jst = jl.apply(jp, jnp.asarray(x))
    ty, tst = tl.apply(tp, torch.from_numpy(x))
    assert _rel(ty.numpy(), jy) <= F32
    assert float(tst["aux_loss"]) == pytest.approx(float(jst["aux_loss"]),
                                                   rel=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3, 7])
def test_topk_keep_matches_lax_top_k_with_ties(k):
    """Gates on a coarse grid, so most rows hold ties: the keep mask is
    lax.top_k's (lowest index among equals)."""
    g = np.round(np.random.default_rng(k).random((64, 8)) * 4) / 4
    _, idx = jax.lax.top_k(jnp.asarray(g), k)
    want = np.asarray(jax.nn.one_hot(idx, 8).sum(axis=1) > 0)
    got = topk_keep(torch.from_numpy(g), k).numpy()
    assert (got == want).all()
    assert (got.sum(-1) == k).all()


def test_2d_and_3d_agree():
    _, _, tl, tp = _layers(it=JInputType.feed_forward(8))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(6, 8)).astype(np.float32))
    y2, _ = tl.apply(tp, x)
    y3, _ = tl.apply(tp, x[:, None, :])
    assert torch.allclose(y2, y3[:, 0], atol=1e-6)


def test_mask_zeroes_and_excludes_from_aux():
    _, _, tl, tp = _layers()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 4, 8)).astype(np.float32))
    mask = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1]], dtype=torch.float32)
    y, st = tl.apply(tp, x, mask=mask)
    assert torch.all(y[0, 2:] == 0.0)
    x2 = x.clone()
    x2[0, 3] = 100.0
    _, st2 = tl.apply(tp, x2, mask=mask)
    assert float(st["aux_loss"]) == pytest.approx(float(st2["aux_loss"]),
                                                  rel=1e-6)


def _f64_layer(top_k):
    jl, jp, tl, tp = _layers(n_in=4, d_hidden=8, experts=3, top_k=top_k,
                             it=JInputType.recurrent(4, 3), seed=1)
    jp = {k: jnp.asarray(v, jnp.float64) for k, v in jp.items()}
    tp = {k: v.double() for k, v in tp.items()}
    return jl, jp, tl, tp


def test_gradient_check_dense_gating():
    """top_k == n_experts (no discrete routing): the f64 central
    difference through the whole layer, aux loss included, at the
    reference test's rel 1e-4 and abs 1e-7; and the port's f64 gradient
    against the reference's within 1e-10."""
    jl, jp, tl, tp = _f64_layer(3)
    x = np.random.default_rng(4).normal(size=(2, 3, 4))
    f64 = t_dtypes.FLOAT64

    def loss(p):
        y, st = tl.apply(p, torch.from_numpy(x), policy=f64)
        return torch.sum(y ** 2) + st["aux_loss"]

    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    grads = dict(zip(live, torch.autograd.grad(loss(live),
                                               list(live.values()))))
    eps = 1e-6
    with torch.no_grad():
        for k, leaf in tp.items():
            idx = (0,) * leaf.ndim
            plus = dict(tp)
            minus = dict(tp)
            plus[k] = leaf.clone()
            plus[k][idx] += eps
            minus[k] = leaf.clone()
            minus[k][idx] -= eps
            fd = (float(loss(plus)) - float(loss(minus))) / (2 * eps)
            assert float(grads[k][idx]) == pytest.approx(fd, rel=1e-4,
                                                         abs=1e-7), k
    jf64 = j_dtypes.policy_from_name("float64")

    def jloss(p):
        y, st = jl.apply(p, jnp.asarray(x), policy=jf64)
        return jnp.sum(y ** 2) + st["aux_loss"]

    jg = jax.grad(jloss)(jp)
    for k in tp:
        assert _rel(grads[k].numpy(), jg[k]) <= 1e-10, k


def test_routed_gradient_equals_reference_f64():
    """top-2 of 3: the routed layer's f64 gradient (the keep mask is a
    constant of the step) against the reference's."""
    jl, jp, tl, tp = _f64_layer(2)
    x = np.random.default_rng(5).normal(size=(2, 3, 4))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, st = tl.apply(live, torch.from_numpy(x), policy=t_dtypes.FLOAT64)
    gs = torch.autograd.grad(torch.sum(y ** 2) + st["aux_loss"],
                             list(live.values()))
    jf64 = j_dtypes.policy_from_name("float64")
    jg = jax.grad(lambda p: (lambda o: jnp.sum(o[0] ** 2) + o[1]["aux_loss"])(
        jl.apply(p, jnp.asarray(x), policy=jf64)))(jp)
    for k, g in zip(live, gs):
        assert _rel(g.numpy(), jg[k]) <= 1e-10, k


def test_serde_and_json_equal_reference():
    tconf = _jconf(transformer_lm, experts=4)
    jconf = _jconf(experts=4)
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    layer = back.vertices["blk0_moe"].layer
    assert isinstance(layer, MoELayer)
    assert (layer.n_experts, layer.top_k, layer.d_hidden) == (4, 2, 32)
    assert "blk0_ff1" not in back.vertices


def test_top_k_above_experts_raises():
    with pytest.raises(ValueError, match="top_k"):
        MoELayer(d_hidden=4, n_experts=2, top_k=3).set_n_in(
            InputType.recurrent(4))


# --------------------------------------------------------------------------
# the MoE transformer LM from a reference checkpoint
# --------------------------------------------------------------------------


def test_probabilities_equal_reference(ckpt):
    jnet, tnet = _pair(ckpt)
    _, x, _ = ckpt
    assert _rel(tnet.output(x).numpy(), jnet.output(x)) <= F32


def test_step0_loss_and_grads_equal_reference(ckpt):
    jnet, tnet = _pair(ckpt)
    _, x, y = ckpt
    jl, jg = jax.value_and_grad(
        lambda p: jnet._loss_fn(p, jnet._states_map(), [jnp.asarray(x)],
                                [jnp.asarray(y)], None, None)[0])(jnet.params)
    tl, tg = tnet._loss_and_grads([torch.from_numpy(x)],
                                  [torch.from_numpy(y)], None)
    assert _rel(float(tl), float(jl)) <= F32
    assert set(tg) == set(jg)
    for v, gs in tg.items():
        assert set(gs) == set(jg[v])
        for k, g in gs.items():
            assert _rel(g.numpy(), jg[v][k]) <= GRAD, (v, k)
    # the router's gradient holds the aux term: it is non-zero
    assert float(tg["blk0_moe"]["router"].abs().max()) > 0


def test_five_adam_steps_equal_reference(ckpt):
    """From the checkpoint's adam state: five steps in each package."""
    jnet, tnet = _pair(ckpt)
    _, x, y = ckpt
    jl = [float(jnet.fit_batch([x], [y])) for _ in range(5)]
    tl = [float(tnet.fit_batch([x], [y])) for _ in range(5)]
    assert _rel(tl, jl) <= STEPS
    assert tl[-1] < tl[0]
    for v, ps in tnet.params.items():
        for k, p in ps.items():
            assert _rel(p.detach().numpy(), jnet.params[v][k]) <= 1e-3, (v, k)


def test_checkpoint_both_ways_with_adam_state(ckpt, tmp_path):
    """Reference → port: the expert-stacked parameters and every adam
    moment arrive as saved. Port → reference after a port step: the same
    arrays, and the reference's next loss equals the port's."""
    path, x, y = ckpt
    jnet, tnet = _pair(ckpt)
    assert tnet.params["blk1_moe"]["w1"].shape == (4, 16, 32)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: np.asarray(tree.detach() if torch.is_tensor(tree)
                                   else tree)}

    def assert_equal(port, ref):
        fp, fr = flat({"p": port.params, "u": port.updater_state}), \
            flat({"p": ref.params, "u": ref.updater_state})
        assert set(fp) == set(fr)
        assert [k for k in fp if "/w2" in k and k.startswith("/u")]
        for k in fp:
            assert np.array_equal(fp[k], fr[k]), k

    assert_equal(tnet, jnet)
    tnet.fit_batch([x], [y])
    out = str(tmp_path / "port.zip")
    save_model(tnet, out)
    back = j_load(out)
    assert_equal(tnet, back)
    assert back.iteration_count == 2
    lj = float(back.fit_batch([x], [y]))
    lt = float(tnet.fit_batch([x], [y]))
    assert _rel(lt, lj) <= STEPS


def test_aux_loss_is_never_persisted(ckpt, tmp_path):
    _, tnet = _pair(ckpt)
    _, x, y = ckpt
    tnet.fit_batch([x], [y])
    assert all("aux_loss" not in st for st in tnet.state.values())
    out = str(tmp_path / "p.zip")
    save_model(tnet, out)
    import zipfile
    import io
    with zipfile.ZipFile(out) as zf:
        names = np.load(io.BytesIO(zf.read("arrays.npz"))).files
    assert not [n for n in names if "aux" in n]
    assert [n for n in names if n.startswith("updater/") and "w1" in n]


def test_health_norms_over_expert_weights_equal_reference(ckpt):
    jnet, tnet = _pair(ckpt)
    _, x, y = ckpt
    jnet.enable_health_stats()
    tnet.enable_health_stats()
    jnet.fit_batch([x], [y])
    tnet.fit_batch([x], [y])
    ref = j_health.latest_stats(jnet).value()
    got = t_health.latest_stats(tnet).value()
    for layer in ("blk0_moe", "blk1_moe"):
        for field in ("param_norm", "grad_norm", "update_norm"):
            assert got[layer][field] == pytest.approx(ref[layer][field],
                                                      rel=1e-4), (layer,
                                                                  field)


def test_remat_equals_full_walk_on_moe(ckpt):
    """Gradient checkpointing on the MoE LM: the same loss and gradients,
    and the aux term still in the loss."""
    _, a = _pair(ckpt)
    _, b = _pair(ckpt)
    b.conf.training.gradient_checkpointing = True
    _, x, y = ckpt
    la, ga = a._loss_and_grads([torch.from_numpy(x)], [torch.from_numpy(y)],
                               None)
    lb, gb = b._loss_and_grads([torch.from_numpy(x)], [torch.from_numpy(y)],
                               None)
    assert float(la) == pytest.approx(float(lb), rel=1e-6)
    for v in ga:
        for k in ga[v]:
            assert _rel(gb[v][k].numpy(), ga[v][k].numpy()) <= 1e-5, (v, k)


# --------------------------------------------------------------------------
# training (the reference's TestMoETraining)
# --------------------------------------------------------------------------


def _batch(seed=0):
    ids = np.random.default_rng(seed).integers(0, V, (B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _tnet(aux_weight=None, updater="sgd", lr=0.05, experts=8):
    conf = transformer_lm(V, n_layers=2, d_model=16, n_heads=2, d_ff=32,
                          updater=updater, learning_rate=lr, seed=5,
                          moe_experts=experts)
    if aux_weight is not None:
        for v in conf.vertices.values():
            if isinstance(getattr(v, "layer", None), MoELayer):
                v.layer.aux_weight = aux_weight
    return ComputationGraph(conf, device="cpu").init()


def test_training_loss_includes_aux():
    x, y = _batch()
    la = float(_tnet().fit_batch([x], [y]))
    lb = float(_tnet(aux_weight=0.0).fit_batch([x], [y]))
    assert la > lb      # E · Σ gate·keep ≥ 1, so aux > 0


def test_moe_transformer_trains():
    net = _tnet(updater="adam", lr=1e-2)
    x, y = _batch()
    l0 = float(net.fit_batch([x], [y]))
    for _ in range(10):
        last = float(net.fit_batch([x], [y]))
    assert last < l0


def _mln(pkg, aux_w):
    nnc, moe, out, it = pkg
    return (nnc.builder().seed(2).updater("sgd").learning_rate(0.05).list()
            .layer(moe(d_hidden=16, n_experts=4, top_k=2, aux_weight=aux_w))
            .layer(out(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(it.recurrent(V)).build())


JPKG = (JNNC, JMoE, JRnnOut, JInputType)
TPKG = (NeuralNetConfiguration, MoELayer, RnnOutputLayer, InputType)


def test_multilayer_aux_loss_wired():
    x, y = _batch()
    la = MultiLayerNetwork(_mln(TPKG, 0.01), device="cpu").init().score_for(
        x, y)
    lb = MultiLayerNetwork(_mln(TPKG, 0.0), device="cpu").init().score_for(
        x, y)
    assert la > lb


def test_multilayer_moe_equals_reference(tmp_path):
    assert json.loads(_mln(TPKG, 0.01).to_json()) == \
        json.loads(_mln(JPKG, 0.01).to_json())
    jnet = JMLN(_mln(JPKG, 0.01)).init()
    path = str(tmp_path / "mln.zip")
    j_save(jnet, path)
    tnet = load_model(path, device="cpu")
    assert isinstance(tnet, MultiLayerNetwork)
    x, y = _batch(3)
    assert _rel(tnet.score_for(x, y), jnet.score_for(x, y)) <= F32
    jl = [float(jnet.fit_batch(x, y)) for _ in range(3)]
    tl = [float(tnet.fit_batch(x, y)) for _ in range(3)]
    assert _rel(tl, jl) <= STEPS


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def test_generate_equals_reference(ckpt):
    jnet, tnet = _pair(ckpt)
    rng = np.random.default_rng(7)
    for n in (1, 5, 12):
        prompt = rng.integers(0, V, n).astype(np.int32)
        assert generate(tnet, prompt, 9).tolist() == \
            np.asarray(j_generate(jnet, prompt, 9)).tolist()


@pytest.mark.parametrize("mode", ["ticked", "fused", "self_draft",
                                  "dense_draft"])
def test_paged_greedy_decode_equals_generate(ckpt, mode):
    """The paged engine over the MoE LM — the ticked step, fused blocks,
    and speculative decoding with the MoE LM as its own draft (MoE draft
    and verify) or a dense draft: every greedy request's tokens equal
    generate's."""
    _, tnet = _pair(ckpt)
    kw = {"fused": dict(block_len=4),
          "self_draft": dict(draft_net=tnet, draft_k=3),
          "dense_draft": dict(draft_net=ComputationGraph(
              draft_transformer_lm(V, d_model=16, n_heads=2, d_ff=32,
                                   max_cache_t=32), device="cpu").init(),
              draft_k=3)}.get(mode, {})
    reg = MetricsRegistry()
    eng = PagedDecodeEngine(tnet, max_batch=4, page_size=8, pages_per_seq=4,
                            prefill_chunk=4, registry=reg, **kw)
    sched = DecodeScheduler(eng, clock=ManualClock(), registry=reg,
                            start_thread=False)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (3, 9, 6, 2)]
    reqs = [sched.submit(p, n) for p, n in zip(prompts, (7, 5, 9, 6))]
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        sched.step_once()
    assert all(r.done for r in reqs)
    for r, p, n in zip(reqs, prompts, (7, 5, 9, 6)):
        assert r.tokens == generate(tnet, p, n).tolist()
