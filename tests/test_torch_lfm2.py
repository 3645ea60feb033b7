"""The hybrid conv/attention LM with sparse experts (``lfm2_moe_lm`` and
the layers of ``nn/conf/hybrid.py``) against the benchmark's plain
reference (``benchmark/reference/lfm2.py``), on the CPU at a tiny size
in float32: d 64, 4 query heads and 2 K/V heads of 16, 6 layers (conv,
attention, dense and MoE layers all present), 8 experts, top 2.

Tolerances: the loss within 1e-5 relative and each leaf's first gradient
within 1e-4 of its largest magnitude (sums run in other orders: the
experts' rows are grouped, the attention's K/V repeated); the layers
alone within 1e-5; the parameters after three adam steps within 1e-5
absolute, 1% of a step (adam moves a parameter by about lr = 1e-3 a
step, whatever its gradient's size, so round-off in a small gradient
moves it by up to a few ulps of its step) and the
selection biases exactly (their steps are ±rate or 0); the custom
backwards by finite differences in f64 (``gradcheck``'s own tolerances).
Routing is compared exactly: in f32 on equal inputs no choice is near a
tie.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.models import lfm2_moe_lm
from deeplearning4j_tpu_torch.nn.conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.hybrid import (
    GatedShortConvLayer, GroupedQueryAttentionLayer, RMSNormalization,
    SparseMoELayer, SwiGLUFeedForwardLayer)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (layer_from_dict,
                                                     layer_to_dict)
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.ops import moe_dispatch, norms, short_conv
from deeplearning4j_tpu_torch.util.metrics import Counter

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from reference import lfm2 as ref  # noqa: E402
from reference import optim as ref_optim  # noqa: E402
from reference.precision import Arithmetic  # noqa: E402

F32 = Arithmetic("f32")
D, H, KV, FF, EFF, E, K = 64, 4, 2, 96, 32, 8, 2
TYPES = ["conv", "conv", "full_attention", "conv", "full_attention", "conv"]
V, B, T = 97, 2, 16


def _cfg(held=E, first=0):
    return {"hidden_size": D, "num_attention_heads": H,
            "num_key_value_heads": KV, "intermediate_size": FF,
            "moe_intermediate_size": EFF, "num_hidden_layers": len(TYPES),
            "layer_types": TYPES, "num_dense_layers": 2, "num_experts": held,
            "num_experts_per_tok": K, "norm_eps": 1e-5, "rope_theta": 1e4,
            "routed_scaling_factor": 1.0, "conv_L_cache": 3,
            "vocab_size": V,
            "training": {"updater": "adam", "learning_rate": 1e-3,
                         "beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                         "expert_bias_update_rate": 1e-3},
            "deployment": {"routed_experts": E, "first_expert": first}}


def _conf(cfg):
    t = cfg["training"]
    return lfm2_moe_lm(
        V, layer_types=TYPES, d_model=D, n_heads=H, n_kv_heads=KV,
        d_ff=FF, moe_d_ff=EFF, n_experts=E, top_k=K,
        experts_held=cfg["num_experts"],
        first_expert=cfg["deployment"]["first_expert"],
        num_dense_layers=2, conv_L=3, rope_theta=1e4, norm_eps=1e-5,
        bias_update_rate=t["expert_bias_update_rate"], updater="adam",
        learning_rate=t["learning_rate"], dtype="float32")


def _tree(shapes, seed=0):
    """Weights from numpy: norm weights near 1, the rest N(0, 0.1); a
    ``W13`` drawn as its two halves, W₁'s then W₃'s."""
    rng = np.random.default_rng(seed)
    tree = {}
    for v, ks in shapes.items():
        tree[v] = {}
        for k, s in ks.items():
            if k == "W13":
                half = (*s[:-1], s[-1] // 2)
                a = np.concatenate([rng.normal(0.0, 0.1, half),
                                    rng.normal(0.0, 0.1, half)], axis=-1)
            else:
                a = rng.normal(0.0, 0.1, s)
            if k in ("gamma", "q_norm", "k_norm"):
                a = 1.0 + a
            tree[v][k] = torch.tensor(a, dtype=torch.float32)
    return tree


def _clone(tree):
    return {v: {k: p.clone() for k, p in ps.items()} for v, ps in tree.items()}


def _batch(step):
    ids = np.random.default_rng(100 + step).integers(0, V, (B, T + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def _net(cfg, seed=0):
    conf = _conf(cfg)
    net = ComputationGraph(conf, device="cpu")
    shapes = {n: conf.vertices[n].param_shapes(dtypes.FLOAT32)
              for n in conf.topological_order()}
    tree = _tree(shapes, seed)
    net.set_params(_clone(tree))
    net.init_updater()
    return net, tree


def _close(got, want, tol):
    scale = float(want.abs().max()) + 1e-12
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{err} of {scale}"


# --------------------------------------------------------------------------
# the whole model against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("held, first", [(E, 0), (2, 2)])
def test_program_matches_reference_in_f32(held, first):
    """Probabilities, loss and every leaf's gradient of the first batch,
    then the parameters and the selection biases after three adam steps,
    against the reference run from the same weights and batches."""
    cfg = _cfg(held, first)
    net, tree = _net(cfg)
    x0, y0 = _batch(0)
    params = _clone(tree)
    leaves = [(v, k, p.requires_grad_(True)) for v, ps in params.items()
              for k, p in ps.items()]
    biases = ref.zero_biases(cfg, "cpu")
    logits, _ = ref.logits(params, torch.as_tensor(x0), cfg, F32, biases)
    loss_ref = ref.summed_loss(logits, torch.as_tensor(y0)) / B
    grads_ref = torch.autograd.grad(loss_ref, [p for _, _, p in leaves])

    probs = net.output(x0)
    _close(probs, torch.softmax(logits.detach(), -1), 1e-5)
    loss, grads = net._loss_and_grads([torch.as_tensor(x0)],
                                      [torch.as_tensor(y0)], None)
    assert float(loss) == pytest.approx(float(loss_ref.detach()), rel=1e-5)
    for (v, k, _), g in zip(leaves, grads_ref):
        _close(grads[v][k], g, 1e-4)

    opt = ref_optim.make(cfg["training"])
    params = _clone(tree)
    state = opt.init(params)
    for step in range(3):
        x, y = _batch(step)
        net.fit_batch(x, y)
        named = [(v, k, p.requires_grad_(True)) for v, ps in params.items()
                 for k, p in ps.items()]
        out, loads = ref.logits(params, torch.as_tensor(x), cfg, F32, biases)
        gs = torch.autograd.grad(ref.summed_loss(out, torch.as_tensor(y)) / B,
                                 [p for _, _, p in named])
        grads = {v: {} for v in params}
        for (v, k, _), g in zip(named, gs):
            grads[v][k] = g
        opt.step(params, grads, state)
        biases = ref.next_biases(biases, loads, cfg)
    got = net.params
    for v, ps in params.items():
        for k, p in ps.items():
            assert float((got[v][k].detach() - p.detach()).abs().max()) \
                <= 1e-5, f"{v}.{k}"
    for v, b in biases.items():
        assert torch.equal(net.state[v]["bias"], b), v
    assert any(b.abs().sum() > 0 for b in biases.values())


# --------------------------------------------------------------------------
# the sparse MoE layer
# --------------------------------------------------------------------------


def _moe_layer(held, first):
    layer = SparseMoELayer(n_in=D, d_hidden=EFF, n_experts=E, top_k=K,
                           experts_held=held, first_expert=first)
    layer.set_n_in(InputType.recurrent(D))
    return layer


def _moe_params(seed=1):
    rng = np.random.default_rng(seed)

    def t(*s):
        return torch.tensor(rng.normal(0.0, 0.2, s), dtype=torch.float32)

    return {"router": t(D, E), "W13": t(E, D, 2 * EFF),
            "W2": t(E, EFF, D)}, t(E) * 0.3, t(B, T, D) * 5


def _share(params, first, held):
    return {"router": params["router"],
            **{k: params[k][first:first + held] for k in ("W13", "W2")}}


def _dense_formula(share, bias, x, first, k=K):
    """Every held expert (the share's, ``first`` on) on every token,
    weighted by its normalised score where chosen and 0 elsewhere."""
    s = torch.sigmoid(x @ share["router"])
    chosen = torch.topk(s + bias, k, dim=-1).indices
    w = s.gather(-1, chosen)
    w = w / (w.sum(-1, keepdim=True) + 1e-6)
    out = torch.zeros_like(x)
    for j, (w13, w2) in enumerate(zip(share["W13"], share["W2"])):
        w_e = (w * (chosen == first + j)).sum(-1, keepdim=True)
        w1, w3 = w13.chunk(2, dim=-1)
        out = out + w_e * ((torch.nn.functional.silu(x @ w1) * (x @ w3))
                           @ w2)
    return out


@pytest.mark.parametrize("held, first", [(E, 0), (2, 0), (2, 6), (3, 4)])
def test_routed_dispatch_equals_the_dense_formula(held, first):
    """Output and every input's gradient of the routed, dropless dispatch
    against the dense formula of the same layer."""
    full, bias, x = _moe_params()
    share = _share(full, first, held)
    params = {k: v.clone().requires_grad_(True) for k, v in share.items()}
    x = x.requires_grad_(True)
    y, _ = _moe_layer(held, first).apply(params, x, state={"bias": bias})
    _close(y, _dense_formula(share, bias, x.detach(), first), 1e-5)
    r = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad((y * r).sum(), [x, *params.values()])
    xd = x.detach().requires_grad_(True)
    pd = {k: v.clone().requires_grad_(True) for k, v in share.items()}
    want = _dense_formula(pd, bias, xd, first)
    exp = torch.autograd.grad((want * r).sum(), [xd, *pd.values()])
    for g, e in zip(got, exp):
        _close(g, e, 1e-5)


def test_shares_add_up_to_the_uncut_layer():
    """Four chips holding two experts each: their outputs add up to the
    reference's layer holding all eight."""
    full, bias, x = _moe_params(seed=2)
    total = sum(_moe_layer(2, first).apply(_share(full, first, 2), x,
                                           state={"bias": bias})[0]
                for first in range(0, E, 2))
    cfg = _cfg(E, 0)
    cfg["num_experts_per_tok"] = K
    want, loads = ref.moe(x, full, bias, cfg, F32)
    _close(total, want, 1e-5)
    assert int(loads.sum()) == B * T * K


def test_selection_bias_moves_by_the_held_loads_and_is_counted():
    """A training forward moves the held experts' biases by ±rate (0 at
    the mean load) and leaves the others; the assignments are counted on
    the device, held and absent adding up to tokens × k."""
    full, bias, x = _moe_params(seed=4)
    layer = _moe_layer(3, 2)
    layer.name = "probe_moe"
    from deeplearning4j_tpu_torch.nn.conf.hybrid import assignments_counter
    counter = assignments_counter()
    before = [counter.value(model="probe_moe", path=p)
              for p in ("held", "absent")]
    _, st = layer.apply(_share(full, 2, 3), x, state={"bias": bias},
                        train=True)
    chosen = torch.topk(torch.sigmoid(x @ full["router"]) + bias, K,
                        dim=-1).indices
    loads = torch.stack([(chosen == e).sum() for e in range(2, 5)]).float()
    step = 1e-3 * torch.sign(loads.mean() - loads)
    assert torch.equal(st["bias"][2:5], bias[2:5] + step)
    assert torch.equal(st["bias"][:2], bias[:2])
    assert torch.equal(st["bias"][5:], bias[5:])
    held, absent = (counter.value(model="probe_moe", path=p) - b0
                    for p, b0 in zip(("held", "absent"), before))
    assert held == float(loads.sum())
    assert held + absent == B * T * K


def test_device_counts_fold_in_when_read():
    c = Counter("probe_total", "probe", ("path",))
    c.inc(2.0, path="held")
    with torch.inference_mode():
        c.inc_device(torch.tensor(3), path="held")
    c.inc_device(torch.tensor([4]), path="held")
    c.inc_device(torch.tensor(5), path="absent")
    assert c.value(path="held") == 9.0
    assert c.snapshot()["series"] == [
        {"labels": {"path": "absent"}, "value": 5.0},
        {"labels": {"path": "held"}, "value": 9.0}]


# --------------------------------------------------------------------------
# the short convolution and attention layers
# --------------------------------------------------------------------------


def _layer_params(layer, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.tensor(rng.normal(0.0, 0.2, s) + (k.endswith("norm")),
                            dtype=torch.float32)
            for k, s in layer.param_shapes().items()}


def test_short_conv_is_causal():
    layer = GatedShortConvLayer(n_in=D, conv_l=3)
    layer.set_n_in(InputType.recurrent(D))
    params = _layer_params(layer, 5)
    x = torch.randn(B, T, D, generator=torch.Generator().manual_seed(6))
    y, _ = layer.apply(params, x)
    for t0 in (0, 5, T - 2):
        x2 = x.clone()
        x2[:, t0 + 1:] = torch.randn(B, T - t0 - 1, D)
        y2, _ = layer.apply(params, x2)
        assert torch.equal(y2[:, :t0 + 1], y[:, :t0 + 1])
        assert not torch.equal(y2[:, t0 + 1:], y[:, t0 + 1:])
    _close(y, ref.short_conv(x, params, F32), 1e-5)


@pytest.mark.parametrize("kv", [1, 2, 4])
def test_gqa_with_repeated_kv_equals_grouped_attention(kv):
    """The layer (K/V repeated to the query heads, the port's attention
    op) against the reference's attention computed per K/V head over its
    group of queries: output and input gradient."""
    layer = GroupedQueryAttentionLayer(n_in=D, n_heads=H, n_kv_heads=kv,
                                       rope_theta=1e4)
    layer.set_n_in(InputType.recurrent(D))
    params = _layer_params(layer, 7)
    x = torch.randn(B, T, D, generator=torch.Generator().manual_seed(8))
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y, _ = layer.apply(params, x1)
    cfg = dict(_cfg(), num_key_value_heads=kv)
    want = ref.attention(x2, params, cfg, F32)
    _close(y, want, 1e-5)
    g1, = torch.autograd.grad(y.square().sum(), x1)
    g2, = torch.autograd.grad(want.square().sum(), x2)
    _close(g1, g2, 1e-5)


def _f64(*shape, seed=0):
    return torch.randn(*shape, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(seed)
                       ).requires_grad_(True)


def _grouped_case():
    k = 2
    chosen = torch.tensor([[0, 3], [1, 0], [3, 2], [0, 1], [2, 3]])
    p = moe_dispatch.plan(chosen, 0, 2)
    xs = moe_dispatch.gather_rows(_f64(5, 6, seed=1), p, k).detach()
    return p, xs


BACKWARDS = {
    "rms_norm": lambda: (lambda x, w: norms.rms_norm(x, w, 1e-5),
                         (_f64(3, 4, 8), _f64(8, seed=1))),
    "short_conv": lambda: (short_conv.gated_short_conv,
                           (_f64(2, 7, 12), _f64(4, 3, seed=1))),
    "swiglu": lambda: (moe_dispatch.SwiGLU.apply, (_f64(5, 8),)),
    "router": lambda: (lambda x, w: moe_dispatch.route(
        x, w, torch.zeros(5, dtype=torch.float64), 2)[1],
        (_f64(6, 4), _f64(4, 5, seed=1))),
    "gather": lambda: (lambda x: moe_dispatch.gather_rows(
        x, moe_dispatch.plan(torch.tensor([[0, 3], [1, 0], [3, 2]]), 1, 2),
        2), (_f64(3, 4),)),
    "combine": lambda: (lambda y, w: moe_dispatch.combine(
        y, w, moe_dispatch.plan(torch.tensor([[0, 3], [1, 0], [3, 2]]), 0,
                                4)), (_f64(6, 5), _f64(3, 2, seed=1))),
    "grouped_swiglu": lambda: (lambda xs, w13, w2: moe_dispatch.grouped_swiglu(
        xs, w13, w2, _grouped_case()[0]),
        (_grouped_case()[1].requires_grad_(True), _f64(2, 6, 8, seed=2),
         _f64(2, 4, 6, seed=3))),
}


@pytest.mark.parametrize("name", sorted(BACKWARDS))
def test_custom_backwards_by_finite_differences(name):
    fn, args = BACKWARDS[name]()
    assert torch.autograd.gradcheck(fn, args)


# --------------------------------------------------------------------------
# configuration, serving
# --------------------------------------------------------------------------


LAYERS = {
    "rms_norm": RMSNormalization(n_out=D, eps=1e-6),
    "swiglu_ffn": SwiGLUFeedForwardLayer(n_in=D, d_hidden=FF),
    "gated_short_conv": GatedShortConvLayer(n_in=D, conv_l=4),
    "gqa_attention": GroupedQueryAttentionLayer(
        n_in=D, n_heads=H, n_kv_heads=KV, rope_theta=1e6),
    "sparse_moe": SparseMoELayer(n_in=D, d_hidden=EFF, n_experts=E, top_k=K,
                                 experts_held=2, first_expert=6,
                                 routed_scaling=2.5, bias_update_rate=1e-2),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_json_round_trip(name):
    d = layer_to_dict(LAYERS[name])
    assert d["type"] == name
    back = layer_from_dict(d)
    assert back == LAYERS[name]
    assert layer_to_dict(back) == d


def test_model_json_round_trip_and_size():
    conf = _conf(_cfg(2, 2))
    js = conf.to_json()
    again = ComputationGraphConfiguration.from_json(js)
    assert again.to_json() == js
    kinds = [type(v.layer).__name__ for n, v in again.vertices.items()
             if n.endswith(("_conv", "_attn", "_ffn", "_moe"))]
    assert kinds.count("GatedShortConvLayer") == 4
    assert kinds.count("GroupedQueryAttentionLayer") == 2
    assert kinds.count("SwiGLUFeedForwardLayer") == 2
    assert kinds.count("SparseMoELayer") == 4
    net = ComputationGraph(again, device="cpu")
    net.init()
    per_moe = D * E + 3 * 2 * D * EFF
    want = (2 * V * D + V + 4 * (3 * D * D + 3 * D + D * D)
            + 2 * (2 * D * D + 2 * D * (D // 2) + 2 * (D // H))
            + 2 * 3 * D * FF + 4 * per_moe + 13 * D)
    assert net.num_params() == want
    with pytest.raises(ValueError, match="layer types"):
        lfm2_moe_lm(V, layer_types=["conv", "mamba"], d_model=D, n_heads=H,
                    n_kv_heads=KV, d_ff=FF, moe_d_ff=EFF, n_experts=E,
                    top_k=K, num_dense_layers=1)


def test_decode_engine_refuses_the_short_convs_state():
    from deeplearning4j_tpu_torch.serving.decode import PagedDecodeEngine
    net, _ = _net(_cfg(2, 2))
    with pytest.raises(ValueError, match="short-conv state"):
        PagedDecodeEngine(net, max_batch=2, page_size=4, pages_per_seq=4)


# --------------------------------------------------------------------------
# on the card (``python -m pytest --noconftest -m cuda
# tests/test_torch_lfm2.py``; this file imports no JAX)
# --------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_routed_experts_equal_the_plain_version_without_a_sync():
    """At LFM2-8B-A1B's widths (d 2,048, experts of 1,792, 8 held of 32,
    top 4, 8,192 tokens): the routed layer's forward and backward in bf16
    through ``torch._grouped_mm``, run under CUDA's sync debug mode set to
    raise, against the plain dense formula of the same layer in f32 (every
    held expert on every token), within bf16's round-off (2% of each
    tensor's norm); the same layer in f32 is refused on the card."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(21)
    d, h, e, held, first, n, k = 2048, 1792, 32, 8, 8, 8192, 4

    def draw(*s, std=0.02):
        return torch.randn(*s, generator=gen, device=dev) * std

    # the bf16 input in both, so both route alike
    x = draw(n, d, std=1.0).to(torch.bfloat16)
    share = {"router": draw(d, e), "W13": draw(held, d, 2 * h),
             "W2": draw(held, h, d)}
    r = draw(n, d, std=1.0)
    bias = torch.zeros(e, device=dev)
    xi = x.clone().requires_grad_(True)
    ps = {name: p.clone().requires_grad_(True) for name, p in share.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, plan = moe_dispatch.sparse_moe(xi, ps["router"], bias, ps["W13"],
                                          ps["W2"], top_k=k, first=first)
        got = torch.autograd.grad((y.float() * r).sum(), [xi, *ps.values()])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    xd = x.float().requires_grad_(True)
    pd = {name: p.clone().requires_grad_(True) for name, p in share.items()}
    want = _dense_formula(pd, bias, xd, first, k)
    exp = torch.autograd.grad((want * r).sum(), [xd, *pd.values()])
    chosen = torch.topk(torch.sigmoid(x.float() @ share["router"]), k,
                        dim=-1).indices
    loads = torch.stack([(chosen == first + j).sum() for j in range(held)])
    assert torch.equal(plan.loads, loads.to(plan.loads.dtype))
    for g, w in [(y, want)] + list(zip(got, exp)):
        g = g.float()
        assert torch.isfinite(g).all()
        assert float((g - w).norm() / w.norm()) < 0.02
    with pytest.raises(ValueError, match="bf16"):
        moe_dispatch.sparse_moe(x.float(), share["router"], bias,
                                share["W13"], share["W2"], top_k=k,
                                first=first)


@pytest.mark.cuda
def test_card_grouped_products_with_an_empty_group():
    """``torch._grouped_mm`` as the dispatch calls it, with a held expert
    that got no rows: the rows' products (M grouped) and the weight
    gradients (K grouped, the empty group's exactly 0) against the plain
    version in f32, within bf16's round-off."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn(96, 64, generator=gen, device=dev)
    b = torch.randn(3, 64, 48, generator=gen, device=dev)
    g = torch.randn(96, 48, generator=gen, device=dev)
    ends = torch.tensor([40, 40, 80], device=dev)
    bf = torch.bfloat16
    for got, want in [
            (moe_dispatch.grouped_mm(a.to(bf), b.to(bf), ends)[:80],
             moe_dispatch.grouped_mm_plain(a, b, ends)[:80]),
            (moe_dispatch.grouped_mm(a.to(bf), g.to(bf), ends),
             moe_dispatch.grouped_mm_plain(a, g, ends))]:
        got = got.float()
        assert float((got - want).norm() / want.norm()) < 0.01
    wgrad = moe_dispatch.grouped_mm(a.to(bf), g.to(bf), ends)
    assert not wgrad[1].any()


@pytest.mark.cuda
def test_card_small_lfm2_step_through_the_flash_kernels(monkeypatch):
    """A small LFM2 net in mixed bf16 on the card (head dim 64, t 256, so
    the flash kernels take the repeated K/V): a training step's forward
    and backward with no host synchronisation, and its loss and gradients
    against the reference in f32 from the same weights, routed as the
    program routed (bf16 flips a few near-tied choices, which would move
    whole experts' gradients): the loss within 1%, each leaf's gradient
    within 5% of the larger of its and the median leaf's norm."""
    dev = _card()
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    types = ["conv", "full_attention", "conv", "full_attention"]
    conf = lfm2_moe_lm(V, layer_types=types, d_model=512, n_heads=8,
                       n_kv_heads=2, d_ff=768, moe_d_ff=256, n_experts=8,
                       top_k=2, experts_held=4, first_expert=4,
                       num_dense_layers=1, rope_theta=1e4,
                       dtype="mixed_bf16")
    net = ComputationGraph(conf, device=dev)
    shapes = {n: conf.vertices[n].param_shapes(dtypes.MIXED_BF16)
              for n in conf.topological_order()}
    tree = {v: {k: (1.0 + 0.2 * (p - 1.0) if k in ("gamma", "q_norm",
                                                   "k_norm") else 0.2 * p
                    ).to(dev) for k, p in ps.items()}
            for v, ps in _tree(shapes, 3).items()}
    net.set_params(_clone(tree))
    ids = torch.as_tensor(np.random.default_rng(4).integers(0, V, (2, 257)),
                          device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    routes = []
    route = moe_dispatch.route

    def keep(*args, **kwargs):
        chosen, w = route(*args, **kwargs)
        routes.append(chosen.view(2, 256, -1))
        return chosen, w

    monkeypatch.setattr(moe_dispatch, "route", keep)
    launches = fa.FLASH_FWD.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, grads = net._loss_and_grads([x], [y], None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fa.FLASH_FWD.launches - launches == 2
    cfg = dict(_cfg(4, 4), hidden_size=512, num_attention_heads=8,
               num_key_value_heads=2, layer_types=types,
               num_hidden_layers=4, num_dense_layers=1)
    params = _clone(tree)
    leaves = [(v, k, p.requires_grad_(True)) for v, ps in params.items()
              for k, p in ps.items()]
    logits, _ = ref.logits(params, x, cfg, F32, ref.zero_biases(cfg, dev),
                           dict(zip(ref.moe_vertices(cfg), routes)))
    want = ref.summed_loss(logits, y) / 2
    gs = torch.autograd.grad(want, [p for _, _, p in leaves])
    assert float(loss) == pytest.approx(float(want.detach()), rel=0.01)
    norm = [float(g.norm()) for g in gs]
    med = sorted(norm)[len(norm) // 2]
    for (v, k, _), g, gn in zip(leaves, gs, norm):
        diff = float((grads[v][k].float() - g).norm()) / max(gn, med)
        assert diff < 0.05, f"{v}.{k}: {diff}"
