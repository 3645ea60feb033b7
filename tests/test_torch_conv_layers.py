"""The port's convolutional and normalisation ops against the JAX package's,
on the CPU: ``ops/convops.py`` (conv, the four poolings, LRN),
SpaceToDepth, GlobalPooling and ``ops/batchnorm.py`` (the training BN with
its hand-written backward, and the inference BN), forward and gradients,
in f32 and f64, plus the dropout of ``ops/common.py``.

Inputs are made from a seed with numpy; each case runs the same arrays
through the reference function (its gradients by ``jax.vjp`` with a
random cotangent) and the port's (torch autograd with the same
cotangent). Tolerances are relative to the largest magnitude compared:
f32 2e-5 (the same sums in another order: cuDNN-style and XLA
convolutions accumulate differently), f64 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.ops import batchnorm as jbn
from deeplearning4j_tpu.ops import convops as jconv

from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.ops import batchnorm as tbn
from deeplearning4j_tpu_torch.ops import common as tcommon
from deeplearning4j_tpu_torch.ops import convops as tconv

TOL = {np.float32: 2e-5, np.float64: 1e-10}
DTYPES = [np.float32, np.float64]


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def _vjp_pair(jfn, tfn, arrays, dtype, seed=0):
    """Forward and gradients of ``jfn``/``tfn`` over the same arrays, with
    one random cotangent."""
    jout, pull = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    ct = np.random.default_rng(seed).normal(size=jout.shape).astype(dtype)
    jgrads = pull(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*ts)
    tgrads = torch.autograd.grad(tout, ts, torch.from_numpy(ct))
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jgrads], [g.numpy() for g in tgrads])


def _check_vjp(jfn, tfn, arrays, dtype, what):
    jout, tout, jg, tg = _vjp_pair(jfn, tfn, arrays, dtype)
    _close(tout, jout, TOL[dtype], f"{what} forward")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, TOL[dtype], f"{what} grad {i}")


CONV_CASES = [
    # (hw, kernel, stride, padding, dilation, groups)
    ((7, 9), (3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((8, 8), (3, 2), (2, 2), (2, 0), (1, 1), 1),
    ((7, 9), (3, 3), (1, 1), "same", (1, 1), 1),
    ((8, 8), (3, 3), (2, 2), "same", (1, 1), 1),     # pads (0, 1)
    ((9, 9), (7, 7), (2, 2), "same", (1, 1), 1),     # pads (2, 3)
    ((7, 9), (3, 3), (2, 2), "valid", (1, 1), 1),
    ((9, 9), (3, 3), (1, 1), "same", (2, 2), 1),
    ((8, 8), (3, 3), (1, 1), (2, 2), (2, 2), 1),
    ((6, 6), (3, 3), (1, 1), "same", (1, 1), 2),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: str(c))
def test_conv2d_matches_reference(case, dtype):
    hw, kernel, stride, padding, dilation, groups = case
    rng = np.random.default_rng(1)
    cin, cout = 4, 6
    x = rng.normal(size=(2, *hw, cin)).astype(dtype)
    w = rng.normal(size=(*kernel, cin // groups, cout)).astype(dtype)
    _check_vjp(
        lambda a, b: jconv.conv2d(a, b, stride, padding, dilation, groups),
        lambda a, b: tconv.conv2d(a, b, stride, padding, dilation, groups),
        [x, w], dtype, f"conv {case}")


@pytest.mark.parametrize("padding,hw,expect", [
    ("same", (56, 56), ((0, 1), (0, 1))),
    ("same", (224, 224), ((2, 3), (2, 3))),
    ("valid", (56, 56), ((0, 0), (0, 0))),
    ((1, 2), (10, 10), ((1, 1), (2, 2))),
])
def test_same_padding_is_xla_not_symmetric(padding, hw, expect):
    kernel, stride = ((3, 3), (2, 2)) if hw == (56, 56) else ((7, 7), (2, 2))
    assert tconv.pad_pairs(padding, hw, kernel, stride) == expect


def test_output_size_helpers_match_reference():
    for args in [(28, 5, 1, 0), (224, 7, 2, 3), (56, 3, 2, 1, 2), (9, 3, 1, 1)]:
        assert tconv.conv_output_size(*args) == jconv.conv_output_size(*args)
    for args in [(56, 3, 2), (224, 7, 2), (7, 3, 1), (8, 1, 2)]:
        assert tconv.same_pad(*args) == jconv.same_pad(*args)


POOL_CASES = [
    # (hw, kernel, stride, padding)
    ((8, 8), (2, 2), (2, 2), (0, 0)),
    ((7, 9), (3, 3), (2, 2), "same"),
    ((8, 8), (3, 3), (2, 2), "same"),               # pads (0, 1)
    ((7, 7), (3, 3), (2, 2), "valid"),
    ((6, 6), (3, 3), (1, 1), (1, 1)),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: str(c))
def test_pool2d_matches_reference(case, kind, dtype):
    hw, kernel, stride, padding = case
    x = np.random.default_rng(2).normal(size=(2, *hw, 3)).astype(dtype)
    _check_vjp(lambda a: jconv.pool2d(a, kind, kernel, stride, padding, 3),
               lambda a: tconv.pool2d(a, kind, kernel, stride, padding, 3),
               [x], dtype, f"{kind} pool {case}")


def test_max_pool_pads_with_minus_inf():
    """A SAME max pool over all-negative inputs: a zero-padded border
    would return 0."""
    x = -1.0 - np.random.default_rng(3).random((1, 8, 8, 2)).astype(np.float32)
    out = tconv.pool2d(torch.from_numpy(x), "max", (3, 3), (2, 2), "same")
    assert float(out.max()) < 0.0
    _close(out.numpy(), np.asarray(jconv.pool2d(
        jnp.asarray(x), "max", (3, 3), (2, 2), "same")), 0.0, "max pool")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [5, 4, 3])
def test_lrn_matches_reference(n, dtype):
    x = np.random.default_rng(4).normal(size=(2, 3, 3, 7)).astype(dtype)
    _check_vjp(lambda a: jconv.lrn(a, 2.0, n, 1e-2, 0.75),
               lambda a: tconv.lrn(a, 2.0, n, 1e-2, 0.75), [x], dtype,
               f"lrn n={n}")


def test_lrn_is_not_torch_local_response_norm():
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 2, 2, 6)).astype(np.float32))
    ours = tconv.lrn(x, 2.0, 5, 1.0, 0.75)
    theirs = torch.nn.functional.local_response_norm(
        x.permute(0, 3, 1, 2), 5, 1.0, 0.75, 2.0).permute(0, 2, 3, 1)
    assert not torch.allclose(ours, theirs)


def test_space_to_depth_channel_order_matches_reference():
    x = np.random.default_rng(6).normal(size=(2, 8, 6, 3)).astype(np.float32)
    want, _ = jlayers.SpaceToDepthLayer(block_size=2).apply({}, jnp.asarray(x))
    got, _ = tlayers.SpaceToDepthLayer(block_size=2).apply(
        {}, torch.from_numpy(x))
    assert got.shape == (2, 4, 3, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["avg", "max", "sum", "pnorm"])
@pytest.mark.parametrize("masked", [False, True])
def test_global_pooling_matches_reference(kind, masked):
    rng = np.random.default_rng(7)
    layer_j = jlayers.GlobalPoolingLayer(pooling_type=kind, pnorm=3)
    layer_t = tlayers.GlobalPoolingLayer(pooling_type=kind, pnorm=3)
    x4 = rng.normal(size=(2, 3, 4, 5))
    want, _ = layer_j.apply({}, jnp.asarray(x4))
    got, _ = layer_t.apply({}, torch.from_numpy(x4))
    _close(got.numpy(), np.asarray(want), 1e-12, f"{kind} NHWC")
    x3 = rng.normal(size=(3, 6, 4))
    mask = None
    if masked:
        mask = np.ones((3, 6))
        mask[1, 4:] = 0
        mask[2, 1:] = 0
    want, _ = layer_j.apply({}, jnp.asarray(x3),
                            mask=None if mask is None else jnp.asarray(mask))
    got, _ = layer_t.apply({}, torch.from_numpy(x3),
                           mask=None if mask is None else torch.from_numpy(mask))
    _close(got.numpy(), np.asarray(want), 1e-12, f"{kind} [b, t, f]")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(6, 5), (4, 3, 5, 6)])
def test_batch_norm_train_matches_reference_vjp(shape, dtype):
    """Forward, batch statistics and the hand-written backward (dx, dγ,
    dβ) against the reference's custom VJP."""
    rng = np.random.default_rng(8)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 1).astype(dtype)
    gamma = rng.normal(size=(c,)).astype(dtype)
    beta = rng.normal(size=(c,)).astype(dtype)
    _check_vjp(lambda a, g, b: jbn.batch_norm_train(a, g, b, 1e-5)[0],
               lambda a, g, b: tbn.batch_norm_train(a, g, b, 1e-5)[0],
               [x, gamma, beta], dtype, f"bn {shape}")
    _, jm, jv = jbn.batch_norm_train(jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta), 1e-5)
    _, tm, tv = tbn.batch_norm_train(torch.from_numpy(x),
                                     torch.from_numpy(gamma),
                                     torch.from_numpy(beta), 1e-5)
    _close(tm.numpy(), np.asarray(jm), TOL[dtype], "batch mean")
    _close(tv.numpy(), np.asarray(jv), TOL[dtype], "batch variance (biased)")
    assert not tm.requires_grad and not tv.requires_grad


def test_batch_norm_backward_is_the_hand_written_one():
    """The custom backward equals autograd of the plain formulation (f64),
    and differs from a planted fault (dβ term dropped)."""
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(5, 2, 2, 3)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(3,)), requires_grad=True)
    b = torch.tensor(rng.normal(size=(3,)), requires_grad=True)
    ct = torch.from_numpy(rng.normal(size=(5, 2, 2, 3)))
    got = torch.autograd.grad(tbn.batch_norm_train(x, g, b, 1e-5)[0],
                              (x, g, b), ct)
    mean = x.mean(dim=(0, 1, 2))
    var = ((x - mean) ** 2).mean(dim=(0, 1, 2))
    plain = (x - mean) / torch.sqrt(var + 1e-5) * g + b
    want = torch.autograd.grad(plain, (x, g, b), ct)
    for a, w in zip(got, want):
        _close(a.numpy(), w.numpy(), 1e-10, "bn backward")


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_norm_inference_matches_reference(dtype):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 4, 4, 5)).astype(dtype)
    g, b, m = (rng.normal(size=(5,)).astype(dtype) for _ in range(3))
    v = rng.random(5).astype(dtype) + 0.5
    want = jbn.batch_norm_inference(*(jnp.asarray(a) for a in (x, g, b, m, v)),
                                    1e-5)
    got = tbn.batch_norm_inference(*(torch.from_numpy(a)
                                     for a in (x, g, b, m, v)), 1e-5)
    _close(got.numpy(), np.asarray(want), TOL[dtype], "bn inference")


def test_batch_norm_layer_bf16_and_running_update_match_reference():
    """The layer under mixed_bf16: bf16 activations normalised in bf16
    (within one bf16 step of the largest output), f32 running statistics
    updated as decay·old + (1 − decay)·batch."""
    from deeplearning4j_tpu import dtypes as jdt
    from deeplearning4j_tpu_torch import dtypes as tdt
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(8, 4, 4, 6)) * 3 + 2).astype(np.float32)
    lj = jlayers.BatchNormalization(n_out=6, decay=0.9)
    lt = tlayers.BatchNormalization(n_out=6, decay=0.9)
    params = {"gamma": rng.normal(size=(6,)).astype(np.float32),
              "beta": rng.normal(size=(6,)).astype(np.float32)}
    state = {"mean": rng.normal(size=(6,)).astype(np.float32),
             "var": rng.random(6).astype(np.float32) + 0.5}
    jy, jst = lj.apply({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x, jnp.bfloat16), train=True,
                       state={k: jnp.asarray(v) for k, v in state.items()},
                       policy=jdt.policy_from_name("mixed_bf16"))
    ty, tst = lt.apply({k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x).to(torch.bfloat16), train=True,
                       state={k: torch.from_numpy(v) for k, v in state.items()},
                       policy=tdt.policy_from_name("mixed_bf16"))
    assert ty.dtype == torch.bfloat16 and tst["mean"].dtype == torch.float32
    want = np.asarray(jy.astype(jnp.float32))
    bf16_step = float(np.abs(want).max()) * 2.0 ** -7
    assert float(np.abs(ty.float().numpy() - want).max()) <= bf16_step
    for k in ("mean", "var"):
        _close(tst[k].numpy(), np.asarray(jst[k]), 1e-6, k)
    # eval mode reads the running statistics and leaves them unchanged
    _, st_eval = lt.apply({k: torch.from_numpy(v) for k, v in params.items()},
                          torch.from_numpy(x), train=False, state=tst)
    assert st_eval is tst


def test_dropout_semantics():
    """``dropout`` is the DROP probability; kept entries are scaled by
    1/(1 − rate); the same generator seed gives the same mask; eval mode
    and rate 0 pass the input through."""
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(3)
    y = tcommon.apply_dropout(gen, x, 0.3, train=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    y2 = tcommon.apply_dropout(torch.Generator().manual_seed(3), x, 0.3, True)
    assert torch.equal(y, y2)
    assert tcommon.apply_dropout(gen, x, 0.3, train=False) is x
    assert tcommon.apply_dropout(gen, x, 0.0, train=True) is x
    assert tcommon.apply_dropout(None, x, 0.3, train=True) is x
