"""The gated short convolution (``ops/short_conv.py``): its plain passes on
the CPU and its two hand-written CUDA kernels (``ops/csrc/short_conv.cu``)
on the card.

On the CPU: the autograd function takes the plain passes, bitwise
:func:`gated_short_conv_plain` and :func:`backward_plain`, which agree with
a step-by-step loop of the formula in f64 (1e-12 of each tensor's largest
magnitude: only the sums' order differs); a CPU input never loads the
library or launches a kernel, and its backward keeps a graph (a double
backward differentiates it); the kernels' rule of shapes, dtypes and
layouts (``shape_refusal``, which holds on any device); the layer's
``shortconv_calls_total{model, path}``; the wrapper's tile and filter
limit equal the source's.

On the card (``-m cuda``; skipped without a card; this file imports no
JAX, so it runs there with ``python -m pytest --noconftest -m cuda
tests/test_torch_short_conv.py``): the kernels against the plain passes
at LFM2-8B-A1B's shape ``[1, 8192, 3·2048]`` with L = 3 and at ragged
shapes, in bf16 and f32; two backward runs bitwise equal; causality; the
launch counts; the wrapper raising on what it does not take; a double
backward through the kernels raising.

Tolerances on the card. Both sides compute in f32 from the same inputs
and round once, so they differ only by the order of f32 operations (the
kernel's fused multiply-adds; the filter gradient's sum over steps taken
per tile, then over tiles): y, dB, dC and dx within 1e-5 of the tensor's
largest magnitude, and in bf16 one bf16 step more (2⁻⁷ of the value: a
few f32 ulps can move a rounding by one step); dw within 1e-4 of its
largest magnitude (a sum of up to 16,384 products in another order).
"""

import re
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch.nn.conf.hybrid import GatedShortConvLayer
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops import _nvcc
from deeplearning4j_tpu_torch.ops import short_conv as sc
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry


def _inputs(b, t, c, length, dtype, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    bcx = torch.randn(b, t, 3 * c, generator=gen).to(device, dtype)
    w = (0.5 * torch.randn(c, length, generator=gen)).to(device)
    gy = torch.randn(b, t, c, generator=gen).to(device, dtype)
    return bcx, w, gy


def _loop(bcx, w, gy):
    """The formula step by step in f64: y, the bcx gradient, dw."""
    bcx, w, gy = bcx.double(), w.double(), gy.double()
    c, length = w.shape
    bb, cc, xx = bcx[..., :c], bcx[..., c:2 * c], bcx[..., 2 * c:]
    t = bcx.shape[1]
    u = bb * xx
    z = torch.zeros_like(u)
    for s in range(t):
        for j in range(length):
            r = s - (length - 1) + j
            if r >= 0:
                z[:, s] += w[:, j] * u[:, r]
    y = cc * z
    gz = gy * cc
    gu = torch.zeros_like(u)
    dw = torch.zeros_like(w)
    for s in range(t):
        for j in range(length):
            r = s + length - 1 - j
            if r < t:
                gu[:, s] += w[:, j] * gz[:, r]
            p = s - (length - 1) + j
            if p >= 0:
                dw[:, j] += (gz[:, s] * u[:, p]).sum(0)
    return y, torch.cat([gu * xx, gy * z, gu * bb], dim=-1), dw


def _close(got, want, tol):
    scale = float(want.abs().max()) + 1e-30
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * scale, f"{err} of {scale}"


# --------------------------------------------------------------------------
# the CPU: the plain passes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 2, 3, 4])
@pytest.mark.parametrize("b, t, c", [(1, 7, 5), (2, 33, 8)])
def test_plain_passes_equal_the_formula_step_by_step(b, t, c, length):
    bcx, w, gy = _inputs(b, t, c, length, torch.float64, seed=length)
    w = w.double()     # dw comes out in w's dtype
    y, gbcx, dw = _loop(bcx, w, gy)
    _close(sc.gated_short_conv_plain(bcx, w), y, 1e-12)
    got_bcx, got_w = sc.backward_plain(bcx, w, gy)
    _close(got_bcx, gbcx, 1e-12)
    _close(got_w, dw, 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cpu_autograd_is_the_plain_passes_bitwise(dtype):
    """Forward and backward of ``gated_short_conv`` on the CPU: bitwise
    what the plain functions give, in ``bcx``'s and ``w``'s dtypes."""
    bcx, w, gy = _inputs(2, 19, 6, 3, dtype, seed=3)
    x = bcx.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    y = sc.gated_short_conv(x, wg)
    y.backward(gy)
    assert y.dtype == dtype and x.grad.dtype == dtype
    assert wg.grad.dtype == torch.float32
    assert torch.equal(y, sc.gated_short_conv_plain(bcx, w))
    want_bcx, want_w = sc.backward_plain(bcx, w, gy)
    assert torch.equal(x.grad, want_bcx)
    assert torch.equal(wg.grad, want_w)


def test_a_cpu_input_never_touches_the_library(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the library was reached from a CPU input")

    monkeypatch.setattr(_nvcc, "build_all", refuse)
    for k in (sc.SHORTCONV_FWD, sc.SHORTCONV_BWD):
        monkeypatch.setattr(k, "fn", refuse)
    before = (sc.SHORTCONV_FWD.launches, sc.SHORTCONV_BWD.launches)
    bcx, w, gy = _inputs(1, 40, 8, 3, torch.bfloat16)
    x = bcx.requires_grad_(True)
    sc.gated_short_conv(x, w.requires_grad_(True)).backward(gy)
    assert (sc.SHORTCONV_FWD.launches, sc.SHORTCONV_BWD.launches) == before
    assert sc.refusal(bcx, w, gy) == "bcx is on cpu, not a CUDA device"
    with pytest.raises(ValueError, match="not a CUDA device"):
        sc.short_conv_fwd_cuda(bcx, w)
    with pytest.raises(ValueError, match="not a CUDA device"):
        sc.short_conv_bwd_cuda(bcx, w, gy)


def _bad(case):
    bcx, w, gy = _inputs(2, 5, 4, 3, torch.float32)
    if case == "f16":
        bcx = bcx.half()
    elif case == "f64":
        bcx = bcx.double()
    elif case == "two_dims":
        bcx = bcx[0]
    elif case == "not_thirds":
        bcx = bcx[..., :11].contiguous()
    elif case == "strided":
        bcx = bcx.transpose(0, 1)
    elif case == "w_width":
        w = w[:3]
    elif case == "no_taps":
        w = w[:, :0]
    elif case == "nine_taps":
        w = torch.zeros(4, 9)
    elif case == "w_ints":
        w = w.int()
    elif case == "dy_dtype":
        return bcx, w, gy.bfloat16()
    elif case == "dy_shape":
        return bcx, w, gy[:, :4]
    elif case == "dy_strided":
        return bcx, w, torch.randn(2, 4, 5).transpose(1, 2)
    return bcx, w, None


BAD = ["f16", "f64", "two_dims", "not_thirds", "strided", "w_width",
       "no_taps", "nine_taps", "w_ints", "dy_dtype", "dy_shape",
       "dy_strided"]


@pytest.mark.parametrize("case", BAD)
def test_the_kernels_refuse_what_they_do_not_take(case):
    bcx, w, gy = _bad(case)
    assert sc.shape_refusal(bcx, w, gy) is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 8])
def test_the_kernels_take_bf16_and_f32_and_one_to_eight_taps(
        dtype, length):
    bcx, w, gy = _inputs(3, 1, 5, length, dtype)
    assert sc.shape_refusal(bcx, w) is None
    assert sc.shape_refusal(bcx, w.bfloat16(), gy) is None


def test_the_cpu_backward_keeps_its_graph():
    """The plain passes' backward is plain ops: a double backward
    differentiates through it."""
    bcx, w, gy = _inputs(1, 9, 4, 3, torch.float64, seed=4)
    x = bcx.requires_grad_(True)
    wg = w.double().requires_grad_(True)
    y = sc.gated_short_conv(x, wg)
    gx, = torch.autograd.grad(y, x, gy, create_graph=True)
    assert gx.grad_fn is not None
    gx.sum().backward()
    assert wg.grad is not None and bool(wg.grad.abs().sum() > 0)


def test_the_wrapper_mirrors_the_source():
    src = (Path(sc.__file__).parent / "csrc" / "short_conv.cu").read_text()
    assert int(re.search(r"#define SHORT_CONV_TILE (\d+)", src)[1]) == sc.TILE
    assert int(re.search(r"#define SHORT_CONV_MAX_L (\d+)", src)[1]) \
        == sc.MAX_L


def test_the_layer_counts_its_calls_by_path(monkeypatch):
    registry = MetricsRegistry()
    monkeypatch.setattr("deeplearning4j_tpu_torch.util.metrics.REGISTRY",
                        registry)
    layer = GatedShortConvLayer(n_in=8, conv_l=3, name="blk0_conv")
    layer.set_n_in(InputType.recurrent(8))
    params = {k: torch.randn(s) for k, s in layer.param_shapes().items()}
    for _ in range(3):
        layer.apply(params, torch.randn(2, 5, 8))
    counter = sc.shortconv_counter(registry)
    assert counter.value(model="blk0_conv", path="plain") == 3
    assert counter.value(model="blk0_conv", path="kernel") == 0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tol(dtype):
    """(relative to the value, relative to the tensor's largest
    magnitude): one bf16 step for bf16 outputs, and f32 reordering."""
    return (2.0 ** -7 if dtype == torch.bfloat16 else 0.0), 1e-5


def _agree(got, want, dtype):
    rel, scaled = _tol(dtype)
    got, want = got.double(), want.double()
    bound = rel * want.abs() + scaled * float(want.abs().max())
    worst = float(((got - want).abs() - bound).max())
    assert got.dtype == want.dtype and worst <= 0, worst


def _kernel_and_plain(bcx, w, gy):
    dtype = bcx.dtype
    y = sc.short_conv_fwd_cuda(bcx, w)
    gbcx, dw = sc.short_conv_bwd_cuda(bcx, w, gy)
    torch.cuda.synchronize()
    assert y.dtype == dtype and gbcx.dtype == dtype and dw.dtype == w.dtype
    _agree(y, sc.gated_short_conv_plain(bcx, w), dtype)
    want_bcx, want_w = sc.backward_plain(bcx, w, gy)
    c = w.shape[0]
    for part in range(3):   # dB, dC, dx
        cut = slice(part * c, (part + 1) * c)
        _agree(gbcx[..., cut], want_bcx[..., cut], dtype)
    _close(dw, want_w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_kernels_equal_the_plain_passes_at_lfm2s_shape(dtype):
    dev = _card()
    _kernel_and_plain(*_inputs(1, 8192, 2048, 3, dtype, dev, seed=11))


RAGGED = [(2, 45, 24, 3), (2, 45, 13, 2), (1, 33, 2048, 4), (3, 1, 9, 3),
          (2, 2, 16, 4), (1, 100, 7, 2), (2, 64, 40, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b, t, c, length", RAGGED)
def test_card_kernels_equal_the_plain_passes_at_ragged_shapes(
        dtype, b, t, c, length):
    dev = _card()
    _kernel_and_plain(*_inputs(b, t, c, length, dtype, dev, seed=t + c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_unaligned_inputs_take_the_scalar_path(dtype):
    """A contiguous bcx and dy that start off a 16-byte boundary."""
    dev = _card()
    b, t, c = 2, 37, 16
    bcx, w, gy = _inputs(b, t, c, 3, dtype, dev, seed=5)
    bcx = torch.cat([bcx.new_zeros(1), bcx.flatten()])[1:].view(b, t, 3 * c)
    gy = torch.cat([gy.new_zeros(1), gy.flatten()])[1:].view(b, t, c)
    assert bcx.data_ptr() % 16 and gy.data_ptr() % 16
    _kernel_and_plain(bcx, w, gy)


@pytest.mark.cuda
def test_card_two_backward_runs_are_bitwise_equal():
    dev = _card()
    bcx, w, gy = _inputs(1, 8192, 2048, 3, torch.bfloat16, dev, seed=12)
    first = sc.short_conv_bwd_cuda(bcx, w, gy)
    second = sc.short_conv_bwd_cuda(bcx, w, gy)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_forward_is_causal(dtype):
    dev = _card()
    bcx, w, _ = _inputs(2, 100, 24, 4, dtype, dev, seed=7)
    y = sc.short_conv_fwd_cuda(bcx, w)
    for t0 in (0, 31, 32, 63, 98):
        other = bcx.clone()
        other[:, t0 + 1:] = torch.randn_like(other[:, t0 + 1:])
        y2 = sc.short_conv_fwd_cuda(other, w)
        assert torch.equal(y2[:, :t0 + 1], y[:, :t0 + 1])
        assert not torch.equal(y2[:, t0 + 1:], y[:, t0 + 1:])


@pytest.mark.cuda
def test_card_autograd_launches_one_forward_and_one_backward_a_call():
    dev = _card()
    bcx, w, gy = _inputs(1, 256, 64, 3, torch.bfloat16, dev, seed=8)
    x = bcx.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    fwd, bwd = sc.SHORTCONV_FWD.launches, sc.SHORTCONV_BWD.launches
    y = sc.gated_short_conv(x, wg)
    assert (sc.SHORTCONV_FWD.launches - fwd,
            sc.SHORTCONV_BWD.launches - bwd) == (1, 0)
    y.backward(gy)
    assert (sc.SHORTCONV_FWD.launches - fwd,
            sc.SHORTCONV_BWD.launches - bwd) == (1, 1)
    _agree(y.detach(), sc.gated_short_conv_plain(bcx, w), torch.bfloat16)
    want_bcx, want_w = sc.backward_plain(bcx, w, gy)
    for part in range(3):
        cut = slice(part * 64, (part + 1) * 64)
        _agree(x.grad[..., cut], want_bcx[..., cut], torch.bfloat16)
    _close(wg.grad, want_w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f16", "f64", "strided", "nine_taps",
                                  "dy_dtype", "dy_strided", "w_on_cpu"])
def test_card_wrapper_raises_and_never_falls_back(case):
    dev = _card()
    if case == "w_on_cpu":
        bcx, w, gy = _inputs(2, 5, 4, 3, torch.float32, dev)
        w = w.cpu()
    else:
        bcx, w, gy = (None if v is None else v.to(dev) for v in _bad(case))
    launches = (sc.SHORTCONV_FWD.launches, sc.SHORTCONV_BWD.launches)
    with pytest.raises(ValueError, match="do not take"):
        if gy is None:
            sc.gated_short_conv(bcx, w)
        else:
            sc.short_conv_bwd_cuda(bcx, w, gy)
    assert (sc.SHORTCONV_FWD.launches, sc.SHORTCONV_BWD.launches) \
        == launches


@pytest.mark.cuda
def test_card_double_backward_raises():
    """The kernels' gradients carry no graph, so a second-order gradient
    through them raises rather than read zero."""
    dev = _card()
    bcx, w, gy = _inputs(1, 40, 16, 3, torch.float32, dev, seed=9)
    x = bcx.requires_grad_(True)
    y = sc.gated_short_conv(x, w.requires_grad_(True))
    gx, = torch.autograd.grad(y, x, gy.requires_grad_(True),
                              create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()
