"""The gated short convolution of a hybrid conv/attention LM (Liquid AI's
LFM2): between the block's two projections, for ``B, C, x`` the three
thirds of the input projection,

    u = B ⊙ x,   z[t] = Σ_j w[:, j] · u[t − (L − 1) + j],   y = C ⊙ z

a causal depthwise convolution of length ``L`` (one filter a channel,
``u`` left-padded by ``L − 1`` zeros), gated on both sides.

One autograd function under the ``shortconv`` phase; it saves the
projection's output and the filters only and forms ``u`` and ``z`` again
in the backward, in at least f32. What runs where:

* on the card, two hand-written CUDA kernels (``csrc/short_conv.cu``):
  :func:`short_conv_fwd_cuda` reads B, C and x once and writes y, and
  :func:`short_conv_bwd_cuda` reads dy, B, C and x once and writes dB, dC
  and dx into one ``[b, t, 3c]`` buffer, the filters' gradient summed per
  block and then over the blocks in a fixed order (bitwise repeatable).
  They take bf16 and f32 ``bcx``, any ``b``, ``t`` and ``c``, and ``1 ≤ L
  ≤`` :data:`MAX_L`; on a CUDA tensor they launch or raise, with no
  fallback. Each launch runs under a profiler op (``shortconv_fwd``,
  ``shortconv_bwd``) so that a trace links the ctypes launch to the phase.
  Their backward has no graph of its own: a double backward raises.
* on the CPU, the plain PyTorch passes (:func:`gated_short_conv_plain`
  and :func:`backward_plain`), f32 arithmetic rounded once as the kernels
  do: the CPU path and the yardstick the kernels are held to on the card.

Each forward counts ``shortconv_calls_total{model, path}`` by the path it
took: ``kernel`` once the forward kernel has launched, ``plain`` once the
plain passes have run.

It replaces no TPU kernel: the JAX package has no such layer. Its bound
is bytes, 11 values a token and channel: B, C and x read and y written
forward; dy, B, C and x read and dB, dC and dx written backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from ..util import metrics as _metrics
from ..util import tracing as _tracing
from . import _nvcc

SHORTCONV_FWD = _nvcc.kernel("shortconv_fwd", "short_conv")
SHORTCONV_BWD = _nvcc.kernel("shortconv_bwd", "short_conv")
MAX_L = 8           # filter lengths the kernels take (csrc SHORT_CONV_MAX_L)
TILE = 32           # steps a block walks (csrc SHORT_CONV_TILE)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P]


def _conv(u: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of ``u [b, t, c]`` by the taps ``wt [L, c]``
    (``wt[L − 1]`` weighs the current step)."""
    length, t = wt.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, length - 1, 0))
    z = up[:, 0:t] * wt[0]
    for j in range(1, length):
        z = torch.addcmul(z, up[:, j:j + t], wt[j])
    return z


def _conv_t(g: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`_conv` in ``u``: ``Σ_j wt[j] · g[t + L − 1
    − j]``, zero past the end."""
    length, t = wt.shape[0], g.shape[1]
    gp = F.pad(g, (0, 0, 0, length - 1))
    out = gp[:, length - 1:length - 1 + t] * wt[0]
    for j in range(1, length):
        s = length - 1 - j
        out = torch.addcmul(out, gp[:, s:s + t], wt[j])
    return out


def gated_short_conv_plain(bcx: torch.Tensor, w: torch.Tensor
                           ) -> torch.Tensor:
    """``C ⊙ conv(B ⊙ x)`` for ``bcx = [B | C | x]`` ``[b, t, 3c]`` and
    filters ``w [c, L]``, in at least f32, returned in ``bcx``'s dtype."""
    ct = torch.promote_types(bcx.dtype, torch.float32)
    b, c, x = bcx.to(ct).chunk(3, dim=-1)
    return (c * _conv(b * x, w.to(ct).t().contiguous())).to(bcx.dtype)


def backward_plain(bcx: torch.Tensor, w: torch.Tensor, gy: torch.Tensor):
    """The gradients of :func:`gated_short_conv_plain` in ``bcx`` and
    ``w`` from ``gy``, in at least f32, returned in their dtypes."""
    ct = torch.promote_types(bcx.dtype, torch.float32)
    b, c, x = bcx.to(ct).chunk(3, dim=-1)
    wt = w.to(ct).t().contiguous()
    u = b * x
    gy = gy.to(ct)
    gz = gy * c
    gc = gy * _conv(u, wt)
    gu = _conv_t(gz, wt)
    length, t = w.shape[1], u.shape[1]
    up = F.pad(u, (0, 0, length - 1, 0))
    gw = torch.stack([(gz * up[:, j:j + t]).sum((0, 1))
                      for j in range(length)], dim=1)
    gbcx = torch.cat([gu * x, gc, gu * b], dim=-1)
    return gbcx.to(bcx.dtype), gw.to(w.dtype)


def refusal(bcx: torch.Tensor, w: torch.Tensor,
            gy: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why the kernels do not take these tensors, or None where they do:
    ``bcx`` a CUDA tensor, ``w`` and ``gy`` (the backward's) on its device,
    and their shapes, dtypes and layouts as :func:`shape_refusal` takes
    them. A pure rule of what the tensors show."""
    if not bcx.is_cuda:
        return f"bcx is on {bcx.device}, not a CUDA device"
    for name, v in (("w", w), ("dy", gy)):
        if v is not None and v.device != bcx.device:
            return f"{name} is on {v.device}, bcx on {bcx.device}"
    return shape_refusal(bcx, w, gy)


def shape_refusal(bcx: torch.Tensor, w: torch.Tensor,
                  gy: Optional[torch.Tensor] = None) -> Optional[str]:
    """The part of :func:`refusal` that holds on any device: ``bcx`` a
    contiguous bf16 or f32 ``[b, t, 3c]`` tensor, ``w`` a float ``[c, L]``
    tensor with ``1 ≤ L ≤`` :data:`MAX_L`, and ``gy`` a contiguous ``[b, t,
    c]`` tensor of ``bcx``'s dtype."""
    if bcx.dtype not in _DTYPES:
        return f"bcx is {bcx.dtype}; the kernels take bf16 and f32"
    if bcx.dim() != 3 or bcx.shape[-1] % 3:
        return f"bcx has shape {tuple(bcx.shape)}, not [b, t, 3c]"
    if not bcx.is_contiguous():
        return "bcx is not contiguous"
    c = bcx.shape[-1] // 3
    if (w.dim() != 2 or w.shape[0] != c or not 1 <= w.shape[1] <= MAX_L
            or not w.is_floating_point()):
        return (f"w is {w.dtype} {tuple(w.shape)}; the kernels take float "
                f"[{c}, L] with 1 <= L <= {MAX_L}")
    if gy is not None and (gy.shape != (*bcx.shape[:2], c)
                           or gy.dtype != bcx.dtype
                           or not gy.is_contiguous()):
        return (f"dy is {gy.dtype} {tuple(gy.shape)}"
                f"{'' if gy.is_contiguous() else ', not contiguous'}; "
                f"the kernel takes a contiguous {bcx.dtype} "
                f"{(*bcx.shape[:2], c)}")
    return None


def _check(bcx, w, gy=None) -> None:
    why = refusal(bcx, w, gy)
    if why is not None:
        raise ValueError(f"the short conv kernels do not take this call: "
                         f"{why}")


def _launched(kernel: _nvcc.CudaKernel, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: CUDA error "
                           f"{err}")
    kernel.launches += 1


def _taps(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.float32).contiguous()


def short_conv_fwd_cuda(bcx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y ``[b, t, c]`` in ``bcx``'s dtype by the forward kernel, on
    PyTorch's current stream. Raises on what the kernel does not take."""
    _check(bcx, w)
    b, t, c3 = bcx.shape
    y = torch.empty((b, t, c3 // 3), dtype=bcx.dtype, device=bcx.device)
    wf = _taps(w)
    stream = torch.cuda.current_stream(bcx.device).cuda_stream
    # a profiler op (not a user range), so that a trace links the kernel to
    # it and to the ``shortconv`` phase around it
    with torch._C._profiler._RecordFunctionFast("shortconv_fwd"):
        _launched(SHORTCONV_FWD, SHORTCONV_FWD.fn(_FWD_ARGS)(
            bcx.data_ptr(), wf.data_ptr(), y.data_ptr(), b, t, c3 // 3,
            w.shape[1], _DTYPES[bcx.dtype], stream))
    return y


def short_conv_bwd_cuda(bcx: torch.Tensor, w: torch.Tensor,
                        gy: torch.Tensor):
    """(dbcx ``[b, t, 3c]`` in ``bcx``'s dtype, dw in ``w``'s dtype) by
    the backward kernel and its fixed-order sum of the blocks' filter
    sums, on PyTorch's current stream. Raises on what it does not take."""
    _check(bcx, w, gy)
    b, t, c3 = bcx.shape
    c, length = c3 // 3, w.shape[1]
    grad = torch.empty_like(bcx)
    parts = b * -(-t // TILE)
    partials = torch.empty((parts, c, length), dtype=torch.float32,
                           device=bcx.device)
    dw = torch.empty((c, length), dtype=torch.float32, device=bcx.device)
    wf = _taps(w)
    stream = torch.cuda.current_stream(bcx.device).cuda_stream
    with torch._C._profiler._RecordFunctionFast("shortconv_bwd"):
        _launched(SHORTCONV_BWD, SHORTCONV_BWD.fn(_BWD_ARGS)(
            bcx.data_ptr(), wf.data_ptr(), gy.data_ptr(), grad.data_ptr(),
            partials.data_ptr(), parts, dw.data_ptr(), b, t, c, length,
            _DTYPES[bcx.dtype], stream))
    return grad, dw.to(w.dtype)


def shortconv_counter(registry=None) -> _metrics.Counter:
    return (registry or _metrics.REGISTRY).counter(
        "shortconv_calls_total",
        "Forward calls of the gated short conv by the path they took: a "
        "launch of the hand-written CUDA kernel (kernel) or the plain "
        "PyTorch passes (plain)", ("model", "path"))


@once_differentiable
def _backward_cuda(ctx, bcx, w, gy):
    return short_conv_bwd_cuda(bcx, w, gy.contiguous())


class _GatedShortConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, bcx, w, name):
        ctx.save_for_backward(bcx, w)
        if bcx.is_cuda:
            y, path = short_conv_fwd_cuda(bcx, w), "kernel"
        else:
            y, path = gated_short_conv_plain(bcx, w), "plain"
        shortconv_counter().inc(model=name, path=path)
        return y

    @staticmethod
    def backward(ctx, gy):
        bcx, w = ctx.saved_tensors
        if bcx.is_cuda:
            return (*_backward_cuda(ctx, bcx, w, gy), None)
        return (*backward_plain(bcx, w, gy), None)


def gated_short_conv(bcx: torch.Tensor, w: torch.Tensor,
                     name: str = "gated_short_conv") -> torch.Tensor:
    """``C ⊙ conv(B ⊙ x)`` with its backward, under the ``shortconv``
    phase: the kernels for a CUDA ``bcx``, the plain passes otherwise;
    counted under ``shortconv_calls_total{model=name}``."""
    with _tracing.phase("shortconv"):
        return _GatedShortConv.apply(bcx, w, name)
