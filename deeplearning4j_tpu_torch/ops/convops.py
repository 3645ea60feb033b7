"""Convolution, pooling and LRN on NHWC activations and HWIO weights
(counterpart of the JAX package's ``ops/convops.py``).

The reference lowers these to XLA's ``conv_general_dilated`` and
``reduce_window``; the port calls cuDNN through ``F.conv2d`` and the
pooling ops. Activations stay NHWC ``[batch, h, w, channels]`` and
kernels HWIO ``[kh, kw, in_c, out_c]``, as in the reference and its
checkpoints: ``x.permute(0, 3, 1, 2)`` of an NHWC tensor is already a
channels-last NCHW view, and the weight is cast and moved to
channels-last OIHW in one copy.

f32 convolutions run in f32. PyTorch lets cuDNN round f32 conv operands
to TF32 by default (``torch.backends.cudnn.allow_tf32``); the first f32
convolution the port runs on the card turns that off for the process, so
an f32 network computes what the reference's f32 network computes (bf16
convolutions are unaffected; f32 matmuls stay f32 by PyTorch's own
default).

Padding follows XLA, not PyTorch: ``"same"`` pads ``total // 2`` before
and the rest after (a 3×3/2 conv on 56×56 pads (0, 1)); an uneven pair is
applied with ``F.pad`` — with −inf for a max pool — and an average pool
divides by the count of real elements in each window.

The reference's two alternative lowerings (``DL4JTPU_CONV_DW=matmul``,
``DL4JTPU_CONV_1X1=dot``, both off by default) are plain matrix products,
``torch.matmul`` here (:func:`conv2d`).
"""

from __future__ import annotations

import os
from typing import Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, Tuple[int, int]]


def conv_output_size(in_size: int, kernel: int, stride: int, pad: int,
                     dilation: int = 1) -> int:
    """Output spatial size, strict mode (the reference's)."""
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    return (in_size + 2 * pad - eff_k) // stride + 1


def same_pad(in_size: int, kernel: int, stride: int) -> int:
    out = -(-in_size // stride)
    total = max(0, (out - 1) * stride + kernel - in_size)
    return total // 2


def pad_pairs(padding: Padding, in_hw, kernel, stride,
              dilation=(1, 1)) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``((top, bottom), (left, right))`` as XLA pads: ``"valid"`` none,
    ``"same"`` ``lax.padtype_to_pads`` over the dilated window, a pair
    ``(ph, pw)`` symmetric."""
    if isinstance(padding, str):
        mode = padding.lower()
        if mode == "valid":
            return (0, 0), (0, 0)
        if mode != "same":
            raise ValueError(f"unknown padding {padding!r}")
        pads = []
        for n, k, s, d in zip(in_hw, kernel, stride, dilation):
            out = -(-n // s)
            total = max(0, (out - 1) * s + (k - 1) * d + 1 - n)
            pads.append((total // 2, total - total // 2))
        return pads[0], pads[1]
    ph, pw = padding
    return (int(ph), int(ph)), (int(pw), int(pw))


def _nchw_operands(x, w, stride, padding, dilation, dtype):
    """(input as a channels-last NCHW view, padded when XLA's pads are
    uneven; the weight as channels-last OIHW in the compute dtype; the
    symmetric pad F.conv2d applies; XLA's pad pairs)."""
    pads = pad_pairs(padding, x.shape[1:3], w.shape[:2], stride, dilation)
    (pt, pb), (pl, pr) = pads
    if (x.is_cuda and (dtype or x.dtype) == torch.float32
            and torch.backends.cudnn.allow_tf32):
        torch.backends.cudnn.allow_tf32 = False     # f32 stays f32
    xn = x.permute(0, 3, 1, 2)
    wn = w.permute(3, 2, 0, 1).to(dtype=dtype or x.dtype,
                                  memory_format=torch.channels_last)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xn = F.pad(xn, (pl, pr, pt, pb))
        pad = (0, 0)
    return xn, wn, pad, pads


def _conv2d_default(x, w, stride, padding, dilation, groups, dtype):
    xn, wn, pad, _ = _nchw_operands(x, w, stride, padding, dilation, dtype)
    y = F.conv2d(xn, wn, None, tuple(stride), pad, tuple(dilation), groups)
    return y.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
           padding: Padding = (0, 0), dilation=(1, 1), groups: int = 1,
           dtype=None) -> torch.Tensor:
    """2D convolution, NHWC × HWIO → NHWC. ``dtype`` (default ``x``'s) is
    the compute dtype the weight is cast to, in the same copy that moves
    it to channels-last OIHW.

    Two alternative lowerings, off by default as in the reference and
    read from its environment names:

    - ``DL4JTPU_CONV_DW=matmul`` (undilated, ungrouped convs): the weight
      gradient as one [Cin, N·Ho·Wo]·[N·Ho·Wo, Cout] matrix product per
      kernel tap (:class:`_Conv2dMMdW`); the input gradient stays cuDNN's.
    - ``DL4JTPU_CONV_1X1=dot``: a 1×1 conv (no dilation, groups or
      padding) as a channel contraction, ``[N, H, W, Cin]·[Cin, Cout]``,
      a stride > 1 first taken as a slice.
    """
    if (_1x1_mode() == "dot" and w.shape[0] == w.shape[1] == 1
            and groups == 1 and tuple(dilation) == (1, 1)
            and (isinstance(padding, str)   # SAME == VALID for a 1x1 kernel
                 or tuple(padding) == (0, 0))):
        sh, sw = tuple(stride)
        if sh > 1 or sw > 1:
            x = x[:, ::sh, ::sw, :]
        return torch.matmul(x, w[0, 0].to(dtype or x.dtype))
    if _dw_mode() == "matmul" and groups == 1 and tuple(dilation) == (1, 1):
        return _Conv2dMMdW.apply(x, w, tuple(stride), padding, dtype)
    return _conv2d_default(x, w, stride, padding, dilation, groups, dtype)


def _1x1_mode() -> str:
    return os.environ.get("DL4JTPU_CONV_1X1", "")


def _dw_mode() -> str:
    return os.environ.get("DL4JTPU_CONV_DW", "")


class _Conv2dMMdW(torch.autograd.Function):
    """The convolution with its weight gradient as per-tap matrix
    products (the reference's ``_conv2d_mmdw``): the forward and the input
    gradient are cuDNN's (``aten.convolution_backward`` for dx alone, so
    the backward does not run the forward again); dW stacks, for each tap
    (p, q), the product of the input window that tap sees through the
    XLA-padded input, [N·Ho·Wo, Cin]ᵀ, with dY as [N·Ho·Wo, Cout],
    accumulated in at least f32."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dtype):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding, ctx.dtype = stride, padding, dtype
        return _conv2d_default(x, w, stride, padding, (1, 1), 1, dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.stride, ctx.padding
        xn, wn, pad, pads = _nchw_operands(x, w, stride, padding, (1, 1),
                                           ctx.dtype)
        (pt, pb), (pl, pr) = pads
        dy_n = dy.permute(0, 3, 1, 2).to(wn.dtype)
        dxn = torch.ops.aten.convolution_backward(
            dy_n, xn, wn, None, list(stride), list(pad), [1, 1], False,
            [0, 0], 1, [True, False, False])[0]
        if pad == (0, 0) and (pt, pb, pl, pr) != (0, 0, 0, 0):
            dxn = dxn[:, :, pt:pt + x.shape[1], pl:pl + x.shape[2]]
        dx = dxn.permute(0, 2, 3, 1).to(x.dtype)
        kh, kw, cin, cout = w.shape
        sh, sw = stride
        n, ho, wo, _ = dy.shape
        acc = torch.promote_types(x.dtype, torch.float32)
        xp = F.pad(x, (0, 0, pl, pr, pt, pb)).to(acc)
        dy2 = dy.reshape(n * ho * wo, cout).to(acc)
        taps = []
        for p in range(kh):
            for q in range(kw):
                xs = xp[:, p:p + (ho - 1) * sh + 1:sh,
                        q:q + (wo - 1) * sw + 1:sw, :]
                taps.append(xs.reshape(n * ho * wo, cin).t() @ dy2)
        dw = torch.stack(taps).reshape(kh, kw, cin, cout).to(w.dtype)
        return dx, dw, None, None, None


def pool2d(x: torch.Tensor, kind: str, kernel=(2, 2), stride=(2, 2),
           padding: Padding = (0, 0), pnorm: int = 2) -> torch.Tensor:
    """Pooling, NHWC. ``kind`` in {max, avg, sum, pnorm}."""
    kind = kind.lower()
    kernel, stride = tuple(kernel), tuple(stride)
    (pt, pb), (pl, pr) = pad_pairs(padding, x.shape[1:3], kernel, stride)
    padded = any((pt, pb, pl, pr))
    xn = x.permute(0, 3, 1, 2)

    def window_sum(t):
        if padded:
            t = F.pad(t, (pl, pr, pt, pb))
        return F.avg_pool2d(t, kernel, stride, divisor_override=1)

    if kind == "max":
        if padded:
            xn = F.pad(xn, (pl, pr, pt, pb), value=float("-inf"))
        y = F.max_pool2d(xn, kernel, stride)
    elif kind == "sum":
        y = window_sum(xn)
    elif kind == "avg":
        summed = window_sum(xn)
        if not padded:
            y = summed / (kernel[0] * kernel[1])
        else:
            # divide by the real window sizes at the borders
            ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype,
                              device=x.device)
            y = summed / window_sum(ones)
    elif kind == "pnorm":
        p = float(pnorm)
        y = window_sum(torch.abs(xn) ** p) ** (1.0 / p)
    else:
        raise ValueError(f"unknown pooling type {kind!r}")
    return y.permute(0, 2, 3, 1)


def lrn(x: torch.Tensor, k: float = 2.0, n: int = 5, alpha: float = 1e-4,
        beta: float = 0.75) -> torch.Tensor:
    """Cross-channel local response normalization on NHWC:
    ``x / (k + alpha · Σ_window x²)^beta``, the window covering
    ``n // 2`` channels before and ``n - 1 - n // 2`` after — not
    ``F.local_response_norm``, which divides ``alpha`` by ``n``."""
    sq = x * x
    half = n // 2
    c = x.shape[-1]
    padded = F.pad(sq, (half, n - 1 - half))
    summed = padded[..., 0:c]
    for i in range(1, n):
        summed = summed + padded[..., i:i + c]
    return x / (k + alpha * summed) ** beta
