"""The gated short convolution of a hybrid conv/attention LM (Liquid AI's
LFM2): between the block's two projections, for ``B, C, x`` the three
thirds of the input projection,

    u = B ⊙ x,   z[t] = Σ_j w[:, j] · u[t − (L − 1) + j],   y = C ⊙ z

a causal depthwise convolution of length ``L`` (one filter a channel,
``u`` left-padded by ``L − 1`` zeros), gated on both sides.

It replaces no TPU kernel (the JAX package has no such layer). Plain
PyTorch inside one autograd function, under the ``shortconv`` phase: it
saves the projection's output and the filters only and forms ``u`` and
``z`` again in the backward, in at least f32. Its bound is bytes: B, C
and x read and y written forward; dy, B, C and x read and dB, dC and dx
written backward; a fused kernel would make each one pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..util import tracing as _tracing


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


class _GatedShortConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, bcx, w):
        ctx.save_for_backward(bcx, w)
        return gated_short_conv_plain(bcx, w)

    @staticmethod
    def backward(ctx, gy):
        bcx, w = ctx.saved_tensors
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


def gated_short_conv(bcx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`gated_short_conv_plain` with its backward, under the
    ``shortconv`` phase."""
    with _tracing.phase("shortconv"):
        return _GatedShortConv.apply(bcx, w)
