"""RMSNorm (Zhang and Sennrich 2019): ``y = x / √(mean(x²) + eps) · w``
over the last axis, in at least f32, returned in ``x``'s dtype.

It replaces no TPU kernel (the JAX package has no RMSNorm). The autograd
function saves ``x`` as it came and the f32 reciprocal root of each row,
and forms the backward from them, so a bf16 activation is kept once and
not as its f32 copies. Plain PyTorch: a pass over memory, read by no
per-layer metric yet.
"""

from __future__ import annotations

import torch


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, eps):
        ct = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(ct)
        rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, w, rstd)
        return (xf * rstd * w.to(ct)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, rstd = ctx.saved_tensors
        ct = rstd.dtype
        xhat = x.to(ct) * rstd
        gf = g.to(ct)
        gxhat = gf * w.to(ct)
        gx = rstd * (gxhat - xhat * (gxhat * xhat).mean(-1, keepdim=True))
        gw = (gf * xhat).reshape(-1, x.shape[-1]).sum(0)
        return gx.to(x.dtype), gw.to(w.dtype), None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of ``x [..., n]`` with the weight ``w [n]``."""
    return _RMSNorm.apply(x, w, float(eps))
