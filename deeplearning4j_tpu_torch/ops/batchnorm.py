"""Training batch normalization with the reference's hand-written VJP
(counterpart of the JAX package's ``ops/batchnorm.py``).

Statistics reduce over every axis but the last (channel) one, so NHWC and
``[b, f]`` both work. The forward takes the batch mean and the BIASED
variance as ``E[x²] − E[x]²`` clamped at 0, the square kept in the
activation dtype and both sums accumulated in the statistics dtype (the
dtype of gamma: f32, or f64 under the f64 policy); it normalises and
scales in the activation dtype. The backward is the textbook BN gradient
the reference writes by hand (its ``_vjp_bwd``): one pass for dβ and dγ,
one for dx. ``F.batch_norm`` keeps the unbiased variance and computes
another backward, so it does not serve the training path.

:class:`BatchNormTrain` returns the batch statistics beside ``y`` for the
running-average update; they are not differentiated.
"""

from __future__ import annotations

import torch


def _reduce_dims(x):
    return tuple(range(x.ndim - 1))


def _n_elements(x) -> float:
    n = 1
    for d in _reduce_dims(x):
        n *= x.shape[d]
    return float(n)


def _split_groups():
    from ..parallel.collectives import active_batch_groups
    return active_batch_groups()


def _global(sums, n, groups):
    """Per-channel sums and the element count over the ranks the batch is
    split over (the sums stacked into one all-reduce)."""
    from ..parallel.collectives import _all_reduce_
    if not groups:
        return sums, n
    flat = _all_reduce_(torch.stack(sums), groups)
    count = _all_reduce_(torch.tensor([n], dtype=torch.float64,
                                      device=flat.device), groups)
    return list(flat.unbind(0)), float(count.item())


def batch_stats(x, stat_dtype):
    """Batch mean and biased variance per channel, in ``stat_dtype``.
    Inside a ``parallel.collectives.batch_split`` the moments are those of
    the global batch (the sums all-reduced over its ranks)."""
    dims = _reduce_dims(x)
    s1 = torch.sum(x, dim=dims, dtype=stat_dtype)
    s2 = torch.sum(torch.square(x), dim=dims, dtype=stat_dtype)
    (s1, s2), n = _global([s1, s2], _n_elements(x), _split_groups())
    mean = s1 / n
    var = torch.clamp_min(s2 / n - torch.square(mean), 0.0)
    return mean, var


def _scale_shift(x, gamma, beta, mean, var, eps):
    inv = torch.rsqrt(var + eps)
    scale = (gamma * inv).to(x.dtype)
    shift = (beta - gamma * mean * inv).to(x.dtype)
    return scale, shift


class BatchNormTrain(torch.autograd.Function):
    """``(y, mean, var) = BatchNormTrain.apply(x, gamma, beta, eps)``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        mean, var = batch_stats(x, gamma.dtype)
        scale, shift = _scale_shift(x, gamma, beta, mean, var, eps)
        y = x * scale + shift
        ctx.save_for_backward(x, gamma, mean, var)
        ctx.eps = eps
        ctx.groups = _split_groups()
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, var = ctx.saved_tensors
        dims = _reduce_dims(x)
        stat = gamma.dtype
        inv = torch.rsqrt(var + ctx.eps)
        xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        dbeta = torch.sum(dy, dim=dims, dtype=stat)
        dgamma = torch.sum((dy * xhat).to(stat), dim=dims, dtype=stat)
        # dx reads the global sums; dγ and dβ stay this rank's share (the
        # trainer sums the ranks' parameter gradients)
        (gb, gg), n = _global([dbeta, dgamma], _n_elements(x), ctx.groups)
        dx = (gamma * inv).to(x.dtype) * (
            dy - (gb / n).to(x.dtype) - xhat * (gg / n).to(x.dtype))
        return dx, dgamma, dbeta, None


def batch_norm_train(x, gamma, beta, eps):
    """Training-mode BN: ``(y, batch_mean, batch_var)``. gamma/beta are in
    the statistics dtype; x may be bf16, f32 or f64."""
    return BatchNormTrain.apply(x, gamma, beta, float(eps))


def batch_norm_inference(x, gamma, beta, mean, var, eps):
    """Inference-mode BN from running statistics (elementwise)."""
    scale, shift = _scale_shift(x, gamma, beta, mean, var, eps)
    return x * scale + shift
