"""On-device token sampling for the fused decode loop (counterpart of the
JAX package's ``ops/sampling.py``).

One documented sampling semantics, shared with the host-side
``models.transformer.sample_token``, so the ticked scheduler, the
full-cache oracle (``generate``) and the fused device loop read a
distribution the same way:

1. **temperature** ``T > 0``: reweight ``w ∝ p^(1/T)``; ``T <= 0`` is the
   greedy argmax of the raw distribution (ties go to the lower id).
2. **top-k** (``top_k > 0``): keep the ``top_k`` highest-weight tokens —
   ties broken toward the lower id by a stable descending sort — zero the
   rest, renormalize.
3. **top-p** (``0 < top_p < 1``): over the top-k weights in descending
   order, keep the minimal prefix whose cumulative mass reaches
   ``top_p`` (a token is kept iff the mass BEFORE it is ``< top_p``),
   renormalize.
4. **draw**: inverse CDF over token ids in ascending id order at a
   uniform ``u`` the caller supplies (drawn on the host from each
   request's seeded generator).

Everything is vectorized over lanes with per-lane ``temperature`` /
``top_k`` / ``top_p`` tensors and reads no value back to the host, so the
fused loop can call it between two device steps without a sync.
"""

from __future__ import annotations

import torch

__all__ = ["filtered_probs", "inverse_cdf", "sample_tokens"]


def filtered_probs(probs, temperature, top_k, top_p):
    """Temperature/top-k/top-p filtered, renormalized distribution.

    probs ``[S, V]``; temperature/top_k/top_p ``[S]`` (``top_k <= 0`` = no
    k-filter, ``top_p`` outside (0, 1) = no p-filter, ``temperature <= 0``
    lanes are reweighted at T = 1 — their callers take the greedy branch).
    Returns ``[S, V]`` float32."""
    p = probs.float()
    v = p.shape[-1]
    t = torch.where(temperature > 0, temperature,
                    torch.ones_like(temperature)).float()
    logits = torch.log(torch.clamp_min(p, 1e-30)) / t[:, None]
    logits = logits - logits.max(dim=-1, keepdim=True).values
    w = torch.exp(logits)
    # descending stable order: ties go to the lower id, as jnp.argsort
    order = torch.argsort(-w, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, v))
    w = torch.where(ranks < k[:, None].to(ranks.dtype), w, 0.0)
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-30)
    w_desc = torch.take_along_dim(w, order, dim=-1)
    before = torch.cumsum(w_desc, dim=-1) - w_desc
    tp = torch.where((top_p > 0) & (top_p < 1), top_p,
                     torch.ones_like(top_p)).float()
    keep = torch.take_along_dim(before < tp[:, None], ranks, dim=-1)
    w = torch.where(keep, w, 0.0)
    return w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-30)


def inverse_cdf(weights, u):
    """Inverse-CDF draw in ascending token-id order: ``[S, V]`` weights
    (need not be normalized) and ``[S]`` uniforms → ``[S]`` int32, the
    smallest id whose cumulative weight exceeds ``u·total``. When
    ``u·total`` reaches the top of the CDF in floating point, the draw
    falls back to the LAST positive-weight id (never a filtered-out
    token)."""
    w = weights.float()
    c = torch.cumsum(w, dim=-1)
    gt = c > (u.float() * c[:, -1])[:, None]
    v = w.shape[-1]
    last_pos = (v - 1) - torch.argmax((w > 0).flip(-1).to(torch.uint8),
                                      dim=-1)
    first = torch.argmax(gt.to(torch.uint8), dim=-1)
    return torch.where(gt.any(dim=-1), first, last_pos).to(torch.int32)


def sample_tokens(probs, temperature, top_k, top_p, u):
    """Per-lane next token (the device twin of the host
    ``models.transformer.sample_token``): greedy argmax where
    ``temperature <= 0``, else the inverse CDF at ``u`` over the filtered
    distribution. probs ``[S, V]``, the rest ``[S]`` → ``[S]`` int32."""
    greedy = torch.argmax(probs, dim=-1).to(torch.int32)
    sampled = inverse_cdf(filtered_probs(probs, temperature, top_k, top_p),
                          u)
    return torch.where(temperature > 0, sampled, greedy)
