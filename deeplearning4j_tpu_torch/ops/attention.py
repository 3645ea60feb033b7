"""Single-device attention (counterpart of the JAX package's
``ops/attention.py::dot_product_attention``).

Shapes: q/k/v are [batch, time, heads, head_dim] ("BTHD"). Ring attention
(sequence parallelism) comes with the distribution slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          scale: Optional[float] = None):
    """Standard softmax attention, single program. [b,t,h,d] → [b,t,h,d].

    mask: optional [b, t_kv] key-validity mask (1=attend).

    Eligible calls (see ``flash_attention.flash_available``) go to the
    flash path: the hand-written CUDA kernel on the card, its plain
    blockwise version on the CPU. ``DL4JTPU_FLASH_ATTENTION=1`` forces it
    on, ``0`` forces this dense path."""
    from .flash_attention import flash_attention, flash_available
    if q.ndim == 4 and q.shape == k.shape == v.shape \
            and flash_available(q, mask):
        return flash_attention(q, k, v, causal, scale, mask=mask)
    d = q.shape[-1]
    if scale is None:
        # the reference rounds sqrt(d) to the activation dtype first
        scale = 1.0 / torch.tensor(math.sqrt(d), dtype=q.dtype).item()
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        causal_mask = torch.ones((tq, tk), dtype=torch.bool,
                                 device=q.device).tril(diagonal=tk - tq)
        logits = torch.where(causal_mask[None, None], logits, neg_inf)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, neg_inf)
    # manual stable softmax so a query with NO attendable keys (all -inf —
    # e.g. leading padded step under a causal mask) outputs 0, not NaN
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(torch.isneginf(logits), torch.zeros_like(logits),
                    torch.exp(logits - m_safe))
    weights = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)
