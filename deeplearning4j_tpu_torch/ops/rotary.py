"""Rotary position embedding (Su et al. 2021, arXiv:2104.09864), in the
rotate-half form: for a head vector split into halves ``(x₁, x₂)`` at
position ``t``, ``x·cos(tθ) + (−x₂, x₁)·sin(tθ)`` with ``θ_i =
base^(−2i/d)``, i < d/2, each frequency used by both halves. Plain
PyTorch, in at least f32, returned in the input's dtype; positions
``0 … t − 1`` along axis 1 of ``[b, t, h, d]``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rotary_tables(t: int, d: int, base: float, device, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` ``[t, d]`` of positions ``0 … t − 1``."""
    inv = 1.0 / (base ** (torch.arange(0, d, 2, device=device,
                                       dtype=torch.float64) / d))
    ang = torch.arange(t, device=device, dtype=torch.float64)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().to(dtype), ang.sin().to(dtype)


def apply_rotary(x: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate ``x [b, t, h, d]`` by its positions along axis 1."""
    ct = torch.promote_types(x.dtype, torch.float32)
    cos, sin = rotary_tables(x.shape[1], x.shape[-1], base, x.device, ct)
    xf = x.to(ct)
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * cos[:, None] + rot * sin[:, None]).to(x.dtype)
