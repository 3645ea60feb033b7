"""Common elementwise/random ops (counterpart of the JAX package's
``ops/common.py``).

Randomness comes from an explicit ``torch.Generator`` on the tensor's
device, where the reference folds a jax key; the semantics are the
reference's, the numbers are not.
"""

from __future__ import annotations

import torch


def dropout_mask(generator: torch.Generator, shape, rate: float,
                 dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Inverted-dropout mask: keep with probability ``1 - rate`` and scale
    the kept entries by ``1 / (1 - rate)``. ``rate`` is the probability of
    DROPPING, as in the reference."""
    keep = 1.0 - rate
    u = torch.rand(shape, generator=generator, device=device)
    return (u < keep).to(dtype) / keep


def apply_dropout(generator, x: torch.Tensor, rate: float,
                  train: bool) -> torch.Tensor:
    if not train or rate <= 0.0 or generator is None:
        return x
    return x * dropout_mask(generator, x.shape, rate, x.dtype, x.device)
