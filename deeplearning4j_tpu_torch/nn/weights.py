"""Weight initialization schemes (counterpart of the JAX package's
``nn/weights.py``).

The same scheme names and distributions, drawn from a ``torch.Generator``.
They match the reference in distribution, not bit for bit: jax's threefry
keys and torch's generator give different numbers from one seed, so parity
with the reference always runs from loaded weights.

  DISTRIBUTION    sample from a configured distribution
  ZERO / ONES     constants
  SIGMOID_UNIFORM U(-r, r), r = 4*sqrt(6/(fanIn+fanOut))
  UNIFORM         U(-a, a), a = 1/sqrt(fanIn)
  XAVIER          N(0, 2/(fanIn+fanOut))
  XAVIER_UNIFORM  U(-s, s), s = sqrt(6/(fanIn+fanOut))
  XAVIER_FAN_IN   N(0, 1/fanIn)
  XAVIER_LEGACY   N(0, 1/(shape[0]+shape[1]))
  RELU            N(0, 2/fanIn)  (He init)
  RELU_UNIFORM    U(-u, u), u = sqrt(6/fanIn)
  NORMALIZED      (U(0,1) - 0.5) / shape[0]
  IDENTITY, LECUN_NORMAL, LECUN_UNIFORM, VAR_SCALING_NORMAL_FAN_AVG
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

VALID = (
    "DISTRIBUTION", "ZERO", "ONES", "SIGMOID_UNIFORM", "UNIFORM", "XAVIER",
    "XAVIER_UNIFORM", "XAVIER_FAN_IN", "XAVIER_LEGACY", "RELU", "RELU_UNIFORM",
    "NORMALIZED", "IDENTITY", "LECUN_NORMAL", "LECUN_UNIFORM",
    "VAR_SCALING_NORMAL_FAN_AVG",
)


@dataclasses.dataclass(frozen=True)
class Distribution:
    """Serializable distribution spec for WeightInit.DISTRIBUTION (same
    fields and JSON as the reference's)."""

    kind: str = "normal"  # normal | uniform | constant
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    value: float = 0.0

    def sample(self, gen, shape, dtype, device):
        if self.kind == "normal":
            return self.mean + self.std * _normal(gen, shape, dtype, device)
        if self.kind == "uniform":
            return _uniform(gen, shape, dtype, device, self.lower, self.upper)
        if self.kind == "constant":
            return torch.full(shape, self.value, dtype=dtype, device=device)
        raise ValueError(f"unknown distribution kind {self.kind!r}")

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        return Distribution(**d)


def _normal(gen, shape, dtype, device):
    # draw on the generator's device, then move: a CPU generator gives the
    # same numbers whatever device the parameters live on
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).to(device)


def _uniform(gen, shape, dtype, device, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return (lo + (hi - lo) * u).to(device)


def init_weights(gen: torch.Generator, shape: Sequence[int], scheme: str,
                 fan_in: float, fan_out: float,
                 distribution: Optional[Distribution] = None,
                 dtype=torch.float32, device="cpu") -> torch.Tensor:
    scheme = scheme.upper()
    shape = tuple(shape)
    if scheme == "ZERO":
        return torch.zeros(shape, dtype=dtype, device=device)
    if scheme == "ONES":
        return torch.ones(shape, dtype=dtype, device=device)
    if scheme == "IDENTITY":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2d shape")
        return torch.eye(shape[0], dtype=dtype, device=device)
    if scheme == "DISTRIBUTION":
        if distribution is None:
            raise ValueError("WeightInit DISTRIBUTION requires a distribution")
        return distribution.sample(gen, shape, dtype, device)
    normal = lambda: _normal(gen, shape, dtype, device)          # noqa: E731
    uniform = lambda lo, hi: _uniform(gen, shape, dtype, device,  # noqa: E731
                                      lo, hi)
    if scheme == "NORMALIZED":
        return (uniform(0.0, 1.0) - 0.5) / shape[0]
    if scheme in ("XAVIER", "VAR_SCALING_NORMAL_FAN_AVG"):
        return normal() * math.sqrt(2.0 / (fan_in + fan_out))
    if scheme == "XAVIER_UNIFORM":
        s = math.sqrt(6.0 / (fan_in + fan_out))
        return uniform(-s, s)
    if scheme == "XAVIER_FAN_IN":
        return normal() / math.sqrt(fan_in)
    if scheme == "XAVIER_LEGACY":
        return normal() / math.sqrt(shape[0] + shape[1])
    if scheme == "SIGMOID_UNIFORM":
        r = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return uniform(-r, r)
    if scheme == "UNIFORM":
        a = 1.0 / math.sqrt(fan_in)
        return uniform(-a, a)
    if scheme == "RELU":
        return normal() * math.sqrt(2.0 / fan_in)
    if scheme == "RELU_UNIFORM":
        u = math.sqrt(6.0 / fan_in)
        return uniform(-u, u)
    if scheme == "LECUN_NORMAL":
        return normal() * math.sqrt(1.0 / fan_in)
    if scheme == "LECUN_UNIFORM":
        b = math.sqrt(3.0 / fan_in)
        return uniform(-b, b)
    raise ValueError(f"unknown WeightInit scheme {scheme!r}; valid: {VALID}")
