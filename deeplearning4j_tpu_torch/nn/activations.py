"""Activation functions (counterpart of the JAX package's
``nn/activations.py``): the same string-keyed registry and names, as
plain functions on tensors."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, Activation] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn
    return deco


def get(name: str) -> Activation:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(_REGISTRY)}") from None


def names():
    return sorted(_REGISTRY)


@register("identity")
@register("linear")
def identity(x):
    return x


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("tanh")
def tanh(x):
    return torch.tanh(x)


@register("relu")
def relu(x):
    return torch.relu(x)


@register("leakyrelu")
def leakyrelu(x, alpha: float = 0.01):
    return torch.where(x >= 0, x, alpha * x)


@register("softmax")
def softmax(x):
    return torch.softmax(x, dim=-1)


@register("softplus")
def softplus(x):
    return F.softplus(x)


@register("softsign")
def softsign(x):
    return F.softsign(x)


@register("hardtanh")
def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


@register("hardsigmoid")
def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


@register("elu")
def elu(x):
    return F.elu(x)


@register("selu")
def selu(x):
    return F.selu(x)


@register("gelu")
def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


@register("swish")
@register("silu")
def swish(x):
    return F.silu(x)


@register("cube")
def cube(x):
    return x ** 3


@register("rationaltanh")
def rationaltanh(x):
    # 1.7159 * tanh_approx(2x/3), tanh_approx(y) =
    # sign(y)(1 - 1/(1+|y|+y^2+1.41645 y^4)) — ND4J RationalTanh semantics
    y = 2.0 * x / 3.0
    a = torch.abs(y)
    approx = torch.sign(y) * (1.0 - 1.0 / (1.0 + a + y * y + 1.41645 * a ** 4))
    return 1.7159 * approx
