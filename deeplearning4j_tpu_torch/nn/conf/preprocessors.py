"""Input preprocessors: shape adapters inserted between layer families
(counterpart of the JAX package's ``nn/conf/preprocessors.py``; the same
classes, fields and JSON).

Each is a reshape or a normalisation of the forward activations;
autograd derives the backward. ``transform_mask`` carries a mask through
the same reshape. CNN activations are NHWC, so CnnToFeedForward flattens
in (h, w, c) order, as the reference does.

All of the reference's: CnnToFeedForward, FeedForwardToCnn,
RnnToFeedForward, FeedForwardToRnn, CnnToRnn, RnnToCnn, Reshape, ZeroMean,
UnitVariance, ZeroMeanAndUnitVariance, BinomialSampling and Composable.
The network runtimes call them through :func:`call_preprocessor`, which
hands a sampling preprocessor (``wants_rng``) the step's
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Type

import torch

from .inputs import InputType

_REGISTRY: Dict[str, Type["InputPreProcessor"]] = {}


def register_preprocessor(name: str):
    def deco(cls):
        cls._type_name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def call_preprocessor(proc: "InputPreProcessor", x, minibatch_size=None,
                      generator=None):
    """Apply a preprocessor from a network runtime: one that samples
    (``wants_rng``) draws from the step's ``generator``; every other is a
    plain call."""
    if getattr(proc, "wants_rng", False) and generator is not None:
        return proc(x, minibatch_size=minibatch_size, generator=generator)
    return proc(x, minibatch_size=minibatch_size)


def child_generator(generator: torch.Generator, index: int) -> torch.Generator:
    """A generator for child ``index`` of a composite, seeded from the
    parent's current state and the index (host-side state; no device
    read)."""
    state = generator.get_state().numpy().tobytes()
    digest = hashlib.blake2s(state + index.to_bytes(4, "big"),
                             digest_size=8).digest()
    child = torch.Generator(device=generator.device)
    child.manual_seed(int.from_bytes(digest, "big") >> 1)
    return child


def preprocessor_from_dict(d) -> "InputPreProcessor":
    from .layers import NotYetPorted
    d = dict(d)
    typ = d.pop("type")
    cls = _REGISTRY.get(typ)
    if cls is None:
        raise NotYetPorted(f"input preprocessor {typ!r} is not yet ported to "
                           "the PyTorch package")
    if "to_shape" in d:
        d["to_shape"] = tuple(d["to_shape"])
    if "children" in d:         # Composable: nested preprocessors
        d["children"] = tuple(preprocessor_from_dict(c)
                              for c in d["children"])
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class InputPreProcessor:
    _type_name = "base"

    def __call__(self, x, minibatch_size=None):
        raise NotImplementedError

    def transform_mask(self, mask, minibatch_size=None):
        return mask

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self):
        return {"type": self._type_name, **dataclasses.asdict(self)}


@register_preprocessor("cnn_to_feedforward")
@dataclasses.dataclass(frozen=True)
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, h, w, c] → [b, h·w·c]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, minibatch_size=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type):
        return InputType.feed_forward(input_type.height * input_type.width
                                      * input_type.channels)


@register_preprocessor("feedforward_to_cnn")
@dataclasses.dataclass(frozen=True)
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[b, h·w·c] → [b, h, w, c]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, minibatch_size=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor("rnn_to_feedforward")
@dataclasses.dataclass(frozen=True)
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, t, f] → [b·t, f] (time-distributed dense)."""

    def __call__(self, x, minibatch_size=None):
        return x.reshape(-1, x.shape[-1])

    def transform_mask(self, mask, minibatch_size=None):
        return None if mask is None else mask.reshape(-1)

    def output_type(self, input_type):
        return InputType.feed_forward(input_type.size)


@register_preprocessor("feedforward_to_rnn")
@dataclasses.dataclass(frozen=True)
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[b·t, f] → [b, t, f]; ``minibatch_size`` (the network's) rebuilds
    the time axis, ``minibatch`` is the JSON-carried fallback."""
    minibatch: int = 0

    def _batch(self, minibatch_size):
        b = minibatch_size if minibatch_size else self.minibatch
        if not b:
            raise ValueError(
                "FeedForwardToRnnPreProcessor needs minibatch_size to "
                "reconstruct the time axis from [b*t, f]; the network runtime "
                "supplies it — pass minibatch_size= when calling directly")
        return b

    def __call__(self, x, minibatch_size=None):
        return x.reshape(self._batch(minibatch_size), -1, x.shape[-1])

    def transform_mask(self, mask, minibatch_size=None):
        if mask is None:
            return None
        return mask.reshape(self._batch(minibatch_size), -1)

    def output_type(self, input_type):
        return InputType.recurrent(input_type.size)


@register_preprocessor("cnn_to_rnn")
@dataclasses.dataclass(frozen=True)
class CnnToRnnPreProcessor(InputPreProcessor):
    """[b·t, h, w, c] → [b, t, h·w·c]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, minibatch_size=None):
        b = minibatch_size or x.shape[0]
        return x.reshape(b, -1, self.height * self.width * self.channels)

    def output_type(self, input_type):
        return InputType.recurrent(input_type.height * input_type.width
                                   * input_type.channels)


@register_preprocessor("rnn_to_cnn")
@dataclasses.dataclass(frozen=True)
class RnnToCnnPreProcessor(InputPreProcessor):
    """[b, t, h·w·c] → [b·t, h, w, c]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x, minibatch_size=None):
        return x.reshape(-1, self.height, self.width, self.channels)

    def transform_mask(self, mask, minibatch_size=None):
        return None if mask is None else mask.reshape(-1)

    def output_type(self, input_type):
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preprocessor("reshape")
@dataclasses.dataclass(frozen=True)
class ReshapePreProcessor(InputPreProcessor):
    """Arbitrary reshape; with ``dynamic`` the leading dimension follows
    the incoming minibatch."""
    to_shape: tuple = ()
    dynamic: bool = True

    def __call__(self, x, minibatch_size=None):
        shape = tuple(int(s) for s in self.to_shape)
        if self.dynamic:
            shape = (x.shape[0],) + shape[1:]
        return x.reshape(shape)

    def output_type(self, input_type):
        tail = tuple(int(s) for s in self.to_shape[1:])
        if len(tail) == 1:
            return InputType.feed_forward(tail[0])
        if len(tail) == 2:
            return InputType.recurrent(tail[1])
        if len(tail) == 3:
            return InputType.convolutional(*tail)
        raise ValueError(f"cannot infer InputType for to_shape={self.to_shape}")

    def to_dict(self):
        return {"type": self._type_name,
                "to_shape": list(self.to_shape), "dynamic": self.dynamic}


def _column_std(x, eps):
    # ddof=1 is 0/0 for a minibatch of 1: ddof=0 there, as the reference
    return torch.std(x, dim=0, keepdim=True,
                     correction=1 if x.shape[0] > 1 else 0) + eps


@register_preprocessor("zero_mean")
@dataclasses.dataclass(frozen=True)
class ZeroMeanPreProcessor(InputPreProcessor):
    """Subtract the per-column batch mean, treated as a constant in the
    backward (the reference's ``stop_gradient``)."""

    def __call__(self, x, minibatch_size=None):
        return x - x.mean(dim=0, keepdim=True).detach()

    def output_type(self, input_type):
        return input_type


@register_preprocessor("unit_variance")
@dataclasses.dataclass(frozen=True)
class UnitVarianceProcessor(InputPreProcessor):
    """Divide by the per-column batch std (ddof 1) plus ``eps``."""
    eps: float = 1e-5

    def __call__(self, x, minibatch_size=None):
        return x / _column_std(x, self.eps).detach()

    def output_type(self, input_type):
        return input_type


@register_preprocessor("zero_mean_unit_variance")
@dataclasses.dataclass(frozen=True)
class ZeroMeanAndUnitVariancePreProcessor(InputPreProcessor):
    """Column-standardise activations."""
    eps: float = 1e-5

    def __call__(self, x, minibatch_size=None):
        mean = x.mean(dim=0, keepdim=True)
        return (x - mean.detach()) / _column_std(x, self.eps).detach()

    def output_type(self, input_type):
        return input_type


@register_preprocessor("binomial_sampling")
@dataclasses.dataclass(frozen=True)
class BinomialSamplingPreProcessor(InputPreProcessor):
    """Bernoulli samples of activations read as probabilities (clipped to
    [0, 1]), straight-through in the backward (the sample's gradient is
    the identity's). In a network the draw comes from the step's
    generator, so every step samples afresh; a direct call without one
    draws from a generator seeded with ``seed``."""
    seed: int = 0
    wants_rng = True

    def __call__(self, x, minibatch_size=None, generator=None):
        if generator is None:
            generator = torch.Generator(device=x.device)
            generator.manual_seed(self.seed)
        u = torch.rand(x.shape, generator=generator, device=x.device,
                       dtype=torch.promote_types(x.dtype, torch.float32))
        sample = (u < torch.clamp(x, 0.0, 1.0)).to(x.dtype)
        return x + (sample - x).detach()

    def output_type(self, input_type):
        return input_type


@register_preprocessor("composable")
@dataclasses.dataclass(frozen=True)
class ComposableInputPreProcessor(InputPreProcessor):
    """Apply ``children`` in order (their masks and output types too); a
    sampling child draws from a generator offset by its index from the
    step's."""
    children: tuple = ()

    @property
    def wants_rng(self):
        return any(getattr(p, "wants_rng", False) for p in self.children)

    def __call__(self, x, minibatch_size=None, generator=None):
        for i, p in enumerate(self.children):
            if getattr(p, "wants_rng", False) and generator is not None:
                x = p(x, minibatch_size=minibatch_size,
                      generator=child_generator(generator, i))
            else:
                x = p(x, minibatch_size=minibatch_size)
        if generator is not None and self.wants_rng:
            # move the step's stream on, so a later composite in the same
            # step seeds its children differently
            torch.rand((1,), generator=generator, device=generator.device)
        return x

    def transform_mask(self, mask, minibatch_size=None):
        for p in self.children:
            mask = p.transform_mask(mask, minibatch_size=minibatch_size)
        return mask

    def output_type(self, input_type):
        for p in self.children:
            input_type = p.output_type(input_type)
        return input_type

    def to_dict(self):
        return {"type": self._type_name,
                "children": [p.to_dict() for p in self.children]}
