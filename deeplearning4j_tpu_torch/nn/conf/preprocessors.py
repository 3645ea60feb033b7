"""Input preprocessors: shape adapters inserted between layer families
(counterpart of the JAX package's ``nn/conf/preprocessors.py``; the same
classes, fields and JSON).

Each is a reshape or a normalisation of the forward activations;
autograd derives the backward. ``transform_mask`` carries a mask through
the same reshape. CNN activations are NHWC, so CnnToFeedForward flattens
in (h, w, c) order, as the reference does.

Ported: CnnToFeedForward, FeedForwardToCnn, RnnToFeedForward,
FeedForwardToRnn, CnnToRnn, RnnToCnn, Reshape, ZeroMean, UnitVariance and
ZeroMeanAndUnitVariance. The reference's BinomialSampling and Composable
preprocessors raise :class:`NotYetPorted` when a configuration names
them.
"""

from __future__ import annotations

import dataclasses
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
