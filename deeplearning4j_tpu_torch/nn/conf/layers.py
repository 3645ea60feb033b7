"""Layer configurations and their forward functions (counterpart of the JAX
package's ``nn/conf/layers.py``).

Each config is a dataclass with the reference's fields, so its JSON is the
reference's JSON; the forward is a plain function of a parameter dict and
tensors::

    params       = conf.init_params(generator, policy, device)  # {name: tensor}
    y, state     = conf.apply(params, x, state=..., mask=..., policy=...)

The port has the layers of the transformer-LM path, for inference and
training (output layers score through ``losses.py``). Any other layer
type found in a configuration raises :class:`NotYetPorted` naming the
type, and so does training a layer whose ``dropout`` is above 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Type

import torch

from ... import dtypes as _dtypes
from .. import activations as _activations
from ..weights import Distribution, init_weights
from .inputs import InputType


class NotYetPorted(NotImplementedError):
    """A configuration names a layer, vertex or preprocessor that the
    PyTorch port does not have yet."""


LAYER_REGISTRY: Dict[str, Type["Layer"]] = {}


def register_layer(name: str):
    def deco(cls):
        cls._type_name = name
        LAYER_REGISTRY[name] = cls
        return cls
    return deco


def layer_to_dict(layer: "Layer") -> dict:
    d = {"type": layer._type_name}
    for f in dataclasses.fields(layer):
        v = getattr(layer, f.name)
        if isinstance(v, Distribution):
            v = v.to_dict()
        elif isinstance(v, tuple):
            v = list(v)
        d[f.name] = v
    return d


def layer_from_dict(d: dict) -> "Layer":
    d = dict(d)
    typ = d.pop("type")
    cls = LAYER_REGISTRY.get(typ)
    if cls is None:
        raise NotYetPorted(f"layer type {typ!r} is not yet ported to the "
                           "PyTorch package")
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in field_map:
            continue
        if k == "dist" and isinstance(v, dict):
            v = Distribution.from_dict(v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


# --------------------------------------------------------------------------
# base classes
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Layer:
    """Base layer config. Fields left as None inherit the builder's global
    defaults (activation "sigmoid", weight_init "XAVIER", ...)."""

    name: Optional[str] = None
    activation: Optional[str] = None          # default "sigmoid" via builder
    weight_init: Optional[str] = None         # default "XAVIER" via builder
    bias_init: Optional[float] = None         # default 0.0
    dist: Optional[Distribution] = None
    dropout: Optional[float] = None           # drop probability (0 disables)
    l1: Optional[float] = None
    l2: Optional[float] = None
    learning_rate: Optional[float] = None     # per-layer LR override
    bias_learning_rate: Optional[float] = None

    _type_name = "base"

    # ---- shape inference ----
    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        pass

    def preprocessor_for(self, input_type: InputType) -> Optional[str]:
        """Name of the reference preprocessor this layer would insert for
        ``input_type`` (None = none needed). Preprocessors are not ported
        yet, so the builder refuses any non-None answer."""
        return None

    # ---- params ----
    def param_shapes(self, policy=None) -> Dict[str, Tuple[int, ...]]:
        return {}

    def init_params(self, gen, policy=None, device="cpu") -> Dict[str, torch.Tensor]:
        return {}

    def regularized_params(self) -> Tuple[str, ...]:
        """Params l1/l2 apply to (the reference's weights-only rule)."""
        return ("W",)

    # ---- forward ----
    def apply(self, params, x, *, state=None, mask=None, policy=None):
        raise NotImplementedError

    def _act(self, name_override=None):
        return _activations.get(name_override or self.activation or "sigmoid")


def _full(shape, value, dtype, device):
    return torch.full(shape, float(value), dtype=dtype, device=device)


@dataclasses.dataclass
class FeedForwardLayer(Layer):
    """Base for layers with [n_in, n_out] dense weights."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_in is None or override:
            self.n_in = input_type.flat_size()

    def preprocessor_for(self, input_type: InputType):
        if input_type.kind == "recurrent":
            return "RnnToFeedForwardPreProcessor"
        if input_type.kind == "convolutional":
            return "CnnToFeedForwardPreProcessor"
        return None

    def param_shapes(self, policy=None):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    def init_params(self, gen, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        w = init_weights(gen, (self.n_in, self.n_out),
                         self.weight_init or "XAVIER", fan_in=self.n_in,
                         fan_out=self.n_out, distribution=self.dist,
                         dtype=dt, device=device)
        return {"W": w, "b": _full((self.n_out,), self.bias_init or 0.0, dt,
                                   device)}

    def pre_output(self, params, x, *, policy=None):
        policy = policy or _dtypes.FLOAT32
        xc, wc = policy.cast_to_compute(x, params["W"])
        return xc @ wc + params["b"].to(xc.dtype)

    def apply(self, params, x, *, state=None, mask=None, policy=None):
        return self._act()(self.pre_output(params, x, policy=policy)), state


@dataclasses.dataclass
class BaseOutputLayer(FeedForwardLayer):
    """Output layer with a loss function."""

    loss: str = "negativeloglikelihood"

    def compute_score_array(self, params, x, labels, *, mask=None,
                            policy=None):
        """Per-example loss from the hidden input ``x`` (the pre-output is
        scored fused with the activation, as in the reference)."""
        from ... import losses as _losses
        pre = self.pre_output(params, x, policy=policy)
        return _losses.score_array(self.loss, labels, pre,
                                   self.activation or "sigmoid", mask)


@register_layer("rnn_output")
@dataclasses.dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Time-distributed output for [b, t, f] activations."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def preprocessor_for(self, input_type: InputType):
        if input_type.kind == "feedforward":
            return "FeedForwardToRnnPreProcessor"
        return None

    def pre_output(self, params, x, *, policy=None):
        policy = policy or _dtypes.FLOAT32
        xc, wc = policy.cast_to_compute(x, params["W"])
        return torch.matmul(xc, wc) + params["b"].to(xc.dtype)


@register_layer("embedding_sequence")
@dataclasses.dataclass
class EmbeddingSequenceLayer(FeedForwardLayer):
    """Token-id sequence embedding: ids [b, t] (or [b, t, 1]) → [b, t, n_out].

    ``n_in`` is the vocabulary size. Ids may arrive as floats (the server
    parses JSON into float32); they are truncated to integers directly and
    never pass through the compute dtype (bf16 rounds ids past 256). The
    rows are gathered from the f32 ``W`` and then cast to the compute
    dtype, as in the reference."""

    has_bias: bool = False

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_in is None:
            raise ValueError(
                "EmbeddingSequenceLayer needs n_in=<vocab size> set "
                "explicitly — the [b, t] id input has no feature dim to "
                "infer it from")

    def preprocessor_for(self, input_type: InputType):
        return None     # ids are consumed raw — never reshaped/cast

    def param_shapes(self, policy=None):
        shapes = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen, policy=None, device="cpu"):
        params = super().init_params(gen, policy, device)
        if not self.has_bias:
            params.pop("b", None)
        return params

    def apply(self, params, x, *, state=None, mask=None, policy=None):
        policy = policy or _dtypes.FLOAT32
        idx = x.to(torch.int64)
        if idx.ndim == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        # ids come from outside (a /predict body): an out-of-range index
        # must not reach the device gather, where it is a fatal device
        # assert. Same result as the reference's jnp.take: ids in [-V, 0)
        # wrap, any other out-of-range id gives a NaN row.
        w = params["W"]
        vocab = w.shape[0]
        idx = torch.where(idx < 0, idx + vocab, idx)
        valid = (idx >= 0) & (idx < vocab)
        emb = w[idx.clamp(0, vocab - 1)]
        emb = torch.where(valid[..., None], emb, float("nan"))
        emb = emb.to(policy.compute_dtype)
        if self.has_bias:
            emb = emb + params["b"].to(emb.dtype)
        out = self._act("identity" if self.activation is None
                        else self.activation)(emb)
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, state


@register_layer("layer_norm")
@dataclasses.dataclass
class LayerNormalization(Layer):
    """Layer normalization over the feature (last) axis. Stateless.

    Like the reference, ``apply`` never applies ``activation`` (the builder
    fills in "sigmoid", which the JSON then carries unused). It normalizes
    in at least f32 and returns the input dtype."""

    n_out: Optional[int] = None          # feature count (inferred)
    eps: float = 1e-5

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_out is None or override:
            if input_type.kind == "convolutional":
                self.n_out = input_type.channels
            else:
                self.n_out = (input_type.size
                              if input_type.kind == "recurrent"
                              else input_type.flat_size())

    def param_shapes(self, policy=None):
        return {"gamma": (self.n_out,), "beta": (self.n_out,)}

    def regularized_params(self) -> Tuple[str, ...]:
        return ()

    def init_params(self, gen, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        return {"gamma": torch.ones((self.n_out,), dtype=dt, device=device),
                "beta": torch.zeros((self.n_out,), dtype=dt, device=device)}

    def apply(self, params, x, *, state=None, mask=None, policy=None):
        cdt = _dtypes.promote_to_f32(x.dtype)
        xf = x.to(cdt)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * params["gamma"].to(cdt) + params["beta"].to(cdt)
        return y.to(x.dtype), state
