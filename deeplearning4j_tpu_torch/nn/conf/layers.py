"""Layer configurations and their forward functions (counterpart of the JAX
package's ``nn/conf/layers.py``).

Each config is a dataclass with the reference's fields, so its JSON is the
reference's JSON; the forward is a plain function of a parameter dict and
tensors::

    params       = conf.init_params(generator, policy, device)  # {name: tensor}
    state        = conf.init_state(policy, device)   # e.g. BN running stats
    y, new_state = conf.apply(params, x, state=..., train=..., generator=...,
                              mask=..., policy=...)

Output layers score through ``losses.py``. Dropout is applied to the
layer's INPUT in training, as in the reference, from the ``generator``
the runtime passes (a ``torch.Generator`` on the activations' device).
Recurrent layers live in ``recurrent.py``, attention in
``attention.py``, the MoE FFN in ``moe.py`` and the pretrain layers in
``pretrain.py``; all register here. A layer type no package registers
raises :class:`NotYetPorted`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Type

import torch

from ... import dtypes as _dtypes
from ...ops import common as _common
from ...ops import convops as _convops
from .. import activations as _activations
from ..weights import Distribution, init_weights
from .inputs import InputType
from .preprocessors import (CnnToFeedForwardPreProcessor,
                            FeedForwardToCnnPreProcessor,
                            FeedForwardToRnnPreProcessor,
                            RnnToFeedForwardPreProcessor)


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

    def preprocessor_for(self, input_type: InputType):
        """The input preprocessor this layer needs after ``input_type``
        (None = none); the builders insert it."""
        return None

    # ---- params and state ----
    def param_shapes(self, policy=None) -> Dict[str, Tuple[int, ...]]:
        return {}

    def init_params(self, gen, policy=None, device="cpu") -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self, policy=None, device="cpu") -> Dict[str, torch.Tensor]:
        """Persistent non-parameter state (BN running statistics)."""
        return {}

    def regularized_params(self) -> Tuple[str, ...]:
        """Params l1/l2 apply to (the reference's weights-only rule)."""
        return ("W",)

    # ---- forward ----
    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        raise NotImplementedError

    def _act(self, name_override=None):
        return _activations.get(name_override or self.activation or "sigmoid")

    def _dropout_in(self, x, train, generator):
        if train and (self.dropout or 0.0) > 0.0 and generator is not None:
            return _common.apply_dropout(generator, x, float(self.dropout),
                                         train)
        return x


def _full(shape, value, dtype, device):
    return torch.full(shape, float(value), dtype=dtype, device=device)


def _take_rows(w, x):
    """Rows of ``w`` at the integer ids ``x``. Ids may arrive as floats
    (the server parses JSON into float32); they are truncated to integers
    directly and never pass through the compute dtype. An out-of-range
    id must not reach the device gather, where it is a fatal device
    assert: as the reference's ``jnp.take``, ids in [-V, 0) wrap and any
    other out-of-range id gives a NaN row."""
    idx = x.to(torch.int64)
    vocab = w.shape[0]
    idx = torch.where(idx < 0, idx + vocab, idx)
    valid = (idx >= 0) & (idx < vocab)
    emb = w[idx.clamp(0, vocab - 1)]
    return torch.where(valid[..., None], emb, float("nan"))


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
            return RnnToFeedForwardPreProcessor()
        if input_type.kind == "convolutional":
            return CnnToFeedForwardPreProcessor(
                height=input_type.height, width=input_type.width,
                channels=input_type.channels)
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

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        x = self._dropout_in(x, train, generator)
        return self._act()(self.pre_output(params, x, policy=policy)), state


# --------------------------------------------------------------------------
# feed-forward layers
# --------------------------------------------------------------------------


@register_layer("dense")
@dataclasses.dataclass
class DenseLayer(FeedForwardLayer):
    """Fully-connected layer."""


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


@register_layer("output")
@dataclasses.dataclass
class OutputLayer(BaseOutputLayer):
    """Standard 2D output layer."""


@register_layer("rnn_output")
@dataclasses.dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Time-distributed output for [b, t, f] activations."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def preprocessor_for(self, input_type: InputType):
        if input_type.kind == "feedforward":
            return FeedForwardToRnnPreProcessor()
        return None

    def pre_output(self, params, x, *, policy=None):
        policy = policy or _dtypes.FLOAT32
        xc, wc = policy.cast_to_compute(x, params["W"])
        return torch.matmul(xc, wc) + params["b"].to(xc.dtype)


@register_layer("loss")
@dataclasses.dataclass
class LossLayer(Layer):
    """Parameter-free loss layer."""

    loss: str = "mse"

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        return self._act("identity" if self.activation is None
                         else self.activation)(x), state

    def pre_output(self, params, x, *, policy=None):
        return x

    def compute_score_array(self, params, x, labels, *, mask=None,
                            policy=None):
        from ... import losses as _losses
        return _losses.score_array(self.loss, labels, x,
                                   self.activation or "identity", mask)


@register_layer("activation")
@dataclasses.dataclass
class ActivationLayer(Layer):
    """Activation-only layer."""

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        x = self._dropout_in(x, train, generator)
        return self._act()(x), state


@register_layer("dropout")
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Standalone dropout layer."""

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        return self._dropout_in(x, train, generator), state


@register_layer("embedding")
@dataclasses.dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Embedding lookup: integer ids [b] or [b, 1] → [b, n_out] (W rows +
    bias + activation)."""

    has_bias: bool = True

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

    def pre_output(self, params, x, *, policy=None):
        policy = policy or _dtypes.FLOAT32
        if x.ndim == 2 and x.shape[-1] == 1:
            x = x[:, 0]
        emb = _take_rows(params["W"], x).to(policy.compute_dtype)
        if self.has_bias:
            emb = emb + params["b"].to(emb.dtype)
        return emb

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        z = self.pre_output(params, x, policy=policy)
        return self._act("identity" if self.activation is None
                         else self.activation)(z), state


@register_layer("embedding_sequence")
@dataclasses.dataclass
class EmbeddingSequenceLayer(FeedForwardLayer):
    """Token-id sequence embedding: ids [b, t] (or [b, t, 1]) → [b, t, n_out].

    ``n_in`` is the vocabulary size. The rows are gathered from the f32
    ``W`` and then cast to the compute dtype, as in the reference."""

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

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        policy = policy or _dtypes.FLOAT32
        if x.ndim == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        emb = _take_rows(params["W"], x).to(policy.compute_dtype)
        if self.has_bias:
            emb = emb + params["b"].to(emb.dtype)
        out = self._act("identity" if self.activation is None
                        else self.activation)(emb)
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, state


# --------------------------------------------------------------------------
# convolutional family (NHWC activations, HWIO weights)
# --------------------------------------------------------------------------


def _needs_cnn(input_type: InputType):
    if input_type.kind == "convolutional_flat":
        return FeedForwardToCnnPreProcessor(
            height=input_type.height, width=input_type.width,
            channels=input_type.channels)
    return None


def _spatial_out(layer, input_type, dilation=(1, 1)):
    h, w = input_type.height, input_type.width
    if layer.border_mode == "same":
        return -(-h // layer.stride[0]), -(-w // layer.stride[1])
    ph, pw = (0, 0) if layer.border_mode == "valid" else layer.padding
    return (_convops.conv_output_size(h, layer.kernel_size[0],
                                      layer.stride[0], ph, dilation[0]),
            _convops.conv_output_size(w, layer.kernel_size[1],
                                      layer.stride[1], pw, dilation[1]))


@register_layer("convolution")
@dataclasses.dataclass
class ConvolutionLayer(Layer):
    """2D convolution, NHWC activations and HWIO weights (cuDNN through
    ``ops.convops.conv2d``)."""

    n_in: Optional[int] = None      # input channels (inferred)
    n_out: Optional[int] = None     # filters
    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    border_mode: Optional[str] = None   # None=explicit pad | "same" | "valid"
    groups: int = 1
    has_bias: bool = True           # False for conv+BN pairs

    def __post_init__(self):
        # padding="same"/"valid" routes to border_mode, as in the reference
        if isinstance(self.padding, str):
            self.border_mode = self.padding
            self.padding = (0, 0)

    def _pad_arg(self):
        return self.border_mode if self.border_mode else tuple(self.padding)

    def output_type(self, input_type: InputType) -> InputType:
        oh, ow = _spatial_out(self, input_type, self.dilation)
        return InputType.convolutional(oh, ow, self.n_out)

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_in is None or override:
            self.n_in = input_type.channels

    def preprocessor_for(self, input_type: InputType):
        return _needs_cnn(input_type)

    def param_shapes(self, policy=None):
        kh, kw = self.kernel_size
        shapes = {"W": (kh, kw, self.n_in // self.groups, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        kh, kw = self.kernel_size
        w = init_weights(gen, (kh, kw, self.n_in // self.groups, self.n_out),
                         self.weight_init or "XAVIER",
                         fan_in=self.n_in * kh * kw,
                         fan_out=self.n_out * kh * kw,
                         distribution=self.dist, dtype=dt, device=device)
        params = {"W": w}
        if self.has_bias:
            params["b"] = _full((self.n_out,), self.bias_init or 0.0, dt,
                                device)
        return params

    def pre_output(self, params, x, *, policy=None):
        policy = policy or _dtypes.FLOAT32
        xc = policy.cast_to_compute(x)
        z = _convops.conv2d(xc, params["W"], self.stride, self._pad_arg(),
                            self.dilation, self.groups,
                            dtype=policy.compute_dtype)
        if self.has_bias:
            z = z + params["b"].to(z.dtype)
        return z

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        x = self._dropout_in(x, train, generator)
        return self._act()(self.pre_output(params, x, policy=policy)), state


@register_layer("subsampling")
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """Pooling: max, avg, sum or pnorm."""

    pooling_type: str = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    pnorm: int = 2
    border_mode: Optional[str] = None

    def output_type(self, input_type: InputType) -> InputType:
        oh, ow = _spatial_out(self, input_type)
        return InputType.convolutional(oh, ow, input_type.channels)

    def preprocessor_for(self, input_type: InputType):
        return _needs_cnn(input_type)

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        pad = self.border_mode if self.border_mode else tuple(self.padding)
        return _convops.pool2d(x, self.pooling_type, self.kernel_size,
                               self.stride, pad, self.pnorm), state


@register_layer("space_to_depth")
@dataclasses.dataclass
class SpaceToDepthLayer(Layer):
    """NHWC space-to-depth: [b, h, w, c] → [b, h/bs, w/bs, bs²·c], channel
    order (di, dj, c) over the bs×bs block — the reference's order, which
    ``models.resnet.fold_stem_7x7_to_s2d`` relies on."""

    block_size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        bs = self.block_size
        if input_type.height % bs or input_type.width % bs:
            raise ValueError(
                f"space_to_depth block {bs} does not divide "
                f"{input_type.height}x{input_type.width}")
        return InputType.convolutional(
            input_type.height // bs, input_type.width // bs,
            input_type.channels * bs * bs)

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        bs = self.block_size
        b, h, w, c = x.shape
        x = x.reshape(b, h // bs, bs, w // bs, bs, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h // bs, w // bs, bs * bs * c), state


@register_layer("batch_norm")
@dataclasses.dataclass
class BatchNormalization(Layer):
    """Batch normalization over the channel/feature (last) axis, on [b, f]
    and NHWC. The running mean and variance are layer state, updated in
    training as ``decay·old + (1 − decay)·batch`` (not PyTorch's
    ``momentum`` convention), the batch variance biased
    (``ops/batchnorm.py``)."""

    n_out: Optional[int] = None          # feature/channel count (inferred)
    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_out is None or override:
            if input_type.kind == "convolutional":
                self.n_out = input_type.channels
            else:
                self.n_out = input_type.flat_size()

    def preprocessor_for(self, input_type: InputType):
        return _needs_cnn(input_type)

    def regularized_params(self) -> Tuple[str, ...]:
        return ()

    def param_shapes(self, policy=None):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": (self.n_out,), "beta": (self.n_out,)}

    def init_params(self, gen, policy=None, device="cpu"):
        if self.lock_gamma_beta:
            return {}
        dt = (policy or _dtypes.FLOAT32).param_dtype
        return {"gamma": _full((self.n_out,), self.gamma, dt, device),
                "beta": _full((self.n_out,), self.beta, dt, device)}

    def init_state(self, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        return {"mean": torch.zeros((self.n_out,), dtype=dt, device=device),
                "var": torch.ones((self.n_out,), dtype=dt, device=device)}

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        from ...ops import batchnorm as _bn
        if not state:
            state = self.init_state(policy, x.device)
        # statistics in the state dtype (f32 under mixed_bf16); the
        # normalise-and-scale stays in the activation dtype
        stat = state["mean"].dtype
        if self.lock_gamma_beta:
            g = _full((x.shape[-1],), self.gamma, stat, x.device)
            b = _full((x.shape[-1],), self.beta, stat, x.device)
        else:
            g = params["gamma"].to(stat)
            b = params["beta"].to(stat)
        if train:
            y, mean, var = _bn.batch_norm_train(x, g, b, self.eps)
            return y, {"mean": self.decay * state["mean"]
                       + (1 - self.decay) * mean,
                       "var": self.decay * state["var"]
                       + (1 - self.decay) * var}
        return _bn.batch_norm_inference(x, g, b, state["mean"], state["var"],
                                        self.eps), state


@register_layer("layer_norm")
@dataclasses.dataclass
class LayerNormalization(Layer):
    """Layer normalization over the feature (last) axis. Stateless.

    Like the reference, ``apply`` never applies ``activation`` (the builder
    fills in "sigmoid", which the JSON then carries unused). It normalizes
    in at least f32 and returns the input dtype."""

    n_out: Optional[int] = None          # feature count (inferred)
    eps: float = 1e-5

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

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        cdt = _dtypes.promote_to_f32(x.dtype)
        xf = x.to(cdt)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * params["gamma"].to(cdt) + params["beta"].to(cdt)
        return y.to(x.dtype), state


@register_layer("lrn")
@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    """Cross-channel LRN (defaults n=5, k=2, alpha=1e-4, beta=0.75)."""

    n: int = 5
    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        return _convops.lrn(x, self.k, self.n, self.alpha, self.beta), state


@register_layer("global_pooling")
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial (NHWC) or time axes — max, avg, sum
    or pnorm — mask-aware for variable-length sequences."""

    pooling_type: str = "avg"
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "convolutional":
            return InputType.feed_forward(input_type.channels)
        return InputType.feed_forward(input_type.size)

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        if x.ndim == 4:      # NHWC -> [b, c]
            dims = (1, 2)
        elif x.ndim == 3:    # [b, t, f] -> [b, f]
            dims = (1,)
        else:
            return x, state
        kind = self.pooling_type.lower()
        if x.ndim == 3 and mask is not None:
            m = mask[..., None].to(x.dtype)
            if kind == "avg":
                s = torch.sum(x * m, dim=dims)
                return s / torch.clamp_min(torch.sum(m, dim=dims), 1.0), state
            if kind == "max":
                return torch.amax(torch.where(m > 0, x, float("-inf")),
                                  dim=dims), state
            if kind == "sum":
                return torch.sum(x * m, dim=dims), state
        if kind == "avg":
            return torch.mean(x, dim=dims), state
        if kind == "max":
            return torch.amax(x, dim=dims), state
        if kind == "sum":
            return torch.sum(x, dim=dims), state
        if kind == "pnorm":
            p = float(self.pnorm)
            if x.ndim == 3 and mask is not None:
                # masked timesteps do not contribute to the p-norm
                x = x * mask[..., None].to(x.dtype)
            return torch.sum(torch.abs(x) ** p, dim=dims) ** (1.0 / p), state
        raise ValueError(f"unknown pooling type {kind!r}")
