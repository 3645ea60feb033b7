"""Recurrent-family layer configs (counterpart of the JAX package's
``nn/conf/recurrent.py``). This slice ports the one the transformer uses,
``TimeDistributedDenseLayer``; the LSTMs come with a later slice."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ... import dtypes as _dtypes
from ..weights import init_weights
from .inputs import InputType
from .layers import Layer, _full, register_layer


@dataclasses.dataclass
class BaseRecurrentLayer(Layer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_in is None or override:
            self.n_in = input_type.flat_size()

    def preprocessor_for(self, input_type: InputType):
        if input_type.kind == "feedforward":
            return "FeedForwardToRnnPreProcessor"
        if input_type.kind == "convolutional":
            return "CnnToRnnPreProcessor"
        return None


@register_layer("time_distributed_dense")
@dataclasses.dataclass
class TimeDistributedDenseLayer(BaseRecurrentLayer):
    """Dense applied independently at every timestep:
    [b, t, n_in] → [b, t, n_out]."""

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

    def apply(self, params, x, *, state=None, mask=None, policy=None):
        policy = policy or _dtypes.FLOAT32
        xc, wc = policy.cast_to_compute(x, params["W"])
        z = torch.matmul(xc, wc) + params["b"].to(xc.dtype)
        return self._act()(z), state
