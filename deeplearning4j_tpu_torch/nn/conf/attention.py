"""Multi-head self-attention as a config-DSL layer (counterpart of the JAX
package's ``nn/conf/attention.py``).

This slice ports the full-sequence ``apply``. The streaming (K/V cache)
and paged decode paths come with the decode slices; their config fields
(``max_cache_t``, ``cache_overflow``) are kept so the JSON round-trips.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ... import dtypes as _dtypes
from ..weights import init_weights
from .inputs import InputType
from .layers import Layer, _full, register_layer


@register_layer("self_attention")
@dataclasses.dataclass
class SelfAttentionLayer(Layer):
    """Causal/bidirectional multi-head self-attention with output projection.

    Params: fused qkv projection ``Wqkv`` [n_in, 3·n_in], output projection
    ``Wo`` [n_in, n_out], bias ``b`` [n_out]. ``n_in`` must divide by
    ``n_heads``.

    The projected output goes through ``activation``, as in the reference;
    the builder fills in "sigmoid" for a layer that leaves it unset, so the
    transformer's attention output passes through a sigmoid. The port
    reproduces that reference behaviour exactly.
    """

    n_in: Optional[int] = None
    n_out: Optional[int] = None       # defaults to n_in
    n_heads: int = 4
    causal: bool = True
    max_cache_t: Optional[int] = None
    cache_overflow: str = "evict"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out or self.n_in,
                                   input_type.timesteps)

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_in is None or override:
            self.n_in = input_type.flat_size()
        if self.n_out is None:
            self.n_out = self.n_in
        if self.n_in % self.n_heads:
            raise ValueError(f"n_in={self.n_in} not divisible by "
                             f"n_heads={self.n_heads}")

    def preprocessor_for(self, input_type: InputType):
        if input_type.kind == "feedforward":
            return "FeedForwardToRnnPreProcessor"
        if input_type.kind == "convolutional":
            return "CnnToRnnPreProcessor"
        return None

    def param_shapes(self, policy=None) -> Dict[str, Tuple[int, ...]]:
        return {"Wqkv": (self.n_in, 3 * self.n_in),
                "Wo": (self.n_in, self.n_out), "b": (self.n_out,)}

    def regularized_params(self):
        return ("Wqkv", "Wo")

    def init_params(self, gen, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        wqkv = init_weights(gen, (self.n_in, 3 * self.n_in),
                            self.weight_init or "XAVIER", fan_in=self.n_in,
                            fan_out=self.n_in, distribution=self.dist,
                            dtype=dt, device=device)
        wo = init_weights(gen, (self.n_in, self.n_out),
                          self.weight_init or "XAVIER", fan_in=self.n_in,
                          fan_out=self.n_out, distribution=self.dist,
                          dtype=dt, device=device)
        return {"Wqkv": wqkv, "Wo": wo,
                "b": _full((self.n_out,), self.bias_init or 0.0, dt, device)}

    def apply(self, params, x, *, state=None, mask=None, policy=None):
        from ...ops.attention import dot_product_attention
        policy = policy or _dtypes.FLOAT32
        xc, wqkv = policy.cast_to_compute(x, params["Wqkv"])
        b, t, f = xc.shape
        h = self.n_heads
        qkv = torch.matmul(xc, wqkv).reshape(b, t, 3, h, f // h)
        # strided [b, t, h, d] views: the flash kernel reads them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        att = dot_product_attention(q, k, v, causal=self.causal, mask=mask)
        wo = params["Wo"].to(att.dtype)
        out = torch.matmul(att.reshape(b, t, f), wo) + params["b"].to(att.dtype)
        out = self._act(self.activation or "identity")(out)
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, state
