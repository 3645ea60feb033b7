"""The layers of a hybrid conv/attention LM with sparse experts (Liquid
AI's LFM2 family, ``models/lfm2.py``), as registered config-DSL layers.
The port's own: the JAX package has none of them, and
``SelfAttentionLayer``, ``MoELayer`` and their JSON are untouched.

* :class:`RMSNormalization` — ``x / √(mean(x²) + eps) · gamma``;
* :class:`SwiGLUFeedForwardLayer` — ``W₂(silu(W₁x) ⊙ W₃x)``, no biases;
* :class:`GatedShortConvLayer` — ``W_out(C ⊙ conv(B ⊙ x))`` with ``B, C,
  x`` the thirds of ``W_in·x`` and a causal depthwise conv of length
  ``conv_l`` (``ops/short_conv.py``);
* :class:`GroupedQueryAttentionLayer` — separate q/k/v/o projections,
  ``n_kv_heads`` K/V heads shared by groups of query heads, per-head
  RMSNorm of q and k, rotary positions, causal softmax attention through
  ``ops.attention.dot_product_attention`` with K/V repeated to the query
  heads (the flash kernels take equal shapes);
* :class:`SparseMoELayer` — sigmoid routing over all ``n_experts``, the
  top ``top_k`` of score plus a selection bias (layer state, moved after
  each training step by ``b_e += rate·sign(mean load − load_e)`` over the
  held experts, never by the updater), SwiGLU experts without biases, of
  which this chip holds ``experts_held`` from ``first_expert`` on: it
  routes over all and computes the held experts' part
  (``ops/moe_dispatch.py``, the routed dropless dispatch).

Activations are ``[b, t, f]``; products run in the policy's compute dtype,
norms, routing and the conv's arithmetic in at least f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ... import dtypes as _dtypes
from ...ops import moe_dispatch as _moe
from ...ops.norms import rms_norm
from ...ops.rotary import apply_rotary
from ...ops.short_conv import gated_short_conv
from ...util import metrics as _metrics
from ..weights import init_weights
from .inputs import InputType
from .layers import Layer, register_layer


@dataclasses.dataclass
class _SequenceLayer(Layer):
    """A ``[b, t, n_in]`` → ``[b, t, n_out]`` layer; ``n_out`` defaults to
    ``n_in``."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out or self.n_in,
                                   input_type.timesteps)

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_in is None or override:
            self.n_in = input_type.size
        if self.n_out is None:
            self.n_out = self.n_in

    def regularized_params(self) -> Tuple[str, ...]:
        return tuple(k for k in self.param_shapes() if k.startswith("W"))

    def init_params(self, gen, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        out = {}
        for k, shape in self.param_shapes(policy).items():
            if k in self._ones:
                out[k] = torch.ones(shape, dtype=dt, device=device)
            else:
                # W13 holds two matrices of half its width side by side
                fan_out = shape[-1] // (2 if k == "W13" else 1)
                out[k] = init_weights(
                    gen, shape, self.weight_init or "XAVIER",
                    fan_in=shape[-2], fan_out=fan_out,
                    distribution=self.dist, dtype=dt, device=device)
        return out

    # leaves that start at 1 (norm weights); every other is a matrix
    _ones = ()


@register_layer("rms_norm")
@dataclasses.dataclass
class RMSNormalization(Layer):
    """RMSNorm over the feature (last) axis: ``gamma [n_out]``, starting at
    1. Stateless; ``activation`` is never applied."""

    n_out: Optional[int] = None
    eps: float = 1e-5

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_out is None or override:
            self.n_out = (input_type.size if input_type.kind == "recurrent"
                          else input_type.flat_size())

    def param_shapes(self, policy=None):
        return {"gamma": (self.n_out,)}

    def regularized_params(self) -> Tuple[str, ...]:
        return ()

    def init_params(self, gen, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        return {"gamma": torch.ones((self.n_out,), dtype=dt, device=device)}

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        return rms_norm(x, params["gamma"], self.eps), state


@register_layer("swiglu_ffn")
@dataclasses.dataclass
class SwiGLUFeedForwardLayer(_SequenceLayer):
    """``W₂(silu(W₁x) ⊙ W₃x)``: ``W13 [n_in, 2·d_hidden]`` (W₁ and W₃ side
    by side), ``W2 [d_hidden, n_out]``, no biases."""

    d_hidden: int = 1024

    def param_shapes(self, policy=None):
        return {"W13": (self.n_in, 2 * self.d_hidden),
                "W2": (self.d_hidden, self.n_out)}

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        policy = policy or _dtypes.FLOAT32
        xc = policy.cast_to_compute(self._dropout_in(x, train, generator))
        dt = xc.dtype
        a = _moe.SwiGLU.apply(torch.matmul(xc, params["W13"].to(dt)))
        return torch.matmul(a, params["W2"].to(dt)), state


@register_layer("gated_short_conv")
@dataclasses.dataclass
class GatedShortConvLayer(_SequenceLayer):
    """``W_out(C ⊙ conv(B ⊙ x))``: ``W_in [n_in, 3·n_in]`` (B, C, x in that
    order), ``conv [n_in, conv_l]`` (``conv[:, -1]`` weighs the current
    step), ``W_out [n_in, n_out]``, no biases. Causal: step t reads steps
    ≤ t. A decode would carry the last ``conv_l − 1`` gated inputs per
    sequence, which no cache of the port holds. Each forward counts
    ``shortconv_calls_total{model=<name>, path}`` (``ops/short_conv.py``)."""

    conv_l: int = 3

    def param_shapes(self, policy=None):
        return {"W_in": (self.n_in, 3 * self.n_in),
                "conv": (self.n_in, self.conv_l),
                "W_out": (self.n_in, self.n_out)}

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        policy = policy or _dtypes.FLOAT32
        xc = policy.cast_to_compute(self._dropout_in(x, train, generator))
        dt = xc.dtype
        bcx = torch.matmul(xc, params["W_in"].to(dt))
        y = gated_short_conv(bcx, params["conv"],
                             self.name or "gated_short_conv")
        out = torch.matmul(y, params["W_out"].to(dt))
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, state


@register_layer("gqa_attention")
@dataclasses.dataclass
class GroupedQueryAttentionLayer(_SequenceLayer):
    """Causal grouped-query attention: ``Wq [n_in, n_heads·head_dim]``,
    ``Wk``/``Wv [n_in, n_kv_heads·head_dim]``, ``Wo [n_heads·head_dim,
    n_out]``, per-head RMSNorm weights ``q_norm``/``k_norm [head_dim]``
    (eps ``norm_eps``), rotary positions (base ``rope_theta``) on q and k,
    scale ``1/√head_dim``, no biases; ``head_dim = n_in / n_heads``. Query
    head i reads K/V head ``i // (n_heads / n_kv_heads)``."""

    n_heads: int = 4
    n_kv_heads: int = 4
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    _ones = ("q_norm", "k_norm")

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        super().set_n_in(input_type, override)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")
        if self.n_in % self.n_heads:
            raise ValueError(f"n_in={self.n_in} not divisible by "
                             f"n_heads={self.n_heads}")

    @property
    def head_dim(self) -> int:
        return self.n_in // self.n_heads

    def param_shapes(self, policy=None):
        q, kv = self.n_in, self.n_kv_heads * self.head_dim
        return {"Wq": (self.n_in, q), "Wk": (self.n_in, kv),
                "Wv": (self.n_in, kv), "Wo": (q, self.n_out),
                "q_norm": (self.head_dim,), "k_norm": (self.head_dim,)}

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        from ...ops.attention import dot_product_attention
        policy = policy or _dtypes.FLOAT32
        xc = policy.cast_to_compute(self._dropout_in(x, train, generator))
        dt = xc.dtype
        b, t, _ = xc.shape
        h, kvh, dh = self.n_heads, self.n_kv_heads, self.head_dim

        def project(name, heads):
            return torch.matmul(xc, params[name].to(dt)).view(b, t, heads, dh)

        q = apply_rotary(rms_norm(project("Wq", h), params["q_norm"],
                                  self.norm_eps), self.rope_theta)
        k = apply_rotary(rms_norm(project("Wk", kvh), params["k_norm"],
                                  self.norm_eps), self.rope_theta)
        v = project("Wv", kvh)
        if kvh != h:
            k = k.repeat_interleave(h // kvh, dim=2)
            v = v.repeat_interleave(h // kvh, dim=2)
        att = dot_product_attention(q, k, v, causal=True, mask=mask)
        out = torch.matmul(att.reshape(b, t, h * dh), params["Wo"].to(dt))
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, state


def assignments_counter(registry=None) -> _metrics.Counter:
    return (registry or _metrics.REGISTRY).counter(
        "moe_assignments_total",
        "Token-to-expert assignments routed by sparse MoE layers: those of "
        "the experts this chip holds (held, computed) and of the rest "
        "(absent); counted on the device, folded in when read",
        ("model", "path"))


@register_layer("sparse_moe")
@dataclasses.dataclass
class SparseMoELayer(_SequenceLayer):
    """Sparse mixture of SwiGLU experts with sigmoid routing and a
    selection bias, holding experts ``first_expert … first_expert +
    experts_held − 1`` of ``n_experts`` (all when ``experts_held`` is
    None).

    Params: ``router [n_in, n_experts]``; per held expert ``W13 [held,
    n_in, 2·d_hidden]`` (W₁ and W₃ side by side) and ``W2 [held,
    d_hidden, n_out]``. State:
    the selection ``bias [n_experts]``, 0 at start. The output is the held
    experts' part of ``Σ_{e ∈ top_k} w_e · SwiGLU_e(x)``, ``w`` the chosen
    sigmoid scores normalised to sum 1 (+1e-6) times ``routed_scaling``;
    assignments to experts held elsewhere add nothing here. No auxiliary
    loss. Each training forward moves the held experts' bias entries by
    ``bias_update_rate · sign(mean load − load)`` over their loads in the
    batch, and counts ``moe_assignments_total{model=<name>, path}``."""

    d_hidden: int = 1024
    n_experts: int = 8
    top_k: int = 2
    experts_held: Optional[int] = None
    first_expert: int = 0
    routed_scaling: float = 1.0
    bias_update_rate: float = 1e-3

    @property
    def held(self) -> int:
        return self.n_experts if self.experts_held is None \
            else self.experts_held

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        super().set_n_in(input_type, override)
        if self.top_k > self.n_experts:
            raise ValueError(f"top_k={self.top_k} > "
                             f"n_experts={self.n_experts}")
        if not 0 <= self.first_expert < self.first_expert + self.held \
                <= self.n_experts:
            raise ValueError(
                f"experts {self.first_expert} … {self.first_expert + self.held - 1}"
                f" are not among the layer's {self.n_experts}")

    def param_shapes(self, policy=None):
        e, h = self.held, self.d_hidden
        return {"router": (self.n_in, self.n_experts),
                "W13": (e, self.n_in, 2 * h), "W2": (e, h, self.n_out)}

    def init_state(self, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        return {"bias": torch.zeros((self.n_experts,), dtype=dt,
                                    device=device)}

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        if mask is not None:
            raise ValueError("SparseMoELayer takes no mask: padded tokens "
                             "would be routed and counted in the loads")
        policy = policy or _dtypes.FLOAT32
        xc = policy.cast_to_compute(self._dropout_in(x, train, generator))
        b, t, d = xc.shape
        bias = (state or {}).get("bias")
        if bias is None:
            bias = self.init_state(policy, xc.device)["bias"]
        y, plan = _moe.sparse_moe(
            xc.reshape(b * t, d), params["router"], bias, params["W13"],
            params["W2"], top_k=self.top_k,
            first=self.first_expert, scaling=self.routed_scaling)
        counter = assignments_counter()
        label = self.name or "sparse_moe"
        held = plan.ends[-1:]
        counter.inc_device(held, model=label, path="held")
        counter.inc_device(plan.order.shape[0] - held, model=label,
                           path="absent")
        if train:
            loads = plan.loads.to(bias.dtype)
            step = self.bias_update_rate * torch.sign(loads.mean() - loads)
            lo, hi = self.first_expert, self.first_expert + self.held
            bias = torch.cat([bias[:lo], bias[lo:hi] + step, bias[hi:]])
        return y.view(b, t, self.n_out), {"bias": bias}
