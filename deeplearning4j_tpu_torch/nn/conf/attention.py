"""Multi-head self-attention as a config-DSL layer (counterpart of the JAX
package's ``nn/conf/attention.py``).

Three forward paths, as in the reference:

- ``apply``: the full-sequence forward (the flash kernel or dense
  attention, ``ops.attention``);
- the streaming path (``rnn_time_step``), taken when ``state`` carries a
  K/V cache ``"h"``/``"c"``: the new chunk's K/V is appended to a dense
  ``[b, max_cache_t, f]`` cache and the new queries attend over it, with
  chunk-granular sliding eviction past the window (positions stay
  global). The reference keeps the write position in an extra in-band
  row of the cache; the port keeps it on the host, as ``state["pos"]``;
- ``apply_paged``: the serving engine's decode step over the paged K/V
  pools (``ops.paged_attention``).

The decode attention is plain PyTorch, as the reference's is plain XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ... import dtypes as _dtypes
from ..weights import init_weights
from .inputs import InputType
from .layers import Layer, _full, register_layer
from .preprocessors import CnnToRnnPreProcessor, FeedForwardToRnnPreProcessor


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
            return FeedForwardToRnnPreProcessor()
        if input_type.kind == "convolutional":
            return CnnToRnnPreProcessor(height=input_type.height,
                                        width=input_type.width,
                                        channels=input_type.channels)
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

    def _zero_state(self, batch, policy, device="cpu"):
        """The streaming K/V cache (only when ``max_cache_t`` is set):
        ``{"h": K, "c": V, "pos": 0}`` with K/V ``[batch, max_cache_t,
        n_in]`` zeros in at least f32 (``promote_types(compute, f32)``, as
        the reference) and ``pos`` the number of fed positions."""
        if self.max_cache_t is None:
            raise ValueError(
                "SelfAttentionLayer streaming needs max_cache_t set")
        if self.cache_overflow not in ("evict", "strict"):
            raise ValueError(
                f"cache_overflow={self.cache_overflow!r} — expected "
                "'evict' or 'strict'")
        if not self.causal:
            raise ValueError(
                "SelfAttentionLayer streaming decode requires causal=True "
                "(incremental decode of bidirectional attention is "
                "ill-defined — later tokens would change earlier outputs)")
        dt = _dtypes.promote_to_f32((policy or _dtypes.FLOAT32).compute_dtype)
        shape = (batch, self.max_cache_t, self.n_in)
        return {"h": torch.zeros(shape, dtype=dt, device=device),
                "c": torch.zeros(shape, dtype=dt, device=device), "pos": 0}

    def _project_qkv(self, params, xc):
        b, t, f = xc.shape
        h = self.n_heads
        qkv = torch.matmul(xc, params["Wqkv"].to(xc.dtype)).reshape(
            b, t, 3, h, f // h)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _project_out(self, params, att):
        b, t = att.shape[:2]
        out = torch.matmul(att.reshape(b, t, -1), params["Wo"].to(att.dtype))
        out = out + params["b"].to(att.dtype)
        return self._act(self.activation or "identity")(out)

    def _apply_streaming(self, params, xc, state):
        """Incremental decode: write this chunk's K/V into the cache and
        attend the new queries over everything cached (causal across
        calls).

        Overflow is sliding-window EVICTION, chunk-granular as in the
        reference: the whole chunk's worth of old positions is evicted
        before any of its queries attend, so token-by-token feeding gives
        the exact per-token window. The roll runs only on calls that
        evict (a host branch on the host-side position). The cache is
        updated in place; the returned state holds the advanced
        position."""
        b, t_new, f = xc.shape
        h = self.n_heads
        max_t = self.max_cache_t
        if t_new > max_t:
            raise ValueError(
                f"streaming chunk of {t_new} steps exceeds "
                f"max_cache_t={max_t}; raise max_cache_t or feed smaller "
                "chunks")
        q, k_new, v_new = self._project_qkv(params, xc)
        k_cache, v_cache, pos = state["h"], state["c"], int(state["pos"])
        # cache slot j holds global position base + j; this call may
        # advance base (evict) so the t_new new tokens fit at the end
        old_base = max(pos - max_t, 0)
        new_base = max(pos + t_new - max_t, 0)
        shift = new_base - old_base
        write_pos = pos - new_base
        if shift > 0:
            k_cache = torch.roll(k_cache, -shift, dims=1)
            v_cache = torch.roll(v_cache, -shift, dims=1)
        k_cache[:, write_pos:write_pos + t_new] = \
            k_new.reshape(b, t_new, f).to(k_cache.dtype)
        v_cache[:, write_pos:write_pos + t_new] = \
            v_new.reshape(b, t_new, f).to(v_cache.dtype)
        kh = k_cache.view(b, max_t, h, f // h)
        vh = v_cache.view(b, max_t, h, f // h)
        q_idx = write_pos + torch.arange(t_new, device=xc.device)
        allow = (torch.arange(max_t, device=xc.device)[None, :]
                 <= q_idx[:, None])                      # [t_new, max_t]
        att = causal_cache_attention(q, kh, vh, allow[None, None],
                                     attention_scale(f // h, xc.dtype))
        out = self._project_out(params, att)
        return out, {"h": k_cache, "c": v_cache, "pos": pos + t_new}

    def apply_paged(self, params, x, k_pool, v_pool, page_table,
                    write_slots, rel_pos, *, policy=None):
        """Paged-arena decode (the serving continuous-batching path): K/V
        live in shared ``[pages, page_size, h, d]`` pools and each lane's
        page table reassembles its window by gather; the math is the
        streaming path's. Sliding-window overflow is page eviction, done
        on the host by the serving engine.

        x ``[S, t_new, f]``; write_slots ``[S, t_new]`` view-relative
        slots (-1 = dropped); rel_pos ``[S]`` view-relative position of
        the first new query. The pools are written in place; returns
        ``(out, k_pool, v_pool)``."""
        from ...ops.paged_attention import (paged_attention, paged_gather,
                                            paged_write)
        policy = policy or _dtypes.FLOAT32
        xc = policy.cast_to_compute(x)
        f = xc.shape[-1]
        q, k_new, v_new = self._project_qkv(params, xc)
        paged_write(k_pool, k_new, page_table, write_slots)
        paged_write(v_pool, v_new, page_table, write_slots)
        kh = paged_gather(k_pool, page_table)
        vh = paged_gather(v_pool, page_table)
        att = paged_attention(q, kh, vh, rel_pos,
                              attention_scale(f // self.n_heads, xc.dtype))
        return self._project_out(params, att), k_pool, v_pool

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        from ...ops.attention import dot_product_attention
        policy = policy or _dtypes.FLOAT32
        x = self._dropout_in(x, train, generator)
        if (not train and mask is None and self.max_cache_t is not None
                and state is not None and "h" in state):
            # streaming decode with the carried K/V cache (rnn_time_step)
            return self._apply_streaming(params, policy.cast_to_compute(x),
                                         state)
        # strided [b, t, h, d] views: the flash kernel reads them in place
        q, k, v = self._project_qkv(params, policy.cast_to_compute(x))
        att = dot_product_attention(q, k, v, causal=self.causal, mask=mask)
        out = self._project_out(params, att)
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out, state


def attention_scale(d: int, dtype) -> torch.Tensor:
    """``1/sqrt(d)`` in the compute dtype, as the reference computes it
    (``1.0 / jnp.sqrt(d).astype(compute)``): a 0-dim tensor, so a product
    with f32 logits stays f32."""
    return 1.0 / torch.tensor(math.sqrt(d), dtype=dtype)


def causal_cache_attention(q, kh, vh, allow, scale):
    """The decode softmax attention of the reference's streaming and paged
    paths, term for term: f32 logits masked by ``allow`` (broadcast to
    ``[S, h, t_new, W]``), max-subtracted exp, a 1e-30 floor on the
    denominator, and the weights rounded to q's (compute) dtype before the
    product with V. q ``[S, t_new, h, d]`` in the compute dtype, kh/vh
    ``[S, W, h, d]`` in the cache dtype; the output ``[S, t_new, h, d]``
    is in ``promote_types(compute, cache)`` (f32 under mixed_bf16)."""
    ct = torch.promote_types(q.dtype, kh.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), kh.to(ct)) * scale
    logits = torch.where(allow, logits.float(), float("-inf"))
    m = logits.max(dim=-1, keepdim=True).values
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(torch.isneginf(logits), 0.0, torch.exp(logits - m_safe))
    weights = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    ct = torch.promote_types(q.dtype, vh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype).to(ct),
                        vh.to(ct))
