"""Mixture-of-experts FFN as a config-DSL layer (counterpart of the JAX
package's ``nn/conf/moe.py``; the same JSON fields and parameters).

Dense dispatch, as the reference: every expert computes every token and
the top-k gates zero the rest, so every shape is static — what the decode
engine's captured CUDA graphs need (no ``nonzero``, no host read, no
data-dependent shape). The experts' two matmuls run as two wide GEMMs
over the experts side by side: ``x [bt, d] @ w1 [d, E·h]``, the hidden
scaled by each token's gate weight, then ``[bt, E·h] @ w2 [E·h, d]`` —
the reference's ``Σ_e w_e (relu(x W1_e + b1_e) W2_e + b2_e)`` with the sum
over experts folded into the second GEMM's reduction.

Routing runs at least in f32 (f64 under the float64 policy, for the
gradient check), from router logits computed in the compute dtype. The
keep mask takes the top ``top_k`` gates with ``lax.top_k``'s tie rule —
among equal gates the lowest expert index wins — by a rank count, so
exactly ``top_k`` experts fire even when all gates are equal.

The Shazeer-style load-balancing loss ``aux_weight · E · Σ_e gate_frac_e ·
keep_frac_e`` travels in the returned state under ``"aux_loss"``; both
network runtimes add such entries to the training objective and never
persist them. Masked tokens give zero output and stay out of the aux
statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ... import dtypes as _dtypes
from ..weights import init_weights
from .inputs import InputType
from .layers import Layer, register_layer


def topk_keep(gates: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the ``k`` largest entries along the last axis,
    ties going to the lower index (``lax.top_k``'s order): entry ``e``
    is kept when fewer than ``k`` entries outrank it, where ``j`` outranks
    ``e`` if ``g_j > g_e``, or ``g_j == g_e`` and ``j < e``."""
    e = gates.shape[-1]
    gi = gates.unsqueeze(-1)                    # [..., E(e), 1]
    gj = gates.unsqueeze(-2)                    # [..., 1, E(j)]
    idx = torch.arange(e, device=gates.device)
    lower = idx[None, :] < idx[:, None]         # [e, j]: j < e
    outranks = (gj > gi) | ((gj == gi) & lower)
    return outranks.sum(-1) < k


@register_layer("moe")
@dataclasses.dataclass
class MoELayer(Layer):
    """Top-k routed mixture-of-experts FFN: [b, t, f] → [b, t, f] (or
    [b, f] → [b, f]).

    Params: ``router`` [n_in, E], expert-stacked ``w1`` [E, n_in,
    d_hidden], ``b1`` [E, d_hidden], ``w2`` [E, d_hidden, n_out], ``b2``
    [E, n_out]."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None          # defaults to n_in
    d_hidden: int = 256
    n_experts: int = 8
    top_k: int = 2
    aux_weight: float = 0.01

    def output_type(self, input_type: InputType) -> InputType:
        n = self.n_out or self.n_in
        if input_type.kind == "recurrent":
            return InputType.recurrent(n, input_type.timesteps)
        return InputType.feed_forward(n)

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_in is None or override:
            self.n_in = input_type.flat_size()
        if self.n_out is None:
            self.n_out = self.n_in
        if self.top_k > self.n_experts:
            raise ValueError(f"top_k={self.top_k} > "
                             f"n_experts={self.n_experts}")

    def param_shapes(self, policy=None) -> Dict[str, Tuple[int, ...]]:
        e, h = self.n_experts, self.d_hidden
        return {"router": (self.n_in, e),
                "w1": (e, self.n_in, h), "b1": (e, h),
                "w2": (e, h, self.n_out), "b2": (e, self.n_out)}

    def regularized_params(self) -> Tuple[str, ...]:
        return ("w1", "w2")

    def init_params(self, gen, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        e, h = self.n_experts, self.d_hidden
        wi = self.weight_init or "XAVIER"

        def stack(shape, fan_in, fan_out):
            return torch.stack([
                init_weights(gen, shape, wi, fan_in=fan_in, fan_out=fan_out,
                             distribution=self.dist, dtype=dt, device=device)
                for _ in range(e)])

        return {
            "router": init_weights(gen, (self.n_in, e), wi, fan_in=self.n_in,
                                   fan_out=e, dtype=dt, device=device),
            "w1": stack((self.n_in, h), self.n_in, h),
            "b1": torch.zeros((e, h), dtype=dt, device=device),
            "w2": stack((h, self.n_out), h, self.n_out),
            "b2": torch.zeros((e, self.n_out), dtype=dt, device=device),
        }

    def route(self, params, xc: torch.Tensor):
        """(gates, keep, weights) of compute-dtype tokens ``xc`` [b, t, d]:
        the softmax over experts (at least f32), the top-k keep mask and
        the kept gates renormalised to sum 1 (all gates when ``top_k ==
        E``)."""
        logits = torch.matmul(xc, params["router"].to(xc.dtype))
        gates = torch.softmax(logits.to(_dtypes.promote_to_f32(logits.dtype)),
                              dim=-1)
        if self.top_k < self.n_experts:
            keep = topk_keep(gates, self.top_k)
            masked = torch.where(keep, gates, torch.zeros_like(gates))
            weights = masked / torch.clamp_min(masked.sum(-1, keepdim=True),
                                               1e-9)
        else:
            keep = torch.ones_like(gates, dtype=torch.bool)
            weights = gates
        return gates, keep, weights

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        policy = policy or _dtypes.FLOAT32
        x = self._dropout_in(x, train, generator)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, :]                                   # [b, 1, f]
        xc = policy.cast_to_compute(x)
        b, t, d = xc.shape
        e, h = self.n_experts, self.d_hidden
        gates, keep, weights = self.route(params, xc)
        gate_dt = gates.dtype
        wc = weights.to(xc.dtype).reshape(b * t, e)
        # every expert on every token: [bt, d] @ [d, E·h]
        w1 = params["w1"].to(xc.dtype).permute(1, 0, 2).reshape(d, e * h)
        hid = torch.relu(torch.matmul(xc.reshape(b * t, d), w1)
                         + params["b1"].to(xc.dtype).reshape(e * h))
        # each expert's hidden scaled by its gate weight, then one GEMM sums
        # the experts' outputs: [bt, E·h] @ [E·h, n_out]
        hid = (hid.view(b * t, e, h) * wc[:, :, None]).view(b * t, e * h)
        w2 = params["w2"].to(xc.dtype).reshape(e * h, self.n_out)
        y = (torch.matmul(hid, w2)
             + torch.matmul(wc, params["b2"].to(xc.dtype))
             ).view(b, t, self.n_out)
        # Shazeer-style load balancing: E · Σ_e mean gate · mean keep
        keep_f = keep.to(gate_dt)
        if mask is not None:
            m = mask.to(gate_dt)[:, :, None]
            denom = torch.clamp_min(m.sum(), 1.0)
            gate_frac = (gates * m).sum(dim=(0, 1)) / denom
            keep_frac = (keep_f * m).sum(dim=(0, 1)) / denom
            y = y * m.to(y.dtype)
        else:
            gate_frac = gates.mean(dim=(0, 1))
            keep_frac = keep_f.mean(dim=(0, 1))
        aux = e * torch.sum(gate_frac * keep_frac)
        if squeeze:
            y = y[:, 0, :]
        out_state = dict(state or {})
        out_state["aux_loss"] = self.aux_weight * aux
        return y, out_state
