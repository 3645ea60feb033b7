"""Expert parallelism: mixture-of-experts FFN with its experts partitioned
over an ``ep`` mesh dim (counterpart of the JAX package's
``parallel/expert.py``).

The dense-dispatch formulation, as in the JAX package: every expert
computes every token and the top-k gates zero the unused results,
expressed over a stacked expert dim, so shapes stay static. The
expert-stacked parameters are partitioned over ``ep`` on the leading E
dim: each rank computes its E/ep experts on every token and the blocks'
outputs are summed over the dim (``collectives.sum_out``; the tokens and
gate weights enter by ``copy_in``, so the router's and the input's
gradients are whole on every rank); each rank updates its block, against
its block of the updater state. The router stays whole.

Includes the standard auxiliary load-balancing loss (mean gate fraction ×
mean top-k assignment fraction, summed over experts and scaled by E).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from . import collectives as _coll
from .dsl_trainer import ShardedDSLTrainerBase, placement_from_spec
from .mesh import axis_group, axis_names, axis_size, mesh_device

Pytree = Any


def init_moe_params(generator: torch.Generator, d_model: int, d_hidden: int,
                    n_experts: int, dtype=torch.float32,
                    device="cpu") -> Pytree:
    """Router + stacked expert FFNs ([E, ...] leading expert dim)."""
    def normal(shape, fan):
        w = torch.randn(shape, generator=generator, dtype=dtype)
        return (w * (1.0 / math.sqrt(fan))).to(device)

    return {
        "router": normal((d_model, n_experts), d_model),
        "w1": normal((n_experts, d_model, d_hidden), d_model),
        "b1": torch.zeros((n_experts, d_hidden), dtype=dtype, device=device),
        "w2": normal((n_experts, d_hidden, d_model), d_hidden),
        "b2": torch.zeros((n_experts, d_model), dtype=dtype, device=device),
    }


def moe_apply(params: Pytree, x, *, top_k: int = 2, group=None):
    """[b, d] -> ([b, d], aux_loss). Dense dispatch over all experts; with
    ``group``, ``params`` holds this rank's block of the experts (the
    router whole): the block is computed and the blocks' outputs summed
    over the group."""
    from ..nn.conf.moe import topk_keep
    e = params["router"].shape[1]
    e_here = params["w1"].shape[0]
    logits = x @ params["router"]                        # [b, E]
    gates = torch.softmax(logits, dim=-1)
    if top_k < e:
        keep = topk_keep(gates, top_k)                   # lowest-index ties
        masked = torch.where(keep, gates, torch.zeros_like(gates))
        weights = masked / torch.clamp_min(masked.sum(-1, keepdim=True),
                                           1e-9)
    else:
        keep = torch.ones_like(gates, dtype=torch.bool)
        weights = gates
    xe = x
    if e_here != e:
        first = _coll.group_rank(group) * e_here
        weights = _coll.copy_in(weights, group)[:, first:first + e_here]
        xe = _coll.copy_in(x, group)
    h = torch.relu(torch.einsum("bd,edh->ebh", xe, params["w1"])
                   + params["b1"][:, None, :])
    y_e = (torch.einsum("ebh,ehd->ebd", h, params["w2"])
           + params["b2"][:, None, :])
    y = torch.einsum("be,ebd->bd", weights, y_e)
    if e_here != e:
        y = _coll.sum_out(y, group)
    aux = e * torch.sum(gates.mean(dim=0) * keep.to(gates.dtype).mean(dim=0))
    return y, aux


def moe_param_shardings(mesh, axis: str = "ep") -> Dict[str, Optional[tuple]]:
    """Placements: expert-stacked tensors split over ``axis`` on dim 0,
    the router whole."""
    return {"router": None, "w1": (axis, 0), "b1": (axis, 0),
            "w2": (axis, 0), "b2": (axis, 0)}


class ExpertParallelTrainer:
    """Train an MoE FFN with experts partitioned over the ``ep`` mesh dim.

    Regression-style head: ``loss = mse(moe(x), y) + aux_weight * aux``
    on a batch every rank sees whole; plain SGD. Each rank holds, computes
    and updates E/ep experts (``params``: its block of the expert tensors,
    the router whole); the blocks' outputs are summed over the dim."""

    def __init__(self, d_model: int, d_hidden: int, n_experts: int, mesh,
                 *, axis: str = "ep", top_k: int = 2,
                 learning_rate: float = 0.05, aux_weight: float = 0.01,
                 seed: int = 0):
        if n_experts % axis_size(mesh, axis):
            raise ValueError(
                f"n_experts={n_experts} not divisible by mesh axis "
                f"{axis!r} size {axis_size(mesh, axis)}")
        self.mesh = mesh
        self.top_k = int(top_k)
        self.lr = float(learning_rate)
        self.aux_weight = float(aux_weight)
        self.device = mesh_device(mesh)
        self._group = axis_group(mesh, axis)
        self.params = self.shard(init_moe_params(
            torch.Generator().manual_seed(int(seed)), d_model, d_hidden,
            n_experts, device=self.device))

    def shard(self, params):
        """This rank's block of a whole parameter tree."""
        return {k: (v if pl is None else
                    _coll.local_slice(v, self._group, pl[1]).contiguous())
                for (k, v), pl in zip(params.items(), (
                    moe_param_shardings(self.mesh)[k] for k in params))}

    def _x(self, a):
        return torch.as_tensor(a).to(self.device)

    def forward(self, x):
        with torch.no_grad():
            y, _ = moe_apply(self.params, self._x(x), top_k=self.top_k,
                             group=self._group)
        return y

    def fit_batch(self, x, y):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        out, aux = moe_apply(params, self._x(x), top_k=self.top_k,
                             group=self._group)
        loss = torch.mean((out - self._x(y)) ** 2) + self.aux_weight * aux
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            self.params = {k: p - self.lr * g
                           for (k, p), g in zip(params.items(), grads)}
        return loss.detach()


# --------------------------------------------------------------------------
# expert parallelism for DSL models (MoELayer vertices)
# --------------------------------------------------------------------------


def _layer_of(net, key):
    if hasattr(net.conf, "vertices"):
        return getattr(net.conf.vertices.get(key), "layer", None)
    return net.layers[int(key.split("_")[-1])]


def expert_param_specs(net, axis: str = "ep") -> Dict[str, Dict[str, tuple]]:
    """Per-dim spec tuples for net.params: expert-stacked MoELayer params
    split over ``axis`` on their leading E dim, everything else
    replicated."""
    from ..nn.conf.moe import MoELayer
    specs = {}
    for key, lp in net.params.items():
        if isinstance(_layer_of(net, key), MoELayer):
            specs[key] = {name: ((axis,) + (None,) * (p.ndim - 1)
                                 if name != "router" else ())
                          for name, p in lp.items()}
        else:
            specs[key] = {name: () for name in lp}
    return specs


def expert_param_shardings(net, mesh, axis: str = "ep"):
    """Validated placements — (dim name, tensor dim) per partitioned
    parameter — for a net's MoELayer expert params: raises if
    the net has no MoE vertices or an expert count does not divide the
    mesh dim. ONE implementation for every trainer that composes expert
    partitioning."""
    if axis not in axis_names(mesh):
        raise ValueError(f"expert axis {axis!r} not in mesh "
                         f"{axis_names(mesh)}")
    specs = expert_param_specs(net, axis)
    if not any(sp for lp in specs.values() for sp in lp.values()):
        raise ValueError("no MoELayer params found to shard — expert "
                         "parallelism needs MoE vertices in the net")
    size = axis_size(mesh, axis)
    for key, lp in net.params.items():
        for name, p in lp.items():
            if specs[key][name] and p.shape[0] % size:
                raise ValueError(
                    f"n_experts={p.shape[0]} not divisible by mesh axis "
                    f"{axis!r} size {size}")
    return {key: {name: placement_from_spec(sp) for name, sp in lp.items()}
            for key, lp in specs.items()}



class ExpertParallelGraphTrainer(ShardedDSLTrainerBase):
    """Expert-parallel training for DSL models containing ``MoELayer``s:
    expert-stacked params partitioned over the ``ep`` mesh dim (each rank
    holds and updates E/ep experts' blocks), everything else whole, the
    batch optionally split over ``batch_axis``. Shares the sharded-trainer
    contract (masks, TBPTT chunk rejection, output()) with
    ``SequenceParallelGraphTrainer``."""

    _api = "ExpertParallelGraphTrainer"

    def __init__(self, net, mesh, *, axis: str = "ep",
                 batch_axis: Optional[str] = None,
                 skip_nonfinite_budget: Optional[int] = None):
        if net.params is None:
            net.init()
        self.axis = axis
        group = axis_group(mesh, axis)
        self._build(net, mesh, x_spec=(batch_axis,), mask_spec=(batch_axis,),
                    batch_axis=batch_axis,
                    param_placement=expert_param_shardings(net, mesh, axis),
                    step_ctx=lambda: _coll.expert_split(group),
                    local_compute=True,
                    skip_nonfinite_budget=skip_nonfinite_budget)
