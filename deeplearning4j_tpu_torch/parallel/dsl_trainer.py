"""Shared machinery for the mesh-sharded trainers that serve DSL models
(counterpart of the JAX package's ``parallel/dsl_trainer.py``).

One step over the net's own loss function, parameterised by what a mode
splits: ``SequenceParallelGraphTrainer`` splits the time axis and runs
the step inside the ring-attention context; ``TensorParallelGraphTrainer``
and ``ExpertParallelGraphTrainer`` partition parameters over a mesh dim.
All inherit the same contract — masks, TBPTT chunk rejection, listener
and iteration accounting, ``output()``, the non-finite budget — so the
modes cannot drift from each other or from the single-device step.

Every rank is handed the same GLOBAL arrays and keeps its block of each
(``x_spec`` names the mesh dim each tensor dim is split over). The step:

1. the loss of this rank's block inside ``collectives.batch_split`` over
   the split dims' groups, so denominators, BatchNormalization moments and
   the MoE load-balancing fractions are global and the penalties counted
   once — a rank's loss is its share of the global loss;
2. its gradients, summed over those groups (the global gradient), and
   gradient normalization on them;
3. the update: a partitioned parameter (``param_placement``, the JAX
   package's per-parameter sharding) is updated on this rank's block only,
   against this rank's block of the updater state, and the updated blocks
   are all-gathered back into the net's parameter. With ``local_compute``
   the forward and backward read this rank's block (the experts of MoE
   layers; the column-parallel blocks of tensor parallelism).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import collectives as _coll
from .mesh import axis_group, axis_names, axis_size

Pytree = Any
# a parameter's placement: (mesh dim name, tensor dim it is split along)
Placement = Tuple[str, int]


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _reject_tbptt_chunking(net, xs, api: str) -> None:
    """The sharded trainers run ONE full-sequence BPTT update per batch;
    doing that where the single-device path would chunk (truncated_bptt
    with T > tbptt_fwd_length) changes the optimisation — refuse. Uses
    the net's own ``_reject_tbptt`` so the predicate cannot drift."""
    if hasattr(net, "topo_order") and hasattr(net.conf, "vertices"):
        net._reject_tbptt(xs, api)          # ComputationGraph: list input
    else:
        net._reject_tbptt(xs[0], api)       # MultiLayerNetwork: one array


def placement_from_spec(spec: Sequence[Optional[str]]) -> Optional[Placement]:
    """(dim name, tensor dim) of the one split entry of a per-dim spec
    tuple (the JAX package's PartitionSpec), or None when replicated."""
    split = [(name, i) for i, name in enumerate(spec) if name is not None]
    if not split:
        return None
    if len(split) > 1:
        raise ValueError(f"a parameter splits along one dim, got {spec}")
    return split[0]


def _is_graph(net) -> bool:
    return hasattr(net.conf, "vertices")


class ShardedDSLTrainerBase:
    """One training step over a DSL net's own loss function, split over
    the caller's mesh dims.

    Subclass contract: call ``_build(net, mesh, ...)`` from ``__init__``
    with the mode's input/mask specs (a mesh dim name or None per tensor
    dim), optional per-parameter placements (default: none partitioned)
    and an optional context factory entered around the step (e.g. the
    ring-attention route)."""

    _api = "ShardedDSLTrainerBase"

    def _build(self, net, mesh, *, x_spec: Sequence[Optional[str]],
               mask_spec: Sequence[Optional[str]],
               batch_axis: Optional[str] = None,
               param_placement: Optional[Dict[str, Dict[str, Placement]]]
               = None,
               step_ctx=None, local_compute=False,
               skip_nonfinite_budget: Optional[int] = None) -> None:
        if net.params is None:
            net.init()
        self.nonfinite_guard = None
        if skip_nonfinite_budget is not None:
            from ..util.resilience import NonFiniteGuard
            self.nonfinite_guard = NonFiniteGuard(
                int(skip_nonfinite_budget), net)
        names = axis_names(mesh)
        for dim in tuple(x_spec) + tuple(mask_spec):
            if dim is not None and dim not in names:
                raise ValueError(f"mesh dim {dim!r} not in mesh {names}")
        if batch_axis is not None and batch_axis not in names:
            raise ValueError(f"batch_axis {batch_axis!r} not in mesh "
                             f"{names}")
        self.net = net
        self.mesh = mesh
        self.batch_axis = batch_axis
        self._is_graph = _is_graph(net)
        self._x_spec = tuple(x_spec)
        self._mask_spec = tuple(mask_spec)
        # the groups the examples (dim 0) and timesteps are split over
        self._example_groups = [axis_group(mesh, d) for d in self._x_spec[:1]
                                if d is not None]
        self._time_groups = [axis_group(mesh, d) for d in self._x_spec[1:]
                             if d is not None]
        self._split_groups = self._example_groups + self._time_groups
        self._ctx = step_ctx if step_ctx is not None else \
            contextlib.nullcontext
        # the forward reads a partitioned parameter's block, not the whole
        # parameter: True hands the layers the bare block (MoE experts
        # under collectives.expert_split); a callable (block, tensor dim)
        # wraps it (tensor.ColumnBlock)
        self._local_compute = local_compute
        if net._updater is None:
            net.init_updater()
        self._placement: Dict[str, Dict[str, Tuple[Any, int]]] = {}
        for v, lp in (param_placement or {}).items():
            for k, pl in lp.items():
                if pl is None:
                    continue
                dim_name, tdim = pl
                group = axis_group(mesh, dim_name)
                size = axis_size(mesh, dim_name)
                shape = net.params[v][k].shape
                if shape[tdim] % size:
                    raise ValueError(
                        f"{v}.{k} dim {tdim} ({shape[tdim]}) does not "
                        f"split over {dim_name!r} ({size})")
                self._placement.setdefault(v, {})[k] = (group, tdim)
        # this rank's block of the updater state: slots that mirror the
        # parameter tree follow their parameter's placement
        self.opt_state = {}
        for slot, tree in (net.updater_state or {}).items():
            self.opt_state[slot] = (self._shard_tree(tree)
                                    if self._mirrors(tree) else tree)

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _mirrors(self, tree) -> bool:
        params = self.net.params
        return isinstance(tree, dict) and set(tree) == set(params) and all(
            isinstance(tree[v], dict) and set(tree[v]) == set(params[v])
            for v in params)

    def _shard_tree(self, tree):
        """This rank's blocks of a tree that mirrors the parameters."""
        out = {}
        for v, lp in tree.items():
            pl = self._placement.get(v, {})
            out[v] = {k: (_coll.local_slice(t, *pl[k]) if k in pl else t)
                      for k, t in lp.items()}
        return out

    def _gather_tree(self, tree):
        out = {}
        for v, lp in tree.items():
            pl = self._placement.get(v, {})
            out[v] = {k: (_coll.all_gather_dim(t, *pl[k]) if k in pl else t)
                      for k, t in lp.items()}
        return out

    def sync_to_net(self) -> None:
        """Gather the partitioned updater state into ``net.updater_state``
        (parameters are whole on every rank after each step)."""
        self.net.updater_state = {
            slot: (self._gather_tree(tree) if self._mirrors(tree) else tree)
            for slot, tree in self.opt_state.items()}

    # ------------------------------------------------------------------
    # staging: this rank's block of a global array
    # ------------------------------------------------------------------

    def _block(self, a, spec):
        t = self.net._to_input(a)
        for i, dim in enumerate(spec[:t.ndim]):
            if dim is None:
                continue
            n = axis_size(self.mesh, dim)
            if t.shape[i] % n:
                raise ValueError(
                    f"{self._api}: dim {i} of size {t.shape[i]} does not "
                    f"split over mesh dim {dim!r} ({n})")
            t = _coll.local_slice(t, axis_group(self.mesh, dim), i)
        return t

    def _stage(self, a):
        return self._block(a, self._x_spec)

    def _stage_mask(self, m):
        return self._block(m, self._mask_spec)

    def _states(self):
        return (self.net._states_map() if self._is_graph
                else self.net._states_list())

    def output(self, *inputs):
        """Sharded inference over the network outputs: each rank runs its
        block and the blocks are gathered back along the split dims."""
        xs = [self._stage(x) for x in
              (inputs[0] if len(inputs) == 1
               and isinstance(inputs[0], (list, tuple)) else list(inputs))]
        with self._ctx():
            outs = self.net.output(xs if self._is_graph else xs[0])
        outs = _as_list(outs)
        gathered = []
        for o in outs:
            for i, dim in enumerate(self._x_spec[:o.ndim]):
                if dim is not None:
                    o = _coll.all_gather_dim(o, axis_group(self.mesh, dim), i)
            gathered.append(o)
        return gathered[0] if len(gathered) == 1 else gathered

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _forward_params(self):
        """(the parameters the step's forward reads, the leaves the
        gradient is taken against): the net's own, or with
        ``local_compute`` this rank's block of each partitioned one (a
        leaf of its own, so its gradient is the block's), wrapped when
        ``local_compute`` is a wrapper."""
        params = self.net._require_params()
        if not self._local_compute:
            return params, params
        wrap = (self._local_compute if callable(self._local_compute)
                else None)
        leaves, forward = {}, {}
        for v, lp in self._shard_tree(params).items():
            pl = self._placement.get(v, {})
            leaves[v] = {k: (t.detach().requires_grad_(True) if k in pl
                             else t) for k, t in lp.items()}
            forward[v] = {k: (wrap(t, pl[k][1]) if wrap and k in pl
                              else t) for k, t in leaves[v].items()}
        return forward, leaves

    def _loss(self, xs, ys, ms, gen, new_states, params):
        net = self.net
        if self._is_graph:
            return net._loss_fn(xs, ys, ms, params=params, generator=gen,
                                new_states=new_states,
                                states=net._states_map())
        loss, states = net._loss_fn(xs[0], ys[0],
                                    None if ms is None else ms[0],
                                    params=params, generator=gen,
                                    states=net._states_list())
        new_states.update(enumerate(states))
        return loss

    def fit_batch(self, inputs, labels, masks=None) -> torch.Tensor:
        """One sharded update on GLOBAL arrays; ``masks``: optional [b, t]
        sequence masks."""
        from ..optimize import updaters as _updaters
        net = self.net
        xs_global = [net._to_input(x) for x in _as_list(inputs)]
        _reject_tbptt_chunking(net, xs_global, f"{self._api}.fit_batch")
        xs = [self._stage(x) for x in xs_global]
        ys = [self._stage(y) for y in _as_list(labels)]
        ms = (None if masks is None
              else [None if m is None else self._stage_mask(m)
                    for m in _as_list(masks)])
        params, leaves = self._forward_params()
        named = [(v, k, p) for v, lp in leaves.items() for k, p in lp.items()]
        gen = net._generator(f"update_{net._update_count}")
        new_states: Dict[Any, Any] = {}
        with self._ctx(), _coll.batch_split(
                self._example_groups, time_groups=self._time_groups):
            loss = self._loss(xs, ys, ms, gen, new_states, params)
        gs = torch.autograd.grad(loss, [p for _, _, p in named],
                                 allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {v: {} for v in params}
        for (v, k, p), g in zip(named, gs):
            grads[v][k] = torch.zeros_like(p) if g is None else g
        if self._local_compute:
            # whole gradients of the blocks, for the normalization below
            grads = self._gather_tree(grads)
        # the global gradient and loss: sums of the ranks' shares
        _coll.all_reduce_tree(grads, self._split_groups)
        loss = loss.detach().clone()
        for g in self._split_groups:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=g)
        ok = True
        if self.nonfinite_guard is not None:
            ok = bool(torch.logical_and(_updaters.all_finite(grads),
                                        torch.isfinite(loss).all()))
        if ok:
            t = net.conf.training
            grads = _updaters.normalize_gradients(
                grads, t.gradient_normalization,
                float(t.gradient_normalization_threshold))
            self._update(grads)
            if self._is_graph:
                net._persist_states(new_states)
            else:
                net._persist_states([new_states[i]
                                     for i in range(len(new_states))])
        net._update_count += 1
        net._score = loss
        if self.nonfinite_guard is not None:
            # may raise once over budget; the batch enables attribution
            self.nonfinite_guard.step(ok, batch=(xs, ys, ms))
        net._fire_iteration(xs_global[0].shape[0], loss)
        return loss

    @torch.no_grad()
    def _update(self, grads) -> None:
        """The updater on this rank's blocks; partitioned parameters are
        then gathered whole again."""
        from ..optimize import updaters as _updaters
        net = self.net
        params = net.params
        blocks = self._shard_tree(params)
        deltas, self.opt_state = net._updater.update(
            self._shard_tree(grads), self.opt_state, net._update_count)
        _updaters.apply_updates(blocks, deltas)
        for v, pl in self._placement.items():
            for k, (group, tdim) in pl.items():
                if _coll.group_size(group) > 1:
                    params[v][k].copy_(
                        _coll.all_gather_dim(blocks[v][k], group, tdim))
        if not self._placement or all(
                _coll.group_size(g) == 1 for pl in self._placement.values()
                for g, _ in pl.values()):
            net.updater_state = self.opt_state
