"""Pipeline parallelism: GPipe-style microbatch pipelining over a mesh dim
(counterpart of the JAX package's ``parallel/pipeline.py``).

The shift-register schedule: a stack of S identical blocks, one stage per
rank along the ``pp`` dim, processes M microbatches in M+S-1 ticks. At
each tick every stage runs its block and the activations move one stage
on by a cyclic shift over the dim's process group (``batch_isend_irecv``);
autograd through the shift gives exact pipeline gradients (the backward
of a shift forward is a shift back). Stage parameters live only on their
stage's rank — memory scales 1/S.

Every rank's graph has the same shape, so the shifts of the backward
pair up: stage 0 selects its microbatch over the arriving activation
with a ``where`` (the arriving one still joins the graph), every stage
writes its output into the output slots under a ``where`` that only the
last stage's condition opens, and the outputs are summed over the dim
(forward; the backward passes the cotangent through, as every rank
computes the same loss from them). The pipeline's input enters by an
identity whose backward sums the ranks' cotangents, so the prologue's
gradients are whole on every rank.

Scope: homogeneous stacks (every stage runs the same ``block_fn`` with its
own parameters).
"""

from __future__ import annotations

import re
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from . import collectives as _coll
from .mesh import axis_group, axis_names, axis_rank, axis_size, mesh_device

Pytree = Any
BlockFn = Callable[[Pytree, torch.Tensor], torch.Tensor]


def make_pipeline_forward(mesh, axis: str, block_fn: BlockFn,
                          n_stages: int, n_micro: int,
                          batch_axis: Optional[str] = None):
    """Build ``fn(stage_params, xm) -> ym``.

    ``stage_params``: THIS rank's stage parameters. ``xm``: microbatched
    input [M, b, ...], the same on every rank of the ``axis`` group (each
    slice of ``batch_axis`` runs its own pipeline on its rows). Returns
    [M, b, ...] — the last stage's outputs, on every rank of the group."""
    if axis_size(mesh, axis) != n_stages:
        raise ValueError(
            f"mesh axis {axis!r} has size {axis_size(mesh, axis)}, "
            f"need n_stages={n_stages}")
    del batch_axis
    S, M = n_stages, n_micro
    group = axis_group(mesh, axis)
    s = axis_rank(mesh, axis)

    def fn(stage_params, xm):
        dev = xm.device
        is_first = torch.tensor(s == 0, device=dev)
        xm = _coll.copy_in(xm, group)
        inflight = torch.zeros_like(xm[0])
        outs: List[torch.Tensor] = [torch.zeros_like(xm[0])
                                    for _ in range(M)]
        for t in range(M + S - 1):
            first = xm[min(max(t, 0), M - 1)]
            x_in = torch.where(is_first, first, inflight)
            y = block_fn(stage_params, x_in)
            # the value reaching stage S-1 at tick t is microbatch t-(S-1)
            m_out = min(max(t - (S - 1), 0), M - 1)
            write = torch.tensor(s == S - 1 and t >= S - 1, device=dev)
            outs[m_out] = torch.where(write, y, outs[m_out])
            if t + 1 < M + S - 1:
                inflight, = _coll.ppermute([y], group)
        return _coll.sum_out(torch.stack(outs), group)

    return fn


def _microbatch(x, M: int):
    b = x.shape[0]
    if b % M:
        raise ValueError(f"batch {b} not divisible by n_micro={M}")
    return x.reshape((M, b // M) + tuple(x.shape[1:]))


class PipelineParallelTrainer:
    """Train a stack of S identical blocks pipelined over ``axis``.

    ``layer``: a layer config (e.g. ``DenseLayer(n_in=d, n_out=d)``) whose
    ``apply`` is shape-preserving; stage i's parameters are initialised
    from the generator named ``stage_i`` and live on the stage's rank.
    The loss head ``loss`` (a ``losses`` name) is evaluated on the final
    stage's outputs, on every rank; plain SGD."""

    def __init__(self, layer, n_stages: int, mesh, *, axis: str = "pp",
                 n_micro: Optional[int] = None,
                 learning_rate: float = 0.01, loss: str = "mse",
                 seed: int = 0, policy=None):
        from .. import losses as _losses
        from ..util.netutil import named_generator

        self.layer = layer
        self.mesh = mesh
        self.axis = axis
        self.S = int(n_stages)
        self.M = int(n_micro if n_micro is not None else n_stages)
        self.lr = float(learning_rate)
        self.device = mesh_device(mesh)

        def block_fn(p, x):
            y, _ = layer.apply(p, x, state=None, train=False,
                               generator=None, policy=policy)
            return y

        # build first: validates n_stages against the mesh dim
        self._fwd = make_pipeline_forward(mesh, axis, block_fn, self.S,
                                          self.M)
        self.stage = axis_rank(mesh, axis)
        self.params = layer.init_params(
            named_generator("cpu", seed, f"stage_{self.stage}"), policy,
            self.device)
        self._loss_elem = _losses.get(loss)

    def _x(self, a):
        return _microbatch(torch.as_tensor(a).to(self.device), self.M)

    def forward(self, x):
        """Pipelined forward; returns [b, ...]."""
        with torch.no_grad():
            ym = self._fwd(self.params, self._x(x))
        return ym.reshape((-1,) + tuple(ym.shape[2:]))

    def fit_batch(self, x, y):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        out = self._fwd(params, self._x(x))
        loss = torch.mean(self._loss_elem(self._x(y), out, "identity"))
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            self.params = {k: p - self.lr * g
                           for (k, p), g in zip(params.items(), grads)}
        return loss.detach()


# --------------------------------------------------------------------------
# pipeline parallelism for DSL ComputationGraphs
# --------------------------------------------------------------------------


def _partition_pipeline(conf, pattern: str):
    """Cut a graph's topo order into (prologue, [(block_id, [vertices])],
    epilogue) by the repeated-block naming pattern, validating that the
    cut is pipeline-shaped: contiguous blocks, one external input per
    block (the previous block's output), structurally identical stages."""
    topo = conf.topological_order()
    pre: List[str] = []
    blocks: List[Tuple[str, List[str]]] = []
    post: List[str] = []
    for name in topo:
        m = re.match(pattern, name)
        if m:
            if post:
                raise ValueError(
                    f"block vertex {name!r} appears after non-block "
                    f"vertices {post} in topological order — blocks must "
                    "be contiguous to pipeline")
            bid = m.group(1)
            if not blocks or blocks[-1][0] != bid:
                if any(b == bid for b, _ in blocks):
                    raise ValueError(
                        f"block {bid!r} is interleaved with other blocks "
                        "in topological order — cannot pipeline")
                blocks.append((bid, []))
            blocks[-1][1].append(name)
        elif not blocks:
            pre.append(name)
        else:
            post.append(name)
    if not blocks:
        raise ValueError(
            f"no vertices match block pattern {pattern!r}; name repeated "
            "blocks like 'blk0_...' (models/transformer.py style) or pass "
            "block_pattern")

    def suffix(bid, name):
        return name[len(bid):]
    sig0 = [suffix(blocks[0][0], n) for n in blocks[0][1]]
    for bid, names in blocks[1:]:
        sig = [suffix(bid, n) for n in names]
        if sig != sig0:
            raise ValueError(
                f"block {bid!r} has structure {sig}, expected {sig0} — "
                "stages must be homogeneous to ride the pipeline schedule")
        for n0, n in zip(blocks[0][1], names):
            if conf.vertices[n] != conf.vertices[n0]:
                raise ValueError(
                    f"vertex {n!r} config differs from template {n0!r} — "
                    "stages must be homogeneous to ride the pipeline "
                    "schedule")
    prev_out = pre[-1] if pre else conf.network_inputs[0]
    for bid, names in blocks:
        in_block = set(names)
        externals = {src for n in names
                     for src in conf.vertex_inputs[n]
                     if src not in in_block}
        if externals != {prev_out}:
            raise ValueError(
                f"block {bid!r} reads {sorted(externals)} from outside the "
                f"block; a pipeline stage may only read its input "
                f"({prev_out!r})")
        prev_out = names[-1]
    allowed = set(post) | {prev_out} | set(conf.network_inputs)
    for n in post:
        for src in conf.vertex_inputs[n]:
            if src not in allowed:
                raise ValueError(
                    f"epilogue vertex {n!r} reads {src!r} from inside the "
                    "pipelined region — cannot pipeline this graph")
    return pre, blocks, post


class GraphPipelineTrainer:
    """GPipe pipeline parallelism for a DSL ``ComputationGraph`` with
    repeated homogeneous blocks — e.g. ``models.transformer.transformer_lm``.

    The topo order is cut by ``block_pattern`` into prologue → blocks →
    epilogue. The blocks are distributed over the ``axis`` mesh dim
    (n_blocks divisible by its size; stage s runs blocks
    [s·k, (s+1)·k) with the graph's own vertex semantics) and their
    parameters live only on their stage's rank; microbatches ride the
    schedule of :func:`make_pipeline_forward`. Prologue, epilogue and the
    loss head run on every rank of the dim and reuse the network's own
    ``_output_score``, so the loss and gradients are the single-device
    ones. With ``batch_axis`` (dp × pp) each data slice pipelines its rows
    and the gradients are summed over the data dim.

    Constraints (validated): stateless, dropout-free vertices, no l1/l2,
    no MoE layers, one loss output."""

    def __init__(self, net, mesh, *, axis: str = "pp",
                 n_micro: Optional[int] = None,
                 batch_axis: Optional[str] = None,
                 block_pattern: str = r"^(blk\d+)_"):
        from ..optimize import updaters as _updaters

        if net.params is None:
            net.init()
        if batch_axis is not None and batch_axis not in axis_names(mesh):
            raise ValueError(f"batch_axis {batch_axis!r} not in mesh "
                             f"{axis_names(mesh)}")
        self.net = net
        self.mesh = mesh
        self.axis = axis
        self.batch_axis = batch_axis
        S = axis_size(mesh, axis)
        self.S = S
        self.M = int(n_micro if n_micro is not None else S)
        conf = net.conf
        self.pre, self.blocks, self.post = _partition_pipeline(
            conf, block_pattern)
        if len(self.blocks) % S:
            raise ValueError(
                f"{len(self.blocks)} blocks not divisible by pipeline "
                f"stages {S}")
        self.k = len(self.blocks) // S
        self._validate_pipelineable()
        if len(net._output_layer_names) != 1:
            raise ValueError("pipeline training needs exactly one loss "
                             "output")
        self.stage = axis_rank(mesh, axis)
        self._data_group = axis_group(mesh, batch_axis)
        k, blocks = self.k, self.blocks
        template = [blocks[j][1] for j in range(k)]

        def stage_fn(stage_params, x):
            # stage parameters {block j: {template vertex: params}}; the
            # vertex semantics come from the template (stages are
            # homogeneous)
            h = x
            for j in range(k):
                names = template[j]
                in_block = set(names)
                acts = {src: h for n in names
                        for src in conf.vertex_inputs[n]
                        if src not in in_block}
                for n in names:
                    acts[n], _ = net._apply_vertex(
                        n, stage_params[str(j)][n], acts, {}, None,
                        train=True, minibatch=x.shape[0])
                h = acts[names[-1]]
            return h

        self._fwd = make_pipeline_forward(mesh, axis, stage_fn, S, self.M,
                                          batch_axis=batch_axis)
        params = net.params
        s = self.stage
        self.params = {
            "pro": {n: dict(params[n]) for n in self.pre},
            "stage": {str(j): {t: dict(params[n]) for t, n in
                               zip(template[j], blocks[s * k + j][1])}
                      for j in range(k)},
            "post": {n: dict(params[n]) for n in self.post}}
        self.params = _detach(self.params, clone=True)
        self._updater = _updaters.make_updater(net.conf.training, None)
        self.opt_state = self._updater.init(self.params)

    def _validate_pipelineable(self) -> None:
        # the WHOLE graph: the pipeline loss runs every vertex with no
        # generator (no dropout) and adds no penalty, so dropout/l1/l2
        # anywhere would silently diverge from the single-device run
        from ..nn.conf.moe import MoELayer

        net, conf = self.net, self.net.conf
        for n in conf.topological_order():
            v = conf.vertices[n]
            if isinstance(getattr(v, "layer", None), MoELayer):
                raise ValueError(
                    f"vertex {n!r} is a MoELayer — its aux_loss cannot "
                    "ride the pipeline schedule yet; use "
                    "ExpertParallelGraphTrainer for MoE models")
            if v.init_state(net.policy, net.device):
                raise ValueError(
                    f"vertex {n!r} carries state (e.g. BN running stats) — "
                    "pipeline training runs all vertices stateless")
            layer = getattr(v, "layer", None)
            if layer is not None and getattr(layer, "dropout", None):
                raise ValueError(
                    f"vertex {n!r} uses dropout — not supported under "
                    "pipeline training yet")
            if layer is not None and (getattr(layer, "l1", None)
                                      or getattr(layer, "l2", None)):
                raise ValueError(
                    f"vertex {n!r} sets l1/l2 — regularization is not "
                    "supported under pipeline training yet")

    def _run(self, names, params_by_name, acts, mb):
        for n in names:
            acts[n], _ = self.net._apply_vertex(
                n, params_by_name[n], acts, {}, None, train=True,
                minibatch=mb)
        return acts

    def _loss(self, params, inputs, labels):
        """This rank's share of the loss (the whole loss without a data
        dim)."""
        net, conf = self.net, self.net.conf
        B = inputs[0].shape[0]
        acts = dict(zip(conf.network_inputs, inputs))
        acts = self._run(self.pre, params["pro"], acts, B)
        h = acts[self.pre[-1]] if self.pre else acts[conf.network_inputs[0]]
        ym = self._fwd(params["stage"], _microbatch(h, self.M))
        acts[self.blocks[-1][1][-1]] = ym.reshape((B,) + tuple(ym.shape[2:]))
        out_name = net._output_layer_names[0]
        consumed = {i for ins in conf.vertex_inputs.values() for i in ins}
        total = 0.0
        with _coll.batch_split([self._data_group]):
            for n in self.post:
                if n == out_name:
                    total = total + net._output_score(
                        params["post"], n, acts[conf.vertex_inputs[n][0]],
                        labels[0], None, None, minibatch=B)
                if n != out_name or n in consumed:
                    acts = self._run([n], params["post"], acts, B)
        return total.to(torch.float32)

    def _stage_batch(self, arrs):
        from .dsl_trainer import _as_list
        out = []
        for a in _as_list(arrs):
            t = self.net._to_input(a)
            if self._data_group is not None:
                n = _coll.group_size(self._data_group)
                if t.shape[0] % n:
                    raise ValueError(f"batch {t.shape[0]} not divisible by "
                                     f"the {n}-device {self.batch_axis!r} "
                                     "dim")
                t = _coll.local_slice(t, self._data_group, 0)
            out.append(t)
        if out[0].shape[0] % self.M:
            raise ValueError(f"batch {out[0].shape[0]} not divisible by "
                             f"n_micro={self.M}")
        return out

    def fit_batch(self, inputs, labels):
        """One pipelined update on GLOBAL [b, ...] arrays (each data slice's
        rows divisible by n_micro)."""
        from ..optimize import updaters as _updaters
        from .dsl_trainer import _reject_tbptt_chunking
        net = self.net
        xs_global = [net._to_input(x) for x in
                     (inputs if isinstance(inputs, (list, tuple))
                      else [inputs])]
        _reject_tbptt_chunking(net, xs_global,
                               "GraphPipelineTrainer.fit_batch")
        xs, ys = self._stage_batch(xs_global), self._stage_batch(labels)
        params = _requires_grad(self.params)
        leaves = _coll.tree_tensors(params)
        loss = self._loss(params, xs, ys)
        grads = _unflatten(params, torch.autograd.grad(
            loss, leaves, allow_unused=True), leaves)
        loss = loss.detach().clone()
        if self._data_group is not None:
            _coll.all_reduce_tree(grads, [self._data_group])
            dist.all_reduce(loss, op=dist.ReduceOp.SUM,
                            group=self._data_group)
        t = net.conf.training
        grads = _updaters.normalize_gradients(
            grads, t.gradient_normalization,
            float(t.gradient_normalization_threshold))
        deltas, self.opt_state = self._updater.update(
            grads, self.opt_state, net._update_count)
        self.params = _detach(params)
        _updaters.apply_updates(self.params, deltas)
        net._update_count += 1
        net._score = loss
        net._fire_iteration(xs_global[0].shape[0], loss)
        return loss

    def score_for(self, inputs, labels) -> float:
        with torch.no_grad():
            loss = self._loss(self.params, self._stage_batch(inputs),
                              self._stage_batch(labels))
            if self._data_group is not None:
                loss = loss.clone()
                dist.all_reduce(loss, op=dist.ReduceOp.SUM,
                                group=self._data_group)
        return float(loss)

    @torch.no_grad()
    def sync_to_net(self) -> None:
        """Write the trained parameters back into ``net.params`` (vertex
        name keyed, whole on every rank): each stage's blocks are
        gathered from its rank."""
        net = self.net
        params = net.params
        group = axis_group(self.mesh, self.axis)
        for part in ("pro", "post"):
            for n, lp in self.params[part].items():
                for k, t in lp.items():
                    params[n][k].copy_(t)
        template = [self.blocks[j][1] for j in range(self.k)]
        for j in range(self.k):
            for ti, tname in enumerate(template[j]):
                for key, t in self.params["stage"][str(j)][tname].items():
                    stacked = _coll.all_gather_dim(t[None], group, 0)
                    for s in range(self.S):
                        name = self.blocks[s * self.k + j][1][ti]
                        params[name][key].copy_(stacked[s])


def _detach(tree, clone: bool = False):
    if isinstance(tree, dict):
        return {k: _detach(v, clone) for k, v in tree.items()}
    return tree.detach().clone() if clone else tree.detach()


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def _unflatten(tree, values, leaves):
    by_id = {id(l): (torch.zeros_like(l) if v is None else v)
             for l, v in zip(leaves, values)}

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        return by_id[id(t)]
    return rebuild(tree)
