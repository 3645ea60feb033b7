"""Collectives over process groups, and the global reductions of a
sharded step.

The JAX package runs ONE program over global arrays: every mean over a
sharded axis is a global mean, and GSPMD inserts the collectives. The
port runs one program per rank over its local shard, so whatever must be
global is made global here, explicitly:

* :func:`batch_split` — a context naming the process groups over which
  the step's examples (and, under sequence parallelism, its timesteps)
  are split. Inside it, :func:`global_count` sums a loss denominator over
  the groups (an example count over the example groups only), :func:`global_sum` sums a differentiable statistic
  (BatchNormalization's moments, the MoE load-balancing fractions), and
  :func:`count_once` keeps a replicated term (the l1/l2 penalty, the MoE
  auxiliary loss) in the first rank's share of the summed loss only. A
  rank's loss is then its share of the global loss, and the sum of the
  ranks' gradients (:func:`all_reduce_tree`) is the global gradient.
  Outside the context each is the identity.
* :func:`expert_split` — a context under which MoE layers handed a block
  of their experts compute it and sum the blocks' outputs over the group.
* differentiable collectives with the backward each use needs:
  :class:`AllReduceSum` (backward: the sum of the ranks' cotangents),
  :func:`copy_in` / :func:`sum_out` (the identity whose backward sums,
  the sum whose backward is the identity: a replicated value entering and
  leaving a partitioned computation), :func:`ppermute` (a cyclic shift;
  backward: the shift back) and :func:`gather_dim` (an all-gather whose
  backward keeps this rank's slice, for values every rank of the group
  computes identically).

A group of one rank never communicates: each collective returns its
input. Every collective raises on failure; nothing retries in another
backend. A host value crosses a group on :func:`group_device` (the card
for NCCL, which takes no CPU tensor).

The two contexts are context variables, so they hold in the thread (or
task) that entered them and nowhere else: another thread's forward during
a sharded step (an in-process server, elastic hosts on threads) keeps its
single-device route. A gradient-checkpointed segment recomputes in the
backward under the context of its forward (``util.netutil``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def group_ranks(group) -> List[int]:
    """The global ranks of ``group`` in group-rank order."""
    return dist.get_process_group_ranks(group)


def group_device(groups) -> torch.device:
    """Where a host value must lie to cross ``groups``: this process's
    card when any of them is an NCCL group, else the CPU."""
    if any(dist.get_backend(g) == dist.Backend.NCCL for g in groups):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# --------------------------------------------------------------------------
# the batch-split context
# --------------------------------------------------------------------------

_BATCH_GROUPS = contextvars.ContextVar("batch_groups", default=((), ()))


@contextlib.contextmanager
def batch_split(groups: Sequence, *, time_groups: Sequence = ()):
    """Within the block (in this thread), the step's examples are split
    over ``groups`` and its timesteps over ``time_groups`` (process
    groups; groups of one rank are dropped)."""
    keep = lambda gs: tuple(g for g in gs                 # noqa: E731
                            if g is not None and group_size(g) > 1)
    token = _BATCH_GROUPS.set((keep(groups), keep(time_groups)))
    try:
        yield
    finally:
        _BATCH_GROUPS.reset(token)


def active_batch_groups() -> tuple:
    """Every group the step's examples or timesteps are split over."""
    examples, times = _BATCH_GROUPS.get()
    return examples + times


def _all_reduce_(x: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def global_count(x, *, examples_only: bool = False):
    """A loss denominator (a count, not differentiated) summed over the
    active split groups — only those splitting the examples when it
    counts examples (``examples_only``); a Python number or a tensor."""
    groups = (_BATCH_GROUPS.get()[0] if examples_only
              else active_batch_groups())
    if not groups:
        return x
    if torch.is_tensor(x):
        return _all_reduce_(x.detach().clone(), groups)
    t = torch.tensor(float(x), dtype=torch.float64,
                     device=group_device(groups))
    return float(_all_reduce_(t, groups))


def count_once(x):
    """``x`` in the first rank's share of the summed loss, 0·x in the
    others' (the zero keeps every rank's graph the same shape, so the
    collectives of its backward pair up)."""
    groups = active_batch_groups()
    if not groups or not torch.is_tensor(x):
        return x
    first = all(group_rank(g) == 0 for g in groups)
    return x if first else x * 0.0


class AllReduceSum(torch.autograd.Function):
    """Sum over ``groups``; the backward sums the cotangents likewise
    (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce_(x.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.groups), None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A differentiable statistic summed over the active batch groups."""
    groups = active_batch_groups()
    return AllReduceSum.apply(x, groups) if groups else x


# --------------------------------------------------------------------------
# the expert-split context: experts partitioned over a group
# --------------------------------------------------------------------------

_EXPERT_GROUP = contextvars.ContextVar("expert_group", default=None)


@contextlib.contextmanager
def expert_split(group):
    """Within the block (in this thread), MoE layers handed a block of
    their experts compute that block and sum the blocks' outputs over
    ``group``."""
    token = _EXPERT_GROUP.set(group if group_size(group) > 1 else None)
    try:
        yield
    finally:
        _EXPERT_GROUP.reset(token)


def active_expert_group():
    return _EXPERT_GROUP.get()


class _CopyIn(torch.autograd.Function):
    """Identity forward; the backward sums the cotangents over the group
    (each rank's use of a replicated value is one share of its
    gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), [ctx.group]), None


class _SumOut(torch.autograd.Function):
    """Sum over the group forward; the backward passes the cotangent
    through (every rank computes the same loss from the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), [group])

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyIn.apply(x, group)


def sum_out(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _SumOut.apply(x, group)


# --------------------------------------------------------------------------
# trees of tensors
# --------------------------------------------------------------------------


def tree_tensors(tree, out: Optional[list] = None) -> List[torch.Tensor]:
    """The tensor leaves of a nest of dicts, lists and tuples, in order."""
    out = [] if out is None else out
    if torch.is_tensor(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            tree_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tree_tensors(v, out)
    return out


@torch.no_grad()
def all_reduce_tree(tree, groups, *, average: bool = False):
    """Sum (or average) every floating tensor leaf of ``tree`` over
    ``groups`` in place, one flat buffer per dtype. Groups of one rank
    take part too (the all-reduce is then the identity), so a one-rank
    run goes through the same calls as a wider one."""
    groups = tuple(g for g in groups if g is not None)
    if not groups:
        return tree
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tree_tensors(tree):
        if t.is_floating_point():
            by_dtype.setdefault(t.dtype, []).append(t)
    n = 1
    for g in groups:
        n *= group_size(g)
    for leaves in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in leaves])
        _all_reduce_(flat, groups)
        if average:
            flat = flat / n
        off = 0
        for t in leaves:
            k = t.numel()
            t.copy_(flat[off:off + k].view_as(t))
            off += k
    return tree


# --------------------------------------------------------------------------
# point to point: the cyclic shift
# --------------------------------------------------------------------------


def shift(tensors: Sequence[torch.Tensor], group, step: int = 1
          ) -> List[torch.Tensor]:
    """Send each tensor to the rank ``step`` places on in ``group``
    (cyclically) and return what arrives from the rank ``step`` places
    back: one ``batch_isend_irecv`` for all of them."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    ranks = group_ranks(group)
    me = group_rank(group)
    dst, src = ranks[(me + step) % n], ranks[(me - step) % n]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, step, *xs):
        ctx.group, ctx.step = group, step
        return tuple(shift(xs, group, step))

    @staticmethod
    def backward(ctx, *gs):
        back = shift([g.contiguous() for g in gs], ctx.group, -ctx.step)
        return (None, None, *back)


def ppermute(tensors: Sequence[torch.Tensor], group, step: int = 1
             ) -> List[torch.Tensor]:
    """Differentiable :func:`shift` (``lax.ppermute`` by ``step``): the
    backward shifts the cotangents back. Every rank of the group must
    reach the backward of each shift in the same order."""
    if group_size(group) == 1:
        return list(tensors)
    return list(_Shift.apply(group, step, *tensors))


# --------------------------------------------------------------------------
# gather along a tensor dim
# --------------------------------------------------------------------------


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate the group's shards of ``x`` along ``dim`` (group-rank
    order)."""
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def local_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's shard of ``x`` along ``dim`` (equal chunks)."""
    n = group_size(group)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * size, size)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.group, ctx.dim).contiguous(), None, None


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable all-gather along ``dim`` for a value every rank of
    the group then uses identically: the backward keeps this rank's slice
    of the (identical) cotangent."""
    if group_size(group) == 1:
        return x
    return _GatherDim.apply(x, group, dim)
