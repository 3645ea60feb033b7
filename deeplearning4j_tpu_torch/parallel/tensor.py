"""Tensor parallelism: parameters partitioned over the ``model`` mesh dim
(counterpart of the JAX package's ``parallel/tensor.py``).

The JAX package annotates column-parallel parameter shardings and lets
GSPMD partition every matmul. No compiler partitions here, so the port
does it in the forward: the layers read each partitioned parameter as
this rank's :class:`ColumnBlock`, and ``x @ W`` with ``W`` split on its
output dim computes this rank's output columns and all-gathers them on
the feature dim (the backward keeps this rank's columns of the
cotangent, and the input's gradient is summed over the dim); any other
use of a block (a bias add, an embedding lookup, a layer norm's scale)
reads the whole parameter, gathered. Each rank updates its blocks against
its blocks of the updater state and the updated blocks are gathered back
into the net's parameter (``dsl_trainer``). The batch may be split over
``data`` besides (dp × tp).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import collectives as _coll
from .dsl_trainer import ShardedDSLTrainerBase, placement_from_spec
from .mesh import axis_group, axis_names, axis_size

Spec = Tuple[Optional[str], ...]


def param_partition_specs(net, model_axis: str = "model",
                          mesh=None) -> Dict[str, Dict[str, Spec]]:
    """Per-dim spec tuples (the JAX package's PartitionSpecs) for
    net.params: 2-D kernels column-parallel (output dim split), 4-D conv
    kernels split on output channels, 1-D params (biases, per-channel)
    split on their dim, the rest replicated. Dims not divisible by the
    mesh dim stay replicated."""
    ma = model_axis
    size = axis_size(mesh, model_axis) if mesh is not None else 1

    def ok(dim: int) -> bool:
        return dim % size == 0

    def spec_for(shape) -> Spec:
        if len(shape) == 2 and ok(shape[1]):     # dense/lstm kernels
            return (None, ma)
        if len(shape) == 4 and ok(shape[3]):     # conv HWIO
            return (None, None, None, ma)
        if len(shape) == 1 and shape[0] > 1 and ok(shape[0]):
            return (ma,)                         # biases / per-channel
        return ()

    params = net.params
    if params is None:
        raise ValueError("net.init() first")
    return {key: {name: spec_for(tuple(p.shape)) for name, p in lp.items()}
            for key, lp in params.items()}


class ColumnBlock(torch.Tensor):
    """This rank's block of a parameter split along ``dim`` over a process
    group, as the layers' forward reads it. ``x @ W`` with ``W`` split on
    its last (output) dim runs column-parallel: this rank's output columns
    from its block, the columns all-gathered (the input enters by
    ``collectives.copy_in``, so its gradient sums the ranks' shares; the
    gather's backward keeps this rank's columns). ``.to`` keeps the block;
    every other operation reads the whole parameter, gathered."""

    @staticmethod
    def of(local: torch.Tensor, group, dim: int) -> "ColumnBlock":
        out = local.as_subclass(ColumnBlock)
        out._group, out._dim = group, dim
        return out

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with torch._C.DisableTorchFunctionSubclass():
            if (func in (torch.matmul, torch.Tensor.matmul,
                         torch.Tensor.__matmul__) and len(args) == 2
                    and isinstance(args[1], ColumnBlock)
                    and not isinstance(args[0], ColumnBlock)
                    and args[1]._dim == args[1].ndim - 1):
                x, w = args
                y = torch.matmul(_coll.copy_in(x, w._group),
                                 w.as_subclass(torch.Tensor))
                return _coll.gather_dim(y, w._group, y.ndim - 1)
            if func is torch.Tensor.to and isinstance(args[0], ColumnBlock):
                w = args[0]
                out = func(w.as_subclass(torch.Tensor), *args[1:], **kwargs)
                return ColumnBlock.of(out, w._group, w._dim)

            def whole(a):
                if isinstance(a, ColumnBlock):
                    return _coll.gather_dim(a.as_subclass(torch.Tensor),
                                            a._group, a._dim)
                if isinstance(a, (list, tuple)):
                    return type(a)(whole(v) for v in a)
                return a
            return func(*whole(args), **{k: whole(v)
                                         for k, v in kwargs.items()})


def column_blocks(mesh, model_axis: str):
    """The block wrapper the tensor-parallel trainers hand
    ``ShardedDSLTrainerBase``: a partitioned parameter's block becomes a
    :class:`ColumnBlock` over the ``model_axis`` group."""
    group = axis_group(mesh, model_axis)

    def wrap(block: torch.Tensor, tdim: int) -> torch.Tensor:
        return ColumnBlock.of(block, group, tdim)
    return wrap


def shard_params(net, mesh, model_axis: str = "model"):
    """The placement — (dim name, tensor dim) per partitioned parameter —
    that the trainers hold parameters, updater slots and updates in."""
    specs = param_partition_specs(net, model_axis, mesh)
    return {key: {name: placement_from_spec(spec)
                  for name, spec in lp.items()}
            for key, lp in specs.items()}


class TensorParallelTrainer(ShardedDSLTrainerBase):
    """2-D (data × model) training for a MultiLayerNetwork.

    Usage::

        mesh = create_mesh({"data": 2, "model": 4})
        tp = TensorParallelTrainer(net, mesh)
        tp.fit_batch(x, y)          # updater state stays partitioned
    """

    _api = "TensorParallelTrainer"

    def __init__(self, net, mesh, data_axis: str = "data",
                 model_axis: str = "model"):
        if net.params is None:
            net.init()
        self.data_axis = data_axis if data_axis in axis_names(mesh) else None
        self.model_axis = model_axis
        self._build(net, mesh, x_spec=(self.data_axis,),
                    mask_spec=(self.data_axis,), batch_axis=self.data_axis,
                    param_placement=shard_params(net, mesh, model_axis),
                    local_compute=column_blocks(mesh, model_axis))


class TensorParallelGraphTrainer(ShardedDSLTrainerBase):
    """Tensor-parallel training for DSL models (``ComputationGraph`` or
    ``MultiLayerNetwork``): big weights column-partitioned over
    ``model_axis`` by :func:`param_partition_specs`, the batch split over
    ``data_axis`` when the mesh has it. Shares the sharded-trainer contract
    (masks, TBPTT chunk rejection, ``output()``) with the sequence/expert
    trainers."""

    _api = "TensorParallelGraphTrainer"

    def __init__(self, net, mesh, *, data_axis: str = "data",
                 model_axis: str = "model",
                 skip_nonfinite_budget: Optional[int] = None):
        if net.params is None:
            net.init()
        if model_axis not in axis_names(mesh):
            raise ValueError(f"model_axis {model_axis!r} not in mesh "
                             f"{axis_names(mesh)}")
        self.model_axis = model_axis
        batch_axis = data_axis if data_axis in axis_names(mesh) else None
        self._build(net, mesh, x_spec=(batch_axis,), mask_spec=(batch_axis,),
                    batch_axis=batch_axis,
                    param_placement=shard_params(net, mesh, model_axis),
                    local_compute=column_blocks(mesh, model_axis),
                    skip_nonfinite_budget=skip_nonfinite_budget)
