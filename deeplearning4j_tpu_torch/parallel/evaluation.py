"""Mesh-sharded evaluation and scoring (counterpart of the JAX package's
``parallel/evaluation.py``).

Parity: reference distributed evaluation — workers evaluate partitions
and the Spark master reduces the ``Evaluation`` objects
(``dl4j-spark/.../evaluation/EvaluateFlatMapFunction.java``,
``EvaluationReduceFunction.java``) plus distributed scoring
(``scoring/ScoreExamplesFunction.java``).

Every rank of the mesh's ``data`` dim is handed the same GLOBAL batches.
A batch is padded to a multiple of the dim's size (the last row
repeated), each rank runs the forward on its rows, and the pad rows are
masked out of the metrics; the per-rank confusion counts are then
all-reduced, so every rank ends with the global ``Evaluation``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import collectives as _coll
from .mesh import axis_group, axis_names, axis_rank, axis_size


def _is_graph(net) -> bool:
    return hasattr(net.conf, "vertices")


def _pad_to(x: np.ndarray, m: int):
    b = x.shape[0]
    pad = (-b) % m
    if pad == 0:
        return x, b
    reps = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
    return reps, b


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy() if a.is_floating_point() \
            else a.detach().cpu().numpy()
    return np.asarray(a)


class ShardedEvaluator:
    """Evaluate / score a network with batches split over the mesh.

    Usage::

        ev = ShardedEvaluator(net, mesh).evaluate(test_iterator)
        print(ev.stats())
    """

    def __init__(self, net, mesh=None, axis: str = "data"):
        from .mesh import data_parallel_mesh
        if net.params is None:
            net.init()
        if _is_graph(net) and (len(net.conf.network_inputs) != 1
                               or len(net.conf.network_outputs) != 1):
            raise ValueError(
                "ShardedEvaluator supports single-input/single-output "
                f"graphs; got {len(net.conf.network_inputs)} inputs / "
                f"{len(net.conf.network_outputs)} outputs — evaluate "
                "multi-io graphs per-output with net.output() + Evaluation")
        self.net = net
        self.mesh = (mesh if mesh is not None
                     else data_parallel_mesh(device_type=net.device.type))
        if axis not in axis_names(self.mesh):
            raise ValueError(
                f"mesh has no {axis!r} axis: {axis_names(self.mesh)}")
        self.axis = axis
        self.n = axis_size(self.mesh, axis)
        self._group = axis_group(self.mesh, axis)
        self._rank = axis_rank(self.mesh, axis)

    def _my_rows(self, a: np.ndarray) -> np.ndarray:
        size = a.shape[0] // self.n
        return a[self._rank * size:(self._rank + 1) * size]

    def _local_output(self, xp: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            out = self.net.output(self._my_rows(xp))
        return out[0] if isinstance(out, (list, tuple)) else out

    def output(self, x) -> np.ndarray:
        """Sharded forward on one (possibly indivisible) batch."""
        xp, b = _pad_to(_host(x), self.n)
        out = _coll.all_gather_dim(self._local_output(xp), self._group, 0)
        return _host(out)[:b]

    def evaluate(self, data, labels=None, evaluation=None):
        """Sharded ``Evaluation`` over an iterator / arrays; every rank
        returns the global counts. Pass an existing ``evaluation`` to
        accumulate into it."""
        from ..eval import Evaluation
        ev = evaluation if evaluation is not None else Evaluation()
        local = Evaluation()
        for x, y, m in self.net._as_batches(data, labels):
            y = _host(y)
            xp, b = _pad_to(_host(x), self.n)
            yp, _ = _pad_to(y, self.n)
            keep = np.ones(yp.shape[:-1] if yp.ndim > 1 else yp.shape,
                           np.float32)
            keep[b:] = 0.0
            if m is not None:
                mp, _ = _pad_to(_host(m), self.n)
                keep = keep * mp.reshape(keep.shape)
            out = self._local_output(xp)
            local.eval(self._my_rows(yp), _host(out),
                       mask=self._my_rows(keep))
        if hasattr(data, "reset"):
            data.reset()
        self._all_reduce_counts(local)
        ev.merge(local)
        return ev

    def _all_reduce_counts(self, ev) -> None:
        """Sum the ranks' confusion counts (every rank sizes its matrix to
        the largest class count first)."""
        k = torch.tensor([0 if ev.confusion is None
                          else len(ev.confusion.classes)], dtype=torch.int64)
        self._reduce(k, dist.ReduceOp.MAX)
        n_cls = int(k.item())
        if n_cls == 0:
            return
        ev._ensure_confusion(n_cls)
        ev.confusion.grow_to(n_cls)
        ev.num_classes = n_cls
        counts = torch.from_numpy(np.concatenate(
            [ev.confusion.matrix.reshape(-1), [ev._examples]]))
        self._reduce(counts, dist.ReduceOp.SUM)
        counts = counts.numpy()
        ev.confusion.matrix = counts[:-1].reshape(n_cls, n_cls).copy()
        ev._examples = int(counts[-1])

    def _reduce(self, t: torch.Tensor, op) -> None:
        """All-reduce a host tensor in place over the dim's group (through
        the group's device for NCCL)."""
        if _coll.group_size(self._group) == 1:
            return
        d = t.to(_coll.group_device([self._group]))
        dist.all_reduce(d, op=op, group=self._group)
        if d is not t:
            t.copy_(d.cpu())

    def _loss_share(self, x, y) -> torch.Tensor:
        """This rank's share of the global mean loss of (x, y)."""
        net = self.net
        xs = net._to_input(self._my_rows(x))
        ys = net._to_input(self._my_rows(y))
        with torch.no_grad(), _coll.batch_split([self._group]):
            if _is_graph(net):
                return net._loss_fn([xs], [ys], None)
            return net._loss_fn(xs, ys, None)[0]

    def score(self, data, labels=None, average: bool = True) -> float:
        """Sharded mean loss (parity: distributed ``calculateScore``);
        masked batches and batches not divisible by the mesh dim take the
        unsharded scorer, so padding never pollutes the mean."""
        net = self.net
        total, n = 0.0, 0
        for x, y, m in net._as_batches(data, labels):
            x, y = _host(x), _host(y)
            b = x.shape[0]
            if m is None and b % self.n == 0:
                s = self._loss_share(x, y).detach().clone()
                if _coll.group_size(self._group) > 1:
                    dist.all_reduce(s, op=dist.ReduceOp.SUM,
                                    group=self._group)
                s = float(s)
            elif _is_graph(net):
                s = net.score_for([x], [y], None if m is None else [_host(m)])
            else:
                s = net.score_for(x, y, None if m is None else _host(m))
            total += float(s) * b
            n += b
        if hasattr(data, "reset"):
            data.reset()
        return total / max(n, 1) if average else total


def evaluate_sharded(net, data, labels=None, mesh=None):
    """One-shot helper: ``evaluate_sharded(net, test_iter, mesh=mesh)``."""
    return ShardedEvaluator(net, mesh).evaluate(data, labels)
