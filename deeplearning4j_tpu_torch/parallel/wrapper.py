"""ParallelWrapper: data-parallel training over a device mesh
(counterpart of the JAX package's ``parallel/wrapper.py``).

Parity: reference ``ParallelWrapper.java:37-204`` (parameter averaging
every ``averagingFrequency`` iterations, updater-state averaging at
``:163-186``) and ``ParameterAveragingTrainingMaster.java:763-832``.

Each rank of the mesh's ``data`` dim runs this program on its own device
and takes its rows of every (global) batch; both modes wrap the
runtimes' own step:

- **sync** (``averaging_frequency=1``): the runtime's step runs on this
  rank's rows inside ``collectives.batch_split`` (the loss denominators,
  BatchNormalization's moments and the penalties are those of the global
  batch), and its gradients are all-reduced over the ``data`` group
  before gradient normalization and the update — the per-step all-reduce
  that GSPMD inserts in the JAX package. The step is installed on the
  net, so ``net.fit``/``fit_batch`` run data-parallel from then on.
- **local-SGD** (``averaging_frequency=k > 1``): each rank's net is its
  replica and steps alone on its rows; every k steps the parameters,
  updater state and layer state are averaged over the group.

The cross-PROCESS analog of local SGD that survives a dead peer is
:mod:`.elastic`; an ``ElasticTrainer`` built with a mesh runs its local
steps through a sync-mode wrapper (``stepper_factory``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from . import collectives as _coll
from .mesh import axis_group, axis_names, axis_rank, axis_size
from .stats import maybe_time_phase


def _is_graph(net) -> bool:
    return hasattr(net.conf, "vertices")


def _rows(a, n: int, rank: int):
    """This rank's ``1/n`` of the leading (batch) dim."""
    if a is None:
        return None
    if isinstance(a, (list, tuple)):
        return [_rows(x, n, rank) for x in a]
    b = int(a.shape[0])
    if b % n:
        raise ValueError(
            f"batch size {b} not divisible by the {n}-device 'data' mesh "
            "axis (data parallelism splits the batch evenly across "
            "devices)")
    size = b // n
    return a[rank * size:(rank + 1) * size]


class DataParallelStep:
    """What the runtimes' step consults when a ParallelWrapper wraps the
    net (``net._data_parallel``): which rows are this rank's, the context
    the loss runs in, and the reduction of the gradients. ``reduce_grads``
    False is the local-SGD replica step (no reduction)."""

    def __init__(self, group, n: int, rank: int, *, reduce_grads: bool,
                 guard=None):
        self.group, self.n, self.rank = group, n, rank
        self.reduce_grads = reduce_grads
        self.guard = guard

    def shard(self, *arrays):
        return tuple(_rows(a, self.n, self.rank) for a in arrays)

    def loss_context(self):
        if not self.reduce_grads:
            return contextlib.nullcontext()
        return _coll.batch_split([self.group])

    def reduce(self, loss, grads, batch=None):
        """(loss, grads, ok): the global loss and gradients (sync mode)
        and whether the step is finite (always True without a guard)."""
        if self.reduce_grads:
            _coll.all_reduce_tree(grads, [self.group])
            loss = loss.clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=self.group)
        if self.guard is None:
            return loss, grads, True
        from ..optimize import updaters as _updaters
        ok = torch.logical_and(_updaters.all_finite(grads),
                               torch.isfinite(loss).all())
        self.guard.step(ok, batch=batch)   # raises once over budget
        return loss, grads, bool(ok)


class ParallelWrapper:
    """Wrap an (initialized) network for data-parallel training.

    Usage (as in the reference)::

        net = MultiLayerNetwork(conf, device="cuda").init()
        pw = ParallelWrapper(net, mesh=None, averaging_frequency=1)
        pw.fit(iterator, epochs=2)        # trains net in place

    Every rank passes the same GLOBAL batches; each trains on its rows.
    ``averaging_frequency=1`` → per-step gradient all-reduce (sync).
    ``averaging_frequency=k>1`` → independent replica steps; params +
    updater state + layer states averaged every k iterations.
    """

    def __init__(self, net, mesh=None, averaging_frequency: int = 1,
                 stats=None, skip_nonfinite_budget: Optional[int] = None):
        from .mesh import data_parallel_mesh
        if net.params is None:
            net.init()
        self.net = net
        self.mesh = (mesh if mesh is not None
                     else data_parallel_mesh(device_type=net.device.type))
        if "data" not in axis_names(self.mesh):
            raise ValueError(f"mesh must have a 'data' axis, got "
                             f"{axis_names(self.mesh)}")
        self.averaging_frequency = int(averaging_frequency)
        self.n_devices = axis_size(self.mesh, "data")
        self._group = axis_group(self.mesh, "data")
        self._rank = axis_rank(self.mesh, "data")
        self._local: Optional[_LocalSgdState] = None
        # resilience: with a budget set, steps whose gradients (or loss)
        # are non-finite are skipped (the old parameters and optimizer state
        # kept) and
        # counted on the host, raising once the budget is exhausted; the
        # per-step finiteness read is a host sync, so it is opt-in
        self.nonfinite_guard = None
        if skip_nonfinite_budget is not None:
            from ..util.resilience import NonFiniteGuard
            self.nonfinite_guard = NonFiniteGuard(
                int(skip_nonfinite_budget), net)
        # phase timing (parity: SparkTrainingStats); stats=True builds a
        # default collector, or pass a TrainingStats
        if stats is True:
            from .stats import TrainingStats
            stats = TrainingStats()
        self.stats = stats or None
        if self.averaging_frequency < 1:
            raise ValueError("averaging_frequency must be >= 1")
        if self.averaging_frequency == 1:
            # the net's own fit/fit_batch run data-parallel from here on
            net._data_parallel = DataParallelStep(
                self._group, self.n_devices, self._rank, reduce_grads=True,
                guard=self.nonfinite_guard)

    def _ensure_local(self) -> "_LocalSgdState":
        if self._local is None:
            self._local = _LocalSgdState(self)
        return self._local

    # ------------------------------------------------------------------
    # fit API
    # ------------------------------------------------------------------

    def fit(self, data, labels=None, *, epochs: int = 1, mask=None) -> None:
        if _is_graph(self.net) and mask is not None:
            raise ValueError(
                "ComputationGraph: pass masks via DataSet batches, "
                "not the mask kwarg")
        local = (self._ensure_local()
                 if self.averaging_frequency > 1 else None)
        net = self.net
        for epoch in range(epochs):
            # lazy epoch-start reset; revive an iterator a previous fit()
            # exhausted
            if hasattr(data, "reset") and (
                    epoch > 0 or (hasattr(data, "has_next")
                                  and not data.has_next())):
                data.reset()
            for l in net.listeners:
                l.on_epoch_start(net, net.epoch_count)
            batch_iter = iter(net._as_batches(data, labels, mask))
            n_batches = 0
            while True:
                with maybe_time_phase(self.stats, "batch_prep"):
                    batch = next(batch_iter, None)
                if batch is None:
                    break
                n_batches += 1
                x, y, m = batch
                if local is not None:
                    self._timed_local_step(local, x, y, m)
                else:
                    self._timed_sync_step(x, y, m)
            if n_batches == 0 and epoch > 0:
                raise ValueError(
                    f"epoch {epoch} yielded no batches — the data iterator "
                    "is exhausted and not resettable; pass arrays/DataSets "
                    "or a resettable iterator for multi-epoch fit")
            for l in net.listeners:
                l.on_epoch_end(net, net.epoch_count)
            net.epoch_count += 1
        if local is not None:
            self._timed_sync_to_net(local)

    def _timed_sync_step(self, x, y, mask):
        holder = []
        with maybe_time_phase(self.stats, "step", holder):
            loss = self.net.fit_batch(x, y, mask)
            holder.append(loss)
        return loss

    def _timed_local_step(self, local, x, y, mask):
        holder = []
        with maybe_time_phase(self.stats, "step", holder):
            loss = local.fit_batch(x, y, mask)
            holder.append(loss)
        if local._steps_since_avg == 0:
            self._timed_sync_to_net(local)
        return loss

    def _timed_sync_to_net(self, local):
        holder = []
        with maybe_time_phase(self.stats, "sync_to_net", holder):
            local.sync_to_net()
            holder.append(self.net.params)

    def fit_batch(self, x, y, mask=None):
        """One update on a GLOBAL batch. In local-SGD mode replicas step
        independently and average every ``averaging_frequency`` calls —
        call :meth:`finish` (or ``average_now``) after the last batch to
        flush a partial window."""
        if self.averaging_frequency == 1:
            return self._timed_sync_step(x, y, mask)
        return self._timed_local_step(self._ensure_local(), x, y, mask)

    def finish(self) -> None:
        """Flush local-SGD replicas into the wrapped net (average)."""
        if self._local is not None:
            self._local.sync_to_net()

    def average_now(self) -> None:
        """Force a parameter average (local-SGD mode)."""
        if self._local is not None:
            self._local.average()
            self._local.sync_to_net()


class _LocalSgdState:
    """The local-SGD window: this rank's net is its replica."""

    def __init__(self, pw: ParallelWrapper):
        self.pw = pw
        self.net = pw.net
        self.n = pw.n_devices
        self.k = pw.averaging_frequency
        self._steps_since_avg = 0
        self._step = DataParallelStep(pw._group, pw.n_devices, pw._rank,
                                      reduce_grads=False,
                                      guard=pw.nonfinite_guard)

    def fit_batch(self, x, y, mask=None):
        net = self.net
        xs, ys, ms = net._stage(x, y, mask)
        bs = (xs[0] if _is_graph(net) else xs).shape[0]
        net._data_parallel = self._step
        try:
            loss = net._steps([(xs, ys, ms)])[0]
        finally:
            net._data_parallel = None
        self._steps_since_avg += 1
        if self._steps_since_avg >= self.k:
            self.average()
        # the score is the replicas' mean loss (stays on the device)
        score = loss.detach().clone()
        dist.all_reduce(score, op=dist.ReduceOp.SUM, group=self.pw._group)
        score = score / self.n
        net._score = score
        net._fire_iteration(bs, score)
        return score

    def average(self) -> None:
        """Parameter + updater-state + layer-state averaging (parity:
        ``ParallelWrapper.java:145,:163-186``)."""
        holder = []
        net = self.net
        with maybe_time_phase(self.pw.stats, "average", holder):
            group = [self.pw._group]
            _coll.all_reduce_tree(net.params, group, average=True)
            _coll.all_reduce_tree(net.updater_state, group, average=True)
            _coll.all_reduce_tree(net.state, group, average=True)
            holder.append(net.params)
        self._steps_since_avg = 0

    def sync_to_net(self) -> None:
        """Average any un-averaged window into the net (every replica ends
        with the same values)."""
        if self._steps_since_avg:
            self.average()
