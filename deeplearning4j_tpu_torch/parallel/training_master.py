"""TrainingMaster SPI: pluggable distributed-training strategies
(counterpart of the JAX package's ``parallel/training_master.py``).

Parity: reference ``dl4j-spark/src/main/java/org/deeplearning4j/spark/api/
TrainingMaster.java:29-111`` — the strategy seam that lets
``SparkDl4jMultiLayer.fit(rdd)`` run parameter averaging today and something
else tomorrow — and its one real implementation
``.../impl/paramavg/ParameterAveragingTrainingMaster.java:340-374``.

A strategy owns (a) how the step is split over the mesh and (b)
when/how replicas reconcile. The two collective strategies run one
process per device over a ``DeviceMesh`` (``parallel.distributed``):

- :class:`SyncTrainingMaster` — per-step gradient all-reduce (the strongest
  consistency; what the reference approximates with averagingFrequency=1).
- :class:`ParameterAveragingTrainingMaster` — independent replica steps with
  params/updater averaged every ``averaging_frequency`` iterations (exact
  reference semantics, right choice when the reconcile must cross DCN).
- :class:`ElasticTrainingMaster` — bounded-staleness local-SGD sync rounds
  over a shared coordination store, one PROCESS per host, with heartbeat/
  lease membership: a preempted host is evicted after a deadline instead of
  stalling the fleet, and a restarted host rejoins from its durable
  snapshot (:mod:`.elastic`). Unlike the two
  collective strategies it does not run collectives — a dead peer must not hang
  the survivors — so its trainer's ``fit(batch_fn, rounds=R)`` drives
  seeded per-host batches rather than a shared iterator.

Usage::

    master = ParameterAveragingTrainingMaster(averaging_frequency=4)
    trainer = master.build(net, mesh)    # net trained in place
    trainer.fit(iterator, epochs=2)
"""

from __future__ import annotations

import abc
from typing import Optional

from .wrapper import ParallelWrapper


class TrainingMaster(abc.ABC):
    """Strategy SPI (parity: ``TrainingMaster.java:29``).

    ``build(net, mesh)`` returns a trainer bound to the network and mesh —
    the analog of ``executeTraining``'s setup half; the trainer's
    ``fit``/``fit_batch``/``finish`` mirror the per-split execution.
    """

    def __init__(self, collect_stats: bool = False,
                 blocking_stats: bool = False):
        self.collect_stats = collect_stats
        self.blocking_stats = blocking_stats

    def _stats(self):
        """Phase-timing collector when ``collect_stats`` is on (parity:
        ``TrainingMaster.setCollectTrainingStats``)."""
        if not self.collect_stats:
            return None
        from .stats import TrainingStats
        return TrainingStats(blocking=self.blocking_stats)

    @abc.abstractmethod
    def build(self, net, mesh=None) -> "Trainer":
        """Bind the strategy to a network + mesh, returning a Trainer."""


class Trainer:
    """What a bound strategy hands back; wraps the data-parallel wrapper."""

    def __init__(self, wrapper: ParallelWrapper):
        self._pw = wrapper
        self.net = wrapper.net
        self.mesh = wrapper.mesh

    def fit(self, data, labels=None, *, epochs: int = 1, mask=None) -> None:
        self._pw.fit(data, labels, epochs=epochs, mask=mask)

    def fit_batch(self, x, y, mask=None):
        return self._pw.fit_batch(x, y, mask)

    def finish(self) -> None:
        """Reconcile any un-averaged replica state into the network."""
        self._pw.finish()

    def stats(self) -> Optional[dict]:
        """Per-phase timing summary when the master was built with
        ``collect_stats=True`` (parity: ``SparkTrainingStats``); else None."""
        if self._pw.stats is None:
            return None
        return self._pw.stats.summary()

    def training_stats(self):
        """The raw TrainingStats collector (events + HTML export), or None."""
        return self._pw.stats

    def export_stats_html(self, path: str) -> None:
        """Timeline chart export (parity: ``StatsUtils.java:69-92``)."""
        if self._pw.stats is None:
            raise ValueError("build the master with collect_stats=True")
        self._pw.stats.export_html(path)


class SyncTrainingMaster(TrainingMaster):
    """Per-step synchronous data parallelism: batch split over ``data``,
    params replicated, the gradients all-reduced every step."""

    def build(self, net, mesh=None) -> Trainer:
        return Trainer(ParallelWrapper(net, mesh=mesh, averaging_frequency=1,
                                       stats=self._stats()))


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Local-SGD with periodic averaging (parity:
    ``ParameterAveragingTrainingMaster.java`` semantics: each replica fits
    ``averaging_frequency`` minibatches between reconciles).

    The reference's knobs that still mean something here are kept;
    Spark plumbing knobs (repartitioning, export mode, RDD splits) have no
    analog — there is no data shipping to orchestrate.
    ``collect_stats`` mirrors ``TrainingMaster.setCollectTrainingStats``.
    """

    def __init__(self, averaging_frequency: int = 5,
                 collect_stats: bool = False, blocking_stats: bool = False):
        super().__init__(collect_stats, blocking_stats)
        if averaging_frequency < 1:
            raise ValueError("averaging_frequency must be >= 1")
        self.averaging_frequency = int(averaging_frequency)

    def build(self, net, mesh=None) -> Trainer:
        return Trainer(ParallelWrapper(
            net, mesh=mesh, averaging_frequency=self.averaging_frequency,
            stats=self._stats()))


class ElasticTrainingMaster(TrainingMaster):
    """Elastic bounded-staleness local SGD across host PROCESSES.

    Every host constructs the same master (same ``fleet`` spec and
    coordination directory, its own ``host`` id) and calls
    ``build(net[, mesh])``; with a mesh the local steps run data-parallel
    over this host's devices through a sync-mode :class:`ParallelWrapper`.
    The returned :class:`~.elastic.ElasticTrainer` exposes ``fit(batch_fn, rounds=R)`` plus the
    evict/rejoin machinery; see :mod:`.elastic`
    for the protocol and its determinism guarantees.
    """

    def __init__(self, coordination_dir, fleet, host, *,
                 steps_per_round: int = 4, max_staleness: int = 1,
                 lease_s: float = 10.0,
                 evict_after_s: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every_rounds: int = 1,
                 watchdog_s: Optional[float] = None,
                 handle_signals: bool = False, registry=None,
                 collect_stats: bool = False,
                 blocking_stats: bool = False):
        super().__init__(collect_stats, blocking_stats)
        self.coordination_dir = coordination_dir
        self.fleet = tuple(fleet)
        self.host = host
        self.steps_per_round = steps_per_round
        self.max_staleness = max_staleness
        self.lease_s = lease_s
        self.evict_after_s = evict_after_s
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_rounds = checkpoint_every_rounds
        self.watchdog_s = watchdog_s
        self.handle_signals = handle_signals
        self.registry = registry

    def build(self, net, mesh=None):
        from .elastic import ElasticConfig, ElasticTrainer
        cfg = ElasticConfig(
            fleet=self.fleet, host=self.host,
            steps_per_round=self.steps_per_round,
            max_staleness=self.max_staleness, lease_s=self.lease_s,
            evict_after_s=self.evict_after_s,
            checkpoint_every_rounds=self.checkpoint_every_rounds)
        factory = None
        if mesh is not None:
            stats = self._stats()
            factory = (lambda n: ParallelWrapper(
                n, mesh=mesh, averaging_frequency=1, stats=stats))
        return ElasticTrainer(
            net, self.coordination_dir, cfg,
            checkpoint_dir=self.checkpoint_dir, registry=self.registry,
            watchdog_s=self.watchdog_s,
            handle_signals=self.handle_signals,
            stepper_factory=factory)
