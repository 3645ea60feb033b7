"""Training listeners: per-iteration/epoch hooks fired by the fit loop
(counterpart of the JAX package's ``optimize/listeners.py``).

The port's training step runs asynchronously on the card; listeners fire
on the host after the step is queued. ``score`` arrives as a
:class:`LazyScore`: ``float(score)`` waits for the card and copies the loss
to the host (counted in ``training_host_syncs_total``), so a listener
gating on ``iteration % frequency`` costs one sync per window and a
listener that never reads the score costs none. ``fit_repeated`` and
``fit_scan`` read their K losses in one transfer and fire with host
floats (the reference's replay).

``LazyScore``, ``sync_counter`` and ``as_listener_score`` live in
``util/ingest.py``, as in the reference, and are re-exported here.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..util import metrics as _metrics
from ..util.ingest import (LazyScore, as_listener_score,  # noqa: F401
                           sync_counter)

logger = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    """Hook bus contract. `model` is the network; `iteration` is the global
    iteration counter (minibatches seen)."""

    def iteration_done(self, model, iteration: int, score) -> None:
        """``score`` is host-lazy (``LazyScore``): ``float(score)`` blocks
        on the device and transfers — do it at most once per frequency
        window."""
        pass

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass

    def on_forward_pass(self, model, activations) -> None:
        pass

    def on_gradient_calculation(self, model) -> None:
        pass

    def on_backward_pass(self, model) -> None:
        pass

    def on_step_skipped(self, model, iteration: int, reason: str,
                        info: Optional[dict] = None) -> None:
        """A training step was detected as divergent (e.g. non-finite
        gradients) and skipped — the params did not move this iteration.
        Fired by the resilience-guarded trainers (parallel wrapper /
        sharded DSL trainers with ``skip_nonfinite_budget`` set).

        ``info`` (when present) carries structured context: ``model``
        (name), ``iteration``, and — when NaN layer-of-origin attribution
        ran (``util.health.attribute_nonfinite``) — ``layer``,
        ``quantity`` and ``param`` of the first offending value. Legacy
        3-argument overrides keep working: the guards fire through
        :func:`fire_step_skipped`, which degrades to the old signature."""
        pass


def fire_step_skipped(listener, model, iteration: int, reason: str,
                      info: Optional[dict] = None) -> None:
    """Fire ``on_step_skipped`` with the structured ``info`` dict,
    degrading to the legacy 3-argument signature for user listeners that
    predate it — the one copy of the adaptive call the guards and
    composite listeners share."""
    hook = getattr(listener, "on_step_skipped", None)
    if hook is None:
        return
    try:
        import inspect
        sig = inspect.signature(hook)
        takes_info = any(p.name == "info" or p.kind == p.VAR_KEYWORD
                         for p in sig.parameters.values())
    except (TypeError, ValueError):
        takes_info = False
    if takes_info:
        hook(model, iteration, reason, info=info)
    else:
        hook(model, iteration, reason)


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (parity: ScoreIterationListener.java)."""

    def __init__(self, print_iterations: int = 10,
                 log_fn: Optional[Callable[[str], None]] = None):
        self.print_iterations = max(1, int(print_iterations))
        self._log = log_fn or logger.info

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_iterations == 0:
            self._log(f"Score at iteration {iteration} is {float(score)}")


class PerformanceListener(TrainingListener):
    """Throughput reporting (parity: PerformanceListener.java:71-86 —
    samples/sec and batches/sec over the reporting window)."""

    def __init__(self, frequency: int = 10, report_batch: bool = True,
                 report_sample: bool = True,
                 log_fn: Optional[Callable[[str], None]] = None):
        self.frequency = max(1, int(frequency))
        self.report_batch = report_batch
        self.report_sample = report_sample
        self._log = log_fn or logger.info
        self._last_time = None
        self._last_iter = 0
        self._samples = 0
        self.last_samples_per_sec: Optional[float] = None
        self.last_batches_per_sec: Optional[float] = None

    def record_batch(self, batch_size: int) -> None:
        self._samples += int(batch_size)

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            self._samples = 0
            return
        if (iteration - self._last_iter) >= self.frequency:
            dt = max(now - self._last_time, 1e-9)
            batches = iteration - self._last_iter
            self.last_batches_per_sec = batches / dt
            self.last_samples_per_sec = self._samples / dt
            parts = []
            if self.report_batch:
                parts.append(f"{self.last_batches_per_sec:.2f} batches/sec")
            if self.report_sample and self._samples:
                parts.append(f"{self.last_samples_per_sec:.2f} samples/sec")
            self._log(f"iteration {iteration}: " + ", ".join(parts))
            self._last_time = now
            self._last_iter = iteration
            self._samples = 0


class CollectScoresIterationListener(TrainingListener):
    """Accumulate (iteration, score) pairs in memory
    (parity: CollectScoresIterationListener.java)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class ComposableIterationListener(TrainingListener):
    """Fan one callback out to many (parity: ComposableIterationListener.java)."""

    def __init__(self, *listeners: TrainingListener):
        self.listeners = list(listeners)

    def record_batch(self, batch_size: int) -> None:
        for l in self.listeners:
            if hasattr(l, "record_batch"):
                l.record_batch(batch_size)

    def iteration_done(self, model, iteration, score):
        for l in self.listeners:
            l.iteration_done(model, iteration, score)

    def on_epoch_start(self, model, epoch):
        for l in self.listeners:
            l.on_epoch_start(model, epoch)

    def on_epoch_end(self, model, epoch):
        for l in self.listeners:
            l.on_epoch_end(model, epoch)

    def on_forward_pass(self, model, activations):
        for l in self.listeners:
            l.on_forward_pass(model, activations)

    def on_gradient_calculation(self, model):
        for l in self.listeners:
            l.on_gradient_calculation(model)

    def on_backward_pass(self, model):
        for l in self.listeners:
            l.on_backward_pass(model)

    def on_step_skipped(self, model, iteration, reason, info=None):
        for l in self.listeners:
            fire_step_skipped(l, model, iteration, reason, info)


class MetricsListener(TrainingListener):
    """Bridge training events into a
    :class:`~deeplearning4j_tpu_torch.util.metrics.MetricsRegistry`: iteration
    and epoch counters, a last-score gauge, an iteration-wall-time
    histogram, and skipped-step counts from the resilience-guarded
    trainers — the scrapeable twin of StatsListener (which feeds the UI).

    Reading ``score`` forces a device sync (same caveat as
    ScoreIterationListener); ``frequency=N`` reads it only every Nth
    iteration (the counters and wall-time histogram stay per-step — they
    never touch the device), and ``record_score=False`` keeps the
    listener entirely off the async dispatch path.
    """

    _ITER_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, registry=None, name: str = "net",
                 record_score: bool = True, frequency: int = 1):
        reg = registry if registry is not None else _metrics.REGISTRY
        self.registry = reg
        self.name = name
        self.record_score = record_score
        self.frequency = max(1, int(frequency))
        self._iterations = reg.counter(
            "training_iterations_total", "Training iterations completed",
            ("model",))
        self._epochs = reg.counter(
            "training_epochs_total", "Training epochs completed", ("model",))
        self._skipped = reg.counter(
            "training_steps_skipped_total",
            "Steps skipped by the non-finite guard; `layer` names the "
            "attributed origin (empty when attribution did not run)",
            ("model", "layer"))
        self._score = reg.gauge(
            "training_score", "Score at the latest iteration", ("model",))
        self._iter_time = reg.histogram(
            "training_iteration_seconds",
            "Wall time between consecutive iterations", ("model",),
            buckets=self._ITER_BUCKETS)
        self._last_time: Optional[float] = None

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        self._iterations.inc(model=self.name)
        if self._last_time is not None:
            self._iter_time.observe(now - self._last_time, model=self.name)
        self._last_time = now
        if self.record_score and iteration % self.frequency == 0:
            self._score.set(float(score), model=self.name)

    def on_epoch_end(self, model, epoch):
        self._epochs.inc(model=self.name)

    def on_step_skipped(self, model, iteration, reason, info=None):
        layer = (info or {}).get("layer") or ""
        self._skipped.inc(model=self.name, layer=layer)


class ParamAndGradientIterationListener(TrainingListener):
    """Log per-layer parameter and update magnitudes every N iterations
    (parity: ``ParamAndGradientIterationListener.java``).

    The reference prints parameter and raw-gradient statistics; here the
    UPDATE magnitude (parameter delta across the iteration) stands in for
    the gradient, which never leaves the fused jitted train step. Columns:
    mean |param|, mean |update|, and their ratio — the classic
    learning-rate sanity signal (~1e-3 is healthy).

    Use with ``fit``/``fit_batch``. The fused-scan paths
    (``fit_scan``/``fit_repeated``) replay listener fires AFTER all K
    updates landed, so deltas there are 0 — the listener prints a hint
    instead of a misleading zero signal.
    """

    def __init__(self, print_iterations: int = 10,
                 log_fn: Optional[Callable[[str], None]] = None):
        self.print_iterations = max(1, int(print_iterations))
        self._log = log_fn or logger.info
        self._prev = None

    @staticmethod
    def _flat(model):
        """{"['vertex']['param']": f32 host copy} (the reference's
        ``jax.tree_util.keystr`` names)."""
        return {f"['{v}']['{k}']": t.detach().float().cpu().numpy()
                for v, ps in model.params.items() for k, t in ps.items()}

    def iteration_done(self, model, iteration, score) -> None:
        prints = iteration % self.print_iterations == 0
        snapshots = (iteration + 1) % self.print_iterations == 0
        if not (prints or snapshots):
            return
        flat = self._flat(model)
        if prints:
            prev = self._prev or {}
            lines = []
            deltas = []
            for name, a in flat.items():
                p_mag = float(np.mean(np.abs(a)))
                if name in prev:
                    u_mag = float(np.mean(np.abs(a - prev[name])))
                    deltas.append(u_mag)
                    ratio = u_mag / (p_mag + 1e-12)
                    lines.append(f"  {name}: |p|={p_mag:.3e} "
                                 f"|Δp|={u_mag:.3e} ratio={ratio:.2e}")
                else:
                    lines.append(f"  {name}: |p|={p_mag:.3e}")
            if deltas and max(deltas) == 0.0:
                lines.append(
                    "  (all deltas are exactly 0 — fused-scan replay? "
                    "fit_scan/fit_repeated apply updates before listeners "
                    "fire; use fit/fit_batch with this listener)")
            self._log(f"iteration {iteration} param/update stats:\n"
                      + "\n".join(lines))
        if snapshots:
            # the iteration right before the next print: its delta to the
            # printed params is ONE update's magnitude
            self._prev = flat
