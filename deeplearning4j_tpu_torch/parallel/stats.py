"""Distributed-training phase timing: per-phase events and summaries
(counterpart of the JAX package's ``parallel/stats.py``).

Parity: reference Spark training stats — ``CommonSparkTrainingStats.java``
/ ``StatsCalculationHelper`` (phase timers around fit/aggregate) and
``StatsUtils.java:69-92`` ``exportStatsAsHtml``. The phases are the
trainers': host batch prep, the step, replica averaging, net sync.

Kernels are launched asynchronously, so a ``step`` phase measures the
launch unless ``blocking=True``, which synchronizes the device of the
tensors the timed section produced before closing the measurement.

The HTML timeline is built on the ``ui`` components, which are not ported
yet: :meth:`TrainingStats.as_components` and ``export_html`` raise
``NotYetPorted``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from .collectives import tree_tensors


@dataclasses.dataclass
class PhaseEvent:
    """One timed occurrence of a phase (parity: ``BaseEventStats``)."""

    phase: str
    start_ms: float
    duration_ms: float


class TrainingStats:
    """Collects phase events during distributed training.

    ``blocking=True`` waits for the device results of timed sections so
    step durations are device times, not launch times."""

    def __init__(self, blocking: bool = False, registry=None):
        self.blocking = blocking
        self.events: List[PhaseEvent] = []
        self._origin = time.perf_counter()
        # optional mirror into the metrics plane
        self._phase_hist = None
        if registry is not None:
            self._phase_hist = registry.histogram(
                "training_phase_seconds",
                "Distributed-training phase durations", ("phase",),
                buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                         0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0))

    def _now_ms(self) -> float:
        return (time.perf_counter() - self._origin) * 1000.0

    def _add(self, event: PhaseEvent) -> None:
        self.events.append(event)
        if self._phase_hist is not None:
            self._phase_hist.observe(event.duration_ms / 1000.0,
                                     phase=event.phase)

    @contextmanager
    def time_phase(self, phase: str, result_holder: Optional[list] = None):
        """Context manager timing one phase occurrence. If ``blocking`` and
        ``result_holder`` ends up holding CUDA tensors, waits for their
        devices before closing the measurement."""
        t0 = self._now_ms()
        try:
            yield
        finally:
            if self.blocking and result_holder:
                devices = {t.device for t in tree_tensors(result_holder)
                           if t.device.type == "cuda"}
                for dev in devices:
                    torch.cuda.synchronize(dev)
            self._add(PhaseEvent(phase, t0, self._now_ms() - t0))

    def record(self, phase: str, start_ms: float, duration_ms: float) -> None:
        self._add(PhaseEvent(phase, start_ms, duration_ms))

    # ------------------------------------------------------------------
    # summaries (parity: CommonSparkTrainingStats getValue/statsAsString)
    # ------------------------------------------------------------------

    def phases(self) -> List[str]:
        seen: Dict[str, None] = {}
        for e in self.events:
            seen.setdefault(e.phase, None)
        return list(seen)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for p in self.phases():
            ds = [e.duration_ms for e in self.events if e.phase == p]
            out[p] = {
                "count": len(ds),
                "total_ms": round(sum(ds), 3),
                "mean_ms": round(sum(ds) / len(ds), 3),
                "min_ms": round(min(ds), 3),
                "max_ms": round(max(ds), 3),
            }
        return out

    def as_json(self) -> str:
        return json.dumps({
            "summary": self.summary(),
            "events": [dataclasses.asdict(e) for e in self.events],
        })

    # ------------------------------------------------------------------
    # HTML timeline (parity: StatsUtils.exportStatsAsHtml :69-92)
    # ------------------------------------------------------------------

    def as_components(self) -> list:
        """Timeline + summary table as UI components (needs ``ui``)."""
        from ..nn.conf.layers import NotYetPorted
        raise NotYetPorted("TrainingStats.as_components: the ui components "
                           "are not yet ported to the PyTorch package")

    def export_html(self, path: str, title: str = "Training phase timeline"
                    ) -> None:
        """Standalone HTML timeline (needs ``ui``)."""
        from ..nn.conf.layers import NotYetPorted
        raise NotYetPorted("TrainingStats.export_html: the ui components "
                           "are not yet ported to the PyTorch package")


@contextmanager
def maybe_time_phase(stats: Optional[TrainingStats], phase: str,
                     result_holder: Optional[list] = None):
    """Null-safe ``time_phase``: a no-op when stats collection is off."""
    if stats is None:
        yield
    else:
        with stats.time_phase(phase, result_holder):
            yield
