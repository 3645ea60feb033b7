"""What a run measured, handed to each per-layer metric's reader
(``read(run) -> float | None`` in ``benchmark/metrics/<name>.py``, or in
the file of the metric's quantity, its name up to the first dot)."""

from __future__ import annotations

from typing import Dict, Optional

from . import counts


def _series_value(snapshot: dict, name: str, field: str, labels: dict):
    fam = snapshot.get(name)
    if fam is None:
        return 0.0
    return sum(s.get(field, 0.0) for s in fam["series"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


class RunRecord:
    """``cell``'s configuration and traffic, the device's published peaks
    (None off the table), the measured window (``window_s`` seconds,
    ``steps`` steps), the program's registry before and after it, and, in
    a ``--trace 1`` run, the steps profiled after the window closed
    (``trace``, a :class:`~harness.trace.TraceView`)."""

    def __init__(self, cell, device_kind: str):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.peaks = counts.peaks_for(device_kind)
        self.window_s: Optional[float] = None
        self.steps: int = 0
        self.before: Dict = {}
        self.after: Dict = {}
        self.trace = None

    def delta(self, name: str, field: str = "value", **labels) -> float:
        """A counter's (``field="value"``) or a histogram's (``"sum"``,
        ``"count"``) change over the window, summed over the series whose
        labels include ``labels``."""
        return (_series_value(self.after, name, field, labels)
                - _series_value(self.before, name, field, labels))

    def step_s(self) -> Optional[float]:
        """The measured window's wall time per step."""
        return self.window_s / self.steps if self.steps else None
