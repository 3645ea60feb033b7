"""What a traced window shows: the device's busy time, its kernels, the
device time of the work under one of the harness's own annotations
(forward) and of the autograd nodes that work created (backward), and the
breakdown of device time and of idle gaps.

Work is attributed through the profiler's links, not kernel names: a
kernel belongs to the CPU op whose launch it was (the correlation id), an
op to the annotation it ran under, and a backward node to the forward op
of the same sequence number."""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

import torch

BACKWARD_PREFIX = "autograd::engine::evaluate_function:"


def profiler(host: bool):
    """A profiler of the device's activity and, with ``host``, of the host's
    ops too (which slows the host's dispatch, so the busy share is read
    from a window profiled without it)."""
    from torch.profiler import ProfilerActivity, profile
    acts = []
    if host or not torch.cuda.is_available():
        acts.append(ProfilerActivity.CPU)
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def annotate(module, attr: str, label: str) -> None:
    """Wrap ``module.attr`` so that each call runs under the profiler
    annotation ``label``."""
    fn = getattr(module, attr)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(module, attr, wrapped)


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _split(prof):
    from torch.autograd import DeviceType
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    host = [e for e in events
            if e.device_type == DeviceType.CPU and not e.is_async]
    return device, host


class TraceView:
    """Two profiled windows of ``steps`` steps (or ticks) each, back to
    back, each between a synchronise before the profiler started and one
    before it stopped: ``device_prof`` saw the device alone and gives the
    busy time (over its ``window_s`` by the host's clock), the kernels and
    the device time by kernel; ``host_prof`` saw the host's ops too and
    gives the attribution of device time to ops and the idle gaps by what
    the host was doing."""

    def __init__(self, device_prof, window_s: float, steps: int,
                 host_prof, main_thread=None):
        self.window_s = window_s
        self.steps = steps
        self.device, _ = _split(device_prof)
        self.host_device, self.cpu = _split(host_prof)
        self.main_thread = main_thread
        self._merged = _merge([(e.time_range.start, e.time_range.end)
                               for e in self.device])

    # -- the device --------------------------------------------------------

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged) * 1e-6

    def kernel_count(self) -> int:
        return sum(1 for e in self.device
                   if not e.name.startswith(("Memcpy", "Memset")))

    def device_ops(self, top: int = 10) -> List[List]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
        return [[n[:120], s] for n, s in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    # -- attribution -------------------------------------------------------

    def annotated_device_s(self, label: str) -> Optional[float]:
        """Device seconds of the kernels launched under ``label`` and of
        those of the backward nodes its forward ops created; None when no
        op ran under ``label``."""
        roots = [e for e in self.cpu if e.name == label]
        if not roots:
            return None
        fwd_us, seqs = 0.0, set()
        stack = list(roots)
        for r in roots:
            fwd_us += r.device_time_total
        while stack:
            e = stack.pop()
            if e.sequence_nr >= 0:
                seqs.add(e.sequence_nr)
            stack.extend(e.cpu_children)
        bwd_us = sum(e.device_time_total for e in self.cpu
                     if e.name.startswith(BACKWARD_PREFIX)
                     and e.sequence_nr in seqs)
        return (fwd_us + bwd_us) * 1e-6

    # -- idle gaps ---------------------------------------------------------

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The idle gaps between device work, summed by what the host was
        doing at each gap's middle (the innermost op on the dispatching
        thread), the largest sums first."""
        merged = _merge([(e.time_range.start, e.time_range.end)
                         for e in self.host_device])
        if len(merged) < 2:
            return []
        host = [e for e in self.cpu
                if self.main_thread is None or e.thread == self.main_thread]
        if not host:
            host = self.cpu
        host.sort(key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in host]
        gaps = [(b[0] - a[1], (a[1] + b[0]) / 2)
                for a, b in zip(merged, merged[1:])]
        gaps.sort(reverse=True)
        by_what: Dict[str, float] = collections.defaultdict(float)
        for length, mid in gaps[:2000]:
            what = "no host op"
            i = bisect.bisect_right(starts, mid)
            for e in reversed(host[max(0, i - 4000):i]):
                if e.time_range.end >= mid:
                    what = e.name
                    break
            by_what[what[:120]] += length * 1e-6
        return [[n, s] for n, s in
                sorted(by_what.items(), key=lambda kv: -kv[1])[:top]]
