"""Profiling helpers: device trace capture, step timing, MFU (counterpart
of the JAX package's ``util/profiling.py``).

``torch.profiler`` takes the place of ``jax.profiler``: a capture records
the host's operators and, when a card is present, its kernels (CUPTI),
and writes one Chrome trace (``trace.json``, viewable in Perfetto) into a
fresh run directory. The contract is the reference's:

- :func:`capture_trace` records for N seconds under a process-wide
  single-capture guard (:class:`ProfilerBusy` while one runs — the
  server's ``POST /profile`` answers 409), and :class:`StepCapture` is the
  piecewise form that brackets an exact step range
  (``DL4JTPU_PROFILE_STEPS=start:stop[:dir]``);
- :func:`register_device_memory_gauges` publishes
  ``device_memory_bytes{device,kind}`` (in_use/peak/limit) sampled at
  exposition time from ``torch.cuda.memory_stats()`` and
  ``torch.cuda.mem_get_info()``; on the CPU the series are absent;
- :func:`time_steps` times a step callable with a device barrier per
  sample, and the analytic FLOPs helpers and :func:`mfu` are the
  reference's arithmetic.

A profile and a CUDA graph capture exclude each other: a graph capture
(``util/capture.py``) waits while a profile is open, and a profile waits
for a capture in progress to finish before it starts
(:func:`graph_capture_guard`). Captures of different engines in one
process serialize on the same guard.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")

# bf16 dense peak FLOP/s per card by device name (NVIDIA's H100 SXM data
# sheet: 989 TFLOP/s bf16 dense, at the card's full 700 W limit)
PEAK_FLOPS = {
    "h100": 989e12,
}


def peak_flops_per_sec(device=None) -> Optional[float]:
    """bf16 peak of the attached card (``device``: an index or
    ``torch.device``, the current card by default), or None without a
    card or for a card not in the table — :func:`mfu` then raises asking
    for an explicit peak."""
    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_FLOPS.items():
        if key in kind:
            return peak
    return None


def mfu(examples_per_sec: float, flops_per_example: float,
        peak: Optional[float] = None) -> float:
    """Model FLOPs utilization: useful analytic FLOPs over peak. Raises
    ValueError when no ``peak`` is given and the attached device's peak
    is unknown (the CPU and unknown cards have no meaningful MFU)."""
    if peak is None:
        peak = peak_flops_per_sec()
        if peak is None:
            kind = (torch.cuda.get_device_name()
                    if torch.cuda.is_available() else "cpu")
            raise ValueError(
                f"unknown device kind {kind!r} has no published peak — "
                "pass peak= explicitly (MFU is undefined without a "
                "denominator)")
    return examples_per_sec * flops_per_example / peak


# ----------------------------------------------------------------------
# device trace capture (single-capture guard)
# ----------------------------------------------------------------------

class ProfilerBusy(RuntimeError):
    """A profiler capture is already in progress (one at a time). HTTP
    surfaces answer 409."""


# one profile at a time, process-wide: the guard turns a second start
# into a clean "busy" the HTTP endpoints answer as 409
_capture_lock = threading.Lock()
# held for the whole of a profile and of every CUDA graph capture: the
# two never overlap, and graph captures never overlap each other
_device_trace_lock = threading.Lock()


def capture_in_progress() -> bool:
    return _capture_lock.locked()


@contextlib.contextmanager
def graph_capture_guard() -> Iterator[None]:
    """Held around a CUDA graph capture: waits while a profile is open
    (or another capture runs), and keeps a profile from starting until
    the capture is done."""
    with _device_trace_lock:
        yield


def _acquire_capture() -> None:
    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy(
            "a profiler capture is already in progress (one at a time)")


def default_capture_dir() -> str:
    """Capture root: ``DL4JTPU_PROFILE_DIR`` or the system temp dir."""
    return (os.environ.get("DL4JTPU_PROFILE_DIR")
            or os.path.join(tempfile.gettempdir(), "dl4jtpu_profile"))


def _new_run_dir(log_dir: Optional[str]) -> str:
    d = os.path.join(
        log_dir or default_capture_dir(),
        f"capture_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    return d


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _all_threads_config():
    """Record the operators of every thread, not only the one that
    started the profile (an HTTP handler thread starts it while the
    batcher and scheduler threads do the work). Kineto's option where
    this PyTorch has it; the card's kernels are recorded process-wide
    either way."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def _profiler():
    return torch.profiler.profile(activities=_activities(),
                                  experimental_config=_all_threads_config())


# Kineto sets itself up at the first start in a process; made off the
# thread that loaded PyTorch, that first capture records no operator (it
# logs "External init callback must run in same thread as
# registerClient"), and later ones do. Servers answer POST /profile on a
# handler thread, so they prime the profiler when built on the main thread.
_primed = False


def prime_profiler() -> None:
    """One empty start/stop of the profiler, on the main thread only (see
    above); idempotent, and a no-op off the main thread."""
    global _primed
    if _primed or threading.current_thread() is not threading.main_thread():
        return
    with _capture_lock, _device_trace_lock:
        if not _primed:
            first = _profiler()
            first.start()
            first.stop()
            _primed = True


class _Session:
    """One open profile: started under both guards, written on stop."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._prof = _profiler()

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(os.path.join(self.run_dir,
                                                    "trace.json"))
        with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
            json.dump(_summary(self._prof), f)


def _summary(prof) -> dict:
    """Operator and kernel totals of a finished profile, largest first
    (microseconds; device time where the profiler recorded any)."""
    rows = []
    for e in prof.key_averages():
        rows.append({"name": e.key, "count": int(e.count),
                     "cpu_us": float(e.self_cpu_time_total),
                     "device_us": float(getattr(e, "self_device_time_total",
                                                0.0) or 0.0)})
    rows.sort(key=lambda r: -(r["device_us"] or r["cpu_us"]))
    return {"events": rows}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the process into ``log_dir`` for the block (``trace.json``
    and ``summary.json``). Holds the single-capture guard (raises
    :class:`ProfilerBusy` if another profile is running) and the device
    trace guard (waits for a CUDA graph capture in progress)."""
    _acquire_capture()
    try:
        with _device_trace_lock:
            session = _Session(log_dir)
            session.start()
            try:
                yield
            finally:
                session.stop()
    finally:
        _capture_lock.release()


def capture_trace(seconds: float, log_dir: Optional[str] = None) -> str:
    """Blocking on-demand capture: profile whatever the process does for
    the next ``seconds``, into a fresh timestamped run directory (under
    ``log_dir`` / ``DL4JTPU_PROFILE_DIR`` / the temp dir). Returns the run
    directory; raises :class:`ProfilerBusy` while another capture runs —
    the ``POST /profile?seconds=N`` implementation."""
    seconds = float(seconds)
    if not 0 < seconds <= 300:
        raise ValueError(f"seconds must be in (0, 300], got {seconds}")
    run_dir = _new_run_dir(log_dir)
    with trace(run_dir):
        time.sleep(seconds)
    return run_dir


class StepCapture:
    """Piecewise capture bracketing a step range: the profiler starts
    before step ``start`` and stops after step ``stop-1`` (two separate
    calls), holding both guards for the whole window. A busy profiler
    skips the capture with a warning instead of failing the run."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self.run_dir: Optional[str] = None
        self.active = False
        self._session: Optional[_Session] = None

    def start(self) -> bool:
        try:
            _acquire_capture()
        except ProfilerBusy:
            logger.warning(
                "DL4JTPU_PROFILE_STEPS capture skipped: another profiler "
                "capture is in progress")
            return False
        _device_trace_lock.acquire()
        try:
            self.run_dir = _new_run_dir(self.log_dir)
            self._session = _Session(self.run_dir)
            self._session.start()
        except Exception:
            _device_trace_lock.release()
            _capture_lock.release()
            raise
        self.active = True
        logger.info("profiler capture started into %s", self.run_dir)
        return True

    def stop(self) -> Optional[str]:
        if not self.active:
            return None
        try:
            self._session.stop()
        finally:
            self.active = False
            self._session = None
            _device_trace_lock.release()
            _capture_lock.release()
        logger.info("profiler capture written to %s", self.run_dir)
        return self.run_dir


def profile_request(query: Dict[str, list]) -> Tuple[dict, int]:
    """The ``POST /profile?seconds=N[&dir=...]`` implementation: parse-qs
    style query dict in, (json body, http code) out. Blocks the calling
    handler thread for the capture window; a concurrent capture answers
    409."""
    try:
        seconds = float(query.get("seconds", ["1"])[0])
    except (TypeError, ValueError) as e:
        return {"error": f"bad seconds: {e}"}, 400
    log_dir = query.get("dir", [None])[0]
    try:
        run_dir = capture_trace(seconds, log_dir)
    except ProfilerBusy as e:
        return {"error": str(e)}, 409
    except ValueError as e:
        return {"error": str(e)}, 400
    return {"ok": True, "dir": run_dir, "seconds": seconds}, 200


# (kind label, torch.cuda.memory_stats key); "limit" is the card's total
# memory (torch.cuda.mem_get_info)
_MEMORY_KINDS = (("in_use", "allocated_bytes.all.current"),
                 ("peak", "allocated_bytes.all.peak"))


def register_device_memory_gauges(registry=None):
    """Per-card callback gauges ``device_memory_bytes{device,kind}``
    (kind = in_use/peak/limit) sampled live at exposition time.
    Idempotent; without a card no series is registered, leaving only the
    family header (the reference's CPU behaviour)."""
    from . import metrics as _metrics
    reg = registry if registry is not None else _metrics.REGISTRY
    g = reg.gauge(
        "device_memory_bytes",
        "Per-device memory from the backend's memory_stats(), sampled at "
        "exposition time (kind: in_use/peak/limit; series absent when "
        "the backend exposes no stats)", ("device", "kind"))
    if not torch.cuda.is_available():
        return g

    def sampler(index, key):
        def fn() -> float:
            stats = torch.cuda.memory_stats(index)
            if key not in stats:
                raise LookupError(f"{key} unavailable on cuda:{index}")
            return float(stats[key])
        return fn

    for i in range(torch.cuda.device_count()):
        label = f"cuda:{i}"
        for kind, key in _MEMORY_KINDS:
            g.set_function(sampler(i, key), device=label, kind=kind)
        g.set_function(lambda i=i: float(torch.cuda.mem_get_info(i)[1]),
                       device=label, kind="limit")
    return g


def profile_steps_env() -> Optional[Tuple[int, int, Optional[str]]]:
    """Parse ``DL4JTPU_PROFILE_STEPS=start:stop[:dir]`` (0-based step
    indices, stop-exclusive). Returns (start, stop, dir) or None when
    unset."""
    raw = os.environ.get("DL4JTPU_PROFILE_STEPS", "").strip()
    if not raw:
        return None
    parts = raw.split(":", 2)
    if len(parts) < 2:
        raise ValueError(
            f"DL4JTPU_PROFILE_STEPS={raw!r} is not start:stop[:dir]")
    start, stop = int(parts[0]), int(parts[1])
    if start < 0 or stop <= start:
        raise ValueError(
            f"DL4JTPU_PROFILE_STEPS={raw!r}: need 0 <= start < stop")
    return start, stop, (parts[2] or None) if len(parts) > 2 else None


@dataclass
class StepTiming:
    mean_ms: float
    min_ms: float
    max_ms: float
    steps: int


def time_steps(step_fn: Callable[[], object], steps: int = 10,
               warmup: int = 2) -> StepTiming:
    """Wall-time a step callable, each sample ending in a device barrier
    (``torch.cuda.synchronize`` when a card is present): PyTorch returns
    before the card finishes, so a host clock without it times the
    enqueue."""
    def run_once() -> float:
        t0 = time.perf_counter()
        step_fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000.0

    for _ in range(warmup):
        run_once()
    samples = [run_once() for _ in range(steps)]
    return StepTiming(mean_ms=float(np.mean(samples)),
                      min_ms=float(np.min(samples)),
                      max_ms=float(np.max(samples)), steps=steps)


# ----------------------------------------------------------------------
# Analytic FLOPs for common layer shapes (the reference's arithmetic)
# ----------------------------------------------------------------------

def conv2d_flops(out_h: int, out_w: int, kh: int, kw: int, cin: int,
                 cout: int) -> float:
    """MACs×2 for one example's conv forward."""
    return 2.0 * out_h * out_w * kh * kw * cin * cout


def dense_flops(n_in: int, n_out: int) -> float:
    return 2.0 * n_in * n_out


def lstm_flops(seq_len: int, n_in: int, hidden: int) -> float:
    """Gates: 4 matmuls of [n_in+hidden, hidden] per timestep."""
    return 2.0 * seq_len * 4 * (n_in + hidden) * hidden


def train_flops(forward_flops: float) -> float:
    """Training step ≈ 3× forward (fwd + dx + dW), the standard accounting."""
    return 3.0 * forward_flops
