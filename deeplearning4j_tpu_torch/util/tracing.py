"""Tracing substrate: spans with parent links, JSONL export, seam context,
and serializable cross-scope propagation.

A copy of the JAX package's ``util/tracing.py`` (host code, no JAX math),
with :func:`phase` added for the profiler.

The companion of :mod:`deeplearning4j_tpu_torch.util.metrics`: metrics say *how
often* and *how long* in aggregate; a trace says what ONE request did —
queue wait → batch assembly → model call as parented spans with wall +
monotonic timestamps.

Spans cross threads (an HTTP handler enqueues, the batcher answers), so
parenting is explicit: ``tracer.start(name, parent=...)`` / ``span.end()``
for cross-thread spans, and the ``tracer.span(...)`` context manager for
same-thread nesting (the active span is tracked per-thread and becomes
the default parent).

Spans also cross PROCESSES and HTTP hops (Dapper-style context
propagation, Sigelman et al. 2010): every span carries ``host`` and
``pid`` next to its ids, and :func:`inject` / :func:`extract` serialize
the identifying pair as a W3C-traceparent-style string
(``00-<trace_id>-<span_id>-01``) that rides an environment variable into
a forked fleet child or a ``traceparent`` HTTP header into a server. The
extracted :class:`SpanContext` is a valid ``parent=`` for
``tracer.start`` — the remote child's spans join the caller's trace, and
``util.timeline`` (ported with the serving fleet) merges the per-process exports
into one fleet/request timeline.

Chaos-test integration: entering ``span()`` stamps the active span into
the :mod:`deeplearning4j_tpu_torch.util.faults` seam context, so a scripted
fault records WHICH span it landed in (``FaultPlan.trigger_context``) —
"the injected infer failure hit the model-call span of trace X" becomes
an assertable fact instead of a guess. The same provider feeds the
flight recorder: every flight event recorded while a span is active
carries the active ``trace_id``/``span_id``, so a watchdog or crash dump
cross-references the exact request or round it interrupted.

Phases (:func:`phase`) are the hot path's form: the fit loop and both
runtimes' update mark a step's phases with it, and the stager its copies.
A phase is a span when a tracer is attached and a ``record_function``
range while a ``torch.profiler`` records, both on the Unix-epoch clock
the profiler's absolute times use; with neither it costs one check.

Memory: a tracer keeps the newest ``max_spans`` finished spans (default
10000, ``DL4JTPU_TRACE_MAX_SPANS``); overflow drops the OLDEST spans,
counted in ``tracer_spans_dropped_total`` with a one-time warning — the
export is a flight recorder, not an archive, but the drop must be
visible.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import re
import socket
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import torch.autograd.profiler as _torch_profiler

from . import faults as _faults
from . import flightrecorder as _flight
from . import metrics as _metrics

logger = logging.getLogger("deeplearning4j_tpu_torch")

DEFAULT_MAX_SPANS = 10000

_HOSTNAME = socket.gethostname()

# W3C traceparent: version "00", 32-hex trace id, 16-hex span id, flags.
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")

# The one env var a parent process sets to adopt its children's traces
# (fleet harness, two-process workers): extract() of its value is the
# root parent for the child's top-level span.
TRACEPARENT_ENV = "DL4JTPU_TRACEPARENT"


# Span ids are hot-path allocations (one per decode block per lane):
# a process-seeded PRNG at ~0.1µs/id replaces uuid4's ~3µs urandom
# syscall. Spawned processes reseed at import; os.fork()-style children
# (multiprocessing's default on Linux) inherit the parent's PRNG state,
# so reseed after fork — identical id streams would collide in merged
# timelines (the collector dedupes by span_id).
_id_rng = random.Random(int.from_bytes(os.urandom(16), "big"))
_id_lock = threading.Lock()


def _reseed_ids() -> None:
    with _id_lock:
        _id_rng.seed(int.from_bytes(os.urandom(16), "big"))


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed_ids)


def _new_trace_id() -> str:
    with _id_lock:
        return f"{_id_rng.getrandbits(128):032x}"


def _new_span_id() -> str:
    with _id_lock:
        return f"{_id_rng.getrandbits(64):016x}"


def _max_spans_default() -> int:
    n = int(os.environ.get("DL4JTPU_TRACE_MAX_SPANS",
                           str(DEFAULT_MAX_SPANS)))
    if n < 1:
        raise ValueError(f"DL4JTPU_TRACE_MAX_SPANS must be >= 1, got {n}")
    return n


def dropped_spans_counter(registry=None) -> "_metrics.Counter":
    return (registry if registry is not None
            else _metrics.REGISTRY).counter(
        "tracer_spans_dropped_total",
        "Finished spans evicted from a tracer's bounded ring (oldest "
        "first; raise DL4JTPU_TRACE_MAX_SPANS if the drop loses data "
        "an export needed)")


class SpanContext:
    """The serializable identifying pair of a span — what crosses a
    process or HTTP boundary. Valid as ``parent=`` for
    :meth:`Tracer.start` (parenting only needs ``trace_id``/``span_id``)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id!r}, {self.span_id!r})"

    def __eq__(self, other):
        return (isinstance(other, SpanContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)


def inject(span) -> str:
    """Serialize a span's (or SpanContext's) identity as a W3C-
    traceparent-style string: ``00-<trace_id>-<span_id>-01``."""
    return f"00-{span.trace_id}-{span.span_id}-01"


def extract(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a traceparent string back into a :class:`SpanContext`;
    None for a missing or malformed value (propagation is best-effort —
    a bad header starts a fresh trace, it never breaks the request)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    return SpanContext(m.group(1), m.group(2))


def env_context() -> Optional[SpanContext]:
    """The trace context a parent process handed this one via
    ``DL4JTPU_TRACEPARENT`` (fleet children, spawned workers)."""
    return extract(os.environ.get(TRACEPARENT_ENV))


class Span:
    """One timed operation. ``start_unix`` is wall time (for humans and
    cross-process alignment); durations come from the monotonic clock.
    ``host``/``pid`` name the process that produced the span, so merged
    multi-process timelines keep their provenance."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "attributes",
                 "start_unix", "_start_mono", "duration_ms", "status",
                 "host", "pid", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str],
                 attributes: Optional[Dict[str, Any]] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.host = tracer.host
        self.pid = os.getpid()
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.start_unix = time.time()
        self._start_mono = time.perf_counter()
        self.duration_ms: Optional[float] = None
        self.status = "ok"

    def set_attribute(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def end(self, status: Optional[str] = None) -> None:
        """Close the span (idempotent) and hand it to the tracer."""
        if self.duration_ms is not None:
            return
        self.duration_ms = (time.perf_counter() - self._start_mono) * 1000.0
        if status is not None:
            self.status = status
        self._tracer._finish(self)

    def context(self) -> Dict[str, str]:
        """The identifying triple stamped into fault-seam payloads."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "name": self.name}

    def traceparent(self) -> str:
        return inject(self)

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "host": self.host, "pid": self.pid,
                "start_unix": self.start_unix,
                "duration_ms": self.duration_ms, "status": self.status,
                "attributes": self.attributes}


class _ActiveStack(threading.local):
    def __init__(self):
        self.stack: List[Span] = []


class Tracer:
    """Creates spans and collects the finished ones for export.

    ``max_spans`` bounds memory: a long-lived server keeps the newest N
    finished spans (default from ``DL4JTPU_TRACE_MAX_SPANS``); overflow
    increments ``tracer_spans_dropped_total`` and warns once. ``host``
    names this tracer's process in exported spans — a logical id (an
    elastic fleet host) when given, the machine hostname otherwise.
    """

    def __init__(self, max_spans: Optional[int] = None, *,
                 host: Optional[str] = None, registry=None):
        self.max_spans = (_max_spans_default() if max_spans is None
                          else max(1, int(max_spans)))
        self.host = host if host is not None else _HOSTNAME
        self._dropped_counter = dropped_spans_counter(registry)
        self._warned_drop = False
        self._lock = threading.Lock()
        self._finished: List[Span] = []
        self._active = _ActiveStack()
        with _tracers_lock:
            _live_tracers.add(self)

    # -- creation ------------------------------------------------------

    def start(self, name: str, parent: Optional[Any] = None,
              attributes: Optional[Dict[str, Any]] = None) -> Span:
        """Explicit-lifetime span (cross-thread safe): caller must call
        ``span.end()``. Defaults the parent to this thread's active span.
        ``parent`` may be a :class:`Span` or an extracted
        :class:`SpanContext` from another process."""
        if parent is None:
            parent = self.current()
        trace_id = parent.trace_id if parent else _new_trace_id()
        return Span(self, name, trace_id,
                    parent.span_id if parent else None, attributes)

    def span(self, name: str, parent: Optional[Any] = None,
             attributes: Optional[Dict[str, Any]] = None) -> "_SpanScope":
        """Context manager: starts a span, makes it this thread's active
        span (and the fault-seam context), ends it on exit — status
        "error" if the block raised."""
        return _SpanScope(self, self.start(name, parent, attributes))

    def record(self, name: str, seconds: float,
               parent: Optional[Any] = None,
               attributes: Optional[Dict[str, Any]] = None) -> Span:
        """An already-finished span of explicit duration ending NOW —
        for phases whose boundaries were measured inline (a poll loop's
        successful tail) rather than wrapped in a context manager."""
        s = self.start(name, parent, attributes)
        seconds = max(0.0, float(seconds))
        s.start_unix -= seconds
        s.duration_ms = seconds * 1000.0
        self._finish(s)
        return s

    def current(self) -> Optional[Span]:
        """This thread's innermost open ``span()`` block."""
        stack = self._active.stack
        return stack[-1] if stack else None

    # -- collection / export -------------------------------------------

    def _finish(self, span: Span) -> None:
        dropped = 0
        with self._lock:
            self._finished.append(span)
            if len(self._finished) > self.max_spans:
                dropped = len(self._finished) - self.max_spans
                del self._finished[:dropped]
        if dropped:
            self._dropped_counter.inc(dropped)
            if not self._warned_drop:
                self._warned_drop = True
                logger.warning(
                    "tracer span ring full (max_spans=%d): dropping "
                    "oldest finished spans — raise DL4JTPU_TRACE_MAX_SPANS "
                    "to keep more (counted in tracer_spans_dropped_total)",
                    self.max_spans)

    @property
    def finished(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def find(self, name: str) -> List[Span]:
        return [s for s in self.finished if s.name == name]

    def to_jsonl(self) -> str:
        return "".join(json.dumps(s.to_dict()) + "\n"
                       for s in self.finished)

    def export_jsonl(self, path: str) -> int:
        """Write one JSON object per finished span; returns the count."""
        spans = self.finished
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict()) + "\n")
        return len(spans)

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


class _SpanScope:
    """What :meth:`Tracer.span` returns: the span is this thread's active
    one between enter and exit."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: Tracer, span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._active.stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = self._tracer._active.stack
        if stack and stack[-1] is self._span:
            stack.pop()
        self._span.end("error" if exc_type is not None else None)
        return False


# ---------------------------------------------------------------------------
# phases: spans that also land in a running profile
# ---------------------------------------------------------------------------


_NO_PHASE = contextlib.nullcontext()


class _Phase:
    __slots__ = ("_name", "_scope", "_range")

    def __init__(self, name: str, tracer: Optional[Tracer],
                 attributes: Optional[Dict[str, Any]]):
        self._name = name
        self._scope = (tracer.span(name, attributes=attributes)
                       if tracer is not None else None)
        self._range = None

    def __enter__(self) -> Optional[Span]:
        span = self._scope.__enter__() if self._scope is not None else None
        if _torch_profiler._is_profiler_enabled:
            self._range = _torch_profiler.record_function(self._name)
            self._range.__enter__()
        return span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if self._scope is not None:
            self._scope.__exit__(exc_type, exc, tb)
        return False


def phase(name: str, tracer: Optional[Tracer] = None,
          attributes: Optional[Dict[str, Any]] = None):
    """Context manager for one phase of a hot path (a training step's
    batch wait, forward and backward, updater, device wait; a stager's
    copy). While a ``torch.profiler`` records in this process it opens a
    ``record_function(name)`` range, so the phase and the kernels launched
    inside it land in the profile on the profiler's clock; with a
    ``tracer`` it also records a span (``tracer.span``), the same wall
    interval within microseconds, parented under this thread's active
    span. It yields the span, or None without a tracer. With neither, it
    costs one check and creates nothing. Keep code that may stop one
    profile and start the next (a listener) out of a phase: torch ends a
    range opened in one profile inside the next by writing into the
    first one's freed events."""
    if tracer is None and not _torch_profiler._is_profiler_enabled:
        return _NO_PHASE
    return _Phase(name, tracer, attributes)


# ---------------------------------------------------------------------------
# process-default tracer + active-span context for the other sinks
# ---------------------------------------------------------------------------

# RLock, not Lock: flightrecorder.record() runs from SIGNAL HANDLERS
# (PreemptionHandler) and now consults active_span() via the context
# provider — if the signal lands while the main thread is inside
# Tracer.__init__ or active_span() holding this lock, a plain lock
# would self-deadlock the drain path
_tracers_lock = threading.RLock()
_live_tracers: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


def active_span() -> Optional[Span]:
    """The active span of ANY live tracer on this thread (at most one —
    ``span()`` stacks are per-thread)."""
    with _tracers_lock:
        tracers = list(_live_tracers)
    for t in tracers:
        s = t.current()
        if s is not None:
            return s
    return None


# The process-default tracer: components take ``tracer=None`` and fall
# back to it, so one export shows the whole process.
TRACER = Tracer()


def default_tracer() -> Tracer:
    return TRACER


def _seam_context() -> Dict[str, Any]:
    """Called by faults.check(): fault-seam triggers carry the active
    span (and through it the trace id the fault interrupted)."""
    s = active_span()
    return {"span": s.context()} if s is not None else {}


_faults.add_context_provider(_seam_context)


def _flight_context() -> Dict[str, Any]:
    """Called by flightrecorder.record(): every event recorded under an
    active span carries the trace it belongs to, so a crash/watchdog
    dump names the exact request or round it interrupted."""
    s = active_span()
    if s is None:
        return {}
    return {"trace_id": s.trace_id, "span_id": s.span_id}


_flight.add_context_provider(_flight_context)
