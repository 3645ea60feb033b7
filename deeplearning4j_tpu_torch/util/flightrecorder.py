"""Flight recorder: a bounded in-memory ring of structured events that is
dumped as JSONL when a run crashes, stalls, or is preempted.

A copy of the JAX package's ``util/flightrecorder.py`` (host code).

The reference's answer to "what was the fleet doing when it died" was
Spark's event log; the metrics/tracing substrate answers *how
often* and *how long* but not *what happened just before the crash* — a
Prometheus scrape cannot be taken from a wedged process. This module is
the black box: every layer records its significant events (step
dispatches, retraces, breaker transitions, fault-seam triggers,
checkpoint commits, decode shed/retire summaries) into one process-wide
bounded ring, near-free in steady state, and the failure paths —
the training runtime's step watchdog and preemption handler (ported with
the training substrate), and
an optional unhandled-exception hook — dump the ring to a JSONL file a
human (or the chaos harness) reads after the process is gone.

Event schema: one JSON object per line, always carrying
``{"seq": N, "t": unix_seconds, "kind": str}`` plus kind-specific fields
(see ARCHITECTURE.md "Performance attribution & flight recorder" for the
kinds recorded in-tree). Fields that fail JSON serialization are
stringified rather than dropped — a dump must never raise.

Knobs: ``DL4JTPU_FLIGHT_EVENTS`` (ring capacity, default 512),
``DL4JTPU_FLIGHT_DIR`` (dump directory, default the system temp dir).
Live inspection: ``GET /debug/flightrecorder`` on the serving and UI
servers returns the current ring as JSON.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

DEFAULT_CAPACITY = 512

# Context providers: called on every record() to stamp ambient context
# (e.g. the active trace id, registered by util.tracing) into the event.
# Provider fields never override the caller's explicit fields, and a
# failing provider is ignored — recording must never raise.
_context_providers: List = []


def add_context_provider(fn) -> None:
    """Register a zero-arg callable returning a dict of extra fields for
    every recorded event (same shape as faults.add_context_provider)."""
    _context_providers.append(fn)


def _ambient_context() -> Dict:
    out: Dict = {}
    for fn in _context_providers:
        try:
            out.update(fn() or {})
        except Exception:
            pass
    return out


def _capacity_default() -> int:
    n = int(os.environ.get("DL4JTPU_FLIGHT_EVENTS", str(DEFAULT_CAPACITY)))
    if n < 1:
        raise ValueError(f"DL4JTPU_FLIGHT_EVENTS must be >= 1, got {n}")
    return n


def dump_dir() -> str:
    """Where dumps land: ``DL4JTPU_FLIGHT_DIR`` or the system temp dir."""
    return os.environ.get("DL4JTPU_FLIGHT_DIR") or tempfile.gettempdir()


class FlightRecorder:
    """Thread-safe bounded ring of structured events.

    ``record()`` is the steady-state hot path: one lock, one deque
    append, no I/O. ``dump()`` is the failure path: serialize the ring
    to JSONL, best-effort (logs instead of raising — the recorder must
    never turn a crash into a different crash).
    """

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = (_capacity_default() if capacity is None
                         else max(1, int(capacity)))
        # RLock, not Lock: PreemptionHandler records/dumps from a SIGNAL
        # HANDLER, which Python runs on the main thread — if the signal
        # lands while that same thread is inside record() (the fit loop
        # records every step), a plain lock would self-deadlock the
        # graceful-drain path
        self._lock = threading.RLock()
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._seq = 0
        self.last_dump_path: Optional[str] = None

    # -- recording -----------------------------------------------------

    def record(self, kind: str, /, **fields) -> dict:
        event = {"seq": 0, "t": time.time(), "kind": str(kind),
                 **_ambient_context(), **fields}
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)
        return event

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- dumping -------------------------------------------------------

    def to_jsonl(self) -> str:
        return "".join(json.dumps(e, default=repr) + "\n"
                       for e in self.events())

    def default_dump_path(self) -> str:
        return os.path.join(dump_dir(), f"flightrecorder_{os.getpid()}.jsonl")

    def dump(self, path: Optional[str] = None,
             reason: Optional[str] = None) -> Optional[str]:
        """Write the ring as JSONL (appending a final ``dump`` event naming
        the reason). Returns the written path, or None on failure — a
        failing dump is logged, never raised, so the crash/stall that
        triggered it still surfaces as itself."""
        if reason is not None:
            self.record("dump", reason=reason)
        path = path or self.default_dump_path()
        try:
            body = self.to_jsonl()
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                f.write(body)
            self.last_dump_path = path
            logger.warning("flight recorder dumped %d events to %s",
                           len(self), path)
            return path
        except Exception:
            logger.exception("flight recorder dump to %s failed", path)
            return None


# The process-default recorder: the black box every in-tree feed records
# into, so one dump explains the whole process.
RECORDER = FlightRecorder()


def record(kind: str, /, **fields) -> dict:
    return RECORDER.record(kind, **fields)


def events(kind: Optional[str] = None) -> List[dict]:
    return RECORDER.events(kind)


def jsonable_events(kind: Optional[str] = None) -> List[dict]:
    """Events with every field JSON-safe (repr-stringified when needed) —
    what the HTTP debug endpoints return, so one odd field value cannot
    500 the black-box inspection exactly when someone needs it."""
    return [json.loads(json.dumps(e, default=repr))
            for e in RECORDER.events(kind)]


def dump(reason: Optional[str] = None,
         path: Optional[str] = None) -> Optional[str]:
    return RECORDER.dump(path=path, reason=reason)


def read_jsonl(path: str) -> List[dict]:
    """Parse a dump back into events (the chaos harness's read side)."""
    out = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ----------------------------------------------------------------------
# unhandled-exception hook
# ----------------------------------------------------------------------

_hook_lock = threading.Lock()
_hook_installed = False


def install_excepthook() -> None:
    """Chain ``sys.excepthook`` so an unhandled exception dumps the ring
    before the interpreter's (or anyone else's) handler runs. Idempotent."""
    global _hook_installed
    with _hook_lock:
        if _hook_installed:
            return
        previous = sys.excepthook

        def hook(exc_type, exc, tb):
            try:
                RECORDER.record("unhandled_exception",
                                error=f"{exc_type.__name__}: {exc}")
                RECORDER.dump(reason="unhandled_exception")
            except Exception:
                pass
            previous(exc_type, exc, tb)

        sys.excepthook = hook
        _hook_installed = True
