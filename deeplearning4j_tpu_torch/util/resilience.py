"""Resilience substrate: retry/backoff, circuit breaking, deadlines.

A copy of the JAX package's ``util/resilience.py`` (host code, no JAX
math), minus ``NonFiniteGuard``, which needs the training-health modules
and comes with the training slice.

Parity-plus: the reference delegates fault tolerance entirely to Spark
task retry (SURVEY §5 — nothing bespoke in-tree). This reproduction owns
serving, remote stats, checkpointing and multi-step training loops, so it
owns ONE composable fault story instead of per-module ad-hoc loops:

- :class:`RetryPolicy` — bounded attempts with exponential backoff and an
  overall deadline.
- :class:`CircuitBreaker` — consecutive failures trip OPEN; after a
  cool-down one HALF_OPEN probe decides between CLOSED and re-OPEN, so an
  unreachable dependency is probed, not hammered.
- :class:`Deadline` — an absolute time budget threaded through queues and
  request handlers.

Everything takes an injectable :class:`Clock`, so every failure path is
driven deterministically from tests (``ManualClock`` — no real sleeps),
in the spirit of hypothesis-style deterministic fault injection; see
:mod:`deeplearning4j_tpu_torch.util.faults` for the companion injection
harness.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Callable, Dict, Iterator, Optional, Tuple, Type

logger = logging.getLogger("deeplearning4j_tpu_torch")

# Every constructed CircuitBreaker registers here (weakly), so diagnostic
# dumps — chiefly util.durable.StepWatchdog's no-progress report — can
# name each live breaker's current state without threading references.
_live_breakers: "weakref.WeakSet" = weakref.WeakSet()


def breaker_states() -> Dict[str, str]:
    """Name → state of every live :class:`CircuitBreaker` in the process."""
    return {b.name: b.state for b in sorted(
        list(_live_breakers), key=lambda b: b.name)}


class ResilienceError(Exception):
    """Base class for failures raised by the resilience substrate."""


class RetriesExhausted(ResilienceError):
    """A RetryPolicy ran out of attempts/deadline. ``__cause__`` holds the
    last underlying error."""


class CircuitOpenError(ResilienceError):
    """The call was refused because the circuit breaker is OPEN."""

    def __init__(self, msg: str, retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class DeadlineExceeded(ResilienceError):
    """A Deadline expired before the work completed."""


class Clock:
    """Injectable time source. The default reads the monotonic clock and
    really sleeps; tests substitute :class:`ManualClock`."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class ManualClock(Clock):
    """Deterministic clock for tests: ``sleep`` advances virtual time
    instantly and records the requested durations."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self.sleeps: list = []

    def monotonic(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        self.now += max(0.0, float(seconds))

    def advance(self, seconds: float) -> None:
        self.now += float(seconds)


SYSTEM_CLOCK = Clock()


class Deadline:
    """An absolute point in (clock) time a unit of work must finish by."""

    def __init__(self, budget_s: Optional[float], clock: Clock = SYSTEM_CLOCK):
        self.clock = clock
        self._at = (None if budget_s is None
                    else clock.monotonic() + float(budget_s))

    def remaining(self) -> Optional[float]:
        """Seconds left (None = unbounded); never negative."""
        if self._at is None:
            return None
        return max(0.0, self._at - self.clock.monotonic())

    @property
    def expired(self) -> bool:
        return self._at is not None and self.clock.monotonic() >= self._at

    def check(self, what: str = "operation") -> None:
        if self.expired:
            raise DeadlineExceeded(f"{what} exceeded its deadline")


def wait_until(predicate: Callable[[], bool], *,
               timeout_s: Optional[float] = None, poll_s: float = 0.02,
               clock: Clock = SYSTEM_CLOCK,
               desc: str = "condition",
               on_poll: Optional[Callable[[], None]] = None) -> bool:
    """Deadline-bounded polling wait: True as soon as ``predicate()`` is
    truthy, False once ``timeout_s`` elapses (None = wait forever). The
    replacement for fixed test sleeps — a passing wait returns at the
    first poll instead of sleeping the worst case, and a hung condition
    fails at the deadline instead of hanging the suite. ``on_poll`` runs
    every iteration (pet a watchdog, publish a heartbeat)."""
    deadline = Deadline(timeout_s, clock)
    while True:
        if predicate():
            return True
        if deadline.expired:
            logger.warning("wait_until(%s) expired after %.1fs", desc,
                           float(timeout_s or 0))
            return False
        if on_poll is not None:
            on_poll()
        clock.sleep(poll_s)


class RetryPolicy:
    """Exponential-backoff retry with bounded attempts and a total
    deadline.

    ``call(fn)`` runs ``fn`` up to ``max_attempts`` times, sleeping
    ``initial_backoff * multiplier**k`` (capped at ``max_backoff``)
    between attempts via the injected clock. A ``deadline_s`` bounds the
    WHOLE retry loop: no retry is begun (nor slept toward) past it.
    Raises :class:`RetriesExhausted` chaining the last error.
    """

    def __init__(self, *, max_attempts: int = 3,
                 initial_backoff: float = 0.1, max_backoff: float = 10.0,
                 multiplier: float = 2.0,
                 deadline_s: Optional[float] = None,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 clock: Clock = SYSTEM_CLOCK,
                 name: str = "retry", registry=None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        self.max_attempts = int(max_attempts)
        self.initial_backoff = float(initial_backoff)
        self.max_backoff = float(max_backoff)
        self.multiplier = float(multiplier)
        self.deadline_s = deadline_s
        self.retry_on = retry_on
        self.clock = clock
        self.name = name
        # attempt / give-up counters, labeled by policy name so one
        # scrape separates "remote UI flapping" from "checkpoint flapping"
        from . import metrics as _metrics
        reg = registry if registry is not None else _metrics.REGISTRY
        self._attempts_counter = reg.counter(
            "retry_attempts_total", "Attempts started under a RetryPolicy",
            ("policy",))
        self._give_ups_counter = reg.counter(
            "retry_give_ups_total",
            "Retry loops that exhausted attempts or deadline", ("policy",))

    def backoff(self, attempt: int) -> float:
        """Sleep before attempt ``attempt`` (0-based; attempt 0 has none)."""
        if attempt <= 0:
            return 0.0
        return min(self.max_backoff,
                   self.initial_backoff * self.multiplier ** (attempt - 1))

    def attempts(self) -> Iterator[int]:
        """Yield attempt indices, sleeping the backoff between them and
        stopping early when the policy deadline runs out."""
        deadline = Deadline(self.deadline_s, self.clock)
        for attempt in range(self.max_attempts):
            if attempt > 0:
                wait = self.backoff(attempt)
                rem = deadline.remaining()
                if rem is not None and wait >= rem:
                    # the backoff alone would eat the rest of the deadline
                    # — give up now instead of sleeping toward nothing
                    return
                self.clock.sleep(wait)
            self._attempts_counter.inc(policy=self.name)
            yield attempt

    def record_give_up(self) -> None:
        """Count one exhausted retry loop. ``call()`` does this itself;
        callers driving ``attempts()`` by hand (e.g. the remote stats
        router) call it when their loop ends without success."""
        self._give_ups_counter.inc(policy=self.name)

    def call(self, fn: Callable, *args, **kwargs):
        last: Optional[BaseException] = None
        ran = 0
        for _attempt in self.attempts():
            ran += 1
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                last = e
        self.record_give_up()
        cut = ("" if ran == self.max_attempts
               else f" (deadline cut the loop short of {self.max_attempts})")
        raise RetriesExhausted(
            f"{getattr(fn, '__name__', fn)!r} failed after {ran} "
            f"attempts{cut}") from last


# breaker states
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Trip OPEN after ``failure_threshold`` consecutive failures; refuse
    calls while OPEN; after ``reset_timeout_s`` allow ONE probe
    (HALF_OPEN) — its success closes the circuit, its failure re-opens it
    for another cool-down. Thread-safe; clock-injectable.
    """

    def __init__(self, *, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Clock = SYSTEM_CLOCK, name: str = "breaker",
                 on_transition: Optional[Callable[[str, str, str],
                                                  None]] = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.clock = clock
        self.name = name
        # observer fired as (breaker_name, old_state, new_state) on EVERY
        # state change, outside the breaker lock (a hook may read state)
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._pending_transitions: list = []
        self.trips = 0          # times the breaker went CLOSED/HALF_OPEN→OPEN
        self.rejected = 0       # calls refused while OPEN
        _live_breakers.add(self)

    def _set_state(self, new: str) -> None:
        """Must hold self._lock; queues the transition for hooks."""
        if new != self._state:
            self._pending_transitions.append((self._state, new))
        self._state = new

    def _fire_transitions(self) -> None:
        """Must NOT hold self._lock. Hook failures are logged, never
        raised — telemetry must not take down the breaker's caller (the
        serving batcher thread calls this from its failure path)."""
        with self._lock:
            pending, self._pending_transitions = (
                self._pending_transitions, [])
        hook = self.on_transition
        for old, new in pending:
            # every transition lands in the process flight recorder (a
            # breaker flapping open right before a stall is exactly what
            # a post-mortem dump must show), independent of any hook
            from . import flightrecorder as _flight
            _flight.record("breaker_transition", breaker=self.name,
                           from_state=old, to_state=new)
            if hook is not None:
                try:
                    hook(self.name, old, new)
                except Exception:
                    logger.exception(
                        "circuit %s on_transition hook failed (%s -> %s)",
                        self.name, old, new)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            out = self._state
        self._fire_transitions()
        return out

    def _maybe_half_open(self) -> None:
        if (self._state == OPEN
                and self.clock.monotonic() - self._opened_at
                >= self.reset_timeout_s):
            self._set_state(HALF_OPEN)
            self._probe_inflight = False

    def retry_after(self) -> float:
        """Seconds until the next probe is allowed (0 when not OPEN)."""
        with self._lock:
            self._maybe_half_open()
            if self._state != OPEN:
                out = 0.0
            else:
                out = max(0.0, self._opened_at + self.reset_timeout_s
                          - self.clock.monotonic())
        self._fire_transitions()
        return out

    def allow(self) -> bool:
        """True if a call may proceed now (counts a rejection otherwise).
        In HALF_OPEN exactly ONE caller gets True (the probe); the rest
        are refused until its outcome is recorded — a recovering
        dependency meets one request, not a thundering herd."""
        with self._lock:
            self._maybe_half_open()
            if self._state == OPEN or (self._state == HALF_OPEN
                                       and self._probe_inflight):
                self.rejected += 1
                out = False
            else:
                if self._state == HALF_OPEN:
                    self._probe_inflight = True
                out = True
        self._fire_transitions()
        return out

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                logger.info("circuit %s closed after successful probe",
                            self.name)
            self._set_state(CLOSED)
        self._fire_transitions()

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            self._probe_inflight = False
            self._consecutive_failures += 1
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._set_state(OPEN)
                self._opened_at = self.clock.monotonic()
                self.trips += 1
                logger.warning(
                    "circuit %s OPEN after %d consecutive failures "
                    "(cool-down %.1fs)", self.name,
                    self._consecutive_failures, self.reset_timeout_s)
        self._fire_transitions()

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under the breaker: refused with
        :class:`CircuitOpenError` while OPEN, outcome recorded otherwise."""
        if not self.allow():
            raise CircuitOpenError(
                f"circuit {self.name} is open",
                retry_after=self.retry_after())
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


# numeric encoding for breaker-state gauges (Prometheus has no enums)
STATE_VALUES = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


def metrics_transition_hook(registry=None) -> Callable[[str, str, str], None]:
    """An ``on_transition`` hook recording every breaker state change as
    ``breaker_transitions_total{breaker,from_state,to_state}``."""
    from . import metrics as _metrics
    reg = registry if registry is not None else _metrics.REGISTRY
    transitions = reg.counter(
        "breaker_transitions_total", "Circuit breaker state transitions",
        ("breaker", "from_state", "to_state"))

    def hook(name: str, old: str, new: str) -> None:
        transitions.inc(breaker=name, from_state=old, to_state=new)

    return hook
