"""Deterministic fault injection: script failures into named seams.

A copy of the JAX package's ``util/faults.py`` (host code, no JAX math).

The production modules call :func:`check` at their I/O seams (checkpoint
writes, remote stats POSTs, the serving inference call, ...). With no
plan installed that is a near-free no-op. Tests install a
:class:`FaultPlan` that scripts EXACTLY which call at which site fails
and how — the hypothesis-style alternative to sleep-based chaos tests
and to monkeypatching module internals: the seam is part of the module's
contract, so tests survive refactors of everything behind it.

Known sites (grep for ``faults.check``):

- ``"checkpoint.write"``   — serialization writing a model artifact
- ``"storage.post"``       — RemoteUIStatsStorageRouter HTTP round-trip
- ``"serving.infer"``      — the inference server's batched model call
- ``"recovery.restore"``   — checkpoint load during recovery
- ``"training.step"``      — once per dispatched step in the shared fit
  loop (``util.ingest.run_fit_loop``) and the early-stopping trainers,
  BEFORE the dispatch; chaos tests script kills/hangs at exact step
  boundaries here (raise = clean crash, ``os._exit`` hook = hard kill,
  ``os.kill(os.getpid(), SIGTERM)`` hook = preemption signal)

Usage::

    plan = FaultPlan()
    plan.fail("storage.post", times=5, exc=ConnectionError("ui down"))
    plan.fail_at("checkpoint.write", call=2, exc=IOError("disk full"))
    with plan.active():
        ...   # the scripted calls raise; everything else proceeds

A fault may also be a callable hook (e.g. to truncate bytes before
raising — a torn write); it receives the payload the site passed.

Each triggered fault is recorded in ``plan.triggered`` (site, call#) and
``plan.trigger_context`` (site, call, payload, plus seam context from
registered providers — :mod:`deeplearning4j_tpu_torch.util.tracing` stamps the
active span, so tests can assert which span a fault landed in).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Union

Fault = Union[BaseException, Callable[[Any], None]]

_lock = threading.Lock()
_active: Optional["FaultPlan"] = None

# Seam-context providers: callables returning a dict merged into the
# context recorded when a fault triggers. util/tracing.py registers one
# that stamps the active span, so a chaos test can assert WHICH span a
# scripted fault landed in.
_context_providers: list = []


def add_context_provider(fn: Callable[[], dict]) -> None:
    if fn not in _context_providers:
        _context_providers.append(fn)


def seam_context() -> dict:
    """The merged context of all registered providers (empty when none)."""
    ctx: dict = {}
    for fn in list(_context_providers):
        try:
            ctx.update(fn() or {})
        except Exception:
            pass            # a broken provider must never mask the seam
    return ctx


class _Rule:
    __slots__ = ("first", "last", "fault")

    def __init__(self, first: int, last: int, fault: Fault):
        self.first = first          # 1-based call numbers, inclusive
        self.last = last
        self.fault = fault

    def matches(self, call: int) -> bool:
        return self.first <= call <= self.last


class FaultPlan:
    """A deterministic schedule of failures keyed by (site, call number).

    Call numbers are 1-based and counted per site from the moment the
    plan is installed. Thread-safe: sites are hit from server/batcher
    threads.
    """

    def __init__(self):
        self._rules: Dict[str, List[_Rule]] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.triggered: List[tuple] = []   # (site, call#) audit trail
        # one dict per triggered fault: site, call, payload, plus seam
        # context (e.g. the active tracing span) captured at the hit
        self.trigger_context: List[dict] = []

    # -- scripting --

    def fail(self, site: str, *, times: int = 1,
             exc: Fault = None, after: int = 0) -> "FaultPlan":
        """Fail the next ``times`` calls to ``site`` (skipping the first
        ``after`` calls). ``exc``: exception instance/class to raise, or
        a callable hook invoked with the site payload (it may raise
        itself); defaults to ``InjectedFault``."""
        first = after + 1
        self._rules.setdefault(site, []).append(
            _Rule(first, first + times - 1,
                  exc if exc is not None else InjectedFault(site)))
        return self

    def fail_at(self, site: str, call: int, exc: Fault = None) -> "FaultPlan":
        """Fail exactly the ``call``-th (1-based) call to ``site``."""
        self._rules.setdefault(site, []).append(
            _Rule(call, call,
                  exc if exc is not None else InjectedFault(site)))
        return self

    def always(self, site: str, exc: Fault = None) -> "FaultPlan":
        """Fail every call to ``site`` until the plan is uninstalled."""
        return self.fail(site, times=1 << 30, exc=exc)

    # -- bookkeeping --

    def calls(self, site: str) -> int:
        """How many times ``site`` was hit under this plan."""
        with self._lock:
            return self._counts.get(site, 0)

    def _hit(self, site: str, payload: Any) -> None:
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            rule = next((r for r in self._rules.get(site, ())
                         if r.matches(n)), None)
            if rule is not None:
                self.triggered.append((site, n))
                self.trigger_context.append(
                    {"site": site, "call": n, "payload": payload,
                     **seam_context()})
        if rule is None:
            return
        # scripted faults are significant events by definition: the chaos
        # dump must show the injected failure next to its consequences
        from . import flightrecorder as _flight
        _flight.record("fault_injected", site=site, call=n)
        fault = rule.fault
        if isinstance(fault, BaseException):
            raise fault
        if isinstance(fault, type) and issubclass(fault, BaseException):
            raise fault(f"injected fault at {site} (call {n})")
        fault(payload)          # callable hook; may raise on its own

    # -- installation --

    def install(self) -> None:
        global _active
        with _lock:
            if _active is not None and _active is not self:
                raise RuntimeError("another FaultPlan is already active")
            _active = self

    def uninstall(self) -> None:
        global _active
        with _lock:
            if _active is self:
                _active = None

    def active(self):
        """Context manager: install for the duration of the block."""
        plan = self

        class _Ctx:
            def __enter__(self):
                plan.install()
                return plan

            def __exit__(self, *exc):
                plan.uninstall()
                return False

        return _Ctx()


class InjectedFault(Exception):
    """Default exception for scripted faults."""


def check(site: str, payload: Any = None) -> None:
    """Production seam: no-op unless an installed plan scripted a fault
    for this call of ``site``."""
    plan = _active
    if plan is not None:
        plan._hit(site, payload)


def active_plan() -> Optional[FaultPlan]:
    return _active
