"""Metrics substrate: labeled counters/gauges/histograms + Prometheus text.

A copy of the JAX package's ``util/metrics.py`` (host code, no JAX math).

Parity-plus: the reference's whole L7 (StatsListener → StatsStorage → UI)
exists to make *training* observable; nothing in it can answer "why did
this 503 happen" for the serving/resilience layers this reproduction
added. This module is the one process-wide metrics plane every layer
records into — serving request latencies, breaker transitions, retry
give-ups, training phase timings — exposed in Prometheus text format
(``registry.expose()``) so an off-the-shelf scraper explains every slow
step and every shed request.

Design:

- :class:`MetricsRegistry` — thread-safe, name-keyed. ``counter()`` /
  ``gauge()`` / ``histogram()`` are get-or-create (idempotent across call
  sites; re-declaring a name as a different type or label set raises).
- :class:`Counter` — monotonic; ``inc()``, per-labelset children via
  ``labels()``; ``inc_device()`` adds a count that stays on a device
  until the counter is read.
- :class:`Gauge` — ``set``/``inc``/``dec``, plus ``set_function`` for
  live values (queue depth, breaker state) sampled at exposition time.
- :class:`Histogram` — explicit buckets, cumulative ``_bucket`` series +
  ``_sum`` + ``_count`` (the Prometheus shape, so quantiles are the
  scraper's job, not the process's).
- ``REGISTRY`` — the process-default registry; components take an
  optional ``registry=`` and fall back to it.

Everything is pure stdlib and allocation-light: one dict lookup + one
lock per record on the hot path, nothing on import.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Prometheus default buckets suit RPC latencies in seconds.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing .0, +Inf for
    infinity, repr-precision otherwise."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_key(labelnames: Tuple[str, ...], labels: Dict[str, str]
                ) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


def _render_labels(labelnames: Sequence[str], values: Sequence[str],
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{n}="{_escape_label_value(v)}"'
             for n, v in zip(labelnames, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape_label_value(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    """Base: a named family of per-labelset series."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for l in labelnames:
            if not _LABEL_RE.match(l):
                raise ValueError(f"invalid label name {l!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    # exposition -------------------------------------------------------

    def _samples(self) -> List[str]:
        raise NotImplementedError

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        lines.extend(self._samples())
        return "\n".join(lines)

    def snapshot(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count (resets only with the process).

    ``inc_device`` adds a one-element tensor without reading it: the sum
    stays on its device, and whatever reads the counter (``value``,
    ``total``, exposition, ``snapshot``) folds it in first, so a hot path
    that counts on the device never waits for it."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._on_device: Dict[Tuple[str, ...], object] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def inc_device(self, amount, **labels) -> None:
        """Add the one-element tensor ``amount`` (not negative) to this
        labelset's running sum on its device (out of place, so that a sum
        begun under ``torch.inference_mode`` goes on outside it)."""
        key = _labels_key(self.labelnames, labels)
        amount = amount.detach().reshape(())
        with self._lock:
            acc = self._on_device.get(key)
            self._on_device[key] = (amount.clone() if acc is None
                                    else acc + amount)

    def _fold(self) -> None:
        """Move the sums kept on devices into the host values (reads them:
        a device synchronisation when there are any). Holds the lock."""
        for key, acc in self._on_device.items():
            self._values[key] = self._values.get(key, 0.0) + float(acc)
        self._on_device.clear()

    def value(self, **labels) -> float:
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            self._fold()
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum across every labelset (back-compat for bare-int counters)."""
        with self._lock:
            self._fold()
            return sum(self._values.values())

    def _samples(self) -> List[str]:
        with self._lock:
            self._fold()
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        return [f"{self.name}{_render_labels(self.labelnames, k)} {_fmt(v)}"
                for k, v in items]

    def snapshot(self) -> dict:
        with self._lock:
            self._fold()
            series = [{"labels": dict(zip(self.labelnames, k)), "value": v}
                      for k, v in sorted(self._values.items())]
        return {"type": "counter", "help": self.help, "series": series}


class Gauge(_Metric):
    """A value that goes up and down; may be backed by a live callback
    (``set_function``) sampled at exposition time."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._fns: Dict[Tuple[str, ...], Callable[[], float]] = {}

    def set(self, value: float, **labels) -> None:
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        """Sample ``fn`` at exposition time — the right shape for values
        that already live somewhere (queue depth, breaker state)."""
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            self._fns[key] = fn

    def value(self, **labels) -> float:
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            fn = self._fns.get(key)
            if fn is None:
                return self._values.get(key, 0.0)
        return float(fn())

    def _items(self) -> List[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            static = dict(self._values)
            fns = dict(self._fns)
        for key, fn in fns.items():
            try:
                static[key] = float(fn())
            except Exception:
                static.pop(key, None)   # a dead callback drops its series
        return sorted(static.items())

    def _samples(self) -> List[str]:
        return [f"{self.name}{_render_labels(self.labelnames, k)} {_fmt(v)}"
                for k, v in self._items()]

    def snapshot(self) -> dict:
        return {"type": "gauge", "help": self.help,
                "series": [{"labels": dict(zip(self.labelnames, k)),
                            "value": v} for k, v in self._items()]}


class Histogram(_Metric):
    """Explicit-bucket histogram: cumulative ``_bucket{le=...}`` counts
    plus ``_sum`` and ``_count`` per labelset."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        if bs != sorted(set(bs)):
            raise ValueError("duplicate bucket bounds")
        self.buckets = tuple(bs)        # +Inf is implicit
        # per-labelset: ([count per finite bucket], inf_count, sum)
        self._series: Dict[Tuple[str, ...], list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _labels_key(self.labelnames, labels)
        v = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * len(self.buckets), 0, 0.0]
            counts, _inf, _sum = s
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            else:
                s[1] += 1
            s[2] += v

    def count(self, **labels) -> int:
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            s = self._series.get(key)
            return 0 if s is None else sum(s[0]) + s[1]

    def sum(self, **labels) -> float:
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            s = self._series.get(key)
            return 0.0 if s is None else s[2]

    def total_sum(self) -> float:
        """Sum of observed values across EVERY labelset (e.g. compile
        wall across all jitted functions)."""
        with self._lock:
            return sum(s[2] for s in self._series.values())

    def _samples(self) -> List[str]:
        with self._lock:
            series = {k: [list(s[0]), s[1], s[2]]
                      for k, s in sorted(self._series.items())}
        out = []
        for key, (counts, inf_count, total) in series.items():
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                lbl = _render_labels(self.labelnames, key, ("le", _fmt(b)))
                out.append(f"{self.name}_bucket{lbl} {cum}")
            cum += inf_count
            lbl = _render_labels(self.labelnames, key, ("le", "+Inf"))
            out.append(f"{self.name}_bucket{lbl} {cum}")
            plain = _render_labels(self.labelnames, key)
            out.append(f"{self.name}_sum{plain} {_fmt(total)}")
            out.append(f"{self.name}_count{plain} {cum}")
        return out

    def snapshot(self) -> dict:
        with self._lock:
            series = [{"labels": dict(zip(self.labelnames, k)),
                       "buckets": dict(zip(map(_fmt, self.buckets), s[0])),
                       "inf": s[1], "sum": s[2],
                       "count": sum(s[0]) + s[1]}
                      for k, s in sorted(self._series.items())]
        return {"type": "histogram", "help": self.help,
                "bucket_bounds": list(self.buckets), "series": series}


class MetricsRegistry:
    """Thread-safe, name-keyed metric store with get-or-create accessors
    and Prometheus text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
                return m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}")
        if m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{m.labelnames}, not {tuple(labelnames)}")
        want_buckets = kw.get("buckets")
        if (want_buckets is not None
                and m.buckets != tuple(sorted(float(b)
                                              for b in want_buckets))):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{m.buckets}, not {tuple(want_buckets)}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def expose(self) -> str:
        """Prometheus text format (content type
        ``text/plain; version=0.0.4``), families sorted by name."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        return "\n".join(m.expose() for m in metrics) + ("\n" if metrics
                                                         else "")

    def snapshot(self) -> dict:
        """JSON-friendly dump (ridden by bench.py into BENCH_*.json)."""
        with self._lock:
            metrics = [(n, self._metrics[n]) for n in sorted(self._metrics)]
        return {n: m.snapshot() for n, m in metrics}


EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def write_exposition(handler, registry: "MetricsRegistry") -> None:
    """Write a registry's exposition as the HTTP response on a
    ``BaseHTTPRequestHandler`` — the one copy of the /metrics plumbing
    shared by the serving and UI servers."""
    body = registry.expose().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", EXPOSITION_CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)

# The process-default registry: components take ``registry=None`` and fall
# back to this, so one scrape shows the whole process.
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY
