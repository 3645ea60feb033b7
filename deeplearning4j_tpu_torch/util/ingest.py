"""Host ingest and asynchronous dispatch: the stage between a batch source
and the training step (counterpart of the JAX package's
``util/ingest.py``).

PyTorch queues CUDA work asynchronously, as JAX dispatches it, so the
host costs left in ``fit()`` are the reference's three: a host read of
the loss every step, a synchronous host→device copy of each batch on the
training thread, and Python dispatch overhead. This module removes them
without changing training numerics:

- :class:`LazyScore` — a loss that stays on the card until read.
  ``float(score)`` waits for the card, copies, and counts into
  ``training_host_syncs_total``: a listener at ``frequency=N`` costs one
  sync per N steps, a listener that never reads costs none.
- :class:`InflightWindow` — bounds the dispatched-but-unfinished steps
  (default 2, ``DL4JTPU_MAX_INFLIGHT``). Each step records one CUDA event
  on the training stream; past the bound the host waits for the OLDEST
  event by polling ``event.query()`` (never ``synchronize()``: a
  :class:`~.durable.StepWatchdog` interrupts the main thread, and an
  interrupt only lands while Python runs).
- :func:`stage` — a background thread that copies each batch to the card
  on its own CUDA stream: from a small ring of pinned host buffers with
  ``non_blocking=True``, then an event recorded after the copies, which
  the producer itself waits on (the reference's ``block_until_ready`` on
  the producer), so queued batches are resident and the copy overlaps
  the step in flight. The consumer makes the training stream
  ``wait_event`` that event (no host block) and calls ``record_stream``
  on every staged tensor, so the caching allocator does not hand a
  batch's memory to the next copy while a step still reads it. A stager
  whose target is a CUDA device and that has no card raises; on a CPU
  target the producer only converts host arrays to tensors. Applied to
  every ``fit(iterator)`` by default (``DL4JTPU_INGEST=0`` disables).
- :func:`coalesced` — groups runs of K consecutive same-shape maskless
  batches for one ``fit_scan`` call (``DL4JTPU_COALESCE_K`` or
  ``fit(..., coalesce=K)``). The port's ``fit_scan`` is K ordinary steps,
  each with its own update-count generator, so coalescing changes the
  dispatch, not the draws.

Observability (the metrics registry): prefetch queue depth, h2d bytes and
seconds, staged batches, the host gap between dispatches, the record
pipeline's counters, and the live measured FLOP rate and MFU.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import queue
import threading
import time
import weakref
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from . import faults as _faults
from . import flightrecorder as _flight
from . import metrics as _metrics
from . import tracing as _tracing

logger = logging.getLogger("deeplearning4j_tpu_torch")


# ----------------------------------------------------------------------
# the shared producer/queue core (also backs the async dataset iterators)
# ----------------------------------------------------------------------

class ProducerQueue:
    """Bounded queue + stop flag + sentinel + fail-fast error hand-off:
    the one copy of the producer/consumer machinery shared by
    :func:`stage` and ``datasets.iterator.AsyncDataSetIterator``.

    Producer side: ``put`` (gives up promptly once ``stop`` is set),
    ``fail(exc)`` then ``finish()`` in a finally. Consumer side: ``get``
    returns the next item or ``SENTINEL``; a pending producer error raises
    as soon as it is observed, before any queued item is handed out.
    ``drain_and_join`` discards staged items (unblocking a producer stuck
    on a full queue) and reports whether the producer thread exited.
    """

    SENTINEL = object()

    def __init__(self, maxsize: int):
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(1, maxsize))
        self.stop = threading.Event()
        self.error: Optional[BaseException] = None

    def put(self, item, timeout: float = 0.05) -> bool:
        while not self.stop.is_set():
            try:
                self.queue.put(item, timeout=timeout)
                return True
            except queue.Full:
                continue
        return False

    def fail(self, exc: BaseException) -> None:
        self.error = exc

    def finish(self) -> None:
        self.put(self.SENTINEL)

    def raise_pending(self) -> None:
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def get(self, timeout: float = 0.05):
        """Next item or ``SENTINEL``; a producer error raises at its first
        observation, and a sentinel re-checks, so an error set right
        before ``finish()`` cannot pass as a clean end of stream."""
        while True:
            self.raise_pending()
            try:
                item = self.queue.get(timeout=timeout)
            except queue.Empty:
                continue
            if item is self.SENTINEL:
                self.raise_pending()
            return item

    def drain_and_join(self, thread: threading.Thread,
                       join_timeout: float = 5.0) -> bool:
        """Stop the producer, discard staged items, wait for the thread.
        False if the thread is still alive (stuck inside its source)."""
        self.stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=join_timeout)
        return not thread.is_alive()


# ----------------------------------------------------------------------
# knobs
# ----------------------------------------------------------------------

def max_inflight_default() -> int:
    """Bounded dispatch window for fit() (``DL4JTPU_MAX_INFLIGHT``, default
    2: one step computes while the next one stages and dispatches)."""
    n = int(os.environ.get("DL4JTPU_MAX_INFLIGHT", "2"))
    if n < 1:
        raise ValueError(f"DL4JTPU_MAX_INFLIGHT must be >= 1, got {n}")
    return n


def staging_enabled() -> bool:
    return os.environ.get("DL4JTPU_INGEST", "1") != "0"


def coalesce_k_default() -> int:
    """Run length for same-shape batch coalescing (0/1 = off)."""
    return int(os.environ.get("DL4JTPU_COALESCE_K", "0"))


def already_staged(data) -> bool:
    """True when the source already ships device-resident batches (an
    AsyncDataSetIterator built with ``device_put=True``)."""
    return bool(getattr(data, "device_put", False))


# ----------------------------------------------------------------------
# metric families (get-or-create: idempotent across pipelines)
# ----------------------------------------------------------------------

_GAP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 1.0)


def _reg(registry=None) -> _metrics.MetricsRegistry:
    return registry if registry is not None else _metrics.REGISTRY


def sync_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "training_host_syncs_total",
        "Device->host loss transfers forced by score readers")


def retrace_counter(registry=None) -> _metrics.Counter:
    from . import capture as _capture
    return _capture.retrace_counter(_reg(registry))


def _queue_gauge(registry=None) -> _metrics.Gauge:
    return _reg(registry).gauge(
        "ingest_queue_depth", "Staged batches waiting in the prefetch queue",
        ("stage",))


def _h2d_bytes(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "ingest_h2d_bytes_total", "Host bytes shipped to device by ingest",
        ("stage",))


def _h2d_seconds(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "ingest_h2d_seconds_total",
        "Producer-thread seconds spent staging (pinned copy, h2d copy on "
        "the side stream and the wait for it)", ("stage",))


def _staged_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "ingest_batches_staged_total", "Batches staged by ingest", ("stage",))


def host_gap_histogram(registry=None) -> _metrics.Histogram:
    return _reg(registry).histogram(
        "fit_host_gap_seconds",
        "Host time fit() waits for its next (staged) batch between two "
        "step dispatches: the fetch from the batch stream, the fit.batch_wait "
        "phase (listeners fire inside the dispatch, not here)", ("model",),
        buckets=_GAP_BUCKETS)


def phase_histogram(registry=None) -> _metrics.Histogram:
    return _reg(registry).histogram(
        "fit_phase_seconds",
        "Host time of one phase of a training update: 'updater' from "
        "gradient normalization through the parameters' update (one per "
        "update), 'device_wait' fit() blocked on an earlier step's "
        "completion (one per dispatch)", ("model", "phase"),
        buckets=_GAP_BUCKETS)


@contextlib.contextmanager
def fit_phase(phase: str, tracer, model_label: str):
    """The ``fit.<phase>`` phase (``util.tracing.phase``) and its
    ``fit_phase_seconds{model, phase}`` observation, on the host clock
    inside the phase's range."""
    with _tracing.phase(f"fit.{phase}", tracer):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
    phase_histogram().observe(dt, model=model_label, phase=phase)


def records_read_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "pipeline_records_read_total",
        "Records decoded from shard files by the record input pipeline "
        "(data.pipeline)", ("stage",))


def records_skipped_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "pipeline_records_skipped_total",
        "Corrupt records dropped by the skip-with-counter policy — any "
        "nonzero value on a production run means a shard needs fsck",
        ("stage",))


def augment_seconds_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "pipeline_augment_seconds_total",
        "Producer-side seconds spent in the augmentation stage",
        ("stage",))


def pipeline_batches_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "pipeline_batches_total",
        "Batches assembled by the record input pipeline", ("stage",))


def measured_flops_gauge(registry=None) -> _metrics.Gauge:
    return _reg(registry).gauge(
        "measured_flops_per_sec",
        "Live training FLOP/s: the guarded train step's counted FLOPs "
        "(compiled_flops) over wall time between dispatches", ("model",))


def measured_mfu_gauge(registry=None) -> _metrics.Gauge:
    return _reg(registry).gauge(
        "measured_mfu",
        "Live model FLOPs utilization: measured_flops_per_sec over the "
        "attached card's bf16 peak (series absent when the card has no "
        "known peak — CPU runs read measured_flops_per_sec instead)",
        ("model",))


class _MfuMeter:
    """Live measured-performance gauges for :func:`run_fit_loop`: the
    guarded step's counted FLOPs (``compiled_flops{fn}``, recorded by
    ``util.xla.retrace_guard`` on a signature's first call) over the wall
    time between dispatches, into ``measured_flops_per_sec{model}`` and,
    when the card's peak is known, ``measured_mfu{model}``. The first
    dispatch only anchors the clock."""

    def __init__(self, model_label: str, registry=None):
        from . import profiling as _profiling
        from . import xla as _xla
        self.model_label = model_label
        self._flops = _xla.compiled_flops_gauge(registry)
        self._rate = measured_flops_gauge(registry)
        self._mfu = measured_mfu_gauge(registry)
        try:
            self._peak = _profiling.peak_flops_per_sec()
        except Exception:
            self._peak = None
        self._t0: Optional[float] = None
        self._total = 0.0

    def on_dispatch(self, kind: str) -> None:
        fn = (f"{self.model_label}.train_scan" if kind == "scan"
              else f"{self.model_label}.train_step")
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return
        flops = self._flops.value(fn=fn)
        if not flops:
            return
        self._total += flops
        elapsed = now - self._t0
        if elapsed <= 0:
            return
        rate = self._total / elapsed
        self._rate.set(rate, model=self.model_label)
        if self._peak:
            self._mfu.set(rate / self._peak, model=self.model_label)


# ----------------------------------------------------------------------
# LazyScore
# ----------------------------------------------------------------------

class LazyScore:
    """A training loss that stays on the device until read.

    ``float(score)`` / ``score.value()`` transfers it to the host (once;
    the result is cached) and increments ``training_host_syncs_total``.
    """

    __slots__ = ("_device", "_host", "_registry")

    def __init__(self, device_value, registry=None):
        self._device = device_value
        self._host: Optional[float] = None
        self._registry = registry

    @property
    def resolved(self) -> bool:
        return self._host is not None

    def value(self) -> float:
        if self._host is None:
            sync_counter(self._registry).inc()
            v, self._device = self._device, None
            self._host = float(v)
        return self._host

    def __float__(self) -> float:
        return self.value()

    def __repr__(self) -> str:
        return (f"LazyScore({self._host})" if self.resolved
                else "LazyScore(<on device>)")


def as_listener_score(loss, registry=None):
    """Wrap a device loss for listener delivery; host scalars (the
    fit_scan/fit_repeated replay, which already paid one transfer for all
    K losses) pass through untouched."""
    if isinstance(loss, (int, float, np.floating, np.integer)):
        return loss
    return LazyScore(loss, registry)


# ----------------------------------------------------------------------
# InflightWindow
# ----------------------------------------------------------------------

_POLL_S = 0.0002


def wait_event(event) -> None:
    """Wait for a CUDA event by polling ``query()``: the host keeps running
    Python, so a watchdog's interrupt of the main thread lands."""
    while not event.query():
        time.sleep(_POLL_S)


class InflightWindow:
    """Bound the number of dispatched-but-unfinished train steps.

    ``push(token)`` records one step: for a CUDA tensor (the step's loss)
    an event on the current stream, which completes when the step's work
    does. Once more than ``max_inflight`` are outstanding, the oldest is
    waited on (:func:`wait_event`) — a completion fence; the loss never
    moves to the host. CPU tokens are complete when returned.
    """

    def __init__(self, max_inflight: Optional[int] = None):
        self.max_inflight = (max_inflight_default() if max_inflight is None
                             else max(1, int(max_inflight)))
        self._pending: collections.deque = collections.deque()

    def push(self, token) -> None:
        if torch.is_tensor(token) and token.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(token.device))
            token = ev
        self._pending.append(token)
        while len(self._pending) > self.max_inflight:
            self._complete(self._pending.popleft())

    @staticmethod
    def _complete(token) -> None:
        if isinstance(token, torch.cuda.Event):
            wait_event(token)

    def drain(self) -> None:
        while self._pending:
            self._complete(self._pending.popleft())

    def __len__(self) -> int:
        return len(self._pending)


# ----------------------------------------------------------------------
# background device staging
# ----------------------------------------------------------------------

_ALIGN = 256


class _PinnedRing:
    """A few pinned host buffers, used in turn: a batch's host arrays are
    packed into one slot (each array at an aligned offset) and copied to
    the card from there, so staging does not pin fresh memory per batch.
    A slot is reused two batches later; the producer waits for each
    batch's copies before the next, so the slot is free by then."""

    def __init__(self, slots: int = 2):
        self._bufs = [None] * max(1, slots)
        self._next = 0

    def slot(self, nbytes: int) -> torch.Tensor:
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(
                max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        return buf


class _Slot:
    """Where a host array sat in a batch, while it is being staged."""
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


# Module-level walks (not nested closures: a recursive closure is a
# reference cycle, which would keep a batch's tensors alive until the
# cyclic collector runs)

def _collect(el, host: list):
    """The batch's skeleton, each host array replaced by a _Slot into
    ``host`` (device tensors and non-arrays kept as they are)."""
    if isinstance(el, (list, tuple)):
        return type(el)(_collect(e, host) for e in el)
    if el is None or not hasattr(el, "shape"):
        return el
    if torch.is_tensor(el) and el.device.type != "cpu":
        return el
    host.append(_host_tensor(el))
    return _Slot(len(host) - 1)


def _fill(el, leaves: list):
    if isinstance(el, (list, tuple)):
        return type(el)(_fill(e, leaves) for e in el)
    return leaves[el.index] if isinstance(el, _Slot) else el


def _record_on(el, stream) -> None:
    if isinstance(el, (list, tuple)):
        for e in el:
            _record_on(e, stream)
    elif torch.is_tensor(el) and el.is_cuda:
        el.record_stream(stream)


def _host_tensor(el) -> torch.Tensor:
    if torch.is_tensor(el):
        return el
    a = np.asarray(el)
    if not a.flags["C_CONTIGUOUS"] or any(s < 0 for s in a.strides):
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a)


class DeviceStager:
    """The copy machinery of one staging producer, shared by
    :func:`stage` and the async dataset iterators.

    ``stage(batch)`` runs on the producer thread: every host array of the
    (possibly nested) batch is packed into a pinned slot and copied to
    ``device`` on the producer's own stream, an event is recorded after
    the copies and the producer waits on it; it returns ``(staged batch,
    event)``. ``adopt(batch, event)`` runs on the consumer: its current
    stream waits on the event and every staged tensor is
    ``record_stream``-ed onto it. On a CPU device the arrays only become
    tensors and there is no event. Counts into the ingest metrics; each
    copy is the ``ingest.stage`` phase (``util.tracing.phase``) on the
    producer thread.

    ``_plant`` is a fault for tests of the staging gate: ``"no_record"``
    skips ``record_stream``, ``"no_wait"`` skips both waits.
    """

    def __init__(self, device, *, stage_name: str = "fit", registry=None,
                 tracer=None, _plant: Optional[str] = None):
        self.device = torch.device(device if device is not None else "cpu")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"ingest stage {stage_name!r}: staging to {self.device} "
                    "needs a CUDA device and none is available")
            if self.device.index is None:   # the producer thread sets it
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.stage_name = stage_name
        self.tracer = tracer
        self._plant = _plant
        self._cuda = self.device.type == "cuda"
        self._stream = None
        self._ring = _PinnedRing() if self._cuda else None
        self._bytes = _h2d_bytes(registry)
        self._seconds = _h2d_seconds(registry)
        self._staged = _staged_counter(registry)

    # -- producer side -------------------------------------------------

    def stage(self, batch: Tuple):
        if self._cuda and self._stream is None:
            torch.cuda.set_device(self.device)
            self._stream = torch.cuda.Stream(self.device)
        with _tracing.phase("ingest.stage", self.tracer,
                            {"stage": self.stage_name}) as span:
            staged, event, host_bytes = self._copy(batch)
            if span is not None:
                span.attributes["bytes"] = host_bytes
        return staged, event

    def _copy(self, batch: Tuple):
        t0 = time.perf_counter()
        host: list = []
        skeleton = tuple(_collect(el, host) for el in batch)
        host_bytes = sum(t.numel() * t.element_size() for t in host)
        event = None
        if not self._cuda:
            staged_leaves = [t.to(self.device) for t in host]
        else:
            offs, total = [], 0
            for t in host:
                offs.append(total)
                total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
            buf = self._ring.slot(total)
            staged_leaves = []
            with torch.cuda.stream(self._stream):
                for t, off in zip(host, offs):
                    n = t.numel() * t.element_size()
                    pinned = buf[off:off + n].view(t.dtype).view(t.shape)
                    pinned.copy_(t)
                    staged_leaves.append(
                        pinned.to(self.device, non_blocking=True))
                event = torch.cuda.Event()
                event.record(self._stream)
            if self._plant != "no_wait":
                # the producer's wait: a queued batch is resident, and the
                # copy overlapped the consumer's step in flight
                wait_event(event)

        staged = tuple(_fill(el, staged_leaves) for el in skeleton)
        dt = time.perf_counter() - t0
        self._seconds.inc(dt, stage=self.stage_name)
        if host_bytes:
            self._bytes.inc(host_bytes, stage=self.stage_name)
        self._staged.inc(stage=self.stage_name)
        return staged, event, host_bytes

    # -- consumer side -------------------------------------------------

    def adopt(self, batch, event) -> None:
        """Order the consumer's stream after the copies and tie every
        staged tensor's memory to it."""
        if event is None:
            return
        stream = torch.cuda.current_stream(self.device)
        if self._plant != "no_wait":
            stream.wait_event(event)
        if self._plant != "no_record":
            for el in batch:
                _record_on(el, stream)


class _StagedStream:
    """Iterator over device-staged batches produced by a background thread
    (a :class:`DeviceStager` does the copies). The producer pulls (x, y,
    mask)-style tuples from ``source`` and enqueues ``(batch, event)``;
    the consumer adopts each batch as it hands it out. Errors from the
    source surface on the consumer as soon as they are observed.
    ``close()`` (also on exhaustion) stops the producer.
    """

    def __init__(self, source: Iterable[Tuple], *, stage_name: str,
                 device=None, device_put: bool = True, queue_size: int = 2,
                 registry=None, tracer=None):
        self.stage_name = stage_name
        self.device_put = device_put
        self._stager = (DeviceStager(device, stage_name=stage_name,
                                     registry=registry, tracer=tracer)
                        if device_put else None)
        self._source = source
        self._pq = ProducerQueue(queue_size)
        self._finished = False
        self._depth = _queue_gauge(registry)
        self._depth.set_function(self._pq.queue.qsize, stage=stage_name)
        self._staged = _staged_counter(registry)
        self._thread = threading.Thread(
            target=self._producer, name=f"ingest-{stage_name}", daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        try:
            for batch in self._source:
                if self._pq.stop.is_set():
                    return
                if self._stager is not None:
                    item = self._stager.stage(batch)
                else:
                    self._staged.inc(stage=self.stage_name)
                    item = (batch, None)
                if not self._pq.put(item):
                    return
        except BaseException as e:   # surfaced on the consumer side
            self._pq.fail(e)
        finally:
            self._pq.finish()

    def __iter__(self) -> Iterator[Tuple]:
        return self

    def __next__(self) -> Tuple:
        if self._finished:
            raise StopIteration
        try:
            item = self._pq.get()
        except BaseException:
            self._finished = True
            raise
        if item is ProducerQueue.SENTINEL:
            self._finished = True
            raise StopIteration
        batch, event = item
        if self._stager is not None:
            self._stager.adopt(batch, event)
        return batch

    def close(self) -> None:
        """Stop the producer (bounded by one in-flight batch) and release
        the queue. Best effort: nothing restarts over this source."""
        self._pq.drain_and_join(self._thread)
        self._finished = True

    def __del__(self):
        try:
            self._pq.stop.set()
        except Exception:
            pass


def stage(source: Iterable[Tuple], *, stage_name: str = "fit", device=None,
          device_put: bool = True, queue_size: int = 2, registry=None,
          tracer=None) -> _StagedStream:
    """Wrap a batch iterable with background device staging onto
    ``device`` (double-buffered by default: one batch staging while one
    waits). ``device_put=False`` keeps batches on the host and only
    overlaps the source's own batch preparation."""
    return _StagedStream(source, stage_name=stage_name, device=device,
                         device_put=device_put, queue_size=queue_size,
                         registry=registry, tracer=tracer)


# ----------------------------------------------------------------------
# same-shape coalescing
# ----------------------------------------------------------------------

def _batch_sig(x, y) -> Optional[Tuple]:
    if not (hasattr(x, "shape") and hasattr(y, "shape")):
        return None
    return (tuple(x.shape), str(getattr(x, "dtype", "?")),
            tuple(y.shape), str(getattr(y, "dtype", "?")))


def _stack(arrays):
    if torch.is_tensor(arrays[0]):
        return torch.stack(arrays)
    return np.stack(arrays)


def coalesced(batches: Iterable[Tuple], k: int) -> Iterator[Tuple[str, Tuple]]:
    """Group runs of K consecutive same-shape maskless batches.

    Yields ``("scan", (xs, ys))`` with ``xs``/``ys`` stacked along a new
    leading axis for exactly-K runs, and ``("step", (x, y, mask))`` for
    everything else (masked batches, shape changes, sub-K tails).
    Multi-input graph batches (lists of arrays) are never coalesced.
    """
    if k < 2:
        for b in batches:
            yield ("step", b)
        return
    buf: list = []
    sig = None

    def _flush():
        for x, y in buf:
            yield ("step", (x, y, None))
        buf.clear()

    for b in batches:
        x, y, m = b[0], b[1], (b[2] if len(b) > 2 else None)
        s = _batch_sig(x, y) if m is None else None
        if s is None:
            yield from _flush()
            sig = None
            yield ("step", b)
            continue
        if buf and s != sig:
            yield from _flush()
        sig = s
        buf.append((x, y))
        if len(buf) == k:
            xs = _stack([x for x, _ in buf])
            ys = _stack([y for _, y in buf])
            buf.clear()
            yield ("scan", (xs, ys))
    yield from _flush()


# ----------------------------------------------------------------------
# the shared async fit loop (MultiLayerNetwork + ComputationGraph)
# ----------------------------------------------------------------------

_GUARDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _fit_batch(net, *batch):
    return net.fit_batch(*batch)


def _fit_scan(net, xs, ys):
    return net.fit_scan(xs, ys)


def _guarded(net, kind: str, model_label: str):
    """``(net, *batch)`` callables running the net's ``fit_batch`` or
    ``fit_scan`` behind a per-net ``util.xla.retrace_guard``
    (``jit_retraces_total`` counts per net). Kept beside the net, not on
    it, and holding no reference to it, so a copy of the net never calls
    the original and a dropped net is freed."""
    from . import xla as _xla
    guards = _GUARDS.setdefault(net, {})
    fn = guards.get(kind)
    if fn is None:
        if kind == "scan":
            fn = _xla.retrace_guard(_fit_scan, f"{model_label}.train_scan")
        else:
            fn = _xla.retrace_guard(_fit_batch, f"{model_label}.train_step")
        guards[kind] = fn
    return fn


def run_fit_loop(net, data, labels, mask, epochs: int,
                 coalesce: Optional[int], *, model_label: str,
                 session=None) -> None:
    """The dispatch-asynchronous epoch loop behind both runtimes' ``fit``.

    Per epoch: lazily reset the source (at epoch START, so the final epoch
    never restarts a producer whose work would be discarded), wrap
    iterator sources in background device staging, then dispatch steps
    behind an :class:`InflightWindow`, recording the host gap between
    consecutive dispatches. Coalescing (``k >= 2``) routes exact-K
    same-shape runs through ``fit_scan``; with listeners attached it stays
    off unless the caller passed ``coalesce`` explicitly.

    Every dispatched step first passes the ``"training.step"`` fault seam
    and lands a ``train_step`` flight-recorder event. With a ``session``
    (``util.durable.DurableSession``) the loop taps the batch stream for
    data-source cursors (before staging, so in production order), reports
    each step, and — when the session asks to stop (preemption,
    max_steps) — drains the in-flight window and returns without counting
    the partial epoch. ``DL4JTPU_PROFILE_STEPS=start:stop[:dir]`` brackets
    that dispatch range with a profiler capture, the window drained
    before it stops.

    A turn of the loop runs three phases (``util.tracing.phase``, with
    the net's ``tracer``, which the stager gets too): ``fit.batch_wait``
    (the fetch that ``fit_host_gap_seconds`` times), the dispatch (the
    runtime's ``fit.forward_backward`` and ``fit.updater``) and
    ``fit.device_wait`` (the push into the window, observed in
    ``fit_phase_seconds``); the turn that finds the data at its end has a
    ``fit.batch_wait`` alone. With a tracer, each turn is a ``fit.step``
    span, their parent. It is no profiler range: the turn runs the
    listeners, which may stop one profile and start the next, and torch
    ends a range opened in one profile inside the next one by writing
    into the first one's freed events.
    """
    single = (labels is not None or hasattr(data, "shape")
              or hasattr(data, "features")
              or (isinstance(data, tuple) and len(data) in (2, 3)))
    k = coalesce_k_default() if coalesce is None else int(coalesce)
    if net.listeners and coalesce is None and k >= 2:
        logger.info(
            "DL4JTPU_COALESCE_K=%d ignored: %d listener(s) attached — "
            "pass fit(..., coalesce=%d) to fuse anyway (listeners then "
            "get replayed host scores)", k, len(net.listeners), k)
        k = 0
    elif net.listeners and coalesce is None:
        k = 0
    from . import profiling as _profiling
    gap_hist = host_gap_histogram()
    tracer = net.tracer
    meter = _MfuMeter(model_label)
    profile_range = _profiling.profile_steps_env()
    capture = (_profiling.StepCapture(profile_range[2])
               if profile_range is not None else None)
    dispatch_idx = 0
    # a session resuming a mid-epoch cursor must not revive the source on
    # its first epoch: a cursor at the exact end of the data means zero
    # batches remain, not restart-from-scratch
    revive_ok = not (session is not None
                     and getattr(session, "resuming", False))
    window = None
    step_fn = _guarded(net, "step", model_label)
    try:
        for epoch in range(epochs):
            if hasattr(data, "reset") and (
                    epoch > 0 or (revive_ok and hasattr(data, "has_next")
                                  and not data.has_next())):
                data.reset()
            for l in net.listeners:
                if hasattr(l, "on_epoch_start"):
                    l.on_epoch_start(net, net.epoch_count)
            window = InflightWindow()
            source = net._as_batches(data, labels, mask)
            if session is not None:
                source = session.tap(source, data)
            staged = None
            if not single and staging_enabled() and not already_staged(data):
                staged = stage(source, stage_name="fit", device=net.device,
                               tracer=tracer)
                source = staged
            batches = coalesced(source, k)
            n_batches = 0
            t_prev = None
            stopped = False
            try:
                while True:
                    if (capture is not None and not capture.active
                            and dispatch_idx == profile_range[0]):
                        capture.start()
                    with (tracer.span("fit.step") if tracer is not None
                          else contextlib.nullcontext()):
                        with _tracing.phase("fit.batch_wait", tracer):
                            item = next(batches, None)
                        if item is None:
                            break
                        kind, payload = item
                        t_now = time.perf_counter()
                        if t_prev is not None:
                            gap_hist.observe(t_now - t_prev,
                                             model=model_label)
                        _flight.record(
                            "train_step", model=model_label,
                            epoch=net.epoch_count,
                            iteration=net.iteration_count, dispatch=kind,
                            host_gap_s=(round(t_now - t_prev, 6)
                                        if t_prev is not None else None))
                        _faults.check("training.step", {
                            "model": model_label, "epoch": net.epoch_count,
                            "iteration": net.iteration_count, "kind": kind})
                        if kind == "scan":
                            xs, ys = payload
                            done = _guarded(net, "scan", model_label)(
                                net, xs, ys)[-1]
                            consumed = int(xs.shape[0])
                        else:
                            done = step_fn(net, *payload)
                            consumed = 1
                        with fit_phase("device_wait", tracer, model_label):
                            window.push(done)
                        meter.on_dispatch(kind)
                        dispatch_idx += 1
                        n_batches += consumed
                        # a clean stop: every dispatched step lands before
                        # the caller snapshots the stop instant
                        stopped = (session is not None
                                   and not session.on_step(net, consumed))
                        if stopped:
                            window.drain()
                    if (capture is not None and capture.active
                            and dispatch_idx >= profile_range[1]):
                        window.drain()
                        capture.stop()
                    if stopped:
                        break
                    t_prev = time.perf_counter()
            finally:
                if staged is not None:
                    staged.close()
            if stopped:
                return      # partial epoch: no epoch_end, no count bump
            if n_batches == 0 and epoch > 0:
                raise ValueError(
                    f"epoch {epoch} yielded no batches — the data "
                    "iterator is exhausted and has no reset(); pass a "
                    "resettable iterator (e.g. "
                    "datasets.ListDataSetIterator) when epochs > 1")
            for l in net.listeners:
                if hasattr(l, "on_epoch_end"):
                    l.on_epoch_end(net, net.epoch_count)
            net.epoch_count += 1
            if session is not None:
                session.on_epoch_boundary(net)
    finally:
        if capture is not None and capture.active:
            if window is not None:
                try:
                    window.drain()
                except Exception:
                    pass    # a failed dispatch still ends the capture
            capture.stop()
