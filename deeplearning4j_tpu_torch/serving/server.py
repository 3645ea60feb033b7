"""HTTP inference server with micro-batching (counterpart of the JAX
package's ``serving/server.py``).

Endpoints:
  POST /predict   {"inputs": [[...], ...]} → {"outputs": [[...], ...]}
  POST /generate  {"prompt_ids": [...], "max_new_tokens": N,
                   "temperature": T, "top_k": k, "top_p": p, "seed": s,
                   "eos_id": id, "timeout_s": s}
                  → {"tokens": [...], "finish_reason": "eos|max_tokens|
                     deadline", "ttft_ms": ..., "n_generated": N}
                  (requires ``decode=``: the continuous-batching scheduler
                  over the paged KV arena, serving/decode.py)
  GET  /healthz   {"ok": true, "live": true, "ready": true,
                   "ready_reasons": [], "model": "...", "served": N,
                   "shed": n, "queue_depth": n, "queue_capacity": n,
                   "breaker": "closed|open|half_open", "draining": bool,
                   "model_digest": "...", "model_generation": n,
                   "decode": {"active": n, "queued": n, "prefix_cache":
                   {...}} when decode is enabled}
  GET  /livez     200 {"live": true} while the batcher loop is up
  GET  /readyz    200 {"ready": true} when the replica should be admitted
                  traffic; 503 + the gating reasons (draining, warming,
                  model_swap, stopped, breaker_open) otherwise
  GET  /metrics   Prometheus text exposition of this server's registry
  GET  /debug/flightrecorder
                  the process flight recorder's event ring as JSON
  GET  /debug/timeline
                  per-request decode timelines and every trace of this
                  server's tracer (util/timeline.py), nested by
                  parentage; ?trace_id= filters to one trace
  GET  /debug/health
                  training-health telemetry (util/health.py): latest
                  rule report, stats snapshot, NaN attribution
  POST /profile?seconds=N
                  a torch.profiler capture (host operators, and the
                  card's kernels when there is one) for N seconds
                  (default 1, max 300) into a fresh run directory;
                  returns {"dir": ...}; 409 while one is in progress
  POST /model     {"path": "/path/to/model.zip"}: swap the served model
                  from a checkpoint zip, loaded onto this server's
                  device; 409 + Retry-After while generative sequences
                  are in flight, fenced to a decode step boundary
                  otherwise

Design: requests land in a bounded queue; a batcher thread coalesces up to
``max_batch`` examples (waiting at most ``batch_timeout_ms`` after the
first) into ONE ``model.output`` call on the server's device. Batches are
padded to power-of-two sizes. Resilience as in the reference: load
shedding (503 + ``Retry-After`` when the queue is full), per-request
deadlines (504, never a model call for an expired request), a circuit
breaker over model failures, and graceful drain that also waits for
in-flight generative sequences. Fault seam: ``"serving.infer"`` around
the batched model call.
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .. import dtypes as _dtypes
from ..util import faults as _faults
from ..util import metrics as _metrics
from ..util import tracing as _tracing
from ..util.durable import params_digest  # re-exported: its home is util/durable
from ..util.resilience import (SYSTEM_CLOCK, STATE_VALUES, CircuitBreaker,
                               Clock, Deadline, metrics_transition_hook)


class ModelSwapRefused(RuntimeError):
    """``set_model`` refused: generative sequences are in flight (their
    K/V pages hold the old model's activations). Drain first."""


def drain_counter(registry=None) -> _metrics.Counter:
    """``serving_drain_total{result}`` — graceful drains by outcome."""
    reg = registry if registry is not None else _metrics.REGISTRY
    return reg.counter(
        "serving_drain_total",
        "Graceful drains by result (ok = fully drained within the "
        "timeout; timeout = half-drained, detailed by the "
        "serving_drain_timeout flight event)", ("result",))


def to_numpy(out) -> np.ndarray:
    """A model output as a numpy array. Tensors convert explicitly through
    float32 on the host: numpy has no bfloat16, and a bf16 CUDA tensor
    does not convert by itself."""
    if torch.is_tensor(out):
        return out.detach().float().cpu().numpy()
    return np.asarray(out)


class _Pending:
    __slots__ = ("x", "event", "result", "error", "code", "deadline",
                 "enqueued_at", "span", "queue_span")

    def __init__(self, x: np.ndarray, deadline: Deadline):
        self.x = x
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.code: int = 500
        self.deadline = deadline
        self.enqueued_at = time.perf_counter()
        self.span = None          # request-root tracing span
        self.queue_span = None    # child span covering queue wait


class InferenceServer:
    """Serve ``model.output`` (and, with ``decode=``, generation) over
    HTTP.

    ``device`` (default ``"cuda"``, which raises without a card) is where
    each coalesced batch is placed before ``model.output`` is called; the
    decode engine runs on the model's own device.

    ``decode``: a prebuilt :class:`~.decode.DecodeScheduler`, or a dict of
    engine and scheduler settings to build one over this model and this
    server's registry. Built engines turn the prefix cache on unless the
    dict says ``prefix_cache=False``, and warm their dispatch ladder
    before the server starts — or, with ``warmup_background=True`` (fleet
    replicas), after it: the server answers at once with ready=false
    (reason ``warming``) while a thread builds the ladder under the
    scheduler's step lock, so ticks and the ``set_model`` fence queue
    behind it."""

    def __init__(self, model, port: int = 0, *, max_batch: int = 64,
                 batch_timeout_ms: float = 5.0,
                 pad_to_buckets: bool = True,
                 max_queue: int = 256,
                 request_timeout_s: float = 30.0,
                 breaker: Optional[CircuitBreaker] = None,
                 clock: Clock = SYSTEM_CLOCK,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 tracer=None, decode=None, device="cuda",
                 warmup_background: bool = False):
        self.device = _dtypes.resolve_device(device)
        self._model = model
        self.max_batch = int(max_batch)
        self.batch_timeout_s = float(batch_timeout_ms) / 1000.0
        self.pad_to_buckets = pad_to_buckets
        self.request_timeout_s = float(request_timeout_s)
        self.clock = clock
        self.tracer = tracer
        # per-server registry by default so two servers in one process
        # don't blur each other's numbers
        self.registry = registry if registry is not None \
            else _metrics.MetricsRegistry()
        self._init_metrics()
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, reset_timeout_s=5.0, clock=clock,
            name="serving-model")
        self._chain_breaker_hook()
        # readiness (distinct from liveness): warming, swapping and
        # draining each gate admission without the process being unhealthy
        self._warming = False
        self._swapping = False
        self._model_generation = 0
        self._model_digest: Optional[str] = None
        self.decode = None
        if decode is not None:
            self.decode = self._build_decode(decode, model, clock, tracer,
                                             warmup_background)
        self._queue: "queue.Queue[_Pending]" = queue.Queue(
            maxsize=int(max_queue))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._draining = False
        # admitted-but-unanswered requests; drain() waits on this, not on
        # queue emptiness (an item leaves the queue before it is answered)
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._m_queue_depth.set_function(lambda: float(self._queue.qsize()))
        self._m_pending.set_function(lambda: float(self._pending))
        self._m_breaker_state.set_function(
            lambda: STATE_VALUES.get(self.breaker.state, -1.0))
        self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
        self._batcher.start()

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200, headers=None):
                body = json.dumps(obj).encode()
                outer._m_responses.inc(code=str(code))
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                headers = dict(headers or {})
                tp = headers.pop("traceparent",
                                 self.headers.get("traceparent"))
                if tp:
                    self.send_header("traceparent", tp)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                path = url.path
                if path == "/healthz":
                    self._json(outer._health())
                elif path == "/livez":
                    live = outer.live
                    self._json({"live": live}, 200 if live else 503)
                elif path == "/readyz":
                    reasons = outer.readiness_reasons()
                    self._json({"ready": not reasons, "reasons": reasons},
                               200 if not reasons else 503)
                elif path == "/metrics":
                    _metrics.write_exposition(self, outer.registry)
                    outer._m_responses.inc(code="200")
                elif path == "/debug/flightrecorder":
                    from ..util import flightrecorder as _flight
                    self._json({"events": _flight.jsonable_events()})
                elif path == "/debug/timeline":
                    self._json(outer._timeline(
                        parse_qs(url.query).get("trace_id", [None])[0]))
                elif path == "/debug/health":
                    from ..util import health as _health
                    # repr odd values: a debug page must not 500
                    self._json(json.loads(json.dumps(
                        _health.debug_payload(), default=repr)))
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                url = urlparse(self.path)
                if url.path == "/profile":
                    # parameters ride the query string, no body
                    from ..util.profiling import profile_request
                    self._json(*profile_request(parse_qs(url.query)))
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(length).decode())
                except Exception as e:
                    self._json({"error": f"bad request: {e}"}, 400)
                    return
                if url.path == "/generate":
                    body, code, retry_after, tp = outer._generate(
                        payload, trace_ctx=self.headers.get("traceparent"))
                    headers = {}
                    if retry_after is not None:
                        headers["Retry-After"] = f"{retry_after:.0f}"
                    if tp is not None:
                        headers["traceparent"] = tp
                    self._json(body, code, headers)
                    return
                if url.path == "/model":
                    try:
                        outer.swap_model_from(payload["path"])
                        self._json({"ok": True})
                    except ModelSwapRefused as e:
                        # retriable: drain the in-flight decodes and POST
                        # again
                        self._json({"error": str(e)}, 409,
                                   {"Retry-After": "1"})
                    except Exception as e:
                        self._json({"error": str(e)}, 400)
                    return
                if url.path != "/predict":
                    self._json({"error": "not found"}, 404)
                    return
                try:
                    x = np.asarray(payload["inputs"], dtype=np.float32)
                except Exception as e:
                    self._json({"error": f"bad inputs: {e}"}, 400)
                    return
                out, err, code, retry_after, tp = outer._predict(
                    x, trace_ctx=self.headers.get("traceparent"))
                headers = {}
                if retry_after is not None:
                    headers["Retry-After"] = f"{retry_after:.0f}"
                if tp is not None:
                    headers["traceparent"] = tp
                if err is not None:
                    self._json({"error": err}, code, headers)
                else:
                    self._json({"outputs": out.tolist()}, 200, headers)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._serve_thread.start()

    def _build_decode(self, decode, model, clock, tracer, background):
        from .decode import DecodeScheduler, PagedDecodeEngine
        if isinstance(decode, DecodeScheduler):
            return decode
        cfg = dict(decode)
        sched_kw = {k: cfg.pop(k) for k in
                    ("max_queue", "default_max_new_tokens",
                     "request_timeout_s", "start_thread") if k in cfg}
        # cross-request prefix caching is on by default for served
        # engines (traffic repeats system prompts)
        cfg.setdefault("prefix_cache", True)
        engine = PagedDecodeEngine(model, registry=self.registry, **cfg)
        if not background:
            # the ladder runs before the loop starts: server start pays
            # the first-dispatch costs, not the first live requests
            engine.warmup()
        sched = DecodeScheduler(engine, clock=clock, registry=self.registry,
                                tracer=tracer, **sched_kw)
        if background:
            self._warming = True

            def warm():
                try:
                    with sched._dispatch_lock:
                        engine.warmup()
                finally:
                    self._warming = False

            threading.Thread(target=warm, daemon=True,
                             name="serving-warmup").start()
        return sched

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def _init_metrics(self) -> None:
        reg = self.registry
        self._m_responses = reg.counter(
            "serving_responses_total", "HTTP responses by status code",
            ("code",))
        self._m_shed = reg.counter(
            "serving_shed_total",
            "Predict requests shed with 503 before reaching the model",
            ("reason",))
        self._m_deadline_expired = reg.counter(
            "serving_deadline_expired_total",
            "Queued requests answered 504 after their deadline passed")
        self._m_drain = drain_counter(reg)
        self._m_served = reg.counter(
            "serving_examples_served_total",
            "Examples answered 200 through the batched model call")
        self._m_batch_size = reg.histogram(
            "serving_batch_size", "Examples coalesced per model call",
            buckets=[float(1 << i) for i in range(11)])   # 1..1024
        self._m_latency = reg.histogram(
            "serving_request_latency_seconds",
            "Per-phase request latency: time in the bounded queue "
            "(queue_wait), coalescing window (batch_assembly), and the "
            "batched model call (model_call)", ("phase",))
        self._m_queue_depth = reg.gauge(
            "serving_queue_depth", "Requests waiting in the bounded queue")
        self._m_pending = reg.gauge(
            "serving_pending_requests", "Admitted but unanswered requests")
        self._m_breaker_state = reg.gauge(
            "serving_breaker_state",
            "Model circuit breaker state (0=closed, 1=half_open, 2=open)")
        # device memory next to the serving numbers it explains
        from ..util import profiling as _profiling
        _profiling.register_device_memory_gauges(reg)
        # POST /profile runs on a handler thread
        _profiling.prime_profiler()

    def _chain_breaker_hook(self) -> None:
        """Record breaker transitions into this server's registry, on top
        of any hook the injected breaker already carries."""
        record = metrics_transition_hook(self.registry)
        prior = self.breaker.on_transition

        def hook(name: str, old: str, new: str) -> None:
            record(name, old, new)
            if prior is not None:
                prior(name, old, new)

        self.breaker.on_transition = hook

    @property
    def served(self) -> int:
        """Examples answered 200."""
        return int(self._m_served.value())

    @property
    def shed(self) -> int:
        """Requests shed for load (queue full / draining). Breaker
        rejections are not load shedding; they appear only as
        serving_shed_total{reason="breaker_open"}."""
        return int(self._m_shed.value(reason="queue_full")
                   + self._m_shed.value(reason="draining"))

    # ------------------------------------------------------------------
    # liveness vs readiness
    # ------------------------------------------------------------------

    @property
    def live(self) -> bool:
        """The serving loops are up. False means restart the replica."""
        return not self._stop.is_set() and self._batcher.is_alive()

    def readiness_reasons(self) -> List[str]:
        """Why this replica should NOT be admitted traffic (empty = ready)."""
        reasons = []
        if self._warming:
            reasons.append("warming")
        if self._draining:
            reasons.append("draining")
        if self._swapping:
            reasons.append("model_swap")
        if self._stop.is_set():
            reasons.append("stopped")
        if self.breaker.state == "open":
            reasons.append("breaker_open")
        return reasons

    @property
    def ready(self) -> bool:
        return not self.readiness_reasons()

    @property
    def model_digest(self) -> str:
        """Content digest of the served params (cached; invalidated on
        ``set_model``)."""
        if self._model_digest is None:
            params = getattr(self._model, "params", None)
            if params is None:
                self._model_digest = type(self._model).__name__
            else:
                self._model_digest = params_digest(params)[:16]
        return self._model_digest

    @property
    def model_generation(self) -> int:
        """Monotonic count of completed model swaps on this server."""
        return self._model_generation

    def _health(self) -> dict:
        reasons = self.readiness_reasons()
        h = {"ok": not self._draining and self.breaker.state != "open",
             "live": self.live,
             "ready": not reasons,
             "ready_reasons": reasons,
             "model": type(self._model).__name__,
             "model_digest": self.model_digest,
             "model_generation": self._model_generation,
             "served": self.served,
             "shed": self.shed,
             "queue_depth": self._queue.qsize(),
             "queue_capacity": self._queue.maxsize,
             "breaker": self.breaker.state,
             "draining": self._draining}
        if self.decode is not None:
            h["decode"] = {"active": self.decode.active_count(),
                           "queued": self.decode.queue_depth()}
            eng = self.decode.engine
            index = eng.arena.prefix_index
            if index is not None:
                hits = self.registry.get("kv_prefix_hits_total")
                hit_pages = self.registry.get("kv_prefix_hit_pages_total")
                h["decode"]["prefix_cache"] = {
                    "hits_full": hits.value(result="full") if hits else 0.0,
                    "hits_partial": (hits.value(result="partial")
                                     if hits else 0.0),
                    "misses": hits.value(result="miss") if hits else 0.0,
                    "hit_pages": hit_pages.value() if hit_pages else 0.0,
                    "cached_pages": index.cached_pages,
                    "shared_pages": eng.arena.allocator.shared_pages,
                    "kv_dtype": eng.arena.kv_dtype or "fp",
                }
        return h

    def _timeline(self, trace_id: Optional[str]) -> dict:
        """The ``GET /debug/timeline`` body: request timelines and trace
        summaries from this server's tracer (a prebuilt scheduler's own
        tracer, else the process default), odd attribute values repr'd."""
        from ..util import timeline as _timeline
        tracer = self.tracer
        if tracer is None and self.decode is not None:
            tracer = self.decode.tracer
        if tracer is None:
            tracer = _tracing.TRACER
        payload = {"requests": _timeline.request_timelines(
                       tracer, trace_id=trace_id),
                   "traces": _timeline.trace_summaries(
                       tracer, trace_id=trace_id)}
        return json.loads(json.dumps(payload, default=repr))

    # ------------------------------------------------------------------
    # generate
    # ------------------------------------------------------------------

    def _generate(self, payload: dict, trace_ctx: Optional[str] = None
                  ) -> Tuple[dict, int, Optional[float], Optional[str]]:
        """POST /generate → (body, http_code, retry_after_s,
        traceparent_out). Blocks the handler thread until the scheduler
        finishes the request (the loop runs it together with every other
        in-flight sequence)."""
        from .decode import SchedulerDraining, SchedulerSaturated
        if self.decode is None:
            return ({"error": "generative decode not enabled on this "
                              "server (pass decode=)"}, 400, None, None)
        if not isinstance(payload, dict) or "prompt_ids" not in payload:
            return {"error": "missing prompt_ids"}, 400, None, None
        try:
            # coerced up front: a string would pass Deadline's float()
            # and then break the wait arithmetic below
            timeout_s = (None if payload.get("timeout_s") is None
                         else float(payload["timeout_s"]))
        except (TypeError, ValueError) as e:
            return {"error": f"bad timeout_s: {e}"}, 400, None, None
        try:
            req = self.decode.submit(
                payload["prompt_ids"], payload.get("max_new_tokens"),
                temperature=float(payload.get("temperature", 0.0)),
                eos_id=payload.get("eos_id"),
                timeout_s=timeout_s,
                seed=payload.get("seed"),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                trace_ctx=trace_ctx)
        except SchedulerDraining:
            return {"error": "server is draining"}, 503, 1.0, None
        except SchedulerSaturated as e:
            return ({"error": "server overloaded (decode queue full)"},
                    503, e.retry_after, None)
        except (ValueError, TypeError, OverflowError) as e:
            return {"error": f"bad request: {e}"}, 400, None, None
        tp = _tracing.inject(req.span) if req.span is not None else None
        budget = (timeout_s if timeout_s is not None
                  else self.decode.request_timeout_s)
        req.wait(timeout=budget + 5.0)
        if req.finish_reason is None:      # scheduler wedged: honest 504
            return {"error": "generation timeout"}, 504, None, tp
        if req.finish_reason == "error":
            # the request died with the ENGINE (pools rebuilt), not on its
            # own terms: partial output and a retryable verdict
            return ({"error": req.error or "decode failed",
                     "retryable": True,
                     "tokens": [int(t) for t in req.tokens],
                     "n_generated": len(req.tokens)}, 500, None, tp)
        if req.finish_reason == "shutdown":
            return ({"error": "server shutting down",
                     "retryable": True}, 503, None, tp)
        if req.finish_reason == "deadline" and not req.tokens:
            return {"error": "request deadline exceeded"}, 504, None, tp
        body = {"tokens": [int(t) for t in req.tokens],
                "finish_reason": req.finish_reason,
                "n_generated": len(req.tokens)}
        if req.t_first_token is not None:
            body["ttft_ms"] = round(
                1000.0 * (req.t_first_token - req.t_submit), 3)
        if req.span is not None:
            body["trace_id"] = req.span.trace_id
        return body, 200, None, tp

    # ------------------------------------------------------------------
    # predict
    # ------------------------------------------------------------------

    def _predict(self, x: np.ndarray, trace_ctx: Optional[str] = None
                 ) -> Tuple[Optional[np.ndarray], Optional[str],
                            int, Optional[float], Optional[str]]:
        """Returns (outputs, error, http_code, retry_after_s,
        traceparent_out)."""
        if self._draining or self._stop.is_set():
            self._m_shed.inc(reason="draining")
            return None, "server is draining", 503, 1.0, None
        if not self.breaker.allow():
            self._m_shed.inc(reason="breaker_open")
            retry = max(1.0, self.breaker.retry_after())
            return (None, "model circuit open (failing upstream)", 503,
                    retry, None)
        p = _Pending(x, Deadline(self.request_timeout_s, self.clock))
        tp = None
        if self.tracer is not None:
            p.span = self.tracer.start(
                "predict", parent=_tracing.extract(trace_ctx),
                attributes={"examples": int(x.shape[0])})
            p.queue_span = self.tracer.start("queue", parent=p.span)
            tp = _tracing.inject(p.span)
        with self._pending_lock:
            self._pending += 1
        try:
            self._queue.put_nowait(p)
        except queue.Full:
            with self._pending_lock:
                self._pending -= 1
            self._m_shed.inc(reason="queue_full")
            self._end_spans(p, "shed")
            return (None, "server overloaded (queue full)", 503,
                    max(1.0, self.batch_timeout_s), tp)
        p.event.wait(timeout=self.request_timeout_s + 1.0)
        if p.error is not None:
            return None, p.error, p.code, None, tp
        if p.result is None:
            return None, "inference timeout", 504, None, tp
        return p.result, None, 200, None, tp

    @staticmethod
    def _end_spans(p: _Pending, status: Optional[str] = None) -> None:
        if p.queue_span is not None:
            p.queue_span.end(status)
        if p.span is not None:
            p.span.end(status)

    def _finish(self, p: _Pending) -> None:
        """Answer a pending request (exactly once per admitted request)."""
        if p.span is not None:
            late = p.error is None and p.deadline.expired
            p.span.set_attribute("code", p.code if p.error is not None
                                 else 200)
            if late:
                p.span.set_attribute("late", True)
            self._end_spans(p, "error" if p.error is not None
                            else ("late" if late else None))
        p.event.set()
        with self._pending_lock:
            self._pending -= 1

    def _dequeued(self, p: _Pending) -> None:
        self._m_latency.observe(time.perf_counter() - p.enqueued_at,
                                phase="queue_wait")
        if p.queue_span is not None:
            p.queue_span.end()

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            self._dequeued(first)
            assembly_t0 = time.perf_counter()
            batch = [first]
            n = first.x.shape[0]
            deadline = assembly_t0 + self.batch_timeout_s
            while n < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    p = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                self._dequeued(p)
                batch.append(p)
                n += p.x.shape[0]
            self._m_latency.observe(time.perf_counter() - assembly_t0,
                                    phase="batch_assembly")
            # expired requests: their client already gave up — answer
            # 504 and spend the model call on the live ones only
            live = []
            for p in batch:
                if p.deadline.expired:
                    p.error = "request deadline exceeded"
                    p.code = 504
                    self._m_deadline_expired.inc()
                    self._finish(p)
                else:
                    live.append(p)
            if live:
                self._run_batch(live)

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, max(self.max_batch, n))

    def _run_batch(self, batch: List[_Pending]) -> None:
        batch_span = None
        model_t0 = None
        if self.tracer is not None:
            batch_span = self.tracer.start(
                "batch", parent=batch[0].span,
                attributes={"requests": len(batch)})
        try:
            x = np.concatenate([p.x for p in batch], axis=0)
            n = x.shape[0]
            if batch_span is not None:
                batch_span.set_attribute("examples", n)
            self._m_batch_size.observe(float(n))
            if self.pad_to_buckets:
                b = self._bucket(n)
                if b > n:
                    x = np.concatenate(
                        [x, np.zeros((b - n,) + x.shape[1:], x.dtype)])
            model_t0 = time.perf_counter()
            model_ctx = (self.tracer.span("model", parent=batch_span)
                         if self.tracer is not None
                         else contextlib.nullcontext())
            with self._lock, model_ctx:
                _faults.check("serving.infer", {"batch": n})
                xt = torch.from_numpy(x).to(self.device)
                out = to_numpy(self._model.output(xt))[:n]
            self._m_latency.observe(time.perf_counter() - model_t0,
                                    phase="model_call")
            ofs = 0
            for p in batch:
                k = p.x.shape[0]
                p.result = out[ofs:ofs + k]
                ofs += k
                self._finish(p)
            self._m_served.inc(n)
            self.breaker.record_success()
            if batch_span is not None:
                batch_span.end()
        except Exception as e:
            # a failing model call still has a latency — the histogram
            # must not go blind during the exact window the breaker trips
            if model_t0 is not None:
                self._m_latency.observe(time.perf_counter() - model_t0,
                                        phase="model_call")
            self.breaker.record_failure()
            if batch_span is not None:
                batch_span.end("error")
            for p in batch:
                p.error = f"{type(e).__name__}: {e}"
                p.code = 500
                self._finish(p)

    # ------------------------------------------------------------------

    def set_model(self, model) -> None:
        """Hot-swap the served model (atomic w.r.t. in-flight batches).

        With generative decode the swap is fenced to a decode step
        boundary and REFUSED (:class:`ModelSwapRefused`) while sequences
        are in flight: their K/V pages hold the old model's activations.
        Drain first."""
        if self.decode is not None:
            # not ready for the whole fence: a router stops sending before
            # the swap instead of bouncing off ModelSwapRefused
            self._swapping = True
            try:
                with self.decode.fence() as in_flight:
                    if in_flight:
                        raise ModelSwapRefused(
                            f"refusing model swap: {in_flight} generative "
                            "sequence(s) in flight — drain() first")
                    self.decode.engine.swap_net(model)
                    with self._lock:
                        self._model = model
            finally:
                self._swapping = False
            self._model_digest = None
            self._model_generation += 1
            return
        with self._lock:
            self._model = model
        self._model_digest = None
        self._model_generation += 1

    def swap_model_from(self, path: str) -> None:
        """Load a checkpoint zip (``util.serialization``) onto this
        server's device and serve it."""
        from ..util.serialization import load_model
        self.set_model(load_model(path, device=self.device))

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting new work (predicts and generates answer 503) and
        wait until everything already accepted has been answered —
        including in-flight generative sequences, which keep decoding
        until they finish or hit their own deadline. True if fully
        drained within ``timeout``; every drain counts into
        ``serving_drain_total{result}``, and a timeout also records a
        ``serving_drain_timeout`` flight event naming what was left."""
        self._draining = True
        deadline = time.perf_counter() + timeout
        decode_ok = True
        if self.decode is not None:
            decode_ok = self.decode.drain(timeout=timeout)
        drained = False
        while time.perf_counter() < deadline:
            with self._pending_lock:
                if self._pending == 0:
                    drained = True
                    break
            time.sleep(0.005)
        if not drained:
            with self._pending_lock:
                drained = self._pending == 0
        drained = drained and decode_ok
        self._m_drain.inc(result="ok" if drained else "timeout")
        if not drained:
            from ..util import flightrecorder as _flight
            _flight.record("serving_drain_timeout",
                           pending_predicts=self._pending,
                           in_flight=self._in_flight_decodes())
        return drained

    def _in_flight_decodes(self) -> List[dict]:
        """The generative requests still active (lane, progress and trace
        id), for the ``serving_drain_timeout`` event."""
        if self.decode is None:
            return []
        return [{"lane": seq.lane, "prompt_len": len(seq.req.prompt),
                 "generated": len(seq.req.tokens),
                 "max_new_tokens": seq.req.max_new_tokens,
                 "trace_id": (seq.req.span.trace_id
                              if seq.req.span is not None else None)}
                for seq in list(self.decode._active.values())]

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful shutdown: by default drains queued requests first so a
        planned restart drops nothing mid-flight."""
        if drain:
            self.drain(timeout)
        if self.decode is not None:
            self.decode.stop()
        self._stop.set()
        # answer anything still queued (drain=False or drain timeout)
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            p.error = "server shutting down"
            p.code = 503
            self._finish(p)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._batcher.join(timeout=5.0)
