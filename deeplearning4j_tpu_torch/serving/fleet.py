"""Serving fleet tier: replica registration, decode-aware routing, and
idempotent failover replay over the elastic coordination substrate
(counterpart of the JAX package's ``serving/fleet.py``).

Host code in front of the card, and on the wire the reference's exactly:
the lease documents, the registration keys and the ``/healthz`` fields
the router reads are the same, so one store may hold replicas and routers
of either package. One addition: the router also proxies ``POST
/predict`` (full-sequence outputs) with the same routing, retry budget and
failover as ``/generate``.

One :class:`~.server.InferenceServer` process per engine is not an
availability story — a single SIGTERM loses every in-flight decode and
there is no horizontal scale-out path. This module composes the
substrate the repo already has into that story, adding no new substrate:

- **Registration** (:class:`ReplicaAgent`): each replica publishes a
  heartbeat lease into a shared
  :class:`~deeplearning4j_tpu_torch.parallel.elastic.CoordinationStore`
  via :class:`~deeplearning4j_tpu_torch.parallel.elastic.LeaseMembership`
  — the
  same liveness layer the elastic trainer uses, in its DYNAMIC mode
  (replicas self-register; the router needs no fleet spec). The doc
  advertises routable capacity (free KV pages and lanes from the page
  allocator, decode queue depth), readiness (the ``/readyz`` split:
  draining / fencing for ``set_model`` / warming report ready=false),
  and a generation-stamped model digest. Liveness is ATTESTED, not
  assumed: the heartbeat publishes only through a decode step boundary
  (a bounded try-acquire of the scheduler's dispatch lock), so a wedged
  decode loop stops heartbeating and its lease expires — a background
  thread that heartbeats unconditionally would mask exactly the hang
  the fleet must route around.
- **Routing** (:class:`FleetRouter`): decode-aware, never round-robin —
  admit to the live+ready replica with the most free KV pages (adjusted
  by the router's own in-flight count × the replica's pages-per-seq, so
  a stale heartbeat cannot stampede one replica) and the shortest
  queue. No routable replica sheds AT THE ROUTER on the existing
  ``serving_shed_total`` plane with ``Retry-After`` — after a short
  grace poll (one lease period) that bridges transient empty views:
  a heartbeat landing a beat late, or the last uncordoned replica
  mid-rolling-deploy.
- **Failover** (the headline): every request gets an idempotency key
  and a router-held retry budget. When a replica dies or wedges
  mid-decode (lease lapses, connection drops, or the replica answers a
  *retryable* verdict — the :attr:`DecodeRequest.retryable` contract),
  the router replays the request on a survivor within the request's own
  SLO deadline. The idempotency table returns each key's single
  response to duplicate submissions, so work is never silently dropped
  and never double-served; ``/debug/audit`` exposes the per-key attempt
  trail the chaos tests verify.
- **Tracing**: the caller's ``traceparent`` parents a ``fleet.request``
  root span; each attempt is a ``fleet.replica_call`` child whose
  context is injected into the proxied request, so the replica's
  ``decode.request`` spans share the trace and the router's
  ``/debug/timeline`` shows the router→replica hop. A replay is an
  explicit ``fleet.failover`` span naming from/to replica and reason.
- **Rolling deploy**: :meth:`FleetRouter.rolling_set_model` walks the
  fleet one replica at a time — cordon (routing excludes it; survivors
  absorb the traffic), wait idle, ``POST /model`` behind the replica's
  own drain/fence (retrying 409s), then gate on readiness + a bumped
  model generation before uncordoning. Zero shed increase during the
  roll is an assertable property, not a hope.

Wire format note: replicas and router speak the plain
:class:`~.server.InferenceServer` HTTP API — the fleet tier is a proxy,
not a protocol.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..parallel.elastic import CoordinationStore, LeaseMembership
from ..util import flightrecorder as _flight
from ..util import metrics as _metrics
from ..util import tracing as _tracing

_FLIGHT_KIND = "fleet_membership"


def _reg(registry) -> _metrics.MetricsRegistry:
    return registry if registry is not None else _metrics.REGISTRY


# ----------------------------------------------------------------------
# metric families (factories so the conventions lint can build them)
# ----------------------------------------------------------------------

def requests_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "fleet_requests_total",
        "Requests terminated at the router by outcome (ok, error, shed, "
        "exhausted = retry budget spent, deduplicated = idempotency-key "
        "duplicate answered from the single in-flight/completed result)",
        ("outcome",))


def failovers_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "fleet_failovers_total",
        "Replays of an accepted request on a surviving replica, by what "
        "invalidated the previous attempt (transport = connection "
        "died/timed out, retryable_error = replica answered the "
        "retryable verdict, replica_shed = replica-level 503)",
        ("reason",))


def heartbeats_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "fleet_heartbeats_total",
        "Replica lease heartbeats by result (published, or "
        "skipped_wedged when the decode step boundary could not be "
        "reached — the lease is then allowed to lapse on purpose)",
        ("result",))


def router_latency_histogram(registry=None) -> _metrics.Histogram:
    return _reg(registry).histogram(
        "fleet_request_latency_seconds",
        "Router-side request latency by phase: route (replica "
        "selection), replica_call (one proxied attempt), total "
        "(admission to terminal answer, replays included)", ("phase",))


def live_replicas_gauge(registry=None) -> _metrics.Gauge:
    return _reg(registry).gauge(
        "fleet_live_replicas", "Replicas with an unexpired lease")


def ready_replicas_gauge(registry=None) -> _metrics.Gauge:
    return _reg(registry).gauge(
        "fleet_ready_replicas",
        "Live replicas currently advertising ready=true")


def shed_counter(registry=None) -> _metrics.Counter:
    # the ROUTER sheds on the same plane the replicas do — one family,
    # one alerting rule, wherever in the tier the 503 happens
    return _reg(registry).counter(
        "serving_shed_total",
        "Predict requests shed with 503 before reaching the model",
        ("reason",))


# ----------------------------------------------------------------------
# replica agent
# ----------------------------------------------------------------------

class ReplicaAgent:
    """Registers one :class:`~.server.InferenceServer` in the fleet and
    keeps its lease fresh.

    The heartbeat doc carries everything the router needs to route
    without calling the replica: address, readiness (+ reasons),
    capacity (free KV pages / lanes, queue depth, active sequences),
    and the generation-stamped model digest. ``stop()`` publishes
    ``status="done"`` so a clean leave is a ``done`` membership
    transition, not an evict.
    """

    def __init__(self, server, store: CoordinationStore, *, replica: str,
                 lease_s: float = 2.0,
                 heartbeat_every_s: Optional[float] = None,
                 probe_timeout_s: Optional[float] = None,
                 addr: Optional[str] = None, registry=None):
        self.server = server
        self.replica = str(replica)
        self.lease_s = float(lease_s)
        self.heartbeat_every_s = (max(0.02, self.lease_s / 4.0)
                                  if heartbeat_every_s is None
                                  else float(heartbeat_every_s))
        self.probe_timeout_s = (min(0.5, self.heartbeat_every_s / 2.0)
                                if probe_timeout_s is None
                                else float(probe_timeout_s))
        self.registry = registry if registry is not None else server.registry
        self.membership = LeaseMembership(
            store, observer=self.replica, lease_s=self.lease_s,
            registry=self.registry, flight_kind=_FLIGHT_KIND)
        self.incarnation = self.membership.next_incarnation(self.replica)
        self.addr = addr or f"127.0.0.1:{server.port}"
        self._m_heartbeats = heartbeats_counter(self.registry)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- doc -----------------------------------------------------------

    def capacity(self) -> Dict[str, Any]:
        srv = self.server
        cap: Dict[str, Any] = {"queue_depth": 0, "active": 0}
        if srv.decode is not None:
            cap["queue_depth"] = srv.decode.queue_depth()
            cap["active"] = srv.decode.active_count()
            eng = srv.decode.engine
            cap["free_lanes"] = eng.lanes_free()
            cap["free_pages"] = eng.arena.allocator.available()
            cap["pages_per_seq"] = eng.pages_per_seq
        return cap

    def _doc(self, status: str = "live") -> Dict[str, Any]:
        srv = self.server
        reasons = srv.readiness_reasons()
        return {"host": self.replica, "incarnation": self.incarnation,
                "status": status, "addr": self.addr,
                "ready": not reasons, "ready_reasons": reasons,
                "model_digest": srv.model_digest,
                "model_generation": srv.model_generation,
                "capacity": self.capacity()}

    # -- heartbeat loop ------------------------------------------------

    def beat(self) -> bool:
        """One heartbeat attempt. Publishes only through a decode step
        boundary: a wedged dispatch holds the lock for the whole hang,
        the probe times out, and the lease lapses — which is the signal
        the router fails over on. During background warmup the lock is
        legitimately held for the whole compile, so the probe is skipped
        and the replica registers (ready=false) while it warms."""
        srv = self.server
        if srv.decode is not None and "warming" not in \
                srv.readiness_reasons():
            lock = srv.decode._dispatch_lock
            if not lock.acquire(timeout=self.probe_timeout_s):
                self._m_heartbeats.inc(result="skipped_wedged")
                return False
            try:
                doc = self._doc()
            finally:
                lock.release()
        else:
            doc = self._doc()
        self.membership.publish(self.replica, doc)
        self._m_heartbeats.inc(result="published")
        return True

    def start(self) -> "ReplicaAgent":
        """Publish the first heartbeat (registration) and start the
        lease-keeping thread."""
        self.beat()

        def _loop():
            while not self._stop.wait(self.heartbeat_every_s):
                try:
                    self.beat()
                except Exception:
                    # a failing heartbeat must never kill the agent
                    # thread: a stale lease is exactly the protocol's
                    # failure signal, so failing to publish IS handled
                    self._m_heartbeats.inc(result="error")
        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name=f"fleet-agent-{self.replica}")
        self._thread.start()
        return self

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if deregister:
            self.membership.publish(self.replica, self._doc(status="done"))


# ----------------------------------------------------------------------
# router
# ----------------------------------------------------------------------

class _Entry:
    """One idempotency-key slot: the single response every submission of
    the key receives."""
    __slots__ = ("event", "response")

    def __init__(self):
        self.event = threading.Event()
        self.response: Optional[Tuple[dict, int]] = None


class FleetRouter:
    """HTTP front for N registered replicas: decode-aware routing,
    idempotent failover replay, rolling deploy.

    Endpoints:
      POST /generate  routed + replayed; response gains ``replica``,
                      ``attempts`` and ``idempotency_key``
      POST /predict   the same, for full-sequence outputs
      POST /model     {"path": ...} → rolling deploy across the fleet
      GET  /healthz   router + per-replica membership summary
      GET  /fleet     full lease view (docs included), cordons, inflight
      GET  /metrics   router registry exposition
      GET  /debug/audit     idempotency-keyed attempt trail
      GET  /debug/timeline  fleet.request timelines (router→replica hops)
    """

    def __init__(self, store: CoordinationStore, *, port: int = 0,
                 lease_s: float = 2.0, retry_budget: int = 2,
                 request_timeout_s: float = 30.0,
                 attempt_timeout_s: float = 10.0,
                 view_refresh_s: float = 0.05,
                 shed_grace_s: Optional[float] = None,
                 observer: str = "router", registry=None, tracer=None):
        self.store = store
        self.retry_budget = int(retry_budget)
        self.request_timeout_s = float(request_timeout_s)
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.view_refresh_s = float(view_refresh_s)
        # An empty routable set is usually TRANSIENT — a heartbeat
        # arriving a beat late under scheduler jitter, or the last
        # uncordoned replica mid-rolling-deploy — so the router polls
        # the lease view for up to one lease period (bounded by the
        # request's own deadline) before it sheds. Genuine outages
        # still shed; they just pay one grace period first.
        self.shed_grace_s = float(lease_s if shed_grace_s is None
                                  else shed_grace_s)
        self.registry = registry if registry is not None \
            else _metrics.MetricsRegistry()
        self.tracer = tracer
        self.membership = LeaseMembership(
            store, observer=observer, lease_s=float(lease_s),
            registry=self.registry, flight_kind=_FLIGHT_KIND)
        self._m_requests = requests_counter(self.registry)
        self._m_failovers = failovers_counter(self.registry)
        self._m_latency = router_latency_histogram(self.registry)
        self._m_shed = shed_counter(self.registry)
        self._view_lock = threading.Lock()
        self._last_view: Dict[str, dict] = {}
        self._view_ts = -1e18
        live_replicas_gauge(self.registry).set_function(
            lambda: float(sum(1 for v in self._last_view.values()
                              if v["alive"] and not v["done"])))
        ready_replicas_gauge(self.registry).set_function(
            lambda: float(sum(1 for v in self._last_view.values()
                              if v["alive"] and not v["done"]
                              and (v["doc"] or {}).get("ready"))))
        self._inflight: collections.Counter = collections.Counter()
        self._inflight_lock = threading.Lock()
        self._cordoned: set = set()
        self._results: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        self._results_lock = threading.Lock()
        self._audit: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._max_keys = 4096

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200, headers=None):
                body = json.dumps(obj, default=repr).encode()
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
                elif path == "/fleet":
                    self._json(outer.fleet_state())
                elif path == "/metrics":
                    _metrics.write_exposition(self, outer.registry)
                elif path == "/debug/audit":
                    self._json({"audit": dict(outer._audit)})
                elif path == "/debug/timeline":
                    from ..util import timeline as _timeline
                    q = parse_qs(url.query)
                    tracer = outer.tracer
                    if tracer is None:
                        tracer = _tracing.TRACER
                    tid = q.get("trace_id", [None])[0]
                    payload = {
                        "requests": _timeline.request_timelines(
                            tracer, root_name="fleet.request",
                            trace_id=tid),
                        "traces": _timeline.trace_summaries(
                            tracer, trace_id=tid)}
                    self._json(json.loads(
                        json.dumps(payload, default=repr)))
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                url = urlparse(self.path)
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(length).decode())
                except Exception as e:
                    self._json({"error": f"bad request: {e}"}, 400)
                    return
                if url.path in ("/generate", "/predict"):
                    body, code, headers = outer.route(
                        url.path, payload,
                        trace_ctx=self.headers.get("traceparent"),
                        idem_key=self.headers.get("x-idempotency-key"))
                    self._json(body, code, headers)
                elif url.path == "/model":
                    try:
                        results = outer.rolling_set_model(payload["path"])
                        self._json({"ok": True, "replicas": results})
                    except Exception as e:
                        self._json({"error": str(e)}, 500)
                else:
                    self._json({"error": "not found"}, 404)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="fleet-router")
        self._serve_thread.start()

    # -- membership view -----------------------------------------------

    def view(self, force: bool = False) -> Dict[str, dict]:
        """Lease view, cached for ``view_refresh_s`` so a request burst
        does not multiply store reads."""
        now = time.perf_counter()
        with self._view_lock:
            if force or now - self._view_ts >= self.view_refresh_s:
                self._last_view = self.membership.view()
                self._view_ts = now
            return self._last_view

    def _health(self) -> dict:
        view = self.view()
        reps = {h: {"alive": v["alive"], "done": v["done"],
                    "ready": bool((v["doc"] or {}).get("ready")),
                    "age_s": v["age_s"]}
                for h, v in view.items()}
        return {"ok": True, "role": "router", "replicas": reps,
                "live": sum(1 for v in view.values()
                            if v["alive"] and not v["done"]),
                "ready": sum(1 for r in reps.values()
                             if r["ready"] and r["alive"]),
                "cordoned": sorted(self._cordoned)}

    def fleet_state(self) -> dict:
        view = self.view()
        with self._inflight_lock:
            inflight = dict(self._inflight)
        return {"replicas": view, "cordoned": sorted(self._cordoned),
                "inflight": inflight}

    # -- routing policy ------------------------------------------------

    def _pick(self, exclude=()) -> Tuple[Optional[str], Optional[dict]]:
        """Decode-aware selection: the live+ready replica with the most
        free KV pages — discounted by what this router has already sent
        it but the (possibly stale) heartbeat doesn't reflect — then the
        shortest queue. Deliberately not round-robin: a replica running
        long sequences has less room than its turn would claim."""
        view = self.view()
        best, best_score = None, None
        with self._inflight_lock:
            inflight = dict(self._inflight)
        for h in sorted(view):
            v = view[h]
            if h in exclude or h in self._cordoned:
                continue
            if not v["alive"] or v["done"]:
                continue
            doc = v["doc"] or {}
            if not doc.get("ready") or doc.get("status") != "live":
                continue
            cap = doc.get("capacity") or {}
            mine = inflight.get(h, 0)
            free = cap.get("free_pages")
            adj = (free - cap.get("pages_per_seq", 0) * mine
                   if free is not None else 0)
            queue = cap.get("queue_depth", 0) + cap.get("active", 0) + mine
            score = (adj, -queue)
            if best_score is None or score > best_score:
                best, best_score = h, score
        return best, (view[best]["doc"] if best is not None else None)

    # -- HTTP client ---------------------------------------------------

    @staticmethod
    def _call(addr: str, path: str, payload: Optional[dict], *,
              timeout: float, headers: Optional[dict] = None,
              method: str = "POST"
              ) -> Tuple[Optional[int], dict, dict]:
        """(status, body, headers); status None = transport failure
        (connection refused/reset, socket timeout) — the retryable kind."""
        req = urllib.request.Request(
            f"http://{addr}{path}",
            data=(None if payload is None
                  else json.dumps(payload).encode()),
            headers={"Content-Type": "application/json",
                     **(headers or {})},
            method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return (r.status, json.loads(r.read().decode()),
                        dict(r.headers))
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read().decode())
            except Exception:
                body = {"error": str(e)}
            return e.code, body, dict(e.headers)
        except Exception as e:  # URLError, timeout, reset — transport
            return None, {"error": f"{type(e).__name__}: {e}"}, {}

    def _track(self, replica: str, delta: int) -> None:
        with self._inflight_lock:
            self._inflight[replica] += delta
            if self._inflight[replica] <= 0:
                del self._inflight[replica]

    # -- the headline path ---------------------------------------------

    def route_generate(self, payload: dict,
                       trace_ctx: Optional[str] = None,
                       idem_key: Optional[str] = None
                       ) -> Tuple[dict, int, dict]:
        """Route one /generate (see :meth:`route`)."""
        return self.route("/generate", payload, trace_ctx, idem_key)

    def route(self, path: str, payload: dict,
              trace_ctx: Optional[str] = None,
              idem_key: Optional[str] = None) -> Tuple[dict, int, dict]:
        """Route one ``/generate`` or ``/predict``: pick → proxy → (on a
        retryable failure) replay on a survivor, all inside the request's
        SLO deadline and the router's retry budget. Exactly one response
        per idempotency key, ever."""
        key = str(payload.get("idempotency_key") or idem_key
                  or uuid.uuid4().hex)
        budget = self.request_timeout_s
        try:
            if payload.get("timeout_s") is not None:
                budget = float(payload["timeout_s"])
        except (TypeError, ValueError):
            return {"error": "bad timeout_s"}, 400, {}
        with self._results_lock:
            entry = self._results.get(key)
            owner = entry is None
            if owner:
                entry = _Entry()
                self._results[key] = entry
                while len(self._results) > self._max_keys:
                    _, old = self._results.popitem(last=False)
                    old.event.set()  # never strand a waiter
        if not owner:
            # duplicate submission: the key's single response, not a
            # second serve
            self._m_requests.inc(outcome="deduplicated")
            entry.event.wait(timeout=budget + 5.0)
            if entry.response is None:
                return ({"error": "duplicate of an in-flight request "
                                  "that did not finish"}, 504, {})
            body, code = entry.response
            return dict(body), code, {"x-idempotent-replay": "true"}
        body, code, headers = self._attempts(path, payload, key, budget,
                                             trace_ctx)
        entry.response = (body, code)
        entry.event.set()
        return body, code, headers

    def _attempts(self, path: str, payload: dict, key: str, budget: float,
                  trace_ctx: Optional[str]) -> Tuple[dict, int, dict]:
        t0 = time.perf_counter()
        deadline = t0 + budget
        prompt = payload.get("prompt_ids") or []
        root = None
        if self.tracer is not None:
            root = self.tracer.start(
                "fleet.request", parent=_tracing.extract(trace_ctx),
                attributes={"idempotency_key": key,
                            "prompt_len": len(prompt)})
        tp_root = (_tracing.inject(root) if root is not None else None)
        trail: List[dict] = []

        def _finish(body, code, headers, outcome, status=None):
            self._m_requests.inc(outcome=outcome)
            self._m_latency.observe(time.perf_counter() - t0,
                                    phase="total")
            if root is not None:
                root.set_attribute("attempts", len(trail))
                root.set_attribute("outcome", outcome)
                root.end(status)
            self._audit_put(key, trail, code)
            if tp_root is not None:
                headers = dict(headers, traceparent=tp_root)
            return body, code, headers

        exclude: set = set()
        attempt = 0
        while True:
            rt0 = time.perf_counter()
            replica, doc = self._pick(exclude)
            if replica is None:
                grace_end = min(deadline,
                                time.perf_counter() + self.shed_grace_s)
                while replica is None \
                        and time.perf_counter() < grace_end:
                    time.sleep(0.025)
                    self.view(force=True)
                    replica, doc = self._pick(exclude)
            self._m_latency.observe(time.perf_counter() - rt0,
                                    phase="route")
            if replica is None:
                # shed at the router, same plane as the replicas
                self._m_shed.inc(reason="no_replica")
                retry_after = max(1.0, self.membership.lease_s)
                _flight.record("fleet_shed", key=key,
                               excluded=sorted(exclude),
                               cordoned=sorted(self._cordoned))
                outcome = "shed" if not trail else "exhausted"
                return _finish(
                    {"error": "no routable replica", "retryable": True,
                     "idempotency_key": key}, 503,
                    {"Retry-After": f"{retry_after:.0f}"},
                    outcome, status="shed")
            attempt += 1
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return _finish(
                    {"error": "SLO deadline exhausted at the router",
                     "idempotency_key": key}, 504, {},
                    "timeout", status="timeout")
            call_span = None
            tp_out = trace_ctx
            if self.tracer is not None:
                call_span = self.tracer.start(
                    "fleet.replica_call", parent=root,
                    attributes={"replica": replica, "attempt": attempt})
                tp_out = _tracing.inject(call_span)
            fwd = dict(payload)
            fwd["timeout_s"] = max(0.05, remaining)
            fwd.pop("idempotency_key", None)
            ct0 = time.perf_counter()
            self._track(replica, +1)
            try:
                code, body, _hdrs = self._call(
                    doc["addr"], path, fwd,
                    timeout=min(self.attempt_timeout_s,
                                max(0.05, remaining)),
                    headers={} if tp_out is None
                    else {"traceparent": tp_out,
                          "x-idempotency-key": key})
            finally:
                self._track(replica, -1)
            self._m_latency.observe(time.perf_counter() - ct0,
                                    phase="replica_call")
            trail.append({"replica": replica, "attempt": attempt,
                          "code": code})
            if code == 200:
                if call_span is not None:
                    call_span.end()
                out = dict(body, replica=replica, attempts=attempt,
                           idempotency_key=key)
                return _finish(out, 200, {}, "ok")
            # classify: is the failed attempt safe to replay?
            retryable = (code is None
                         or (code in (500, 502, 503)
                             and (code != 500
                                  or bool(body.get("retryable")))))
            if not retryable:
                if call_span is not None:
                    call_span.end("error")
                return _finish(dict(body, replica=replica,
                                    idempotency_key=key),
                               code, {}, "error", status="error")
            reason = ("transport" if code is None
                      else "replica_shed" if code == 503
                      else "retryable_error")
            if call_span is not None:
                call_span.set_attribute("failed", reason)
                call_span.end("error")
            exclude.add(replica)
            if attempt > self.retry_budget:
                return _finish(
                    {"error": f"retry budget exhausted after {attempt} "
                              "attempts", "retryable": True,
                     "idempotency_key": key}, 503,
                    {"Retry-After": "1"}, "exhausted", status="error")
            # the failover hop, named in the timeline and the black box
            self._m_failovers.inc(reason=reason)
            nxt, _ = self._pick(exclude)
            if self.tracer is not None:
                fspan = self.tracer.start(
                    "fleet.failover", parent=root,
                    attributes={"from_replica": replica,
                                "to_replica": nxt, "reason": reason})
                fspan.end()
            _flight.record("fleet_failover", key=key,
                           from_replica=replica, to_replica=nxt,
                           reason=reason, attempt=attempt)

    def _audit_put(self, key: str, trail: List[dict], code: int) -> None:
        with self._results_lock:
            self._audit[key] = {"attempts": trail, "code": code}
            while len(self._audit) > self._max_keys:
                self._audit.popitem(last=False)

    # -- rolling deploy ------------------------------------------------

    def rolling_set_model(self, path: str, *,
                          drain_timeout_s: float = 30.0,
                          ready_timeout_s: float = 120.0,
                          poll_s: float = 0.05) -> List[dict]:
        """Swap the served model fleet-wide, one replica at a time, with
        zero shed increase: cordon (routing excludes the replica while
        survivors absorb the load), wait until the router has nothing in
        flight there and the replica's decode is idle, ``POST /model``
        behind its drain/fence (409s retried — the fence refuses while
        sequences are in flight), then gate on readiness + a bumped
        model generation before uncordoning and moving on."""
        view = self.view(force=True)
        targets = [(h, v["doc"]) for h, v in sorted(view.items())
                   if v["alive"] and not v["done"] and v["doc"]]
        results = []
        for h, doc in targets:
            addr = doc["addr"]
            code, health, _ = self._call(addr, "/healthz", None,
                                         timeout=5.0, method="GET")
            gen_before = (health or {}).get("model_generation", 0)
            self._cordoned.add(h)
            t0 = time.perf_counter()
            try:
                # 1. idle: nothing of ours in flight, decode quiet
                deadline = t0 + drain_timeout_s
                while time.perf_counter() < deadline:
                    with self._inflight_lock:
                        mine = self._inflight.get(h, 0)
                    code, health, _ = self._call(addr, "/healthz", None,
                                                 timeout=5.0,
                                                 method="GET")
                    dec = (health or {}).get("decode") or {}
                    if mine == 0 and dec.get("active", 0) == 0 \
                            and dec.get("queued", 0) == 0:
                        break
                    time.sleep(poll_s)
                # 2. swap, retrying the fence's 409 until it admits us
                deadline = time.perf_counter() + ready_timeout_s
                while True:
                    code, body, _ = self._call(addr, "/model",
                                               {"path": path},
                                               timeout=ready_timeout_s)
                    if code == 200:
                        break
                    if code == 409 and time.perf_counter() < deadline:
                        time.sleep(poll_s)
                        continue
                    raise RuntimeError(
                        f"model swap on {h} failed: {code} {body}")
                # 3. readiness gate: serving the NEW model, ready again
                while time.perf_counter() < deadline:
                    code, health, _ = self._call(addr, "/healthz", None,
                                                 timeout=5.0,
                                                 method="GET")
                    if code == 200 and health.get("ready") \
                            and health.get("model_generation",
                                           0) > gen_before:
                        break
                    time.sleep(poll_s)
                else:
                    raise RuntimeError(
                        f"{h} did not become ready on the new model")
            finally:
                self._cordoned.discard(h)
            _flight.record("fleet_rolling_deploy", replica=h,
                           model_digest=health.get("model_digest"),
                           generation=health.get("model_generation"),
                           seconds=time.perf_counter() - t0)
            results.append({"replica": h, "ok": True,
                            "model_digest": health.get("model_digest"),
                            "model_generation":
                                health.get("model_generation")})
        return results

    # -- lifecycle -----------------------------------------------------

    def stop(self) -> None:
        self._httpd.shutdown()
        self._serve_thread.join(timeout=5.0)


def rolling_set_model(router: FleetRouter, path: str, **kwargs) -> List[dict]:
    """Fleet-wide model swap through ``router`` (see
    :meth:`FleetRouter.rolling_set_model`)."""
    return router.rolling_set_model(path, **kwargs)
