"""The port's serving fleet on the CPU: the classes of
``tests/test_fleet.py`` with port replicas (registration over the lease
substrate, the readiness split, drain telemetry, the engine-level
replica-loss contract, the routing policy, and two real replicas behind a
real router over the full HTTP path), and mixed fleets: a reference
``FleetRouter`` routing to port replicas and a port router routing to
reference replicas over one ``FileCoordinationStore`` — the wire format
that mixed fleets rely on.

Replicas serve the kill harness's LM (``tests/_kill_harness.py``:
``transformer_lm(32, n_layers=1, d_model=32, n_heads=2, d_ff=64,
max_cache_t=32)``), initialised by the JAX package and loaded by the port
from its checkpoint. Greedy tokens are compared exactly with the JAX
package's ``generate`` on the same weights. The ``ManualClock`` cases
stay deterministic.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import _kill_harness as harness
from deeplearning4j_tpu.models.transformer import generate as j_generate
from deeplearning4j_tpu.parallel import elastic as j_elastic
from deeplearning4j_tpu.serving import FleetRouter as JFleetRouter
from deeplearning4j_tpu.serving import InferenceServer as JInferenceServer
from deeplearning4j_tpu.serving import ReplicaAgent as JReplicaAgent
from deeplearning4j_tpu.util.serialization import load_model as j_load_model
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

from deeplearning4j_tpu_torch.parallel.elastic import (
    FileCoordinationStore, InMemoryCoordinationStore, LeaseMembership)
from deeplearning4j_tpu_torch.serving import (DecodeScheduler, FleetRouter,
                                              InferenceServer,
                                              PagedDecodeEngine, ReplicaAgent,
                                              rolling_set_model)
from deeplearning4j_tpu_torch.util import faults
from deeplearning4j_tpu_torch.util import flightrecorder as _flight
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.resilience import ManualClock
from deeplearning4j_tpu_torch.util.serialization import load_model
from deeplearning4j_tpu_torch.util.tracing import Tracer

DECODE_CFG = {"max_batch": 2, "page_size": 8, "pages_per_seq": 4,
              "prefill_chunk": 8}


def _post(port, path, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path, timeout=10):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_until(fn, timeout=30.0, every=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(every)
    assert fn(), f"timed out waiting for {msg}"


def _dead_addr():
    """An address nothing listens on (bind, grab the port, close)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    paths = {}
    for seed in (5, 11):
        paths[seed] = str(d / f"lm{seed}.zip")
        j_save_model(harness.build_lm_net(seed), paths[seed])
    return paths


@pytest.fixture(scope="module")
def ref_net(ckpts):
    return j_load_model(ckpts[5])


def _ref_greedy(ref_net, prompt, n):
    return [int(t) for t in j_generate(ref_net, np.asarray(prompt), n)]


def _net(ckpts, seed=5):
    return load_model(ckpts[seed], device="cpu")


# ----------------------------------------------------------------------
# the lease substrate (parallel/elastic.LeaseMembership)
# ----------------------------------------------------------------------

class TestLeaseMembershipDynamic:
    def test_discovery_transitions_and_docs(self):
        store = InMemoryCoordinationStore()
        reg = MetricsRegistry()
        obs = LeaseMembership(store, observer="router", lease_s=0.2,
                              registry=reg, flight_kind="fleet_membership")
        pub = LeaseMembership(store, observer="pub", lease_s=0.2)
        assert obs.members() == ()
        pub.publish("a", {"status": "live", "ready": True,
                          "capacity": {"free_pages": 9}})
        pub.publish("b", {"status": "live", "ready": False})
        v = obs.view()
        assert set(v) == {"a", "b"}
        assert v["a"]["alive"] and not v["a"]["done"]
        assert v["a"]["doc"]["capacity"]["free_pages"] == 9
        tc = reg.get("membership_transitions_total")
        assert tc.value(event="join", host="a") == 1
        assert tc.value(event="join", host="b") == 1
        time.sleep(0.35)
        v = obs.view()
        assert not v["a"]["alive"]
        assert tc.value(event="evict", host="a") == 1
        pub.publish("a", {"status": "live"})
        v = obs.view()
        assert v["a"]["alive"]
        assert tc.value(event="rejoin", host="a") == 1
        pub.publish("b", {"status": "done"})
        v = obs.view()
        assert v["b"]["done"] and v["b"]["alive"]

    def test_incarnation_counts_restarts(self):
        store = InMemoryCoordinationStore()
        lm = LeaseMembership(store, observer="x", lease_s=1.0)
        assert lm.next_incarnation("r0") == 1
        lm.publish("r0", {"incarnation": 1})
        assert lm.next_incarnation("r0") == 2


# ----------------------------------------------------------------------
# liveness vs readiness
# ----------------------------------------------------------------------

class TestReadinessSplit:
    def test_livez_readyz_and_health_fields(self, ckpts):
        srv = InferenceServer(_net(ckpts), port=0, device="cpu")
        try:
            code, h = _get(srv.port, "/healthz")
            assert code == 200
            assert h["live"] is True and h["ready"] is True
            assert h["ready_reasons"] == []
            assert isinstance(h["model_digest"], str) and h["model_digest"]
            assert h["model_generation"] == 0
            assert _get(srv.port, "/livez") == (200, {"live": True})
            assert _get(srv.port, "/readyz") == (
                200, {"ready": True, "reasons": []})
            for _ in range(3):
                srv.breaker.record_failure()
            assert srv.breaker.state == "open"
            code, body = _get(srv.port, "/readyz")
            assert code == 503 and body["reasons"] == ["breaker_open"]
            assert _get(srv.port, "/livez")[0] == 200
            assert _get(srv.port, "/healthz")[1]["live"] is True
        finally:
            srv.stop(drain=False)

    def test_draining_is_not_ready_but_live(self, ckpts):
        srv = InferenceServer(_net(ckpts), port=0, device="cpu")
        try:
            assert srv.drain(timeout=5.0)
            code, body = _get(srv.port, "/readyz")
            assert code == 503 and "draining" in body["reasons"]
            assert _get(srv.port, "/livez")[0] == 200
            assert _get(srv.port, "/healthz")[1]["ok"] is False
        finally:
            srv.stop(drain=False)

    def test_background_warmup_reports_warming_then_ready(self, ckpts,
                                                          monkeypatch):
        """A fleet replica registers (ready=false, reason=warming) while
        its ladder is built, instead of being invisible until then. The
        warm-up is held on an event, so the warming window is certain."""
        release = threading.Event()
        warmup = PagedDecodeEngine.warmup

        def held(self):
            assert release.wait(timeout=60)
            warmup(self)

        monkeypatch.setattr(PagedDecodeEngine, "warmup", held)
        store = InMemoryCoordinationStore()
        srv = InferenceServer(_net(ckpts), port=0, device="cpu",
                              decode=dict(DECODE_CFG),
                              warmup_background=True)
        agent = None
        try:
            assert "warming" in srv.readiness_reasons()
            agent = ReplicaAgent(srv, store, replica="w0", lease_s=2.0)
            assert agent.beat()  # warming replicas publish unprobed
            doc = store.get_json("hb/w0.json")
            assert doc["ready"] is False
            assert "warming" in doc["ready_reasons"]
            assert doc["capacity"]["free_pages"] > 0
            release.set()
            wait_until(lambda: srv.ready, timeout=120, msg="warmup")
            assert agent.beat()
            doc = store.get_json("hb/w0.json")
            assert doc["ready"] is True and doc["ready_reasons"] == []
            code, body, _ = _post(srv.port, "/generate",
                                  {"prompt_ids": [1, 2, 3],
                                   "max_new_tokens": 3})
            assert code == 200 and len(body["tokens"]) == 3
            agent.stop(deregister=True)
            assert store.get_json("hb/w0.json")["status"] == "done"
        finally:
            release.set()
            if agent is not None:
                agent.stop(deregister=False)
            srv.stop(drain=False)

    def test_registration_doc_fields_equal_the_references(self, ckpts,
                                                          ref_net):
        """The lease documents of a port replica and a reference replica
        carry the same keys, capacity keys included — what a router of
        either package reads."""
        store = InMemoryCoordinationStore()
        jstore = j_elastic.InMemoryCoordinationStore()
        srv = InferenceServer(_net(ckpts), port=0, device="cpu",
                              decode=dict(DECODE_CFG))
        jsrv = JInferenceServer(ref_net, port=0, decode=dict(DECODE_CFG))
        try:
            ReplicaAgent(srv, store, replica="p").beat()
            JReplicaAgent(jsrv, jstore, replica="j").beat()
            doc, jdoc = store.get_json("hb/p.json"), jstore.get_json(
                "hb/j.json")
            assert set(doc) == set(jdoc)
            assert set(doc["capacity"]) == set(jdoc["capacity"])
            assert doc["capacity"] == jdoc["capacity"]
            assert (doc["status"], doc["ready"], doc["incarnation"]) == \
                (jdoc["status"], jdoc["ready"], jdoc["incarnation"])
            h, jh = _get(srv.port, "/healthz")[1], _get(jsrv.port,
                                                        "/healthz")[1]
            assert set(h) == set(jh) and set(h["decode"]) == \
                set(jh["decode"])
        finally:
            srv.stop(drain=False)
            jsrv.stop(drain=False)


# ----------------------------------------------------------------------
# drain telemetry
# ----------------------------------------------------------------------

class _BlockingModel:
    def __init__(self, width=3):
        self.width = width
        self.entered = threading.Event()
        self.release = threading.Event()

    def output(self, x):
        self.entered.set()
        assert self.release.wait(timeout=30)
        return np.zeros((x.shape[0], self.width), np.float32)


@pytest.mark.chaos
class TestDrainTelemetry:
    def test_drain_timeout_counts_and_names_pending_predicts(self):
        model = _BlockingModel()
        srv = InferenceServer(model, port=0, max_batch=1, device="cpu")
        t = threading.Thread(target=_post, args=(
            srv.port, "/predict", {"inputs": [[0.0, 0.0, 0.0]]}))
        try:
            n_before = len(_flight.events("serving_drain_timeout"))
            t.start()
            assert model.entered.wait(timeout=10)
            assert srv.drain(timeout=0.2) is False
            drains = srv.registry.get("serving_drain_total")
            assert drains.value(result="timeout") == 1
            evs = _flight.events("serving_drain_timeout")
            assert len(evs) == n_before + 1
            assert evs[-1]["pending_predicts"] >= 1
            model.release.set()
            t.join(timeout=30)
            assert srv.drain(timeout=10.0) is True
            assert drains.value(result="ok") == 1
        finally:
            model.release.set()
            srv.stop(drain=False)

    def test_drain_timeout_names_in_flight_decodes(self, ckpts):
        reg = MetricsRegistry()
        tracer = Tracer()
        net = _net(ckpts)
        eng = PagedDecodeEngine(net, registry=reg, **DECODE_CFG)
        sched = DecodeScheduler(eng, clock=ManualClock(), registry=reg,
                                tracer=tracer, start_thread=False)
        srv = InferenceServer(net, port=0, decode=sched, device="cpu")
        try:
            req = sched.submit([1, 2, 3], max_new_tokens=8)
            sched.step_once()
            assert not req.done
            assert srv.drain(timeout=0.0) is False
            ev = _flight.events("serving_drain_timeout")[-1]
            assert len(ev["in_flight"]) == 1
            entry = ev["in_flight"][0]
            assert entry["prompt_len"] == 3
            assert entry["max_new_tokens"] == 8
            assert entry["trace_id"] == req.span.trace_id
            for _ in range(200):
                if req.done:
                    break
                sched.step_once()
            assert req.done
            assert srv.drain(timeout=10.0) is True
            assert srv.registry.get("serving_drain_total").value(
                result="ok") == 1
        finally:
            srv.stop(drain=False)


# ----------------------------------------------------------------------
# replica loss at the engine level
# ----------------------------------------------------------------------

@pytest.mark.chaos
class TestReplicaLossEngine:
    def test_error_retire_preserves_partial_output_and_retryability(
            self, ckpts):
        reg = MetricsRegistry()
        eng = PagedDecodeEngine(_net(ckpts), registry=reg, **DECODE_CFG)
        sched = DecodeScheduler(eng, clock=ManualClock(), registry=reg,
                                start_thread=False)
        r1 = sched.submit([1, 2, 3], max_new_tokens=12)
        r2 = sched.submit([4, 5], max_new_tokens=12)
        for _ in range(200):
            if len(r1.tokens) >= 2 and len(r2.tokens) >= 2:
                break
            sched.step_once()
        assert len(r1.tokens) >= 2 and len(r2.tokens) >= 2
        partial = (list(r1.tokens), list(r2.tokens))
        plan = faults.FaultPlan().fail("serving.decode_step", times=1)
        with plan.active():
            sched.step_once()
        for r, before in zip((r1, r2), partial):
            assert r.done and r.finish_reason == "error"
            assert r.retryable is True
            assert r.tokens[:len(before)] == before
            assert "InjectedFault" in r.error
        assert reg.get("decode_retired_total").value(reason="error") == 2
        r3 = sched.submit([6, 7, 8], max_new_tokens=4)
        for _ in range(200):
            if r3.done:
                break
            sched.step_once()
        assert r3.finish_reason == "max_tokens" and len(r3.tokens) == 4
        assert r3.retryable is False

    def test_http_surface_of_error_retire(self, ckpts):
        reg = MetricsRegistry()
        net = _net(ckpts)
        eng = PagedDecodeEngine(net, registry=reg, **DECODE_CFG)
        eng.warmup()
        sched = DecodeScheduler(eng, registry=reg)
        srv = InferenceServer(net, port=0, decode=sched, registry=reg,
                              device="cpu")
        try:
            plan = faults.FaultPlan().fail("serving.decode_step", times=1,
                                           after=2)
            with plan.active():
                code, body, _ = _post(srv.port, "/generate",
                                      {"prompt_ids": [1, 2, 3],
                                       "max_new_tokens": 8})
            assert code == 500
            assert body["retryable"] is True
            assert "tokens" in body and "n_generated" in body
        finally:
            srv.stop(drain=False)


# ----------------------------------------------------------------------
# router unit: routing policy + shed plane
# ----------------------------------------------------------------------

class TestRoutingPolicy:
    def _doc(self, free_pages, queue=0, active=0, ready=True,
             status="live", addr="127.0.0.1:1", pages_per_seq=4):
        return {"status": status, "ready": ready, "addr": addr,
                "capacity": {"free_pages": free_pages,
                             "queue_depth": queue, "active": active,
                             "pages_per_seq": pages_per_seq}}

    def test_pick_is_decode_aware_never_round_robin(self):
        store = InMemoryCoordinationStore()
        router = FleetRouter(store, lease_s=30.0, view_refresh_s=0.0)
        pub = LeaseMembership(store, observer="t", lease_s=30.0)
        try:
            pub.publish("a", self._doc(4))
            pub.publish("b", self._doc(12))
            pub.publish("c", self._doc(12, queue=3))
            for _ in range(5):
                assert router._pick()[0] == "b"
            router._track("b", +1)
            router._track("b", +1)
            assert router._pick()[0] == "c"
            router._cordoned.add("c")
            assert router._pick()[0] == "a"
            router._cordoned.discard("c")
            router._track("b", -1)
            router._track("b", -1)
            pub.publish("b", self._doc(12, ready=False))
            assert router._pick()[0] == "c"
            router._cordoned.add("c")
            assert router._pick()[0] == "a"
            router._cordoned.discard("c")
            assert router._pick(exclude=("a", "c"))[0] is None
        finally:
            router.stop()

    def test_no_replica_sheds_on_serving_plane_with_retry_after(self):
        store = InMemoryCoordinationStore()
        router = FleetRouter(store, lease_s=1.0, shed_grace_s=0.0)
        try:
            for path in ("/generate", "/predict"):
                code, body, headers = _post(router.port, path,
                                            {"prompt_ids": [1, 2]})
                assert code == 503
                assert body["retryable"] is True
                assert "Retry-After" in headers
            assert router.registry.get("serving_shed_total").value(
                reason="no_replica") == 2
            assert router.registry.get("fleet_requests_total").value(
                outcome="shed") == 2
        finally:
            router.stop()

    def test_shed_grace_bridges_late_registration(self):
        store = InMemoryCoordinationStore()
        router = FleetRouter(store, lease_s=1.0, shed_grace_s=1.5,
                             retry_budget=0)
        pub = LeaseMembership(store, observer="late", lease_s=1.0)

        def publish_late():
            time.sleep(0.3)
            pub.publish("g1", self._doc(8, addr=_dead_addr()))

        th = threading.Thread(target=publish_late)
        th.start()
        try:
            code, body, _ = _post(router.port, "/generate",
                                  {"prompt_ids": [1],
                                   "idempotency_key": "late-1"})
            assert code == 503
            trail = router._audit["late-1"]["attempts"]
            assert [a["replica"] for a in trail] == ["g1"]
            assert router.registry.get("fleet_requests_total").value(
                outcome="shed") == 0
        finally:
            th.join(timeout=10)
            router.stop()


# ----------------------------------------------------------------------
# router integration: 2 port replicas, full HTTP path
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet2(ckpts):
    """Two warmed port replicas registered behind a port router."""
    store = InMemoryCoordinationStore()
    servers, agents = [], []
    for i in range(2):
        srv = InferenceServer(_net(ckpts), port=0, device="cpu",
                              decode=dict(DECODE_CFG),
                              tracer=Tracer(host=f"r{i}"))
        agents.append(ReplicaAgent(srv, store, replica=f"r{i}",
                                   lease_s=1.5).start())
        servers.append(srv)
    router = FleetRouter(store, lease_s=1.5, retry_budget=2,
                         request_timeout_s=30.0, attempt_timeout_s=10.0,
                         shed_grace_s=8.0, tracer=Tracer(host="router"))
    wait_until(lambda: router._health()["ready"] == 2, timeout=30,
               msg="2 ready replicas")
    yield {"store": store, "servers": servers, "agents": agents,
           "router": router}
    router.stop()
    for a in agents:
        a.stop(deregister=False)
    for s in servers:
        s.stop(drain=False)


class TestFleetIntegration:
    def test_routes_with_attribution_and_traceparent_propagation(
            self, fleet2, ref_net):
        router = fleet2["router"]
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        code, body, _ = _post(router.port, "/generate",
                              {"prompt_ids": [1, 2, 3, 4],
                               "max_new_tokens": 4},
                              headers={"traceparent": tp})
        assert code == 200
        assert body["tokens"] == _ref_greedy(ref_net, [1, 2, 3, 4], 4)
        assert body["replica"] in ("r0", "r1")
        assert body["attempts"] == 1
        assert body["idempotency_key"]
        roots = [s for s in router.tracer.find("fleet.request")
                 if s.trace_id == "ab" * 16]
        assert len(roots) == 1
        calls = [s for s in router.tracer.find("fleet.replica_call")
                 if s.trace_id == "ab" * 16]
        assert calls and calls[0].attributes["replica"] == body["replica"]
        srv = fleet2["servers"][int(body["replica"][1])]
        assert any(s.trace_id == "ab" * 16
                   for s in srv.tracer.find("decode.request"))
        code, tl = _get(router.port,
                        "/debug/timeline?trace_id=" + "ab" * 16)
        assert code == 200 and len(tl["requests"]) == 1

    def test_predict_is_routed(self, fleet2, ckpts):
        router = fleet2["router"]
        x = np.random.default_rng(3).integers(0, harness.SERVE_VOCAB,
                                              (2, 8)).astype(np.int32)
        code, body, _ = _post(router.port, "/predict",
                              {"inputs": x.tolist()})
        assert code == 200 and body["replica"] in ("r0", "r1")
        want = _net(ckpts).output(x).numpy()
        assert np.allclose(np.asarray(body["outputs"]), want, atol=1e-5)

    def test_idempotency_key_dedupes_concurrent_submissions(self, fleet2):
        router = fleet2["router"]
        payload = {"prompt_ids": [5, 6, 7], "max_new_tokens": 5,
                   "idempotency_key": "dedupe-1"}
        results = [None, None]

        def call(i):
            results[i] = _post(router.port, "/generate", dict(payload))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        (c0, b0, h0), (c1, b1, h1) = results
        assert c0 == 200 and c1 == 200
        assert b0["tokens"] == b1["tokens"]
        replays = [h for h in (h0, h1)
                   if h.get("x-idempotent-replay") == "true"]
        assert len(replays) == 1
        assert router.registry.get("fleet_requests_total").value(
            outcome="deduplicated") == 1
        code, audit = _get(router.port, "/debug/audit")
        trail = audit["audit"]["dedupe-1"]
        assert len(trail["attempts"]) == 1 and trail["code"] == 200

    def test_failover_replays_on_survivor(self, fleet2, ref_net):
        router = fleet2["router"]
        store = fleet2["store"]
        ghost = LeaseMembership(store, observer="ghost", lease_s=1.5)
        ghost.publish("zz-ghost", {
            "status": "live", "ready": True, "addr": _dead_addr(),
            "incarnation": 1,
            "capacity": {"free_pages": 10 ** 6, "queue_depth": 0,
                         "active": 0, "pages_per_seq": 4}})
        router.view(force=True)
        n_flight = len(_flight.events("fleet_failover"))
        code, body, _ = _post(router.port, "/generate",
                              {"prompt_ids": [2, 3], "max_new_tokens": 3,
                               "idempotency_key": "failover-1"})
        assert code == 200
        assert body["attempts"] == 2
        assert body["replica"] in ("r0", "r1")
        assert body["tokens"] == _ref_greedy(ref_net, [2, 3], 3)
        assert router.registry.get("fleet_failovers_total").value(
            reason="transport") >= 1
        code, audit = _get(router.port, "/debug/audit")
        trail = audit["audit"]["failover-1"]["attempts"]
        assert [a["replica"] for a in trail] == ["zz-ghost",
                                                 body["replica"]]
        assert trail[0]["code"] is None
        spans = router.tracer.find("fleet.failover")
        assert any(s.attributes["from_replica"] == "zz-ghost"
                   and s.attributes["to_replica"] == body["replica"]
                   for s in spans)
        evs = _flight.events("fleet_failover")
        assert len(evs) == n_flight + 1
        assert evs[-1]["from_replica"] == "zz-ghost"
        time.sleep(1.6)
        assert not router.view(force=True)["zz-ghost"]["alive"]
        assert router.registry.get("membership_transitions_total").value(
            event="evict", host="zz-ghost") == 1

    def test_rolling_set_model_zero_shed_under_load(self, fleet2, ckpts):
        router = fleet2["router"]
        digest_before = _get(fleet2["servers"][0].port,
                             "/healthz")[1]["model_digest"]
        shed = router.registry.get("serving_shed_total")
        shed_before = shed.value(reason="no_replica")
        stop = threading.Event()
        codes, bad = [], []

        def load():
            i = 0
            while not stop.is_set():
                i += 1
                c, b, _ = _post(router.port, "/generate",
                                {"prompt_ids": [1, 2], "max_new_tokens": 2,
                                 "idempotency_key": f"roll-{i}"},
                                timeout=30)
                codes.append(c)
                if c != 200:
                    bad.append((i, c, b))
                time.sleep(0.05)

        loader = threading.Thread(target=load)
        loader.start()
        try:
            results = rolling_set_model(router, ckpts[11],
                                        drain_timeout_s=30,
                                        ready_timeout_s=120)
        finally:
            stop.set()
            loader.join(timeout=60)
        assert [r["replica"] for r in results] == ["r0", "r1"]
        assert all(r["ok"] for r in results)
        digests = set()
        for srv in fleet2["servers"]:
            h = _get(srv.port, "/healthz")[1]
            assert h["model_generation"] == 1
            digests.add(h["model_digest"])
        assert len(digests) == 1 and digest_before not in digests
        assert codes and all(c == 200 for c in codes), bad
        assert shed.value(reason="no_replica") == shed_before
        ev = _flight.events("fleet_rolling_deploy")[-1]
        assert ev["replica"] == "r1" and ev["generation"] == 1
        # the fleet now serves the new weights
        code, body, _ = _post(router.port, "/generate",
                              {"prompt_ids": [7, 1], "max_new_tokens": 4})
        assert body["tokens"] == _ref_greedy(j_load_model(ckpts[11]),
                                             [7, 1], 4)


# ----------------------------------------------------------------------
# mixed fleets: one FileCoordinationStore, routers and replicas of both
# packages
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed(ckpts, ref_net, tmp_path_factory):
    """Two port replicas and one reference replica registered in one
    FileCoordinationStore directory, with a port router and a reference
    router over it."""
    store_dir = str(tmp_path_factory.mktemp("mixed_store"))
    store = FileCoordinationStore(store_dir)
    jstore = j_elastic.FileCoordinationStore(store_dir)
    servers, agents = [], []
    for i in range(2):
        srv = InferenceServer(_net(ckpts), port=0, device="cpu",
                              decode=dict(DECODE_CFG))
        agents.append(ReplicaAgent(srv, store, replica=f"port{i}",
                                   lease_s=2.0).start())
        servers.append(srv)
    jsrv = JInferenceServer(ref_net, port=0, decode=dict(DECODE_CFG))
    agents.append(JReplicaAgent(jsrv, jstore, replica="ref0",
                                lease_s=2.0).start())
    servers.append(jsrv)
    routers = {"port": FleetRouter(store, lease_s=2.0, shed_grace_s=8.0),
               "ref": JFleetRouter(jstore, lease_s=2.0, shed_grace_s=8.0)}
    for r in routers.values():
        wait_until(lambda r=r: r._health()["ready"] == 3, timeout=60,
                   msg="3 ready replicas")
    yield routers
    for r in routers.values():
        r.stop()
    for a in agents:
        a.stop(deregister=False)
    for s in servers:
        s.stop(drain=False)


class TestMixedFleet:
    PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9])

    @pytest.mark.parametrize("router_pkg,replicas", [
        ("ref", ("port0", "port1")),     # a reference router, port replicas
        ("port", ("ref0",)),             # a port router, a reference replica
        ("port", ("port0", "port1", "ref0")),
        ("ref", ("port0", "port1", "ref0")),
    ])
    def test_greedy_tokens_equal_the_references(self, mixed, ref_net,
                                                router_pkg, replicas):
        router = mixed[router_pkg]
        others = {"port0", "port1", "ref0"} - set(replicas)
        router._cordoned.update(others)
        try:
            seen = set()
            for i, prompt in enumerate(self.PROMPTS * 2):
                code, body, _ = _post(router.port, "/generate",
                                      {"prompt_ids": prompt,
                                       "max_new_tokens": 5})
                assert code == 200, body
                assert body["replica"] in replicas
                assert body["tokens"] == _ref_greedy(ref_net, prompt, 5)
                seen.add(body["replica"])
            if len(replicas) == 1:
                assert seen == set(replicas)
        finally:
            router._cordoned.difference_update(others)
