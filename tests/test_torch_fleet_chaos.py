"""N-process serving-fleet kill test with port replicas (the counterpart
of ``tests/test_fleet_chaos.py::TestServingFleetKill``): SIGTERM one
replica and wedge another in the middle of a decode under load, and
prove the router replays every accepted-but-unfinished request on the
survivor within its SLO — zero dropped, zero double-served — with the
failover hop named in the timeline and the membership transitions on
record.

Three replica PROCESSES join a FileCoordinationStore; each is a fresh
interpreter running this file (``python tests/test_torch_fleet_chaos.py
'<config json>'``, the ``__main__`` block at the bottom), never a fork,
and imports only PyTorch and the port. The router runs in the test
process and drives real HTTP traffic. r0 is SIGTERMed on its 6th
decode-phase dispatch, r1 wedges (sleeping inside the dispatch, the
dispatch lock held) on its 10th; because the heartbeat is attested
through the decode step boundary, the wedge stops the lease. r2
survives and absorbs the replays. Completed requests' tokens must equal
the JAX package's greedy decode of the same weights.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytestmark = [pytest.mark.chaos]

N_REQUESTS = 24
MAX_NEW = 6
SLO_S = 25.0
RUN_S = 90.0
# A replica's heartbeat publishes only through a decode step boundary
# (a bounded try of its step lock), so a healthy replica slowed down by a
# loaded machine (the suite runs beside other test processes) must not
# look wedged: 3 s leases, where the reference's test uses 1 s.
LEASE_S = 3.0
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def wait_until(fn, timeout, every=0.1, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(every)
    assert fn(), f"timed out waiting for {msg}"


def _post(port, path, payload):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=SLO_S + 10) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _configs(n, store_dir, base_dir, ckpt, kill_plans):
    out = []
    for i in range(n):
        host = f"r{i}"
        cfg = {"host": host, "store_dir": store_dir, "ckpt": ckpt,
               "dir": os.path.join(base_dir, host), "lease_s": LEASE_S,
               "request_timeout_s": SLO_S, "run_s": RUN_S}
        cfg.update(kill_plans.get(i, {}))
        out.append(cfg)
    return out


def _run_fleet(configs, timeout):
    """Spawn one fresh interpreter per replica and wait for them: hang
    replicas never exit on their own and are killed once every other one
    has (the cluster reclaiming a wedged machine). {host: {"rc", "stderr",
    "result"}}."""
    env = dict(os.environ, PYTHONPATH=REPO + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    procs = {c["host"]: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), json.dumps(c)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for c in configs}
    hang = {c["host"] for c in configs if c.get("kill_mode") == "hang"}
    out = {h: {"rc": None, "stderr": ""} for h in procs}
    deadline = time.monotonic() + timeout
    try:
        while True:
            for h, p in procs.items():
                if out[h]["rc"] is None and p.poll() is not None:
                    out[h]["rc"] = p.returncode
                    out[h]["stderr"] = p.communicate()[1] or ""
            pending = [h for h, p in procs.items() if p.poll() is None]
            if not pending:
                break
            if set(pending) <= hang:
                for h in pending:
                    procs[h].kill()
                    out[h]["stderr"] = procs[h].communicate()[1] or ""
                    out[h]["rc"] = "killed_hung"
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"replicas still running: {pending}")
            time.sleep(0.1)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for c in configs:
        path = os.path.join(c["dir"], f"result_{c['host']}.json")
        out[c["host"]]["result"] = (json.load(open(path))
                                    if os.path.exists(path) else None)
    return out


class TestServingFleetKill:
    def test_failover_replays_on_survivor_no_drop_no_double_serve(
            self, tmp_path):
        import _kill_harness as harness
        from deeplearning4j_tpu.models.transformer import generate
        from deeplearning4j_tpu.util.serialization import save_model

        from deeplearning4j_tpu_torch.parallel.elastic import \
            FileCoordinationStore
        from deeplearning4j_tpu_torch.serving import FleetRouter
        from deeplearning4j_tpu_torch.util.tracing import Tracer

        t_start = time.monotonic()
        ckpt = str(tmp_path / "lm.zip")
        ref_net = harness.build_lm_net(7)
        save_model(ref_net, ckpt)
        store_dir = str(tmp_path / "store")
        configs = _configs(
            3, store_dir, str(tmp_path / "replicas"), ckpt,
            {0: {"kill_mode": "sigterm", "kill_at_dispatch": 6},
             1: {"kill_mode": "hang", "kill_at_dispatch": 10}})
        store = FileCoordinationStore(store_dir)
        router = FleetRouter(store, lease_s=LEASE_S, retry_budget=3,
                             request_timeout_s=SLO_S,
                             attempt_timeout_s=3.0,
                             shed_grace_s=LEASE_S + 3.0,
                             tracer=Tracer(host="router"))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, harness.SERVE_VOCAB,
                                4 + i % 4).tolist()
                   for i in range(N_REQUESTS)]
        want = [[int(t) for t in generate(ref_net, np.asarray(p), MAX_NEW)]
                for p in prompts]

        fleet_out = {}

        def run():
            fleet_out.update(_run_fleet(configs, timeout=RUN_S + 30))

        fleet_thread = threading.Thread(target=run)
        fleet_thread.start()
        results = {}
        try:
            wait_until(lambda: router._health()["ready"] == 3,
                       timeout=60, msg="3 ready replicas")

            def call(i):
                t0 = time.monotonic()
                code, body, _ = _post(
                    router.port, "/generate",
                    {"prompt_ids": prompts[i], "max_new_tokens": MAX_NEW,
                     "timeout_s": SLO_S, "idempotency_key": f"req-{i}"})
                results[i] = {"code": code, "body": body,
                              "latency": time.monotonic() - t0}

            threads = []
            for i in range(N_REQUESTS):
                t = threading.Thread(target=call, args=(i,))
                t.start()
                threads.append(t)
                time.sleep(float(rng.exponential(0.08)))
            for t in threads:
                t.join(timeout=SLO_S + 10)
            assert len(results) == N_REQUESTS
            time.sleep(LEASE_S + 1.5)    # the victims' leases lapse
            view = router.view(force=True)
        finally:
            store.put("ctl/stop", b"1", overwrite=True)
            fleet_thread.join(timeout=RUN_S + 60)
            router.stop()

        # zero dropped: every accepted request answered 200 within its
        # SLO, with the reference's greedy tokens
        for i, r in sorted(results.items()):
            assert r["code"] == 200, (i, r)
            assert r["body"]["tokens"] == want[i], (i, r)
            assert r["latency"] < SLO_S, (i, r["latency"])

        replayed = {i: r for i, r in results.items()
                    if r["body"]["attempts"] >= 2}
        assert replayed, "kill landed mid-decode but nothing replayed"
        for i, r in replayed.items():
            assert r["body"]["replica"] != "r0", (i, r)
        assert router.registry.get("fleet_failovers_total").total() >= 1

        # zero double-serve: one final answer per idempotency key
        audit = router._audit
        for i in range(N_REQUESTS):
            trail = audit[f"req-{i}"]
            assert trail["code"] == 200
            finals = [a for a in trail["attempts"] if a["code"] == 200]
            assert len(finals) == 1, (i, trail)
            for a in trail["attempts"][:-1]:
                assert a["code"] != 200, (i, trail)

        fspans = router.tracer.find("fleet.failover")
        assert any(s.attributes["from_replica"] in ("r0", "r1")
                   for s in fspans)
        by_trace = {}
        for s in router.tracer.find("fleet.replica_call"):
            by_trace.setdefault(s.trace_id, []).append(s)
        assert any(len(v) >= 2 for v in by_trace.values())

        trans = router.registry.get("membership_transitions_total")
        for h in ("r0", "r1", "r2"):
            assert trans.value(event="join", host=h) >= 1, h
        assert trans.value(event="evict", host="r0") >= 1
        assert trans.value(event="evict", host="r1") >= 1
        assert not view["r0"]["alive"]
        assert not view["r1"]["alive"]
        assert view["r2"]["alive"] and not view["r2"]["done"]

        assert fleet_out["r0"]["rc"] == -signal.SIGTERM, fleet_out["r0"]
        assert fleet_out["r1"]["rc"] in ("killed_hung", 0, -9), \
            fleet_out["r1"]
        assert fleet_out["r2"]["rc"] == 0, fleet_out["r2"]["stderr"][-2000:]
        r2 = fleet_out["r2"]["result"]
        assert r2 is not None
        assert r2["responses"].get("200", 0) > 0
        assert r2["drain_ok"] >= 1
        assert r2["heartbeats_published"] > 0
        assert r2["jax_modules"] == []       # a PyTorch-only interpreter
        # well inside the reference's 150 s budget for the same scenario
        assert time.monotonic() - t_start < 100


def _child_main(config: dict) -> None:
    """One replica: a port InferenceServer warming in the background,
    registered by a ReplicaAgent, with an optional kill plan on the
    decode-step seam; serves until the parent publishes ``ctl/stop``,
    then drains and writes ``result_<host>.json``."""
    from deeplearning4j_tpu_torch.parallel.elastic import \
        FileCoordinationStore
    from deeplearning4j_tpu_torch.serving import InferenceServer, ReplicaAgent
    from deeplearning4j_tpu_torch.util import faults
    from deeplearning4j_tpu_torch.util import metrics as _metrics
    from deeplearning4j_tpu_torch.util import tracing as _tracing
    from deeplearning4j_tpu_torch.util.serialization import load_model

    directory = config["dir"]
    os.makedirs(directory, exist_ok=True)
    os.environ["DL4JTPU_FLIGHT_DIR"] = directory
    replica = config["host"]
    store = FileCoordinationStore(config["store_dir"])
    registry = _metrics.REGISTRY
    tracer = _tracing.Tracer(host=replica, registry=registry)
    server = InferenceServer(
        load_model(config["ckpt"], device="cpu"), device="cpu",
        tracer=tracer, registry=registry,
        decode={"max_batch": 2, "page_size": 8, "pages_per_seq": 4,
                "prefill_chunk": 8,
                "request_timeout_s": config["request_timeout_s"]},
        warmup_background=True)
    agent = ReplicaAgent(server, store, replica=replica,
                         lease_s=config["lease_s"],
                         registry=registry).start()

    plan = faults.FaultPlan()
    kill_mode, kill_at = config.get("kill_mode"), config.get(
        "kill_at_dispatch")
    if kill_mode:
        state = {"n": 0}

        def kill(payload):
            if payload.get("phase") == "prefill":
                return
            state["n"] += 1
            if state["n"] == kill_at:
                if kill_mode == "hang":
                    # wedged inside the dispatch with its lock held: the
                    # heartbeat probe fails and the lease lapses
                    time.sleep(600)
                    return
                os.kill(os.getpid(), signal.SIGTERM)
        plan.always("serving.decode_step", exc=kill)

    deadline = time.monotonic() + config["run_s"]
    with plan.active():
        while time.monotonic() < deadline:
            if store.get("ctl/stop") is not None:
                break
            time.sleep(0.1)
        agent.stop(deregister=True)
        server.stop(drain=True, timeout=10.0)

    responses = {s["labels"]["code"]: s["value"] for s in registry.get(
        "serving_responses_total").snapshot()["series"]}

    def _ctr(name, **labels):
        m = registry.get(name)
        return m.value(**labels) if m is not None else 0.0

    result = {"host": replica, "responses": responses,
              "heartbeats_published": _ctr("fleet_heartbeats_total",
                                           result="published"),
              "drain_ok": _ctr("serving_drain_total", result="ok"),
              "drain_timeout": _ctr("serving_drain_total",
                                    result="timeout"),
              "jax_modules": sorted(m for m in sys.modules
                                    if m == "jax" or m.startswith("jax."))}
    with open(os.path.join(directory, f"result_{replica}.json"), "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    _child_main(json.loads(sys.argv[1]))
