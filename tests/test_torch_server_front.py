"""The rest of the port's HTTP front on the CPU: ``POST /model`` (the
scenario of ``tests/test_serving.py::test_hot_model_swap`` on the
transformer, and the 409 while a decode runs), ``POST /profile`` with its
concurrent 409, ``GET /debug/flightrecorder``, ``GET /debug/timeline``
(the cases of ``tests/test_decode.py::TestRequestTimelines`` through
HTTP), ``GET /debug/health``, and the fleet replica's background warm-up
(``warmup_background=True``: ready=false while warming, then true).

Weights come from the reference: the kill harness's serving LM
(``transformer_lm(32, n_layers=1, d_model=32, n_heads=2, d_ff=64,
max_cache_t=32)``) initialised by the JAX package, saved, and loaded by
the port on the CPU. ``/predict`` outputs are held within 1e-5 of the
net's own ``output`` (the same code on another batch).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import _kill_harness as harness
from deeplearning4j_tpu.util.serialization import save_model as j_save_model

from deeplearning4j_tpu_torch.models.transformer import generate
from deeplearning4j_tpu_torch.serving import InferenceServer
from deeplearning4j_tpu_torch.serving.decode import (DecodeScheduler,
                                                     PagedDecodeEngine)
from deeplearning4j_tpu_torch.util import flightrecorder as _flight
from deeplearning4j_tpu_torch.util import health as t_health
from deeplearning4j_tpu_torch.util import profiling
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.util.resilience import ManualClock
from deeplearning4j_tpu_torch.util.serialization import load_model
from deeplearning4j_tpu_torch.util.tracing import Tracer

DECODE_CFG = {"max_batch": 2, "page_size": 8, "pages_per_seq": 4,
              "prefill_chunk": 8}
TP = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"


def _request(port, path, payload=None, headers=None, timeout=60):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method="GET" if payload is None and not path.startswith(
            ("/profile", "/model")) else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("front")
    paths = {}
    for seed in (5, 11):
        paths[seed] = str(d / f"lm{seed}.zip")
        j_save_model(harness.build_lm_net(seed), paths[seed])
    return paths


def _ids(seed, b=2, t=8):
    return np.random.default_rng(seed).integers(
        0, harness.SERVE_VOCAB, (b, t)).astype(np.int32)


class TestModelEndpoint:
    def test_hot_model_swap(self, ckpts):
        net1 = load_model(ckpts[5], device="cpu")
        server = InferenceServer(net1, port=0, device="cpu")
        try:
            x = _ids(0)
            code, before, _ = _request(server.port, "/predict",
                                       {"inputs": x.tolist()})
            assert code == 200
            digest = server.model_digest
            code, body, _ = _request(server.port, "/model",
                                     {"path": ckpts[11]})
            assert code == 200 and body == {"ok": True}
            code, after, _ = _request(server.port, "/predict",
                                      {"inputs": x.tolist()})
            want = load_model(ckpts[11], device="cpu").output(x).numpy()
            assert np.allclose(np.asarray(after["outputs"]), want,
                               atol=1e-5)
            assert not np.allclose(np.asarray(before["outputs"]),
                                   np.asarray(after["outputs"]))
            h = _request(server.port, "/healthz")[1]
            assert h["model_generation"] == 1 and h["ready"]
            assert h["model_digest"] != digest
            # loaded onto the server's own device
            assert server._model.device.type == "cpu"
        finally:
            server.stop()

    def test_bad_path_is_400(self, ckpts, tmp_path):
        server = InferenceServer(load_model(ckpts[5], device="cpu"), port=0,
                                 device="cpu")
        try:
            code, body, _ = _request(server.port, "/model",
                                     {"path": str(tmp_path / "none.zip")})
            assert code == 400 and body["error"]
            assert _request(server.port, "/model", {})[0] == 400
            assert server.model_generation == 0
        finally:
            server.stop()

    def test_refused_with_retry_after_while_a_decode_runs(self, ckpts):
        net = load_model(ckpts[5], device="cpu")
        reg = MetricsRegistry()
        eng = PagedDecodeEngine(net, registry=reg, **DECODE_CFG)
        sched = DecodeScheduler(eng, clock=ManualClock(), registry=reg,
                                start_thread=False)
        server = InferenceServer(net, port=0, decode=sched, device="cpu")
        try:
            req = sched.submit([1, 2, 3], max_new_tokens=6)
            sched.step_once()                  # admitted: in flight
            assert not req.done
            code, body, headers = _request(server.port, "/model",
                                           {"path": ckpts[11]})
            assert code == 409 and headers["Retry-After"] == "1"
            assert "in flight" in body["error"]
            assert server.model_generation == 0 and server.ready
            for _ in range(100):
                if req.done:
                    break
                sched.step_once()
            assert req.done
            code, _, _ = _request(server.port, "/model",
                                  {"path": ckpts[11]})
            assert code == 200 and server.model_generation == 1
            # the engine serves the new weights
            new = load_model(ckpts[11], device="cpu")
            r2 = sched.submit([4, 5, 6], max_new_tokens=5)
            for _ in range(100):
                if r2.done:
                    break
                sched.step_once()
            assert r2.tokens == generate(new, np.array([4, 5, 6]),
                                         5).tolist()
        finally:
            server.stop(drain=False)


class TestProfileEndpoint:
    def test_profile_and_concurrent_409(self, ckpts, tmp_path):
        server = InferenceServer(load_model(ckpts[5], device="cpu"),
                                 port=0, device="cpu")
        out = {}

        def first():
            out["r"] = _request(server.port,
                                f"/profile?seconds=0.8&dir={tmp_path}")

        try:
            # traffic before the capture: a thread's first operators ever
            # are not recorded by a capture already running (PyTorch sets
            # up a thread's profiler state at its first operator)
            assert _request(server.port, "/predict",
                            {"inputs": _ids(1).tolist()})[0] == 200
            th = threading.Thread(target=first)
            th.start()
            deadline = time.monotonic() + 10
            while not profiling.capture_in_progress():
                assert time.monotonic() < deadline
                time.sleep(0.005)
            # traffic during the capture, and a second capture refused
            code, _, _ = _request(server.port, "/predict",
                                  {"inputs": _ids(1).tolist()})
            assert code == 200
            code, body, _ = _request(server.port, "/profile?seconds=0.1")
            assert code == 409 and "in progress" in body["error"]
            th.join(timeout=30)
            code, body, _ = out["r"]
            assert code == 200 and body["ok"] and body["seconds"] == 0.8
            assert sorted(os.listdir(body["dir"])) == ["summary.json",
                                                       "trace.json"]
            names = [e["name"] for e in json.load(
                open(os.path.join(body["dir"], "summary.json")))["events"]]
            assert any(n.startswith("aten::") for n in names)
            assert _request(server.port, "/profile?seconds=400")[0] == 400
        finally:
            server.stop()


class TestDebugEndpoints:
    def test_flightrecorder(self, ckpts):
        server = InferenceServer(load_model(ckpts[5], device="cpu"),
                                 port=0, device="cpu")
        try:
            _flight.record("front_test", marker=12345, odd=object())
            code, body, _ = _request(server.port, "/debug/flightrecorder")
            assert code == 200
            ev = [e for e in body["events"] if e.get("kind") == "front_test"]
            assert ev and ev[-1]["marker"] == 12345
        finally:
            server.stop()

    def test_health(self, ckpts):
        t_health.reset_debug_state()
        server = InferenceServer(load_model(ckpts[5], device="cpu"),
                                 port=0, device="cpu")
        try:
            code, body, _ = _request(server.port, "/debug/health")
            assert code == 200
            assert body["report"] is None and body["attribution"] is None
            net = load_model(ckpts[5], device="cpu")
            listener = t_health.HealthListener(frequency=1, model="front",
                                               registry=MetricsRegistry())
            net.set_listeners(listener)
            net.enable_health_stats()
            x = _ids(2, t=9)
            net.fit_batch(x[:, :-1], x[:, 1:])
            params = {v: {k: t.detach().clone() for k, t in ps.items()}
                      for v, ps in net.params.items()}
            params["blk0_ff2"]["W"][1, 1] = float("nan")
            t_health.attribute_nonfinite(net, x[:, :-1], x[:, 1:],
                                         params=params, iteration=1)
            code, body, _ = _request(server.port, "/debug/health")
            assert body["report"]["model"] == "front"
            assert body["report"]["iteration"] == 1
            assert body["stats"]["blk0_ff1"]["param_norm"] > 0
            assert body["attribution"]["layer"] == "blk0_ff2"
            assert body["attribution"]["quantity"] == "param"
        finally:
            server.stop()


class TestRequestTimelinesHTTP:
    """``tests/test_decode.py::TestRequestTimelines`` through ``GET
    /debug/timeline``: a threaded server with a tracer on the real
    clock."""

    @pytest.fixture(scope="class")
    def traced(self, ckpts):
        tracer = Tracer(host="front")
        server = InferenceServer(load_model(ckpts[5], device="cpu"),
                                 port=0, device="cpu", tracer=tracer,
                                 decode=dict(DECODE_CFG))
        results = [None, None]

        def call(i, payload, headers):
            results[i] = _request(server.port, "/generate", payload,
                                  headers)

        threads = [threading.Thread(target=call, args=(
                       0, {"prompt_ids": [3, 1, 4, 1, 5],
                           "max_new_tokens": 6}, {"traceparent": TP})),
                   threading.Thread(target=call, args=(
                       1, {"prompt_ids": [2, 7, 1], "max_new_tokens": 4},
                       None))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        yield server, results
        server.stop(drain=False)

    def test_breakdown_sums_to_measured_ttft(self, traced):
        server, results = traced
        assert all(r[0] == 200 for r in results)
        code, body, _ = _request(server.port, "/debug/timeline")
        assert code == 200 and len(body["requests"]) == 2
        for t in body["requests"]:
            a = t["attributes"]
            bd = a["ttft_breakdown_ms"]
            assert set(bd) == {"queue_wait", "prefill", "compile",
                               "dispatch"}
            assert all(v >= 0 for v in bd.values())
            assert abs(sum(bd.values()) - a["ttft_ms"]) <= \
                max(0.05 * a["ttft_ms"], 0.01)
            assert bd["prefill"] > 0

    def test_span_tree_and_remote_parenting(self, traced):
        server, results = traced
        code, body, _ = _request(server.port,
                                 "/debug/timeline?trace_id=" + "ab" * 16)
        assert len(body["requests"]) == 1
        remote = body["requests"][0]
        assert remote["spans"]["parent_id"] == "cd" * 8
        assert results[0][2]["traceparent"].split("-")[1] == "ab" * 16
        code, body, _ = _request(server.port, "/debug/timeline")
        for t in body["requests"]:
            root = t["spans"]
            assert root["name"] == "decode.request"
            kids = root["children"]
            assert kids[0]["name"] == "queue"
            blocks = [k for k in kids if k["name"] == "decode_block"]
            assert blocks
            for b in blocks:
                a = b["attributes"]
                assert a["kind"] == "ticked" and a["tokens"] == 1
                assert 0 <= a["lane"] < DECODE_CFG["max_batch"]
                assert a["bucket"] in (1, 2)
            assert sum(b["attributes"]["tokens"] for b in blocks) == \
                t["attributes"]["tokens"] - 1
        assert {tr["trace_id"] for tr in body["traces"]} >= {"ab" * 16}


class TestBackgroundWarmup:
    def test_ready_false_while_warming_then_true(self, ckpts, monkeypatch):
        release = threading.Event()
        warmup = PagedDecodeEngine.warmup

        def held(self):
            assert release.wait(timeout=60)
            warmup(self)

        monkeypatch.setattr(PagedDecodeEngine, "warmup", held)
        server = InferenceServer(load_model(ckpts[5], device="cpu"), port=0,
                                 device="cpu", decode=dict(DECODE_CFG),
                                 warmup_background=True)
        try:
            code, body, _ = _request(server.port, "/readyz")
            assert code == 503 and body["reasons"] == ["warming"]
            h = _request(server.port, "/healthz")[1]
            assert h["ready"] is False and h["live"] is True
            assert h["ready_reasons"] == ["warming"]
            release.set()
            deadline = time.monotonic() + 60
            while not server.ready:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert _request(server.port, "/readyz")[0] == 200
            code, body, _ = _request(server.port, "/generate",
                                     {"prompt_ids": [1, 2, 3],
                                      "max_new_tokens": 3})
            assert code == 200 and len(body["tokens"]) == 3
            builds = server.registry.get("jit_retraces_total")
            assert builds.total() > 0 and max(
                s["value"] for s in builds.snapshot()["series"]) == 1
        finally:
            release.set()
            server.stop(drain=False)

    def test_metrics_carry_the_device_memory_family(self, ckpts):
        server = InferenceServer(load_model(ckpts[5], device="cpu"),
                                 port=0, device="cpu")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/metrics",
                    timeout=10) as r:
                text = r.read().decode()
            assert "# TYPE device_memory_bytes gauge" in text
        finally:
            server.stop()
