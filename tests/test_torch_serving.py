"""The port's inference server: the scenarios of ``tests/test_serving.py``
against ``deeplearning4j_tpu_torch.serving.InferenceServer`` on the CPU.

The model is a small port transformer LM taking [b, t] token ids (the
server parses JSON inputs into float32; the embedding truncates them to
integer ids). The resilience scenarios (overload shedding, deadlines,
breaker, drain) use blocking stub models, ManualClock and FaultPlan —
deterministic, no sleep-based chaos.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer_lm
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.serving import InferenceServer

V, T = 16, 8


def _net(seed=1, dtype="float32"):
    conf = transformer_lm(V, n_layers=1, d_model=16, n_heads=2, d_ff=32,
                          input_ids=True, seed=seed, dtype=dtype)
    return ComputationGraph(conf, device="cpu").init()


def _ids(rng, batch):
    return rng.integers(0, V, (batch, T)).astype(np.int32)


def _server(model, **kw):
    return InferenceServer(model, port=0, device="cpu", **kw)


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get_error(base, path, payload):
    """POST expecting an HTTP error; returns (code, body, headers)."""
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _health(base):
    return json.loads(urllib.request.urlopen(base + "/healthz",
                                             timeout=5).read())


class TestInferenceServer:
    def test_predict_matches_direct_output(self, rng):
        net = _net()
        server = _server(net)
        base = f"http://127.0.0.1:{server.port}"
        try:
            x = _ids(rng, 4)
            out = _post(base, "/predict", {"inputs": x.tolist()})["outputs"]
            ref = net.output(x).numpy()
            assert np.allclose(np.asarray(out), ref, atol=1e-5)
            health = _health(base)
            assert health["ok"] and health["served"] == 4
            assert health["model"] == "ComputationGraph"
        finally:
            server.stop()

    def test_bf16_output_is_served_as_floats(self, rng):
        """mixed_bf16 outputs are bf16 tensors; the server converts them
        explicitly (numpy has no bfloat16)."""
        net = _net(dtype="mixed_bf16")
        server = _server(net)
        base = f"http://127.0.0.1:{server.port}"
        try:
            x = _ids(rng, 2)
            out = np.asarray(_post(base, "/predict",
                                   {"inputs": x.tolist()})["outputs"])
            ref = net.output(x)
            assert ref.dtype == torch.bfloat16
            assert np.array_equal(out.astype(np.float32),
                                  ref.float().numpy())
        finally:
            server.stop()

    def test_concurrent_requests_microbatched(self, rng):
        net = _net()
        server = _server(net, max_batch=32, batch_timeout_ms=20.0)
        base = f"http://127.0.0.1:{server.port}"
        xs = [_ids(rng, 2) for _ in range(8)]
        results = [None] * 8

        def call(i):
            results[i] = _post(base, "/predict",
                               {"inputs": xs[i].tolist()})["outputs"]
        try:
            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            for i in range(8):
                ref = net.output(xs[i]).numpy()
                assert np.allclose(np.asarray(results[i]), ref, atol=1e-5), i
            # fewer model calls than requests: the batcher coalesced
            assert server._m_batch_size.count() < 8
        finally:
            server.stop()

    def test_bad_request_does_not_kill_server(self):
        server = _server(_net())
        base = f"http://127.0.0.1:{server.port}"
        try:
            req = urllib.request.Request(base + "/predict", data=b"nope",
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=5)
            assert e.value.code == 400
            code, body, _ = _get_error(base, "/predict", {"nothing": 1})
            assert code == 400 and "bad inputs" in body["error"]
            assert _health(base)["ok"]
        finally:
            server.stop()

    def test_liveness_readiness_and_metrics(self, rng):
        server = _server(_net())
        base = f"http://127.0.0.1:{server.port}"
        try:
            assert json.loads(urllib.request.urlopen(
                base + "/livez", timeout=5).read()) == {"live": True}
            assert json.loads(urllib.request.urlopen(
                base + "/readyz", timeout=5).read())["ready"] is True
            _post(base, "/predict", {"inputs": _ids(rng, 1).tolist()})
            text = urllib.request.urlopen(base + "/metrics",
                                          timeout=5).read().decode()
            assert "serving_examples_served_total 1" in text
            assert 'serving_responses_total{code="200"}' in text
        finally:
            server.stop()

    def test_traced_predict_parents_its_spans(self, rng):
        from deeplearning4j_tpu_torch.util.tracing import Tracer
        tracer = Tracer()
        server = _server(_net(), tracer=tracer)
        base = f"http://127.0.0.1:{server.port}"
        try:
            req = urllib.request.Request(
                base + "/predict",
                data=json.dumps({"inputs": _ids(rng, 1).tolist()}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                tp = r.headers["traceparent"]
            (predict,) = tracer.find("predict")
            assert predict.trace_id in tp
            for name in ("queue", "batch", "model"):
                (span,) = tracer.find(name)
                assert span.trace_id == predict.trace_id
        finally:
            server.stop()

    def test_decode_is_not_yet_ported(self):
        from deeplearning4j_tpu_torch.nn.conf.layers import NotYetPorted
        with pytest.raises(NotYetPorted, match="decode"):
            _server(_net(), decode={"max_lanes": 2})


class _BlockingModel:
    """Stub model whose output() blocks on an Event — lets tests hold the
    batcher mid-batch deterministically (no sleeps)."""

    def __init__(self, width=3):
        self.width = width
        self.entered = threading.Event()
        self.release = threading.Event()

    def output(self, x):
        self.entered.set()
        assert self.release.wait(timeout=30)
        return np.zeros((x.shape[0], self.width), np.float32)


class _FailingModel:
    def output(self, x):
        raise RuntimeError("model exploded")


@pytest.mark.chaos
class TestServingResilience:
    def test_overload_returns_503_with_retry_after(self):
        model = _BlockingModel()
        server = _server(model, max_batch=1, batch_timeout_ms=1.0,
                         max_queue=2)
        base = f"http://127.0.0.1:{server.port}"
        results = {}

        def call(name):
            results[name] = _get_error(
                base, "/predict", {"inputs": [[0.0, 0.0, 0.0]]})

        try:
            ta = threading.Thread(target=call, args=("a",))
            ta.start()
            assert model.entered.wait(timeout=10)
            tb = threading.Thread(target=call, args=("b",))
            tc = threading.Thread(target=call, args=("c",))
            tb.start(), tc.start()
            waiter = threading.Event()
            for _ in range(200):
                if server._queue.qsize() >= 2:
                    break
                waiter.wait(0.01)
            assert server._queue.qsize() == 2
            code, body, headers = _get_error(
                base, "/predict", {"inputs": [[0.0, 0.0, 0.0]]})
            assert code == 503
            assert "overloaded" in body["error"]
            assert "Retry-After" in headers
            assert server.shed >= 1
            model.release.set()
            for t in (ta, tb, tc):
                t.join(timeout=30)
            for name in ("a", "b", "c"):
                assert results[name][0] == 200, results[name]
        finally:
            model.release.set()
            server.stop(drain=False)

    def test_healthz_reports_queue_and_breaker(self):
        model = _BlockingModel()
        server = _server(model, max_batch=1, max_queue=7)
        base = f"http://127.0.0.1:{server.port}"
        try:
            health = _health(base)
            assert health["queue_depth"] == 0
            assert health["queue_capacity"] == 7
            assert health["breaker"] == "closed"
            assert health["draining"] is False
        finally:
            model.release.set()
            server.stop(drain=False)

    def test_breaker_trips_on_model_failures_and_recovers(self, rng):
        from deeplearning4j_tpu_torch.util.resilience import (CircuitBreaker,
                                                              ManualClock)
        clock = ManualClock()
        breaker = CircuitBreaker(failure_threshold=2, reset_timeout_s=60.0,
                                 clock=clock, name="test-serving")
        server = _server(_FailingModel(), max_batch=1, breaker=breaker,
                         clock=clock)
        base = f"http://127.0.0.1:{server.port}"
        x = [[0.0] * T]
        try:
            for _ in range(2):
                code, body, _ = _get_error(base, "/predict", {"inputs": x})
                assert code == 500
            assert breaker.state == "open"
            code, body, headers = _get_error(base, "/predict", {"inputs": x})
            assert code == 503
            assert "circuit" in body["error"]
            assert float(headers["Retry-After"]) >= 1.0
            health = _health(base)
            assert health["breaker"] == "open" and not health["ok"]
            assert "breaker_open" in health["ready_reasons"]
            server.set_model(_net())
            clock.advance(60.0)
            code, body, _ = _get_error(base, "/predict",
                                       {"inputs": _ids(rng, 1).tolist()})
            assert code == 200
            assert breaker.state == "closed"
            assert server.model_generation == 1
        finally:
            server.stop(drain=False)

    def test_expired_request_answers_504_without_model_call(self):
        from deeplearning4j_tpu_torch.util.resilience import ManualClock
        clock = ManualClock()
        calls = []

        class CountingModel(_BlockingModel):
            def output(self, x):
                calls.append(x.shape[0])
                return super().output(x)

        model = CountingModel()
        server = _server(model, max_batch=1, batch_timeout_ms=1.0,
                         request_timeout_s=5.0, clock=clock)
        base = f"http://127.0.0.1:{server.port}"
        results = {}

        def call(name):
            results[name] = _get_error(
                base, "/predict", {"inputs": [[0.0, 0.0, 0.0]]})

        try:
            ta = threading.Thread(target=call, args=("a",))
            ta.start()
            assert model.entered.wait(timeout=10)
            tb = threading.Thread(target=call, args=("b",))
            tb.start()
            for _ in range(200):
                if server._queue.qsize() >= 1:
                    break
                threading.Event().wait(0.01)
            clock.advance(10.0)
            n_calls = len(calls)
            model.release.set()
            ta.join(timeout=30)
            tb.join(timeout=30)
            assert results["a"][0] == 200
            assert results["b"][0] == 504
            assert "deadline" in results["b"][1]["error"]
            assert len(calls) == n_calls
        finally:
            model.release.set()
            server.stop(drain=False)

    def test_graceful_drain_finishes_queued_work(self, rng):
        net = _net()
        server = _server(net, max_batch=8)
        base = f"http://127.0.0.1:{server.port}"
        xs = [_ids(rng, 2) for _ in range(6)]
        results = [None] * 6

        def call(i):
            results[i] = _get_error(base, "/predict",
                                    {"inputs": xs[i].tolist()})

        try:
            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert server.drain(timeout=10)
            code, body, headers = _get_error(
                base, "/predict", {"inputs": xs[0].tolist()})
            assert code == 503
            assert "draining" in body["error"]
            assert "Retry-After" in headers
            health = _health(base)
            assert health["draining"] is True and not health["ok"]
            for i in range(6):
                assert results[i][0] == 200, results[i]
        finally:
            server.stop(drain=False)

    def test_faultplan_scripts_an_inference_outage(self, rng):
        from deeplearning4j_tpu_torch.util import faults
        server = _server(_net(), max_batch=1)
        base = f"http://127.0.0.1:{server.port}"
        x = _ids(rng, 1)
        plan = faults.FaultPlan().fail_at("serving.infer", call=1,
                                          exc=RuntimeError("chip fell over"))
        try:
            with plan.active():
                code, body, _ = _get_error(base, "/predict",
                                           {"inputs": x.tolist()})
                assert code == 500
                assert "chip fell over" in body["error"]
                code, body, _ = _get_error(base, "/predict",
                                           {"inputs": x.tolist()})
                assert code == 200
            assert server.breaker.state == "closed"
        finally:
            server.stop(drain=False)
