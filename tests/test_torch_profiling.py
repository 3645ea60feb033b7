"""The port's profiling captures (``util/profiling.py``): one
torch.profiler capture at a time (a second answers busy, ``POST
/profile``'s 409), the trace and summary written, a CUDA graph capture
held off while a profile is open, and the device memory gauges — absent
on the CPU, live on the card. Imports no JAX, so the card-only cases run
on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_profiling.py``.
"""

import json
import os
import threading
import time

import pytest
import torch

from deeplearning4j_tpu_torch.util import profiling as t_profiling
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry


class TestCapture:
    def test_capture_writes_trace_and_refuses_a_second(self, tmp_path):
        out = {}

        def first():
            out["dir"] = t_profiling.capture_trace(0.6, str(tmp_path))

        th = threading.Thread(target=first)
        th.start()
        deadline = time.monotonic() + 10
        while not t_profiling.capture_in_progress():
            assert time.monotonic() < deadline
            time.sleep(0.005)
        body, code = t_profiling.profile_request({"seconds": ["0.1"]})
        assert code == 409 and "in progress" in body["error"]
        th.join(timeout=30)
        assert not th.is_alive()
        names = sorted(os.listdir(out["dir"]))
        assert names == ["summary.json", "trace.json"]
        assert json.load(open(os.path.join(out["dir"], "trace.json")))

    def test_bad_seconds_is_400(self):
        assert t_profiling.profile_request({"seconds": ["0"]})[1] == 400
        assert t_profiling.profile_request({"seconds": ["x"]})[1] == 400

    def test_graph_capture_waits_for_an_open_profile(self, tmp_path):
        """A CUDA graph capture never starts while a profile is open: the
        guard it takes is held by the profile until it stops."""
        entered = []

        def capture():
            with t_profiling.graph_capture_guard():
                entered.append(time.monotonic())

        with t_profiling.trace(str(tmp_path)):
            th = threading.Thread(target=capture)
            th.start()
            time.sleep(0.2)
            assert not entered
            stopped = time.monotonic()
        th.join(timeout=10)
        assert not th.is_alive()
        assert len(entered) == 1 and entered[0] >= stopped

    def test_memory_gauges_absent_on_the_cpu(self):
        reg = MetricsRegistry()
        t_profiling.register_device_memory_gauges(reg)
        assert reg.get("device_memory_bytes").snapshot()["series"] == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
class TestOnTheCard:
    def test_memory_gauges_on_the_device(self, cuda):
        reg = MetricsRegistry()
        t_profiling.register_device_memory_gauges(reg)
        x = torch.ones(1 << 20, device="cuda")
        series = {s["labels"]["kind"]: s["value"] for s in
                  reg.get("device_memory_bytes").snapshot()["series"]
                  if s["labels"]["device"] == "cuda:0"}
        assert series["in_use"] >= x.numel() * 4
        assert series["peak"] >= series["in_use"]
        assert series["limit"] == torch.cuda.mem_get_info(0)[1]

    def test_profile_names_a_cuda_kernel(self, cuda, tmp_path):
        a = torch.randn(512, 512, device="cuda")
        with t_profiling.trace(str(tmp_path)):
            for _ in range(4):
                a = a @ a
            torch.cuda.synchronize()
        summary = json.load(open(tmp_path / "summary.json"))
        assert any(e["device_us"] > 0 for e in summary["events"])
