"""One short run of each cell on the card, from the command line as the
benchmark is run: exit 0, ``correct`` true, every end-to-end metric of the
cell. Skips without a card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

import run as bench_run

BENCH = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483999", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=bench_run.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    want = {m["name"] for m in BENCH["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(result["metrics"]) == want
