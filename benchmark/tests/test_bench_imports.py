"""No module of jax, jaxlib, flax or the JAX package in a run (top-level
names compared whole: the port's own package starts with the JAX
package's name and is none of them), and nothing of the program in the
references."""

import json
import subprocess
import sys

import run as bench_run

RUN_TINY = """
import json, sys
sys.path[:0] = [{bench!r}, {tests!r}]
import run as bench_run
bench_run.configure_environment()
import _tiny
from harness import common
_, result = _tiny.run({name!r}, seconds=0.5)
print(json.dumps({{"correct": result["correct"],
                  "forbidden": common.forbidden_modules(),
                  "port": "deeplearning4j_tpu_torch" in sys.modules}}))
"""

IMPORT_REFERENCE = """
import json, sys
sys.path.insert(0, {bench!r})
from reference import lm, optim, precision, resnet
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _last_json(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=bench_run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    for name in ("opt-125m.train.t2048", "resnet50-f32.train.b128"):
        got = _last_json(RUN_TINY.format(
            bench=str(bench_run.BENCH),
            tests=str(bench_run.BENCH / "tests"), name=name))
        assert got["port"] and got["forbidden"] == []


def test_references_import_nothing_of_the_program():
    top = _last_json(IMPORT_REFERENCE.format(bench=str(bench_run.BENCH)))
    for name in ("deeplearning4j_tpu_torch", "deeplearning4j_tpu", "jax",
                 "jaxlib", "flax", "harness", "families"):
        assert name not in top


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """With no card, or in a directory holding only BENCHMARK.json and the
    benchmark's files, a run exits non-zero and prints no result."""
    import shutil
    (tmp_path / "benchmark").mkdir()
    shutil.copy(bench_run.ROOT / "BENCHMARK.json", tmp_path)
    for sub in ("run.py",):
        shutil.copy(bench_run.BENCH / sub, tmp_path / "benchmark" / sub)
    for sub in ("harness", "reference", "families", "metrics", "traffic",
                "configs", "limits"):
        shutil.copytree(bench_run.BENCH / sub, tmp_path / "benchmark" / sub)
    for root in (bench_run.ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "opt-125m.train.t2048", "--seed", "1", "--seconds", "1"],
            capture_output=True, text=True, timeout=300, cwd=root)
        assert out.returncode != 0
        assert not out.stdout.strip()
