"""The control: the plain reference in the precision below the one the
configuration states, put in the program's place, comes out not correct
against the cell's limits: e4m3 products at tiny sizes on the CPU; TF32,
which needs the card, at the cell's own size there."""

import json
import subprocess
import sys

import pytest
import torch

import _tiny
import run as bench_run
from harness import drive_fit
from reference import precision


def _limits(name):
    return json.loads((bench_run.BENCH / "limits" / f"{name}.json")
                      .read_text())


def _control(name):
    return precision.CONTROL[_tiny.cell(name).config["program"]["dtype"]]


def test_training_control_fails():
    name = "opt-125m.train.t2048"
    arithmetic = _control(name)
    ctx, result = _tiny.run(name)
    assert result["correct"] is True
    cell = ctx.cell
    got = drive_fit.reference_readings(
        ctx.family, cell.config, ctx.shapes, ctx.seed, ctx.device,
        ctx.batches, arithmetic=arithmetic)
    readings = drive_fit.compare(got, ctx.reference_readings)
    assert any(readings[k] > lim for k, lim in _limits(name).items())


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card():
    """``control.py`` on one seed at the ResNet-50 cell's own size: the
    TF32 control fails one of the cell's numbers, the program none."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need an NVIDIA GPU")
    name = "resnet50-f32.train.b128"
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", name,
         "--seeds", "2147492001", "--seconds", "2"],
        capture_output=True, text=True, timeout=900, cwd=bench_run.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = _limits(name)
    assert line["correct"] is True
    assert any(line["control"][k] > lim for k, lim in limits.items())
