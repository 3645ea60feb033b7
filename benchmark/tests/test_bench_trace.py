"""A ``--trace 1`` run profiles its steps after the measured window has
closed, so the window's own numbers (step time, host gap, model FLOPs'
share) read as in an untraced run: at tiny sizes on the CPU."""

import pytest

import _tiny


@pytest.mark.parametrize("name", ["opt-125m.train.t2048",
                                  "resnet50-f32.train.b128"])
def test_traced_run_profiles_after_the_window(name):
    ctx, result = _tiny.run(name, seconds=0.5, trace=True)
    record = ctx.record
    traffic = ctx.cell.traffic
    assert result["correct"] is True
    assert record.trace is not None
    assert record.trace.steps == traffic["trace_steps"]
    assert record.steps > 0 and record.window_s >= 0.5
    assert result["attempted"] == record.steps + 3
    gap = [k for k in result["metrics"] if k.startswith("train_host_gap_ms")]
    assert gap and result["metrics"][gap[0]]["value"] > 0
