"""The reader of ``updater_fused_share`` (the leaves the window's updates
sent to the multi-tensor adam kernel over all leaves updated) on synthetic
run records, silent on a program without ``updater_leaves_total``, and in
a tiny traced run on the CPU, where every leaf takes the plain path."""

import pytest

import _tiny
from harness import common
from harness.record import RunRecord

CELLS = {"opt-125m.train.t2048": "", "resnet50-f32.train.b128": ".resnet"}


def _counter(**series):
    """A counter family's snapshot: one series a path."""
    return {"series": [{"labels": {"model": "ComputationGraph", "path": k},
                        "value": v} for k, v in series.items()]}


def _record(name, before=None, after=None):
    run = RunRecord(_tiny.cell(name), "NVIDIA H100 80GB HBM3")
    if before is not None:
        run.before = {"updater_leaves_total": _counter(**before)}
        run.after = {"updater_leaves_total": _counter(**after)}
    return run


def _read(cell, run):
    return common.load_reader("updater_fused_share" + CELLS[cell]).read(run)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("before,after,share", [
    ({"fused": 274, "plain": 0}, {"fused": 274 + 137 * 10, "plain": 0}, 1.0),
    ({"fused": 0, "plain": 322}, {"fused": 0, "plain": 322 + 161 * 4}, 0.0),
    ({"fused": 10, "plain": 5}, {"fused": 40, "plain": 15}, 0.75),
])
def test_share_on_a_synthetic_run(cell, before, after, share):
    assert _read(cell, _record(cell, before, after)) == pytest.approx(share)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_silent_without_the_counter_or_an_update(cell):
    assert _read(cell, _record(cell)) is None
    idle = {"fused": 3, "plain": 4}
    assert _read(cell, _record(cell, idle, idle)) is None


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_tiny_traced_run_reports_the_share(name):
    """CPU leaves are not the kernel's: the share reads 0."""
    _, result = _tiny.run(name, seconds=0.5, trace=True)
    assert result["metrics"]["updater_fused_share" + CELLS[name]] == {
        "value": 0.0, "unit": "share"}
