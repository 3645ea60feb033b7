"""The readers of the program's update phases (``updater_device_ms``,
``updater_host_ms``, ``updater_idle_ms``, ``train_host_busy_ms``) on a
synthetic run record and trace, on one without the program's phases (a
program that marks none: every reader says nothing), and in a tiny traced
run on the CPU."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

import _tiny
from harness import common
from harness.record import RunRecord
from harness.trace import TraceView

CELLS = {"opt-125m.train.t2048": "", "resnet50-f32.train.b128": ".resnet"}
QUANTITIES = ("updater_device_ms", "updater_host_ms", "updater_idle_ms",
              "train_host_busy_ms")


def _ev(name, start, end, device=False, device_us=0.0):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=DeviceType.CUDA if device else DeviceType.CPU,
              is_user_annotation=False, is_async=False,
              device_time_total=device_us, sequence_nr=-1, cpu_children=[],
              thread=1)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _hist(*series):
    """A histogram family's snapshot: (labels, sum, count) a series."""
    return {"series": [{"labels": labels, "sum": s, "count": n}
                       for labels, s, n in series]}


def _record(name, phases=True):
    """Ten window steps in 1 s with 0.05 s of batch waits and 0.45 s of
    device waits, 0.2 s of updater phases; a host profile of two steps
    (µs): updater ranges [100, 200] and [300, 400] that launched 25 and 35
    µs of kernels, device activity [90, 130], [160, 170] and [350, 420]."""
    run = RunRecord(_tiny.cell(name), "NVIDIA H100 80GB HBM3")
    cg = {"model": "ComputationGraph"}
    run.before = {"fit_host_gap_seconds": _hist((cg, 0.01, 1))}
    run.after = {"fit_host_gap_seconds": _hist((cg, 0.06, 11))}
    if phases:
        upd, wait = dict(cg, phase="updater"), dict(cg, phase="device_wait")
        run.before["fit_phase_seconds"] = _hist((upd, 0.02, 1),
                                                (wait, 0.05, 1))
        run.after["fit_phase_seconds"] = _hist((upd, 0.22, 11),
                                               (wait, 0.5, 11))
    run.window_s, run.steps = 1.0, 10
    device = [_ev("k", 90, 130, True), _ev("k", 160, 170, True),
              _ev("k", 350, 420, True)]
    host = [_ev("aten::mm", 10, 80)]
    if phases:
        host += [_ev("fit.updater", 100, 200, device_us=25.0),
                 _ev("fit.updater", 300, 400, device_us=35.0)]
    run.trace = TraceView(_Prof(list(device)), 0.001, 2,
                          _Prof(device + host))
    return run


def _read(quantity, cell, run):
    return common.load_reader(quantity + CELLS[cell]).read(run)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_readers_on_a_synthetic_run(cell):
    run = _record(cell)
    assert _read("updater_device_ms", cell, run) == pytest.approx(0.030)
    # 100 − 40 and 100 − 50 µs without device activity, over 2 steps
    assert _read("updater_idle_ms", cell, run) == pytest.approx(0.055)
    assert _read("updater_host_ms", cell, run) == pytest.approx(20.0)
    # (1 − 0.05 − 0.45) s over 10 steps
    assert _read("train_host_busy_ms", cell, run) == pytest.approx(50.0)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("quantity", QUANTITIES)
def test_readers_say_nothing_without_the_programs_phases(cell, quantity):
    assert _read(quantity, cell, _record(cell, phases=False)) is None


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_tiny_traced_run_reports_the_host_phases(name):
    """On the CPU the counters read and the device readers say nothing:
    the updater's host time lies inside the host's busy time, which lies
    inside the step."""
    ctx, result = _tiny.run(name, seconds=0.5, trace=True)
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    upd = metrics["updater_host_ms" + CELLS[name]]
    busy = metrics["train_host_busy_ms" + CELLS[name]]
    step_ms = 1e3 * ctx.record.window_s / ctx.record.steps
    assert 0 < upd < busy <= step_ms
    assert "updater_device_ms" + CELLS[name] not in metrics
    assert "updater_idle_ms" + CELLS[name] not in metrics
