"""The hybrid MoE LM's cell (``lfm2-8b-a1b-ep4.train.t8192``) on the CPU:
its counts against values worked out by hand, its readers on synthetic
run records (and silent without the program's phases or counter), its
configuration's size, and tiny runs of the cell: sound, with its state
left unchanged, and with the half-token fault of ``control_tokens.py``
planted in the reference put in the program's place."""

import json
import subprocess
import sys
from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType

import control_tokens
import run as bench_run
from harness import common, counts_lfm2, drive_fit
from harness.record import RunRecord
from harness.trace import TraceView

NAME = "lfm2-8b-a1b-ep4.train.t8192"
READERS = ("moe_expert_roofline", "moe_routing_device_ms",
           "shortconv_roofline", "train_mfu_pct.lfm2")
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_hidden_layers": 6,
        "num_experts": 8, "vocab_size": 512}
UNIT = {"bf16_flops": 1.0, "bytes": 1.0}
SEED = 2 ** 31 + 4321
# 256 tokens give each of the 8 held experts ≈ 32 assignments, so a top-4
# choice that bf16 flips at a near-tie moves a few percent of an expert's
# gradient, as at the cell's size, not an eighth of it
TOKENS = 256


def _cell(tiny=True):
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    cell = common.Cell(bench, NAME, bench_run.ROOT)
    if tiny:
        cell.config.update(TINY)
        cell.traffic.update({"batch": 1, "seq_len": TOKENS})
    return cell


def _counts_cfg():
    """4 layers (conv, conv, attention, conv), 1 dense; d 8, 2 heads of 4
    and 1 K/V head; FFN 12; 2 of 8 experts of 4 held; vocabulary 16."""
    return {"hidden_size": 8, "num_attention_heads": 2,
            "num_key_value_heads": 1, "intermediate_size": 12,
            "moe_intermediate_size": 4, "num_hidden_layers": 4,
            "layer_types": ["conv", "conv", "full_attention", "conv",
                            "full_attention"],
            "num_dense_layers": 1, "num_experts": 2,
            "deployment": {"routed_experts": 8}, "vocab_size": 16}


def test_counts_by_hand():
    cfg = _counts_cfg()
    assert counts_lfm2.layer_counts(cfg) == {"conv": 3, "attention": 1,
                                             "dense": 1, "moe": 3}
    # 3 convs · 4·8², attention 2·8·8 + 2·8·4, FFN 3·8·12, 3 routers 8·8,
    # head 8·16
    assert counts_lfm2.dense_matmul_params(cfg) == 1568
    # 1 layer · 4 · t/2 · (2 heads · 4)
    assert counts_lfm2.attention_forward_flops_per_token(cfg, 6) == 96
    # 10 assignments · 3 products · 2·8·4
    assert counts_lfm2.expert_forward_flops(cfg, 10) == 1920
    # 3 · (2·1568·6 + 96·6 + 1920)
    assert counts_lfm2.train_flops(cfg, 6, 6, 10) == 63936
    # forward max(1920 FLOPs, 1152 weight bytes + 20·28) + backward
    # max(3840, 2304 + 20·32)
    assert counts_lfm2.expert_train_bound_s(cfg, 10, UNIT) == 1920 + 3840
    # 3 conv layers · 6 tokens · 11 values of 8 · 2 bytes
    assert counts_lfm2.shortconv_train_bytes(cfg, 6) == 3168


@pytest.mark.parametrize("layers, params", [(12, 1_420_599_680),
                                            (24, 2_660_907_776)])
def test_configuration_size(layers, params):
    """The cell's configuration as the program builds it: 1.42B parameters
    at the 12 layers it runs, 2.66B at the published 24 (8 of 32 experts
    held in each MoE layer either way)."""
    cell = _cell(tiny=False)
    cfg = dict(cell.config, num_hidden_layers=layers)
    shapes = common.program_shapes(common.family(cfg).port_conf(cfg))
    total = sum(torch.Size(s).numel() for v in shapes.values()
                for s in v.values())
    assert total == params
    assert shapes["blk2_moe"]["W13"] == (8, 2048, 2 * 1792)
    assert shapes["blk2_moe"]["router"] == (2048, 32)


def _ev(name, device_us):
    return NS(name=name, time_range=NS(start=0, end=10),
              device_type=DeviceType.CPU, is_user_annotation=False,
              is_async=False, device_time_total=device_us, sequence_nr=-1,
              cpu_children=[], thread=1)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _record(phases=True, counted=True):
    """Ten window steps in 2 s with 100 held assignments each; two profiled
    steps whose phases launched (µs) 300 of experts, 40, 20 and 60 of
    route, dispatch and combine, 50 of short conv."""
    run = RunRecord(_cell(), "NVIDIA H100 80GB HBM3")
    run.window_s, run.steps = 2.0, 10
    if counted:
        series = [{"labels": {"model": "blk2_moe", "path": "held"},
                   "value": 1000.0},
                  {"labels": {"model": "blk2_moe", "path": "absent"},
                   "value": 5000.0}]
        run.before = {"moe_assignments_total": {"series": []}}
        run.after = {"moe_assignments_total": {"series": series}}
    host = [_ev("aten::mm", 0.0)]
    if phases:
        host += [_ev("moe.experts", 300.0), _ev("moe.route", 40.0),
                 _ev("moe.dispatch", 20.0), _ev("moe.combine", 60.0),
                 _ev("shortconv", 50.0)]
    run.trace = TraceView(_Prof([]), 0.1, 2, _Prof(host))
    return run


def _read(name, run):
    return common.load_reader(name).read(run)


def test_readers_on_a_synthetic_run():
    run = _record()
    cfg, peaks = run.config, run.peaks
    bound = counts_lfm2.expert_train_bound_s(cfg, 100 * 2, peaks)
    assert _read("moe_expert_roofline", run) == pytest.approx(
        100 * bound / 300e-6)
    assert _read("moe_routing_device_ms", run) == pytest.approx(0.06)
    conv = counts_lfm2.shortconv_train_bytes(cfg, TOKENS * 2) / peaks["bytes"]
    assert _read("shortconv_roofline", run) == pytest.approx(
        100 * conv / 50e-6)
    flops = counts_lfm2.train_flops(cfg, TOKENS * 10, TOKENS, 1000)
    assert _read("train_mfu_pct.lfm2", run) == pytest.approx(
        100 * flops / 2.0 / 989e12)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("phases, counted", [(False, True), (True, False),
                                             (False, False)])
def test_readers_say_nothing_without_the_programs_phases_or_counter(
        name, phases, counted):
    """A program that marks none of the phases, or counts no assignments
    (the parent commit), reads nothing; the routing and the conv need
    only their phases, the MFU only the counter."""
    run = _record(phases, counted)
    needs_counter = name in ("moe_expert_roofline", "train_mfu_pct.lfm2")
    needs_phases = name != "train_mfu_pct.lfm2"
    silent = (needs_counter and not counted) or (needs_phases and not phases)
    assert (_read(name, run) is None) == silent
    run.trace = None
    if needs_phases:
        assert _read(name, run) is None


def test_a_tiny_run_is_correct_and_its_faults_are_caught(monkeypatch):
    """A sound tiny run is correct; with the updates dropped (a state left
    unchanged) it is not, by the change numbers; the half-token fault in
    the reference's place fails the gradient numbers."""
    cell = _cell()
    ctx, sound = bench_run.run_cell(cell, SEED, 0.5, False,
                                    torch.device("cpu"))
    assert sound["correct"] is True
    assert set(sound["metrics"]) == {"setup_s", "train_step_ms"}
    half = drive_fit.reference_readings(
        control_tokens.HalfTokens(ctx.family), cell.config, ctx.shapes, SEED,
        torch.device("cpu"), ctx.batches)
    got = drive_fit.compare(half, ctx.reference_readings)
    limits = {k: c["limit"] for k, c in sound["checks"].items()}
    assert got["grad_diff_median"] > limits["grad_diff_median"]
    assert got["change_gap_step1"] > limits["change_gap_step1"]
    from deeplearning4j_tpu_torch.optimize import updaters
    monkeypatch.setattr(updaters, "apply_updates", lambda params, d: None)
    _, broken = bench_run.run_cell(_cell(), SEED, 0.5, False,
                                   torch.device("cpu"))
    assert broken["correct"] is False
    assert broken["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_tiny_traced_run_reads_no_device_metric_on_the_cpu():
    _, result = bench_run.run_cell(_cell(), SEED, 0.5, True,
                                   torch.device("cpu"))
    assert result["correct"] is True
    assert not set(READERS) & set(result["metrics"])


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(bench_run.BENCH)!r})"
            "\nfrom reference import lfm2"
            "\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=bench_run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("deeplearning4j_tpu_torch", "deeplearning4j_tpu", "jax",
                 "harness", "families"):
        assert name not in top
