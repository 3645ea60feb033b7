"""The reader of ``shortconv_kernel_share`` (the window's gated short conv
calls that took the hand-written CUDA kernels over all calls) on synthetic
run records, silent on a program without ``shortconv_calls_total``, and
in a tiny traced run of the LFM2 cell on the CPU, where every call takes
the plain passes."""

import json

import pytest
import torch

import run as bench_run
from harness import common
from harness.record import RunRecord

NAME = "lfm2-8b-a1b-ep4.train.t8192"
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_hidden_layers": 6,
        "num_experts": 8, "vocab_size": 512}
SEED = 2 ** 31 + 2222


def _cell():
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    cell = common.Cell(bench, NAME, bench_run.ROOT)
    cell.config.update(TINY)
    cell.traffic.update({"batch": 1, "seq_len": 64})
    return cell


def _counter(**series):
    """A counter family's snapshot: one series a (layer, path)."""
    return {"series": [{"labels": {"model": f"blk{i}_conv", "path": k},
                        "value": v} for k, v in series.items()
                       for i in (0, 1)]}


def _record(before=None, after=None):
    run = RunRecord(_cell(), "NVIDIA H100 80GB HBM3")
    if before is not None:
        run.before = {"shortconv_calls_total": _counter(**before)}
        run.after = {"shortconv_calls_total": _counter(**after)}
    return run


def _read(run):
    return common.load_reader("shortconv_kernel_share").read(run)


@pytest.mark.parametrize("before,after,share", [
    ({"kernel": 27, "plain": 0}, {"kernel": 27 + 9 * 40, "plain": 0}, 1.0),
    ({"kernel": 0, "plain": 27}, {"kernel": 0, "plain": 27 + 9 * 40}, 0.0),
    ({"kernel": 3, "plain": 1}, {"kernel": 9, "plain": 3}, 0.75),
])
def test_share_on_a_synthetic_run(before, after, share):
    assert _read(_record(before, after)) == pytest.approx(share)


def test_silent_without_the_counter_or_a_call():
    assert _read(_record()) is None
    idle = {"kernel": 5, "plain": 2}
    assert _read(_record(idle, idle)) is None


def test_a_tiny_traced_run_reports_the_share():
    """CPU tensors are not the kernels': the share reads 0."""
    _, result = bench_run.run_cell(_cell(), SEED, 0.5, True,
                                   torch.device("cpu"))
    assert result["metrics"]["shortconv_kernel_share"] == {
        "value": 0.0, "unit": "share"}
