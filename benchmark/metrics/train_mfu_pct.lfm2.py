"""Whole step, hybrid MoE LM: the model FLOPs of the window's steps
(``counts_lfm2.train_flops``: the operators, dense FFNs, routers, head
and causal attention from the configuration's shapes, the routed experts
from the assignments the program counted to the held experts,
``moe_assignments_total{path="held"}``) over the window's wall time and
the bf16 peak. None where the program counts no assignments."""

from harness import counts, counts_lfm2


def read(run):
    if run.peaks is None or not run.steps:
        return None
    held = run.delta("moe_assignments_total", path="held")
    if not held:
        return None
    t = run.traffic["seq_len"]
    tokens = run.traffic["batch"] * t * run.steps
    flops = counts_lfm2.train_flops(run.config, tokens, t, held)
    peak = counts.compute_peak(run.peaks, run.config["program"])
    return 100.0 * flops / run.window_s / peak
