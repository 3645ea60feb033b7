"""Kernels, MoE experts: the least time of the held experts' products in
the profiled steps (``counts_lfm2.expert_train_bound_s``, for the
assignments the window's steps routed to the held experts on average,
``moe_assignments_total{path="held"}``) over the device time of the work
under the program's ``moe.experts`` phases and the backward nodes they
created. None where the program marks no such phase or counts nothing."""

from harness import counts_lfm2


def read(run):
    if run.trace is None or run.peaks is None or not run.steps:
        return None
    spent = run.trace.annotated_device_s("moe.experts")
    held = run.delta("moe_assignments_total", path="held")
    if not spent or not held:
        return None
    bound = counts_lfm2.expert_train_bound_s(
        run.config, held / run.steps * run.trace.steps, run.peaks)
    return 100.0 * bound / spent
