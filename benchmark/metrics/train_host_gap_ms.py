"""Training loop: the mean host time between two step dispatches of
``fit`` over the window (``fit_host_gap_seconds{model}``, sum over
count)."""


def read(run):
    n = run.delta("fit_host_gap_seconds", "count", model="ComputationGraph")
    if not n:
        return None
    s = run.delta("fit_host_gap_seconds", "sum", model="ComputationGraph")
    return 1e3 * s / n
