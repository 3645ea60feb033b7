"""MoE routing: the device time a profiled step of the work under the
program's ``moe.route``, ``moe.dispatch`` and ``moe.combine`` phases and
of the backward nodes it created (the scores and top-k, the sort and the
gather of the rows, the weighted sum back). None where the program marks
none of them."""

PHASES = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    spent = [run.trace.annotated_device_s(p) for p in PHASES]
    if not any(spent):
        return None
    return 1e3 * sum(s or 0.0 for s in spent) / run.trace.steps
