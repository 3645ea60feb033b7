"""Runtime and updater: the device time a host-profiled step of the
kernels launched inside the program's ``fit.updater`` ranges (gradient
normalization, the updater's arithmetic and the parameters' update).
None where the program marks no such range, or the card ran nothing in
it."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    spent = run.trace.annotated_device_s("fit.updater")
    if not spent:
        return None
    return 1e3 * spent / run.trace.steps
