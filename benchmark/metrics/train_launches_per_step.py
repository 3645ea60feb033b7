"""Runtime and updater: device kernels in the traced steps, per step."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    n = run.trace.kernel_count()
    return n / run.trace.steps if n else None
