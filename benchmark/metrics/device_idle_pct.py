"""Device: the share of a measured step in which no kernel, copy or fill
ran on the card: one minus the device's busy time per profiled step (the
device-only profile after the window) over the measured window's wall
time per step. The profiler slows the host's dispatch, so the profiled
steps' own wall time would read the profiler's cost as idle time."""


def read(run):
    step_s = run.step_s()
    if run.trace is None or not run.trace.device or not step_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.steps / step_s)
