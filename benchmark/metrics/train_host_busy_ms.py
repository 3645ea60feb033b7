"""Training loop: the dispatching thread's time a step outside its two
waits, over the window: (wall − Σ ``fit_host_gap_seconds``, the waits for
a staged batch, − Σ ``fit_phase_seconds{phase="device_wait"}``, the waits
on an earlier step's completion) over the steps. Near the step time, the
step is bound by the host's issue."""


def read(run):
    if not run.steps or not run.delta("fit_phase_seconds", "count",
                                      phase="device_wait"):
        return None
    gap = run.delta("fit_host_gap_seconds", "sum")
    wait = run.delta("fit_phase_seconds", "sum", phase="device_wait")
    return 1e3 * (run.window_s - gap - wait) / run.steps
