"""Runtime and updater: the mean host time of one update's updater phase
over the window (``fit_phase_seconds{phase="updater"}``, sum over count):
what issuing gradient normalization, the updater's arithmetic and the
parameters' update costs the dispatching thread."""


def read(run):
    n = run.delta("fit_phase_seconds", "count", phase="updater")
    if not n:
        return None
    return 1e3 * run.delta("fit_phase_seconds", "sum", phase="updater") / n
