"""Kernels, short conv: the share of the window's gated short conv calls
whose forward launched the hand-written CUDA kernel, kernel calls over all
calls (``shortconv_calls_total{path="kernel"}`` over the series' sum; the
program counts ``kernel`` after a launch and ``plain`` after the plain
passes). 1 where every conv layer's forward launched the kernel, 0 where
each took the plain passes. Nothing on a program without the counter."""


def read(run):
    total = run.delta("shortconv_calls_total")
    if not total:
        return None
    return run.delta("shortconv_calls_total", path="kernel") / total
