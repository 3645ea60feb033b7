"""Kernels, short conv: the bytes bound of the gated short convolutions
between their projections in the profiled steps
(``counts_lfm2.shortconv_train_bytes`` over the bandwidth) over the
device time of the work under the program's ``shortconv`` phases and the
backward nodes they created. None where the program marks no such
phase."""

from harness import counts_lfm2


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    spent = run.trace.annotated_device_s("shortconv")
    if not spent:
        return None
    tokens = run.traffic["batch"] * run.traffic["seq_len"] * run.trace.steps
    bound = counts_lfm2.shortconv_train_bytes(run.config, tokens) \
        / run.peaks["bytes"]
    return 100.0 * bound / spent
