"""Kernels, BatchNorm: the bytes bound of every training-mode BatchNorm's
forward and backward at the cell's shapes, in its activations' type
(``counts.batchnorm_train_bound_s``) over the device time of the kernels
launched under the BatchNorm op and by the backward nodes it created, in
the traced steps."""

from harness import counts

ANNOTATE = [("deeplearning4j_tpu_torch.ops.batchnorm", "batch_norm_train",
             "bench::batchnorm")]


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    spent = run.trace.annotated_device_s("bench::batchnorm")
    if not spent:
        return None
    bound = counts.batchnorm_train_bound_s(
        run.config, run.traffic["batch"],
        counts.activation_bytes(run.config["program"]), run.peaks)
    return 100.0 * bound * run.trace.steps / spent
