"""Kernels, attention: the least time of the causal attention forward and
backward at the cell's shapes (``counts.causal_attention_bound_s``) over
the device time of the kernels launched under the attention op and by the
backward nodes it created, in the traced steps."""

from harness import counts

ANNOTATE = [("deeplearning4j_tpu_torch.ops.attention", "dot_product_attention",
             "bench::attention")]


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    spent = run.trace.annotated_device_s("bench::attention")
    if not spent:
        return None
    cfg, traffic = run.config, run.traffic
    heads = cfg["num_attention_heads"]
    bound = counts.causal_attention_bound_s(
        traffic["batch"], traffic["seq_len"], heads,
        cfg["hidden_size"] // heads, 2, run.peaks)
    per_step_layers = cfg["num_hidden_layers"] * run.trace.steps
    return 100.0 * bound * per_step_layers / spent
