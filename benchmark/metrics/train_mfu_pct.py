"""Whole step: the model FLOPs of the window's steps (counted from the
configuration's shapes by the benchmark, not what the program executed)
over the window's wall time and the chip's peak in the precision the
configuration runs (bf16 for mixed bf16, FFMA for float32 without TF32)."""

from harness import counts


def flops_per_step(cfg, traffic):
    batch = traffic["batch"]
    if cfg["family"] == "lm":
        t = traffic["seq_len"]
        return batch * t * counts.lm_train_flops_per_token(
            cfg["hidden_size"], cfg["num_hidden_layers"], cfg["ffn_dim"],
            cfg["vocab_size"], t)
    if cfg["family"] == "resnet":
        return batch * counts.resnet_train_flops_per_example(cfg)
    return None


def read(run):
    flops = flops_per_step(run.config, run.traffic)
    if run.peaks is None or flops is None or not run.steps:
        return None
    peak = counts.compute_peak(run.peaks, run.config["program"])
    return 100.0 * flops * run.steps / run.window_s / peak
