"""The yardstick's arithmetic: the chip's published peaks, model FLOPs of
a training step, and the least time of the kernels' work at given shapes.
Every count comes from shapes alone, never from what a program executed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit.
PEAKS = {
    "H100": {"bf16_flops": 989e12, "tf32_flops": 495e12,
             "f32_flops": 67e12, "bytes": 3.35e12},
}


def peaks_for(device_kind: str) -> Optional[Dict[str, float]]:
    """The peaks of a device by its ``torch.cuda.get_device_name()``, or
    None for a device the table does not know (its shares read nothing)."""
    for key, peaks in PEAKS.items():
        if key in device_kind:
            return peaks
    return None


def compute_peak(peaks: Dict[str, float], program: dict) -> float:
    """The FLOP/s peak of the precision a configuration's program runs:
    bf16 for mixed bf16, TF32 or float32 (FFMA) for float32."""
    if program["dtype"] == "mixed_bf16":
        return peaks["bf16_flops"]
    return peaks["tf32_flops"] if program.get("tf32", True) \
        else peaks["f32_flops"]


def activation_bytes(program: dict) -> int:
    """Bytes of an activation in the precision the program runs."""
    return 2 if program["dtype"] == "mixed_bf16" else 4


# --------------------------------------------------------------------------
# decoder-only LM
# --------------------------------------------------------------------------


def lm_matmul_params(d: int, n_layers: int, d_ff: int, vocab: int) -> float:
    """Weights that take part in a matrix product per token: per layer the
    fused qkv (3d²), the output projection (d²) and the FFN (2·d·d_ff),
    and the vocabulary head (d·V). The embedding is a gather."""
    return n_layers * (4.0 * d * d + 2.0 * d * d_ff) + d * vocab


def lm_train_flops_per_token(d: int, n_layers: int, d_ff: int, vocab: int,
                             t: int) -> float:
    """Model FLOPs per trained token: 3× (forward and backward) the
    forward's 2 FLOPs per matmul weight, plus the causal attention's QKᵀ
    and PV over t/2 keys on average. LayerNorm, softmax and the residual
    adds are left out."""
    attn = n_layers * 2.0 * (t / 2.0) * d * 2.0
    return 3.0 * (2.0 * lm_matmul_params(d, n_layers, d_ff, vocab) + attn)


def causal_attention_bound_s(b: int, t: int, h: int, d: int, itemsize: int,
                             peaks: Dict[str, float]) -> float:
    """Least time of one causal attention forward and its backward, for
    q/k/v ``[b, t, h, d]`` in a 2-byte type: per pass the larger of its
    FLOPs over the bf16 peak and its bytes over the bandwidth. FLOPs per
    attended (query, key) pair: 4·d forward (QKᵀ, PV), 10·d backward (S
    recomputed once, dP, dV, dQ, dK). Bytes: each input read once and each
    output written once (forward: q, k, v in, out and the f32 row
    log-sum-exp out; backward: q, k, v, out, dout and lse in, dq, dk, dv
    out)."""
    pairs = b * h * t * (t + 1) / 2.0
    x = b * t * h * d * itemsize
    row = b * h * t * 4
    fwd = max(4.0 * d * pairs / peaks["bf16_flops"],
              (4 * x + row) / peaks["bytes"])
    bwd = max(10.0 * d * pairs / peaks["bf16_flops"],
              (8 * x + row) / peaks["bytes"])
    return fwd + bwd


# --------------------------------------------------------------------------
# bottleneck ResNet
# --------------------------------------------------------------------------


def _same_out(n: int, stride: int) -> int:
    return -(-n // stride)


def resnet_layers(cfg: dict) -> List[dict]:
    """Every conv of a bottleneck ResNet (v1.5: the stride on the 3×3) in
    order, each ``{"hw_in", "hw_out", "c_in", "c_out", "k", "stride"}``;
    each is followed by a BatchNorm over its output."""
    size = cfg["image_size"]
    convs = []

    def conv(hw, c_in, c_out, k, stride):
        out = _same_out(hw, stride)
        convs.append({"hw_in": hw, "hw_out": out, "c_in": c_in,
                      "c_out": c_out, "k": k, "stride": stride})
        return out

    hw = conv(size, cfg["num_channels"], cfg["embedding_size"],
              cfg["stem_kernel"], cfg["stem_stride"])
    hw = _same_out(hw, 2)                      # 3×3/2 max pool
    c_in = cfg["embedding_size"]
    for stage, (planes, blocks) in enumerate(zip(cfg["hidden_sizes"],
                                                 cfg["depths"])):
        width = planes // cfg["expansion"]
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            conv(hw, c_in, width, 1, 1)
            out = conv(hw, width, width, 3, stride)
            conv(out, width, planes, 1, 1)
            if i == 0:
                conv(hw, c_in, planes, 1, stride)
            c_in, hw = planes, out
    return convs


def resnet_train_flops_per_example(cfg: dict) -> float:
    """Model FLOPs per trained example: 3× the forward's 2 FLOPs per
    multiply-accumulate of every conv and the classifier."""
    fwd = sum(2.0 * c["hw_out"] ** 2 * c["c_out"] * c["k"] ** 2 * c["c_in"]
              for c in resnet_layers(cfg))
    fwd += 2.0 * cfg["hidden_sizes"][-1] * cfg["num_labels"]
    return 3.0 * fwd


def batchnorm_train_bound_s(cfg: dict, batch: int, itemsize: int,
                            peaks: Dict[str, float]) -> float:
    """Least time of every training-mode BatchNorm's forward and backward
    in one step, by bytes: per BatchNorm of n activations over c channels,
    the forward reads x and writes y, the backward reads x and dy and
    writes dx (each once, in the activation type), plus the f32 per-channel
    vectors (γ, β in and mean, var out; γ, mean, var in and dγ, dβ out)."""
    total = 0.0
    for c in resnet_layers(cfg):
        n = batch * c["hw_out"] ** 2 * c["c_out"]
        total += 5 * n * itemsize + 9 * c["c_out"] * 4
    return total / peaks["bytes"]
