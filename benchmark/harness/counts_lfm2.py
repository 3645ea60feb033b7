"""The yardstick's arithmetic for the hybrid conv/attention MoE LM
(``families/lfm2.py``): model FLOPs of a training step and the least time
of its experts' products and of its gated short convolutions. Counted
from the configuration's shapes, and for the routed experts from the
number of assignments to the held experts (``moe_assignments_total
{path="held"}``, the program's count of the work the routing gave them):
the same work is counted whatever implements it.

Layers are the configuration's first ``num_hidden_layers`` of
``layer_types``; the first ``num_dense_layers`` have a dense SwiGLU FFN,
the rest a sparse MoE whose router spans ``deployment.routed_experts``
and of whose experts ``num_experts`` are held here.
"""

from __future__ import annotations

from typing import Dict


def layer_counts(cfg: dict) -> Dict[str, int]:
    """How many conv and attention operators, dense FFNs and MoE layers
    the configuration runs."""
    n = cfg["num_hidden_layers"]
    kinds = cfg["layer_types"][:n]
    dense = min(cfg["num_dense_layers"], n)
    return {"conv": kinds.count("conv"),
            "attention": kinds.count("full_attention"),
            "dense": dense, "moe": n - dense}


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def dense_matmul_params(cfg: dict) -> float:
    """Weights that every token meets in a matrix product: each conv
    operator's in and out projections (3d², d²), each attention
    operator's q, k, v and o (d·h·dh, twice d·kv·dh, h·dh·d), each dense
    SwiGLU (3·d·ff), each router (d·E) and the vocabulary head (d·V). The
    embedding is a gather; the routed experts are counted by assignment
    (:func:`expert_forward_flops`)."""
    c, d = layer_counts(cfg), cfg["hidden_size"]
    q = cfg["num_attention_heads"] * head_dim(cfg)
    kv = cfg["num_key_value_heads"] * head_dim(cfg)
    return (c["conv"] * 4.0 * d * d
            + c["attention"] * (2.0 * d * q + 2.0 * d * kv)
            + c["dense"] * 3.0 * d * cfg["intermediate_size"]
            + c["moe"] * d * cfg["deployment"]["routed_experts"]
            + d * cfg["vocab_size"])


def attention_forward_flops_per_token(cfg: dict, t: int) -> float:
    """Causal attention's QKᵀ and PV a token, forward: 2·2·(t/2)·h·dh a
    layer (t/2 keys on average)."""
    q = cfg["num_attention_heads"] * head_dim(cfg)
    return layer_counts(cfg)["attention"] * 4.0 * (t / 2.0) * q


def expert_forward_flops(cfg: dict, held_assignments: float) -> float:
    """The held experts' three products (W₁, W₃, W₂) of 2·d·h FLOPs each
    for every assignment routed to them."""
    return (held_assignments * 3 * 2.0 * cfg["hidden_size"]
            * cfg["moe_intermediate_size"])


def train_flops(cfg: dict, tokens: float, t: int,
                held_assignments: float) -> float:
    """Model FLOPs of training on ``tokens`` tokens of sequences of ``t``
    with ``held_assignments`` assignments to the held experts: 3× (forward
    and backward) the forward's 2 FLOPs a matmul weight and token, the
    causal attention and the routed experts. Norms, the conv, the
    routing's passes and the softmax are left out."""
    return 3.0 * (2.0 * dense_matmul_params(cfg) * tokens
                  + attention_forward_flops_per_token(cfg, t) * tokens
                  + expert_forward_flops(cfg, held_assignments))


def expert_train_bound_s(cfg: dict, held_assignments: float,
                         peaks: Dict[str, float]) -> float:
    """Least time of the held experts' products in training, summed over
    the MoE layers for ``held_assignments`` assignments in all: forward
    (three products) and backward (six), each pass the larger of its
    FLOPs over the bf16 peak and its bytes over the bandwidth. Bytes, in
    bf16, read or written once a pass: forward the held experts' weights
    (3·d·h each), the assignments' rows in (d), the first products out
    (2h), their SwiGLU in (h) and the outputs out (d); backward the
    weights in and their gradients out, and dy, x and the first products
    in, dx out."""
    d, h = cfg["hidden_size"], cfg["moe_intermediate_size"]
    weights = layer_counts(cfg)["moe"] * cfg["num_experts"] * 3.0 * d * h * 2
    rows = held_assignments * 2.0
    fwd_flops = expert_forward_flops(cfg, held_assignments)
    fwd_bytes = weights + rows * (d + 2 * h + h + d)
    bwd_bytes = 2 * weights + rows * (d + d + 2 * h + d)
    return (max(fwd_flops / peaks["bf16_flops"], fwd_bytes / peaks["bytes"])
            + max(2 * fwd_flops / peaks["bf16_flops"],
                  bwd_bytes / peaks["bytes"]))


def shortconv_train_bytes(cfg: dict, tokens: float) -> float:
    """Bytes of the gated short convolutions between their projections in
    training, bf16, each read or written once: forward B, C, x in and y
    out, backward dy, B, C, x in and dB, dC, dx out (the filters are
    left out), 11·d values a token and conv layer."""
    return layer_counts(cfg)["conv"] * tokens * 11.0 * cfg["hidden_size"] * 2
