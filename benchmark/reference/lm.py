"""Plain PyTorch reference of the decoder-only LM the benchmark runs: the
layer equations of ``deeplearning4j_tpu_torch``'s ``transformer_lm
(input_ids=True)`` written out again, in float32 (or the control's
arithmetic), with no kernel, cache or batching of the program.

Per layer: x ← x + attn(LN₁(x))·Wo + b, then x ← x + relu(LN₂(x)·W₁ +
b₁)·W₂ + b₂; attention is causal softmax(q·kᵀ/√d_head)·v over the fused
``Wqkv`` projection (no bias), heads split as [b, t, 3, h, d_head]. The
token embedding is a row gather, without positions. After the final
LayerNorm, the head gives logits = x·W + b, and the training loss is the
summed cross-entropy over every position, divided by the batch size.
Parameters come as the program's tree ``{vertex: {name: tensor}}``
(``embed``, ``blk{i}_ln1`` … ``final_ln``, ``out``)."""

from __future__ import annotations

import math

import torch

from .precision import Arithmetic

LN_EPS = 1e-5


def layer_norm(x, p):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p["gamma"] + p["beta"]


def attention(x, p, n_heads, ar: Arithmetic):
    b, t, d = x.shape
    dh = d // n_heads
    qkv = ar.matmul(x, p["Wqkv"]).reshape(b, t, 3, n_heads, dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    s = ar.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    o = ar.matmul(torch.softmax(s, dim=-1), v)
    o = o.transpose(1, 2).reshape(b, t, d)
    return ar.matmul(o, p["Wo"]) + p["b"]


def hidden(params, ids, cfg, ar: Arithmetic):
    """The final LayerNorm's output for ids ``[b, t]``."""
    x = params["embed"]["W"][ids.long()]
    for i in range(cfg["num_hidden_layers"]):
        x = x + attention(layer_norm(x, params[f"blk{i}_ln1"]),
                          params[f"blk{i}_attn"],
                          cfg["num_attention_heads"], ar)
        h = layer_norm(x, params[f"blk{i}_ln2"])
        f1, f2 = params[f"blk{i}_ff1"], params[f"blk{i}_ff2"]
        h = torch.relu(ar.matmul(h, f1["W"]) + f1["b"])
        x = x + ar.matmul(h, f2["W"]) + f2["b"]
    return layer_norm(x, params["final_ln"])


def logits(params, ids, cfg, ar: Arithmetic):
    """Logits ``[b, t, V]`` for ids ``[b, t]``."""
    out = params["out"]
    return ar.matmul(hidden(params, ids, cfg, ar), out["W"]) + out["b"]


def summed_loss(logits, labels):
    """Σ over rows and positions of −log softmax(logits)[label]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).sum()
