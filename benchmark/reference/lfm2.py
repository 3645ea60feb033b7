"""Plain PyTorch reference of the hybrid conv/attention LM with sparse
experts that the benchmark runs (Liquid AI's LFM2-MoE, transformers'
``lfm2_moe``): the published layer equations written out again from the
program's parameter tree, in float32 (or the control's arithmetic, every
matrix product through ``ar.matmul``), with no kernel, cache or batching
of the program.

Per decoder layer ``i`` (``layer_types[i]``): ``h = x + op(RMSNorm₁(x))``,
``x' = h + ffn(RMSNorm₂(h))``, RMSNorm ``x·rsqrt(mean(x²) + eps)·w``.

- conv: ``B, C, u = split₃(x·W_in)``; ``z`` = the causal depthwise
  ``conv1d`` of ``B ⊙ u`` (one filter a channel, left padding L − 1, as
  ``torch.nn.functional.conv1d`` with ``groups = d``); ``(C ⊙ z)·W_out``.
- attention: ``q = RMSNorm_q(x·W_q)``, ``k = RMSNorm_k(x·W_k)`` per head,
  rotary positions (rotate-half, base ``rope_theta``) on both, ``v =
  x·W_v``; causal softmax attention with scale ``1/√d_head``, query head
  ``j·r + i`` reading K/V head ``j`` (``r`` = query heads a K/V head),
  computed per K/V head over its group without repeating K/V; ``·W_o``.
- dense FFN (the first ``num_dense_layers``): ``W₂(silu(W₁x) ⊙ W₃x)``.
- MoE: ``s = sigmoid(x·router)`` over every expert; the top
  ``num_experts_per_tok`` of ``s + bias``; the chosen ``s`` normalised to
  sum 1 (+1e-6), times ``routed_scaling_factor``; the output is the sum
  over the held experts ``e`` (``first_expert …``, ``num_experts`` of
  them) of ``w_e · SwiGLU_e(x)`` — the dense formula, every held expert
  on every token with ``w_e = 0`` where ``e`` was not chosen. The experts
  held elsewhere add nothing, as in the program. The selection bias moves
  after each step by ``rate·sign(mean load − load_e)`` over the held
  experts' loads (:func:`next_biases`); it gets no gradient.

After the last layer: RMSNorm, then ``logits = x·W + b``; the loss is the
summed cross-entropy over every position, divided by the batch size.
Each layer runs under ``torch.utils.checkpoint``, and attention over
blocks of queries, each under its own, so that a backward holds one
block's scores at a time ([h, 1,024, t] f32).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import Arithmetic

QUERY_BLOCK = 1024
NORM_EPS = 1e-6


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def short_conv(x, p, ar: Arithmetic):
    b, c, u = ar.matmul(x, p["W_in"]).chunk(3, dim=-1)
    w = p["conv"]                                        # [d, L]
    length, t = w.shape[1], x.shape[1]
    z = F.conv1d((b * u).transpose(1, 2), w[:, None, :],
                 padding=length - 1, groups=w.shape[0])[..., :t]
    return ar.matmul(c * z.transpose(1, 2), p["W_out"])


def rotate(x, base):
    """Rotary positions on ``x [b, t, h, d]`` (rotate-half)."""
    t, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d))
    ang = torch.outer(torch.arange(t, dtype=torch.float64, device=x.device),
                      inv)
    cos = torch.cat([ang.cos(), ang.cos()], -1).to(x.dtype)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1).to(x.dtype)[:, None]
    half = d // 2
    turned = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + turned * sin


def _attend_block(q, k, v, start, ar: Arithmetic):
    """Queries ``q [b, kv, r, n, d]`` at positions ``start …`` against
    every key ``k``/``v [b, kv, t, d]``: ``[b, kv, r, n, d]``."""
    b, kv, r, n, d = q.shape
    t = k.shape[2]
    s = ar.matmul(q.reshape(b, kv, r * n, d), k.transpose(-1, -2))
    s = s.reshape(b, kv, r, n, t) / math.sqrt(d)
    pos = start + torch.arange(n, device=q.device)
    keep = torch.arange(t, device=q.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~keep, float("-inf"))
    prob = torch.softmax(s, dim=-1).reshape(b, kv, r * n, t)
    return ar.matmul(prob, v).reshape(b, kv, r, n, d)


def attention(x, p, cfg, ar: Arithmetic):
    b, t, _ = x.shape
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = p["q_norm"].shape[0]
    eps, base = cfg["norm_eps"], float(cfg["rope_theta"])
    q = rotate(rms_norm(ar.matmul(x, p["Wq"]).view(b, t, h, d),
                        p["q_norm"], eps), base)
    k = rotate(rms_norm(ar.matmul(x, p["Wk"]).view(b, t, kv, d),
                        p["k_norm"], eps), base)
    v = ar.matmul(x, p["Wv"]).view(b, t, kv, d)
    q = q.view(b, t, kv, h // kv, d).permute(0, 2, 3, 1, 4)  # [b,kv,r,t,d]
    k, v = k.transpose(1, 2), v.transpose(1, 2)              # [b,kv,t,d]
    outs = [_ckpt(lambda qb, kk, vv, s=s: _attend_block(qb, kk, vv, s, ar),
                  q[:, :, :, s:s + QUERY_BLOCK], k, v)
            for s in range(0, t, QUERY_BLOCK)]
    o = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(b, t, h * d)
    return ar.matmul(o, p["Wo"])


def swiglu(x, w13, w2, ar: Arithmetic):
    """``W₂(silu(W₁x) ⊙ W₃x)`` with ``W₁``, ``W₃`` the halves of the
    program's ``W13``."""
    w1, w3 = w13.chunk(2, dim=-1)
    return ar.matmul(F.silu(ar.matmul(x, w1)) * ar.matmul(x, w3), w2)


def moe(x, p, bias, cfg, ar: Arithmetic, chosen=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The held experts' part of the layer for ``x [b, t, d]``, and each
    held expert's load (its assignments); ``chosen [b, t, k]`` imposes
    the experts each token is routed to."""
    scores = torch.sigmoid(ar.matmul(x, p["router"]))
    k = cfg["num_experts_per_tok"]
    if chosen is None:
        chosen = torch.topk(scores.detach() + bias, k, dim=-1).indices
    w = scores.gather(-1, chosen)
    w = w / (w.sum(-1, keepdim=True) + NORM_EPS) * cfg["routed_scaling_factor"]
    first = cfg["deployment"]["first_expert"]
    out = torch.zeros_like(x)
    loads = []
    for e in range(p["W13"].shape[0]):
        picked = chosen == first + e
        loads.append(picked.sum())
        w_e = (w * picked).sum(-1, keepdim=True)
        out = out + w_e * swiglu(x, p["W13"][e], p["W2"][e], ar)
    return out, torch.stack(loads)


def _layer(i, x, params, biases, cfg, ar: Arithmetic, routes):
    blk, eps = f"blk{i}", cfg["norm_eps"]
    y = rms_norm(x, params[f"{blk}_norm1"]["gamma"], eps)
    if cfg["layer_types"][i] == "conv":
        h = x + short_conv(y, params[f"{blk}_conv"], ar)
    else:
        h = x + attention(y, params[f"{blk}_attn"], cfg, ar)
    y = rms_norm(h, params[f"{blk}_norm2"]["gamma"], eps)
    if i < cfg["num_dense_layers"]:
        f = params[f"{blk}_ffn"]
        return h + swiglu(y, f["W13"], f["W2"], ar), None
    out, loads = moe(y, params[f"{blk}_moe"], biases[f"{blk}_moe"], cfg, ar,
                     routes.get(f"{blk}_moe"))
    return h + out, loads


def moe_vertices(cfg) -> List[str]:
    return [f"blk{i}_moe" for i in range(cfg["num_dense_layers"],
                                         cfg["num_hidden_layers"])]


def zero_biases(cfg, device) -> Dict[str, torch.Tensor]:
    n = cfg["deployment"]["routed_experts"]
    return {v: torch.zeros(n, device=device) for v in moe_vertices(cfg)}


def logits(params, ids, cfg, ar: Arithmetic, biases: Dict[str, torch.Tensor],
           routes: Optional[Dict[str, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(logits ``[b, t, V]`` for ids ``[b, t]``, each MoE layer's held
    experts' loads) under the selection ``biases``; ``routes`` imposes
    the chosen experts of the MoE layers it names."""
    x = params["embed"]["W"][ids.long()]
    loads = {}
    routes = routes or {}
    for i in range(cfg["num_hidden_layers"]):
        x, load = _ckpt(lambda xx, i=i: _layer(i, xx, params, biases, cfg,
                                               ar, routes), x)
        if load is not None:
            loads[f"blk{i}_moe"] = load
    x = rms_norm(x, params["final_norm"]["gamma"], cfg["norm_eps"])
    out = params["out"]
    return ar.matmul(x, out["W"]) + out["b"], loads


def next_biases(biases, loads, cfg) -> Dict[str, torch.Tensor]:
    """The selection biases after a step with these loads: each held
    expert's entry moves by ``rate·sign(mean load − load)``."""
    rate = cfg["training"]["expert_bias_update_rate"]
    first = cfg["deployment"]["first_expert"]
    out = {}
    for v, b in biases.items():
        load = loads[v].to(b.dtype)
        b = b.clone()
        b[first:first + len(load)] += rate * torch.sign(load.mean() - load)
        out[v] = b
    return out


def summed_loss(logits, labels):
    """Σ over rows and positions of −log softmax(logits)[label]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).sum()
