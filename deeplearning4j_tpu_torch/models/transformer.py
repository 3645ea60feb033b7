"""Decoder-only transformer LM as a ComputationGraphConfiguration
(counterpart of the JAX package's ``models/transformer.py::transformer_lm``;
it builds the same configuration, so ``to_json`` matches the reference's).

Pre-norm blocks of ``SelfAttentionLayer`` + time-distributed FFN with
``ElementWiseVertex`` residual adds. Two input contracts:
  - default: one-hot [b, t, vocab] inputs;
  - ``input_ids=True``: integer token ids [b, t] through an
    ``EmbeddingSequenceLayer`` gather (the realistic-vocab path).

Autoregressive decode, host side and device side: ``generate`` (the
single-sequence full-cache decode through ``rnn_time_step``, also the
parity oracle of the serving engine), the host sampler ``sample_token``,
``paged_decode_forward`` (one forward over the paged K/V pools) and
``fused_decode_loop`` (N decode steps with on-device sampling and no host
sync), and speculative decoding (``draft_transformer_lm``,
``draft_decode_loop``, ``spec_verify``). ``moe_experts > 0`` replaces
every block's dense FFN with a top-k routed ``MoELayer`` (``{b}_moe``,
``d_hidden = d_ff`` per expert, its load-balancing loss in the training
objective), as the reference builds it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..nn.conf.attention import SelfAttentionLayer
from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.graph import ElementWiseVertex, LayerVertex
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (EmbeddingSequenceLayer, LayerNormalization,
                              RnnOutputLayer)
from ..nn.conf.moe import MoELayer
from ..nn.conf.recurrent import TimeDistributedDenseLayer


def transformer_lm(vocab_size: int, *, n_layers: int = 4,
                   d_model: int = 256, n_heads: int = 4, d_ff: int = 1024,
                   updater: str = "adam", learning_rate: float = 3e-4,
                   seed: int = 42, dtype: str = "float32",
                   moe_experts: int = 0, moe_top_k: int = 2,
                   input_ids: bool = False,
                   max_cache_t: Optional[int] = None):
    """Causal LM: in-proj → n_layers × [ln → attention (+res) → ln → ffn
    (+res)] → final ln → vocab head (softmax)."""
    if d_model % n_heads:
        raise ValueError(f"d_model={d_model} not divisible by "
                         f"n_heads={n_heads}")
    gb = (NeuralNetConfiguration.builder()
          .seed(seed).updater(updater).learning_rate(learning_rate)
          .dtype(dtype)
          .graph_builder()
          .add_inputs("in"))
    if input_ids:
        gb.add_layer("embed",
                     EmbeddingSequenceLayer(n_in=vocab_size, n_out=d_model,
                                            activation="identity"), "in")
    else:
        gb.add_layer("embed",
                     TimeDistributedDenseLayer(n_in=vocab_size,
                                               n_out=d_model,
                                               activation="identity"), "in")
    prev = "embed"
    for i in range(n_layers):
        b = f"blk{i}"
        gb.add_layer(f"{b}_ln1", LayerNormalization(), prev)
        gb.add_layer(f"{b}_attn",
                     SelfAttentionLayer(n_in=d_model, n_out=d_model,
                                        n_heads=n_heads, causal=True,
                                        max_cache_t=max_cache_t),
                     f"{b}_ln1")
        gb.add_vertex(f"{b}_res1", ElementWiseVertex(op="add"),
                      prev, f"{b}_attn")
        gb.add_layer(f"{b}_ln2", LayerNormalization(), f"{b}_res1")
        if moe_experts > 0:
            gb.add_layer(f"{b}_moe",
                         MoELayer(n_in=d_model, n_out=d_model, d_hidden=d_ff,
                                  n_experts=moe_experts, top_k=moe_top_k),
                         f"{b}_ln2")
            ff_out = f"{b}_moe"
        else:
            gb.add_layer(f"{b}_ff1",
                         TimeDistributedDenseLayer(n_in=d_model, n_out=d_ff,
                                                   activation="relu"),
                         f"{b}_ln2")
            gb.add_layer(f"{b}_ff2",
                         TimeDistributedDenseLayer(n_in=d_ff, n_out=d_model,
                                                   activation="identity"),
                         f"{b}_ff1")
            ff_out = f"{b}_ff2"
        gb.add_vertex(f"{b}_res2", ElementWiseVertex(op="add"),
                      f"{b}_res1", ff_out)
        prev = f"{b}_res2"
    gb.add_layer("final_ln", LayerNormalization(), prev)
    gb.add_layer("out", RnnOutputLayer(
        n_in=d_model, n_out=vocab_size, activation="softmax",
        loss="sparse_mcxent" if input_ids else "mcxent"), "final_ln")
    gb.set_outputs("out")
    gb.set_input_types(InputType.recurrent(1 if input_ids else vocab_size))
    return gb.build()


# --------------------------------------------------------------------------
# autoregressive decode
# --------------------------------------------------------------------------


def attention_vertices(net) -> List[str]:
    """Topo-ordered names of the net's causal ``SelfAttentionLayer``
    vertices — the layers that own a K/V cache (dense or paged) during
    decode."""
    names = []
    for name in net.topo_order:
        v = net.conf.vertices[name]
        layer = v.layer if isinstance(v, LayerVertex) else None
        if isinstance(layer, SelfAttentionLayer) and layer.causal:
            names.append(name)
    return names


def filtered_probs_host(p: np.ndarray, temperature: float, top_k: int,
                        top_p: float) -> np.ndarray:
    """Host mirror of ``ops.sampling.filtered_probs`` for ONE row: the same
    temperature → top-k → renormalize → top-p → renormalize order and the
    same stable lower-id tie-breaking, in float64."""
    logits = np.log(np.maximum(p, 1e-30)) / float(temperature)
    logits -= logits.max()
    w = np.exp(logits)
    order = np.argsort(-w, kind="stable")
    if top_k and top_k > 0:
        w[order[int(top_k):]] = 0.0
    w /= max(w.sum(), 1e-30)
    if 0.0 < top_p < 1.0:
        w_desc = w[order]
        before = np.cumsum(w_desc) - w_desc
        w[order[before >= top_p]] = 0.0
        w /= max(w.sum(), 1e-30)
    return w


def sample_token(probs, temperature: float = 0.0, rng=None, *,
                 top_k: int = 0, top_p: float = 1.0) -> int:
    """Next token from a softmax row, on the host in float64 — shared by
    :func:`generate` and the ticked serving engine. ``temperature <= 0``
    is greedy (argmax, ties to the lower id); otherwise an inverse-CDF
    draw at one uniform from ``rng`` (a ``numpy.random.Generator``) over
    the filtered distribution — the semantics of the device sampler
    ``ops.sampling.sample_tokens``."""
    p = np.asarray(probs, dtype=np.float64).reshape(-1)
    if temperature <= 0.0:
        return int(np.argmax(p))
    if rng is None:
        raise ValueError("temperature sampling needs an rng")
    w = filtered_probs_host(p, temperature, top_k, top_p)
    c = np.cumsum(w)
    gt = c > float(rng.random()) * c[-1]
    if gt.any():
        return int(np.argmax(gt))
    # u·total reached the top of the CDF (float rounding only): the same
    # last-positive-weight fallback as the device twin
    return int(np.max(np.nonzero(w > 0)[0]))


def _last_row(out) -> np.ndarray:
    """The last position's distribution of a ``[1, t, V]`` output, on the
    host (bf16 widens exactly)."""
    return out[0, -1].float().cpu().numpy()


def generate(net, prompt_ids, max_new_tokens: int, *,
             temperature: float = 0.0, eos_id: Optional[int] = None,
             rng=None, top_k: int = 0, top_p: float = 1.0) -> np.ndarray:
    """Single-sequence full-cache autoregressive decode through the
    streaming ``rnn_time_step`` path — the offline API and the oracle the
    paged serving engine is held against.

    The net must be an ids-mode ``transformer_lm`` built with
    ``max_cache_t``. The first window of the prompt goes in one chunk and
    any tail past it token by token (eviction is chunk-granular, so this
    gives every position the exact sliding window). Returns the generated
    ids as int32 (≤ ``max_new_tokens``; stops at ``eos_id``, which is
    included)."""
    from ..util.netutil import streaming_cache_limit
    limit = streaming_cache_limit(net)
    if limit is None:
        raise ValueError(
            "generate() needs streaming K/V caches — build the net with "
            "transformer_lm(..., max_cache_t=...)")
    prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
    if prompt.size < 1:
        raise ValueError("generate() needs a non-empty prompt")
    net.rnn_clear_previous_state()
    first = min(len(prompt), limit)
    out = net.rnn_time_step(prompt[None, :first, None])
    for i in range(first, len(prompt)):
        out = net.rnn_time_step(prompt[None, i:i + 1, None])
    probs = _last_row(out)
    toks: List[int] = []
    for i in range(int(max_new_tokens)):
        t = sample_token(probs, temperature, rng, top_k=top_k, top_p=top_p)
        toks.append(t)
        if (eos_id is not None and t == eos_id) \
                or i == int(max_new_tokens) - 1:
            break
        probs = _last_row(net.rnn_time_step(np.full((1, 1, 1), t,
                                                    np.int32)))
    return np.asarray(toks, np.int32)


def oracle_stream_probs(net, token_ids) -> np.ndarray:
    """Per-position next-token distributions from the dense full-cache
    streaming path, fed with :func:`generate`'s schedule (first window in
    one chunk, the tail token by token): ``[len(token_ids), V]`` float64,
    row i the distribution of the token FOLLOWING position i."""
    from ..util.netutil import streaming_cache_limit
    limit = streaming_cache_limit(net)
    if limit is None:
        raise ValueError(
            "oracle_stream_probs() needs streaming K/V caches — build "
            "the net with transformer_lm(..., max_cache_t=...)")
    ids = np.asarray(token_ids, np.int32).reshape(-1)
    if ids.size < 1:
        raise ValueError("oracle_stream_probs() needs at least one token")
    net.rnn_clear_previous_state()
    first = min(len(ids), limit)
    rows = [net.rnn_time_step(ids[None, :first, None])[0].double().cpu()]
    for i in range(first, len(ids)):
        step = net.rnn_time_step(ids[None, i:i + 1, None])
        rows.append(step[0].double().cpu())
    return torch.cat(rows, dim=0).numpy()


def paged_decode_forward(net, params, k_pools, v_pools, ids, page_tables,
                         write_slots, rel_pos):
    """ONE forward of an ids-mode ``transformer_lm`` graph in paged-decode
    mode: every causal attention vertex reads and writes the block pools
    through the lanes' page tables (``SelfAttentionLayer.apply_paged``);
    every other vertex applies as in ``output()``. Tensors on the net's
    device; reads nothing back to the host.

    ids ``[S, t_new]`` (padded lanes: any value — their writes are dropped
    and their outputs ignored); page_tables ``[S, P]``; write_slots
    ``[S, t_new]`` (-1 = dropped); rel_pos ``[S]``. Returns ``(probs
    [S, t_new, V], k_pools, v_pools)``; the pools are written in place."""
    attn = attention_vertices(net)
    if len(attn) != len(k_pools):
        raise ValueError(
            f"{len(k_pools)} pools for {len(attn)} attention vertices")
    pool_ix = {n: i for i, n in enumerate(attn)}
    k_pools, v_pools = list(k_pools), list(v_pools)
    acts = {net.conf.network_inputs[0]: ids[:, :, None]}
    for name in net.topo_order:
        in_names = net.conf.vertex_inputs[name]
        i = pool_ix.get(name)
        v = net.conf.vertices[name]
        if i is not None:
            out, k_pools[i], v_pools[i] = v.layer.apply_paged(
                params[name], acts[in_names[0]], k_pools[i], v_pools[i],
                page_tables, write_slots, rel_pos, policy=net.policy)
        else:
            out, _ = v.apply(params[name], [acts[n] for n in in_names],
                             state=None, policy=net.policy,
                             masks=[None] * len(in_names))
        acts[name] = out
    return acts[net.conf.network_outputs[0]], k_pools, v_pools


def fused_decode_loop(net, params, k_pools, v_pools, last_tokens,
                      page_tables, rel_pos, active, budget, eos_ids,
                      temperature, top_k, top_p, uniforms, *,
                      any_sampled: bool):
    """N decode steps over the paged arena with no host sync (N =
    ``uniforms.shape[1]``). Each step writes every lane's pending token's
    K/V, runs one paged forward (t_new = 1, the ticked step's math),
    picks the next token on the device (greedy argmax, or the filtered
    inverse CDF at that step's host-drawn uniform), and folds the
    EOS/budget self-retire mask: a finished lane keeps computing (fixed
    shapes) but its writes turn to ``-1`` slots (dropped) and its outputs
    are marked invalid.

    The reference runs this as a ``lax.while_loop`` that exits once every
    lane is done. Exiting early here would need the host to read ``done``
    — a sync per step — so the port always runs all N steps. The extra
    steps write nothing and emit nothing: ``tokens``, ``valid`` and
    ``n_emitted`` are the same. ``any_sampled`` is the host's knowledge of
    whether any lane has ``temperature > 0`` (the reference's device-side
    ``lax.cond``); an all-greedy block skips the filter pipeline.

    last_tokens ``[S]`` each lane's pending token; rel_pos ``[S]`` its
    view-relative slot (the host pre-draws pages for the whole block);
    active ``[S]`` (padded lanes start retired); budget ``[S]`` tokens the
    lane may still emit; eos_ids ``[S]`` (-1 = none). Returns ``(tokens
    [S, N], valid [S, N], n_emitted [S], done [S], k_pools, v_pools)``,
    all on the device."""
    from ..ops import sampling as _sampling
    n_steps = uniforms.shape[1]
    s = last_tokens.shape[0]
    dev = last_tokens.device
    cur = last_tokens.to(torch.int32)
    done = ~active
    n_emitted = torch.zeros(s, dtype=torch.int32, device=dev)
    toks = torch.full((s, n_steps), -1, dtype=torch.int32, device=dev)
    valid = torch.zeros((s, n_steps), dtype=torch.bool, device=dev)
    rel = rel_pos.to(torch.int32)
    for i in range(n_steps):
        slot = torch.where(done, -1, rel + i)
        probs, k_pools, v_pools = paged_decode_forward(
            net, params, k_pools, v_pools, cur[:, None], page_tables,
            slot[:, None], rel + i)
        row = probs[:, 0, :]
        if any_sampled:
            tok = _sampling.sample_tokens(row, temperature, top_k, top_p,
                                          uniforms[:, i])
        else:
            tok = torch.argmax(row, dim=-1).to(torch.int32)
        emit = ~done
        n_emitted = n_emitted + emit.to(torch.int32)
        hit_eos = (eos_ids >= 0) & (tok == eos_ids)
        done = done | (emit & (hit_eos | (n_emitted >= budget)))
        cur = torch.where(emit, tok, cur)
        toks[:, i] = torch.where(emit, tok, -1)
        valid[:, i] = emit
    return toks, valid, n_emitted, done, k_pools, v_pools


def draft_transformer_lm(vocab_size: int, *, d_model: int = 128,
                         n_heads: int = 4, d_ff: int = 512,
                         seed: int = 42, dtype: str = "float32",
                         max_cache_t: Optional[int] = None):
    """The draft model family of speculative decoding: a 2-layer ids-mode
    :func:`transformer_lm` over the SAME vocabulary as the target it
    drafts for (same input contract and softmax head, so its filtered
    distributions compare directly in the accept/reject step). The
    serving engine requires only a matching vocabulary and window."""
    return transformer_lm(vocab_size, n_layers=2, d_model=d_model,
                          n_heads=n_heads, d_ff=d_ff, seed=seed,
                          dtype=dtype, input_ids=True,
                          max_cache_t=max_cache_t)


def draft_decode_loop(net, params, k_pools, v_pools, last_tokens,
                      page_tables, rel_pos, active, write_budget,
                      temperature, top_k, top_p, uniforms, *,
                      any_sampled: bool):
    """The draft half of a speculative block: K+1 steps of the draft net
    over ITS OWN pools through the SHARED page tables (``uniforms [S,
    K+1]``). The steps feed ``[pending, d_1 .. d_K]``, so the draft writes
    K/V for all K+1 inputs, ``d_K`` included (its output is discarded):
    target and draft frontiers advance in lockstep, and rejected tokens'
    stale K/V sits beyond the causal mask until overwritten.

    ``write_budget [S]`` caps each lane's writes at the tokens it may still
    emit: slots past ``rel_pos + write_budget - 1`` are dropped, so a lane
    near its max-tokens or the window edge never forces a page draw or an
    eviction for tokens that cannot exist. ``any_sampled`` is the host's
    knowledge of whether any lane samples (the reference's ``lax.cond``):
    an all-greedy block skips the filter pipeline and returns zero
    distributions, which the greedy verify never reads.

    Returns ``(draft_tokens [S, K], draft_dists [S, K, V], k_pools,
    v_pools)`` on the device; ``draft_dists`` are the FILTERED
    distributions the draft sampled from."""
    from ..ops import sampling as _sampling
    k1 = uniforms.shape[1]                  # K + 1
    rel = rel_pos.to(torch.int32)
    cur = last_tokens.to(torch.int32)
    toks, dists = [], []
    for i in range(k1):
        slot = torch.where(active & (i < write_budget), rel + i, -1)
        probs, k_pools, v_pools = paged_decode_forward(
            net, params, k_pools, v_pools, cur[:, None], page_tables,
            slot[:, None], rel + i)
        if i == k1 - 1:
            break                           # d_K's K/V is all this step adds
        row = probs[:, 0, :]
        greedy = torch.argmax(row, dim=-1).to(torch.int32)
        if any_sampled:
            dist = _sampling.filtered_probs(row, temperature, top_k, top_p)
            cur = torch.where(temperature > 0,
                              _sampling.inverse_cdf(dist, uniforms[:, i]),
                              greedy)
        else:
            dist = torch.zeros(row.shape, dtype=torch.float32,
                               device=row.device)
            cur = greedy
        toks.append(cur)
        dists.append(dist)
    return (torch.stack(toks, dim=1), torch.stack(dists, dim=1), k_pools,
            v_pools)


def spec_verify(net, params, k_pools, v_pools, last_tokens, page_tables,
                rel_pos, active, write_budget, draft_tokens, draft_dists,
                temperature, top_k, top_p, u_accept, u_fix, *,
                any_sampled: bool):
    """The verify half of a speculative block: ONE target pass over
    ``[pending, d_1 .. d_K]`` (K+1 positions; the paged chunk forward
    equals feeding them one at a time, which is what makes greedy
    speculative output equal target-only decode), then accept/reject and
    the bonus on the device (Leviathan et al.):

    - greedy lanes (``temperature <= 0``): accept ``d_i`` iff it equals the
      target argmax at its position; the first mismatch emits the target
      argmax instead; a fully accepted block emits the position-K argmax
      as the bonus token;
    - sampled lanes: accept ``d_i`` with probability ``min(1, q(d_i) /
      p(d_i))`` (filtered target over filtered draft) at ``u_accept[:,
      i]``; the first rejection samples the residual ``max(q - p, 0)``
      (``q`` when the residual has no mass) at ``u_fix``; the bonus is a
      draw from the filtered position-K target distribution.

    ``any_sampled`` is the host's greedy/sampled key axis (the reference's
    ``lax.cond``); ``write_budget`` caps writes as in
    :func:`draft_decode_loop`. Returns ``(emitted [S, K+1], valid [S,
    K+1], accepts [S], k_pools, v_pools)``: ``valid[:, j] = j <=
    accepts`` on active lanes; the host truncates at EOS/max-tokens."""
    from ..ops import sampling as _sampling
    s, k = draft_tokens.shape
    k1 = k + 1
    dev = draft_tokens.device
    draft = draft_tokens.to(torch.int32)
    rel = rel_pos.to(torch.int32)
    ids = torch.cat([last_tokens.to(torch.int32)[:, None], draft], dim=1)
    offs = torch.arange(k1, dtype=torch.int32, device=dev)[None, :]
    wslots = torch.where(active[:, None] & (offs < write_budget[:, None]),
                         rel[:, None] + offs, -1)
    probs, k_pools, v_pools = paged_decode_forward(
        net, params, k_pools, v_pools, ids, page_tables, wslots, rel)
    v = probs.shape[-1]
    t_hat = torch.argmax(probs, dim=-1).to(torch.int32)      # [S, K+1]
    accept = draft == t_hat[:, :k]
    fix = t_hat
    if any_sampled:
        def rep(a):                  # each lane's value K+1 times
            return a[:, None].expand(s, k1).reshape(s * k1)
        q = _sampling.filtered_probs(probs.reshape(s * k1, v),
                                     rep(temperature), rep(top_k),
                                     rep(top_p)).reshape(s, k1, v)
        q_d = torch.take_along_dim(q[:, :k], draft[:, :, None].long(),
                                   dim=-1)[..., 0]           # [S, K]
        p_d = torch.take_along_dim(draft_dists, draft[:, :, None].long(),
                                   dim=-1)[..., 0]
        acc_sampled = u_accept < torch.clamp_max(
            q_d / torch.clamp_min(p_d, 1e-30), 1.0)
        resid = torch.clamp_min(q[:, :k] - draft_dists, 0.0)
        has_mass = resid.sum(dim=-1, keepdim=True) > 0
        resid = torch.where(has_mass, resid, q[:, :k])
        fix_dist = torch.cat([resid, q[:, k:]], dim=1)       # [S, K+1, V]
        fix_sampled = _sampling.inverse_cdf(
            fix_dist.reshape(s * k1, v), u_fix.reshape(s * k1)
        ).reshape(s, k1)
        greedy = (temperature <= 0)[:, None]
        accept = torch.where(greedy, accept, acc_sampled)
        fix = torch.where(greedy, t_hat, fix_sampled)
    accepts = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)                                          # [S] 0..K
    fix_at_a = torch.take_along_dim(fix, accepts[:, None].long(), dim=1)
    d_pad = torch.cat([draft, torch.zeros((s, 1), dtype=torch.int32,
                                          device=dev)], dim=1)
    j = torch.arange(k1, dtype=torch.int32, device=dev)[None, :]
    emitted = torch.where(j < accepts[:, None], d_pad,
                          torch.where(j == accepts[:, None], fix_at_a, -1))
    valid = (j <= accepts[:, None]) & active[:, None]
    return emitted, valid, accepts, k_pools, v_pools
