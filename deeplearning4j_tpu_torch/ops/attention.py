"""Attention ops (counterpart of the JAX package's ``ops/attention.py``):
single-device attention and ring attention (sequence parallelism over a
process group).

Ring attention follows the public recipe: blockwise online-softmax
accumulation while K/V shards rotate around the ``seq`` mesh dim, so the
sequence length scales with the number of devices. Its flash route runs
every hop through the hand-written kernels (``flash_attention_block`` /
``flash_attention_bwd_block``); its plain route is the JAX package's
``_block_attend`` loop, differentiated by autograd.

Shapes: q/k/v are [batch, time, heads, head_dim] ("BTHD").
"""

from __future__ import annotations

import contextvars
import math
import os
from typing import Optional

import torch


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          scale: Optional[float] = None):
    """Standard softmax attention, single program. [b,t,h,d] → [b,t,h,d].

    mask: optional [b, t_kv] key-validity mask (1=attend).

    Calls that ``flash_attention.flash_available`` routes there go to the
    flash path: the hand-written CUDA kernels on the card (under auto only
    what they take), its plain blockwise version on the CPU.
    ``DL4JTPU_FLASH_ATTENTION=1`` forces it on, ``0`` forces this dense
    path."""
    from .flash_attention import flash_attention, flash_available
    if q.ndim == 4 and q.shape == k.shape == v.shape \
            and flash_available(q, mask):
        return flash_attention(q, k, v, causal, scale, mask=mask)
    d = q.shape[-1]
    if scale is None:
        # the reference rounds sqrt(d) to the activation dtype first
        scale = 1.0 / torch.tensor(math.sqrt(d), dtype=q.dtype).item()
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        causal_mask = torch.ones((tq, tk), dtype=torch.bool,
                                 device=q.device).tril(diagonal=tk - tq)
        logits = torch.where(causal_mask[None, None], logits, neg_inf)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, neg_inf)
    # manual stable softmax so a query with NO attendable keys (all -inf —
    # e.g. leading padded step under a causal mask) outputs 0, not NaN
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.where(torch.isneginf(logits), torch.zeros_like(logits),
                    torch.exp(logits - m_safe))
    weights = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _block_attend(q, k, v, m_prev, num_prev, den_prev, *, scale,
                  q_offset, k_offset, causal, key_mask=None):
    """One K/V block of online-softmax accumulation (the JAX package's
    ``_block_attend``, the ring's plain route).

    m/num/den carry the running max [b,h,tq], weighted-value numerator
    [b,h,tq,d] and normalizer [b,h,tq]; q_offset/k_offset are the global
    time offsets of the local q block and the current k block (causal
    masking across hops); key_mask: optional [b, tk] validity of THIS k
    block's keys."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale   # [b,h,tq,tk]
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qi = q_offset + torch.arange(tq, device=q.device)
        ki = k_offset + torch.arange(tk, device=q.device)
        allow = qi[:, None] >= ki[None, :]
        logits = torch.where(allow[None, None], logits, neg_inf)
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :] > 0, logits, neg_inf)
    m_new = torch.maximum(m_prev, logits.amax(dim=-1))     # [b,h,tq]
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(torch.isneginf(logits), 0.0, p)
    correction = torch.where(torch.isneginf(m_prev), 0.0,
                             torch.exp(m_prev - m_safe))
    num = (num_prev * correction[..., None]
           + torch.einsum("bhqk,bkhd->bhqd", p, v))
    den = den_prev * correction + p.sum(dim=-1)
    return m_new, num, den


def ring_flash_available(t_local: int, device, head_dim: int) -> bool:
    """Should the ring run its hops through the flash kernels?

    ``DL4JTPU_FLASH_ATTENTION=1`` forces the flash route (on the CPU its
    entries run the kernels' plain versions; on the card a head dim the
    kernels do not take raises), ``0`` forces the plain online-softmax
    route; unset = auto, which is the flash route on CUDA when the kernels
    take the hops and the plain route otherwise. The hops run in f32 and
    a shard that is not a multiple of 128 is padded at its end under the
    key mask, so only the head dim decides (64 or 128). (The JAX
    package's auto rule, t_local ≥ 1024 on a TPU, was set on a TPU and
    does not carry over.)"""
    from .flash_attention import HEAD_DIMS
    del t_local
    flag = os.environ.get("DL4JTPU_FLASH_ATTENTION", "auto")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return torch.device(device).type == "cuda" and head_dim in HEAD_DIMS


# --------------------------------------------------------------------------
# the hop schedule
# --------------------------------------------------------------------------
#
# Hop i of a ring of n over the time axis: rank ``idx`` holds the k/v
# shard born on rank ``src = (idx - i) mod n``. A causal pair is wholly
# before the diagonal (src < idx: the non-causal kernel), on it (src ==
# idx: the causal kernel) or wholly after it (src > idx: no kernel). The
# schedule is one function, apart from how shards travel, so a real ring
# over a process group and the virtual ring of one process run the same
# block pairs in the same order.

FULL, DIAG, SKIP = "full", "diag", "skip"


def hop_schedule(idx: int, n: int, causal: bool):
    """[(src, kind)] for hops 0..n-1 of rank ``idx`` in a ring of ``n``;
    kind is ``"full"``, ``"diag"`` or ``"skip"``."""
    out = []
    for i in range(n):
        src = (idx - i) % n
        if not causal or src < idx:
            out.append((src, FULL))
        elif src == idx:
            out.append((src, DIAG))
        else:
            out.append((src, SKIP))
    return out


def _hop_fwd(q32, kb, vb, mb, carry, kind, scale):
    from .flash_attention import flash_attention_block
    if kind == SKIP:
        return carry
    return flash_attention_block(q32, kb, vb, carry, causal=kind == DIAG,
                                 scale=scale, mask=mb)


def _hop_bwd(q32, kb, vb, mb, out32, lse, g32, kind, scale):
    from .flash_attention import flash_attention_bwd_block
    return flash_attention_bwd_block(q32, kb, vb, out32, lse, g32,
                                     causal=kind == DIAG, scale=scale,
                                     mask=mb)


# --------------------------------------------------------------------------
# ring over a process group
# --------------------------------------------------------------------------


def _ring_flash_fwd(q32, k32, v32, mask, group, causal, scale):
    from ..parallel.collectives import group_rank, group_size, shift
    from .flash_attention import flash_carry_finalize, flash_carry_init
    n, idx = group_size(group), group_rank(group)
    carry = flash_carry_init(q32)
    kb, vb, mb = k32, v32, mask
    for i, (_, kind) in enumerate(hop_schedule(idx, n, causal)):
        carry = _hop_fwd(q32, kb, vb, mb, carry, kind, scale)
        if i + 1 < n:
            kb, vb, mb = shift([kb, vb, mb], group)
    return flash_carry_finalize(carry)


def _ring_flash_bwd(q32, k32, v32, mask, out32, lse, g32, group, causal,
                    scale):
    """dq accumulates on this rank; the dk/dv accumulators travel WITH
    their k/v shard and arrive home after the full rotation."""
    from ..parallel.collectives import group_rank, group_size, shift
    n, idx = group_size(group), group_rank(group)
    dq = torch.zeros_like(q32)
    dk = torch.zeros_like(k32)
    dv = torch.zeros_like(v32)
    kb, vb, mb = k32, v32, mask
    for i, (_, kind) in enumerate(hop_schedule(idx, n, causal)):
        if kind != SKIP:
            dq_h, dk_h, dv_h = _hop_bwd(q32, kb, vb, mb, out32, lse, g32,
                                        kind, scale)
            dq = dq + dq_h
            dk = dk + dk_h
            dv = dv + dv_h
        if i + 1 < n:
            kb, vb, mb, dk, dv = shift([kb, vb, mb, dk, dv], group)
        else:
            dk, dv = shift([dk, dv], group)
    return dq, dk, dv


def _f32(x):
    x = x.float()
    return x if x.stride(-1) == 1 else x.contiguous()


class _RingFlash(torch.autograd.Function):
    """The flash route's VJP: the forward ring of per-hop kernel calls
    folded into the carry, the backward a second ring of per-hop backward
    kernels against the global lse. Hops run in f32 (q, k, v and the
    cotangent cast up, as the JAX package casts them)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, causal, scale):
        out32, lse = _ring_flash_fwd(_f32(q), _f32(k), _f32(v), mask, group,
                                     causal, scale)
        ctx.save_for_backward(q, k, v, mask, out32, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out32, lse = ctx.saved_tensors
        dq, dk, dv = _ring_flash_bwd(_f32(q), _f32(k), _f32(v), mask, out32,
                                     lse, _f32(g), ctx.group, ctx.causal,
                                     ctx.scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _pad_shards(q, k, v, mask):
    """Pad the END of each shard to the kernels' 128-row granule, the
    padded keys masked out (the hop trichotomy compares shard indices
    only, so global causal order is kept). Returns (q, k, v, mask, pad)."""
    from .flash_attention import BLOCK
    b, t_local = q.shape[:2]
    pad = (-t_local) % BLOCK
    if mask is None and pad:
        mask = torch.ones((b, t_local), dtype=torch.float32, device=q.device)
    if mask is not None:
        mask = mask.to(dtype=torch.float32).contiguous()
    if pad:
        widths = (0, 0, 0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(x, widths) for x in (q, k, v))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return q, k, v, mask, pad


def _ring_flash_attention(q, k, v, mask, *, group, causal: bool,
                          scale: Optional[float]):
    """Flash-kernel ring attention on the LOCAL shards; ragged shards are
    padded here, outside the VJP."""
    t_local = q.shape[1]
    scale = _resolve_flash_scale(scale, q.shape[-1])
    q, k, v, mask, pad = _pad_shards(q, k, v, mask)
    out = _RingFlash.apply(q, k, v, mask, group, bool(causal), scale)
    return out[:, :t_local] if pad else out


def _plain_scale(scale, d, dtype):
    # the JAX package rounds sqrt(d) to the activation dtype first
    return (scale if scale is not None
            else 1.0 / torch.tensor(math.sqrt(d), dtype=dtype).item())


def _ring_plain(q, k, v, mask, group, causal, scale):
    """The plain route: online softmax over the visiting blocks, the K/V
    shards moved by a differentiable shift (autograd carries the backward
    around the ring)."""
    from ..parallel.collectives import group_rank, group_size, ppermute, shift
    n, idx = group_size(group), group_rank(group)
    b, t_local, h, d = q.shape
    scale = _plain_scale(scale, d, q.dtype)
    q32 = q.float()
    m = torch.full((b, h, t_local), float("-inf"), dtype=torch.float32,
                   device=q.device)
    num = torch.zeros((b, h, t_local, d), dtype=torch.float32,
                      device=q.device)
    den = torch.zeros((b, h, t_local), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    mb = None if mask is None else mask.to(torch.float32).contiguous()
    for i in range(n):
        src = (idx - i) % n
        m, num, den = _block_attend(
            q32, kb.float(), vb.float(), m, num, den, scale=scale,
            q_offset=idx * t_local, k_offset=src * t_local, causal=causal,
            key_mask=mb)
        if i + 1 < n:
            kb, vb = ppermute([kb, vb], group)
            if mb is not None:
                mb, = shift([mb], group)
    out = num / torch.clamp(den[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q, k, v, *, group, causal: bool = False,
                   scale: Optional[float] = None, mask=None,
                   impl: Optional[str] = None):
    """Ring attention over the process group ``group`` (the ``seq`` mesh
    dim's): each rank holds a [b, t_local, h, d] shard of q/k/v (the
    global sequence split in rank order). K/V shards travel around the
    ring (``batch_isend_irecv`` per hop) while each rank accumulates its
    local queries' attention online — full-sequence attention without
    the [t, t] matrix or a gather of the sequence.

    ``mask``: optional [b, t_local] key-validity shard; it travels WITH
    its K/V shard, and fully masked query rows give 0. ``impl``:
    ``"flash"`` runs every hop through the flash kernels, forward and
    backward; ``"jax"`` (the JAX package's name for it) the plain
    online-softmax block; None routes by :func:`ring_flash_available`."""
    if impl is None:
        impl = ("flash" if ring_flash_available(q.shape[1], q.device,
                                                q.shape[-1]) else "jax")
    if impl == "flash":
        return _ring_flash_attention(q, k, v, mask, group=group,
                                     causal=causal, scale=scale)
    if impl != "jax":
        raise ValueError(f"impl must be 'flash', 'jax' or None, got {impl!r}")
    return _ring_plain(q, k, v, mask, group, causal, scale)


def make_ring_attention(mesh, axis_name: str = "seq", *,
                        causal: bool = False, batch_axis: Optional[str] = None,
                        with_mask: bool = False):
    """Ring attention over the mesh dim ``axis_name``: ``fn(q, k, v)`` (or
    ``fn(q, k, v, mask)`` with ``with_mask=True``) on this rank's LOCAL
    [b, t_local, h, d] shards. ``batch_axis`` names the dim the batch is
    data-parallel over; each of its slices has its own ring, which the
    mesh's per-dim groups give already."""
    from ..parallel.mesh import axis_group
    del batch_axis
    group = axis_group(mesh, axis_name)
    if with_mask:
        def fn(q, k, v, mask):
            return ring_attention(q, k, v, group=group, causal=causal,
                                  mask=mask)
        return fn

    def fn(q, k, v):
        return ring_attention(q, k, v, group=group, causal=causal)
    return fn


# --------------------------------------------------------------------------
# the virtual ring: n shards in one process
# --------------------------------------------------------------------------


def virtual_ring_fwd(q, k, v, mask, n: int, *, causal: bool,
                     scale: Optional[float] = None):
    """The flash ring's forward over ``n`` time shards of GLOBAL
    [b, t, h, d] f32 arrays in one process: (out [b, t, h, d], lse
    [b, t, h]), f32. Hop by hop, each shard's carry sees the block pairs
    the real ring gives its rank, in the same order, through the same
    entries (the kernels on CUDA). t/n must suit the kernels."""
    from .flash_attention import flash_carry_finalize, flash_carry_init
    scale = _resolve_flash_scale(scale, q.shape[-1])
    qs, ks, vs = (x.chunk(n, dim=1) for x in (q, k, v))
    ms = [None] * n if mask is None else mask.float().chunk(n, dim=1)
    ms = [None if m is None else m.contiguous() for m in ms]
    carries = [flash_carry_init(qs[r]) for r in range(n)]
    for i in range(n):
        for idx in range(n):
            src, kind = hop_schedule(idx, n, causal)[i]
            carries[idx] = _hop_fwd(qs[idx], ks[src], vs[src], ms[src],
                                    carries[idx], kind, scale)
    outs, lses = zip(*(flash_carry_finalize(c) for c in carries))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def virtual_ring_bwd(q, k, v, mask, out, lse, dout, n: int, *,
                     causal: bool, scale: Optional[float] = None):
    """The flash ring's backward over ``n`` shards in one process: (dq,
    dk, dv) f32, each shard's dk/dv summed in the order its accumulator
    meets the ranks on the real ring."""
    scale = _resolve_flash_scale(scale, q.shape[-1])
    qs, ks, vs, os_, gs = (x.chunk(n, dim=1) for x in (q, k, v, out, dout))
    lses = lse.chunk(n, dim=1)
    ms = [None] * n if mask is None else mask.float().chunk(n, dim=1)
    ms = [None if m is None else m.contiguous() for m in ms]
    dq = [torch.zeros_like(x) for x in qs]
    dk = [torch.zeros_like(x) for x in ks]
    dv = [torch.zeros_like(x) for x in vs]
    for i in range(n):
        for idx in range(n):
            src, kind = hop_schedule(idx, n, causal)[i]
            if kind == SKIP:
                continue
            dq_h, dk_h, dv_h = _hop_bwd(qs[idx], ks[src], vs[src], ms[src],
                                        os_[idx], lses[idx], gs[idx], kind,
                                        scale)
            dq[idx] = dq[idx] + dq_h
            dk[src] = dk[src] + dk_h
            dv[src] = dv[src] + dv_h
    return tuple(torch.cat(x, dim=1) for x in (dq, dk, dv))


def _resolve_flash_scale(scale, d):
    return float(scale) if scale is not None else 1.0 / float(d) ** 0.5


# --------------------------------------------------------------------------
# sequence-sharding context: how DSL layers discover an active seq mesh
# --------------------------------------------------------------------------

_SEQ_SHARDING = contextvars.ContextVar("seq_sharding", default=None)


class sequence_sharding:
    """Context that routes ``SelfAttentionLayer`` to ring attention over
    ``seq_axis``. The JAX package reads it at trace time; the port reads
    it at call time, so a sharded trainer enters it around its step and
    the same model object used outside keeps its single-device route. It
    is a context variable: it holds in the thread that entered it only,
    so another thread's forward during the step is not routed into the
    ring."""

    def __init__(self, mesh, seq_axis: str = "seq",
                 batch_axis: Optional[str] = None):
        self.value = (mesh, seq_axis, batch_axis)

    def __enter__(self):
        self._token = _SEQ_SHARDING.set(self.value)
        return self

    def __exit__(self, *exc):
        _SEQ_SHARDING.reset(self._token)
        return False


def active_sequence_sharding() -> Optional[tuple]:
    """(mesh, seq_axis, batch_axis) if a sequence_sharding context is
    active in this thread, else None."""
    return _SEQ_SHARDING.get()
