"""Paged KV-cache attention primitives (counterpart of the JAX package's
``ops/paged_attention.py``): gather/scatter and plain PyTorch ops, as the
reference's are gather/scatter and XLA einsums.

Per-layer K/V live in preallocated block pools; each sequence owns an
ordered page table of physical page ids. A decode step scatters the new
tokens' K/V into the pools at (page, offset) and gathers each lane's
pages back into a contiguous ``[window, heads, head_dim]`` view — the
dense streaming cache reassembled — so the attention is the streaming
path's (``nn.conf.attention.causal_cache_attention``).

Layout (shared with ``serving/kv_cache.py`` and ``serving/decode.py``):

- a pool is ``[num_pages + 2, page_size, h, d]``. Row ``num_pages`` is the
  SENTINEL page: unallocated page-table entries point at it, and it stays
  all zeros, so a gathered hole reads exact zeros (as the reference's
  ``mode="fill"`` gather). Row ``num_pages + 1`` is the TRASH page: every
  dropped write (slot ``-1``, or a sentinel table entry) lands there and
  nothing ever reads it. No index ever leaves the pool — on a CUDA tensor
  an out-of-range gather or scatter is a device assert that kills the
  context — and nothing needs a host sync to filter writes, so the fused
  decode loop can call these between two device steps;
- write positions are VIEW-relative slots ``global_pos - base``, where
  ``base`` counts evicted positions; sliding-window overflow is page
  eviction done on the host by the engine;
- an int8 pool (``kv_dtype="int8"``) is a ``(codes, scales)`` tuple:
  ``[num_pages + 2, page_size, h, d]`` int8 codes and ``[num_pages + 2,
  h]`` f32 per-(page, head) quantization steps, quantized on write
  (:func:`paged_write`) and dequantized on gather. The sentinel page's
  scale stays 0; the trash page takes the dropped writes and their amax.
  Every write is in place, so a captured CUDA graph stays valid.
"""

from __future__ import annotations

import torch

from ..nn.conf.attention import causal_cache_attention

__all__ = ["paged_write", "paged_gather", "paged_attention", "pool_rows"]


def pool_rows(num_pages: int) -> int:
    """Rows of a pool over ``num_pages`` allocatable pages: the pages, the
    sentinel (zero) page and the trash page."""
    return int(num_pages) + 2


def paged_write(pool, new, page_table, write_slots):
    """Scatter new K (or V) rows into the pool, in place.

    pool ``[num_pages + 2, page_size, h, d]``; new ``[S, t_new, h, d]``;
    page_table ``[S, P]`` physical page ids; write_slots ``[S, t_new]``
    view-relative slots (``-1`` = dropped). Dropped writes and writes
    through a sentinel table entry go to the trash page. An int8 pool is
    the ``(codes, scales)`` tuple (:func:`_paged_write_q8`). Returns the
    pool."""
    if isinstance(pool, tuple):
        return _paged_write_q8(pool, new, page_table, write_slots)
    phys, off = _write_targets(pool, page_table, write_slots)
    pool.index_put_((phys, off), new.to(pool.dtype))
    return pool


def _write_targets(pool, page_table, write_slots):
    """Physical page and in-page offset of every new row ``[S, t_new]``:
    dropped writes (slot ``-1``, a sentinel table entry) target the trash
    page."""
    codes = pool[0] if isinstance(pool, tuple) else pool
    zero_page = codes.shape[0] - 2
    page_size = codes.shape[1]
    slots = write_slots.to(torch.int64)
    p_idx = torch.clamp(torch.div(slots, page_size, rounding_mode="floor"),
                        0, page_table.shape[1] - 1)
    off = torch.remainder(slots, page_size)
    phys = torch.take_along_dim(page_table.to(torch.int64), p_idx, dim=1)
    ok = (slots >= 0) & (phys >= 0) & (phys < zero_page)
    return torch.where(ok, phys, zero_page + 1), off


def _paged_write_q8(pool, new, page_table, write_slots):
    """The int8 write: ``pool = (codes, scales)``. Scales are monotone per
    (page, head): a write folds the new rows' amax into ``new = max(old,
    amax / 127)`` (a scatter-max), rescales the touched pages' codes by
    ``old / new`` (a page written by several rows is rescaled once per
    row with identical values), then writes the new rows quantized at the
    new step (round half to even, clipped to ±127) — the reference's
    ``_paged_write_q8``, in place."""
    q, scales = pool
    h = q.shape[2]
    phys, off = _write_targets(pool, page_table, write_slots)  # [S, t]
    newf = new.float()
    # 1) fold the new rows' amax into the touched pages' scales
    amax_tok = newf.abs().amax(dim=-1).reshape(-1, h)          # [S·t, h]
    flat = phys.reshape(-1)
    amax_page = torch.zeros_like(scales).scatter_reduce_(
        0, flat[:, None].expand(-1, h), amax_tok, reduce="amax")
    new_scales = torch.maximum(scales, amax_page / 127.0)
    # 2) rescale only the touched pages' codes to the new step
    ratio = torch.where(new_scales > 0, scales / new_scales, 0.0)
    r = ratio[flat][:, None, :, None]
    q.index_put_((flat,), torch.round(q[flat].float() * r).to(torch.int8))
    scales.copy_(new_scales)
    # 3) quantize the new rows at the new step and scatter them in
    s_tok = scales[phys]                                       # [S, t, h]
    rows = torch.round(newf / torch.clamp_min(s_tok[..., None], 1e-30))
    q.index_put_((phys, off), torch.clamp(rows, -127, 127).to(torch.int8))
    return pool


def paged_gather(pool, page_table):
    """Each lane's pages as one contiguous view: ``[S, P·page_size, h,
    d]``. Sentinel entries read the zero page. An int8 pool is
    dequantized here (f32 codes times their page's scale), the one place
    it is read."""
    codes = pool[0] if isinstance(pool, tuple) else pool
    idx = torch.clamp(page_table.to(torch.int64), 0, codes.shape[0] - 2)
    g = codes[idx]
    if isinstance(pool, tuple):
        g = g.float() * pool[1][idx][:, :, None, :, None]
    s, p, page_size, h, d = g.shape
    return g.reshape(s, p * page_size, h, d)


def paged_attention(q, k_view, v_view, rel_pos, scale):
    """Causal attention of new queries over the gathered paged view, with
    the streaming path's math. q ``[S, t_new, h, d]`` (compute dtype);
    k_view/v_view ``[S, W, h, d]`` (cache dtype); rel_pos ``[S]`` the
    view-relative position of each lane's first new query. Returns
    ``[S, t_new, h, d]``."""
    t_new = q.shape[1]
    w = k_view.shape[1]
    q_idx = (rel_pos.to(torch.int64)[:, None]
             + torch.arange(t_new, device=q.device)[None, :])   # [S, t_new]
    allow = (torch.arange(w, device=q.device)[None, None, :]
             <= q_idx[:, :, None])                               # [S, t, W]
    return causal_cache_attention(q, k_view, v_view, allow[:, None], scale)
