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
  eviction done on the host by the engine.
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
    through a sentinel table entry go to the trash page. Returns the
    pool."""
    zero_page = pool.shape[0] - 2
    page_size = pool.shape[1]
    slots = write_slots.to(torch.int64)
    p_idx = torch.clamp(torch.div(slots, page_size, rounding_mode="floor"),
                        0, page_table.shape[1] - 1)
    off = torch.remainder(slots, page_size)
    phys = torch.take_along_dim(page_table.to(torch.int64), p_idx, dim=1)
    ok = (slots >= 0) & (phys >= 0) & (phys < zero_page)
    phys = torch.where(ok, phys, zero_page + 1)
    pool.index_put_((phys, off), new.to(pool.dtype))
    return pool


def paged_gather(pool, page_table):
    """Each lane's pages as one contiguous view: ``[S, P·page_size, h,
    d]``. Sentinel entries read the zero page."""
    zero_page = pool.shape[0] - 2
    idx = torch.clamp(page_table.to(torch.int64), 0, zero_page)
    g = pool[idx]
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
