"""Continuous-batching autoregressive decode over a paged KV arena
(counterpart of the JAX package's ``serving/decode.py``).

Instead of batching a wave of requests and holding every lane until the
longest sequence finishes, a persistent decode loop admits new sequences
and retires finished ones (EOS / max-tokens / deadline) at every step,
against a fixed lane budget. K/V live in the shared
:class:`~deeplearning4j_tpu_torch.serving.kv_cache.PagedKVArena`, so a
retiring sequence's pages are reusable by the next admission.

Two layers:

- :class:`PagedDecodeEngine` — owns the model, the arena, and one
  captured program per dispatch shape (``util/capture.py``: a CUDA graph
  on the card, the reference's one compiled XLA program per shape key).
  The scheduler packs working lanes into power-of-two batch buckets, so
  the key set is a fixed ladder — ``paged_decode[S{lanes}xT{t}xP{pages}]``
  for prefill chunks and ticked steps, ``fused_decode[S{lanes}xN{block}
  xP{pages}]``, ``draft_prefill[...]``, ``spec_draft[S{lanes}xK{k}x
  P{pages}]`` and ``spec_verify[...]``, the last three with a
  ``|sampled`` variant when a lane samples — and ``jit_retraces_total``
  stays at 1 per key however requests arrive and retire. ``warmup()``
  builds the whole ladder; a key it missed is built mid-serve and its
  wall charged to TTFT's ``compile`` part. ``dispatch_keys`` counts the
  dispatches per key.
- :class:`DecodeScheduler` — the continuous-batching policy: bounded
  submit queue with shed-by-reason, page-reservation admission, chunked
  prefill interleaved with decode, per-sequence deadlines, decode-aware
  ``drain()``, and a ``fence()`` that holds the loop at a step boundary.

Three decode-step shapes:

- ``block_len=1`` (default): the host-ticked step — one dispatch and one
  host read per generated token, sampled on the host (``sample_token``).
- ``block_len=N``: the FUSED block — ``models.transformer.
  fused_decode_loop`` runs N steps (paged scatter, forward, on-device
  sampling, EOS/budget self-retire) with no host sync inside; the
  scheduler ticks once per block and reads the block's results once. N is
  bucketed to a power of two, capped at 64.
- ``draft_net=``: SPECULATIVE blocks — a small draft model (its pools in
  a pools-only shadow arena indexed by the same page tables) drafts
  ``draft_k`` tokens per lane, the target verifies them in one K+1
  chunk, and accept/reject and the bonus happen on the device (Leviathan
  et al.): 1..K+1 tokens per block for two dispatches and one host sync.

``kv_dtype="int8"`` stores the pools as int8 codes with per-(page, head)
f32 scales (``ops/paged_attention.py``), for every step shape.

Greedy output is the same as the single-sequence full-cache oracle
(``models.transformer.generate``) for every sequence that stays within
the window (prompt + generated ≤ page_size × pages_per_seq): the paged
gather reassembles the window the oracle's streaming cache holds. Past
the window the two legitimately differ: the arena evicts a page at a time
while the oracle slides a token at a time.

Observability: ``serving_shed_total{reason}``, ``decode_batch_occupancy``,
``kv_pages_in_use``, ``decode_retired_total{reason}``, TTFT and
time-per-output-token histograms, ``decode_dispatches_total{kind}``,
``decode_host_syncs_total``, ``decode_host_tick_seconds{component}``,
``decode_draft_tokens_total{result}``, and the builds per key
(``jit_retraces_total{fn}``, ``xla_compile_seconds{fn}``).

Fault seam: ``"serving.decode_step"`` before every prefill/decode
dispatch.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import dtypes as _dtypes
from ..models import transformer as _transformer
from ..nn.conf.attention import SelfAttentionLayer
from ..nn.conf.layers import EmbeddingSequenceLayer
from ..util import faults as _faults
from ..util import flightrecorder as _flight
from ..util import metrics as _metrics
from ..util import tracing as _tracing
from ..util import capture as _capture
from ..util.resilience import SYSTEM_CLOCK, Clock, Deadline
from .kv_cache import PagedKVArena
from ..util.xla import pow2_bucket  # re-exported: its home is util/xla

__all__ = ["PagedDecodeEngine", "DecodeScheduler", "DecodeRequest",
           "SchedulerSaturated", "SchedulerDraining", "pow2_bucket"]


class SchedulerSaturated(RuntimeError):
    """Submit refused: the bounded request queue is full."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class SchedulerDraining(RuntimeError):
    """Submit refused: the scheduler is draining or stopped."""


class DecodeRequest:
    """Handle for one generative request: the scheduler appends tokens as
    they are produced and signals ``event`` on finish. ``finish_reason``
    ∈ {eos, max_tokens, deadline, error, shutdown}.

    ``ttft_breakdown`` (stamped at the first token) splits the measured
    TTFT into parts that sum to it: ``queue_wait`` (submit → admission),
    ``prefill`` (this request's own prefill dispatches, builds excluded),
    ``compile`` (the builds — graph captures on the card — of keys that
    ``warmup()`` missed, paid by its prefill ticks) and ``dispatch`` (the
    rest: the shared ticks' other dispatches and host bookkeeping)."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "eos_id",
                 "deadline", "rng", "tokens", "finish_reason", "error",
                 "event", "t_submit", "t_admit", "t_first_token",
                 "t_done", "top_k", "top_p", "span", "queue_span",
                 "ttft_breakdown", "prefix_covered_tokens")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 temperature: float, eos_id: Optional[int],
                 deadline: Deadline, rng, t_submit: float,
                 top_k: int = 0, top_p: float = 1.0):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.deadline = deadline
        self.rng = rng
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.event = threading.Event()
        self.t_submit = t_submit
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.span = None
        self.queue_span = None
        self.ttft_breakdown: Optional[Dict[str, float]] = None
        # prompt tokens covered by a prefix-cache hit at admission
        self.prefix_covered_tokens = 0

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def retryable(self) -> bool:
        """True when the request died with the ENGINE (pools rebuilt after
        a dispatch failure, server shutting down) rather than on its own
        terms: safe to replay, and any partial ``tokens`` are kept."""
        return self.finish_reason in ("error", "shutdown")

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request finishes (True) or ``timeout`` real
        seconds pass (False)."""
        return self.event.wait(timeout)


_PREFILL, _DECODE = "prefill", "decode"


class _Sequence:
    __slots__ = ("req", "lane", "state", "cursor", "last_token",
                 "prefill_s", "compile_s", "covered")

    def __init__(self, req: DecodeRequest, lane: int):
        self.req = req
        self.lane = lane
        self.state = _PREFILL
        self.cursor = 0              # prompt tokens already fed
        self.last_token = 0          # next token to feed in decode
        self.prefill_s = 0.0         # own prefill dispatch wall (TTFT)
        self.compile_s = 0.0         # build wall its ticks paid
        self.covered = 0             # positions below this are cache hits


class PagedDecodeEngine:
    """Model + arena + one captured program per dispatch shape.

    ``max_batch`` is the lane count; ``page_size × pages_per_seq`` is each
    lane's attention window (longer sequences slide by page eviction);
    ``num_pages`` defaults to ``max_batch × pages_per_seq`` (no
    overcommit). The engine runs on the net's device; the pools are
    ``promote_types(compute, float32)`` as in the reference, or int8 codes
    with per-(page, head) f32 scales (``kv_dtype="int8"``).
    ``draft_net`` (with ``draft_k`` drafted tokens per block, in [1, 16])
    turns the decode step into speculative blocks; it excludes
    ``block_len > 1``.
    """

    def __init__(self, net, *, max_batch: int = 8, page_size: int = 16,
                 pages_per_seq: int = 8, num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 block_len: int = 1, draft_net=None, draft_k: int = 4,
                 prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', "
                             f"got {kv_dtype!r}")
        self._validate_net(net)
        self.net = net
        self.device = net.device
        self.lanes = int(max_batch)
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        self.window = self.page_size * self.pages_per_seq
        if num_pages is None:
            num_pages = self.lanes * self.pages_per_seq
        if self.pages_per_seq > num_pages:
            raise ValueError(
                f"pages_per_seq={self.pages_per_seq} exceeds the arena "
                f"({num_pages} pages) — one sequence could never run")
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk \
            else min(16, self.window)
        if not (1 <= self.prefill_chunk <= self.window):
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must be in "
                f"[1, window={self.window}]")
        # fused-block length: a power of two (cap 64); 1 = ticked step
        self.block_len = pow2_bucket(int(block_len), cap=64)
        if self.block_len > self.window:
            raise ValueError(
                f"block_len={self.block_len} exceeds the window "
                f"({self.window}) — a block must fit the lane's view")
        self.registry = registry if registry is not None \
            else _metrics.MetricsRegistry()
        self._check_decode_config(net)
        self.arena = PagedKVArena(
            self._layer_dims(net), num_pages=int(num_pages),
            page_size=self.page_size,
            dtype=_dtypes.promote_to_f32(net.policy.compute_dtype),
            device=self.device, registry=self.registry,
            kv_dtype=kv_dtype, prefix_cache=bool(prefix_cache))
        self.vocab = self._embed_vocab(net)
        # speculative decoding: the draft's K/V lives in a pools-only
        # shadow arena indexed by the same page tables
        self.draft_net = draft_net
        self.draft_k = int(draft_k)
        self.draft_arena = None
        if draft_net is not None:
            if int(block_len) != 1:
                raise ValueError(
                    "block_len and draft_net are mutually exclusive — "
                    "speculative blocks are draft_k-sized; configure one "
                    "decode-step shape")
            if not (1 <= self.draft_k <= 16):
                raise ValueError(
                    f"draft_k={self.draft_k} out of range [1, 16]")
            if self.draft_k + 1 > self.window:
                raise ValueError(
                    f"draft_k={self.draft_k}+1 exceeds the window "
                    f"({self.window})")
            self._validate_net(draft_net)
            self._check_decode_config(draft_net)
            if self._embed_vocab(draft_net) != self.vocab:
                raise ValueError(
                    f"draft vocab {self._embed_vocab(draft_net)} != "
                    f"target vocab {self.vocab} — accept/reject compares "
                    "distributions over one vocabulary")
            if draft_net.device != self.device:
                raise ValueError(f"draft net on {draft_net.device}; the "
                                 f"engine runs on {self.device}")
            self.draft_arena = PagedKVArena(
                self._layer_dims(draft_net), num_pages=int(num_pages),
                page_size=self.page_size,
                dtype=_dtypes.promote_to_f32(
                    draft_net.policy.compute_dtype),
                device=self.device, with_allocator=False,
                kv_dtype=kv_dtype)
        s, p = self.lanes, self.pages_per_seq
        self._tables = np.full((s, p), self.arena.sentinel, np.int32)
        self._pos = np.zeros(s, np.int64)       # global fed positions
        self._base = np.zeros(s, np.int64)      # evicted positions
        self._held: List[List[int]] = [[] for _ in range(s)]
        self._reserve_left = np.zeros(s, np.int64)
        self._covered = np.zeros(s, np.int64)   # prefix-hit tokens/lane
        self._free_lanes = deque(range(s))
        # one captured program per shape key (util/capture.py), and the
        # dispatches per key
        self._graphs = _capture.GraphCache(self.device, self.registry)
        self.dispatch_keys: collections.Counter = collections.Counter()
        self._m_prefix_hits = self.registry.counter(
            "kv_prefix_hits_total",
            "Prefix-cache admission outcomes: full (whole prompt "
            "resident), partial (some full-page prefix resident), miss",
            ("result",))
        self._m_prefix_pages = self.registry.counter(
            "kv_prefix_hit_pages_total",
            "KV pages mapped from the prefix cache instead of prefilled")
        self._m_syncs = self.registry.counter(
            "decode_host_syncs_total",
            "Decode dispatches whose results the host synchronized on")
        self._m_dispatches = self.registry.counter(
            "decode_dispatches_total",
            "Device dispatches issued by the decode engine", ("kind",))
        self._m_tick = self.registry.histogram(
            "decode_host_tick_seconds",
            "Scheduler tick wall split into dispatch (device compute + "
            "sync) vs host bookkeeping components", ("component",),
            buckets=[0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 1.0])
        self._tick_dispatch_wall = 0.0
        self._tick_dispatches = 0
        self._warming = False

    # -- construction-time validation ---------------------------------

    @staticmethod
    def _layer_dims(net) -> Dict[str, Tuple[int, int]]:
        dims = {}
        for name in _transformer.attention_vertices(net):
            layer = net.conf.vertices[name].layer
            dims[name] = (layer.n_heads, layer.n_in // layer.n_heads)
        return dims

    @staticmethod
    def _validate_net(net) -> None:
        if not hasattr(net, "topo_order"):
            raise ValueError(
                "paged decode drives a ComputationGraph (transformer_lm)")
        if net.params is None:
            raise ValueError("net is not initialized — call init() first")
        if (len(net.conf.network_inputs) != 1
                or len(net.conf.network_outputs) != 1):
            raise ValueError("paged decode needs exactly one input and "
                             "one output vertex")
        if not _transformer.attention_vertices(net):
            raise ValueError("no causal SelfAttentionLayer vertices — "
                             "nothing to cache")
        in_name = net.conf.network_inputs[0]
        consumers = [n for n in net.topo_order
                     if in_name in net.conf.vertex_inputs[n]]
        if not any(isinstance(getattr(net.conf.vertices[n], "layer", None),
                              EmbeddingSequenceLayer) for n in consumers):
            raise ValueError(
                "paged decode requires the integer-id input path — build "
                "with transformer_lm(..., input_ids=True)")
        for name in net.topo_order:
            layer = getattr(net.conf.vertices[name], "layer", None)
            if isinstance(layer, SelfAttentionLayer) and not layer.causal:
                raise ValueError(
                    f"vertex {name!r}: non-causal attention cannot "
                    "decode incrementally")
            if net.state.get(name):
                raise ValueError(
                    f"vertex {name!r} carries persistent state — "
                    "unsupported in paged decode")

    def _check_decode_config(self, net) -> None:
        """The net's own streaming-cache contract must agree with the
        serving window: strict layers forbid the sliding window, and a
        ``max_cache_t`` other than ``page_size × pages_per_seq`` means a
        different attention window."""
        for name in _transformer.attention_vertices(net):
            layer = net.conf.vertices[name].layer
            if getattr(layer, "cache_overflow", "evict") == "strict":
                raise ValueError(
                    f"vertex {name!r} sets cache_overflow='strict' — the "
                    "paged serving window slides; serve an evict-mode "
                    "net, or size page_size×pages_per_seq to the full "
                    "context and cap max_new_tokens instead")
            if (layer.max_cache_t is not None
                    and layer.max_cache_t != self.window):
                raise ValueError(
                    f"vertex {name!r} max_cache_t={layer.max_cache_t} != "
                    f"serving window {self.window} (page_size × "
                    "pages_per_seq) — decode through the arena would "
                    "diverge from the net's own streaming semantics")

    @staticmethod
    def _embed_vocab(net) -> int:
        for name in net.topo_order:
            layer = getattr(net.conf.vertices[name], "layer", None)
            if isinstance(layer, EmbeddingSequenceLayer):
                return int(layer.n_in)
        return 0

    # -- lane lifecycle ------------------------------------------------

    def acquire_lane(self, total_tokens: int,
                     prompt=None) -> Optional[int]:
        """Admission: a free lane + a worst-case page reservation, or None
        when either is unavailable (the request stays queued).

        With the prefix cache and ``prompt`` given, the longest resident
        full-page prefix is mapped (retained) into the lane's table and
        the reservation covers only the uncovered pages — except for
        sequences that will outgrow the window, which reserve the full
        ``pages_per_seq`` (each shared page may later detach
        copy-on-write). A fully covered prompt re-feeds its LAST token
        with a dropped write, so the feed cursor starts at
        ``len(prompt) - 1``."""
        if not self._free_lanes:
            return None
        alloc = self.arena.allocator
        index = self.arena.prefix_index
        worst = self.arena.pages_for(total_tokens)
        covered_pages: List[int] = []
        if index is not None and prompt is not None:
            # lookup + admit under one lock: a page the lookup returned
            # cannot be reclaimed before admit() pins it
            with alloc._lock:
                covered_pages = index.lookup(prompt, self.pages_per_seq)
                if worst > self.pages_per_seq:
                    need = self.pages_per_seq
                else:
                    need = worst - len(covered_pages)
                if not alloc.admit(need, covered_pages):
                    return None
        else:
            need = min(self.pages_per_seq, worst)
            if not alloc.reserve(need):
                return None
        lane = self._free_lanes.popleft()
        cov = len(covered_pages)
        covered_tokens = cov * self.page_size
        self._base[lane] = 0
        self._reserve_left[lane] = need
        self._held[lane] = list(covered_pages)
        self._tables[lane, :] = self.arena.sentinel
        if cov:
            self._tables[lane, :cov] = covered_pages
        self._covered[lane] = covered_tokens
        if prompt is not None and covered_tokens >= len(prompt):
            self._pos[lane] = len(prompt) - 1
        else:
            self._pos[lane] = covered_tokens
        if index is not None and prompt is not None:
            if covered_tokens == 0:
                self._m_prefix_hits.inc(result="miss")
            elif covered_tokens >= len(prompt):
                self._m_prefix_hits.inc(result="full")
            else:
                self._m_prefix_hits.inc(result="partial")
            if cov:
                self._m_prefix_pages.inc(cov)
        return lane

    def register_prefix(self, lane: int, prompt_ids) -> int:
        """Publish a freshly prefilled lane's full-page prompt prefix to
        the index (no-op without one, or if the lane's window already slid
        — its leading pages no longer hold the prompt's start)."""
        index = self.arena.prefix_index
        if index is None or self._base[lane] != 0:
            return 0
        full = min(len(prompt_ids) // self.page_size, self.pages_per_seq)
        if full <= 0:
            return 0
        return index.register(prompt_ids, self._held[lane][:full])

    def release_lane(self, lane: int) -> None:
        """Retirement: the lane's page references released, its unused
        reservation returned, the lane reusable by the next admission."""
        self.arena.allocator.free(self._held[lane])
        if self._reserve_left[lane]:
            self.arena.allocator.unreserve(int(self._reserve_left[lane]))
        self._held[lane] = []
        self._reserve_left[lane] = 0
        self._covered[lane] = 0
        self._tables[lane, :] = self.arena.sentinel
        self._pos[lane] = 0
        self._base[lane] = 0
        self._free_lanes.append(lane)

    def ensure_pages(self, lane: int, n_new: int) -> None:
        """Before a dispatch: make the lane's view hold slots for
        ``n_new`` tokens at positions ``pos .. pos+n_new-1`` — recycling
        the oldest page (window eviction, ``base`` advances) when the
        view is full, drawing reserved pages as the sequence grows."""
        if n_new > self.window:
            raise ValueError(f"chunk of {n_new} exceeds the "
                             f"window ({self.window})")
        pos, base = int(self._pos[lane]), int(self._base[lane])
        ps = self.page_size
        held = self._held[lane]
        alloc = self.arena.allocator
        fresh: List[int] = []       # newly drawn or recycled pages
        while pos + n_new - 1 - base >= self.window:
            # the oldest page becomes the LAST LIVE table entry; only the
            # live prefix [0, len(held)) shifts, so no sentinel hole lands
            # in the middle of the view
            oldest = held.pop(0)
            if alloc.refcount(oldest) > 1:
                # copy-on-write detach: the page is shared (the prefix
                # index and/or another lane reads it). Release our
                # reference and draw a private tail instead (admission
                # reserved pages_per_seq for sliding sequences)
                alloc.free([oldest])
                replacement = alloc.draw()
                self._reserve_left[lane] -= 1
                alloc.note_cow()
            else:
                replacement = oldest
            fresh.append(replacement)
            held.append(replacement)
            n = len(held)
            self._tables[lane, :n - 1] = self._tables[lane, 1:n]
            self._tables[lane, n - 1] = replacement
            base += ps
            alloc.note_eviction()
        last_idx = (pos + n_new - 1 - base) // ps
        while len(held) <= last_idx:
            page = alloc.draw()
            self._reserve_left[lane] -= 1
            self._tables[lane, len(held)] = page
            held.append(page)
            fresh.append(page)
        self._base[lane] = base
        if fresh:
            self._reset_page_scales(fresh)

    def _reset_page_scales(self, pages: List[int]) -> None:
        """int8 arenas: zero the scales of freshly drawn or recycled
        pages. A recycled page's scale is a max over its previous owner's
        rows: folding new writes into it would quantize them needlessly
        coarsely, while a zero scale makes the first write rescale the
        stale codes to exact zeros. Written in place, between dispatches,
        under the scheduler's tick."""
        arenas = [a for a in (self.arena, self.draft_arena)
                  if a is not None and a.kv_dtype == "int8"]
        if not arenas:
            return
        idx = torch.tensor(pages, dtype=torch.int64)
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        for arena in arenas:
            for _codes, scales in arena.k_pools + arena.v_pools:
                scales.index_fill_(0, idx, 0.0)

    def advance(self, lane: int, n: int) -> None:
        """Account ``n`` tokens written by the dispatch that just ran."""
        self._pos[lane] += int(n)

    def rel_pos(self, lane: int) -> int:
        """View-relative position of the lane's next token."""
        return int(self._pos[lane] - self._base[lane])

    # -- the dispatch protocol -----------------------------------------

    def _dispatch(self, name: str, step, placeholders: Dict[str, np.ndarray],
                  values: Dict[str, object], *, kind: str,
                  sync: bool = True):
        """The one dispatch protocol of the engine. ``name`` is the shape
        key; its entry (``util/capture.py``: a captured CUDA graph on the
        card) is built on first use from ``placeholders`` — all-sentinel
        tables, dropped slots, inactive lanes, so building never touches a
        live page — with its wall on ``xla_compile_seconds``. The
        dispatch stages ``values`` into the entry's static inputs and runs
        it. ``sync=True`` reads the entry's one output on the host (the
        dispatch's single host sync, inside the ``try`` so that an
        asynchronous device failure surfaces here) and returns it as
        numpy; ``sync=False`` returns the static outputs on the device (a
        later sync waits them out). A failed dispatch or build zeroes
        every pool in place and flushes the prefix index before
        re-raising; the scheduler retires the in-flight batch and keeps
        serving."""
        self.dispatch_keys[name] += 1
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                entry = self._graphs.get(name, step, placeholders)
                entry.stage(**values)
                outs = entry.run()
                if sync:
                    (out,) = outs
                    outs = out.cpu().numpy()
        except Exception:
            self._reset_all_pools()
            raise
        self._note_dispatch(t0, kind, sync=sync)
        return outs

    def _reset_all_pools(self) -> None:
        self.arena.reset_pools()
        if self.draft_arena is not None:
            self.draft_arena.reset_pools()
        if self.arena.prefix_index is not None:
            # the cached chains point into pools that just became zeros
            self.arena.prefix_index.flush()

    def _compile_wall(self) -> float:
        """Total build wall (graph captures) this engine's registry has
        seen: deltas around a dispatch attribute the build of a key that
        ``warmup()`` missed to the requests that paid for it."""
        h = self.registry.get("xla_compile_seconds")
        return 0.0 if h is None else h.total_sum()

    def _note_dispatch(self, t0: float, kind: str, sync: bool = True
                       ) -> None:
        if self._warming:
            # warmup dispatches (and their builds) stay out of the
            # steady-state series
            return
        dt = time.perf_counter() - t0
        self._tick_dispatch_wall += dt
        self._tick_dispatches += 1
        self._m_dispatches.inc(kind=kind)
        if sync:
            self._m_syncs.inc()
            self._m_tick.observe(dt, component="dispatch")

    def _chunk_inputs(self, b: int, t: int) -> Dict[str, np.ndarray]:
        """Placeholders of a paged chunk [b, t]: dropped slots through
        all-sentinel tables."""
        return {"ids": np.zeros((b, t), np.int32),
                "tables": np.full((b, self.pages_per_seq),
                                  self.arena.sentinel, np.int32),
                "wslots": np.full((b, t), -1, np.int32),
                "rel": np.zeros(b, np.int32)}

    def _block_inputs(self, b: int, n_uniform: int
                      ) -> Dict[str, np.ndarray]:
        """Placeholders of a fused or speculative block over ``b``
        inactive lanes."""
        return {"last": np.zeros(b, np.int32),
                "tables": np.full((b, self.pages_per_seq),
                                  self.arena.sentinel, np.int32),
                "rel": np.zeros(b, np.int32),
                "active": np.zeros(b, bool),
                "budget": np.zeros(b, np.int32),
                "temps": np.zeros(b, np.float32),
                "top_k": np.zeros(b, np.int32),
                "top_p": np.ones(b, np.float32),
                "u": np.zeros((b, n_uniform), np.float32)}

    # -- the paged step ------------------------------------------------

    def run(self, ids: np.ndarray, write_slots: np.ndarray,
            rel_pos: np.ndarray, tables: np.ndarray,
            rows: np.ndarray) -> np.ndarray:
        """One paged forward over a compact lane selection (``ids
        [B, t_new]``, ``tables [B, P]``): scatter the new tokens' K/V,
        gather, attend; return on the host each lane's probabilities at
        position ``rows[i]``, ``[B, V]`` — the one row the scheduler reads,
        so a prefill chunk does not copy ``[B, t_new, V]`` to the host."""
        b, t_new = ids.shape
        name = f"paged_decode[S{b}xT{t_new}xP{self.pages_per_seq}]"
        arena = self.arena

        def step(ids, tables, wslots, rel, rows):
            probs, _, _ = _transformer.paged_decode_forward(
                self.net, self.net.params, arena.k_pools, arena.v_pools,
                ids, tables, wslots, rel)
            lanes = torch.arange(b, device=probs.device)
            return probs[lanes, rows].float()

        placeholders = dict(self._chunk_inputs(b, t_new),
                            rows=np.zeros(b, np.int64))
        return self._dispatch(
            name, step, placeholders,
            dict(ids=ids, tables=tables, wslots=write_slots, rel=rel_pos,
                 rows=rows), kind="paged")

    # -- fused multi-token block --------------------------------------

    def run_fused(self, last: np.ndarray, tables: np.ndarray,
                  rel: np.ndarray, active: np.ndarray, budget: np.ndarray,
                  eos: np.ndarray, temps: np.ndarray, top_k: np.ndarray,
                  top_p: np.ndarray, uniforms: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One fused block: ``uniforms.shape[1]`` decode steps through
        ``models.transformer.fused_decode_loop``, with on-device sampling
        and EOS/budget self-retire, and ONE host read of the results.
        Whether any lane samples is a key axis: ``fused_decode[...]`` and
        ``fused_decode[...]|sampled`` are two programs (the reference's
        one program branches with a ``lax.cond``). Returns host ``(tokens
        [B, N], valid [B, N], n_emitted [B])``."""
        b, n = uniforms.shape
        any_sampled = bool(np.any(temps > 0))
        name = (f"fused_decode[S{b}xN{n}xP{self.pages_per_seq}]"
                + ("|sampled" if any_sampled else ""))
        arena = self.arena

        def step(last, tables, rel, active, budget, eos, temps, top_k,
                 top_p, u):
            toks, valid, n_emitted, _done, _, _ = \
                _transformer.fused_decode_loop(
                    self.net, self.net.params, arena.k_pools,
                    arena.v_pools, last, tables, rel, active, budget, eos,
                    temps, top_k, top_p, u, any_sampled=any_sampled)
            # one tensor, so the block costs one device-to-host read
            return torch.cat([toks, valid.to(torch.int32),
                              n_emitted[:, None]], dim=1)

        placeholders = dict(self._block_inputs(b, n),
                            eos=np.full(b, -1, np.int32))
        packed = self._dispatch(
            name, step, placeholders,
            dict(last=last, tables=tables, rel=rel, active=active,
                 budget=budget, eos=eos, temps=temps, top_k=top_k,
                 top_p=top_p, u=uniforms), kind="fused")
        return packed[:, :n], packed[:, n:2 * n].astype(bool), packed[:, 2 * n]

    # -- speculative draft / verify -----------------------------------

    def run_draft_prefill(self, ids: np.ndarray, write_slots: np.ndarray,
                          rel_pos: np.ndarray, tables: np.ndarray) -> None:
        """Shadow prefill: the draft model feeds the same prompt chunk
        into its own pools (same tables, same slots), so its first
        drafting block sees the whole context. No output and no host
        sync; a failure surfaces at the next synced dispatch."""
        b, t = ids.shape
        name = f"draft_prefill[S{b}xT{t}xP{self.pages_per_seq}]"
        arena = self.draft_arena

        def step(ids, tables, wslots, rel):
            _transformer.paged_decode_forward(
                self.draft_net, self.draft_net.params, arena.k_pools,
                arena.v_pools, ids, tables, wslots, rel)
            return ()

        self._dispatch(name, step, self._chunk_inputs(b, t),
                       dict(ids=ids, tables=tables, wslots=write_slots,
                            rel=rel_pos), kind="draft_prefill", sync=False)

    def run_draft(self, last: np.ndarray, tables: np.ndarray,
                  rel: np.ndarray, active: np.ndarray,
                  write_budget: np.ndarray, temps: np.ndarray,
                  top_k: np.ndarray, top_p: np.ndarray,
                  uniforms: np.ndarray):
        """Draft half of a speculative block: K+1 steps of the draft net
        (``uniforms [B, K+1]``). Returns the entry's DEVICE outputs
        ``(draft_tokens [B, K], draft_dists [B, K, V])``; they feed
        :meth:`run_verify` with no host sync between."""
        b, k1 = uniforms.shape
        any_sampled = bool(np.any(temps > 0))
        name = (f"spec_draft[S{b}xK{k1 - 1}xP{self.pages_per_seq}]"
                + ("|sampled" if any_sampled else ""))
        arena = self.draft_arena

        def step(last, tables, rel, active, budget, temps, top_k, top_p,
                 u):
            d_toks, d_dists, _, _ = _transformer.draft_decode_loop(
                self.draft_net, self.draft_net.params, arena.k_pools,
                arena.v_pools, last, tables, rel, active, budget, temps,
                top_k, top_p, u, any_sampled=any_sampled)
            return d_toks, d_dists

        return self._dispatch(
            name, step, self._block_inputs(b, k1),
            dict(last=last, tables=tables, rel=rel, active=active,
                 budget=write_budget, temps=temps, top_k=top_k,
                 top_p=top_p, u=uniforms), kind="draft", sync=False)

    def run_verify(self, last: np.ndarray, tables: np.ndarray,
                   rel: np.ndarray, active: np.ndarray,
                   write_budget: np.ndarray, d_toks, d_dists,
                   temps: np.ndarray, top_k: np.ndarray,
                   top_p: np.ndarray, u_accept: np.ndarray,
                   u_fix: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Verify half: one batched K+1 target chunk and the on-device
        accept/reject/bonus (``models.transformer.spec_verify``). The
        draft's device outputs are copied into this entry's static inputs
        on the device. The block's ONE host sync happens here. Returns
        host ``(emitted [B, K+1], valid [B, K+1], accepts [B])``."""
        b, k = u_accept.shape
        any_sampled = bool(np.any(temps > 0))
        name = (f"spec_verify[S{b}xK{k}xP{self.pages_per_seq}]"
                + ("|sampled" if any_sampled else ""))
        arena = self.arena

        def step(last, tables, rel, active, budget, d_toks, d_dists, temps,
                 top_k, top_p, u_accept, u_fix):
            emitted, valid, accepts, _, _ = _transformer.spec_verify(
                self.net, self.net.params, arena.k_pools, arena.v_pools,
                last, tables, rel, active, budget, d_toks, d_dists, temps,
                top_k, top_p, u_accept, u_fix, any_sampled=any_sampled)
            return torch.cat([emitted, valid.to(torch.int32),
                              accepts[:, None]], dim=1)

        placeholders = self._block_inputs(b, k + 1)
        del placeholders["u"]
        placeholders.update(
            d_toks=np.zeros((b, k), np.int32),
            d_dists=np.zeros((b, k, self.vocab), np.float32),
            u_accept=np.zeros((b, k), np.float32),
            u_fix=np.zeros((b, k + 1), np.float32))
        packed = self._dispatch(
            name, step, placeholders,
            dict(last=last, tables=tables, rel=rel, active=active,
                 budget=write_budget, d_toks=d_toks, d_dists=d_dists,
                 temps=temps, top_k=top_k, top_p=top_p, u_accept=u_accept,
                 u_fix=u_fix), kind="verify")
        k1 = k + 1
        return (packed[:, :k1], packed[:, k1:2 * k1].astype(bool),
                packed[:, 2 * k1])

    def warmup(self) -> None:
        """Build every entry of the configured mode's ladder up front, so
        the first live requests pay no capture: every power-of-two lane
        bucket × the prefill chunk, t = 1 when the prefix cache is on, and
        the t = 1 step, or the fused block (greedy and sampled), or the
        draft prefills, draft and verify (greedy and sampled). Warmup
        dispatches carry all-sentinel tables, dropped write slots and
        inactive lanes, so they cannot perturb the arena."""
        self._warming = True
        try:
            self._warmup_ladder()
        finally:
            self._warming = False

    def _warmup_ladder(self) -> None:
        b = 1
        while True:
            c = self.prefill_chunk
            chunks = [c]
            if self.arena.prefix_index is not None and c > 1:
                # prefix-cache hit ticks re-feed at t = 1 in every mode
                chunks.append(1)
            if self.draft_net is None and self.block_len == 1:
                chunks.append(1)                  # the ticked step
            for t in dict.fromkeys(chunks):
                a = self._chunk_inputs(b, t)
                self.run(a["ids"], a["wslots"], a["rel"], a["tables"],
                         rows=np.zeros(b, np.int64))
                if self.draft_net is not None:
                    self.run_draft_prefill(a["ids"], a["wslots"], a["rel"],
                                           a["tables"])
            for temp in (0.0, 1.0):               # greedy, then sampled
                if self.draft_net is not None:
                    k = self.draft_k
                    a = self._block_inputs(b, k + 1)
                    temps = np.full(b, temp, np.float32)
                    d_toks, d_dists = self.run_draft(
                        a["last"], a["tables"], a["rel"], a["active"],
                        a["budget"], temps, a["top_k"], a["top_p"], a["u"])
                    self.run_verify(
                        a["last"], a["tables"], a["rel"], a["active"],
                        a["budget"], d_toks, d_dists, temps, a["top_k"],
                        a["top_p"], np.zeros((b, k), np.float32), a["u"])
                elif self.block_len > 1:
                    a = self._block_inputs(b, self.block_len)
                    self.run_fused(
                        a["last"], a["tables"], a["rel"], a["active"],
                        a["budget"], np.full(b, -1, np.int32),
                        np.full(b, temp, np.float32), a["top_k"],
                        a["top_p"], a["u"])
            if b >= self.lanes:
                break
            b <<= 1           # the ladder _compact produces

    # -- model swap (fenced by the scheduler) -------------------------

    def swap_net(self, net) -> None:
        """Replace the served model at a step boundary. The topology and
        parameter shapes must match; every entry is dropped (a captured
        graph reads the old parameters), the prefix index is flushed (its
        K/V came from the old parameters) and the ladder built again."""
        self._validate_net(net)
        self._check_decode_config(net)
        if list(net.topo_order) != list(self.net.topo_order):
            raise ValueError("model swap with a different graph topology")

        def shapes(params):
            return {v: {k: tuple(t.shape) for k, t in ps.items()}
                    for v, ps in params.items()}

        if shapes(net.params) != shapes(self.net.params):
            raise ValueError("model swap with different parameter shapes")
        if net.device != self.device:
            raise ValueError(f"model swap to a net on {net.device}; the "
                             f"engine runs on {self.device}")
        self.net = net
        # the graphs read the old parameters at their addresses
        self._graphs.clear()
        if self.arena.prefix_index is not None:
            self.arena.prefix_index.flush()
        self.warmup()

    def lanes_free(self) -> int:
        return len(self._free_lanes)


class DecodeScheduler:
    """The continuous-batching loop (see module docstring).

    Every tick: retire expired/finished sequences → admit from the bounded
    queue against lanes + page reservations → ONE batched prefill chunk
    for admitting sequences → ONE decode step (or fused block) for every
    decoding sequence. ``step_once()`` is public so deterministic tests
    drive the whole machine on a :class:`ManualClock` with no threads.
    """

    def __init__(self, engine: PagedDecodeEngine, *, max_queue: int = 64,
                 default_max_new_tokens: int = 32,
                 request_timeout_s: float = 30.0,
                 clock: Clock = SYSTEM_CLOCK,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 tracer=None, start_thread: bool = True):
        self.engine = engine
        self.max_queue = int(max_queue)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.request_timeout_s = float(request_timeout_s)
        self.clock = clock
        self.tracer = tracer
        self.registry = registry if registry is not None else engine.registry
        self._init_metrics()
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._active: Dict[int, _Sequence] = {}
        # held across one full tick: the step boundary every outside
        # mutation (drain bookkeeping, model swap) fences on
        self._dispatch_lock = threading.RLock()
        self._draining = False
        self._stopped = False
        # callers waiting in fence(): the loop yields the lock to them
        self._fence_waiters = 0
        self._thread: Optional[threading.Thread] = None
        if start_thread:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="decode-scheduler")
            self._thread.start()

    def _init_metrics(self) -> None:
        reg = self.registry
        self._m_shed = reg.counter(
            "serving_shed_total",
            "Predict requests shed with 503 before reaching the model",
            ("reason",))
        self._m_admitted = reg.counter(
            "decode_admitted_total",
            "Generative sequences admitted into the decode batch")
        self._m_retired = reg.counter(
            "decode_retired_total",
            "Generative sequences retired, by reason", ("reason",))
        self._m_steps = reg.counter(
            "decode_steps_total", "Batched decode steps dispatched")
        self._m_tokens = reg.counter(
            "decode_tokens_total",
            "Tokens pushed through the paged decode path", ("phase",))
        self._m_occupancy = reg.histogram(
            "decode_batch_occupancy",
            "Sequences active in each batched decode step",
            buckets=[float(1 << i) for i in range(11)])
        self._m_ttft = reg.histogram(
            "decode_ttft_seconds",
            "Submit → first generated token (queue + prefill)")
        self._m_tpot = reg.histogram(
            "decode_time_per_output_token_seconds",
            "Steady-state seconds per output token, per finished sequence",
            buckets=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0])
        self._m_draft = reg.counter(
            "decode_draft_tokens_total",
            "Speculative draft tokens, by verify outcome", ("result",))
        self._m_goodput = reg.counter(
            "decode_goodput_tokens_total",
            "Generated tokens by SLO outcome of their request: met "
            "(finished by eos/max_tokens within its deadline) vs missed "
            "(deadline/error/shutdown)", ("slo",))
        # weakly bound: a retired scheduler (and its engine and pools)
        # stays collectable on a shared registry
        ref = weakref.ref(self)

        def _sample(get):
            def fn():
                sched = ref()
                if sched is None:
                    raise LookupError("scheduler retired")
                return float(get(sched))
            return fn

        reg.gauge(
            "decode_active_sequences",
            "Generative sequences currently holding a decode lane"
        ).set_function(_sample(lambda s: len(s._active)))
        reg.gauge(
            "decode_queue_depth",
            "Generative requests accepted but not yet admitted"
        ).set_function(_sample(lambda s: len(s._queue)))

    # -- intake --------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None, *,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               seed: Optional[int] = None, top_k: int = 0,
               top_p: float = 1.0, trace_ctx=None) -> DecodeRequest:
        """Accept one generative request into the bounded queue. Raises
        :class:`SchedulerDraining` / :class:`SchedulerSaturated` (the shed
        paths, recorded by reason) instead of queueing unbounded latency.
        ``top_k``/``top_p`` filter temperature sampling; ignored when
        greedy. ``trace_ctx`` (a traceparent string or SpanContext)
        parents the request's root span when a tracer is attached."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if self.engine.vocab and (prompt.min() < 0
                                  or prompt.max() >= self.engine.vocab):
            raise ValueError(
                f"prompt ids outside [0, {self.engine.vocab})")
        n_new = int(max_new_tokens if max_new_tokens is not None
                    else self.default_max_new_tokens)
        if n_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if int(top_k) < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not (0.0 < float(top_p) <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        # top_k >= vocab filters nothing: normalized to 0 so the value
        # stays int32-safe in the block arrays
        top_k = int(top_k)
        if self.engine.vocab and top_k >= self.engine.vocab:
            top_k = 0
        rng = (np.random.default_rng(seed) if temperature > 0 else None)
        req = DecodeRequest(
            prompt, n_new, temperature, eos_id,
            Deadline(timeout_s if timeout_s is not None
                     else self.request_timeout_s, self.clock),
            rng, self.clock.monotonic(), top_k=top_k, top_p=float(top_p))
        if self.tracer is not None:
            if isinstance(trace_ctx, str):
                trace_ctx = _tracing.extract(trace_ctx)
            req.span = self.tracer.start(
                "decode.request", parent=trace_ctx,
                attributes={"prompt_len": int(prompt.size),
                            "max_new_tokens": n_new})
            req.queue_span = self.tracer.start("queue", parent=req.span)
        try:
            with self._cond:
                # flags checked under the lock: a submit racing stop()
                # lands before the shutdown flush or is refused
                if self._draining or self._stopped:
                    self._m_shed.inc(reason="draining")
                    _flight.record("decode_shed", reason="draining")
                    raise SchedulerDraining("decode scheduler is draining")
                if len(self._queue) >= self.max_queue:
                    self._m_shed.inc(reason="decode_queue_full")
                    _flight.record("decode_shed",
                                   reason="decode_queue_full",
                                   queue_depth=len(self._queue))
                    raise SchedulerSaturated(
                        "decode queue full", retry_after=1.0)
                self._queue.append(req)
                self._cond.notify_all()
        except Exception:
            self._end_request_spans(req, "shed")
            raise
        return req

    @staticmethod
    def _end_request_spans(req: DecodeRequest,
                           status: Optional[str] = None) -> None:
        if req.queue_span is not None:
            req.queue_span.end(status)
        if req.span is not None:
            req.span.end(status)

    # -- the continuous-batching tick ---------------------------------

    def step_once(self) -> bool:
        """One scheduler tick: retire → admit → prefill chunk → decode
        step. Returns whether anything progressed. A dispatch error
        retires every in-flight sequence with ``finish_reason="error"``
        and leaves the scheduler serving on rebuilt pools."""
        with self._dispatch_lock:
            eng = self.engine
            t_tick = time.perf_counter()
            eng._tick_dispatch_wall = 0.0
            eng._tick_dispatches = 0
            progressed = self._retire_expired()
            progressed = self._admit() or progressed
            try:
                progressed = self._prefill_tick() or progressed
                progressed = self._decode_tick() or progressed
            except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
                _flight.record("decode_error",
                               error=f"{type(e).__name__}: {e}",
                               in_flight=len(self._active))
                for seq in list(self._active.values()):
                    seq.req.error = f"{type(e).__name__}: {e}"
                    self._retire(seq, "error")
                progressed = True
            if eng._tick_dispatches:
                total = time.perf_counter() - t_tick
                eng._m_tick.observe(
                    max(0.0, total - eng._tick_dispatch_wall),
                    component="bookkeeping")
            return progressed

    def _retire_expired(self) -> bool:
        any_ = False
        for seq in list(self._active.values()):
            if seq.req.deadline.expired:
                self._retire(seq, "deadline")
                any_ = True
        with self._cond:
            queued = list(self._queue)
        for req in queued:
            if req.deadline.expired:
                with self._cond:
                    try:
                        self._queue.remove(req)
                    except ValueError:
                        continue
                self._finish(req, "deadline")
                self._m_retired.inc(reason="deadline")
                any_ = True
        return any_

    def _admit(self) -> bool:
        admitted = False
        while True:
            with self._cond:
                if not self._queue:
                    break
                req = self._queue[0]
            lane = self.engine.acquire_lane(
                len(req.prompt) + req.max_new_tokens, prompt=req.prompt)
            if lane is None:          # no lane / page pressure: stay queued
                break
            with self._cond:
                self._queue.popleft()
            req.t_admit = self.clock.monotonic()
            if req.queue_span is not None:
                req.queue_span.set_attribute("lane", lane)
                req.queue_span.end()
                req.queue_span = None
            seq = _Sequence(req, lane)
            # a prefix-cache hit parks the feed cursor past the covered
            # tokens (a full cover re-feeds the last prompt token)
            seq.cursor = int(self.engine._pos[lane])
            seq.covered = int(self.engine._covered[lane])
            req.prefix_covered_tokens = min(seq.covered, len(req.prompt))
            self._active[lane] = seq
            self._m_admitted.inc()
            admitted = True
        return admitted

    def _compact(self, seqs: List[_Sequence], t_new: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray]:
        """Pack the lanes that have work into a power-of-two batch bucket:
        a lone admission prefills at [1, C], not full width, while the
        bucket set stays fixed."""
        eng = self.engine
        b = pow2_bucket(len(seqs), cap=1 << 30)
        ids = np.zeros((b, t_new), np.int32)
        wslots = np.full((b, t_new), -1, np.int32)
        rel = np.zeros(b, np.int32)
        tables = np.full((b, eng.pages_per_seq), eng.arena.sentinel,
                         np.int32)
        for i, seq in enumerate(seqs):
            tables[i] = eng._tables[seq.lane]
        return ids, wslots, rel, tables

    def _prefill_tick(self) -> bool:
        seqs = [s for s in self._active.values() if s.state == _PREFILL]
        if not seqs:
            return False
        eng = self.engine
        c = eng.prefill_chunk
        chunk_len: List[int] = []
        for seq in seqs:
            n = min(c, len(seq.req.prompt) - seq.cursor)
            eng.ensure_pages(seq.lane, n)
            chunk_len.append(n)
        # prefix-cache fast path: when every admitting lane has at most
        # one token left to feed (the full-hit re-feed), dispatch at the
        # t = 1 decode shape instead of the padded prefill chunk
        t_feed = (1 if (eng.arena.prefix_index is not None
                        and max(chunk_len) <= 1) else c)
        ids, wslots, rel, tables = self._compact(seqs, t_feed)
        rows = np.zeros(ids.shape[0], np.int64)
        for i, seq in enumerate(seqs):
            n = chunk_len[i]
            r = eng.rel_pos(seq.lane)
            ids[i, :n] = seq.req.prompt[seq.cursor:seq.cursor + n]
            slots = r + np.arange(n)
            if seq.covered > seq.cursor:
                # cache-resident positions: re-fed tokens attend their
                # resident K/V but must NOT write (a shared page)
                slots[:seq.covered - seq.cursor] = -1
            wslots[i, :n] = slots
            rel[i] = r
            rows[i] = n - 1
        _faults.check("serving.decode_step",
                      {"phase": "prefill", "lanes": len(seqs)})
        w0, c0 = eng._tick_dispatch_wall, eng._compile_wall()
        probs = eng.run(ids, wslots, rel, tables, rows=rows)   # [B, V]
        if eng.draft_net is not None:
            # shadow prefill: the draft's cache holds the same context
            # before its first drafting block
            eng.run_draft_prefill(ids, wslots, rel, tables)
        # TTFT attribution: this chunk's dispatch wall, the builds split
        # out, is charged to every sequence it prefilled
        d_wall = eng._tick_dispatch_wall - w0
        d_compile = min(eng._compile_wall() - c0, d_wall)
        for i, seq in enumerate(seqs):
            seq.prefill_s += d_wall - d_compile
            seq.compile_s += d_compile
            if self.tracer is not None and seq.req.span is not None:
                self.tracer.record(
                    "prefill_chunk", d_wall, parent=seq.req.span,
                    attributes={"lane": seq.lane, "bucket": ids.shape[0],
                                "tokens": int(chunk_len[i]),
                                "compile_s": round(d_compile, 6)})
        self._m_tokens.inc(sum(chunk_len), phase="prefill")
        for i, seq in enumerate(seqs):
            n = chunk_len[i]
            eng.advance(seq.lane, n)
            seq.cursor += n
            if seq.cursor == len(seq.req.prompt):
                # publish the prompt's full-page prefix BEFORE emitting
                # (emit may retire the lane and release its pages)
                eng.register_prefix(seq.lane, seq.req.prompt)
                # the last prompt position's distribution gives the first
                # generated token
                self._emit_token(seq, probs[i])
                if seq.lane in self._active:
                    seq.state = _DECODE
        return True

    def _decode_tick(self) -> bool:
        seqs = [s for s in self._active.values() if s.state == _DECODE]
        if not seqs:
            return False
        eng = self.engine
        if eng.draft_net is not None:
            return self._spec_block_tick(seqs)
        if eng.block_len > 1:
            return self._fused_block_tick(seqs)
        for seq in seqs:
            eng.ensure_pages(seq.lane, 1)
        ids, wslots, rel, tables = self._compact(seqs, 1)
        for i, seq in enumerate(seqs):
            r = eng.rel_pos(seq.lane)
            ids[i, 0] = seq.last_token
            wslots[i, 0] = r
            rel[i] = r
        _faults.check("serving.decode_step",
                      {"phase": "decode", "lanes": len(seqs)})
        w0 = eng._tick_dispatch_wall
        probs = eng.run(ids, wslots, rel, tables,
                        rows=np.zeros(ids.shape[0], np.int64))   # [B, V]
        self._record_block_spans(seqs, "ticked", ids.shape[0],
                                 [1] * len(seqs),
                                 eng._tick_dispatch_wall - w0)
        self._m_steps.inc()
        self._m_occupancy.observe(float(len(seqs)))
        self._m_tokens.inc(len(seqs), phase="decode")
        # one vectorized greedy argmax for the batch (the same result as
        # sample_token's argmax over the float64 widening)
        greedy = np.argmax(probs, axis=-1)
        for i, seq in enumerate(seqs):
            eng.advance(seq.lane, 1)
            self._emit_token(seq, probs[i], greedy_tok=int(greedy[i]))
        return True

    def _block_arrays(self, seqs: List[_Sequence], n_uniform: int):
        """Per-lane arrays for a fused block over a power-of-two bucket:
        pending token, view-relative position, active mask (padded lanes
        start retired), sampling configuration, and ``n_uniform``
        host-drawn uniforms per sampled lane (from each request's seeded
        generator, so a request's draws do not depend on its batch)."""
        eng = self.engine
        b = pow2_bucket(len(seqs), cap=1 << 30)
        arr = {
            "last": np.zeros(b, np.int32),
            "rel": np.zeros(b, np.int32),
            "active": np.zeros(b, bool),
            "eos": np.full(b, -1, np.int32),
            "temps": np.zeros(b, np.float32),
            "top_k": np.zeros(b, np.int32),
            "top_p": np.ones(b, np.float32),
            "u": np.zeros((b, n_uniform), np.float32),
            "tables": np.full((b, eng.pages_per_seq), eng.arena.sentinel,
                              np.int32),
        }
        for i, seq in enumerate(seqs):
            req = seq.req
            arr["tables"][i] = eng._tables[seq.lane]
            arr["last"][i] = seq.last_token
            arr["rel"][i] = eng.rel_pos(seq.lane)
            arr["active"][i] = True
            if req.eos_id is not None:
                arr["eos"][i] = req.eos_id
            if req.temperature > 0:
                arr["temps"][i] = req.temperature
                arr["top_k"][i] = req.top_k
                arr["top_p"][i] = req.top_p
                arr["u"][i] = req.rng.random(n_uniform)
        return arr

    def _fused_block_tick(self, seqs: List[_Sequence]) -> bool:
        """One FUSED block: N device-resident decode steps, one host read;
        retire/admit happen at the block boundary, finished lanes
        self-retire on the device mid-block."""
        eng = self.engine
        n = eng.block_len
        budgets = []
        for seq in seqs:
            remaining = seq.req.max_new_tokens - len(seq.req.tokens)
            budgets.append(min(n, remaining))
            eng.ensure_pages(seq.lane, budgets[-1])
        a = self._block_arrays(seqs, n)
        budget = np.zeros(a["last"].shape[0], np.int32)
        budget[:len(seqs)] = budgets
        _faults.check("serving.decode_step",
                      {"phase": "decode_block", "lanes": len(seqs),
                       "block_len": n})
        w0 = eng._tick_dispatch_wall
        toks, valid, n_emitted = eng.run_fused(
            a["last"], a["tables"], a["rel"], a["active"], budget,
            a["eos"], a["temps"], a["top_k"], a["top_p"], a["u"])
        self._record_block_spans(
            seqs, "fused", a["last"].shape[0],
            [int(n_emitted[i]) for i in range(len(seqs))],
            eng._tick_dispatch_wall - w0)
        self._m_steps.inc()
        self._m_occupancy.observe(float(len(seqs)))
        emitted_total = 0
        for i, seq in enumerate(seqs):
            m = int(n_emitted[i])
            eng.advance(seq.lane, m)
            emitted_total += m
            for j in range(m):
                self._absorb_token(seq, int(toks[i, j]))
                if seq.req.done:
                    break
        self._m_tokens.inc(emitted_total, phase="decode")
        _flight.record("decode_block", kind="fused", lanes=len(seqs),
                       block_len=n, tokens=emitted_total,
                       active=len(self._active))
        return True

    def _spec_block_tick(self, seqs: List[_Sequence]) -> bool:
        """One SPECULATIVE block: the draft runs K+1 steps, the target
        verifies all K drafts in one batched chunk, accept/reject and the
        bonus land on the device — 1..K+1 tokens per lane for two
        dispatches and one host sync. EOS/max-tokens truncation of the
        valid prefix is on the host (the block boundary is a host tick)."""
        eng = self.engine
        k = eng.draft_k
        # write budget = tokens the lane can still emit: slots past it are
        # dropped on the device, so a lane near max-tokens (or the window
        # edge) never draws pages, or evicts live ones, for positions
        # that cannot exist
        wbudget = []
        for seq in seqs:
            remaining = seq.req.max_new_tokens - len(seq.req.tokens)
            wbudget.append(min(k + 1, remaining))
            eng.ensure_pages(seq.lane, wbudget[-1])
        a = self._block_arrays(seqs, k + 1)
        b = a["last"].shape[0]
        write_budget = np.zeros(b, np.int32)
        write_budget[:len(seqs)] = wbudget
        u_acc = np.zeros((b, k), np.float32)
        u_fix = np.zeros((b, k + 1), np.float32)
        for i, seq in enumerate(seqs):
            if seq.req.temperature > 0:
                u_acc[i] = seq.req.rng.random(k)
                u_fix[i] = seq.req.rng.random(k + 1)
        _faults.check("serving.decode_step",
                      {"phase": "spec_block", "lanes": len(seqs),
                       "draft_k": k})
        w0 = eng._tick_dispatch_wall
        d_toks, d_dists = eng.run_draft(
            a["last"], a["tables"], a["rel"], a["active"], write_budget,
            a["temps"], a["top_k"], a["top_p"], a["u"])
        emitted, valid, accepts = eng.run_verify(
            a["last"], a["tables"], a["rel"], a["active"], write_budget,
            d_toks, d_dists, a["temps"], a["top_k"], a["top_p"], u_acc,
            u_fix)
        spec_wall = eng._tick_dispatch_wall - w0
        self._m_steps.inc()
        self._m_occupancy.observe(float(len(seqs)))
        emitted_total = 0
        emitted_per_seq: List[int] = []
        for i, seq in enumerate(seqs):
            m = 0
            for j in range(k + 1):
                if not valid[i, j]:
                    break
                self._absorb_token(seq, int(emitted[i, j]))
                m += 1
                if seq.req.done:
                    break
            emitted_per_seq.append(m)
            if not seq.req.done:
                # a finished lane was released by _absorb_token's retire
                eng.advance(seq.lane, m)
            emitted_total += m
            # acceptance over the drafts that had a chance to be served
            # (valid context within the write budget): accepted drafts
            # became output; rejected ones went unserved, by a target
            # mismatch or because the lane finished first
            chanced = min(k, wbudget[i])
            served = min(int(accepts[i]), m, chanced)
            self._m_draft.inc(served, result="accepted")
            self._m_draft.inc(chanced - served, result="rejected")
        self._record_block_spans(seqs, "speculative", b, emitted_per_seq,
                                 spec_wall)
        self._m_tokens.inc(emitted_total, phase="decode")
        _flight.record("decode_block", kind="speculative",
                       lanes=len(seqs), draft_k=k, tokens=emitted_total,
                       sampled_lanes=int(np.count_nonzero(a["temps"] > 0)),
                       active=len(self._active))
        return True

    def _record_block_spans(self, seqs: List[_Sequence], kind: str,
                            bucket: int, tokens: List[int],
                            seconds: float) -> None:
        if self.tracer is None:
            return
        for i, seq in enumerate(seqs):
            if seq.req.span is not None:
                self.tracer.record(
                    "decode_block", seconds, parent=seq.req.span,
                    attributes={"kind": kind, "lane": seq.lane,
                                "bucket": int(bucket),
                                "tokens": int(tokens[i])})

    def _emit_token(self, seq: _Sequence, probs: np.ndarray, *,
                    greedy_tok: Optional[int] = None) -> None:
        req = seq.req
        tok = (greedy_tok if greedy_tok is not None
               and req.temperature <= 0.0
               else _transformer.sample_token(probs, req.temperature,
                                              req.rng, top_k=req.top_k,
                                              top_p=req.top_p))
        self._absorb_token(seq, tok)

    def _absorb_token(self, seq: _Sequence, tok: int) -> None:
        """Account one generated token (host-sampled or device-sampled in
        a fused block): append, stamp TTFT, retire on EOS/max-tokens — the
        one copy of the finish rules."""
        req = seq.req
        if req.t_first_token is None:
            req.t_first_token = self.clock.monotonic()
            ttft = req.t_first_token - req.t_submit
            self._m_ttft.observe(ttft)
            queue_wait = max(0.0, (req.t_admit if req.t_admit is not None
                                   else req.t_submit) - req.t_submit)
            prefill = min(seq.prefill_s, max(0.0, ttft - queue_wait))
            compile_s = min(seq.compile_s,
                            max(0.0, ttft - queue_wait - prefill))
            req.ttft_breakdown = {
                "queue_wait": queue_wait, "prefill": prefill,
                "compile": compile_s,
                "dispatch": max(0.0, ttft - queue_wait - prefill
                                - compile_s)}
            if req.span is not None:
                req.span.set_attribute("ttft_ms", round(ttft * 1000, 3))
                req.span.set_attribute(
                    "ttft_breakdown_ms",
                    {k: round(v * 1000, 3)
                     for k, v in req.ttft_breakdown.items()})
        req.tokens.append(tok)
        seq.last_token = tok
        if req.eos_id is not None and tok == req.eos_id:
            self._retire(seq, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._retire(seq, "max_tokens")

    def _retire(self, seq: _Sequence, reason: str) -> None:
        self.engine.release_lane(seq.lane)
        self._active.pop(seq.lane, None)
        self._finish(seq.req, reason)
        self._m_retired.inc(reason=reason)
        _flight.record("decode_retired", reason=reason, lane=seq.lane,
                       tokens=len(seq.req.tokens),
                       active=len(self._active))

    def _finish(self, req: DecodeRequest, reason: str) -> None:
        req.finish_reason = reason
        req.t_done = self.clock.monotonic()
        if req.t_first_token is not None and len(req.tokens) > 1:
            self._m_tpot.observe(
                (req.t_done - req.t_first_token)
                / (len(req.tokens) - 1))
        if req.tokens:
            self._m_goodput.inc(
                len(req.tokens),
                slo="met" if reason in ("eos", "max_tokens")
                else "missed")
        if req.span is not None:
            req.span.set_attribute("finish_reason", reason)
            req.span.set_attribute("tokens", len(req.tokens))
            self._end_request_spans(
                req, None if reason in ("eos", "max_tokens") else reason)
        req.event.set()

    # -- loop / lifecycle ---------------------------------------------

    def _loop(self) -> None:
        while not self._stopped:
            progressed = self.step_once()
            if self._fence_waiters:
                # the lock is not fair: without a pause the loop takes it
                # back before a waiting fence() can
                time.sleep(0.001)
            if progressed:
                continue
            with self._cond:
                if self._stopped:
                    break
                if not self._queue and not self._active:
                    self._cond.wait(timeout=0.05)
                else:
                    # queued work that could not admit yet (page/lane
                    # pressure resolves at the next retirement)
                    self._cond.wait(timeout=0.002)

    def active_count(self) -> int:
        return len(self._active)

    def queue_depth(self) -> int:
        return len(self._queue)

    @contextlib.contextmanager
    def fence(self):
        """Hold the scheduler at a step boundary (no dispatch in flight)
        and yield the number of in-flight sequences — the gate a model
        swap passes through."""
        with self._cond:
            self._fence_waiters += 1
        try:
            self._dispatch_lock.acquire()
        finally:
            with self._cond:
                self._fence_waiters -= 1
        try:
            yield len(self._active)
        finally:
            self._dispatch_lock.release()

    def drain(self, timeout: float = 30.0) -> bool:
        """Decode-aware drain: stop ACCEPTING, keep SCHEDULING — every
        accepted request (queued or in flight) finishes, errors, or hits
        its own deadline before the drain reports clean. True if fully
        drained within ``timeout``. Threadless schedulers are stepped
        inline."""
        self._draining = True
        end = self.clock.monotonic() + timeout
        while self.clock.monotonic() < end:
            if not self._queue and not self._active:
                return True
            if self._thread is None:
                if not self.step_once():
                    self.clock.sleep(0.001)
            else:
                time.sleep(0.002)
        return not self._queue and not self._active

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the loop; anything still queued or in flight finishes with
        ``finish_reason="shutdown"``. If the loop thread is wedged inside
        a dispatch, the lock acquire below times out and the stranded
        requests are still answered (engine bookkeeping is skipped)."""
        self._draining = True
        self._stopped = True
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        fenced = self._dispatch_lock.acquire(timeout=max(0.1, timeout))
        try:
            for seq in list(self._active.values()):
                if fenced:
                    self.engine.release_lane(seq.lane)
                self._active.pop(seq.lane, None)
                self._finish(seq.req, "shutdown")
                self._m_retired.inc(reason="shutdown")
            with self._cond:
                queued, self._queue = list(self._queue), deque()
            for req in queued:
                self._finish(req, "shutdown")
                self._m_retired.inc(reason="shutdown")
        finally:
            if fenced:
                self._dispatch_lock.release()
