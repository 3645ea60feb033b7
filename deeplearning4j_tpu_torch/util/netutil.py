"""Small shared helpers of the network runtimes (counterpart of the JAX
package's ``util/netutil.py``): the per-name generator seeds, the
checkpointed segment that redraws its masks, the streaming K/V cache
limits, the strict-mode refusal and the warn-once on overflow."""

from __future__ import annotations

import contextvars
import hashlib
import warnings

import torch
from torch.utils.checkpoint import checkpoint


def name_seed(seed: int, name: str) -> int:
    """Stable 63-bit generator seed per (network seed, name)."""
    digest = hashlib.blake2s(f"{seed}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") >> 1


def named_generator(device, seed: int, name: str) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by :func:`name_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(name_seed(seed, name))
    return gen


def checkpoint_segment(fn, generator, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept. The
    checkpoint preserves only the default RNG, so ``generator``'s state at
    entry (the step's dropout and sampling draws) is restored before each
    run of ``fn``: the recompute draws the masks the forward drew. The
    recompute also runs in a copy of the forward's context variables (a
    sharded step's ``parallel.collectives`` and ``sequence_sharding``
    contexts), since the backward may run on another thread."""
    state = None if generator is None else generator.get_state()
    context = contextvars.copy_context()

    def run(*a):
        if state is not None:
            generator.set_state(state)
        return context.copy().run(fn, *a)
    return checkpoint(run, *args, use_reentrant=False)


class StreamingCacheOverflow(RuntimeError):
    """A strict-mode streaming K/V cache (``cache_overflow="strict"``)
    would overflow: the chunk about to be fed exceeds the remaining
    window. Raised host-side BEFORE the dispatch, so the cache is left
    untouched."""


def _streaming_layers(net):
    """The streaming-cached layers of a ComputationGraph or a
    MultiLayerNetwork."""
    layers = (net.conf.layers if hasattr(net.conf, "layers") else
              (getattr(v, "layer", None) for v in net.conf.vertices.values()))
    return [l for l in layers
            if l is not None and getattr(l, "max_cache_t", None) is not None]


def streaming_cache_limit(net):
    """Smallest ``max_cache_t`` among the net's streaming-cached layers
    (attention K/V caches), or None when nothing carries a bounded cache.
    Feeding more total steps than this through ``rnn_time_step`` slides
    the window (the oldest positions are evicted)."""
    limits = [l.max_cache_t for l in _streaming_layers(net)]
    return min(limits) if limits else None


def strict_cache_limit(net):
    """Smallest ``max_cache_t`` among streaming layers configured with
    ``cache_overflow="strict"``, or None when no layer is strict."""
    limits = [l.max_cache_t for l in _streaming_layers(net)
              if getattr(l, "cache_overflow", "evict") == "strict"]
    return min(limits) if limits else None


_UNSET = object()


def precheck_streamed_steps(net, t_new: int) -> None:
    """Strict-mode gate, called by ``rnn_time_step`` BEFORE any device
    work: when a streaming layer declares ``cache_overflow="strict"`` and
    the chunk about to be fed would push the total past its window, raise
    :class:`StreamingCacheOverflow` (the cache is left untouched). The
    limit is memoized on the net: this runs once per token in decode
    loops."""
    limit = getattr(net, "_stream_strict_limit_memo", _UNSET)
    if limit is _UNSET:
        limit = strict_cache_limit(net)
        net._stream_strict_limit_memo = limit
    if limit is None:
        return
    total = net._rnn_steps_fed + int(t_new)
    if total > limit:
        raise StreamingCacheOverflow(
            f"rnn_time_step would reach {total} total streamed steps but a "
            f"strict streaming K/V cache holds max_cache_t={limit}; call "
            "rnn_clear_previous_state() between sequences, raise "
            "max_cache_t, or set cache_overflow='evict' for "
            "sliding-window attention")


def note_streamed_steps(net, t_new: int) -> None:
    """Add ``t_new`` fed steps to the net's tally and warn ONCE when the
    total first exceeds the smallest streaming cache (``max_cache_t``):
    past that point the oldest cached positions are evicted and outputs
    attend only the most recent ``max_cache_t`` steps. Reset by
    ``rnn_clear_previous_state()``."""
    limit = getattr(net, "_stream_cache_limit_memo", _UNSET)
    if limit is _UNSET:
        limit = streaming_cache_limit(net)
        net._stream_cache_limit_memo = limit
    if limit is None:
        return
    prev = net._rnn_steps_fed
    net._rnn_steps_fed = prev + int(t_new)
    if net._rnn_steps_fed > limit >= prev:
        warnings.warn(
            f"rnn_time_step has been fed {net._rnn_steps_fed} total steps "
            f"but the smallest streaming K/V cache holds max_cache_t="
            f"{limit}; the window now SLIDES — the oldest positions are "
            "evicted and outputs attend only the most recent "
            f"{limit} steps. Call rnn_clear_previous_state() between "
            "sequences, raise max_cache_t, or set "
            "cache_overflow='strict' to fail instead",
            RuntimeWarning, stacklevel=3)
