"""One captured CUDA graph per shape key (counterpart of the JAX
package's ``util/xla.py``: ``keyed_jit``, ``retrace_guard`` and
``compile_seconds_histogram``).

The reference compiles one XLA executable per shape key of a decode
program and pins one compile per key. The PyTorch counterpart of "one
compiled program per shape key" is one captured CUDA graph per shape key:
a :class:`GraphCache` maps a key (``paged_decode[S8xT1xP128]``, ...) to a
:class:`GraphEntry`, built once from placeholder inputs and run for every
later dispatch of that key.

An entry holds static input tensors (with pinned host staging on CUDA),
static output tensors and a :meth:`GraphEntry.run`:

- on CUDA, ``run()`` is ``torch.cuda.CUDAGraph.replay()`` of the step
  function captured over the static inputs. Building it runs PyTorch's
  warm-up iterations on a side stream, then captures on that stream with
  ``capture_error_mode="thread_local"`` (another thread's unrelated CUDA
  work does not invalidate the capture) into one memory pool shared by
  every graph of the cache (``torch.cuda.graph_pool_handle()``), under
  ``util/profiling.py``'s guard (no capture while a profile is open or
  another engine captures). The
  graphs are replayed one at a time on one stream and each dispatch reads
  its outputs before the next replay, which is what sharing a pool needs;
- on the CPU, ``run()`` calls the same step function eagerly on the
  static inputs and copies the result into the static outputs. Staging,
  keying and accounting are the same code on both devices; only capture
  and replay are CUDA-only.

A capture that fails raises :class:`CaptureError`; nothing falls back to
eager execution on CUDA. (``GraphCache._eager_cuda``, set before the
first build, runs CUDA entries eagerly: a private switch for the card
smoke run's eager readings and the ``cuda`` tests, never the default.)

Metrics, under the reference's series names so that one dashboard reads
both packages: ``jit_retraces_total{fn=<key>}`` counts entry builds (on
CUDA: graph captures; a steady state pins it at 1 per key) and
``xla_compile_seconds{fn=<key>}`` their wall (warm-up iterations and
capture on CUDA, the first eager call on the CPU).

The step function closes over whatever it reads besides its inputs (the
model's parameters, the KV pools): a captured graph reads those tensors
at their addresses at capture time, so they must be written in place
and never replaced while the entry lives — drop the entries
(:meth:`GraphCache.clear`) when they are.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import flightrecorder as _flight
from . import metrics as _metrics
from . import profiling as _profiling

__all__ = ["GraphCache", "GraphEntry", "CaptureError",
           "retrace_counter", "compile_seconds_histogram"]

# build walls span milliseconds (a CPU step on a toy model) to seconds (a
# fused block's warm-up and capture at full width)
_COMPILE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0, 30.0, 60.0, 120.0, 300.0)
# warm-up iterations before a capture: lazy library handles, workspaces
# and the allocator's first blocks are set up outside the graph
WARMUP_ITERS = 2


class CaptureError(RuntimeError):
    """A CUDA graph capture failed; the key's entry was not built."""


def retrace_counter(registry: _metrics.MetricsRegistry) -> _metrics.Counter:
    return registry.counter(
        "jit_retraces_total",
        "Entries built per shape key (CUDA graph captures on the card, "
        "first eager calls on the CPU)", ("fn",))


def compile_seconds_histogram(registry: _metrics.MetricsRegistry
                              ) -> _metrics.Histogram:
    return registry.histogram(
        "xla_compile_seconds",
        "Wall time of each entry build (warm-up iterations and CUDA graph "
        "capture on the card, the first eager call on the CPU) per shape "
        "key", ("fn",), buckets=_COMPILE_BUCKETS)


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


class GraphEntry:
    """One shape key's program: static inputs, static outputs, ``run()``
    (see the module docstring). Built by :meth:`GraphCache.get`."""

    def __init__(self, name: str, fn: Callable,
                 inputs: Dict[str, torch.Tensor],
                 staging: Dict[str, torch.Tensor],
                 outputs: Tuple[torch.Tensor, ...],
                 graph: Optional["torch.cuda.CUDAGraph"]):
        self.name = name
        self.fn = fn
        self.inputs = inputs
        self.outputs = outputs
        self.graph = graph
        self._staging = staging
        self._staged = None       # CUDA event after the last H2D copies

    def stage(self, **values) -> None:
        """Copy this dispatch's values into the static inputs: numpy
        arrays through the pinned staging buffers (asynchronous, no host
        sync), tensors already on the device by a device-to-device copy.
        Every input is written every dispatch."""
        if self._staged is not None:
            # the previous dispatch's copies read the staging buffers:
            # done long ago in the engine's protocol (it reads each
            # dispatch's outputs), so this does not wait
            self._staged.synchronize()
        for k, dst in self.inputs.items():
            v = values[k]
            if isinstance(v, torch.Tensor):
                dst.copy_(v)
                continue
            v = np.asarray(v)
            if v.shape != tuple(dst.shape):
                raise ValueError(f"{self.name}: input {k!r} has shape "
                                 f"{v.shape}, the key {tuple(dst.shape)}")
            buf = self._staging.get(k)
            if buf is None:
                dst.copy_(torch.from_numpy(np.ascontiguousarray(v)))
            else:
                buf.numpy()[...] = v
                dst.copy_(buf, non_blocking=True)
        if self._staging:
            self._staged = torch.cuda.Event()
            self._staged.record()

    def run(self) -> Tuple[torch.Tensor, ...]:
        """Replay the graph (CUDA) or call the step function on the static
        inputs and copy the result into the static outputs (CPU, and the
        card's eager comparison). Returns the static outputs."""
        if self.graph is not None:
            self.graph.replay()
        else:
            for dst, src in zip(self.outputs,
                                _as_tuple(self.fn(**self.inputs))):
                dst.copy_(src)
        return self.outputs


class GraphCache:
    """Entries by shape key for one engine, with one shared graph memory
    pool on CUDA. Build only from one thread at a time (the engine builds
    in ``warmup`` and under the scheduler's step lock)."""

    def __init__(self, device, registry: _metrics.MetricsRegistry):
        self.device = torch.device(device)
        self._entries: Dict[str, GraphEntry] = {}
        self._pool = None
        self._eager_cuda = False
        self._m_builds = retrace_counter(registry)
        self._m_build_s = compile_seconds_histogram(registry)

    def entries(self) -> Dict[str, GraphEntry]:
        """The built entries by key (a copy)."""
        return dict(self._entries)

    def clear(self) -> None:
        """Drop every entry (their graphs read tensors that are about to
        be replaced); the next dispatch of each key builds it again."""
        self._entries.clear()

    def get(self, name: str, fn: Callable,
            placeholders: Dict[str, np.ndarray]) -> GraphEntry:
        """The entry of ``name``, built on its first use from
        ``placeholders`` (numpy arrays that fix the inputs' shapes and
        dtypes, and are the values the build runs on: they must make the
        step touch no live state)."""
        entry = self._entries.get(name)
        if entry is None:
            entry = self._build(name, fn, placeholders)
            self._entries[name] = entry
        return entry

    def _build(self, name, fn, placeholders) -> GraphEntry:
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                  for k, v in placeholders.items()}
        staging = ({k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in inputs.items()} if cuda else {})
        graph, waited = None, 0.0
        if cuda and not self._eager_cuda:
            # never while a profile is open, never beside another capture;
            # the wait for the guard is not the build's wall
            t_wait = time.perf_counter()
            with _profiling.graph_capture_guard():
                waited = time.perf_counter() - t_wait
                graph, outputs = self._capture(name, fn, inputs)
        else:
            outputs = tuple(o.clone() for o in _as_tuple(fn(**inputs)))
        dt = time.perf_counter() - t0 - waited
        self._m_builds.inc(fn=name)
        self._m_build_s.observe(dt, fn=name)
        _flight.record("compile", fn=name, compile_seconds=round(dt, 4),
                       captured=graph is not None)
        return GraphEntry(name, fn, inputs, staging, outputs, graph)

    def _capture(self, name, fn, inputs):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_ITERS):
                fn(**inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = _as_tuple(fn(**inputs))
        except Exception as e:
            raise CaptureError(f"CUDA graph capture of {name} failed: "
                               f"{type(e).__name__}: {e}") from e
        return graph, outputs

    def pool_bytes(self) -> Optional[int]:
        """Bytes of the device memory segments that belong to the shared
        graph pool (None on the CPU or before the first capture)."""
        if self._pool is None:
            return None
        want = tuple(self._pool)
        total = 0
        for seg in torch.cuda.memory_snapshot():
            if tuple(seg.get("segment_pool_id", ())) == want:
                total += int(seg["total_size"])
        return total
