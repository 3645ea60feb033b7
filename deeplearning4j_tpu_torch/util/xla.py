"""Step-function bookkeeping: signature counting, measured costs and the
trace-time routing key (counterpart of the JAX package's ``util/xla.py``).

The reference's module holds two kinds of things. Its compiler settings,
``scan_unroll`` (``lax.scan``'s unroll factor for the K-step loops) and
``train_step_options`` (``compiler_options`` handed to ``jax.jit``), tune
XLA's compilation of one traced program and have no counterpart here:
the port's training step is eager PyTorch, dispatched op by op, so there
is no scan to unroll and no compiler to hand options to (``fit_scan`` is
a Python loop of ordinary steps).

What carries over is the accounting around a step function:

- :func:`retrace_guard` counts the distinct call signatures (shapes and
  dtypes of the tensor arguments, values of the scalars) a wrapped
  callable sees into ``jit_retraces_total{fn}`` — the counter that
  ``util/capture.py`` owns for CUDA graph captures — and logs the
  signature that differs (``DL4JTPU_RETRACE_WARN=1``). Under PyTorch a
  new signature costs no compilation, but it is still the event the
  reference's regression tests pin (one signature per steady-state fit);
- on the first call of each signature it records the call's wall time in
  ``xla_compile_seconds{fn}`` and the call's FLOPs, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` around that real call
  (no second execution), in ``compiled_flops{fn}`` — the number
  ``util.ingest``'s live MFU meter divides by wall time. The counting
  mode sees only the operators the dispatcher runs; a hand-written
  kernel launched outside it (the flash-attention kernels, called
  through ctypes) reports its own FLOPs by :func:`count_kernel_flops`;
- :func:`trace_env_key` and :func:`pow2_bucket` as in the reference.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")


def trace_env_key() -> str:
    """Cache-key suffix naming every environment flag that changes which
    route a step takes (the flash-attention routing flags): a per-key
    cache (``util/capture.py``) keyed with it builds a fresh entry after
    a flag flips."""
    return (f"fa={os.environ.get('DL4JTPU_FLASH_ATTENTION', 'auto')}"
            f"|fabwd={os.environ.get('DL4JTPU_FLASH_BWD', 'pallas')}")


def pow2_bucket(n: int, cap: int) -> int:
    """Round ``n`` up to the next power of two, capped at ``cap`` (itself a
    power of two): the rule for every dispatch-shape axis (the decode
    engine's lane buckets and fused block length), so any requested size
    maps into a fixed, enumerable set of shapes."""
    if n < 1:
        raise ValueError(f"bucketed size must be >= 1, got {n}")
    if cap < 1 or (cap & (cap - 1)):
        raise ValueError(f"cap must be a power of two, got {cap}")
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


# ----------------------------------------------------------------------
# measured-cost metrics
# ----------------------------------------------------------------------

def _reg(registry=None):
    from . import metrics as _metrics
    return registry if registry is not None else _metrics.REGISTRY


def compile_seconds_histogram(registry=None):
    from . import capture as _capture
    return _capture.compile_seconds_histogram(_reg(registry))


def compiled_flops_gauge(registry=None):
    return _reg(registry).gauge(
        "compiled_flops",
        "FLOPs of one call per guarded step function, counted by "
        "torch.utils.flop_counter on the first call of its latest "
        "signature (measured from the dispatched operators, plus the "
        "FLOPs the hand-written kernels launched in it report)", ("fn",))


# the FLOPs hand-written kernels report while compiled_costs counts; a
# list, so a launch on autograd's backward thread adds to the same tally
_kernel_tally: Optional[list] = None
_kernel_tally_lock = threading.Lock()


def count_kernel_flops(flops: float) -> None:
    """Called by the wrapper of a kernel that the dispatcher does not run
    (so ``FlopCounterMode`` cannot see it) at each launch, with the
    kernel's matrix-product FLOPs: they are added to the count of a
    :func:`compiled_costs` call in progress, and ignored otherwise."""
    tally = _kernel_tally
    if tally is not None:
        with _kernel_tally_lock:
            tally[0] += flops


def cost_analysis_enabled() -> bool:
    """``DL4JTPU_COST_ANALYSIS=0`` skips the FLOP count of a new
    signature's first call (the counting mode slows that call's host
    dispatch)."""
    return os.environ.get("DL4JTPU_COST_ANALYSIS", "1") != "0"


def compiled_costs(fn: Callable, *args, **kwargs
                   ) -> Tuple[Any, Optional[Dict[str, float]]]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` and
    return ``(result, {"flops": ...})`` (None when nothing was counted).
    The call is the real one: its result is the caller's. The count
    includes what hand-written kernels launched in the call report
    (:func:`count_kernel_flops`)."""
    global _kernel_tally
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    outer, tally = _kernel_tally, [0.0]
    _kernel_tally = tally
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        _kernel_tally = outer
    if outer is not None:
        count_kernel_flops(tally[0])
    flops = float(counter.get_total_flops()) + tally[0]
    return out, ({"flops": flops} if flops else None)


# ----------------------------------------------------------------------
# retrace guard
# ----------------------------------------------------------------------

def _leaf_sig(leaf):
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return ("a", tuple(leaf.shape), str(leaf.dtype))
    if leaf is None or isinstance(leaf, (bool, int, float, str)):
        return ("v", leaf)
    if isinstance(leaf, (list, tuple)):
        return (type(leaf).__name__, tuple(_leaf_sig(e) for e in leaf))
    if isinstance(leaf, dict):
        return ("d", tuple((k, _leaf_sig(v)) for k, v in sorted(leaf.items())))
    return ("t", type(leaf).__name__)


def _abstract_signature(args: tuple, kwargs: dict) -> Tuple:
    """The (shape, dtype) skeleton of a call: tensors and arrays by shape
    and dtype, scalars by value, containers element by element, anything
    else by type."""
    return (_leaf_sig(args), _leaf_sig(kwargs))


def retrace_guard(fn: Callable, name: str, registry=None) -> Callable:
    """Wrap ``fn`` to count its distinct call signatures into
    ``jit_retraces_total{fn=name}`` and measure each new one's first call.

    A new signature records ``xla_compile_seconds{fn}`` (the wall time of
    that call, host dispatch included), ``compiled_flops{fn}`` (its FLOPs,
    :func:`compiled_costs`; also on ``wrapped.compiled_costs``) and a
    ``compile`` flight-recorder event (signatures after the first carry
    the differing signature). ``DL4JTPU_RETRACE_WARN=1`` logs every
    signature after the first beside the previous one.
    """
    from . import capture as _capture
    from . import flightrecorder as _flight
    counter = _capture.retrace_counter(_reg(registry))
    compile_hist = compile_seconds_histogram(registry)
    flops_gauge = compiled_flops_gauge(registry)
    seen: Dict[Tuple, int] = {}
    last: list = []

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        key = _abstract_signature(args, kwargs)
        if key in seen:
            return fn(*args, **kwargs)
        idx = seen[key] = len(seen)
        counter.inc(fn=name)
        if idx > 0 and os.environ.get("DL4JTPU_RETRACE_WARN") == "1":
            logger.warning(
                "retrace #%d of %s — new abstract signature:\n  now:  "
                "%s\n  prev: %s", idx, name, key, last[0] if last else "?")
        prev = last[0] if last else None
        last[:] = [key]
        t0 = time.perf_counter()
        if cost_analysis_enabled():
            out, costs = compiled_costs(fn, *args, **kwargs)
        else:
            out, costs = fn(*args, **kwargs), None
        dt = time.perf_counter() - t0
        compile_hist.observe(dt, fn=name)
        event = {"fn": name, "signature_idx": idx,
                 "compile_seconds": round(dt, 4)}
        if costs is not None:
            wrapped.compiled_costs = costs
            flops_gauge.set(costs["flops"], fn=name)
            event["flops"] = costs["flops"]
        if idx > 0:
            event["signature"] = str(key)
            event["prev_signature"] = str(prev)
        _flight.record("compile", **event)
        return out

    wrapped.signatures_seen = seen
    wrapped.compiled_costs = None
    return wrapped
