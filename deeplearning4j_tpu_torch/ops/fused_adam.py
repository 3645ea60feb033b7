"""Adam over many leaves in one pass: a hand-written multi-tensor CUDA
kernel and its plain version.

The port's plain adam (``optimize/updaters.py``) issues each leaf's update
op by op, 14 launches a leaf; :func:`adam_` updates every leaf it is given
in place in one launch (``csrc/fused_adam.cu``, one per
:data:`MAX_LEAVES` leaves), with the same f32 operations in the same order,
so p, m and v equal the plain path's bitwise. It replaces no TPU kernel:
the JAX package's adam is plain XLA that ``jit`` fuses.

Per element, with the step's scalars (:class:`Scalars`) and the leaf's
learning rate::

    m = b1·m + (1 − b1)·g
    v = b2·v + (1 − b2)·g²
    d = lr·(m·(1/bc1)) / (√(v·(1/bc2)) + ε)
    p = p − d

and ``d`` written out where the caller asks for the deltas (the health
stats read them).

* :func:`adam_plain` — the same sequence in PyTorch, walking the kernel's
  blocks (:func:`plan`, :func:`block_span`) so that it also covers every
  element exactly as the kernel does. The CPU path and the yardstick the
  kernel is held to.
* :func:`adam_cuda` — the kernel, for CUDA tensors that :func:`takes`
  admits; anything else raises, there is no fallback. Its launch tables
  (:func:`records`, :func:`tables`, :func:`launch`) are built from the
  leaves' pointers on every call: the gradients are new tensors each step,
  and nothing keeps a pointer that could go stale.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _nvcc

FUSED_ADAM = _nvcc.kernel("fused_adam")
CHUNK = 32768          # elements a block updates (csrc FUSED_ADAM_CHUNK)
MAX_LEAVES = 512       # leaves a launch's table holds (FUSED_ADAM_MAX_LEAVES)
PARAM_BYTES = 32764    # kernel parameter space since CUDA 12.1, which the
#                        kernel's ``Table`` (the scalars, MAX_LEAVES leaves) fits
# one leaf of a launch's table, laid out as the kernel's ``Leaf``
LEAF = np.dtype([("p", np.uint64), ("g", np.uint64), ("m", np.uint64),
                 ("v", np.uint64), ("d", np.uint64), ("n", np.int64),
                 ("chunk0", np.int32), ("lr", np.float32)])
SCALARS_BYTES = 32     # the kernel's ``Scalars``: 7 floats and the leaf count

# the device type whose tensors the kernel takes; a CPU test sets "cpu" to
# drive the fused step's routing, with the plain version in the kernel's place
DEVICE_TYPE = "cuda"
_F32 = np.float32
_F32T = torch.float32
_ARGS = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 7 \
    + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class Scalars:
    """One step's f32 scalars, as Python floats holding f32 values: the
    betas, one minus each (computed as the plain path computes ``1 - b``,
    in double, then rounded), the f32 reciprocals of the two bias
    corrections and epsilon."""

    b1: float
    omb1: float
    b2: float
    omb2: float
    ibc1: float
    ibc2: float
    eps: float

    @classmethod
    def at(cls, b1: float, b2: float, eps: float, iteration: int
           ) -> "Scalars":
        tstep = _F32(iteration) + _F32(1.0)
        bc1 = _F32(1.0) - np.power(_F32(b1), tstep)
        bc2 = _F32(1.0) - np.power(_F32(b2), tstep)
        return cls(*(float(_F32(x)) for x in (
            b1, 1 - b1, b2, 1 - b2, _F32(1.0) / bc1, _F32(1.0) / bc2, eps)))


def takes(*tensors) -> bool:
    """Does the kernel take a leaf of these tensors (its p, g, m, v)? Each
    a contiguous f32 tensor on a device of :data:`DEVICE_TYPE` (CUDA), all
    on one device and of one size. A pure rule of what the tensors show."""
    first = tensors[0]
    if not (first.is_cuda if DEVICE_TYPE == "cuda"
            else first.device.type == DEVICE_TYPE):
        return False
    index, n = first.get_device(), first.numel()
    for t in tensors:
        if (t.dtype is not _F32T or not t.is_contiguous()
                or t.get_device() != index or t.numel() != n):
            return False
    return True


def plan(lengths: Sequence[int]) -> List[List[Tuple[int, int]]]:
    """The launches for leaves of ``lengths``: lists of (leaf index, first
    chunk), at most :data:`MAX_LEAVES` a launch, each launch's chunks
    numbered from 0 in leaf order. Empty leaves take no chunk and no
    place."""
    launches: List[List[Tuple[int, int]]] = []
    at = 0
    for i, n in enumerate(lengths):
        if n <= 0:
            continue
        if not launches or len(launches[-1]) == MAX_LEAVES:
            launches.append([])
            at = 0
        launches[-1].append((i, at))
        at += -(-n // CHUNK)
    return launches


def launch_blocks(launch: List[Tuple[int, int]],
                  lengths: Sequence[int]) -> int:
    """The blocks of one launch: its last leaf's first chunk plus that
    leaf's chunks (what the C entry computes)."""
    i, chunk0 = launch[-1]
    return chunk0 + -(-lengths[i] // CHUNK)


def block_span(launch: List[Tuple[int, int]], lengths: Sequence[int],
               b: int) -> Tuple[int, int, int]:
    """(leaf index, start, end) that block ``b`` of ``launch`` updates: the
    kernel's binary search for the last leaf whose first chunk is at or
    before ``b``, and that leaf's ``b``-th chunk."""
    lo, hi = 0, len(launch) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if launch[mid][1] <= b:
            lo = mid
        else:
            hi = mid - 1
    i, chunk0 = launch[lo]
    start = (b - chunk0) * CHUNK
    return i, start, min(lengths[i], start + CHUNK)


def adam_plain(ps, gs, ms, vs, lrs, s: Scalars, ds=None) -> None:
    """The kernel's arithmetic in PyTorch, in place, block by block as the
    kernel walks the leaves. ``ps``, ``gs``, ``ms``, ``vs`` (and ``ds``,
    the delta outputs, or None) are equal-sized f32 tensors a leaf, ``lrs``
    the leaves' learning rates (f32 values)."""
    lengths = [p.numel() for p in ps]
    for group in plan(lengths):
        for b in range(launch_blocks(group, lengths)):
            i, lo, hi = block_span(group, lengths, b)
            p, g = ps[i].view(-1)[lo:hi], gs[i].view(-1)[lo:hi]
            m, v = ms[i].view(-1)[lo:hi], vs[i].view(-1)[lo:hi]
            m_new = s.b1 * m + s.omb1 * g
            v_new = s.b2 * v + s.omb2 * torch.square(g)
            d = lrs[i] * (m_new * s.ibc1) / (torch.sqrt(v_new * s.ibc2)
                                             + s.eps)
            m.copy_(m_new)
            v.copy_(v_new)
            p.sub_(d)
            if ds is not None:
                ds[i].view(-1)[lo:hi].copy_(d)


def _launched(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{FUSED_ADAM.name} kernel launch failed: CUDA "
                           f"error {err}")
    FUSED_ADAM.launches += 1


def records(ps, gs, ms, vs) -> List[Optional[tuple]]:
    """Per leaf, its entry of the kernel's table — (p, g, m, v pointers,
    length) — where the kernel takes the leaf (:func:`takes`), else None:
    the rule and the pointers in one pass, made anew on every call."""
    out = []
    for p, g, m, v in zip(ps, gs, ms, vs):
        out.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                    p.numel()) if takes(p, g, m, v) else None)
    return out


def tables(recs, lrs, ds=None) -> List[np.ndarray]:
    """The launches' parameter tables (:data:`LEAF` records, one array a
    launch) for leaves of entries ``recs`` (:func:`records`, none None),
    learning rates ``lrs`` and delta outputs ``ds`` (or None)."""
    lengths = [r[4] for r in recs]
    out = []
    for group in plan(lengths):
        out.append(np.array(
            [recs[i][:4] + (0 if ds is None else ds[i].data_ptr(),
                            recs[i][4], chunk0, lrs[i])
             for i, chunk0 in group], dtype=LEAF))
    return out


def launch(launch_tables: List[np.ndarray], s: Scalars, stream: int
           ) -> None:
    """One launch a table on ``stream`` (a ``cudaStream_t`` as an int)."""
    scalars = (s.b1, s.omb1, s.b2, s.omb2, s.ibc1, s.ibc2, s.eps)
    for table in launch_tables:
        # a profiler op (not a user range), so that a trace links the
        # kernel to it and to the ranges around it
        with torch._C._profiler._RecordFunctionFast("fused_adam"):
            _launched(FUSED_ADAM.fn(_ARGS)(table.ctypes.data, len(table),
                                           *scalars, stream))


def adam_cuda(ps, gs, ms, vs, lrs, s: Scalars, ds=None, recs=None
              ) -> None:
    """The kernel over every leaf, in place, on PyTorch's current stream:
    one launch a :data:`MAX_LEAVES` leaves. ``recs`` are the leaves'
    :func:`records` where the caller has them. Raises on a leaf the kernel
    does not take, a delta output that does not match its leaf, or leaves
    on two devices."""
    if not ps:
        return
    recs = records(ps, gs, ms, vs) if recs is None else recs
    for i, r in enumerate(recs):
        if r is None or (ds is not None and not takes(ps[i], ds[i])):
            raise ValueError(
                f"fused adam takes contiguous f32 CUDA leaves of one size on "
                f"one device; leaf {i} has "
                + ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device}"
                            for t in (ps[i], gs[i], ms[i], vs[i])))
    index = ps[0].get_device()
    if any(p.get_device() != index for p in ps):
        raise ValueError("fused adam takes leaves on one device")
    launch(tables(recs, lrs, ds), s,
           torch.cuda.current_stream(ps[0].device).cuda_stream)


def adam_(ps, gs, ms, vs, lrs, s: Scalars, ds=None, recs=None) -> None:
    """Adam over the leaves in place: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if ps and ps[0].is_cuda:
        adam_cuda(ps, gs, ms, vs, lrs, s, ds, recs)
    else:
        adam_plain(ps, gs, ms, vs, lrs, s, ds)
