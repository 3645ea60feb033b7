"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions.

Counterpart of the JAX package's ``ops/flash_attention.py``: the forward
``_flash_fwd_btd`` (Pallas kernels ``_fwd_kernel_vmem`` /
``_fwd_kernel_stream``; tile math ``_masked_update`` / ``_finalize``) and
the backward ``_flash_bwd_btd_pallas`` (Pallas kernels ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel``; tile math ``_bwd_p_ds``) with its blockwise fallback
``_flash_bwd_btd``, joined by ``jax.custom_vjp`` there and by
:class:`FlashAttentionFunction` (a ``torch.autograd.Function``) here.

Layout: q/k/v are ``[b, t, h, d]`` — the JAX package's public layout — and
may be strided views (the ``qkv`` slices of ``SelfAttentionLayer`` are read
in place, with no transpose copy). The forward returns ``out [b, t, h, d]``
in the input dtype and ``lse [b, h, t]`` in f32 (``lse.reshape(b*h, t)``
is the reference's ``[bh, t]``). A ``[b, t]`` key mask (1 = attend) is
shared by the heads. Rows with no attendable key give out 0 and lse
``NEG_INF`` (-1e30); in the backward they give dq = 0, and masked keys
give dk = dv = 0, exactly. The mask gets no gradient.

* :func:`flash_attention_fwd_plain` / :func:`flash_attention_bwd_plain` —
  blockwise PyTorch mirrors of the reference tile math, in f32. The CPU
  path and the yardsticks the kernels are held against.
* the CUDA kernels (``csrc/flash_fwd.cu``; ``csrc/flash_bwd.cu`` with the
  Δ preprocess, dq and fused dk/dv entries; bf16 or f32, d ∈ {64, 128},
  ``t % 128 == 0``) — launched for CUDA tensors; anything they do not take
  raises, there is no fallback. The bf16 forward, dq and dk/dv kernels are
  wgmma kernels fed by TMA; :func:`tma_layout` is the host-side layout of
  the tensor maps they read q, k, v (and dO) through.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` pick by the
tensors' device.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from . import _nvcc

NEG_INF = -1e30
_HALF_NEG = NEG_INF / 2
BLOCK = 128                      # the t granularity the kernels require
HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

FLASH_FWD = _nvcc.kernel("flash_fwd")
FLASH_BWD_PREPROCESS = _nvcc.kernel("flash_bwd_preprocess", "flash_bwd")
FLASH_BWD_DQ = _nvcc.kernel("flash_bwd_dq", "flash_bwd")
FLASH_BWD_DKV = _nvcc.kernel("flash_bwd_dkv", "flash_bwd")

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# C signatures (csrc/*.cu): dtype and head dim, pointers, [b, t, h] strides,
# sizes, scale, causal, stream
_FWD_ARGS = [_I, _I] + [_P] * 6 + [_LL] * 9 + [_I] * 3 + [_F, _I, _P]
_PRE_ARGS = [_I, _I, _P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _I, _I, _I, _P]
_DQ_ARGS = [_I, _I] + [_P] * 8 + [_LL] * 12 + [_I] * 3 + [_F, _I, _P]
_DKV_ARGS = [_I, _I] + [_P] * 9 + [_LL] * 12 + [_I] * 3 + [_F, _I, _P]


def _resolve_scale(scale: Optional[float], d: int) -> float:
    return scale if scale is not None else 1.0 / float(d) ** 0.5


def _check(q, k, v, mask):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash attention needs equal [b, t, h, d] q/k/v "
                         f"shapes, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError("q, k and v must share a dtype")
    b, t = q.shape[:2]
    if mask is not None and tuple(mask.shape) != (b, t):
        raise ValueError(f"flash attention takes a [b, t] = {(b, t)} key "
                         f"mask, got {tuple(mask.shape)}")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def flash_attention_fwd_plain(q, k, v, mask=None, *, causal: bool = False,
                              scale: Optional[float] = None,
                              block_k: int = BLOCK
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise online softmax over k-blocks in f32, the reference's
    ``_masked_update``/``_finalize`` step for step. All query rows advance
    together; for a row that a causal k-block lies wholly past, the block's
    logits are NEG_INF and the update leaves its accumulators exactly as
    they were — the same result as the reference's loop that stops at the
    diagonal."""
    _check(q, k, v, mask)
    b, t, h, d = q.shape
    s = _resolve_scale(scale, d)
    if t % block_k:
        block_k = t
    qf = q.float().transpose(1, 2)              # [b, h, t, d]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    valid_all = (None if mask is None
                 else (mask.float() > 0)[:, None, None, :])   # [b,1,1,t]
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    num = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    rows = torch.arange(t, device=q.device)[:, None]
    for k0 in range(0, t, block_k):
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        logits = torch.matmul(qf, kb.transpose(-1, -2)) * s  # [b,h,t,bk]
        if valid_all is not None:
            logits = torch.where(valid_all[..., k0:k0 + block_k], logits,
                                 NEG_INF)
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None]
            logits = torch.where(rows >= cols, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        m_safe = torch.where(m_new <= _HALF_NEG, 0.0, m_new)
        p = torch.where(logits <= _HALF_NEG, 0.0,
                        torch.exp(logits - m_safe[..., None]))
        corr = torch.where(m <= _HALF_NEG, 0.0, torch.exp(m - m_safe))
        num = num * corr[..., None] + torch.matmul(p, vb)
        den = den * corr + p.sum(dim=-1)
        m = m_new
    out = num / torch.clamp(den, min=1e-30)[..., None]
    lse = torch.where(den > 0, m + torch.log(torch.clamp(den, min=1e-30)),
                      NEG_INF)
    return out.transpose(1, 2).to(q.dtype), lse


def flash_bwd_preprocess_plain(out, dout) -> torch.Tensor:
    """Δ [b, h, t] f32 = rowsum(dO∘O) over d, in f32."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)


def _bwd_blocks(q, k, v, mask, out, lse, dout, causal: bool, scale: float,
                block_k: int = BLOCK, absolute: bool = False):
    """The blockwise backward in f32, [b, h, t, d] results (dq, dk, dv).

    Per k-block of all query rows: P recomputed from lse (rows with
    lse = NEG_INF, masked keys and causal-future keys give P = 0),
    dS = P∘(dO·Vᵀ − Δ)·scale with Δ = rowsum(dO∘O), then dq += dS·K,
    dk = dSᵀ·Q and dv = Pᵀ·dO — the reference's ``_flash_bwd_btd``.
    With ``absolute`` the three products are taken over the absolute
    values of their operands (|dS|·|K|, |dS|ᵀ·|Q|, |P|ᵀ·|dO|), the sums
    that bound what rounding P and dS to bf16 can cost."""
    b, t, h, d = q.shape
    if t % block_k:
        block_k = t
    qf, kf, vf, dof = (x.float().transpose(1, 2)
                       for x in (q, k, v, dout))             # [b, h, t, d]
    delta = flash_bwd_preprocess_plain(out, dout)            # [b, h, t]
    lse = lse.float()
    dead = (lse <= _HALF_NEG)[..., None]                     # [b, h, t, 1]
    lse_safe = torch.where(dead[..., 0], 0.0, lse)[..., None]
    valid_all = (None if mask is None
                 else (mask.float() > 0)[:, None, None, :])  # [b, 1, 1, t]
    rows = torch.arange(t, device=q.device)[:, None]
    # the operands of the three gradient products
    qx, kx, dox = ((qf.abs(), kf.abs(), dof.abs()) if absolute
                   else (qf, kf, dof))
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for k0 in range(0, t, block_k):
        sl = slice(k0, k0 + block_k)
        kb = kf[:, :, sl]
        sc = torch.matmul(qf, kb.transpose(-1, -2)) * scale  # [b,h,t,bk]
        p = torch.where(dead, 0.0, torch.exp(sc - lse_safe))
        if valid_all is not None:
            p = torch.where(valid_all[..., sl], p, 0.0)
        if causal:
            cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None]
            p = torch.where(rows >= cols, p, 0.0)
        dp = torch.matmul(dof, vf[:, :, sl].transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        if absolute:
            ds = ds.abs()
        dq = dq + torch.matmul(ds, kx[:, :, sl])
        dk[:, :, sl] = torch.matmul(ds.transpose(-1, -2), qx)
        dv[:, :, sl] = torch.matmul(p.transpose(-1, -2), dox)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, mask, out, lse, dout, *,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              block_k: int = BLOCK
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) [b, t, h, d] in the input dtype: the blockwise f32
    backward of the reference's ``_flash_bwd_btd`` from the forward's
    ``out`` and ``lse [b, h, t]`` and the output cotangent ``dout``."""
    _check(q, k, v, mask)
    s = _resolve_scale(scale, q.shape[-1])
    grads = _bwd_blocks(q, k, v, mask, out, lse, dout, causal, s, block_k)
    return tuple(g.transpose(1, 2).to(q.dtype) for g in grads)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------


def _check_kernel_inputs(q, named):
    """What the kernels take: bf16 or f32, d 64 or 128, t % 128 == 0, and
    16-byte aligned rows with a contiguous head dim (16-byte vector loads
    on the bf16 path)."""
    b, t, h, d = q.shape
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim 64 or 128, got {d}")
    if t % BLOCK:
        raise ValueError(f"flash kernel needs t % {BLOCK} == 0, got t={t}")
    align = 16 // q.element_size()
    for name, x in named:
        if x.dtype != q.dtype or tuple(x.shape) != (b, t, h, d):
            raise ValueError(f"flash kernel: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {q.dtype} "
                             f"{(b, t, h, d)}")
        if x.stride(-1) != 1:
            raise ValueError(f"flash kernel needs a contiguous head dim "
                             f"({name}.stride(-1) = {x.stride(-1)})")
        if x.data_ptr() % 16 or any(st % align for st in x.stride()[:3]):
            raise ValueError(f"flash kernel needs 16-byte aligned rows of "
                             f"{name} (strides {x.stride()})")


# TMA (the bf16 forward and backward kernels' loads): one 4-D tensor map
# per operand
TMA_BOX_COLS = 64        # head-dim columns per box: 128 bytes of bf16
TMA_MAX_STRIDE = 1 << 40  # a map's byte strides stay below 2^40


def tma_layout(x, name: str = "x"):
    """The 4-D tensor map through which the bf16 forward, dq and dk/dv
    kernels read a strided ``[b, t, h, d]`` view (q, k, v and dO):
    ``(dims, byte_strides)`` with dims innermost first ``(d, h, t, b)`` and
    the byte strides of h, t and b. A dim of size 1 gets the stride it
    would have if packed, as the C side (``csrc/hopper.cuh``,
    ``encode_view``) gives it.

    Raises ValueError for a view TMA cannot read: a head dim that is not
    contiguous or not a multiple of 64 columns, a base address or a stride
    that is not a multiple of 16 bytes, a stride of 0 (a broadcast dim),
    or a stride of 2^40 bytes or more."""
    if x.ndim != 4:
        raise ValueError(f"tma_layout: {name} must be [b, t, h, d], got "
                         f"{tuple(x.shape)}")
    b, t, h, d = x.shape
    sb, st, sh, sd = x.stride()
    if d % TMA_BOX_COLS or sd != 1:
        raise ValueError(f"TMA reads {name} in boxes of {TMA_BOX_COLS} "
                         f"contiguous head-dim columns (d = {d}, "
                         f"stride {sd})")
    if h == 1:
        sh = d
    if b == 1:
        sb = st * t
    es = x.element_size()
    strides = (sh * es, st * es, sb * es)
    if x.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base of {name} "
                         f"(address % 16 = {x.data_ptr() % 16})")
    for dim, s in zip("htb", strides):
        if s <= 0 or s % 16 or s >= TMA_MAX_STRIDE:
            raise ValueError(f"TMA needs the {dim} stride of {name} to be "
                             f"a positive multiple of 16 bytes below 2^40, "
                             f"got {s} bytes (strides {x.stride()})")
    return (d, h, t, b), strides


def _kernel_mask(mask, device):
    """The [b, t] key mask as the kernels read it: f32, contiguous, 16-byte
    aligned (the bf16 forward bulk-copies it tile by tile)."""
    if mask is None:
        return None
    mask = mask.to(device=device, dtype=torch.float32).contiguous()
    return mask.clone() if mask.data_ptr() % 16 else mask


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launched(kernel: _nvcc.CudaKernel, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: CUDA "
                           f"error {err}")
    kernel.launches += 1


def _flash_fwd_cuda(q, k, v, mask, causal: bool, scale: float):
    b, t, h, d = q.shape
    _check_kernel_inputs(q, (("q", q), ("k", k), ("v", v)))
    if q.dtype == torch.bfloat16:   # the wgmma kernel loads through TMA
        for name, x in (("q", q), ("k", k), ("v", v)):
            tma_layout(x, name)
        if not scale > 0:
            raise ValueError(f"the bf16 flash forward takes a positive "
                             f"scale, got {scale}")
    mask = _kernel_mask(mask, q.device)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if lse.data_ptr() % 16:
        raise ValueError("flash forward needs a 16-byte aligned lse")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = FLASH_FWD.fn(_FWD_ARGS)(
        1 if q.dtype == torch.bfloat16 else 0, d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
        out.data_ptr(), lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, t, h, float(scale), int(bool(causal)), stream)
    _launched(FLASH_FWD, err)
    return out, lse


def _flash_bwd_preprocess_cuda(out, dout):
    """Δ [b, h, t] f32 = rowsum(dO∘O), the preprocess kernel."""
    b, t, h, d = out.shape
    delta = torch.empty((b, h, t), dtype=torch.float32, device=out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _launched(FLASH_BWD_PREPROCESS, FLASH_BWD_PREPROCESS.fn(_PRE_ARGS)(
        1 if out.dtype == torch.bfloat16 else 0, d, out.data_ptr(),
        *out.stride()[:3], dout.data_ptr(), *dout.stride()[:3],
        delta.data_ptr(), b, t, h, stream))
    return delta


def _bwd_entry_args(q, k, v, mask, lse, delta, dout):
    """The pointer and stride arguments the dq and dk/dv entries share."""
    mask = _kernel_mask(mask, q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            _ptr(mask), lse.data_ptr(), delta.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *dout.stride()[:3])
    return mask, ptrs, strides


def _flash_bwd_dq_cuda(q, k, v, mask, lse, delta, dout, causal: bool,
                       scale: float):
    """dq [b, t, h, d] from the dq kernel (inputs checked by the caller)."""
    b, t, h, d = q.shape
    mask, ptrs, strides = _bwd_entry_args(q, k, v, mask, lse, delta, dout)
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launched(FLASH_BWD_DQ, FLASH_BWD_DQ.fn(_DQ_ARGS)(
        1 if q.dtype == torch.bfloat16 else 0, d, *ptrs, dq.data_ptr(),
        *strides, b, t, h, float(scale), int(bool(causal)), stream))
    return dq


def _flash_bwd_dkv_cuda(q, k, v, mask, lse, delta, dout, causal: bool,
                        scale: float):
    """(dk, dv) [b, t, h, d] from the fused dk/dv kernel."""
    b, t, h, d = q.shape
    mask, ptrs, strides = _bwd_entry_args(q, k, v, mask, lse, delta, dout)
    dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
              for _ in range(2))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launched(FLASH_BWD_DKV, FLASH_BWD_DKV.fn(_DKV_ARGS)(
        1 if q.dtype == torch.bfloat16 else 0, d, *ptrs, dk.data_ptr(),
        dv.data_ptr(), *strides, b, t, h, float(scale), int(bool(causal)),
        stream))
    return dk, dv


def _flash_bwd_cuda(q, k, v, mask, out, lse, dout, causal: bool,
                    scale: float):
    """The three backward kernels: Δ = rowsum(dO∘O), then dq, then the
    fused dk/dv. ``lse`` is the forward's [b, h, t] f32."""
    b, t, h, d = q.shape
    _check_kernel_inputs(q, (("q", q), ("k", k), ("v", v), ("out", out),
                             ("dout", dout)))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, t):
        raise ValueError(f"flash backward takes the forward's f32 lse "
                         f"{(b, h, t)}, got {lse.dtype} {tuple(lse.shape)}")
    lse = lse.contiguous()
    if q.dtype == torch.bfloat16:   # the wgmma kernels load through TMA
        for name, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            tma_layout(x, name)
        if lse.data_ptr() % 16:
            raise ValueError("flash backward needs a 16-byte aligned lse")
    delta = _flash_bwd_preprocess_cuda(out, dout)
    dq = _flash_bwd_dq_cuda(q, k, v, mask, lse, delta, dout, causal, scale)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, mask, lse, delta, dout, causal,
                                 scale)
    return dq, dk, dv


# --------------------------------------------------------------------------
# dispatch, autograd, public op
# --------------------------------------------------------------------------


def _device_path(q):
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash-attention path for device {q.device}")
    return q.device.type == "cuda"


def _fwd(q, k, v, mask, causal, scale):
    if _device_path(q):
        return _flash_fwd_cuda(q, k, v, mask, causal, scale)
    return flash_attention_fwd_plain(q, k, v, mask, causal=causal, scale=scale)


def flash_attention_bwd(q, k, v, mask, out, lse, dout, *,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the CUDA kernels for CUDA tensors, the plain version
    for CPU tensors."""
    _check(q, k, v, mask)
    s = _resolve_scale(scale, q.shape[-1])
    if _device_path(q):
        return _flash_bwd_cuda(q, k, v, mask, out, lse, dout, causal, s)
    return flash_attention_bwd_plain(q, k, v, mask, out, lse, dout,
                                     causal=causal, scale=s)


class FlashAttentionFunction(torch.autograd.Function):
    """(out, lse) with a flash backward: the reference's ``custom_vjp``
    (``_core_fwd_rule``/``_core_bwd_rule``). It saves q, k, v, the mask,
    out and lse; its backward runs :func:`flash_attention_bwd` (the three
    kernels on CUDA, the plain backward on the CPU). lse and the mask get
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        out, lse = _fwd(q, k, v, mask, causal, scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, dout,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_fwd(q, k, v, mask=None, *, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [b, t, h, d], lse [b, h, t]): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors; differentiable in q, k and v
    through :class:`FlashAttentionFunction`."""
    _check(q, k, v, mask)
    s = _resolve_scale(scale, q.shape[-1])
    _device_path(q)
    return FlashAttentionFunction.apply(q, k, v, mask, bool(causal), s)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, mask=None) -> torch.Tensor:
    """[b, t, h, d] attention output (reference ``flash_attention``)."""
    return flash_attention_fwd(q, k, v, mask, causal=causal, scale=scale)[0]


# --------------------------------------------------------------------------
# bf16 bounds the kernels are held to
# --------------------------------------------------------------------------


def bf16_out_tolerance(q, k, v, mask, ref_out, *, causal: bool = False,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Elementwise bound on |kernel out − plain out| for bf16 inputs.

    The kernel rounds P to bf16 (unit roundoff 2^-8) for the P·V product
    while its denominator sums the f32 P, so before the last rounding its
    out is off by at most 2^-8·(P·|V|)/l, which is the plain forward on
    ``|v|``. Both sides then round out to bf16, at most one ulp (≤ 2^-7·|out|)
    apart. The bound doubles the first term for the f32 summation order:
    2^-7·(|ref_out| + (P·|V|)/l) + 2^-16."""
    pv_abs = flash_attention_fwd_plain(q, k, v.abs(), mask, causal=causal,
                                       scale=scale)[0].float()
    return 2.0 ** -7 * (ref_out.float().abs() + pv_abs) + 2.0 ** -16


def bf16_grad_tolerance(q, k, v, mask, out, lse, dout, ref_grads, *,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Elementwise bounds on |kernel − plain| for bf16 (dq, dk, dv).

    The kernels compute S and dP from the bf16 operands with f32 sums, as
    the plain backward does, and P and dS from them in f32. What differs
    is that each kernel rounds one f32 operand of its last product to bf16
    (unit roundoff 2^-8) before the tensor-core product: dS for dq = dS·K
    and dk = dSᵀ·Q, P for dv = Pᵀ·dO. A product X·Y whose f32 operand X is
    rounded is off by at most 2^-8·(|X|·|Y|) before its own rounding. Both
    sides then round the gradient to bf16, at most one ulp (≤ 2^-7·|g|)
    apart. Doubling the first term for the f32 summation order gives
    2^-7·(|ref| + |X|·|Y|) + 2^-16, with |X|·|Y| = |dS|·|K| for dq,
    |dS|ᵀ·|Q| for dk and |P|ᵀ·|dO| for dv (the plain backward on absolute
    values, ``_bwd_blocks(absolute=True)``)."""
    s = _resolve_scale(scale, q.shape[-1])
    abs_prods = _bwd_blocks(q, k, v, mask, out, lse, dout, causal, s,
                            absolute=True)
    return tuple(2.0 ** -7 * (ref.float().abs() + xy.transpose(1, 2))
                 + 2.0 ** -16 for ref, xy in zip(ref_grads, abs_prods))


def flash_available(q, mask) -> bool:
    """Should the flash path serve this call? ``q`` is the [b, t, h, d]
    query tensor (k/v equal-shaped, checked by the caller).

    ``DL4JTPU_FLASH_ATTENTION``: ``1`` forces flash on, ``0`` off; unset =
    auto, which is on for every eligible call on CUDA and off on the CPU.
    Eligible, as in the reference: ``t % 128 == 0`` and a mask that is None
    or [b, t]. A head dim or dtype the CUDA kernel does not take then
    raises there. (The reference's auto threshold of t ≥ 4096 was measured
    on a TPU and does not carry over.)"""
    flag = os.environ.get("DL4JTPU_FLASH_ATTENTION", "auto")
    b, t = q.shape[:2]
    if flag == "0" or t % BLOCK:
        return False
    if mask is not None and tuple(mask.shape) != (b, t):
        return False
    return flag == "1" or q.device.type == "cuda"
