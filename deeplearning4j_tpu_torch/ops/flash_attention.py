"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of the JAX package's ``ops/flash_attention.py`` forward
(``_flash_fwd_btd`` → the Pallas kernels ``_fwd_kernel_vmem`` /
``_fwd_kernel_stream``; tile math ``_masked_update`` / ``_finalize``).

Layout: q/k/v are ``[b, t, h, d]`` — the JAX package's public layout — and
may be strided views (the ``qkv`` slices of ``SelfAttentionLayer`` are read
in place, with no transpose copy). The forward returns ``out [b, t, h, d]``
in the input dtype and ``lse [b, h, t]`` in f32 (``lse.reshape(b*h, t)``
is the reference's ``[bh, t]``). A ``[b, t]`` key mask (1 = attend) is
shared by the heads. Rows with no attendable key give out 0 and lse
``NEG_INF`` (-1e30).

* :func:`flash_attention_fwd_plain` — blockwise PyTorch mirror of the
  reference tile math, in f32. The CPU path and the yardstick the kernel
  is held against.
* the CUDA kernel (``csrc/flash_fwd.cu``, bf16 or f32, d ∈ {64, 128},
  ``t % 128 == 0``) — launched for CUDA tensors; anything it does not take
  raises, there is no fallback.

:func:`flash_attention_fwd` picks by the tensors' device. This slice has no
backward kernel: the CUDA path refuses inputs that would need a gradient.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from . import _nvcc

NEG_INF = -1e30
_HALF_NEG = NEG_INF / 2
BLOCK = 128                      # the t granularity the kernel requires
HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

FLASH_FWD = _nvcc.kernel("flash_fwd")


def _flash_fwd_c():
    """The kernel library's C entry point, with its ctypes signature."""
    fn = FLASH_FWD.lib().flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


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


def _flash_fwd_cuda(q, k, v, mask, causal: bool, scale: float):
    b, t, h, d = q.shape
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "the CUDA flash-attention forward has no backward kernel yet; "
            "call it under torch.no_grad()/inference_mode() or on inputs "
            "that do not require grad")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim 64 or 128, got {d}")
    if t % BLOCK:
        raise ValueError(f"flash kernel needs t % {BLOCK} == 0, got t={t}")
    # 16-byte vector loads (bf16 path): every row start must be aligned
    align = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"flash kernel needs a contiguous head dim "
                             f"({name}.stride(-1) = {x.stride(-1)})")
        if x.data_ptr() % 16 or any(st % align for st in x.stride()[:3]):
            raise ValueError(f"flash kernel needs 16-byte aligned rows of "
                             f"{name} (strides {x.stride()})")
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _flash_fwd_c()(
        1 if q.dtype == torch.bfloat16 else 0, d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, t, h, float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    FLASH_FWD.launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, mask=None, *, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [b, t, h, d], lse [b, h, t]): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check(q, k, v, mask)
    s = _resolve_scale(scale, q.shape[-1])
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, mask, causal, s)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, mask, causal=causal, scale=s)
    raise ValueError(f"no flash-attention path for device {q.device}")


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, mask=None) -> torch.Tensor:
    """[b, t, h, d] attention output (reference ``flash_attention``)."""
    return flash_attention_fwd(q, k, v, mask, causal=causal, scale=scale)[0]


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
