"""The arithmetic of the plain references: float32 with TF32 off, or, for
a control, the step below the precision a configuration states. Below
mixed bf16 (bf16 activations and products, f32 parameters) is e4m3
products: the operands of every matrix product and convolution are
rounded to float8 e4m3 with one scale per tensor, in the forward and, for
the gradients flowing back, in the backward; sums accumulate in float32
and activations stay float32, as a program that ran only its GEMMs in
fp8 would. Below float32 is TF32 products. Plain PyTorch; imports nothing
of the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
# the control's arithmetic for the precision a configuration states
CONTROL = {"mixed_bf16": "e4m3", "float32": "tf32"}


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def exact_f32() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    set_tf32(False)


@contextlib.contextmanager
def _tf32():
    set_tf32(True)
    try:
        yield
    finally:
        set_tf32(False)


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (amax to
    448), returned in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class _MatmulE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_e4m3(a), to_e4m3(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gq = to_e4m3(g)
        ga = torch.matmul(gq, to_e4m3(b).transpose(-1, -2))
        gb = torch.matmul(to_e4m3(a).transpose(-1, -2), gq)
        return _sum_to(ga, a.shape), _sum_to(gb, b.shape)


class _Conv2dE4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return F.conv2d(to_e4m3(x), to_e4m3(w), stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gq, xq, wq = to_e4m3(g), to_e4m3(x), to_e4m3(w)
        gx = torch.nn.grad.conv2d_input(x.shape, wq, gq, stride=ctx.stride)
        gw = torch.nn.grad.conv2d_weight(xq, w.shape, gq, stride=ctx.stride)
        return gx, gw, None


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    while g.ndim > len(shape):
        g = g.sum(0)
    return g


class Arithmetic:
    """The products of one reference run: ``"f32"``, ``"tf32"`` or
    ``"e4m3"``. TF32 is a process setting: a TF32 run's forward and
    backward run inside :meth:`scope`."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "tf32", "e4m3"):
            raise ValueError(f"unknown reference arithmetic {kind!r}")
        self.kind = kind

    def scope(self):
        """The scope a forward and its backward run in."""
        return _tf32() if self.kind == "tf32" else contextlib.nullcontext()

    def matmul(self, a, b):
        if self.kind == "e4m3":
            return _MatmulE4M3.apply(a, b)
        return torch.matmul(a, b)

    def conv2d(self, x, w, stride):
        """NCHW ``x``, OIHW ``w``, already padded."""
        if self.kind == "e4m3":
            return _Conv2dE4M3.apply(x, w, stride)
        return F.conv2d(x, w, stride=stride)
