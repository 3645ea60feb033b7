"""Dtype policy (counterpart of the JAX package's ``dtypes.py``).

Parameters in float32, matmul compute in bfloat16 under ``mixed_bf16``,
outputs in bfloat16 — the same names and the same split as the reference,
mapped onto torch dtypes. Also the map from the checkpoint's
``dtypes.json`` names to torch dtypes (the reference uses ``ml_dtypes``;
the port does not need it).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """What dtype to use where.

    param_dtype:   dtype parameters are stored in.
    compute_dtype: dtype inputs/params are cast to for matmuls.
    output_dtype:  dtype activations are returned in (None = compute_dtype).
    """

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = None

    def cast_to_compute(self, *tensors):
        out = tuple(t.to(self.compute_dtype) if torch.is_tensor(t) else t
                    for t in tensors)
        return out[0] if len(out) == 1 else out


FLOAT32 = DtypePolicy()
# Mixed precision: bf16 compute, f32 params.
MIXED_BF16 = DtypePolicy(param_dtype=torch.float32,
                         compute_dtype=torch.bfloat16,
                         output_dtype=torch.bfloat16)
FLOAT64 = DtypePolicy(param_dtype=torch.float64, compute_dtype=torch.float64)


def policy_from_name(name: str) -> DtypePolicy:
    name = name.lower()
    if name in ("float32", "f32", "single"):
        return FLOAT32
    if name in ("bfloat16", "bf16", "mixed", "mixed_bf16", "mixed_bfloat16"):
        return MIXED_BF16
    if name in ("float64", "f64", "double"):
        return FLOAT64
    raise ValueError(f"unknown dtype policy {name!r}")


def promote_to_f32(dtype: torch.dtype) -> torch.dtype:
    """``jnp.promote_types(dtype, float32)`` for floating dtypes."""
    return torch.promote_types(dtype, torch.float32)


# dtype names as numpy / ml_dtypes spell them in a checkpoint's dtypes.json
_TORCH_BY_NAME = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_BY_NAME[name]
    except KeyError:
        raise ValueError(f"dtype {name!r} has no torch counterpart") from None


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` is the default of every
    entry point and needs a card: without one this raises instead of
    running on the CPU unasked — pass ``device="cpu"`` for that."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


@contextlib.contextmanager
def exact_f32_matmul():
    """f32 products in full f32 inside the block (no TF32 or bf16 passes,
    whatever the process-wide setting); the setting is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
