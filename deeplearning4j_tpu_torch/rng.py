"""RNG utilities: named, splittable randomness (counterpart of the JAX
package's ``rng.py``).

The reference threads a long `seed` through NeuralNetConfiguration
(reference ``nn/conf/NeuralNetConfiguration.java:483``) into ND4J's global
RNG. Here a key is a 64-bit int, derived deterministically by name, so
that streams are stable across processes and restarts; draws come from a
``torch.Generator`` seeded by the key on the given device.

The name hash (``_name_to_int``, blake2s over 4 bytes) is the JAX
package's, bit for bit. The draws are not: they come from PyTorch's
generators (Philox on the card, Mersenne Twister on the CPU) where the
reference draws from jax's threefry keys, so no draw equals the
reference's. Parity between the packages runs from loaded weights.
"""

from __future__ import annotations

import hashlib

import torch

from . import dtypes as _dtypes

_MASK64 = (1 << 64) - 1


def key(seed: int = 0) -> int:
    """A key: the seed as a 64-bit int."""
    return int(seed) & _MASK64


def _name_to_int(name: str) -> int:
    # Stable 32-bit hash (Python's hash() is salted per-process).
    return int.from_bytes(hashlib.blake2s(name.encode(), digest_size=4).digest(), "big")


def fold_name(k: int, name: str) -> int:
    """Derive a sub-key deterministically from a string name: blake2s of
    the key and the name's hash."""
    digest = hashlib.blake2s(
        int(k).to_bytes(8, "big") + _name_to_int(name).to_bytes(4, "big"),
        digest_size=8).digest()
    return int.from_bytes(digest, "big")


def split_named(k: int, names) -> dict:
    return {n: fold_name(k, n) for n in names}


def _generator(k: int, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by the key."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(k) & _MASK64)
    return gen


def uniform(k, shape, low=0.0, high=1.0, dtype=torch.float32,
            device="cuda") -> torch.Tensor:
    dev = _dtypes.resolve_device(device)
    u = torch.rand(shape, generator=_generator(k, dev), dtype=dtype,
                   device=dev)
    return low + (high - low) * u


def normal(k, shape, mean=0.0, std=1.0, dtype=torch.float32,
           device="cuda") -> torch.Tensor:
    dev = _dtypes.resolve_device(device)
    return mean + std * torch.randn(shape, generator=_generator(k, dev),
                                    dtype=dtype, device=dev)
