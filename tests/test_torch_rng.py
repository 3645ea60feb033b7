"""The port's ``rng.py``: the JAX package's names over ``torch.Generator``s.

The name hash equals the reference's bit for bit; the draws come from
PyTorch's generators (they cannot equal jax threefry's), so they are
held to determinism, to distinct streams per name and to their moments.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import rng as j_rng
from deeplearning4j_tpu_torch import rng

N = 200_000         # draws for the moment checks; bounds are 6 standard errors


@pytest.mark.parametrize("name", ["", "layer_0", "dropout/blk3", "ü-名前",
                                  "x" * 1000])
def test_name_hash_equals_the_reference(name):
    assert rng._name_to_int(name) == j_rng._name_to_int(name)
    assert 0 <= rng._name_to_int(name) < 2 ** 32


def test_keys_are_64_bit_ints():
    assert rng.key(7) == 7 and rng.key() == 0
    assert rng.key(-1) == 2 ** 64 - 1
    k = rng.fold_name(rng.key(3), "w")
    assert isinstance(k, int) and 0 <= k < 2 ** 64
    assert rng.split_named(rng.key(3), ["w", "b"]) == {
        "w": k, "b": rng.fold_name(rng.key(3), "b")}


@pytest.mark.parametrize("draw", ["uniform", "normal"])
def test_draws_are_deterministic(draw):
    k = rng.fold_name(rng.key(11), "init")
    a = getattr(rng, draw)(k, (64, 3), device="cpu")
    b = getattr(rng, draw)(k, (64, 3), device="cpu")
    assert a.shape == (64, 3) and a.dtype == torch.float32
    assert torch.equal(a, b)
    c = getattr(rng, draw)(k, (64, 3), dtype=torch.float64, device="cpu")
    assert c.dtype == torch.float64


def test_distinct_names_and_seeds_give_distinct_streams():
    keys = [rng.fold_name(rng.key(s), n) for s in (0, 1)
            for n in ("a", "b", "layer_0", "layer_1")]
    assert len(set(keys)) == len(keys)
    draws = [rng.uniform(k, (32,), device="cpu") for k in keys]
    for i in range(len(draws)):
        for j in range(i + 1, len(draws)):
            assert not torch.equal(draws[i], draws[j])
    # folding is order-sensitive: (a, b) and (b, a) differ
    assert rng.fold_name(rng.fold_name(1, "a"), "b") != \
        rng.fold_name(rng.fold_name(1, "b"), "a")


@pytest.mark.parametrize("low,high", [(0.0, 1.0), (-2.0, 3.0)])
def test_uniform_moments(low, high):
    u = rng.uniform(rng.key(5), (N,), low, high,
                    dtype=torch.float64, device="cpu").numpy()
    assert low <= u.min() and u.max() < high
    width = high - low
    se_mean = width / np.sqrt(12 * N)
    assert abs(u.mean() - (low + high) / 2) <= 6 * se_mean
    assert abs(u.var() - width ** 2 / 12) <= 6 * width ** 2 / 12 * np.sqrt(
        0.8 / N)


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (3.0, 0.5)])
def test_normal_moments(mean, std):
    x = rng.normal(rng.key(6), (N,), mean, std, dtype=torch.float64,
                   device="cpu").numpy()
    assert abs(x.mean() - mean) <= 6 * std / np.sqrt(N)
    assert abs(x.std() - std) <= 6 * std / np.sqrt(2 * N)
    z = (x - mean) / std
    assert abs((z ** 3).mean()) <= 6 * np.sqrt(15 / N)          # skew 0
    assert abs((z ** 4).mean() - 3.0) <= 6 * np.sqrt(96 / N)    # kurtosis 3


def test_the_card_is_the_default_and_is_never_faked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rng.uniform(rng.key(0), (2,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rng.normal(rng.key(0), (2,))
