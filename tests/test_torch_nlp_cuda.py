"""The embedding steps on the card against the same steps on the CPU.

Card-only (``-m cuda``; skipped without a card): ``ns_step`` and
``hs_step`` (skip-gram and CBOW) from the same tables and batch, with
heavy row collisions, on the card and on the CPU — every table within
``CARD_ATOL`` (float sums in another order) — and two card runs bitwise
equal (the sorted scatter-adds of ``nlp/learning.py``). This file imports
no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_nlp_cuda.py``.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nlp import learning

CARD_ATOL = 2e-6
V, D, B, K, W, L = 5000, 128, 8192, 5, 10, 14


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"center": rng.integers(0, 200, B).astype(np.int32),
            "target": rng.integers(0, 600, B).astype(np.int32),
            "negs": rng.integers(0, 600, (B, K)).astype(np.int32),
            "ctx": rng.integers(0, 600, (B, W)).astype(np.int32),
            "ctx_mask": (rng.random((B, W)) < 0.7).astype(np.float32),
            "codes": rng.integers(0, 2, (B, L)).astype(np.int32),
            "points": rng.integers(0, 300, (B, L)).astype(np.int32),
            "code_mask": (np.arange(L)[None, :]
                          < rng.integers(1, L + 1, B)[:, None]
                          ).astype(np.float32)}


def tables(kind, seed=1):
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(V - 1 if kind == "hs" else V, D)) * 0.1
    return {"syn0": (rng.normal(size=(V, D)) * 0.1).astype(np.float32),
            "syn1" if kind == "hs" else "syn1neg": out.astype(np.float32)}


def run(kind, cbow, device):
    b = batch()
    names = (("center", "target", "negs") if kind == "ns" else
             ("center", "codes", "points", "code_mask")) + ("ctx", "ctx_mask")
    p = learning.params_from_numpy(tables(kind), device)
    step = getattr(learning, f"{kind}_step")
    for lr in (0.025, 0.0125):
        p, loss = step(p, *learning.to_device([b[n] for n in names], device),
                       lr, cbow=cbow)
    return {k: v.cpu().numpy() for k, v in p.items()}, float(loss)


@pytest.mark.cuda
@pytest.mark.parametrize("cbow", [False, True])
@pytest.mark.parametrize("kind", ["ns", "hs"])
def test_card_step_matches_the_cpu_step(kind, cbow):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu, cpu_loss = run(kind, cbow, "cpu")
    card, card_loss = run(kind, cbow, "cuda")
    again, again_loss = run(kind, cbow, "cuda")
    for k in cpu:
        assert np.abs(card[k] - cpu[k]).max() <= CARD_ATOL, k
        assert card[k].tobytes() == again[k].tobytes(), k
    assert abs(card_loss - cpu_loss) <= 1e-6 * abs(cpu_loss)
    assert card_loss == again_loss
