"""The one generator of traffic. A mix is a data file,
``benchmark/traffic/<name>.json``, whose ``kind`` names the module of
``harness/`` that drives it (``drive_<kind>.py``). Kind ``fit`` feeds
training batches: ``inputs`` is ``token_ids`` (``batch`` rows of
``seq_len`` + 1 ids uniform over the vocabulary, inputs and targets
shifted by one) or ``images`` (``batch`` NHWC images, standard normal, cut
from a ``pool`` of distinct batches made on the device once, and one-hot
labels uniform over the classes).

Batch ``i`` depends on the seed and its index alone.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _rng(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *index])


class FitBatches:
    """``batches(i)`` → host arrays ``(x, y)`` of training batch ``i``."""

    def __init__(self, traffic: dict, cfg: dict, seed: int, device):
        self.traffic, self.cfg, self.seed = traffic, cfg, int(seed)
        self.batch = int(traffic["batch"])
        self.inputs = traffic["inputs"]
        self.pool = None
        if self.inputs == "images":
            size, ch = cfg["image_size"], cfg["num_channels"]
            gen = torch.Generator(device=device)
            gen.manual_seed(self.seed + 1)
            self.pool = torch.randn(
                (int(traffic["pool"]), self.batch, size, size, ch),
                generator=gen, device=device).cpu().numpy()
        elif self.inputs != "token_ids":
            raise ValueError(f"unknown fit inputs {self.inputs!r}")

    def __call__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = _rng(self.seed, i)
        if self.inputs == "token_ids":
            ids = rng.integers(0, self.cfg["vocab_size"],
                               (self.batch, int(self.traffic["seq_len"]) + 1),
                               dtype=np.int64).astype(np.int32)
            return ids[:, :-1], ids[:, 1:]
        classes = self.cfg["num_labels"]
        labels = np.zeros((self.batch, classes), np.float32)
        labels[np.arange(self.batch), rng.integers(0, classes, self.batch)] = 1
        return self.pool[i % len(self.pool)], labels
