"""Confusion matrix (counterpart of the JAX package's ``eval/confusion.py``;
plain numpy)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class ConfusionMatrix:
    """Dense integer confusion matrix over a fixed class set.

    Rows = actual class, columns = predicted class.
    """

    def __init__(self, classes: Sequence[int]):
        self.classes: List[int] = sorted(int(c) for c in classes)
        self._index: Dict[int, int] = {c: i for i, c in enumerate(self.classes)}
        n = len(self.classes)
        self.matrix = np.zeros((n, n), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.matrix[self._index[int(actual)], self._index[int(predicted)]] += count

    def grow_to(self, num_classes: int) -> None:
        """Extend the class set to [0, num_classes) preserving counts (used
        when integer labels reveal new classes in a later batch)."""
        n = len(self.classes)
        if num_classes <= n:
            return
        if self.classes != list(range(n)):
            raise ValueError("grow_to requires a contiguous 0..n-1 class set")
        new = np.zeros((num_classes, num_classes), dtype=np.int64)
        new[:n, :n] = self.matrix
        self.matrix = new
        self.classes = list(range(num_classes))
        self._index = {c: i for i, c in enumerate(self.classes)}

    def add_batch(self, actual: np.ndarray, predicted: np.ndarray,
                  weights: Optional[np.ndarray] = None) -> None:
        """Vectorized accumulation of a whole minibatch."""
        n = len(self.classes)
        idx = actual.astype(np.int64) * n + predicted.astype(np.int64)
        counts = np.bincount(idx, weights=weights, minlength=n * n)
        self.matrix += counts.reshape(n, n).astype(np.int64)

    def count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[self._index[int(actual)], self._index[int(predicted)]])

    def actual_total(self, cls: int) -> int:
        return int(self.matrix[self._index[int(cls)]].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.matrix[:, self._index[int(cls)]].sum())

    def total(self) -> int:
        return int(self.matrix.sum())

    def merge(self, other: "ConfusionMatrix") -> None:
        if other.classes != self.classes:
            raise ValueError("cannot merge confusion matrices over different class sets")
        self.matrix += other.matrix

    def to_csv(self) -> str:
        header = "actual\\predicted," + ",".join(str(c) for c in self.classes)
        rows = [header]
        for i, c in enumerate(self.classes):
            rows.append(str(c) + "," + ",".join(str(int(v)) for v in self.matrix[i]))
        return "\n".join(rows)

    def __str__(self) -> str:
        return self.to_csv()
