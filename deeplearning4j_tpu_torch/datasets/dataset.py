"""DataSet: features + labels (+ masks) container (a copy of the JAX
package's ``datasets/dataset.py``, host numpy code).

ND4J's ``DataSet`` API is the currency of every ``fit``/iterator
signature: ``get_features``, ``get_labels``, ``split_test_and_train``,
``shuffle``, ``batch_by``. Shuffles and samples use numpy's seeded
generator exactly as the reference does, so the same seed orders the
examples identically in both packages.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class SplitTestAndTrain(NamedTuple):
    train: "DataSet"
    test: "DataSet"


def _as_array(x):
    """Keep arrays and tensors as they are; coerce lists/scalars to numpy."""
    if x is None or hasattr(x, "shape"):
        return x
    return np.asarray(x)


class DataSet:
    def __init__(self, features, labels,
                 features_mask=None, labels_mask=None):
        self.features = _as_array(features)
        self.labels = _as_array(labels)
        self.features_mask = _as_array(features_mask)
        self.labels_mask = _as_array(labels_mask)

    def num_examples(self) -> int:
        return self.features.shape[0]

    def get_features(self) -> np.ndarray:
        return self.features

    def get_labels(self) -> np.ndarray:
        return self.labels

    def _take(self, idx) -> "DataSet":
        return DataSet(
            self.features[idx], self.labels[idx],
            None if self.features_mask is None else self.features_mask[idx],
            None if self.labels_mask is None else self.labels_mask[idx])

    def shuffle(self, seed: Optional[int] = None) -> None:
        order = np.random.default_rng(seed).permutation(self.num_examples())
        self.features = self.features[order]
        self.labels = self.labels[order]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[order]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[order]

    def split_test_and_train(self, fraction_or_count) -> SplitTestAndTrain:
        """Split off the first `n` (or fraction) examples as train, rest test
        (parity: ``DataSet.splitTestAndTrain``)."""
        n = self.num_examples()
        k = (int(round(n * fraction_or_count))
             if isinstance(fraction_or_count, float) else int(fraction_or_count))
        k = max(0, min(n, k))
        return SplitTestAndTrain(self._take(slice(0, k)), self._take(slice(k, n)))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self._take(slice(i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]

    def sample(self, n: int, seed: Optional[int] = None,
               with_replacement: bool = True) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.num_examples(), size=n, replace=with_replacement)
        return self._take(idx)

    @staticmethod
    def merge(datasets: List["DataSet"]) -> "DataSet":
        feats = np.concatenate([d.features for d in datasets], axis=0)
        labels = np.concatenate([d.labels for d in datasets], axis=0)
        fm = (np.concatenate([d.features_mask for d in datasets], axis=0)
              if datasets and datasets[0].features_mask is not None else None)
        lm = (np.concatenate([d.labels_mask for d in datasets], axis=0)
              if datasets and datasets[0].labels_mask is not None else None)
        return DataSet(feats, labels, fm, lm)

    def scale_min_max(self, lo: float = 0.0, hi: float = 1.0) -> None:
        """Min-max normalize features in place (parity: DataSet.scaleMinAndMax)."""
        fmin = self.features.min()
        fmax = self.features.max()
        rng = fmax - fmin
        if rng > 0:
            self.features = (self.features - fmin) / rng * (hi - lo) + lo

    def normalize_zero_mean_unit_variance(self) -> None:
        mean = self.features.mean(axis=0, keepdims=True)
        std = self.features.std(axis=0, keepdims=True)
        self.features = (self.features - mean) / np.where(std > 0, std, 1.0)

    def as_tuple(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        return self.features, self.labels, self.features_mask

    def __repr__(self) -> str:
        return (f"DataSet(features={self.features.shape}, "
                f"labels={self.labels.shape})")


class MultiDataSet:
    """Multiple named-position inputs/outputs for ComputationGraph training
    (parity: ND4J ``MultiDataSet`` — lists of feature/label arrays + masks,
    the currency of ``RecordReaderMultiDataSetIterator``)."""

    def __init__(self, features: List, labels: List,
                 features_masks: Optional[List] = None,
                 labels_masks: Optional[List] = None):
        self.features = [_as_array(f) for f in features]
        self.labels = [_as_array(l) for l in labels]
        self.features_masks = (None if features_masks is None
                               else [_as_array(m) for m in features_masks])
        self.labels_masks = (None if labels_masks is None
                             else [_as_array(m) for m in labels_masks])

    def num_examples(self) -> int:
        return self.features[0].shape[0]

    def num_inputs(self) -> int:
        return len(self.features)

    def num_outputs(self) -> int:
        return len(self.labels)

    @staticmethod
    def merge(datasets: List["MultiDataSet"]) -> "MultiDataSet":
        n_in = datasets[0].num_inputs()
        n_out = datasets[0].num_outputs()
        feats = [np.concatenate([d.features[i] for d in datasets], axis=0)
                 for i in range(n_in)]
        labels = [np.concatenate([d.labels[i] for d in datasets], axis=0)
                  for i in range(n_out)]
        fm = (None if datasets[0].features_masks is None else
              [np.concatenate([d.features_masks[i] for d in datasets], axis=0)
               for i in range(n_in)])
        lm = (None if datasets[0].labels_masks is None else
              [np.concatenate([d.labels_masks[i] for d in datasets], axis=0)
               for i in range(n_out)])
        return MultiDataSet(feats, labels, fm, lm)

    def __repr__(self) -> str:
        return (f"MultiDataSet(inputs={[f.shape for f in self.features]}, "
                f"outputs={[l.shape for l in self.labels]})")
