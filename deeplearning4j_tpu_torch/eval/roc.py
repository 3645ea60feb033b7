"""ROC curves and AUC (counterpart of the JAX package's ``eval/roc.py``;
plain numpy on the host, the same numbers).

The counts of true and false positives are accumulated at
``threshold_steps + 1`` evenly spaced thresholds, so a curve streams over
minibatches and merges across workers; the AUC is the trapezoid under
(fpr, tpr). Labels and predictions may be numpy arrays or tensors on any
device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def host_array(a) -> np.ndarray:
    """A numpy view of ``a``: a tensor comes to the host in its own dtype
    (bfloat16 and float16 as float32)."""
    if hasattr(a, "detach"):
        t = a.detach().cpu()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        return t.numpy()
    return np.asarray(a)


class ROC:
    """Binary ROC.

    labels: [b] / [b, 1] in {0, 1}, or one-hot [b, 2] (column 1 is the
    positive class). predictions: the matching probabilities."""

    def __init__(self, threshold_steps: int = 100):
        self.threshold_steps = int(threshold_steps)
        # thresholds 0, 1/steps, ..., 1.0 inclusive
        self.thresholds = np.linspace(0.0, 1.0, self.threshold_steps + 1)
        self._tp = np.zeros_like(self.thresholds, dtype=np.int64)
        self._fp = np.zeros_like(self.thresholds, dtype=np.int64)
        self._pos = 0
        self._neg = 0

    @staticmethod
    def _binary_views(labels, predictions) -> Tuple[np.ndarray, np.ndarray]:
        labels = host_array(labels)
        predictions = host_array(predictions)
        if labels.ndim == 2 and labels.shape[1] == 2:
            labels = labels[:, 1]
        if predictions.ndim == 2 and predictions.shape[1] == 2:
            # two-column probabilities with one-column labels: column 1 is
            # the positive class
            predictions = predictions[:, 1]
        y, p = labels.reshape(-1), predictions.reshape(-1)
        if y.shape[0] != p.shape[0]:
            raise ValueError(
                f"ROC.eval: {y.shape[0]} labels vs {p.shape[0]} predictions "
                "after flattening — shapes must describe the same examples "
                f"(labels {labels.shape}, predictions {predictions.shape})")
        return y, p

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = self._binary_views(labels, predictions)
        if mask is not None:
            keep = host_array(mask).reshape(-1) > 0
            y, p = y[keep], p[keep]
        pos = y > 0.5
        self._pos += int(pos.sum())
        self._neg += int((~pos).sum())
        # predicted positive at threshold t ⇔ p >= t
        pred_pos = p[None, :] >= self.thresholds[:, None]
        self._tp += (pred_pos & pos[None, :]).sum(axis=1)
        self._fp += (pred_pos & ~pos[None, :]).sum(axis=1)

    def merge(self, other: "ROC") -> None:
        if other.threshold_steps != self.threshold_steps:
            raise ValueError("cannot merge ROC with different threshold steps")
        self._tp += other._tp
        self._fp += other._fp
        self._pos += other._pos
        self._neg += other._neg

    def get_roc_curve(self) -> List[Tuple[float, float, float]]:
        """[(threshold, fpr, tpr)] from threshold 0 to 1."""
        out = []
        for i, t in enumerate(self.thresholds):
            tpr = self._tp[i] / self._pos if self._pos else 0.0
            fpr = self._fp[i] / self._neg if self._neg else 0.0
            out.append((float(t), float(fpr), float(tpr)))
        return out

    def get_precision_recall_curve(self) -> List[Tuple[float, float, float]]:
        """[(threshold, precision, recall)]."""
        out = []
        for i, t in enumerate(self.thresholds):
            denom = self._tp[i] + self._fp[i]
            prec = self._tp[i] / denom if denom else 1.0
            rec = self._tp[i] / self._pos if self._pos else 0.0
            out.append((float(t), float(prec), float(rec)))
        return out

    def calculate_auc(self) -> float:
        """Trapezoidal area under (fpr, tpr), sorted by fpr ascending and
        spanning fpr 0 to 1."""
        pts = sorted((fpr, tpr) for _, fpr, tpr in self.get_roc_curve())
        if pts[0][0] > 0.0:
            pts.insert(0, (0.0, 0.0))
        if pts[-1][0] < 1.0:
            pts.append((1.0, 1.0))
        xs = np.array([p[0] for p in pts])
        ys = np.array([p[1] for p in pts])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(ys, xs))


class ROCMultiClass:
    """One-vs-all ROC per class of one-hot labels [b, c]."""

    def __init__(self, threshold_steps: int = 100):
        self.threshold_steps = int(threshold_steps)
        self._per_class: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None) -> None:
        labels = host_array(labels)
        predictions = host_array(predictions)
        if labels.ndim != 2:
            raise ValueError("ROCMultiClass needs one-hot labels [b, c]")
        for c in range(labels.shape[1]):
            roc = self._per_class.setdefault(c, ROC(self.threshold_steps))
            roc.eval(labels[:, c], predictions[:, c], mask=mask)

    def calculate_auc(self, cls: int) -> float:
        return self._per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        if not self._per_class:
            return 0.0
        return float(np.mean([r.calculate_auc()
                              for r in self._per_class.values()]))

    def merge(self, other: "ROCMultiClass") -> None:
        for c, roc in other._per_class.items():
            if c in self._per_class:
                self._per_class[c].merge(roc)
            else:
                self._per_class[c] = roc
