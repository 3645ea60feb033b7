"""Regression evaluation (counterpart of the JAX package's
``eval/regression.py``; plain numpy on the host, the same numbers).

Per-column MSE, MAE, RMSE, RSE and R² (squared correlation), accumulated
in float64 as sums, sums of squares and cross moments, so evaluations
stream over minibatches and merge across workers exactly. Labels and
predictions may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .roc import host_array

_ACCUMULATORS = ("_count", "_sum_abs_err", "_sum_sq_err", "_sum_label",
                 "_sum_pred", "_sum_label_sq", "_sum_pred_sq",
                 "_sum_label_pred")


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None,
                 column_names: Optional[Sequence[str]] = None):
        self.n_columns = n_columns
        self.column_names = list(column_names) if column_names else None
        self._initialized = False

    def _init_accum(self, n: int) -> None:
        self.n_columns = n
        for attr in _ACCUMULATORS:
            setattr(self, attr, np.zeros(n, dtype=np.float64))
        self._initialized = True

    def eval(self, labels, predictions, mask=None) -> None:
        labels = host_array(labels).astype(np.float64)
        predictions = host_array(predictions).astype(np.float64)
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        if labels.ndim == 3:  # [b, t, c]: time flattened
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
        if mask is not None:
            keep = host_array(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        if not self._initialized:
            self._init_accum(labels.shape[1])
        err = predictions - labels
        self._count += labels.shape[0]
        self._sum_abs_err += np.abs(err).sum(axis=0)
        self._sum_sq_err += (err ** 2).sum(axis=0)
        self._sum_label += labels.sum(axis=0)
        self._sum_pred += predictions.sum(axis=0)
        self._sum_label_sq += (labels ** 2).sum(axis=0)
        self._sum_pred_sq += (predictions ** 2).sum(axis=0)
        self._sum_label_pred += (labels * predictions).sum(axis=0)

    def merge(self, other: "RegressionEvaluation") -> None:
        if not other._initialized:
            return
        if not self._initialized:
            self._init_accum(other.n_columns)
        for attr in _ACCUMULATORS:
            setattr(self, attr, getattr(self, attr) + getattr(other, attr))

    # -- per-column metrics --------------------------------------------

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_sq_err[col] / max(self._count[col], 1))

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs_err[col] / max(self._count[col], 1))

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def correlation_r2(self, col: int) -> float:
        """Squared Pearson correlation of labels and predictions."""
        n = self._count[col]
        if n == 0:
            return 0.0
        cov = (self._sum_label_pred[col]
               - self._sum_label[col] * self._sum_pred[col] / n)
        var_l = self._sum_label_sq[col] - self._sum_label[col] ** 2 / n
        var_p = self._sum_pred_sq[col] - self._sum_pred[col] ** 2 / n
        denom = var_l * var_p
        return float(cov * cov / denom) if denom > 0 else 0.0

    def relative_squared_error(self, col: int) -> float:
        n = self._count[col]
        if n == 0:
            return 0.0
        var_l = self._sum_label_sq[col] - self._sum_label[col] ** 2 / n
        return float(self._sum_sq_err[col] / var_l) if var_l > 0 else 0.0

    # -- averages over the columns ---------------------------------------

    def _average(self, metric) -> float:
        return float(np.mean([metric(i) for i in range(self.n_columns)]))

    def average_mean_squared_error(self) -> float:
        return self._average(self.mean_squared_error)

    def average_mean_absolute_error(self) -> float:
        return self._average(self.mean_absolute_error)

    def average_root_mean_squared_error(self) -> float:
        return self._average(self.root_mean_squared_error)

    def average_correlation_r2(self) -> float:
        return self._average(self.correlation_r2)

    def _name(self, i: int) -> str:
        if self.column_names and i < len(self.column_names):
            return self.column_names[i]
        return f"col_{i}"

    def stats(self) -> str:
        if not self._initialized:
            return "RegressionEvaluation: no data"
        lines = ["Column        MSE          MAE          RMSE         RSE"
                 "          R^2"]
        for i in range(self.n_columns):
            lines.append(
                f"{self._name(i):<12} {self.mean_squared_error(i):<12.6g} "
                f"{self.mean_absolute_error(i):<12.6g} "
                f"{self.root_mean_squared_error(i):<12.6g} "
                f"{self.relative_squared_error(i):<12.6g} "
                f"{self.correlation_r2(i):<12.6g}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.stats()
