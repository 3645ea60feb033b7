"""Classification evaluation (counterpart of the JAX package's
``eval/evaluation.py``; plain numpy on the host).

Accumulates a confusion matrix from streamed minibatches and derives
accuracy, per-class precision, recall and F1 and their macro averages, and
the ``stats()`` report — the reference's numbers and text.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .confusion import ConfusionMatrix


@dataclasses.dataclass(frozen=True)
class Prediction:
    """One example's (actual, predicted, provenance) triple (parity:
    reference ``eval/meta/Prediction.java``). ``record_metadata`` is
    whatever the iterator collected — normally a
    ``datavec.readers.RecordMetaData`` — so a misclassified example can be
    traced back to its source record and reloaded via
    ``RecordReaderDataSetIterator.load_from_metadata``."""

    actual_class: int
    predicted_class: int
    record_metadata: Any

    def location(self) -> str:
        meta = self.record_metadata
        return meta.location() if hasattr(meta, "location") else str(meta)


def _to_class_indices(arr: np.ndarray) -> np.ndarray:
    """Labels/predictions may be one-hot/probabilities [b, c] (or [b, c, t]
    time series) or already class indices [b]."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        return arr.astype(np.int64)
    return np.argmax(arr, axis=-1).reshape(-1)


class Evaluation:
    """Streaming classification metrics.

    Usage::

        ev = Evaluation()
        for x, y in batches:
            ev.eval(y, net.output(x))
        print(ev.stats())
    """

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[Sequence[str]] = None):
        self.num_classes = num_classes
        self.label_names = list(labels) if labels is not None else None
        self.confusion: Optional[ConfusionMatrix] = None
        self._examples = 0
        self._predictions: List[Prediction] = []

    # -- accumulation ---------------------------------------------------

    def _ensure_confusion(self, n: int) -> None:
        if self.confusion is None:
            size = self.num_classes or n
            self.confusion = ConfusionMatrix(range(size))
            self.num_classes = size

    def eval(self, labels, predictions, mask=None, metadata=None) -> None:
        """Accumulate one minibatch.

        labels: one-hot [b, c] (or [b, t, c] time series) or ints [b];
        predictions: probabilities, same leading shape; mask: optional
        per-row [b] / per-timestep [b, t] 0/1 array — masked rows are
        excluded (parity: ``Evaluation.evalTimeSeries`` masking).

        metadata: optional per-example provenance, one entry per row
        (parity: ``Evaluation.java:195`` ``eval(labels, out, metadata)``).
        When given, every example's (actual, predicted, metadata) triple is
        retained so ``get_prediction_errors()`` can answer *which source
        records* were misclassified. Per-example metadata attribution is a
        row-wise concept, so it requires per-example labels ([b, c] or
        [b]), not flattened time series.
        """
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim > 1:
            n_out = labels.shape[-1]
        else:
            # integer class indices: size from labels, plus predictions only
            # when those are indices too (not a probability matrix)
            n_out = int(labels.max(initial=0)) + 1
            if predictions.ndim == 1:
                n_out = max(n_out, int(predictions.max(initial=0)) + 1)
            else:
                n_out = max(n_out, predictions.shape[-1])
        self._ensure_confusion(n_out)
        if n_out > len(self.confusion.classes):
            # a later batch revealed new classes (int-label streams)
            self.confusion.grow_to(n_out)
            self.num_classes = n_out

        if labels.ndim == 3:  # [b, t, c] time series → flatten active steps
            if metadata is not None:
                raise ValueError(
                    "metadata attribution needs per-example labels "
                    "([b, c] or [b]); flatten time series yourself or "
                    "evaluate without metadata")
            b, t, c = labels.shape
            labels2 = labels.reshape(b * t, c)
            preds2 = predictions.reshape(b * t, c)
            if mask is not None:
                keep = np.asarray(mask).reshape(b * t) > 0
                labels2, preds2 = labels2[keep], preds2[keep]
            y_true = _to_class_indices(labels2)
            y_pred = _to_class_indices(preds2)
        else:
            y_true = _to_class_indices(labels)
            y_pred = _to_class_indices(predictions)
            metas = list(metadata) if metadata is not None else None
            if metas is not None and len(metas) != len(y_true):
                raise ValueError(
                    f"metadata has {len(metas)} entries for "
                    f"{len(y_true)} examples")
            if mask is not None:
                keep = np.asarray(mask).reshape(-1) > 0
                y_true, y_pred = y_true[keep], y_pred[keep]
                if metas is not None:
                    metas = [m for m, k in zip(metas, keep) if k]
            if metas is not None:
                self._predictions.extend(
                    Prediction(int(a), int(p), m)
                    for a, p, m in zip(y_true, y_pred, metas))

        self.confusion.add_batch(y_true, y_pred)
        self._examples += len(y_true)

    def merge(self, other: "Evaluation") -> None:
        """Combine evaluations from parallel workers (parity: the Spark
        ``EvaluationReduceFunction``)."""
        if other.confusion is None:
            return
        if self.confusion is None:
            self.confusion = ConfusionMatrix(other.confusion.classes)
            self.num_classes = other.num_classes
        self.confusion.merge(other.confusion)
        self._examples += other._examples
        self._predictions.extend(other._predictions)

    # -- per-example metadata attribution -------------------------------
    # parity: reference eval/meta/Prediction.java + Evaluation.java:1013
    # (getPredictionErrors) / :1044 (getPredictionsByActualClass) /
    # :1075 (getPredictionByPredictedClass)

    def get_prediction_errors(self) -> List[Prediction]:
        """All misclassified examples seen with metadata, in eval order —
        answers "WHICH source records did the model get wrong"."""
        return [p for p in self._predictions
                if p.actual_class != p.predicted_class]

    def get_predictions_by_actual_class(self, cls: int) -> List[Prediction]:
        return [p for p in self._predictions if p.actual_class == cls]

    def get_predictions_by_predicted_class(self, cls: int) -> List[Prediction]:
        return [p for p in self._predictions if p.predicted_class == cls]

    # -- per-class counts ----------------------------------------------

    def true_positives(self, cls: int) -> int:
        return self.confusion.count(cls, cls)

    def false_positives(self, cls: int) -> int:
        return self.confusion.predicted_total(cls) - self.true_positives(cls)

    def false_negatives(self, cls: int) -> int:
        return self.confusion.actual_total(cls) - self.true_positives(cls)

    def true_negatives(self, cls: int) -> int:
        return (self.confusion.total() - self.true_positives(cls)
                - self.false_positives(cls) - self.false_negatives(cls))

    # -- metrics --------------------------------------------------------

    def accuracy(self) -> float:
        total = self.confusion.total()
        if total == 0:
            return 0.0
        return float(np.trace(self.confusion.matrix)) / total

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.confusion.predicted_total(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.precision(c) for c in self._seen_classes()]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.confusion.actual_total(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.recall(c) for c in self._seen_classes()]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        vals = [self.f1(c) for c in self._seen_classes()]
        return float(np.mean(vals)) if vals else 0.0

    def _seen_classes(self) -> List[int]:
        """Classes that actually appear (as truth or prediction) — macro
        averages over absent classes would deflate scores, matching the
        reference's treatment of classes with no examples."""
        if self.confusion is None:
            return []
        seen = (self.confusion.matrix.sum(axis=0)
                + self.confusion.matrix.sum(axis=1)) > 0
        return [c for c, s in zip(self.confusion.classes, seen) if s]

    def num_examples(self) -> int:
        return self._examples

    def _label(self, c: int) -> str:
        if self.label_names and c < len(self.label_names):
            return self.label_names[c]
        return str(c)

    def stats(self) -> str:
        """Human-readable report (parity: ``Evaluation.stats()`` :410)."""
        if self.confusion is None:
            return "Evaluation: no data"
        lines = ["========================Evaluation========================="]
        lines.append(f" Examples:  {self._examples}")
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        lines.append("-----------------------------------------------------------")
        lines.append(" Per class:  class  precision  recall  f1  support")
        for c in self._seen_classes():
            lines.append(
                f"   {self._label(c):>8}  {self.precision(c):.4f}  "
                f"{self.recall(c):.4f}  {self.f1(c):.4f}  "
                f"{self.confusion.actual_total(c)}")
        lines.append("-----------------------------------------------------------")
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        lines.append(str(self.confusion))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.stats()


def evaluate_network(net, data, labels=None) -> Evaluation:
    """Classification evaluation of a network runtime's ``output`` over
    an iterable of batches (or (x, y) arrays, or a DataSet-like object);
    DataSets carrying ``example_metadata`` flow it into the result. An
    exhausted resettable iterator is reset first, and any resettable one
    after."""
    from ..util.batching import iter_batches
    ev = Evaluation()
    if (hasattr(data, "has_next") and not data.has_next()
            and hasattr(data, "reset")):
        data.reset()
    for x, y, m, meta in iter_batches(data, labels, with_meta=True):
        ev.eval(_host(y), _host(net.output(x)),
                mask=None if m is None else _host(m), metadata=meta)
    if hasattr(data, "reset"):
        data.reset()
    return ev


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):              # a torch tensor, on any device
        return a.detach().float().cpu().numpy()
    return np.asarray(a)
