"""Score calculators (counterpart of the JAX package's
``earlystopping/scorecalc.py``; parity: reference
``scorecalc/DataSetLossCalculator``). The reference's ``mesh=`` option
(held-out batches sharded over a device mesh) waits for the port of the
distribution layer."""

from __future__ import annotations


class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


def _is_graph(net) -> bool:
    return hasattr(net.conf, "vertices")


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a held-out iterator (parity:
    ``DataSetLossCalculator.java`` with ``average=true``)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, n = 0.0, 0
        for ds in self.iterator:
            x, y = ds.features, ds.labels
            mask = getattr(ds, "features_mask", None)
            batch = x.shape[0]
            s = net.score_for(x, y, mask) if not _is_graph(net) else \
                net.score_for([x], [y], None if mask is None else [mask])
            total += s * batch
            n += batch
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        return total / max(n, 1) if self.average else total


class EvaluationScoreCalculator(ScoreCalculator):
    """1 - accuracy on a held-out iterator (lower is better, so early stopping
    maximizes accuracy)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, net) -> float:
        ev = net.evaluate(self.iterator)
        return 1.0 - ev.accuracy()
