"""Score calculators (counterpart of the JAX package's
``earlystopping/scorecalc.py``; parity: reference
``scorecalc/DataSetLossCalculator``). ``mesh=`` shards the held-out
batches over a device mesh through ``parallel.evaluation.ShardedEvaluator``
(the analog of the reference's ``SparkDataSetLossCalculator``)."""

from __future__ import annotations


class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


def _is_graph(net) -> bool:
    return hasattr(net.conf, "vertices")


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a held-out iterator (parity:
    ``DataSetLossCalculator.java`` with ``average=true``). Pass ``mesh`` to
    shard the held-out batches over a device mesh."""

    def __init__(self, iterator, average: bool = True, mesh=None):
        self.iterator = iterator
        self.average = average
        self.mesh = mesh
        self._evaluator = None

    def _sharded(self, net):
        from ..parallel.evaluation import ShardedEvaluator
        if self._evaluator is None or self._evaluator.net is not net:
            self._evaluator = ShardedEvaluator(net, self.mesh)
        return self._evaluator

    def calculate_score(self, net) -> float:
        if self.mesh is not None:
            return self._sharded(net).score(
                self.iterator, average=self.average)
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

    def __init__(self, iterator, mesh=None):
        self.iterator = iterator
        self.mesh = mesh
        self._evaluator = None

    def _sharded(self, net):
        from ..parallel.evaluation import ShardedEvaluator
        if self._evaluator is None or self._evaluator.net is not net:
            self._evaluator = ShardedEvaluator(net, self.mesh)
        return self._evaluator

    def calculate_score(self, net) -> float:
        if self.mesh is not None:
            ev = self._sharded(net).evaluate(self.iterator)
        else:
            ev = net.evaluate(self.iterator)
        return 1.0 - ev.accuracy()
