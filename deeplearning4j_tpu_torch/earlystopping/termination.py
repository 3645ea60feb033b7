"""Termination conditions (a copy of the JAX package's
``earlystopping/termination.py``; parity: reference
``earlystopping/termination/``).

Epoch conditions are polled after each epoch's score calculation; iteration
conditions after every minibatch.
"""

from __future__ import annotations

import math
import time
from typing import Optional


class EpochTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs

    def __repr__(self):
        return f"MaxEpochs({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) improvement."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self._best: Optional[float] = None
        self._stale = 0

    def initialize(self) -> None:
        self._best, self._stale = None, 0

    def terminate(self, epoch: int, score: float) -> bool:
        if self._best is None or self._best - score > self.min_improvement:
            self._best = min(score, self._best) if self._best is not None else score
            self._stale = 0
            return False
        self._stale += 1
        return self._stale >= self.patience

    def __repr__(self):
        return f"ScoreImprovement(patience={self.patience})"


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at/below a target value."""

    def __init__(self, best_expected_score: float):
        self.target = float(best_expected_score)

    def terminate(self, epoch: int, score: float) -> bool:
        return score <= self.target

    def __repr__(self):
        return f"BestScore(target={self.target})"


class MaxTimeTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self) -> None:
        self._start = time.monotonic()

    def terminate(self, last_score: float) -> bool:
        if self._start is None:
            self.initialize()
        return time.monotonic() - self._start >= self.max_seconds

    def __repr__(self):
        return f"MaxTime({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if the score explodes past a ceiling."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, last_score: float) -> bool:
        return last_score > self.max_score

    def __repr__(self):
        return f"MaxScore({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score: float) -> bool:
        return math.isnan(last_score) or math.isinf(last_score)

    def __repr__(self):
        return "InvalidScore()"
