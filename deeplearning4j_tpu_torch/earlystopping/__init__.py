"""Early stopping: the epoch loop with score calculators, termination
conditions, and model savers (counterpart of the JAX package's
``earlystopping/``).

Parity: reference ``deeplearning4j-nn/.../earlystopping/`` —
``EarlyStoppingConfiguration``, ``trainer/BaseEarlyStoppingTrainer`` /
``EarlyStoppingTrainer`` / ``EarlyStoppingGraphTrainer``,
``scorecalc/DataSetLossCalculator``, ``termination/`` (MaxEpochs, MaxTime,
MaxScore, ScoreImprovement, BestScoreEpoch, InvalidScore), ``saver/``
(InMemory, LocalFile).
"""

from .config import EarlyStoppingConfiguration, EarlyStoppingResult
from .savers import InMemoryModelSaver, LocalFileModelSaver
from .scorecalc import DataSetLossCalculator, EvaluationScoreCalculator
from .termination import (
    BestScoreEpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from .trainer import EarlyStoppingGraphTrainer, EarlyStoppingTrainer

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult",
    "EarlyStoppingTrainer", "EarlyStoppingGraphTrainer",
    "DataSetLossCalculator", "EvaluationScoreCalculator",
    "MaxEpochsTerminationCondition", "MaxTimeTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "BestScoreEpochTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition",
    "InMemoryModelSaver", "LocalFileModelSaver",
]
