"""Evaluation (counterpart of the JAX package's ``eval/``): the
classification :class:`Evaluation` and its :class:`ConfusionMatrix`,
:class:`RegressionEvaluation`, and :class:`ROC` / :class:`ROCMultiClass`
— host numpy accumulation of the network's outputs."""

from .confusion import ConfusionMatrix
from .evaluation import Evaluation, Prediction
from .regression import RegressionEvaluation
from .roc import ROC, ROCMultiClass

__all__ = ["ConfusionMatrix", "Evaluation", "Prediction",
           "RegressionEvaluation", "ROC", "ROCMultiClass"]
