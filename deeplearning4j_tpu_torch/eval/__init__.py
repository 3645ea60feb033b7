"""Evaluation (counterpart of the JAX package's ``eval/``): the
classification :class:`Evaluation` and its :class:`ConfusionMatrix`. ROC
and regression evaluation are not yet ported."""

from .confusion import ConfusionMatrix
from .evaluation import Evaluation, Prediction

__all__ = ["ConfusionMatrix", "Evaluation", "Prediction"]
