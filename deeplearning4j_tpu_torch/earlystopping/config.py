"""EarlyStoppingConfiguration + result (a copy of the JAX package's
``earlystopping/config.py``; parity: reference
``earlystopping/EarlyStoppingConfiguration.java``, ``EarlyStoppingResult.java``)."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from .savers import InMemoryModelSaver, ModelSaver
from .scorecalc import ScoreCalculator
from .termination import (EpochTerminationCondition,
                          IterationTerminationCondition)


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: ScoreCalculator
    epoch_termination_conditions: List[EpochTerminationCondition] = \
        dataclasses.field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = \
        dataclasses.field(default_factory=list)
    model_saver: ModelSaver = dataclasses.field(default_factory=InMemoryModelSaver)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1

    class Builder:
        def __init__(self):
            self._kw = dict(score_calculator=None,
                            epoch_termination_conditions=[],
                            iteration_termination_conditions=[],
                            model_saver=InMemoryModelSaver(),
                            save_last_model=False,
                            evaluate_every_n_epochs=1)

        def score_calculator(self, sc):
            self._kw["score_calculator"] = sc; return self

        def epoch_termination_conditions(self, *conds):
            self._kw["epoch_termination_conditions"] = list(conds); return self

        def iteration_termination_conditions(self, *conds):
            self._kw["iteration_termination_conditions"] = list(conds); return self

        def model_saver(self, saver):
            self._kw["model_saver"] = saver; return self

        def save_last_model(self, flag: bool = True):
            self._kw["save_last_model"] = bool(flag); return self

        def evaluate_every_n_epochs(self, n: int):
            self._kw["evaluate_every_n_epochs"] = int(n); return self

        def build(self) -> "EarlyStoppingConfiguration":
            if self._kw["score_calculator"] is None:
                raise ValueError("score_calculator is required")
            return EarlyStoppingConfiguration(**self._kw)

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str           # "epoch_condition" | "iteration_condition" | "error"
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: Any = None
