"""Training rules (counterpart of the JAX package's ``optimize/``): the
updaters, LR schedules, gradient normalization, the training listeners
and the full-batch solvers."""

from .listeners import (CollectScoresIterationListener,
                        ComposableIterationListener, LazyScore,
                        MetricsListener, ParamAndGradientIterationListener,
                        PerformanceListener, ScoreIterationListener,
                        TrainingListener, fire_step_skipped)
from .solvers import BackTrackLineSearch, Solver
from .updaters import (Updater, all_finite, apply_updates, learning_rate_at,
                       make_updater, normalize_gradients, select_tree)

__all__ = ["Updater", "make_updater", "learning_rate_at",
           "normalize_gradients", "apply_updates", "all_finite",
           "select_tree", "TrainingListener", "ScoreIterationListener",
           "PerformanceListener", "CollectScoresIterationListener",
           "ComposableIterationListener", "MetricsListener",
           "ParamAndGradientIterationListener", "LazyScore",
           "fire_step_skipped", "BackTrackLineSearch", "Solver"]
