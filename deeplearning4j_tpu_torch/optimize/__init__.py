"""Training rules (counterpart of the JAX package's ``optimize/``): the
updaters, LR schedules and gradient normalization. Listeners and solvers
are not ported yet."""

from .updaters import (Updater, all_finite, apply_updates, learning_rate_at,
                       make_updater, normalize_gradients, select_tree)

__all__ = ["Updater", "make_updater", "learning_rate_at",
           "normalize_gradients", "apply_updates", "all_finite",
           "select_tree"]
