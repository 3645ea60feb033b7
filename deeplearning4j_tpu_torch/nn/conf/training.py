"""Training-level configuration (counterpart of the JAX package's
``nn/conf/training.py``; the same fields and JSON). The runtime reads
``seed`` and ``dtype`` now; the updater fields are used by the training
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class TrainingConfig:
    seed: int = 12345
    iterations: int = 1                     # numIterations per minibatch (ref default 1)
    optimization_algo: str = "stochastic_gradient_descent"
    updater: str = "sgd"                    # sgd|adam|nesterovs|adagrad|rmsprop|adadelta|adamax|nadam|none
    learning_rate: float = 1e-1             # ref NeuralNetConfiguration.java:484
    momentum: float = 0.9
    rms_decay: float = 0.95
    rho: float = 0.95                       # adadelta
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    epsilon: float = 1e-8
    regularization: bool = False
    minibatch: bool = True
    max_line_search_iterations: int = 5
    # LR schedule (parity: LayerUpdater.java:132-155 LearningRatePolicy)
    lr_policy: str = "none"                 # none|exponential|inverse|step|torch_step|poly|sigmoid|schedule
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 0.0
    lr_policy_power: float = 0.0
    lr_schedule: Optional[Dict[int, float]] = None
    # gradient normalization (parity: LayerUpdater.java:179-226)
    gradient_normalization: Optional[str] = None
    # renormalize_l2_per_layer | renormalize_l2_per_param_type |
    # clip_elementwise_absolute_value | clip_l2_per_layer | clip_l2_per_param_type
    gradient_normalization_threshold: float = 1.0
    dtype: str = "float32"                  # dtype policy name (dtypes.policy_from_name)
    # rematerialization: recompute layer activations in the backward pass
    gradient_checkpointing: bool = False

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("lr_schedule"):
            d["lr_schedule"] = {str(k): v for k, v in d["lr_schedule"].items()}
        return d

    @staticmethod
    def from_dict(d: dict) -> "TrainingConfig":
        d = dict(d)
        if d.get("lr_schedule"):
            d["lr_schedule"] = {int(k): float(v) for k, v in d["lr_schedule"].items()}
        known = {f.name for f in dataclasses.fields(TrainingConfig)}
        return TrainingConfig(**{k: v for k, v in d.items() if k in known})
