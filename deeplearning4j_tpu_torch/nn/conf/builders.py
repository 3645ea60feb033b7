"""NeuralNetConfiguration builder — the user-facing config DSL
(counterpart of the JAX package's ``nn/conf/builders.py``).

This slice ports the graph builder the transformer uses::

    conf = (NeuralNetConfiguration.builder()
            .seed(42).updater("adam").learning_rate(3e-4).dtype("mixed_bf16")
            .graph_builder()
            .add_inputs("in")
            .add_layer("embed", EmbeddingSequenceLayer(n_in=V, n_out=d), "in")
            ...
            .build())

Global defaults fill any per-layer field left as None, exactly as in the
reference (activation "sigmoid", weight_init "XAVIER", ...).
"""

from __future__ import annotations

import copy

from ..weights import Distribution
from .layers import Layer
from .training import TrainingConfig


class NeuralNetConfiguration:
    """Namespace for the builder entrypoint."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._t = TrainingConfig()
        # global layer defaults (applied to layers leaving fields None)
        self._defaults = dict(
            activation="sigmoid", weight_init="XAVIER", bias_init=0.0,
            dropout=0.0, l1=0.0, l2=0.0, dist=None,
            learning_rate=None, bias_learning_rate=None,
        )

    # ---- training-level settings ----
    def seed(self, s: int) -> "Builder":
        self._t.seed = int(s)
        return self

    def updater(self, name: str, **hyper) -> "Builder":
        self._t.updater = name.lower()
        for k, v in hyper.items():
            setattr(self._t, k, v)
        return self

    def learning_rate(self, lr: float) -> "Builder":
        self._t.learning_rate = float(lr)
        return self

    def dtype(self, policy_name: str) -> "Builder":
        self._t.dtype = policy_name
        return self

    # ---- per-layer global defaults ----
    def activation(self, a: str) -> "Builder":
        self._defaults["activation"] = a
        return self

    def weight_init(self, w: str) -> "Builder":
        self._defaults["weight_init"] = w.upper()
        return self

    def bias_init(self, b: float) -> "Builder":
        self._defaults["bias_init"] = float(b)
        return self

    def dist(self, d: Distribution) -> "Builder":
        self._defaults["dist"] = d
        return self

    # ---- transitions ----
    def graph_builder(self):
        from .graph import GraphBuilder
        return GraphBuilder(self)

    def _apply_defaults(self, layer: Layer) -> Layer:
        layer = copy.deepcopy(layer)
        for field, val in self._defaults.items():
            if getattr(layer, field, "missing") is None and val is not None:
                setattr(layer, field, val)
        return layer
