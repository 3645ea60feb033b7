"""Configuration DSL: serializable layer/graph configs with shape inference
(counterpart of the JAX package's ``nn/conf``; the same JSON)."""

from .inputs import InputType
from .builders import NeuralNetConfiguration
from .graph import ComputationGraphConfiguration
from .layers import NotYetPorted
from .multi_layer import MultiLayerConfiguration

__all__ = ["InputType", "NeuralNetConfiguration",
           "ComputationGraphConfiguration", "MultiLayerConfiguration",
           "NotYetPorted"]
