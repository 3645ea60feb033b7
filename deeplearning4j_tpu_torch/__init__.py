"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

A second package beside the JAX one, with the same module paths, the same
configuration JSON and the same checkpoint format, so every part can be
checked against the JAX package (the reference). Plain tensor code is
PyTorch; each kernel the JAX package wrote in Pallas for the TPU is a
kernel written by hand for Hopper (``ops/csrc``), built with ``nvcc`` at
first use. The package never imports ``jax`` or ``deeplearning4j_tpu``.

Entry points (``ComputationGraph``, ``util.serialization.load_model``,
``serving.InferenceServer``) run on ``device="cuda"`` unless the caller
passes ``device="cpu"``; without a card they raise instead of falling back.

Ported: every module of the JAX package. The transformer-LM flagship
from configuration through training, decode and the serving tier (the
HTTP front, the fleet and the training-health telemetry); the list DSL and
``MultiLayerNetwork``, the convolutional, normalisation and recurrent
layers, the classic zoo (LeNet-5, ResNet, char-RNN, AlexNet, VGG-16),
classification evaluation and gradient checking; the training substrate:
the async fit loop with staging on a side CUDA stream, durable snapshots
with exact resume, checkpoint recovery, early stopping, the record
pipeline and datasets, and the full-batch solvers; distribution, DataVec
ETL and the dashboard; the embedding stack (``nlp``: Word2Vec,
ParagraphVectors, GloVe, the vectorizers) and graph embeddings (``graph``:
random walks, DeepWalk); clustering (k-means on the device, the KD-, VP-
and Barnes-Hut trees), t-SNE (``plot``), Keras import (``modelimport``),
named seeds (``rng``) and the examples (``examples``, run as
``python -m deeplearning4j_tpu_torch.examples.<name>``).
"""

__version__ = "0.1.0"

# Lazy module surface: keep `import deeplearning4j_tpu_torch` light.
# The JAX package's list (``serving`` and ``datavec`` are imported by name
# in both).
_SUBMODULES = {
    "nn", "optimize", "eval", "data", "datasets", "parallel", "models",
    "nlp", "graph", "modelimport", "ui", "util", "ops", "losses", "dtypes",
    "rng", "earlystopping", "clustering", "plot", "storage", "gradientcheck",
}


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        mod = importlib.import_module(f"{__name__}.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
