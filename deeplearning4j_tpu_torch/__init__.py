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

Ported so far: the transformer-LM inference path, from configuration to
``POST /predict``.
"""

__version__ = "0.1.0"

# Lazy module surface: keep `import deeplearning4j_tpu_torch` light.
_SUBMODULES = {"nn", "models", "ops", "serving", "util", "dtypes"}


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        mod = importlib.import_module(f"{__name__}.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
