"""Import a Keras model (counterpart of the JAX package's
``examples/keras_import.py``).

DL4J analog: `Model.importSequentialModel` / `importFunctionalApiModel`
(deeplearning4j-modelimport). This example builds a tiny Keras Sequential
model (Dense(4, relu) -> Dense(3, softmax)), imports it as a
MultiLayerNetwork and runs a forward pass. With h5py installed it writes
and reads a Keras-format HDF5 file (no TensorFlow needed); without it, it
imports the same config JSON and arrays that the file would hold.

Run: python -m deeplearning4j_tpu_torch.examples.keras_import [--smoke] [--device cpu]
"""
import json
import os
import tempfile

import numpy as np

from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.modelimport.keras import (KerasModelImport,
                                                        _import_arrays)

CONFIG = {
    "class_name": "Sequential",
    "config": {"name": "seq", "layers": [
        {"class_name": "Dense", "config": {
            "name": "dense_1", "units": 4, "activation": "relu",
            "batch_input_shape": [None, 5]}},
        {"class_name": "Dense", "config": {
            "name": "dense_2", "units": 3, "activation": "softmax"}},
    ]},
}


def fixture_weights():
    """{layer: {array: value}} of the Dense(4) -> Dense(3) model."""
    rng = np.random.RandomState(0)
    return {name: {"kernel": rng.randn(nin, nout).astype(np.float32),
                   "bias": np.zeros(nout, dtype=np.float32)}
            for name, (nin, nout) in [("dense_1", (5, 4)),
                                      ("dense_2", (4, 3))]}


def write_sequential_fixture(path, weights):
    """The model as a Keras Sequential HDF5 archive."""
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(CONFIG).encode()
        mw = f.create_group("model_weights")
        for name, arrays in weights.items():
            g = mw.create_group(name)
            for key, a in arrays.items():
                g.create_dataset(f"{name}/{key}:0", data=a)


def main(smoke: bool = False, device="cuda"):
    weights = fixture_weights()
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("h5py is not installed: importing the config JSON and arrays")
        net = _import_arrays(CONFIG, weights, device=device)
    else:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "model.h5")
            write_sequential_fixture(path, weights)
            net = KerasModelImport.import_sequential_model(path,
                                                           device=device)
    x = np.random.RandomState(1).randn(2, 5).astype(np.float32)
    out = net.output(x).cpu().numpy()
    print("output shape:", out.shape, "rows sum to 1:",
          bool(np.allclose(out.sum(axis=1), 1.0, atol=1e-5)))


if __name__ == "__main__":
    run(main, __doc__)
