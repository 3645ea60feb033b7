"""Keras model import (counterpart of the JAX package's ``modelimport/``).

Parity: reference ``deeplearning4j-modelimport`` —
``keras/Model.java:58`` (``importSequentialModel``), ``:78``
(``importFunctionalApiModel``), ``ModelConfiguration.java`` (config JSON →
network configuration), ``LayerConfiguration.java:42-47`` (supported layers:
Dense, TimeDistributedDense, LSTM, Convolution2D, MaxPooling2D, Flatten,
Dropout, Activation + the activation-name mapping).

HDF5 is read with h5py, imported only when a file is read. Weights keep
the JAX package's conventions (NHWC/HWIO convs; [in, out] dense kernels,
as Keras stores them), and are written into the initialised network's
parameters in place.
"""

from .keras import KerasModelImport

__all__ = ["KerasModelImport"]
