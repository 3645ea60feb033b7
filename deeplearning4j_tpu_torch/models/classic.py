"""Classic convnet and autoencoder families (counterpart of the JAX
package's ``models/classic.py``; the same configurations). All NHWC, the
dtype policy via ``dtype=``.
"""

from __future__ import annotations

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    ConvolutionLayer, DenseLayer, LocalResponseNormalization,
    OutputLayer, SubsamplingLayer)


def alexnet(height: int = 224, width: int = 224, channels: int = 3,
            n_classes: int = 1000, *, updater: str = "sgd",
            learning_rate: float = 1e-2, seed: int = 42,
            dtype: str = "mixed_bf16"):
    """AlexNet (Krizhevsky 2012): 5 conv + LRN + 3 dense, single-tower."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(updater).learning_rate(learning_rate)
         .weight_init("relu")
         .dtype(dtype)
         .list()
         .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                 stride=(4, 4), padding=(2, 2),
                                 activation="relu"))
         .layer(LocalResponseNormalization())
         .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
         .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                 padding=(2, 2), activation="relu"))
         .layer(LocalResponseNormalization())
         .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
         .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                 padding=(1, 1), activation="relu"))
         .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                 padding=(1, 1), activation="relu"))
         .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                 padding=(1, 1), activation="relu"))
         .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
         .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
         .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
         .layer(OutputLayer(n_out=n_classes, activation="softmax",
                            loss="mcxent")))
    return b.set_input_type(
        InputType.convolutional(height, width, channels)).build()


_VGG16_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def vgg16(height: int = 224, width: int = 224, channels: int = 3,
          n_classes: int = 1000, *, updater: str = "sgd",
          learning_rate: float = 1e-2, seed: int = 42,
          dtype: str = "mixed_bf16"):
    """VGG-16 (Simonyan & Zisserman 2014): 13 3×3 convs + 3 dense."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(updater).learning_rate(learning_rate)
         .weight_init("relu")
         .dtype(dtype)
         .list())
    for n_out, reps in _VGG16_PLAN:
        for _ in range(reps):
            b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                         padding=(1, 1), activation="relu"))
        b = b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
    b = (b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
         .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
         .layer(OutputLayer(n_out=n_classes, activation="softmax",
                            loss="mcxent")))
    return b.set_input_type(
        InputType.convolutional(height, width, channels)).build()


def deep_autoencoder(n_in: int = 784,
                     hidden=(1000, 500, 250, 30), *,
                     updater: str = "adam", learning_rate: float = 1e-3,
                     seed: int = 42, dtype: str = "float32"):
    """Hinton & Salakhutdinov (2006) deep autoencoder — the architecture the
    reference trains on the curves dataset (use with
    ``CurvesDataSetIterator``, whose labels are the inputs)."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(updater).learning_rate(learning_rate)
         .dtype(dtype)
         .list())
    for n in hidden:                     # encoder
        b = b.layer(DenseLayer(n_out=n, activation="relu"))
    for n in reversed(hidden[:-1]):      # decoder
        b = b.layer(DenseLayer(n_out=n, activation="relu"))
    b = b.layer(OutputLayer(n_out=n_in, activation="sigmoid", loss="mse"))
    return b.set_input_type(InputType.feed_forward(n_in)).build()
