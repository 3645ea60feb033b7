"""LeNet-5 (the reference's first bench config): the minimum end-to-end model."""

from __future__ import annotations

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)


def lenet(height: int = 28, width: int = 28, channels: int = 1,
          n_classes: int = 10, *, updater: str = "adam",
          learning_rate: float = 1e-3, seed: int = 42, dtype: str = "float32"):
    """LeNet-5-style convnet as a MultiLayerConfiguration."""
    return (NeuralNetConfiguration.builder()
            .seed(seed).updater(updater).learning_rate(learning_rate)
            .dtype(dtype)
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                    pooling_type="max"))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                    pooling_type="max"))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=n_classes, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(height, width, channels))
            .build())
