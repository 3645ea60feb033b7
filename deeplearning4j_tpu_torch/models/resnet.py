"""ResNet (the reference's second bench config): the DAG/MFU benchmark model.

Standard bottleneck ResNet (He et al. 2015) expressed in the framework's own
GraphBuilder DSL — conv(+BN) vertices, ElementWiseVertex residual sums,
projection shortcuts on stride-2 stage boundaries, global average pool head.

Counterpart of the JAX package's ``models/resnet.py``: the same
configuration (``to_json`` matches the reference's), NHWC throughout. The
``space_to_depth`` stem and ``fold_stem_7x7_to_s2d`` (a numpy copy of the
reference's) lower the 7×7/2 stem to an equivalent 4×4/1 conv.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.graph import ElementWiseVertex, GraphBuilder
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
    OutputLayer, SpaceToDepthLayer, SubsamplingLayer)


def _conv_bn(gb: GraphBuilder, name: str, inp: str, n_out: int,
             kernel, stride=(1, 1), activation: str = "relu") -> str:
    gb.add_layer(f"{name}_conv", ConvolutionLayer(
        n_out=n_out, kernel_size=tuple(kernel), stride=tuple(stride),
        border_mode="same", activation="identity", has_bias=False), inp)
    gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
    if activation == "identity":
        return f"{name}_bn"
    gb.add_layer(f"{name}_act", ActivationLayer(activation=activation),
                 f"{name}_bn")
    return f"{name}_act"


def _bottleneck(gb: GraphBuilder, name: str, inp: str, planes: int,
                stride: int, project: bool) -> str:
    """1x1 reduce → 3x3 → 1x1 expand (4×), + shortcut, relu."""
    c1 = _conv_bn(gb, f"{name}_a", inp, planes, (1, 1), (1, 1), "relu")
    c2 = _conv_bn(gb, f"{name}_b", c1, planes, (3, 3), (stride, stride), "relu")
    c3 = _conv_bn(gb, f"{name}_c", c2, planes * 4, (1, 1), (1, 1), "identity")
    if project:
        sc = _conv_bn(gb, f"{name}_proj", inp, planes * 4, (1, 1),
                      (stride, stride), "identity")
    else:
        sc = inp
    gb.add_vertex(f"{name}_sum", ElementWiseVertex(op="add"), c3, sc)
    gb.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                 f"{name}_sum")
    return f"{name}_relu"


def resnet(blocks: Sequence[int] = (3, 4, 6, 3), *,
           height: int = 224, width: int = 224, channels: int = 3,
           n_classes: int = 1000, width_base: int = 64,
           updater: str = "sgd", learning_rate: float = 0.1,
           momentum: float = 0.9, seed: int = 42, dtype: str = "mixed_bf16",
           stem: str = "conv7"):
    """Bottleneck ResNet as a ComputationGraphConfiguration.

    ``blocks=(3,4,6,3)`` → ResNet-50. Smaller test nets: ``blocks=(1,1)``,
    reduced ``width_base``/image size.

    ``stem="space_to_depth"`` lowers the 7×7/2 stem to an equivalent 4×4/1
    conv on a 2×2 space-to-depth input (``fold_stem_7x7_to_s2d`` maps 7×7
    weights onto it exactly).
    """
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater("nesterovs" if updater == "sgd" else updater)
         .momentum(momentum).learning_rate(learning_rate).dtype(dtype)
         .weight_init("RELU"))
    gb = b.graph_builder().add_inputs("in")
    if stem == "space_to_depth":
        gb.add_layer("stem_s2d", SpaceToDepthLayer(block_size=2), "in")
        stem = _conv_bn(gb, "stem", "stem_s2d", width_base, (4, 4), (1, 1),
                        "relu")
    else:
        stem = _conv_bn(gb, "stem", "in", width_base, (7, 7), (2, 2), "relu")
    gb.add_layer("stem_pool", SubsamplingLayer(
        kernel_size=(3, 3), stride=(2, 2), border_mode="same",
        pooling_type="max"), stem)
    cur = "stem_pool"
    for stage, n_blocks in enumerate(blocks):
        planes = width_base * (2 ** stage)
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            project = (i == 0)  # channel change (and/or stride) at stage entry
            cur = _bottleneck(gb, f"s{stage}b{i}", cur, planes, stride, project)
    gb.add_layer("head_pool", GlobalPoolingLayer(pooling_type="avg"), cur)
    gb.add_layer("out", OutputLayer(n_out=n_classes, activation="softmax",
                                    loss="mcxent"), "head_pool")
    return (gb.set_outputs("out")
            .set_input_types(InputType.convolutional(height, width, channels))
            .build())


def resnet50(**kw):
    """ResNet-50 (ImageNet geometry by default)."""
    return resnet((3, 4, 6, 3), **kw)


def resnet_tiny(*, height: int = 32, width: int = 32, channels: int = 3,
                n_classes: int = 10, width_base: int = 16, **kw):
    """Two-block bottleneck ResNet at CIFAR geometry: the small stand-in
    for the ResNet-50 path (the same DAG shape — stem, stage boundaries,
    projection shortcuts — at ~1/400th the FLOPs)."""
    return resnet((1, 1), height=height, width=width, channels=channels,
                  n_classes=n_classes, width_base=width_base, **kw)


def fold_stem_7x7_to_s2d(w7: np.ndarray) -> np.ndarray:
    """Map 7×7/2 stem weights [7,7,C,O] (SAME pad → (2,3)) onto the exact
    equivalent 4×4/1 kernel [4,4,4C,O] over a 2×2 space-to-depth input
    (SAME pad → (1,2)); s2d channel order (di, dj, c).

    Derivation: output tap kh ∈ [0,7) reads x[2i + kh − 2]; writing
    kh − 2 = 2u + di (u ∈ [−1,2], di ∈ {0,1}) makes it a 4-tap conv over
    s2d rows with block-offset channel di — the (u=2, di=1) slot (kh=7)
    stays zero. Same for kw.
    """
    kh_, kw_, c, o = w7.shape
    if (kh_, kw_) != (7, 7):
        raise ValueError(f"expected a 7x7 kernel, got {w7.shape}")
    w4 = np.zeros((4, 4, 4 * c, o), dtype=w7.dtype)
    for kh in range(7):
        u, di = divmod(kh - 2, 2)
        for kw in range(7):
            v, dj = divmod(kw - 2, 2)
            ch = (di * 2 + dj) * c
            w4[u + 1, v + 1, ch:ch + c, :] = w7[kh, kw]
    return w4
