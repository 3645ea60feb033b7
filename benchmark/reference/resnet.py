"""Plain PyTorch reference of the bottleneck ResNet the benchmark runs (He
et al. 2015, the 50-layer column of Table 1, with the stride on the 3×3 as
torchvision's v1.5), written out again from the equations, in float32 (or
the control's arithmetic).

Images are NHWC as the program takes them; convolutions pad as "SAME"
does (the extra row and column at the end), without bias, each followed by
training-mode BatchNorm (batch mean, biased variance, ε 1e-5) and, except
before a residual sum, relu. The stem is a 7×7/2 conv and a 3×3/2 max
pool; the head a global average pool, a dense layer with bias and softmax.
The loss is the cross-entropy against one-hot labels, summed over classes
and averaged over the batch. Parameters come as the program's tree
(``stem_conv``/``stem_bn``, ``s{stage}b{block}_{a,b,c,proj}_{conv,bn}``,
``out``; conv weights HWIO)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import Arithmetic

BN_EPS = 1e-5


def _same_pads(n, k, s):
    out = -(-n // s)
    total = max(0, (out - 1) * s + k - n)
    return total // 2, total - total // 2


def conv(x, w_hwio, stride, ar: Arithmetic):
    """NCHW ``x`` through an HWIO weight with SAME padding."""
    k = w_hwio.shape[0]
    top, bottom = _same_pads(x.shape[2], k, stride)
    left, right = _same_pads(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return ar.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride)


def batch_norm(x, p):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    g = p["gamma"].view(1, -1, 1, 1)
    b = p["beta"].view(1, -1, 1, 1)
    return (x - mean) / torch.sqrt(var + BN_EPS) * g + b


def conv_bn(params, name, x, stride, ar, relu=True):
    y = batch_norm(conv(x, params[f"{name}_conv"]["W"], stride, ar),
                   params[f"{name}_bn"])
    return torch.relu(y) if relu else y


def max_pool_same(x, k=3, s=2):
    top, bottom = _same_pads(x.shape[2], k, s)
    left, right = _same_pads(x.shape[3], k, s)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def logits(params, images, cfg, ar: Arithmetic):
    """Logits ``[b, classes]`` for NHWC images."""
    x = images.permute(0, 3, 1, 2)
    x = conv_bn(params, "stem", x, cfg["stem_stride"], ar)
    x = max_pool_same(x)
    for stage, blocks in enumerate(cfg["depths"]):
        for i in range(blocks):
            name = f"s{stage}b{i}"
            stride = 2 if (stage > 0 and i == 0) else 1
            y = conv_bn(params, f"{name}_a", x, 1, ar)
            y = conv_bn(params, f"{name}_b", y, stride, ar)
            y = conv_bn(params, f"{name}_c", y, 1, ar, relu=False)
            sc = (conv_bn(params, f"{name}_proj", x, stride, ar, relu=False)
                  if i == 0 else x)
            x = torch.relu(y + sc)
    pooled = x.mean(dim=(2, 3))
    out = params["out"]
    return ar.matmul(pooled, out["W"]) + out["b"]


def summed_loss(logits, labels):
    """Σ over the rows of −Σ_c y_c·log softmax(logits)_c."""
    return -(labels * torch.log_softmax(logits, dim=-1)).sum()
