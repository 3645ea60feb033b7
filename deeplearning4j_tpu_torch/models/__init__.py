"""Model zoo: canonical configurations (counterpart of the JAX package's
``models/``): LeNet-5, ResNet, the GravesLSTM char-RNN, AlexNet, VGG-16,
the deep autoencoder and the transformer LM; and the port's own hybrid
conv/attention LM with sparse experts (``lfm2_moe_lm``)."""

from .char_rnn import char_rnn_lstm
from .classic import alexnet, deep_autoencoder, vgg16
from .lenet import lenet
from .lfm2 import lfm2_moe_lm
from .resnet import fold_stem_7x7_to_s2d, resnet, resnet50, resnet_tiny
from .transformer import transformer_lm

__all__ = ["lenet", "resnet", "resnet50", "resnet_tiny",
           "fold_stem_7x7_to_s2d", "char_rnn_lstm", "alexnet", "vgg16",
           "deep_autoencoder", "transformer_lm", "lfm2_moe_lm"]
