"""Greedy layerwise pretraining, then supervised fine-tuning (counterpart
of the JAX package's ``examples/pretrain_autoencoder.py``).

DL4J analog: the RBM/AutoEncoder deep-network examples — stack AutoEncoder
layers, `pretrain()` them greedily on unlabeled data, then `fit()` the
whole net on labels. Also shows the Hinton deep autoencoder on the Curves
dataset (reconstruction).

Run: python -m deeplearning4j_tpu_torch.examples.pretrain_autoencoder [--smoke] [--device cpu]
"""
import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.fetchers import (CurvesDataSetIterator,
                                                        MnistDataSetIterator)
from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.models import deep_autoencoder
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
from deeplearning4j_tpu_torch.nn.conf.pretrain import AutoEncoder
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def main(smoke: bool = False, device="cuda"):
    n, pre_epochs, tune_epochs = (512, 3, 6) if smoke else (10000, 15, 3)

    # 1) AE stack: pretrain greedily on UNLABELED data, fine-tune on labels
    conf = (NeuralNetConfiguration.builder().seed(7).updater("adam")
            .learning_rate(1e-3).list()
            .layer(AutoEncoder(n_out=64 if smoke else 256,
                               activation="sigmoid",
                               corruption_level=0.3, loss="mse"))
            .layer(AutoEncoder(n_out=32 if smoke else 64,
                               activation="sigmoid", loss="mse"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())
    net = MultiLayerNetwork(conf, device=device).init()
    train = MnistDataSetIterator(batch_size=64, num_examples=n)
    net.pretrain(train, epochs=pre_epochs, learning_rate=0.05)  # minibatch
    train.reset()
    probe = torch.as_tensor(next(iter(train)).features, device=net.device)
    train.reset()
    ae0 = net.layers[0]
    with torch.no_grad():
        err = float(ae0.reconstruction_error(net.params["layer_0"], probe))
    print(f"layer-0 reconstruction error after pretraining: {err:.4f}")
    net.fit(train, epochs=tune_epochs)
    test = MnistDataSetIterator(batch_size=256, num_examples=max(256, n // 5),
                                train=False)
    print(f"fine-tuned accuracy: {net.evaluate(test).accuracy():.4f}")

    # 2) the Hinton deep autoencoder on Curves (labels == inputs)
    ae = MultiLayerNetwork(deep_autoencoder(
        hidden=(64, 16) if smoke else (400, 200, 100, 30)),
        device=device).init()
    curves = CurvesDataSetIterator(batch_size=64,
                                   num_examples=256 if smoke else 5000)
    ae.fit(curves, epochs=1 if smoke else 10)
    ds = next(iter(CurvesDataSetIterator(batch_size=64,
                                         num_examples=64)))
    recon = ae.output(ds.features).float().cpu().numpy()
    mse = float(np.mean((recon - np.asarray(ds.features)) ** 2))
    print(f"curves reconstruction mse: {mse:.5f}")


if __name__ == "__main__":
    run(main, __doc__)
