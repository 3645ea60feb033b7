"""Residual network on CIFAR-10 as a ComputationGraph (counterpart of the
JAX package's ``examples/resnet_cifar.py``).

DL4J analog: ComputationGraph examples with ElementWiseVertex residual
adds.

Run: python -m deeplearning4j_tpu_torch.examples.resnet_cifar [--smoke] [--device cpu]
"""
from deeplearning4j_tpu_torch.datasets.fetchers import CifarDataSetIterator
from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.models import resnet
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph


def main(smoke: bool = False, device="cuda"):
    blocks, n_ex, epochs = ((1, 1), 256, 1) if smoke else ((2, 2, 2), 50000, 5)
    conf = resnet(blocks=blocks, height=32, width=32, n_classes=10,
                  width_base=16 if smoke else 64, dtype="float32",
                  learning_rate=0.05)
    net = ComputationGraph(conf, device=device).init()

    train = CifarDataSetIterator(batch_size=64, num_examples=n_ex)
    net.fit(train, epochs=epochs)

    test = CifarDataSetIterator(batch_size=256,
                                num_examples=max(256, n_ex // 5), train=False)
    ev = net.evaluate(test)
    print(ev.stats())
    return ev.accuracy()


if __name__ == "__main__":
    run(main, __doc__)
