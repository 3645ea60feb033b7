"""LeNet on MNIST — the minimum end-to-end slice (counterpart of the JAX
package's ``examples/mnist_lenet.py``).

DL4J analog: the classic `LenetMnistExample` (MultiLayerNetwork +
MnistDataSetIterator).

Run: python -m deeplearning4j_tpu_torch.examples.mnist_lenet [--smoke] [--device cpu]
"""
from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import ScoreIterationListener


def main(smoke: bool = False, device="cuda"):
    n_train, n_test, epochs = (512, 256, 1) if smoke else (60000, 10000, 2)
    net = MultiLayerNetwork(lenet(), device=device).init()
    net.add_listener(ScoreIterationListener(print_iterations=50,
                                            log_fn=print))

    train = MnistDataSetIterator(batch_size=64, num_examples=n_train)
    net.fit(train, epochs=epochs)

    test = MnistDataSetIterator(batch_size=256, num_examples=n_test,
                                train=False)
    ev = net.evaluate(test)
    print(ev.stats())
    print(f"accuracy: {ev.accuracy():.4f}")
    return ev.accuracy()


if __name__ == "__main__":
    run(main, __doc__)
