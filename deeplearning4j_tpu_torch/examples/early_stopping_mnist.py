"""Early stopping with score-improvement termination and a model saver
(counterpart of the JAX package's ``examples/early_stopping_mnist.py``).

DL4J analog: `EarlyStoppingMNIST`-style setup — EarlyStoppingConfiguration
with MaxEpochs + ScoreImprovementEpochs terminations, DataSetLossCalculator
on a held-out iterator, LocalFileModelSaver, then load the BEST model.

Run: python -m deeplearning4j_tpu_torch.examples.early_stopping_mnist [--smoke] [--device cpu]
"""
import tempfile

from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
from deeplearning4j_tpu_torch.earlystopping import (
    DataSetLossCalculator, EarlyStoppingConfiguration, EarlyStoppingTrainer,
    LocalFileModelSaver, MaxEpochsTerminationCondition,
    ScoreImprovementEpochTerminationCondition)
from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def main(smoke: bool = False, device="cuda"):
    n = 512 if smoke else 10000
    train = MnistDataSetIterator(batch_size=64, num_examples=n)
    val = MnistDataSetIterator(batch_size=256, num_examples=n // 4,
                               train=False)

    with tempfile.TemporaryDirectory() as directory:
        saver = LocalFileModelSaver(directory)
        es = EarlyStoppingConfiguration(
            score_calculator=DataSetLossCalculator(val),
            epoch_termination_conditions=[
                MaxEpochsTerminationCondition(2 if smoke else 20),
                ScoreImprovementEpochTerminationCondition(3)],
            model_saver=saver,
            evaluate_every_n_epochs=1)

        net = MultiLayerNetwork(lenet(), device=device).init()
        result = EarlyStoppingTrainer(es, net, train).fit()
        print(f"terminated: {result.termination_reason} "
              f"(epoch {result.best_model_epoch}, score "
              f"{result.best_model_score:.4f})")
        best = saver.get_best_model()
        print("best model restored:", best is not None)


if __name__ == "__main__":
    run(main, __doc__)
