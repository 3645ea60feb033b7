"""Data-parallel training over a mesh of processes (counterpart of the JAX
package's ``examples/data_parallel_training.py``).

DL4J analog: `ParallelWrapper` / Spark `ParameterAveragingTrainingMaster`.
One process per device: every rank builds the same net and mesh, and the
gradients (or, for local SGD, the parameters) are all-reduced over the
``data`` group.

Run on one process, or start one per rank with the ``torch.distributed``
environment, e.g. two CPU ranks on this host:

  MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 RANK=<r> \
  python -m deeplearning4j_tpu_torch.examples.data_parallel_training --smoke --device cpu
"""
from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.models import lenet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParameterAveragingTrainingMaster, SyncTrainingMaster, data_parallel_mesh,
    distributed)


def main(smoke: bool = False, device="cuda"):
    distributed.initialize(device=device)   # from the environment, if set
    print(f"processes: {distributed.process_count()}")
    n, epochs = (512, 1) if smoke else (60000, 2)
    device_type = MultiLayerNetwork(lenet(), device=device).device.type
    mesh = data_parallel_mesh(device_type=device_type)

    # per-step gradient sync (the ParallelWrapper analog)
    net = MultiLayerNetwork(lenet(), device=device).init()
    trainer = SyncTrainingMaster(collect_stats=True).build(net, mesh)
    trainer.fit(MnistDataSetIterator(batch_size=64, num_examples=n),
                epochs=epochs)
    print(trainer.stats())

    # local SGD: K local steps, then average (ParameterAveraging analog)
    net2 = MultiLayerNetwork(lenet(), device=device).init()
    trainer2 = ParameterAveragingTrainingMaster(
        averaging_frequency=4).build(net2, mesh)
    trainer2.fit(MnistDataSetIterator(batch_size=64, num_examples=n),
                 epochs=epochs)
    print("local-SGD score:", net2.score())


if __name__ == "__main__":
    run(main, __doc__)
