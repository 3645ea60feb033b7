"""Distribution (counterpart of the JAX package's ``parallel/``).

Parity: reference single-node multi-device ``ParallelWrapper``
(``deeplearning4j-core/.../parallelism/ParallelWrapper.java:37-204``) and
the Spark ``ParameterAveragingTrainingMaster``
(``dl4j-spark/.../impl/paramavg/ParameterAveragingTrainingMaster.java:340``).

One process per device over ``torch.distributed`` process groups (NCCL
between cards, gloo between CPU processes); a ``DeviceMesh`` with named
dims takes the place of the JAX package's ``Mesh``:

- data parallelism, sync (per-step gradient all-reduce) or local SGD
  (parameters and updater state averaged every k steps)
  (``ParallelWrapper``, the training masters);
- sequence parallelism through ring attention over the hand-written
  flash kernels (``SequenceParallelGraphTrainer``), tensor, pipeline and
  expert parallelism (``TensorParallel*``, ``*PipelineTrainer``,
  ``ExpertParallel*``);
- elastic bounded-staleness local SGD across processes over a
  coordination store, with no collective (``ElasticTrainer``).
"""

from .distributed import (global_mesh, host_local_batch,
                          host_replicated_batch, initialize,
                          is_initialized, process_count, process_index)
from .elastic import (CoordinationStore, ElasticConfig,
                      ElasticProtocolError, ElasticTrainer,
                      FileCoordinationStore, InMemoryCoordinationStore,
                      LeaseMembership)
from .expert import ExpertParallelGraphTrainer, ExpertParallelTrainer
from .mesh import create_mesh, data_parallel_mesh, mesh_devices
from .pipeline import GraphPipelineTrainer, PipelineParallelTrainer
from .sequence import SequenceParallelGraphTrainer
from .tensor import TensorParallelGraphTrainer, TensorParallelTrainer
from .training_master import (ElasticTrainingMaster,
                              ParameterAveragingTrainingMaster,
                              SyncTrainingMaster, Trainer, TrainingMaster)
from .wrapper import ParallelWrapper

__all__ = ["ParallelWrapper", "create_mesh", "data_parallel_mesh",
           "mesh_devices", "initialize", "is_initialized", "global_mesh",
           "host_local_batch", "host_replicated_batch", "process_count",
           "process_index", "TrainingMaster", "Trainer",
           "SyncTrainingMaster", "ParameterAveragingTrainingMaster",
           "ElasticTrainingMaster", "ElasticTrainer", "ElasticConfig",
           "CoordinationStore", "FileCoordinationStore",
           "InMemoryCoordinationStore", "TensorParallelTrainer",
           "PipelineParallelTrainer", "GraphPipelineTrainer",
           "SequenceParallelGraphTrainer", "ExpertParallelTrainer",
           "ExpertParallelGraphTrainer", "TensorParallelGraphTrainer"]
