"""Distribution (counterpart of the JAX package's ``parallel/``). Ported so
far: the elastic coordination substrate — the coordination stores and the
heartbeat-lease membership the serving fleet runs on. The trainers
(data, tensor, sequence, pipeline, expert and elastic parallelism) are
not ported yet."""

from .elastic import (CoordinationStore, ElasticProtocolError,
                      ElasticTrainer, FileCoordinationStore,
                      InMemoryCoordinationStore, LeaseMembership)

__all__ = ["CoordinationStore", "FileCoordinationStore",
           "InMemoryCoordinationStore", "LeaseMembership",
           "ElasticProtocolError", "ElasticTrainer"]
