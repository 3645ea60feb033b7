"""Model serving: the HTTP inference endpoint over ``output()``,
continuous-batched generation over a paged KV arena (``POST /generate``),
and the fleet in front of the replicas (registration under leases, the
routing router with failover, rolling model deploys).
"""

from .decode import (DecodeRequest, DecodeScheduler, PagedDecodeEngine,
                     SchedulerDraining, SchedulerSaturated)
from .fleet import FleetRouter, ReplicaAgent, rolling_set_model
from .kv_cache import PageAllocator, PagedKVArena, PrefixIndex
from .server import InferenceServer, ModelSwapRefused

__all__ = ["InferenceServer", "ModelSwapRefused", "PagedDecodeEngine",
           "DecodeScheduler", "DecodeRequest", "PagedKVArena",
           "PageAllocator", "PrefixIndex", "SchedulerSaturated",
           "SchedulerDraining", "FleetRouter", "ReplicaAgent",
           "rolling_set_model"]
