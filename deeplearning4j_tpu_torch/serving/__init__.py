"""Model serving: the HTTP inference endpoint over ``output()``, and
continuous-batched generation over a paged KV arena (``POST /generate``).
"""

from .decode import (DecodeRequest, DecodeScheduler, PagedDecodeEngine,
                     SchedulerDraining, SchedulerSaturated)
from .kv_cache import PageAllocator, PagedKVArena, PrefixIndex
from .server import InferenceServer, ModelSwapRefused

__all__ = ["InferenceServer", "ModelSwapRefused", "PagedDecodeEngine",
           "DecodeScheduler", "DecodeRequest", "PagedKVArena",
           "PageAllocator", "PrefixIndex", "SchedulerSaturated",
           "SchedulerDraining"]
