"""StatsStorage: pub-sub persistence for training stats (the UI backbone).

Parity: reference ``deeplearning4j-core/.../api/storage/`` —
``StatsStorage.java`` (sessions/types/workers, persistable records, listener
notifications), ``StatsStorageRouter.java``, ``impl/CollectionStatsStorageRouter``;
impls ``InMemoryStatsStorage`` and the MapDB-backed store (here: JSONL file).
"""

from .remote import RemoteUIStatsStorageRouter
from .stats_storage import (FileStatsStorage, InMemoryStatsStorage,
                            Persistable, StatsStorage, StatsStorageListener,
                            StatsStorageMetricsListener, StatsStorageRouter)

__all__ = ["StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
           "Persistable", "StatsStorageRouter", "StatsStorageListener",
           "StatsStorageMetricsListener", "RemoteUIStatsStorageRouter"]
