"""Stats storage implementations.

Parity: reference ``api/storage/StatsStorage.java`` — records are keyed by
(session_id, type_id, worker_id, timestamp); static info + updates; listeners
get posted events. ``InMemoryStatsStorage`` ↔ reference in-memory impl;
``FileStatsStorage`` (append-only JSONL) ↔ the MapDB-backed store.
Counterpart of the JAX package's ``storage/stats_storage.py``: the records
and the JSONL lines are the same, so a file written by either package
opens in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Persistable:
    """One stats record (parity: ``api/storage/Persistable.java``)."""

    session_id: str
    type_id: str
    worker_id: str
    timestamp: float
    data: Dict[str, Any]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "Persistable":
        return Persistable(**json.loads(s))


class StatsStorageListener:
    """Event callbacks (parity: ``StatsStorageListener.java``)."""

    def notify(self, event: str, record: Persistable) -> None:
        pass


class StatsStorageRouter:
    """Write-side contract (parity: ``StatsStorageRouter.java``)."""

    def put_static_info(self, record: Persistable) -> None:
        raise NotImplementedError

    def put_update(self, record: Persistable) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read+write+subscribe storage (parity: ``StatsStorage.java``)."""

    def __init__(self):
        self._static: Dict[Tuple[str, str, str], Persistable] = {}
        self._updates: Dict[Tuple[str, str, str], List[Persistable]] = {}
        self._listeners: List[StatsStorageListener] = []
        self._lock = threading.Lock()

    # -- write --
    def put_static_info(self, record: Persistable) -> None:
        key = (record.session_id, record.type_id, record.worker_id)
        with self._lock:
            self._static[key] = record
            self._persist("static", record)
        self._notify("static", record)

    def put_update(self, record: Persistable) -> None:
        key = (record.session_id, record.type_id, record.worker_id)
        with self._lock:
            self._updates.setdefault(key, []).append(record)
            self._persist("update", record)
        self._notify("update", record)

    # -- read --
    def list_session_ids(self) -> List[str]:
        with self._lock:
            out = {k[0] for k in self._static} | {k[0] for k in self._updates}
        return sorted(out)

    def list_type_ids(self, session_id: str) -> List[str]:
        with self._lock:
            out = {k[1] for k in list(self._static) + list(self._updates)
                   if k[0] == session_id}
        return sorted(out)

    def list_workers(self, session_id: str, type_id: str) -> List[str]:
        with self._lock:
            out = {k[2] for k in list(self._static) + list(self._updates)
                   if k[0] == session_id and k[1] == type_id}
        return sorted(out)

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[Persistable]:
        # under the lock: writer threads mutate _static concurrently
        with self._lock:
            return self._static.get((session_id, type_id, worker_id))

    def get_all_updates_after(self, session_id: str, type_id: str,
                              worker_id: str, timestamp: float
                              ) -> List[Persistable]:
        with self._lock:
            recs = self._updates.get((session_id, type_id, worker_id), [])
            return [r for r in recs if r.timestamp > timestamp]

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: str) -> Optional[Persistable]:
        with self._lock:
            recs = self._updates.get((session_id, type_id, worker_id), [])
            return recs[-1] if recs else None

    # -- subscribe --
    def register_listener(self, listener: StatsStorageListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def _notify(self, event: str, record: Persistable) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for l in listeners:
            l.notify(event, record)

    # -- persistence hook (overridden by FileStatsStorage) --
    def _persist(self, kind: str, record: Persistable) -> None:
        pass


class InMemoryStatsStorage(StatsStorage):
    pass


class FileStatsStorage(StatsStorage):
    """Append-only JSONL persistence, reloaded on open (parity: the
    reference's MapDB-backed ``FileStatsStorage``). Usable as a context
    manager so the append handle cannot leak::

        with FileStatsStorage(path) as st:
            st.put_update(...)
    """

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    entry = json.loads(line)
                    rec = Persistable(**entry["record"])
                    key = (rec.session_id, rec.type_id, rec.worker_id)
                    if entry["kind"] == "static":
                        self._static[key] = rec
                    else:
                        self._updates.setdefault(key, []).append(rec)
        self._f = open(path, "a")

    def _persist(self, kind: str, record: Persistable) -> None:
        if self._f.closed:
            raise ValueError(f"FileStatsStorage({self.path!r}) is closed")
        self._f.write(json.dumps(
            {"kind": kind, "record": dataclasses.asdict(record)}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "FileStatsStorage":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class StatsStorageMetricsListener(StatsStorageListener):
    """Counts records routed through a storage, per event kind and
    type_id — ``stats_records_total{event,type_id}`` answers "is the
    remote run still posting?" from one scrape instead of a UI visit."""

    def __init__(self, registry=None):
        from ..util import metrics as _metrics
        reg = registry if registry is not None else _metrics.REGISTRY
        self.records = reg.counter(
            "stats_records_total", "Stats records routed into storage",
            ("event", "type_id"))

    def notify(self, event: str, record: Persistable) -> None:
        self.records.inc(event=event, type_id=record.type_id)
