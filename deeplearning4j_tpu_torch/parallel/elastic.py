"""The elastic coordination substrate (counterpart of the JAX package's
``parallel/elastic.py``): the shared bulletin board and the heartbeat-lease
membership that training fleets and serving fleets share.

Ported: :class:`CoordinationStore` with its file and in-memory
implementations, :class:`LeaseMembership` and the metric families. The
on-disk layout of :class:`FileCoordinationStore` is the reference's byte
for byte (keys are relative paths, values are files, JSON documents are
``json.dumps(doc, sort_keys=True)``), so processes of both packages can
share one store directory: a fleet may mix replicas and routers of either
package.

The elastic local-SGD trainer itself (``ElasticCoordinator``,
``ElasticTrainer``) is not ported yet and raises ``NotYetPorted``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..nn.conf.layers import NotYetPorted
from ..util import flightrecorder as _flight
from ..util import metrics as _metrics

class ElasticProtocolError(RuntimeError):
    """The round protocol reached an inconsistent state (diverged replay,
    digest disagreement, conflicting reduce membership)."""


# ----------------------------------------------------------------------
# coordination store: the durable bulletin board
# ----------------------------------------------------------------------

class CoordinationStore:
    """Tiny KV bulletin board with atomic create-once publish.

    The elastic protocol needs exactly three properties: (1) ``put`` is
    atomic (a reader never sees a torn value), (2) create-once ``put``
    (``overwrite=False``) is an atomic test-and-set — the winner of a
    race is decided by the store, and (3) keys are listable by prefix.
    The file implementation maps keys to files under one directory
    (tmp-write + ``link``/``replace``); the in-memory implementation
    backs single-process protocol tests.
    """

    def put(self, key: str, data: bytes, *, overwrite: bool = False) -> bool:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    # -- JSON convenience ----------------------------------------------

    def put_json(self, key: str, doc: dict, *, overwrite: bool = False) -> bool:
        return self.put(key, json.dumps(doc, sort_keys=True).encode(),
                        overwrite=overwrite)

    def get_json(self, key: str) -> Optional[dict]:
        raw = self.get(key)
        return None if raw is None else json.loads(raw.decode())


class FileCoordinationStore(CoordinationStore):
    """Keys are relative paths under ``directory``; values are files.

    Atomicity: values land in a per-process tmp name first, then
    ``os.link`` (create-once: EEXIST loses the race) or ``os.replace``
    (overwrite) into place — readers see old-or-new bytes, never torn.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._seq = 0
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        base = os.path.normpath(self.directory)
        path = os.path.normpath(os.path.join(base, key))
        # bare startswith would accept SIBLINGS sharing the store path
        # as a prefix (/data/fleet matching /data/fleet2/...)
        if path != base and not path.startswith(base + os.sep):
            raise ValueError(f"key escapes the store: {key!r}")
        return path

    def put(self, key: str, data: bytes, *, overwrite: bool = False) -> bool:
        final = self._path(key)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        with self._lock:
            self._seq += 1
            n = self._seq
        tmp = os.path.join(os.path.dirname(final),
                           f".tmp_{os.getpid()}_{n}_{os.path.basename(final)}")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        try:
            if overwrite:
                os.replace(tmp, final)
                return True
            try:
                os.link(tmp, final)
                return True
            except FileExistsError:
                return False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
            return None

    def list(self, prefix: str) -> List[str]:
        base = self._path(prefix) if prefix else self.directory
        if not os.path.isdir(base):
            return []
        out = []
        for name in os.listdir(base):
            if name.startswith(".tmp_"):
                continue
            full = os.path.join(base, name)
            rel = os.path.join(prefix, name) if prefix else name
            if os.path.isfile(full):
                out.append(rel)
        return sorted(out)


class InMemoryCoordinationStore(CoordinationStore):
    """Thread-safe dict store for single-process protocol tests."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes, *, overwrite: bool = False) -> bool:
        with self._lock:
            if not overwrite and key in self._data:
                return False
            self._data[key] = bytes(data)
            return True

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def list(self, prefix: str) -> List[str]:
        norm = prefix.rstrip("/") + "/" if prefix else ""
        with self._lock:
            keys = list(self._data)
        out = []
        for k in keys:
            if not k.startswith(norm):
                continue
            rest = k[len(norm):]
            if "/" not in rest:         # direct children only, like listdir
                out.append(k)
        return sorted(out)


# ----------------------------------------------------------------------
# metric families
# ----------------------------------------------------------------------

def _reg(registry=None) -> _metrics.MetricsRegistry:
    return registry if registry is not None else _metrics.REGISTRY


def transitions_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "membership_transitions_total",
        "Fleet membership transitions as observed by this process "
        "(join/evict/rejoin at the heartbeat-lease level, hard_evict "
        "when a round is reduced without the host)", ("event", "host"))


# ----------------------------------------------------------------------
# lease membership: the reusable liveness layer
# ----------------------------------------------------------------------

class LeaseMembership:
    """Heartbeat-lease membership view over a :class:`CoordinationStore`.

    The liveness core of the elastic protocol, factored out so training
    fleets and serving fleets share one lease discipline. Members publish
    an overwritten ``<prefix>/<member>.json`` doc stamped with wall-clock
    ``ts``; any observer derives live/dead from lease age and records
    join/evict/rejoin transitions into ``membership_transitions_total``
    plus the flight recorder. Two membership styles:

    - **static** (training): ``members`` is the fleet spec; a spec host
      that never heartbeats becomes an evict once the join grace expires.
    - **dynamic** (serving): ``members=None``; the member set is
      discovered from the store listing, so replicas self-register by
      publishing their first heartbeat and observers need no fleet spec.

    Timestamps are deliberately ``time.time()`` — they are compared
    ACROSS processes, where an injected per-process clock has no meaning
    (the reference's ``ElasticConfig`` says why). Tests script failures by killing
    members, not by warping the clock.
    """

    def __init__(self, store: CoordinationStore, *, observer: str,
                 lease_s: float, members: Optional[Sequence[str]] = None,
                 prefix: str = "hb", join_grace_s: Optional[float] = None,
                 registry=None, flight_kind: str = "elastic_membership"):
        if lease_s <= 0:
            raise ValueError(f"lease_s must be > 0, got {lease_s}")
        self.store = store
        self.observer = observer
        self.lease_s = float(lease_s)
        self.prefix = prefix.strip("/")
        self.static_members = (None if members is None
                               else tuple(members))
        self.registry = registry
        self.flight_kind = flight_kind
        # lease-level view for metrics/attribution: member -> status
        self._view: Dict[str, str] = {
            h: "unseen" for h in (self.static_members or ())}
        # join grace: a member that has NEVER heartbeat is not lease-dead
        # while processes are still starting up (first compiles run long
        # before the first publish); it becomes evictable once the grace
        # from OUR start expires
        self._born = time.time()
        self.join_grace_s = (3.0 * self.lease_s if join_grace_s is None
                             else float(join_grace_s))

    # -- publish side --------------------------------------------------

    def _key(self, member: str) -> str:
        return f"{self.prefix}/{member}.json"

    def next_incarnation(self, member: str) -> int:
        doc = self.store.get_json(self._key(member))
        return (int(doc.get("incarnation", 0)) + 1) if doc else 1

    def publish(self, member: str, doc: dict) -> None:
        """Write ``member``'s heartbeat doc, stamping wall-clock ``ts``.

        Callers own the heartbeat CADENCE (and, crucially, which thread
        publishes: liveness must be attested from the loop whose hang
        should expire the lease)."""
        body = dict(doc)
        body.setdefault("host", member)
        body["ts"] = time.time()
        self.store.put_json(self._key(member), body, overwrite=True)

    # -- observe side --------------------------------------------------

    def members(self) -> Tuple[str, ...]:
        """Static spec if given, else every member ever seen in the
        store. The discovered set only grows — a vanished member
        transitions to dead via its stale lease, not by key removal."""
        if self.static_members is not None:
            return self.static_members
        seen = set(self._view)
        plen = len(self.prefix) + 1
        for key in self.store.list(self.prefix):
            name = key[plen:]
            if name.endswith(".json"):
                seen.add(name[: -len(".json")])
        return tuple(sorted(seen))

    def view(self) -> Dict[str, dict]:
        """Refresh the lease-level view; records join/evict/rejoin
        transitions into metrics + the flight recorder. Each member's
        entry carries ``alive``/``done``/``round``/``incarnation``/
        ``age_s`` plus the raw heartbeat ``doc`` (serving members
        advertise capacity and readiness there)."""
        now = time.time()
        out: Dict[str, dict] = {}
        for h in self.members():
            doc = self.store.get_json(self._key(h)) or {}
            ts = float(doc.get("ts", -1e18))
            done = doc.get("status") == "done"
            alive = done or (now - ts) <= self.lease_s
            in_grace = (now - self._born) <= self.join_grace_s
            if not doc and in_grace:
                alive = True        # starting up (first compile)
            out[h] = {"alive": alive, "done": done,
                      "round": int(doc.get("round", -1)),
                      "incarnation": int(doc.get("incarnation", 0)),
                      "age_s": None if not doc else now - ts,
                      "doc": doc}
            prev = self._view.get(h, "unseen")
            # a never-heartbeat host stays "unseen" through the grace
            # (no spurious join), then turns dead — so a host that never
            # came up reports as an evict, not as a silent unseen
            new = ("done" if done
                   else "live" if doc and alive
                   else "dead" if doc or not in_grace
                   else "unseen")
            if new != prev:
                self._view[h] = new
                event = None
                if prev == "unseen" and new in ("live", "done"):
                    event = "join"
                elif prev in ("live", "done", "unseen") and new == "dead":
                    event = "evict"
                elif prev == "dead" and new in ("live", "done"):
                    event = "rejoin"
                if event is not None:
                    transitions_counter(self.registry).inc(
                        event=event, host=h)
                    _flight.record(self.flight_kind, event=event,
                                   host=h, observer=self.observer,
                                   incarnation=out[h]["incarnation"],
                                   peer_round=out[h]["round"])
        return out


class ElasticCoordinator:
    """Not yet ported: the elastic round ledger."""

    def __init__(self, *args, **kwargs):
        raise NotYetPorted("ElasticCoordinator (the elastic local-SGD "
                           "round protocol) is not yet ported to the "
                           "PyTorch package")


class ElasticTrainer:
    """Not yet ported: elastic local-SGD training across hosts."""

    def __init__(self, *args, **kwargs):
        raise NotYetPorted("ElasticTrainer (elastic local-SGD training) is "
                           "not yet ported to the PyTorch package")
