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

The elastic local-SGD round protocol (``ElasticCoordinator``,
``ElasticTrainer``; the JAX package's module docstring sets it out) rides
these stores, the durable snapshots of ``util/durable.py`` and
:func:`.distributed.agree_on_digest` over a store-backed gather. It runs
no collective: a dead peer must not hang the survivors. A contribution is
the parameter delta in the packed-leaf framing below, leaves in sorted
(vertex, name) order, so hosts of either package compute the same
digests for the same values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..util import faults as _faults
from ..util import flightrecorder as _flight
from ..util import metrics as _metrics
from ..util import tracing as _tracing
from ..util.resilience import SYSTEM_CLOCK, Clock, Deadline
from .distributed import agree_on_digest

logger = logging.getLogger("deeplearning4j_tpu")

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
# leaf packing: deterministic bytes for contributions/reductions
# ----------------------------------------------------------------------

def pack_leaves(leaves: Sequence[np.ndarray]) -> bytes:
    """Deterministic framing (unlike npz, whose zip metadata can vary):
    one JSON header line with dtypes/shapes, then the raw leaf bytes."""
    arrs = [np.asarray(a) for a in leaves]
    header = json.dumps([{"dtype": str(a.dtype), "shape": list(a.shape)}
                         for a in arrs]).encode()
    buf = io.BytesIO()
    buf.write(header + b"\n")
    for a in arrs:
        buf.write(np.ascontiguousarray(a).tobytes())
    return buf.getvalue()


def unpack_leaves(data: bytes) -> List[np.ndarray]:
    nl = data.index(b"\n")
    metas = json.loads(data[:nl].decode())
    out, off = [], nl + 1
    for m in metas:
        dt = np.dtype(m["dtype"])
        n = int(np.prod(m["shape"])) if m["shape"] else 1
        nbytes = n * dt.itemsize
        a = np.frombuffer(data[off:off + nbytes], dtype=dt)
        out.append(a.reshape(m["shape"]).copy())
        off += nbytes
    return out


def leaves_digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ----------------------------------------------------------------------
# metric families
# ----------------------------------------------------------------------

_ROUND_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                  10.0, 30.0, 60.0)


def rounds_counter(registry=None) -> _metrics.Counter:
    return _reg(registry).counter(
        "sync_rounds_total",
        "Elastic local-SGD sync rounds completed (local steps + publish + "
        "delayed correction)", ("host",))


def round_seconds_histogram(registry=None) -> _metrics.Histogram:
    return _reg(registry).histogram(
        "sync_round_seconds",
        "Wall time of one elastic sync round, including any blocked wait "
        "at the staleness bound", ("host",), buckets=_ROUND_BUCKETS)


def round_wait_seconds_histogram(registry=None) -> _metrics.Histogram:
    return _reg(registry).histogram(
        "sync_round_wait_seconds",
        "Portion of the round spent blocked waiting for a delayed "
        "correction (0 in steady state — the staleness window hides "
        "peer jitter)", ("host",), buckets=_ROUND_BUCKETS)


def staleness_gauge(registry=None) -> _metrics.Gauge:
    return _reg(registry).gauge(
        "staleness_window",
        "How many rounds this host is ahead of the slowest live member "
        "(bounded by max_staleness)", ("host",))


# ----------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ElasticConfig:
    """Fleet spec + protocol knobs for one elastic host.

    ``fleet`` is the ordered host-id spec (identical on every host);
    ``host`` is this process's id and must be in ``fleet``.
    ``max_staleness`` is the SSP window ``s``: a host blocks only when it
    would run more than ``s`` rounds ahead of the slowest live member
    (``s=0`` is fully synchronous local SGD). ``lease_s`` bounds how
    stale a peer's heartbeat may be before the view marks it dead;
    ``evict_after_s`` (default ``lease_s``) is how long a REDUCTION may
    stay blocked on a dead peer before a survivor hard-evicts it from
    the round. ``clock`` is injectable and governs this host's WAITS
    (poll sleeps, eviction deadlines); heartbeat timestamps and lease
    math are deliberately wall-clock ``time.time()`` — they are compared
    ACROSS processes, where an injected per-process clock has no
    meaning. Deterministic tests therefore script failures by killing
    hosts (leases then expire in real time), not by warping the clock.
    """

    fleet: Tuple[str, ...]
    host: str
    steps_per_round: int = 4
    max_staleness: int = 1
    lease_s: float = 10.0
    evict_after_s: Optional[float] = None
    poll_s: float = 0.02
    heartbeat_every_s: Optional[float] = None
    checkpoint_every_rounds: int = 1
    clock: Clock = SYSTEM_CLOCK

    def __post_init__(self):
        self.fleet = tuple(self.fleet)
        if self.host not in self.fleet:
            raise ValueError(f"host {self.host!r} not in fleet {self.fleet}")
        if len(set(self.fleet)) != len(self.fleet):
            raise ValueError(f"duplicate host ids in fleet {self.fleet}")
        if self.steps_per_round < 1:
            raise ValueError("steps_per_round must be >= 1")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if self.evict_after_s is None:
            self.evict_after_s = float(self.lease_s)
        if self.heartbeat_every_s is None:
            self.heartbeat_every_s = max(self.poll_s, self.lease_s / 4.0)


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


# ----------------------------------------------------------------------
# coordinator: heartbeats, membership log, round ledger
# ----------------------------------------------------------------------

_EV_EVICT = "evict"
_EV_REJOIN = "rejoin"


class ElasticCoordinator:
    """One host's handle on the shared bulletin board.

    Key layout::

        hb/<host>.json                     heartbeat (overwritten)
        log/<seq>_<event>_<host>.json      membership log (create-once)
        rounds/r<round>/<host>.bin         contribution (create-once)
        rounds/r<round>/REDUCE.json        reduce record (create-once)
        final/<host>.json                  final digest barrier
    """

    def __init__(self, store: CoordinationStore, cfg: ElasticConfig, *,
                 registry=None):
        self.store = store
        self.cfg = cfg
        self.registry = registry
        self.host = cfg.host
        self.membership = LeaseMembership(
            store, observer=cfg.host, lease_s=cfg.lease_s,
            members=cfg.fleet, registry=registry)
        self.incarnation = self.membership.next_incarnation(cfg.host)
        self._last_hb = -1e18
        self._log_cache: Optional[Tuple[Tuple[str, ...], List[dict]]] = None

    # -- heartbeats ----------------------------------------------------

    def heartbeat(self, round_: int, status: str = "live", *,
                  force: bool = False) -> None:
        """Publish liveness from the MAIN loop only — a hung main thread
        must stop heartbeating so its lease can expire."""
        now = time.time()
        if not force and now - self._last_hb < self.cfg.heartbeat_every_s:
            return
        self._last_hb = now
        self.membership.publish(self.host, {
            "host": self.host, "incarnation": self.incarnation,
            "round": int(round_), "status": status})

    def fleet_view(self) -> Dict[str, dict]:
        """Refresh the lease-level view; records join/evict/rejoin
        transitions into metrics + the flight recorder."""
        return self.membership.view()

    # -- membership log (round math) -----------------------------------

    def membership_log(self) -> List[dict]:
        keys = tuple(self.store.list("log"))
        cached = self._log_cache
        if cached is not None and cached[0] == keys:
            return cached[1]
        recs = []
        for key in keys:
            doc = self.store.get_json(key)
            if doc is not None:
                recs.append(doc)
        recs.sort(key=lambda d: int(d["seq"]))
        # append-only log: safe to cache per key listing (one remote
        # LIST per poll instead of O(records) remote reads)
        self._log_cache = (keys, recs)
        return recs

    def _append_log(self, event: str, host: str, effective_round: int,
                    **extra) -> dict:
        recs = self.membership_log()
        seq = (int(recs[-1]["seq"]) + 1) if recs else 1
        # membership changes are written from inside a round/fit span:
        # stamping the active trace id lets the timeline collector tie
        # an eviction to the exact round trace that observed it
        span = _tracing.active_span()
        if span is not None:
            extra.setdefault("trace_id", span.trace_id)
        while True:
            doc = {"seq": seq, "event": event, "host": host,
                   "effective_round": int(effective_round),
                   "by": self.host, "ts": time.time(), **extra}
            # key is the SEQ alone: two concurrent appends must collide
            # on the create-once put (a key that also carried event/host
            # would let both land with the same seq, leaving tie order
            # to filename alphabetics instead of causality)
            if self.store.put_json(f"log/{seq:06d}.json", doc):
                self._log_cache = None
                return doc
            seq += 1            # lost the seq race; append after the winner

    def member_at(self, host: str, round_: int) -> bool:
        decided = True          # fleet-spec hosts start as members
        for rec in self.membership_log():
            if rec["host"] != host or rec["effective_round"] > round_:
                continue
            decided = rec["event"] == _EV_REJOIN
        return decided

    def members_for_round(self, round_: int) -> Tuple[str, ...]:
        return tuple(h for h in self.cfg.fleet if self.member_at(h, round_))

    def eviction_of(self, host: str) -> Optional[dict]:
        """The newest membership record for ``host`` if it is an
        eviction (i.e. the host is currently hard-evicted), else None."""
        last = None
        for rec in self.membership_log():
            if rec["host"] == host:
                last = rec
        return last if last is not None and last["event"] == _EV_EVICT \
            else None

    def hard_evict(self, host: str, *, blocked_round: int) -> dict:
        """Remove ``host`` from every round it has not published
        (effective = last published round + 1 — rounds it DID publish
        stay intact, so no already-consumed reduction is invalidated)."""
        effective = self.last_published_round(host, upto=blocked_round) + 1
        self._log_cache = None
        existing = self.eviction_of(host)
        if existing is not None and \
                int(existing["effective_round"]) <= effective:
            # a racing survivor already evicted this host for these
            # rounds — don't duplicate the record or the metric
            return existing
        rec = self._append_log(_EV_EVICT, host, effective,
                               blocked_round=int(blocked_round))
        transitions_counter(self.registry).inc(event="hard_evict",
                                               host=host)
        _flight.record("elastic_evict", host=host, by=self.host,
                       effective_round=effective,
                       blocked_round=int(blocked_round))
        logger.warning(
            "elastic: hard-evicted %s from round %d on (blocked on round "
            "%d past the eviction deadline)", host, effective,
            blocked_round)
        return rec

    def rejoin(self, host: str, effective_round: int,
               incarnation: int) -> dict:
        rec = self._append_log(_EV_REJOIN, host, effective_round,
                               incarnation=int(incarnation))
        _flight.record("elastic_rejoin", host=host,
                       effective_round=int(effective_round),
                       incarnation=int(incarnation))
        return rec

    # -- round ledger --------------------------------------------------

    @staticmethod
    def _round_dir(round_: int) -> str:
        return f"rounds/r{round_:06d}"

    def publish_contribution(self, round_: int,
                             leaves: Sequence[np.ndarray]) -> str:
        """Atomic, idempotent publish of this host's round delta. A
        replayed publish must be BIT-IDENTICAL to what an earlier
        incarnation published — a digest mismatch means nondeterministic
        replay, which would silently corrupt the chain, so it refuses."""
        payload = pack_leaves(leaves)
        digest = leaves_digest(payload)
        key = f"{self._round_dir(round_)}/{self.host}.bin"
        if not self.store.put(key, payload):
            existing = self.store.get(key)
            if existing is None or leaves_digest(existing) != digest:
                raise ElasticProtocolError(
                    f"replayed contribution for round {round_} differs "
                    f"from the published one (host {self.host}) — "
                    "nondeterministic replay, refusing to continue")
        _flight.record("elastic_publish", host=self.host,
                       round=int(round_), digest=digest[:12])
        return digest

    def contribution(self, round_: int, host: str) \
            -> Optional[List[np.ndarray]]:
        raw = self.store.get(f"{self._round_dir(round_)}/{host}.bin")
        return None if raw is None else unpack_leaves(raw)

    def published_hosts(self, round_: int) -> Tuple[str, ...]:
        out = []
        for key in self.store.list(self._round_dir(round_)):
            name = os.path.basename(key)
            if name.endswith(".bin"):
                out.append(name[:-4])
        return tuple(sorted(out))

    def last_published_round(self, host: str, *, upto: int) -> int:
        for r in range(int(upto), -1, -1):
            if self.store.get(f"{self._round_dir(r)}/{host}.bin") is not None:
                return r
        return -1

    def reduce_record(self, round_: int) -> Optional[dict]:
        return self.store.get_json(f"{self._round_dir(round_)}/REDUCE.json")

    # -- round trace records (attribution, not protocol) ---------------

    def publish_trace(self, round_: int, spans: Sequence[dict]) -> None:
        """Export this host's round-``round_`` spans next to the REDUCE
        record (``trace_<host>.json``). Overwrite-mode and best-effort:
        a replayed round records the replay's timings, and a failing
        export must never fail the round it describes."""
        try:
            self.store.put_json(
                f"{self._round_dir(round_)}/trace_{self.host}.json",
                {"host": self.host, "round": int(round_),
                 "incarnation": self.incarnation, "spans": list(spans)},
                overwrite=True)
        except Exception:
            logger.exception("elastic: trace export for round %d failed",
                             round_)

    def trace_records(self, round_: int) -> List[dict]:
        out = []
        for key in self.store.list(self._round_dir(round_)):
            name = os.path.basename(key)
            if name.startswith("trace_") and name.endswith(".json"):
                doc = self.store.get_json(key)
                if doc is not None:
                    out.append(doc)
        return out

    def _compute_reduction(self, round_: int,
                           members: Sequence[str]) -> List[np.ndarray]:
        """Mean of the members' deltas in fleet order, accumulated in
        float64 — the op order is fixed, so every host computes the same
        bits."""
        acc: Optional[List[np.ndarray]] = None
        for h in members:
            leaves = self.contribution(round_, h)
            if leaves is None:
                raise ElasticProtocolError(
                    f"round {round_}: member {h} has no contribution")
            if acc is None:
                acc = [l.astype(np.float64) for l in leaves]
            else:
                acc = [a + l for a, l in zip(acc, leaves)]
        if acc is None:
            raise ElasticProtocolError(
                f"round {round_}: empty membership")
        return [a / float(len(members)) for a in acc]

    def try_reduce(self, round_: int) -> Optional[List[np.ndarray]]:
        """Return round ``round_``'s reduction if computable now.

        An existing REDUCE record is AUTHORITATIVE (its member list pins
        the round even if the membership log has since changed);
        otherwise, once every current member's contribution is present,
        compute the mean and race to publish the record — the loser
        adopts the winner's membership.
        """
        rec = self.reduce_record(round_)
        if rec is None:
            members = self.members_for_round(round_)
            published = set(self.published_hosts(round_))
            if not members or not set(members) <= published:
                return None
            red = self._compute_reduction(round_, members)
            digest = leaves_digest(pack_leaves(red))
            if not self.store.put_json(
                    f"{self._round_dir(round_)}/REDUCE.json",
                    {"round": int(round_), "members": list(members),
                     "digest": digest, "by": self.host}):
                rec = self.reduce_record(round_)   # lost the race
            else:
                _flight.record("elastic_reduce", round=int(round_),
                               members=list(members), by=self.host)
                return red
        members = tuple(rec["members"])
        red = self._compute_reduction(round_, members)
        digest = leaves_digest(pack_leaves(red))
        if digest != rec["digest"]:
            raise ElasticProtocolError(
                f"round {round_}: recomputed reduction digest {digest[:12]} "
                f"!= published {rec['digest'][:12]} — hosts disagree on "
                "the round inputs")
        return red

    # -- final digest barrier ------------------------------------------

    def publish_final(self, digest: str) -> None:
        self.store.put_json(f"final/{self.host}.json",
                            {"host": self.host, "digest": digest,
                             "incarnation": self.incarnation},
                            overwrite=True)

    def final_digest_of(self, host: str) -> Optional[str]:
        doc = self.store.get_json(f"final/{host}.json")
        return None if doc is None else doc.get("digest")


# ----------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------

def _param_items(net):
    """The net's parameter tensors in sorted (vertex, name) order — the
    JAX package's tree-leaf order."""
    params = net.params
    return [params[v][k] for v in sorted(params) for k in sorted(params[v])]


def _net_param_leaves(net) -> List[np.ndarray]:
    return [t.detach().cpu().numpy().copy() for t in _param_items(net)]


def _set_net_params_from_leaves(net, leaves: Sequence[np.ndarray]) -> None:
    items = _param_items(net)
    if len(items) != len(leaves):
        raise ElasticProtocolError(
            f"{len(leaves)} leaves for {len(items)} parameters")
    with torch.no_grad():
        for t, leaf in zip(items, leaves):
            t.copy_(torch.from_numpy(np.ascontiguousarray(leaf)))


class ElasticTrainer:
    """Bounded-staleness elastic local-SGD over a shared coordination
    store. See the module docstring for the protocol.

    ``stepper_factory(net)`` (optional) builds the object whose
    ``fit_batch(x, y[, mask])`` runs one local step updating ``net`` in
    place — e.g. a sync-mode
    :class:`~.wrapper.ParallelWrapper` so the
    local steps are themselves data-parallel over this host's devices.
    A factory (not an instance) because restore/rejoin can swap the
    underlying network, and the stepper's jitted closures must be
    rebuilt against the live one.

    ``fit(batch_fn, rounds=R)`` trains R rounds; ``batch_fn(round,
    step)`` returns ``(x, y)`` or ``(x, y, mask)`` and must be a pure
    function of its arguments (per-host seeded), which is what makes
    replay-on-rejoin exact. With ``checkpoint_dir`` set, construction
    restores the newest durable snapshot (round cursor included) and
    ``fit`` fast-forwards: it republishes the missed rounds
    (digest-verified) and rejoins the fleet without stopping anyone.
    """

    def __init__(self, net, store, cfg: ElasticConfig, *,
                 checkpoint_dir: Optional[str] = None,
                 registry=None, watchdog_s: Optional[float] = None,
                 handle_signals: bool = False, keep: int = 3,
                 stepper_factory: Optional[Callable] = None,
                 tracer: Optional[_tracing.Tracer] = None):
        from ..util.durable import CheckpointStore
        if isinstance(store, str):
            store = FileCoordinationStore(store)
        self.cfg = cfg
        self.registry = registry
        # per-trainer tracer named by the LOGICAL host id (not the
        # machine hostname): merged fleet timelines attribute phases to
        # fleet members. Root parent comes from DL4JTPU_TRACEPARENT when
        # the cluster scheduler (or the chaos harness) set one, so every
        # host's spans share the fleet trace id.
        self.tracer = tracer if tracer is not None \
            else _tracing.Tracer(host=cfg.host, registry=registry)
        self._round_spans: List[_tracing.Span] = []
        self.coord = ElasticCoordinator(store, cfg, registry=registry)
        self.watchdog_s = watchdog_s
        self.handle_signals = handle_signals
        self.preempted = False
        self.resumed = False
        self.agreed: Optional[bool] = None
        self.final_digest: Optional[str] = None
        self._fresh_net = net
        self._round = 0
        self._applied_next = 0      # next reduction round to fold in
        self._own_deltas: Dict[int, List[np.ndarray]] = {}
        # first round whose local delta belongs to THIS param chain —
        # corrections for earlier rounds fold in the full reduction
        # (a rejoined-as-new member's old-incarnation deltas are part of
        # R(j) like any other member's, never subtracted)
        self._member_from = 0
        self._held = None           # round-start TrainingState
        self._ctx: Dict[str, Any] = {"host": cfg.host}
        self._p0: Optional[List[np.ndarray]] = None
        self.ckpt_store = (CheckpointStore(
            checkpoint_dir, keep=keep,
            device=getattr(net, "device", "cuda"))
            if checkpoint_dir else None)
        if net is not None and net.params is None:
            net.init()
        self.net = net
        # p0 — the chain origin every host must share bit-for-bit (same
        # seed/init on every host). The final fleet state is
        # RECONSTRUCTED as p0 + sum of round reductions in one canonical
        # op order, because the incremental per-host chains reach the
        # same value only up to float non-associativity.
        self._p0 = _net_param_leaves(net) if net is not None else None
        if self.ckpt_store is not None:
            loaded = self.ckpt_store.load_latest()
            if loaded is not None:
                el = (loaded.cursor or {}).get("elastic", {})
                self.net = loaded.net
                self._round = int(el.get("round", 0))
                self._applied_next = max(0, self._round - cfg.max_staleness)
                self.resumed = True
                logger.info(
                    "elastic: host %s restored durable snapshot at round "
                    "%d (iter %d) — fast-forwarding", cfg.host,
                    self._round, loaded.iteration_count)
        self._stepper_factory = stepper_factory
        self.stepper = (stepper_factory(self.net) if stepper_factory
                        else self.net)
        self._watchdog = None
        self._preemption = None

    # -- helpers -------------------------------------------------------

    def _capture(self, kind: str = "round"):
        from ..util.durable import TrainingState
        cursor = {"elastic": {"round": self._round,
                              "host": self.cfg.host,
                              "incarnation": self.coord.incarnation}}
        return TrainingState.capture(self.net, cursor=cursor, kind=kind)

    def _write_snapshot(self, state) -> None:
        if self.ckpt_store is not None and state is not None:
            self.ckpt_store.save(state, registry=self.registry)

    def _stop_requested(self) -> bool:
        return (self._preemption is not None
                and self._preemption.requested)

    def _pet(self) -> None:
        if self._watchdog is not None:
            self._watchdog.pet()

    @contextlib.contextmanager
    def _span(self, name: str, **attrs):
        """A tracer span collected into the current round's export set."""
        with self.tracer.span(name, attributes=attrs) as s:
            self._round_spans.append(s)
            yield s

    def _record_span(self, name: str, seconds: float, **attrs) -> None:
        self._round_spans.append(
            self.tracer.record(name, seconds, attributes=attrs))

    # -- rejoin planning -----------------------------------------------

    def _plan_membership(self, rounds: int) -> None:
        """Decide how this incarnation participates: normal start,
        backfill fast-forward, or rejoin-as-new after a hard eviction."""
        ev = self.coord.eviction_of(self.cfg.host)
        if ev is None:
            if self.resumed:
                _flight.record("elastic_backfill", host=self.cfg.host,
                               from_round=self._round)
            return
        # hard-evicted: rounds >= effective were (or will be) reduced
        # without us — backfill is impossible. Rejoin as a NEW member:
        # re-seed from p0, fold in the published reduction history, and
        # pick an effective round beyond the fleet's reduce frontier.
        if self._fresh_net.params is None:
            self._fresh_net.init()
        self.net = self._fresh_net
        self.stepper = (self._stepper_factory(self.net)
                        if self._stepper_factory else self.net)
        s = self.cfg.max_staleness
        rho = -1
        while True:
            view = self.coord.fleet_view()
            frontier = max([v["round"] for v in view.values()]
                           + [int(ev["effective_round"])])
            rho = min(max(rho + 1, frontier + s + 2), rounds)
            if rho < rounds and self.coord.reduce_record(rho) is not None:
                continue        # already reduced without us: bump first
            self.coord.rejoin(self.cfg.host, rho, self.coord.incarnation)
            # a reduce that raced past our record pins us OUT of rho;
            # NEUTRALIZE the now-stale rejoin record (otherwise rounds
            # in [rho, rho') would count us as a member who never
            # publishes, stalling survivors into a second eviction) and
            # bump (effective rounds stay monotonic)
            rec = self.coord.reduce_record(rho)
            if rho >= rounds or rec is None \
                    or self.cfg.host in rec.get("members", ()):
                break
            self.coord._append_log(_EV_EVICT, self.cfg.host, rho,
                                   reason="rejoin_raced")
        transitions_counter(self.registry).inc(event="rejoin",
                                               host=self.cfg.host)
        self._round = rho
        self._applied_next = 0      # fold the full reduction history in
        self._own_deltas.clear()
        self._member_from = rho
        self.resumed = True
        logger.info(
            "elastic: host %s hard-evicted at round %d — rejoining as a "
            "new member from round %d", self.cfg.host,
            int(ev["effective_round"]), rho)

    # -- waits ---------------------------------------------------------

    def _await_reduce(self, round_: int) -> Optional[List[np.ndarray]]:
        """Block until round ``round_`` reduces. While blocked: keep
        heartbeating, attribute the stall to the missing hosts (flight
        recorder), and hard-evict a lease-dead host once the eviction
        deadline passes. Returns None when preemption interrupts."""
        cfg = self.cfg
        started = cfg.clock.monotonic()
        evict_deadlines: Dict[str, Deadline] = {}
        last_stall: Tuple = ()
        while True:
            t_try = cfg.clock.monotonic()
            red = self.coord.try_reduce(round_)
            if red is not None:
                now = cfg.clock.monotonic()
                reduce_s = now - t_try
                waited = now - started
                if waited > cfg.poll_s:
                    round_wait_seconds_histogram(self.registry).observe(
                        waited, host=cfg.host)
                # the round timeline's wait/reduce decomposition: wait =
                # blocked polling for peers (attributed to the missing
                # hosts), reduce = the successful mean + digest check
                self._record_span("wait", waited - reduce_s,
                                  round=round_,
                                  waiting_on=list(last_stall))
                self._record_span("reduce", reduce_s, round=round_)
                return red
            if self._stop_requested():
                return None
            self.coord.heartbeat(self._round)
            view = self.coord.fleet_view()
            members = self.coord.members_for_round(round_)
            missing = tuple(h for h in members
                            if h not in self.coord.published_hosts(round_))
            if missing != last_stall:
                last_stall = missing
                _flight.record(
                    "elastic_stall", host=cfg.host, round=int(round_),
                    waiting_on=list(missing),
                    waited_s=round(cfg.clock.monotonic() - started, 3))
            for h in missing:
                if h == cfg.host:
                    raise ElasticProtocolError(
                        f"round {round_}: waiting on own contribution")
                if view.get(h, {}).get("alive", False):
                    evict_deadlines.pop(h, None)
                    continue
                dl = evict_deadlines.get(h)
                if dl is None:
                    dl = evict_deadlines[h] = Deadline(
                        cfg.evict_after_s, cfg.clock)
                if dl.expired:
                    self.coord.hard_evict(h, blocked_round=round_)
                    evict_deadlines.pop(h, None)
            self._pet()
            cfg.clock.sleep(cfg.poll_s)

    def _apply_correction(self, round_: int,
                          reduction: Sequence[np.ndarray]) -> None:
        own = self._own_deltas.pop(round_, None)
        if own is None and round_ >= self._member_from:
            # a resumed incarnation recovers its own published delta
            # from the ledger (the in-memory copy died with the process)
            own = self.coord.contribution(round_, self.cfg.host)
        leaves = _net_param_leaves(self.net)
        out = []
        for i, p in enumerate(leaves):
            corr = reduction[i] - (own[i].astype(np.float64)
                                   if own is not None else 0.0)
            out.append((p.astype(np.float64) + corr).astype(p.dtype))
        _set_net_params_from_leaves(self.net, out)

    # -- the round -----------------------------------------------------

    def _run_round(self, batch_fn: Callable, r: int) -> bool:
        cfg = self.cfg
        t0 = cfg.clock.monotonic()
        self._round = r
        self._ctx.update(round=r, phase="steps", waiting_on=[])
        self._round_spans = []
        replay = cfg.host in self.coord.published_hosts(r)
        with self._span("elastic.round", round=r, replay=bool(replay)):
            self._held = self._capture()
            if cfg.checkpoint_every_rounds and \
                    r % cfg.checkpoint_every_rounds == 0:
                self._write_snapshot(self._held)
            self.coord.heartbeat(r)
            p_before = _net_param_leaves(self.net)
            with self._span("local_steps", round=r,
                            steps=cfg.steps_per_round):
                for step in range(cfg.steps_per_round):
                    it = getattr(self.net, "iteration_count", 0)
                    _faults.check("training.step",
                                  {"iteration": it, "round": r,
                                   "host": cfg.host, "elastic": True})
                    if self._stop_requested():
                        return False    # round restarts from _held
                    batch = batch_fn(r, step)
                    self.stepper.fit_batch(*batch)
                    self._pet()
                    self.coord.heartbeat(r)   # rate-limited; bounds the
                                              # gap to one step even in
                                              # long rounds
            delta = [a - b for a, b in zip(_net_param_leaves(self.net),
                                           p_before)]
            with self._span("publish", round=r):
                self.coord.publish_contribution(r, delta)
            self._own_deltas[r] = delta
            self.coord.heartbeat(r + 1, force=True)
            j = r - cfg.max_staleness
            while self._applied_next <= j:
                self._ctx.update(phase="await_reduce", waiting_on=[])
                red = self._await_reduce(self._applied_next)
                if red is None:
                    return False
                with self._span("apply", round=self._applied_next):
                    self._apply_correction(self._applied_next, red)
                self._applied_next += 1
            dt = cfg.clock.monotonic() - t0
            rounds_counter(self.registry).inc(host=cfg.host)
            round_seconds_histogram(self.registry).observe(dt,
                                                           host=cfg.host)
            view = self.coord.fleet_view()
            live_rounds = [v["round"] for h, v in view.items()
                           if v["alive"] and not v["done"] and h != cfg.host
                           and v["round"] >= 0]
            staleness_gauge(self.registry).set(
                (r + 1) - min(live_rounds) if live_rounds else 0,
                host=cfg.host)
            _flight.record("elastic_round", host=cfg.host, round=r,
                           seconds=round(dt, 4), steps=cfg.steps_per_round,
                           replay=bool(replay))
        # export the finished round's spans next to its REDUCE record —
        # the timeline collector's per-host input for this round
        self.coord.publish_trace(r, [s.to_dict()
                                     for s in self._round_spans])
        return True

    # -- finish: tail flush + digest barrier ---------------------------

    def _finish(self, rounds: int) -> None:
        cfg = self.cfg
        while self._applied_next < rounds:
            self._ctx.update(phase="tail_flush",
                             round=self._applied_next)
            red = self._await_reduce(self._applied_next)
            if red is None:
                return
            self._apply_correction(self._applied_next, red)
            self._applied_next += 1
        # canonical finalization: every host rebuilds p0 + Σ R(j) with
        # one op order. The incremental chains above land on the same
        # value only up to float non-associativity ((p0+d)+(R-d) is not
        # bitwise p0+R); the barrier digest needs the exact same bits.
        acc = [p.astype(np.float64) for p in self._p0]
        for j in range(rounds):
            red = self.coord.try_reduce(j)
            if red is None:
                raise ElasticProtocolError(
                    f"round {j} not reduced at finalization")
            acc = [a + r_ for a, r_ in zip(acc, red)]
        _set_net_params_from_leaves(
            self.net, [a.astype(p.dtype) for a, p in zip(acc, self._p0)])
        from ..util.durable import params_digest
        digest = params_digest(self.net.params, None, 0)
        self.final_digest = digest
        self.coord.publish_final(digest)
        self.coord.heartbeat(rounds, status="done", force=True)
        self.agreed = agree_on_digest(
            digest, allgather=self._final_allgather(rounds))
        _flight.record("elastic_final", host=cfg.host,
                       digest=digest[:12], agreed=self.agreed)
        if not self.agreed:
            raise ElasticProtocolError(
                "fleet digest disagreement at the final barrier — a host "
                "diverged from the deterministic round chain")
        self._write_snapshot(self._capture(kind="final"))

    def _final_allgather(self, rounds: int):
        """A store-backed allgather for ``agree_on_digest``: wait for
        every round-``rounds`` member's final digest (hard-evicting a
        host that dies before the barrier), then return them stacked in
        fleet order."""
        cfg = self.cfg

        def gather(local: np.ndarray) -> np.ndarray:
            deadlines: Dict[str, Deadline] = {}
            while True:
                members = [h for h in cfg.fleet
                           if self.coord.member_at(h, rounds)]
                digests = {h: self.coord.final_digest_of(h)
                           for h in members}
                missing = [h for h in members if digests[h] is None]
                if not missing:
                    rows = [np.frombuffer(bytes.fromhex(digests[h]),
                                          dtype=np.uint8)
                            for h in members]
                    return np.stack(rows)
                view = self.coord.fleet_view()
                for h in missing:
                    if h == cfg.host or view.get(h, {}).get("alive"):
                        deadlines.pop(h, None)
                        continue
                    dl = deadlines.setdefault(
                        h, Deadline(cfg.evict_after_s, cfg.clock))
                    if dl.expired:
                        self.coord.hard_evict(h, blocked_round=rounds)
                        deadlines.pop(h, None)
                self.coord.heartbeat(rounds, status="done")
                self._pet()
                cfg.clock.sleep(cfg.poll_s)

        return gather

    # -- fit -----------------------------------------------------------

    def fit(self, batch_fn: Callable, *, rounds: int):
        """Train ``rounds`` elastic sync rounds (resuming from the
        durable round cursor when restored). Returns the network."""
        from ..util.durable import PreemptionHandler, StepWatchdog
        if rounds < 1:
            raise ValueError("rounds must be >= 1")
        self._preemption = (PreemptionHandler().install()
                            if self.handle_signals else None)
        self._watchdog = None
        if self.watchdog_s:
            self._watchdog = StepWatchdog(
                self.watchdog_s, registry=self.registry,
                context_provider=lambda: {
                    **_faults.seam_context(),
                    "elastic": dict(self._ctx)})
            self._watchdog.arm()
        # the host's root span: parented on the fleet trace the spawning
        # scheduler handed us (DL4JTPU_TRACEPARENT), so every member's
        # round spans share one trace id and merge into one timeline
        fit_ctx = self.tracer.span(
            "elastic.fit", parent=_tracing.env_context(),
            attributes={"rounds": rounds,
                        "incarnation": self.coord.incarnation,
                        "resumed": self.resumed})
        fit_span = fit_ctx.__enter__()
        fit_exc: Tuple = (None, None, None)
        try:
            self._plan_membership(rounds)
            # rejoin-as-new flips `resumed` inside _plan_membership —
            # re-stamp so the exported root span reports how this
            # incarnation actually started
            fit_span.set_attribute("resumed", self.resumed)
            self.coord.heartbeat(self._round, force=True)
            self.coord.fleet_view()
            # catch up the reduction history this chain has not yet
            # folded in (rejoined-as-new members start at p0 and need
            # every R(j) up to their first round's base)
            while self._applied_next < self._round - self.cfg.max_staleness:
                self._ctx.update(phase="history_catchup",
                                 round=self._applied_next)
                red = self._await_reduce(self._applied_next)
                if red is None:
                    break
                self._apply_correction(self._applied_next, red)
                self._applied_next += 1
            r = self._round
            while r < rounds and not self._stop_requested():
                if not self._run_round(batch_fn, r):
                    break
                r += 1
                self._round = r
            if not self._stop_requested():
                self._finish(rounds)
            if self._stop_requested():
                # preempted mid-rounds OR mid-finish: round-start state
                # is the recovery point — mid-round progress and the
                # tail flush are recomputed deterministically on resume
                self.preempted = True
                self._write_snapshot(self._held)
                _flight.record("elastic_preempted", host=self.cfg.host,
                               round=self._round)
        except BaseException:
            # captured explicitly, NOT via sys.exc_info() in the
            # finally — a caller invoking fit() from inside its own
            # `except` block (the restart-after-preemption flow) has a
            # live outer exception that would falsely mark a clean
            # run's root span as error
            fit_exc = sys.exc_info()
            raise
        finally:
            fit_ctx.__exit__(*fit_exc)
            if self._watchdog is not None:
                self._watchdog.disarm()
            if self._preemption is not None:
                self._preemption.uninstall()
        return self.net
