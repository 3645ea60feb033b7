"""Remote stats routing: POST training stats to a UI server on another host.

Parity: reference ``deeplearning4j-core/.../api/storage/impl/
RemoteUIStatsStorageRouter.java`` — workers/Spark executors route their
``Persistable`` stats records over HTTP to the central UI's
``RemoteReceiverModule``. Here the receiver is the UI server's
``POST /api/remote`` endpoint (:mod:`..ui.server`); the same JSON body as
the JAX package's router, so either package's server takes either's posts.

Async by design (like the reference): a daemon thread drains a bounded
queue so a slow/unreachable UI never blocks the training loop. Delivery
rides the resilience substrate (:mod:`..util.resilience`)
instead of a fixed-count hammer loop: per-record exponential-backoff
retries under a :class:`RetryPolicy`, behind a :class:`CircuitBreaker` —
consecutive failures trip the breaker OPEN and further records are
dropped immediately (stats are best-effort telemetry) until the cool-down
lets one probe through. Clock and transport are injectable, so the whole
failure story is tested deterministically (no real sleeps or sockets);
fault seam: ``"storage.post"``.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.request
import warnings
from typing import Callable, Optional

from ..util import faults as _faults
from ..util.resilience import (SYSTEM_CLOCK, CircuitBreaker, Clock,
                               RetryPolicy)
from .stats_storage import Persistable, StatsStorageRouter


class RemoteUIStatsStorageRouter(StatsStorageRouter):
    """Routes records to ``<url>/api/remote`` via HTTP POST."""

    _SENTINEL = object()

    def __init__(self, url: str, *, queue_size: int = 1000,
                 max_retries: int = 3, timeout: float = 5.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 clock: Clock = SYSTEM_CLOCK,
                 transport: Optional[Callable[[str, bytes, float],
                                              None]] = None):
        self.url = url.rstrip("/") + "/api/remote"
        self.timeout = float(timeout)
        self.clock = clock
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=int(max_retries), initial_backoff=0.2,
            max_backoff=5.0, deadline_s=30.0, clock=clock,
            name="remote-ui")
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=5, reset_timeout_s=30.0, clock=clock,
            name=f"remote-ui[{self.url}]")
        self._transport = transport or self._http_post
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._dropped = 0
        self._posted = 0
        self._closed = False
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    # -- router interface --

    def put_static_info(self, record: Persistable) -> None:
        self._enqueue("static", record)

    def put_update(self, record: Persistable) -> None:
        self._enqueue("update", record)

    # -- internals --

    def _enqueue(self, kind: str, record: Persistable) -> None:
        if self._closed:
            raise ValueError("router is closed")
        try:
            self._queue.put_nowait((kind, record))
        except queue.Full:
            self._dropped += 1

    def _http_post(self, url: str, body: bytes, timeout: float) -> None:
        """Default transport: one HTTP round-trip; raises on any failure."""
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            if not (200 <= r.status < 300):
                raise IOError(f"remote UI returned status {r.status}")

    def _post(self, kind: str, record: Persistable) -> bool:
        body = json.dumps({"kind": kind,
                           "record": json.loads(record.to_json())}).encode()
        for _attempt in self.retry_policy.attempts():
            # the breaker gates every attempt: tripping OPEN mid-loop
            # stops the remaining retries from hammering a dead UI
            if not self.breaker.allow():
                return False
            try:
                _faults.check("storage.post", {"url": self.url,
                                               "body": body})
                self._transport(self.url, body, self.timeout)
            except Exception:
                self.breaker.record_failure()
                continue
            self.breaker.record_success()
            return True
        self.retry_policy.record_give_up()
        return False

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is self._SENTINEL:
                    return
                kind, record = item
                if self._post(kind, record):
                    self._posted += 1
                else:
                    self._dropped += 1
            finally:
                # task_done AFTER the POST so flush() waits for in-flight
                # records, not just an empty queue.
                self._queue.task_done()

    def flush(self, timeout: float = 10.0) -> None:
        """Block until queued records are posted (or timeout)."""
        import time
        q = self._queue
        deadline = time.time() + timeout
        with q.all_tasks_done:
            while q.unfinished_tasks:
                remaining = deadline - time.time()
                if remaining <= 0 or not q.all_tasks_done.wait(remaining):
                    break

    def close(self, timeout: float = 10.0) -> None:
        self.flush(timeout)
        self._closed = True
        self._queue.put(self._SENTINEL)
        self._thread.join(timeout=timeout)
        if self._dropped:
            warnings.warn(
                f"RemoteUIStatsStorageRouter dropped {self._dropped} records "
                f"(posted {self._posted})")
