"""StatsListener: the training-stats producer.

Parity: reference ``ui/stats/StatsListener.java`` — ``iterationDone``
(``:222``) collecting score, iteration timing, memory (``:257-298``), and
param/gradient/update norms + histograms, posted as Persistable records to a
StatsStorageRouter. Counterpart of the JAX package's ``ui/stats.py``: device
memory comes from ``torch.cuda.memory_stats`` under the reference's keys,
one entry per card labelled ``cuda:<i>``; histograms are numpy over f32
host copies of the parameters.
"""

from __future__ import annotations

import logging
import os
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..optimize.listeners import TrainingListener
from ..storage.stats_storage import Persistable, StatsStorageRouter
# the gauges themselves live in util/profiling (nothing UI-specific about
# device memory pressure — the serving layer registers them too);
# re-exported here because this module's listener is the training-side
# registration point
from ..util.profiling import _MEMORY_KINDS
from ..util.profiling import register_device_memory_gauges  # noqa: F401

TYPE_ID = "StatsListener"

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _host_memory_bytes() -> Optional[int]:
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


# the reference's record keys over the caching allocator's counters
_RECORD_KEYS = {"in_use": "bytes_in_use", "peak": "peak_bytes_in_use"}


def _device_memory_stats() -> Optional[Dict[str, Dict[str, int]]]:
    """Per-card memory stats keyed by ``cuda:<i>`` (the UI pane's feed),
    read from the caching allocator's counters (a host query, no device
    sync). None without a card."""
    if not torch.cuda.is_available():
        return None
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {_RECORD_KEYS[kind]: int(stats.get(key, 0))
                            for kind, key in _MEMORY_KINDS}
    return out


def _histogram(arr: np.ndarray, bins: int = 20) -> Dict[str, Any]:
    counts, edges = np.histogram(arr, bins=bins)
    return {"counts": counts.tolist(),
            "min": float(edges[0]), "max": float(edges[-1])}


class StatsListener(TrainingListener):
    """Collects stats every ``frequency`` iterations and routes them to
    storage.

    Two model-internals paths:

    - **On-device** (``device_stats``): the model's stats-enabled train
      step (``net.enable_health_stats()`` / ``util.health``) computes
      per-layer norms, update:param ratios, activation stats and
      log-bucket histograms INSIDE the train dispatch; this listener
      reads the small stats tree with ONE device→host sync per
      collected window — the score rides in the same tree, so the
      LazyScore is never separately synced. ``device_stats=True``
      enables the pass on the model; ``None`` (default) consumes it when
      already enabled; ``False`` never uses it (the host path below is
      the parity oracle).
    - **Legacy host** (``collect_histograms`` / ``collect_norms``):
      copy every param tensor to the host each ``histogram_frequency``-th
      collected window and reduce in numpy. Histograms are only
      materialized when ``collect_histograms=True`` — norms-only
      collection (``collect_norms=True``) still pays the transfer but
      not the binning.

    Async-dispatch contract: ``score`` arrives as a lazy on-device value
    (``util.ingest.LazyScore``); this listener reads it only on collected
    iterations, so at ``frequency=N`` the fit loop pays exactly one
    device→host sync per N steps — off-frequency iterations return
    before any sync and never block the dispatch pipeline."""

    def __init__(self, router: StatsStorageRouter, frequency: int = 1,
                 session_id: Optional[str] = None, worker_id: str = "worker_0",
                 collect_histograms: bool = False,
                 histogram_frequency: int = 10,
                 collect_norms: bool = False,
                 device_stats: Optional[bool] = None):
        self.router = router
        self.frequency = max(1, int(frequency))
        self.session_id = session_id or f"session_{uuid.uuid4().hex[:8]}"
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self.collect_norms = collect_norms
        self.histogram_frequency = max(1, int(histogram_frequency))
        self.device_stats = device_stats
        self._device_requested = False
        self._device_misses = 0      # collected windows with no snapshot
        # device memory belongs on /metrics, not just in posted records
        register_device_memory_gauges()
        # time/iteration of the last COLLECTED iteration: per-iteration
        # duration is (now - then) / iterations-elapsed. (Touching this
        # every iteration_done under-reported iteration_ms by ~frequency×.)
        self._last_time: Optional[float] = None
        self._last_iteration: Optional[int] = None
        self._static_posted = False
        self._prev_params: Optional[Dict[str, np.ndarray]] = None

    # -- listener hooks --
    def _maybe_enable_device_stats(self, model) -> None:
        if self.device_stats and not self._device_requested:
            if hasattr(model, "enable_health_stats"):
                model.enable_health_stats()
            self._device_requested = True

    def on_epoch_start(self, model, epoch: int) -> None:
        self._maybe_enable_device_stats(model)
        if not self._static_posted:
            self._post_static(model)

    def iteration_done(self, model, iteration: int, score) -> None:
        self._maybe_enable_device_stats(model)
        if not self._static_posted:
            self._post_static(model)
        if iteration % self.frequency:
            return
        now = time.perf_counter()
        if self._last_time is None:
            duration_ms = None
        else:
            elapsed_iters = max(1, iteration - self._last_iteration)
            duration_ms = 1000.0 * (now - self._last_time) / elapsed_iters
        self._last_time = now
        self._last_iteration = iteration
        snap = None
        ds = None
        if self.device_stats is not False:
            from ..util import health as _health
            ds = _health.latest_stats(model)
            # only trust a snapshot produced by THIS iteration's dispatch
            # (fit_scan replays fire listeners for window-interior
            # iterations whose snapshot is the window's last step)
            if ds is not None and ds.iteration == iteration:
                snap = ds.value()   # the window's ONE device→host sync
        if snap is not None:
            from ..util import health as _health
            loss = (snap.get(_health.MODEL_KEY) or {}).get("loss")
            score_val = float(score) if loss is None else float(loss)
        else:
            score_val = float(score)
        data: Dict[str, Any] = {
            "iteration": int(iteration),
            "score": score_val,
            "iteration_ms": duration_ms,
        }
        mem = _host_memory_bytes()
        if mem is not None:
            data["host_memory_bytes"] = mem
        dev = _device_memory_stats()
        if dev is not None:
            data["device_memory"] = dev
        if snap is not None:
            self._device_misses = 0
            data["model_stats"] = {"iteration": int(iteration),
                                   "layers": snap}
            data["parameters"] = self._device_param_view(snap)
        else:
            # device_stats=True but NO DeviceStats object exists at all
            # (a mismatched-iteration snapshot is a cadence artifact of
            # fit_scan interior iterations, not absence): the first miss
            # is expected (the stats variant only traces on the NEXT fit
            # after enabling); repeated misses mean this net's step never
            # produces them (e.g. a sharded train_step override) — warn
            # once and fall back to the legacy host path so the listener
            # does not silently post nothing
            fallback = False
            if self.device_stats and ds is None:
                self._device_misses += 1
                fallback = self._device_misses >= 2
                if self._device_misses == 2:
                    logger.warning(
                        "StatsListener(device_stats=True): no on-device "
                        "stats snapshot after %d collected windows — this "
                        "net's train step does not produce them (sharded "
                        "override?); falling back to the host parameter "
                        "path", self._device_misses)
            if ((self.collect_histograms or self.collect_norms or fallback)
                    and (iteration // self.frequency)
                    % self.histogram_frequency == 0):
                data["parameters"] = self._param_stats(
                    model, histograms=self.collect_histograms)
        self.router.put_update(Persistable(
            session_id=self.session_id, type_id=TYPE_ID,
            worker_id=self.worker_id, timestamp=time.time(), data=data))

    # -- internals --
    def _post_static(self, model) -> None:
        info: Dict[str, Any] = {
            "model_class": type(model).__name__,
            "start_time": time.time(),
            "pid": os.getpid(),
        }
        try:
            info["num_params"] = int(model.num_params())
            info["config_json"] = model.conf.to_json()
        except Exception:
            pass
        info["devices"] = ([str(torch.device("cuda", i))
                            for i in range(torch.cuda.device_count())]
                           if torch.cuda.is_available() else ["cpu"])
        self.router.put_static_info(Persistable(
            session_id=self.session_id, type_id=TYPE_ID,
            worker_id=self.worker_id, timestamp=time.time(), data=info))
        self._static_posted = True

    def _device_param_view(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """Project an on-device stats snapshot into the ``parameters``
        record shape the UI's histogram/norm panes consume — PER LAYER
        (the device pass reduces per layer, not per tensor), histograms
        over fixed log10(|x|) edges (``log10_abs`` marks the axis)."""
        from ..util import health as _health
        out: Dict[str, Any] = {}
        lo, hi = _health.HIST_LOG_LO, _health.HIST_LOG_HI
        for name, e in _health.layer_items(snap):
            if "param_norm" not in e:
                continue
            entry: Dict[str, Any] = {
                "norm": e["param_norm"],
                "update": {"norm": e.get("update_norm")},
                "update_ratio": e.get("update_ratio"),
            }
            if "param_hist" in e:
                entry["histogram"] = {"counts": e["param_hist"],
                                      "min": lo, "max": hi,
                                      "log10_abs": True}
                entry["update"]["histogram"] = {
                    "counts": e.get("update_hist"),
                    "min": lo, "max": hi, "log10_abs": True}
            for k in ("act_mean", "act_std", "act_zero_frac"):
                if k in e:
                    entry[k] = e[k]
            out[name] = entry
        return out

    def _param_stats(self, model, histograms: bool = True) -> Dict[str, Any]:
        """Per-parameter norms (and, when ``histograms``, numpy
        histograms), plus the same for the last inter-snapshot UPDATE
        (param delta — the reference's 'updates' view; the raw gradient
        is gone once the step returns, so the applied update is the
        observable quantity). This is the legacy
        HOST path: it transfers every param tensor — kept as the parity
        oracle for the on-device pass; histogram binning is skipped
        unless requested. Names are the reference's key paths
        (``"['vertex']['param']"``) in sorted key order, the order its
        tree flattening visits them; arrays are f32 host copies."""
        out = {}
        prev = self._prev_params or {}
        snap: Dict[str, np.ndarray] = {}
        params = model.params
        for v in sorted(params):
            for k in sorted(params[v]):
                name = f"['{v}']['{k}']"
                # a copy: on the CPU .cpu() would alias the live tensor,
                # which the next step updates in place
                arr = params[v][k].detach().to(
                    "cpu", torch.float32, copy=True).numpy().ravel()
                snap[name] = arr
                entry = {
                    "norm": float(np.linalg.norm(arr)),
                    "mean": float(arr.mean()),
                    "std": float(arr.std()),
                }
                if histograms:
                    entry["histogram"] = _histogram(arr)
                if name in prev and prev[name].shape == arr.shape:
                    upd = arr - prev[name]
                    entry["update"] = {
                        "norm": float(np.linalg.norm(upd)),
                        "mean": float(upd.mean()),
                        "std": float(upd.std()),
                    }
                    if histograms:
                        entry["update"]["histogram"] = _histogram(upd)
                    # ratio of update magnitude to param magnitude — the
                    # at-a-glance learning-rate health indicator
                    pn = float(np.linalg.norm(arr))
                    entry["update_ratio"] = (float(np.linalg.norm(upd) / pn)
                                             if pn > 0 else 0.0)
                out[name] = entry
        self._prev_params = snap
        return out
