"""Training-health telemetry: per-layer stats reduced on the device inside
the training step, a health-rules engine, and NaN layer-of-origin
attribution (counterpart of the JAX package's ``util/health.py``).

- :func:`model_stats` — the per-layer stats tree the stats-enabled
  training step produces beside its update: param/grad/update L2 norms,
  update:param ratio, activation mean/std and zero fraction, per-layer
  non-finite gradient counts, and fixed-edge log10 histograms
  (``HIST_LEN`` = 18 buckets, NaN/inf in the overflow bucket). Every
  reduction runs on the device the parameters live on, over the f32
  master tensors, in plain PyTorch: foreach norms summed per layer, one
  flatten per tree, a cumulative count for the non-finite gradients, and
  one sort of the flattened ``18·layer + bucket`` keys per tree, searched
  for each key's start (the reference sums 18 masked reductions per leaf;
  the counts are the same).
  Nothing in it reads a value back to the host.
- :class:`DeviceStats` — the tree stays on the device until a consumer
  reads ``.value()``, which copies it to the host once (counted in
  ``training_host_syncs_total``). The step loss rides inside, so a
  listener window costs exactly one sync, score included.
- :class:`HealthEngine` + :func:`default_rules` — the reference's rules,
  gauges and ``health_state`` flight events, unchanged (host code).
- :func:`attribute_nonfinite` — the NaN layer-of-origin protocol: inputs,
  then parameters in forward order, then activations in forward order,
  then gradients in backward order (closest to the loss first).
- :func:`debug_payload` — the ``GET /debug/health`` body.

Bucket edges: an element x falls in bucket ``#{j : 10**j <= |x|}`` for
j = -12..4 (``torch.bucketize`` over the f32 edges), which is the
reference's ``floor(log10|x|) + 13`` clipped to [0, 17]; the two can part
only for an element within an f32 rounding of an edge.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import math
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import flightrecorder as _flight
from . import metrics as _metrics

logger = logging.getLogger("deeplearning4j_tpu_torch")

Tree = Any

# The model-wide entry in a stats pytree (total grad norm, non-finite
# count, the step loss). Layer keys never collide with it: both runtimes
# name layers "layer_N" / by vertex name.
MODEL_KEY = "_model_"

OK, WARN, CRITICAL = "ok", "warn", "critical"
HEALTH_STATE_VALUES = {OK: 0.0, WARN: 1.0, CRITICAL: 2.0}
_SEVERITY = {OK: 0, WARN: 1, CRITICAL: 2}

# Fixed log10(|x|) bucket edges: [-12, 4] in 16 buckets, plus an
# underflow bucket (zeros and |x| < 1e-12) and an overflow bucket
# (|x| > 1e4 and non-finite values). Fixed edges — unlike numpy's
# data-dependent min/max — make the histogram a pure reduction with a
# static shape.
HIST_LOG_LO = -12.0
HIST_LOG_HI = 4.0
HIST_LOG_BUCKETS = 16
HIST_LEN = HIST_LOG_BUCKETS + 2


def histogram_edges() -> np.ndarray:
    """The log10 bucket edges (host-side; for rendering/labels)."""
    return np.linspace(HIST_LOG_LO, HIST_LOG_HI, HIST_LOG_BUCKETS + 1)


# ----------------------------------------------------------------------
# device reductions (inside the training step)
# ----------------------------------------------------------------------

# |x| thresholds 10^-12 .. 10^4 as f32, one tensor per device
_EDGE_VALUES = [10.0 ** j for j in range(int(HIST_LOG_LO),
                                         int(HIST_LOG_HI) + 1)]


@functools.lru_cache(maxsize=8)
def _edges(device: torch.device) -> torch.Tensor:
    return torch.tensor(_EDGE_VALUES, dtype=torch.float32, device=device)


def _bucket_index(flat: torch.Tensor) -> torch.Tensor:
    """int32 bucket of every element of a flat f32 tensor: 0 for zeros
    and |x| < 1e-12, HIST_LEN-1 for |x| >= 1e4 and non-finite values."""
    idx = torch.bucketize(flat.abs(), _edges(flat.device), right=True,
                          out_int32=True)
    return torch.where(torch.isfinite(flat), idx, HIST_LEN - 1)


def _count_keys(keys: torch.Tensor, n: int) -> torch.Tensor:
    """int64[n]: how many of ``keys`` (integers in [0, n)) equal each
    value — sorted, then searched for where each value starts. Nothing is
    read back to the host (``bincount`` reads the keys' maximum), and no
    counter serializes (``histc`` funnels every element into a few
    atomically added bins)."""
    ordered = torch.sort(keys).values
    starts = torch.searchsorted(
        ordered, torch.arange(n + 1, dtype=keys.dtype, device=keys.device))
    return torch.diff(starts)


def log_histogram(x: torch.Tensor) -> torch.Tensor:
    """int64[HIST_LEN] counts of |x| over the fixed log10 edges (bucket 0
    = zeros/underflow; bucket HIST_LEN-1 = overflow and non-finite)."""
    flat = x.detach().reshape(-1).to(torch.float32)
    return _count_keys(_bucket_index(flat), HIST_LEN)


def act_moments(a: torch.Tensor, sample: int = 0):
    """(Σx, √Σx², number of non-zero elements, n) of one activation,
    gradient-detached, over the first ``sample`` batch rows when
    ``sample`` > 0 — the inputs of the reference's ``act_summary`` (mean,
    two-moment std, zero fraction), three f32 reductions read straight
    from the activation's own dtype. :func:`model_stats` forms the
    moments of every vertex at once."""
    af = a.detach()
    if sample and af.ndim >= 1 and af.shape[0] > sample:
        af = af[:sample]
    f32 = torch.float32
    return (af.sum(dtype=f32), torch.linalg.vector_norm(af, dtype=f32),
            torch.linalg.vector_norm(af, ord=0, dtype=f32), af.numel())


@dataclasses.dataclass(frozen=True)
class StatsConfig:
    """What the stats-enabled training step collects. ``act_sample``
    bounds the batch rows the activation moments reduce over (0 = all
    rows). ``trace_key`` names the collection set (the reference keys its
    compiled step by it)."""

    histograms: bool = True
    activations: bool = True
    act_sample: int = 64

    def trace_key(self) -> str:
        return (f"h{int(self.histograms)}a{int(self.activations)}"
                f"s{int(self.act_sample)}")

    @staticmethod
    def coerce(value) -> Optional["StatsConfig"]:
        if value is None or value is False:
            return None
        if value is True:
            return StatsConfig()
        if isinstance(value, StatsConfig):
            return value
        raise TypeError(
            f"health stats config must be True/False/None/StatsConfig, "
            f"got {type(value).__name__}")



@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where each float leaf of a layer-keyed tree sits, for one network
    shape on one device (cached: the step reuses it; ``hist_base`` holds
    one int32 per parameter element)."""
    names: Tuple[str, ...]            # layers with float parameters
    keys: Tuple[Tuple[str, str], ...]  # (layer, param) per leaf, in order
    leaf_layer: torch.Tensor          # int64[n_leaves]
    layer_ends: torch.Tensor          # int64[n_layers]: end offsets
    # HIST_LEN · (layer of each element of a flattened tree), int32
    hist_base: torch.Tensor


@functools.lru_cache(maxsize=8)
def _layout(signature: Tuple[Tuple[str, Tuple[Tuple[str, int], ...]], ...],
            device: torch.device) -> _Layout:
    names = tuple(n for n, leaves in signature if leaves)
    keys, leaf_layer, numel = [], [], []
    for li, (n, leaves) in enumerate((n, l) for n, l in signature if l):
        keys.extend((n, k) for k, _ in leaves)
        leaf_layer.extend([li] * len(leaves))
        numel.append(sum(size for _, size in leaves))
    numel_t = torch.tensor(numel, dtype=torch.int64, device=device)
    return _Layout(
        names=names, keys=tuple(keys),
        leaf_layer=torch.tensor(leaf_layer, dtype=torch.int64,
                                device=device),
        layer_ends=torch.cumsum(numel_t, 0),
        hist_base=torch.repeat_interleave(
            torch.arange(0, HIST_LEN * len(names), HIST_LEN,
                         dtype=torch.int32, device=device),
            numel_t, output_size=int(sum(numel))))


@functools.lru_cache(maxsize=8)
def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _float_leaves(layer: Dict[str, Any]) -> List[Tuple[str, int]]:
    return [(k, t.numel()) for k, t in layer.items()
            if torch.is_tensor(t) and t.is_floating_point()]


def _layer_l2(leaves: List[torch.Tensor], lay: _Layout) -> torch.Tensor:
    """f32[n_layers]: the L2 norm over each layer's leaves (foreach norms,
    summed in square per layer)."""
    norms = torch.stack(torch._foreach_norm(leaves))
    sq = torch.zeros(len(lay.names), dtype=torch.float32,
                     device=norms.device)
    return sq.index_add_(0, lay.leaf_layer, norms * norms).sqrt_()


def _layer_counts(flags: torch.Tensor, lay: _Layout) -> torch.Tensor:
    """int64[n_layers]: the true ``flags`` of each layer's segment of a
    flattened tree (one cumulative sum, read at the layer ends)."""
    csum = torch.cumsum(flags, 0, dtype=torch.int64)
    at_ends = csum.index_select(0, lay.layer_ends - 1)
    return torch.diff(at_ends, prepend=at_ends.new_zeros(1))


def _layer_histograms(leaves: List[torch.Tensor], lay: _Layout
                      ) -> torch.Tensor:
    """int64[n_layers, HIST_LEN]: the log10 histogram of each layer (one
    flatten, one bucket pass, one count of the layer·bucket keys)."""
    idx = _bucket_index(torch.cat([t.reshape(-1) for t in leaves]))
    n = len(lay.names)
    return _count_keys(lay.hist_base + idx, n * HIST_LEN).view(n, HIST_LEN)


def model_stats(params: Dict[str, Tree], grads: Dict[str, Tree],
                deltas: Dict[str, Tree],
                act_stats: Optional[Dict[str, tuple]],
                config: StatsConfig, *, loss=None) -> Dict[str, Dict]:
    """The per-layer stats tree, on the parameters' device.

    ``params``/``grads``/``deltas`` are ``{vertex: {param: tensor}}``
    (params after the update — what a checkpoint would hold; grads raw,
    before normalization — what the health rules must see; deltas the
    applied update); ``act_stats`` maps vertex → :func:`act_moments`.
    Leaves are 0-d (and [HIST_LEN]) views of a few packed tensors, so the
    tree is a few KB however wide the model is."""
    signature = tuple((n, tuple(_float_leaves(params[n]))) for n in params)
    device = next((t.device for layer in params.values()
                   for t in layer.values() if torch.is_tensor(t)),
                  torch.device("cpu"))
    lay = _layout(signature, device)
    out: Dict[str, Dict] = {}
    per_layer: Dict[str, Dict[str, torch.Tensor]] = {}
    g_leaves = [grads[n][k].detach().to(torch.float32) for n, k in lay.keys]
    if lay.names:
        p_leaves = [params[n][k].detach().to(torch.float32)
                    for n, k in lay.keys]
        d_leaves = [deltas[n][k].detach().to(torch.float32)
                    for n, k in lay.keys]
        pn = _layer_l2(p_leaves, lay)
        gn = _layer_l2(g_leaves, lay)
        un = _layer_l2(d_leaves, lay)
        ratio = un / torch.clamp(pn, min=1e-12)
        flat_g = torch.cat([g.reshape(-1) for g in g_leaves])
        nf = _layer_counts(torch.isfinite(flat_g).logical_not_(), lay)
        del flat_g
        hists = {}
        if config.histograms:
            hists = {"param_hist": _layer_histograms(p_leaves, lay),
                     "update_hist": _layer_histograms(d_leaves, lay)}
        for i, n in enumerate(lay.names):
            entry = dict(param_norm=pn[i], grad_norm=gn[i],
                         update_norm=un[i], update_ratio=ratio[i],
                         grad_nonfinite=nf[i])
            for field, h in hists.items():
                entry[field] = h[i]
            per_layer[n] = entry
        total_g = torch.linalg.vector_norm(gn)
        total_nf = nf.sum()
    else:
        total_g = torch.zeros((), dtype=torch.float32, device=device)
        total_nf = torch.zeros((), dtype=torch.int64, device=device)
    acts: Dict[str, Dict[str, torch.Tensor]] = {}
    if act_stats and config.activations:
        anames = list(act_stats)
        n = _const(tuple(float(max(act_stats[a][3], 1)) for a in anames),
                   device)
        total, norm, nonzero = (torch.stack([act_stats[a][j]
                                             for a in anames])
                                for j in range(3))
        mean, m2, nonzero = total / n, norm * norm / n, nonzero / n
        std = torch.sqrt(torch.clamp(m2 - mean * mean, min=0.0))
        zero = 1.0 - nonzero
        for i, n in enumerate(anames):
            acts[n] = {"act_mean": mean[i], "act_std": std[i],
                       "act_zero_frac": zero[i]}
    for name in params:
        entry = dict(per_layer.get(name, {}))
        entry.update(acts.get(name, {}))
        if entry:
            out[name] = entry
    model_entry: Dict[str, Any] = {"grad_norm": total_g,
                                   "grad_nonfinite": total_nf}
    if loss is not None:
        model_entry["loss"] = loss.detach().to(torch.float32)
    out[MODEL_KEY] = model_entry
    return out


# ----------------------------------------------------------------------
# host-side consumption
# ----------------------------------------------------------------------

def to_jsonable(tree):
    """Host snapshot → plain python (floats/ints/lists), JSON-ready."""
    if isinstance(tree, dict):
        return {k: to_jsonable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jsonable(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return tree.item() if tree.ndim == 0 else tree.tolist()
    if isinstance(tree, (np.floating, np.integer, np.bool_)):
        return tree.item()
    if hasattr(tree, "shape"):      # a stray device array
        arr = np.asarray(tree)
        return arr.item() if arr.ndim == 0 else arr.tolist()
    return tree



def _tensor_leaves(tree, out: List[torch.Tensor]) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _tensor_leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensor_leaves(v, out)
    elif torch.is_tensor(tree):
        out.append(tree)


def _rebuild(tree, host: Dict[int, Any]):
    if isinstance(tree, dict):
        return {k: _rebuild(v, host) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, host) for v in tree]
    if torch.is_tensor(tree):
        return host[id(tree)]
    return to_jsonable(tree)


def tree_to_host(tree) -> Dict:
    """A stats tree → plain python, in one transfer per dtype kind (the
    float leaves in one packed copy, the integer counts in another): the
    first copy waits for the device, the second finds it done."""
    leaves: List[torch.Tensor] = []
    _tensor_leaves(tree, leaves)
    host: Dict[int, Any] = {}
    for kind in (True, False):
        group = [t for t in leaves if t.is_floating_point() is kind]
        if not group:
            continue
        dtype = torch.float64 if kind else torch.int64
        packed = torch.cat([t.reshape(-1) for t in group]).to(dtype).cpu()
        ofs = 0
        for t in group:
            n = t.numel()
            vals = packed[ofs:ofs + n].tolist()
            host[id(t)] = vals[0] if t.ndim == 0 else vals
            ofs += n
    return _rebuild(tree, host)


class DeviceStats:
    """A stats tree that stays on the device until read. ``value()``
    performs the single device→host transfer — counted into
    ``training_host_syncs_total`` — and caches the JSON-ready result, so
    a listener window costs exactly one sync however many consumers read
    the same snapshot."""

    __slots__ = ("_tree", "_host", "iteration", "model", "_registry")

    def __init__(self, tree: Tree, *, iteration: int = 0,
                 model: str = "net", registry=None):
        self._tree = tree
        self._host: Optional[Dict] = None
        self.iteration = int(iteration)
        self.model = model
        self._registry = registry

    @property
    def resolved(self) -> bool:
        return self._host is not None

    def value(self) -> Dict[str, Dict]:
        if self._host is None:
            from ..optimize.listeners import sync_counter
            sync_counter(self._registry).inc()
            tree, self._tree = self._tree, None
            self._host = tree_to_host(tree)
        return self._host

    def __repr__(self) -> str:
        return (f"DeviceStats(iteration={self.iteration}, "
                f"{'resolved' if self.resolved else '<on device>'})")


def latest_stats(net) -> Optional[DeviceStats]:
    """The most recent :class:`DeviceStats` a stats-enabled train step
    stored on the net (None when stats are off or nothing ran yet)."""
    return getattr(net, "_last_health_stats", None)


def layer_items(stats: Dict[str, Dict]):
    """(layer, entry) pairs excluding the model-wide entry, in depth
    order (dict insertion order = the runtimes' layer order)."""
    return [(k, v) for k, v in stats.items() if k != MODEL_KEY]


# ----------------------------------------------------------------------
# health rules
# ----------------------------------------------------------------------

class HealthSample(NamedTuple):
    """What a rule sees: the host stats snapshot, the iteration it was
    collected at, and the recent loss history (oldest first)."""
    stats: Dict[str, Dict]
    iteration: int
    losses: Tuple[float, ...]


class Verdict(NamedTuple):
    layer: str
    state: str
    detail: str


class HealthRule:
    """One diagnosis. ``evaluate`` returns a verdict per layer it judged
    (OK verdicts included, so the engine can record recoveries); an empty
    list means the rule had nothing to judge this sample."""

    name = "rule"

    def evaluate(self, sample: HealthSample) -> List[Verdict]:
        raise NotImplementedError


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


class UpdateRatioRule(HealthRule):
    """update:param L2 ratio per layer. The classic LR-health band is
    ~[1e-4, 1e-2] (DL4J's visualization guide); outside it the layer is
    either frozen (too low) or thrashing (too high). Warmup iterations
    are skipped — the first Adam steps legitimately overshoot the band
    while the moment estimates bootstrap."""

    name = "update_ratio"

    def __init__(self, lo: float = 1e-4, hi: float = 1e-2,
                 critical_factor: float = 10.0, warmup: int = 10):
        self.lo, self.hi = float(lo), float(hi)
        self.critical_factor = float(critical_factor)
        self.warmup = int(warmup)

    def evaluate(self, sample: HealthSample) -> List[Verdict]:
        if sample.iteration < self.warmup:
            return []
        out = []
        for layer, e in layer_items(sample.stats):
            r, pn = e.get("update_ratio"), e.get("param_norm")
            if r is None or not pn:
                continue
            if not _finite(r) or r > self.hi * self.critical_factor:
                out.append(Verdict(layer, CRITICAL,
                                   f"update:param ratio {r:.3e} far above "
                                   f"the healthy band [{self.lo:g}, "
                                   f"{self.hi:g}]"))
            elif r < self.lo / self.critical_factor:
                out.append(Verdict(layer, WARN,
                                   f"update:param ratio {r:.3e} ~zero — "
                                   "layer effectively frozen"))
            elif r < self.lo or r > self.hi:
                out.append(Verdict(layer, WARN,
                                   f"update:param ratio {r:.3e} outside "
                                   f"[{self.lo:g}, {self.hi:g}]"))
            else:
                out.append(Verdict(layer, OK, ""))
        return out


class ExplodingGradientsRule(HealthRule):
    """Absolute per-layer gradient-norm blowup (an exploding run crosses
    these within a few steps; the depth RATIO is the vanishing rule's
    job)."""

    name = "exploding_gradients"

    def __init__(self, warn_norm: float = 1e3, critical_norm: float = 1e6):
        self.warn_norm = float(warn_norm)
        self.critical_norm = float(critical_norm)

    def evaluate(self, sample: HealthSample) -> List[Verdict]:
        out = []
        for layer, e in layer_items(sample.stats):
            gn = e.get("grad_norm")
            if gn is None:
                continue
            if not _finite(gn) or gn > self.critical_norm:
                out.append(Verdict(layer, CRITICAL,
                                   f"gradient norm {gn:.3e} exploding"))
            elif gn > self.warn_norm:
                out.append(Verdict(layer, WARN,
                                   f"gradient norm {gn:.3e} > "
                                   f"{self.warn_norm:g}"))
            else:
                out.append(Verdict(layer, OK, ""))
        return out


class VanishingGradientsRule(HealthRule):
    """Gradient attenuation ACROSS DEPTH: the ratio of the first param
    layer's grad norm to the last's. A healthy deep net keeps it within
    a few orders of magnitude; 1e-6 means the early layers see no
    learning signal."""

    name = "vanishing_gradients"

    def __init__(self, warn_ratio: float = 1e-6,
                 critical_ratio: float = 1e-9):
        self.warn_ratio = float(warn_ratio)
        self.critical_ratio = float(critical_ratio)

    def evaluate(self, sample: HealthSample) -> List[Verdict]:
        layered = [(k, e) for k, e in layer_items(sample.stats)
                   if _finite(e.get("grad_norm"))]
        if len(layered) < 2:
            return []
        first_layer, first = layered[0]
        last = layered[-1][1]
        if not last["grad_norm"]:
            return []
        ratio = first["grad_norm"] / last["grad_norm"]
        if ratio < self.critical_ratio:
            state, detail = CRITICAL, (
                f"first/last grad-norm ratio {ratio:.3e} — early layers "
                "receive no gradient")
        elif ratio < self.warn_ratio:
            state, detail = WARN, (
                f"first/last grad-norm ratio {ratio:.3e} < "
                f"{self.warn_ratio:g}")
        else:
            state, detail = OK, ""
        return [Verdict(first_layer, state, detail)]


class DeadUnitsRule(HealthRule):
    """Dead-unit (zero-activation) fraction per layer — the dead-ReLU
    detector. Judged only on layers that carried activation stats."""

    name = "dead_units"

    def __init__(self, warn_frac: float = 0.9, critical_frac: float = 0.99):
        self.warn_frac = float(warn_frac)
        self.critical_frac = float(critical_frac)

    def evaluate(self, sample: HealthSample) -> List[Verdict]:
        out = []
        for layer, e in layer_items(sample.stats):
            zf = e.get("act_zero_frac")
            if zf is None:
                continue
            if zf >= self.critical_frac:
                out.append(Verdict(layer, CRITICAL,
                                   f"{zf:.1%} of activations are exactly "
                                   "zero — layer is dead"))
            elif zf >= self.warn_frac:
                out.append(Verdict(layer, WARN,
                                   f"{zf:.1%} of activations are exactly "
                                   "zero"))
            else:
                out.append(Verdict(layer, OK, ""))
        return out


class NonFiniteGradientsRule(HealthRule):
    """Any non-finite gradient element is CRITICAL on its layer — the
    stats-plane twin of the NonFiniteGuard skip path."""

    name = "nonfinite_grads"

    def evaluate(self, sample: HealthSample) -> List[Verdict]:
        out = []
        for layer, e in layer_items(sample.stats):
            n = e.get("grad_nonfinite")
            if n is None:
                continue
            if n:
                out.append(Verdict(layer, CRITICAL,
                                   f"{int(n)} non-finite gradient "
                                   "elements"))
            else:
                out.append(Verdict(layer, OK, ""))
        return out


class LossDivergenceRule(HealthRule):
    """Loss-trend divergence over the engine's loss window: a non-finite
    loss is CRITICAL; a sustained rise (median of the newest samples vs
    the oldest) is WARN/CRITICAL by factor."""

    name = "loss_divergence"

    def __init__(self, window: int = 6, warn_factor: float = 4.0,
                 critical_factor: float = 100.0):
        self.window = int(window)
        self.warn_factor = float(warn_factor)
        self.critical_factor = float(critical_factor)

    def evaluate(self, sample: HealthSample) -> List[Verdict]:
        losses = sample.losses
        if not losses:
            return []
        if not math.isfinite(losses[-1]):
            return [Verdict(MODEL_KEY, CRITICAL,
                            f"loss is non-finite ({losses[-1]})")]
        if len(losses) < self.window:
            return [Verdict(MODEL_KEY, OK, "")]
        head = sorted(losses[:3])[1]    # median of oldest 3
        tail = sorted(losses[-3:])[1]   # median of newest 3
        if head > 0 and tail > head * self.critical_factor:
            return [Verdict(MODEL_KEY, CRITICAL,
                            f"loss rose {tail / head:.1f}x over the "
                            f"window ({head:.3e} -> {tail:.3e})")]
        if head > 0 and tail > head * self.warn_factor:
            return [Verdict(MODEL_KEY, WARN,
                            f"loss rose {tail / head:.1f}x over the "
                            f"window ({head:.3e} -> {tail:.3e})")]
        return [Verdict(MODEL_KEY, OK, "")]


def default_rules() -> List[HealthRule]:
    return [UpdateRatioRule(), ExplodingGradientsRule(),
            VanishingGradientsRule(), DeadUnitsRule(),
            NonFiniteGradientsRule(), LossDivergenceRule()]


# the stat fields mirrored into /metrics gauges (model_stats_* families)
_STAT_GAUGE_FIELDS = ("param_norm", "grad_norm", "update_ratio",
                      "act_zero_frac")


class HealthEngine:
    """Evaluates rules over stats snapshots; publishes gauges + flight
    events; keeps the latest report for ``GET /debug/health``.

    State machine: per (rule, layer), any change of verdict state records
    a ``health_state`` flight event (ok→warn escalations AND recoveries),
    so a post-mortem flight dump shows when each diagnosis flipped.
    """

    def __init__(self, rules: Optional[Sequence[HealthRule]] = None, *,
                 model: str = "net", registry=None, loss_window: int = 16,
                 publish_stats_gauges: bool = True):
        reg = registry if registry is not None else _metrics.REGISTRY
        self.model = model
        self.rules = list(rules) if rules is not None else default_rules()
        self._state_gauge = reg.gauge(
            "training_health_state",
            "Health-rule verdict per rule and layer (0=ok, 1=warn, "
            "2=critical); layer label cardinality is bounded by model "
            "depth", ("model", "rule", "layer"))
        self._stat_gauges = None
        if publish_stats_gauges:
            self._stat_gauges = {
                "param_norm": reg.gauge(
                    "model_stats_param_norm",
                    "Per-layer parameter L2 norm from the on-device "
                    "stats pass", ("model", "layer")),
                "grad_norm": reg.gauge(
                    "model_stats_grad_norm",
                    "Per-layer raw-gradient L2 norm from the on-device "
                    "stats pass", ("model", "layer")),
                "update_ratio": reg.gauge(
                    "model_stats_update_ratio",
                    "Per-layer update:param L2 ratio from the on-device "
                    "stats pass", ("model", "layer")),
                "act_zero_frac": reg.gauge(
                    "model_stats_act_zero_frac",
                    "Per-layer zero-activation fraction (dead units) "
                    "from the on-device stats pass", ("model", "layer")),
            }
        self._losses: collections.deque = collections.deque(
            maxlen=max(2, int(loss_window)))
        self._states: Dict[Tuple[str, str], str] = {}
        self.last_report: Optional[Dict] = None

    def observe(self, stats: Dict[str, Dict], *,
                iteration: int = 0) -> Dict:
        """Feed one host snapshot (``DeviceStats.value()`` output).
        Returns the rule report and remembers it for /debug/health."""
        model_entry = stats.get(MODEL_KEY) or {}
        loss = model_entry.get("loss")
        if loss is not None:
            self._losses.append(float(loss))
        sample = HealthSample(stats=stats, iteration=int(iteration),
                              losses=tuple(self._losses))
        report_rules: Dict[str, Dict] = {}
        worst_overall = OK
        for rule in self.rules:
            try:
                verdicts = rule.evaluate(sample)
            except Exception:
                logger.exception("health rule %s failed", rule.name)
                continue
            if not verdicts:
                continue
            worst = OK
            flagged: Dict[str, Dict] = {}
            for v in verdicts:
                self._state_gauge.set(HEALTH_STATE_VALUES[v.state],
                                      model=self.model, rule=rule.name,
                                      layer=v.layer)
                key = (rule.name, v.layer)
                prev = self._states.get(key, OK)
                if v.state != prev:
                    _flight.record(
                        "health_state", model=self.model, rule=rule.name,
                        layer=v.layer, from_state=prev, to_state=v.state,
                        detail=v.detail, iteration=int(iteration))
                    if _SEVERITY[v.state] > _SEVERITY[prev]:
                        logger.warning(
                            "health rule %s %s on %s/%s: %s", rule.name,
                            v.state.upper(), self.model, v.layer, v.detail)
                self._states[key] = v.state
                if _SEVERITY[v.state] > _SEVERITY[worst]:
                    worst = v.state
                if v.state != OK:
                    flagged[v.layer] = {"state": v.state,
                                        "detail": v.detail}
            report_rules[rule.name] = {
                "state": worst, "layers": flagged,
                "evaluated": len(verdicts)}
            if _SEVERITY[worst] > _SEVERITY[worst_overall]:
                worst_overall = worst
        if self._stat_gauges is not None:
            for layer, e in layer_items(stats):
                for field, gauge in self._stat_gauges.items():
                    v = e.get(field)
                    if v is not None and _finite(v):
                        gauge.set(v, model=self.model, layer=layer)
        report = {"model": self.model, "iteration": int(iteration),
                  "state": worst_overall, "rules": report_rules,
                  "t": time.time()}
        self.last_report = report
        _remember_report(report, stats)
        return report


class HealthListener:
    """Training listener consuming the on-device stats every ``frequency``
    iterations: ONE host sync per window (the snapshot carries the loss,
    so the LazyScore is never read). Enables the stats pass on the model
    at attach time unless ``enable=False`` (then it only consumes stats
    someone else enabled). Duck-typed against the TrainingListener
    contract, like every listener the fit loop fires."""

    def __init__(self, frequency: int = 10,
                 engine: Optional[HealthEngine] = None,
                 model: str = "net", registry=None, config=True,
                 enable: bool = True):
        self.frequency = max(1, int(frequency))
        self.engine = (engine if engine is not None
                       else HealthEngine(model=model, registry=registry))
        self._config = StatsConfig.coerce(config) or StatsConfig()
        self._enable = enable
        self._last_observed = 0    # iteration of the last observed snapshot

    def _ensure_enabled(self, model) -> None:
        if (self._enable and getattr(model, "health_stats", None) is None
                and hasattr(model, "enable_health_stats")):
            model.enable_health_stats(self._config)

    def on_epoch_start(self, model, epoch: int) -> None:
        self._ensure_enabled(model)

    def on_epoch_end(self, model, epoch: int) -> None:
        pass

    def on_step_skipped(self, model, iteration, reason, info=None) -> None:
        pass

    def iteration_done(self, model, iteration: int, score) -> None:
        self._ensure_enabled(model)
        ds = latest_stats(model)
        # only observe a snapshot THIS iteration's dispatch produced:
        # fit_scan/fit_repeated fire listeners for window-interior
        # iterations whose snapshot belongs to the window's LAST step,
        # and a model whose stats stopped (disable, or a step variant
        # without them) would otherwise republish the frozen snapshot as
        # live data — same staleness guard as StatsListener's device path
        if ds is None or ds.iteration != iteration:
            return
        # cadence: exact frequency multiples on the per-step path, and
        # "at least frequency iterations since the last observation" so
        # scanned windows whose final iterations never align with the
        # frequency (k=16 @ frequency=10 → finals 16, 32, ...) still get
        # judged about every `frequency` iterations instead of only at
        # lcm(frequency, k)
        if (iteration % self.frequency
                and iteration - self._last_observed < self.frequency):
            return
        self._last_observed = iteration
        self.engine.observe(ds.value(), iteration=iteration)


# ----------------------------------------------------------------------
# NaN layer-of-origin attribution
# ----------------------------------------------------------------------

@dataclasses.dataclass
class AttributionReport:
    """Which layer a non-finite step originated at, and in what quantity
    (``input`` → ``param`` → ``activation`` → ``gradient`` — the order
    the protocol checks them in)."""

    model: str
    iteration: int
    quantity: str                       # input|param|activation|gradient|unknown
    layer: Optional[str] = None
    param: Optional[str] = None
    detail: str = ""

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        if self.layer is None:
            return f"first non-finite quantity: {self.quantity}"
        p = f".{self.param}" if self.param else ""
        return f"first non-finite {self.quantity} at {self.layer}{p}"


def _all_finite(a) -> bool:
    if torch.is_tensor(a):
        return (not a.is_floating_point()
                or bool(torch.isfinite(a.detach()).all()))
    arr = np.asarray(a)
    if not np.issubdtype(arr.dtype, np.floating) \
            and not np.issubdtype(arr.dtype, np.complexfloating):
        return True
    return bool(np.isfinite(arr).all())


def _first_bad_param(tree) -> Optional[str]:
    if not isinstance(tree, dict):
        return None if _all_finite(tree) else ""
    for pname, leaf in tree.items():
        if hasattr(leaf, "dtype") and not _all_finite(leaf):
            return pname
    return None


def attribute_nonfinite(net, x, y=None, mask=None, *, params=None,
                        model: Optional[str] = None, iteration: int = 0,
                        record: bool = True) -> AttributionReport:
    """Replay a failing batch through per-layer finite checks and name the
    first offending layer/param (the reference's protocol; each stage
    runs only if the previous found nothing):

    1. **inputs** — a poisoned batch is the most common culprit;
    2. **params**, forward order — a previously corrupted checkpoint;
    3. **activations**, forward order (an eval-mode forward): activation
       NaNs propagate forward, so the first non-finite output is the
       origin;
    4. **gradients**, backward order (one autograd pass of the training
       loss): gradient NaNs propagate from the loss toward the input, so
       the origin is the non-finite layer closest to the loss.

    ``params`` (``{vertex: {param: tensor or array}}``) replaces the net's
    parameters for the replay. A failure path: it runs on demand, never
    in the training loop. The report lands in the flight recorder and the
    ``/debug/health`` payload (``record=False`` to suppress)."""
    params = params if params is not None else net.params
    model = model or type(net).__name__
    order = list(net.topo_order)

    def _finish(quantity, layer=None, param=None, detail=""):
        report = AttributionReport(model=model, iteration=int(iteration),
                                   quantity=quantity, layer=layer,
                                   param=param, detail=detail)
        if record:
            _flight.record("nonfinite_attribution", model=model,
                           iteration=int(iteration), quantity=quantity,
                           layer=layer, param=param, detail=detail)
            _remember_attribution(report)
        return report

    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    for i, a in enumerate(xs):
        if a is not None and hasattr(a, "dtype") and not _all_finite(a):
            return _finish("input", detail=f"network input {i} carries "
                           "non-finite values")

    for name in order:
        bad = _first_bad_param(params.get(name) or {})
        if bad is not None:
            return _finish("param", layer=name, param=bad or None)

    def on_device(tree, grad=False):
        return {v: {k: torch.as_tensor(t, device=net.device).detach()
                    .clone().requires_grad_(grad)
                    for k, t in (tree.get(v) or {}).items()}
                for v in order}

    inputs = [net._to_input(a) for a in xs]
    # a MultiLayerNetwork takes one input and names its layers layer_{i}
    sequential = not hasattr(net.conf, "vertices")
    # eval-mode forward: a train-mode-only NaN source falls through to
    # the gradient stage
    try:
        with torch.inference_mode():
            if sequential:
                seq, _ = net._forward(inputs[0], params=on_device(params),
                                      collect=True)
                acts = dict(zip(order, seq[1:]))
            else:
                acts = net._forward(inputs, params=on_device(params))
        for name in order:
            if not _all_finite(acts[name]):
                return _finish("activation", layer=name)
    except Exception as e:
        logger.warning("attribution forward replay failed: %s", e)

    if y is not None:
        try:
            ys = [net._to_input(a) for a in
                  (y if isinstance(y, (list, tuple)) else [y])]
            ms = (None if mask is None else
                  [None if m is None else net._to_input(m) for m in
                   (mask if isinstance(mask, (list, tuple)) else [mask])])
            ptree = on_device(params, grad=True)
            named = [(v, k, t) for v, ps in ptree.items()
                     for k, t in ps.items()]
            loss = (net._loss_fn(inputs[0], ys[0],
                                 None if ms is None else ms[0],
                                 params=ptree)[0]
                    if sequential else
                    net._loss_fn(inputs, ys, ms, params=ptree))
            gs = torch.autograd.grad(loss, [t for _, _, t in named],
                                     allow_unused=True)
            grads: Dict[str, Dict[str, torch.Tensor]] = {v: {}
                                                         for v in ptree}
            for (v, k, _), g in zip(named, gs):
                if g is not None:
                    grads[v][k] = g
            for name in reversed(order):
                bad = _first_bad_param(grads.get(name) or {})
                if bad is not None:
                    return _finish("gradient", layer=name,
                                   param=bad or None)
        except Exception as e:
            logger.warning("attribution gradient replay failed: %s", e)

    return _finish("unknown", detail="replay found every checked "
                   "quantity finite (transient, or a train-mode-only "
                   "source)")


# ----------------------------------------------------------------------
# /debug/health state
# ----------------------------------------------------------------------

_debug_lock = threading.Lock()
_last_report: Optional[Dict] = None
_last_stats: Optional[Dict] = None
_last_attribution: Optional[AttributionReport] = None


def _remember_report(report: Dict, stats: Dict) -> None:
    global _last_report, _last_stats
    with _debug_lock:
        _last_report = report
        _last_stats = stats


def _remember_attribution(report: AttributionReport) -> None:
    global _last_attribution
    with _debug_lock:
        _last_attribution = report


def last_attribution() -> Optional[AttributionReport]:
    with _debug_lock:
        return _last_attribution


def reset_debug_state() -> None:
    """Test hook: forget the remembered report/stats/attribution."""
    global _last_report, _last_stats, _last_attribution
    with _debug_lock:
        _last_report = _last_stats = _last_attribution = None


def debug_payload() -> Dict:
    """The ``GET /debug/health`` body: latest rule report, latest stats
    snapshot, latest NaN attribution (each None until produced)."""
    with _debug_lock:
        return {
            "report": _last_report,
            "stats": _last_stats,
            "attribution": (_last_attribution.to_dict()
                            if _last_attribution is not None else None),
            "histogram_log10_edges": histogram_edges().tolist(),
        }
