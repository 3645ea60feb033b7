"""Training cells (traffic kind ``fit``): ``ComputationGraph.fit`` over a
``DataSetIterator`` of seeded batches, staged by the program's own stager.

Set-up builds the net with the benchmark's weights and drives it through
its first three steps by the window's own call and feed (``fit`` over the
same iterator), reading the logits the first step scored, each step's
loss, the first gradient as the updater holds it and the change of every
parameter after each step. The same net then trains through the window,
which ends with a synchronise; a ``--trace 1`` run profiles a few more
steps after it, so the window's own numbers are the untraced run's. Once
the program is freed, the plain reference follows the first three steps
from the same weights and batches, and the readings are compared
(:func:`compare`).
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

from reference import optim, precision

from . import common, trace as _trace, traffic as _traffic

CHECK_STEPS = 3
# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone and is left out of the comparison
STILL_LEAF = 1e-3


class WindowIterator(DataSetIterator):
    """Batches ``start``, ``start + 1``, … of ``batches``: ``count`` of
    them, or as many as are asked for before ``until`` (host clock)."""

    def __init__(self, batches, start: int, count: Optional[int] = None):
        self.batches = batches
        self.start = self.next_index = start
        self.count = count
        self.until: Optional[float] = None
        self.times: List[float] = []

    def has_next(self) -> bool:
        if self.count is not None:
            return self.next_index < self.start + self.count
        return time.perf_counter() < self.until

    def next(self) -> DataSet:
        self.times.append(time.perf_counter())
        x, y = self.batches(self.next_index)
        self.next_index += 1
        return DataSet(x, y)

    def reset(self) -> None:
        self.next_index = self.start

    @property
    def served(self) -> int:
        return self.next_index - self.start


class ProfileSteps:
    """A listener that profiles ``count`` steps after the first ``lead``
    it sees with the device alone, then ``count`` more with the host's ops
    too, each end of a profile after a synchronise."""

    def __init__(self, lead: int, count: int, device):
        self.lead, self.count, self.device = lead, count, device
        self.seen = 0
        self.profs = []
        self.window_s = 0.0

    def iteration_done(self, net, iteration, score) -> None:
        self.seen += 1
        k = self.seen - self.lead
        if k < 0 or k > 2 * self.count or k % self.count:
            return
        _sync(self.device)
        now = time.perf_counter()
        if self.profs:
            self.profs[-1].stop()
            if len(self.profs) == 1:
                self.window_s = now - self._t0
        if len(self.profs) < 2:
            self.profs.append(_trace.profiler(host=len(self.profs) == 1))
            self.profs[-1].start()
            self._t0 = time.perf_counter()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_gradient(training: dict, state) -> Dict[str, torch.Tensor]:
    """The first step's gradient, leaf by leaf (``"vertex.name"``), as the
    updater's state after one step holds it: Adam's m = (1 − β₁)·g,
    Nesterov's v = −η·g; copied to the host."""
    if training["updater"] == "adam":
        scale, tree = 1.0 - training["beta1"], state["m"]
    elif training["updater"] == "nesterovs":
        scale, tree = -training["learning_rate"], state["v"]
    else:
        raise ValueError(f"no reading of {training['updater']!r} state")
    return {f"{v}.{k}": (p.float() / scale).cpu()
            for v, ps in tree.items() for k, p in ps.items()}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t)) for k, t in tensors.items()}


def change_norms(params, start) -> Dict[str, float]:
    return {f"{v}.{k}": float(torch.linalg.vector_norm(
        p.detach().float() - start[v][k]))
        for v, ps in params.items() for k, p in ps.items()}


class ScoredLogits:
    """While installed, a host copy of what each output layer's
    ``pre_output`` returns: the logits the program's step scores."""

    def __init__(self, net):
        self.layers = [net.conf.vertices[n].layer
                       for n in net.conf.network_outputs]
        self.got: List[torch.Tensor] = []

    def __enter__(self):
        for layer in self.layers:
            scored = layer.pre_output

            def keep(*args, _scored=scored, **kwargs):
                out = _scored(*args, **kwargs)
                self.got.append(out.detach().to("cpu", copy=True))
                return out

            layer.pre_output = keep
        return self

    def __exit__(self, *exc):
        for layer in self.layers:
            del layer.pre_output


def program_readings(net, fam, cfg, shapes, seed, device, batches) -> dict:
    """The first three steps of ``net`` through ``fit``: the logits the
    first step scored (on the host), the losses, the first gradient (its
    leaves, on the host, and their norms) and each step's change norms,
    leaf by leaf. The starting weights are drawn again from the seed after
    each step, so no second copy of them stays on the device."""
    losses, first, changes = [], None, []
    for i in range(CHECK_STEPS):
        if i == 0:
            with ScoredLogits(net) as scored:
                net.fit(WindowIterator(batches, start=i, count=1))
        else:
            net.fit(WindowIterator(batches, start=i, count=1))
        losses.append(net.score())
        if i == 0:
            first = first_gradient(cfg["training"], net.updater_state)
        changes.append(change_norms(
            net.params, common.make_params(fam, cfg, shapes, seed, device)))
    (logits,) = scored.got
    return {"losses": losses, "grads": _norms(first), "first": first,
            "changes": changes, "logits": logits}


def reference_readings(fam, cfg, shapes, seed, device, batches,
                       arithmetic: str = "f32", rows: str = "all") -> dict:
    """The plain reference's readings of the same three steps from the
    same weights and batches (its first step's logits on the device);
    ``rows="half"`` plants the fault of a step that leaves out half of
    each batch and takes the mean over the rest."""
    precision.exact_f32()
    ar = precision.Arithmetic(arithmetic)
    params = common.make_params(fam, cfg, shapes, seed, device)
    start = {v: {k: p.clone() for k, p in ps.items()}
             for v, ps in params.items()}
    leaves = [(v, k, p.requires_grad_(True)) for v, ps in params.items()
              for k, p in ps.items()]
    opt = optim.make(cfg["training"])
    state = opt.init(params)
    losses, first, changes, logits = [], None, [], []
    for step in range(CHECK_STEPS):
        x, y = (torch.as_tensor(a, device=device) for a in batches(step))
        if rows == "half":
            x, y = x[:len(x) // 2], y[:len(y) // 2]
        n = len(x)
        block = fam.REFERENCE_ROWS or n
        grads = {v: {k: torch.zeros_like(p) for k, p in ps.items()}
                 for v, ps in params.items()}
        total = 0.0
        for r in range(0, n, block):
            with ar.scope():
                out = fam.logits(params, x[r:r + block], cfg, ar)
                loss = fam.summed_loss(out, y[r:r + block]) / n
                gs = torch.autograd.grad(loss, [p for _, _, p in leaves],
                                         allow_unused=True)
            if step == 0:
                logits.append(out.detach())
            del out
            for (v, k, _), g in zip(leaves, gs):
                if g is not None:
                    grads[v][k] += g
            total += float(loss.detach())
        losses.append(total)
        if step == 0:
            first = {f"{v}.{k}": g.clone() for v, gs in grads.items()
                     for k, g in gs.items()}
        opt.step(params, grads, state)
        changes.append(change_norms(params, start))
    return {"losses": losses, "grads": _norms(first), "first": first,
            "changes": changes, "logits": torch.cat(logits)}


def _logit_diff(got: torch.Tensor, ref: torch.Tensor) -> float:
    """‖got − ref‖ / ‖ref‖ over the rows both hold, two rows at a time on
    the reference's device."""
    num = den = 0.0
    for g, r in zip(got.split(2), ref.split(2)):
        g = g.to(r.device, torch.float32)
        num += float((g - r).square().sum())
        den += float(r.square().sum())
    return math.sqrt(num / den)


def compare(got: dict, ref: dict) -> Dict[str, float]:
    """The numbers a cell's limits may name: the gap of the first step's
    logits (``logit_diff``, the norm of the difference over the
    reference's norm); the largest relative gap of a step's loss; the
    worst leaf's gap between the two sides' norms of the first gradient
    (``grad_gap``) and of the change after three steps (``change_gap``;
    ``change_median_gap`` the median leaf's; ``change_gap_step1`` after
    one step); and the norm of the difference of
    the two first gradients (``grad_diff`` the worst leaf's,
    ``grad_diff_median`` the median leaf's), each over the larger of that
    leaf's and the median leaf's reference norm. Leaves whose reference
    gradient is under ``STILL_LEAF`` of the median leaf's are left out."""
    med_g = statistics.median(ref["grads"].values())
    moving = [k for k, g in ref["grads"].items() if g >= STILL_LEAF * med_g]
    diffs = [float(torch.linalg.vector_norm(
        got["first"][k].to(ref["first"][k].device) - ref["first"][k]))
        / max(ref["grads"][k], med_g) for k in moving]
    change = change_gaps(got, ref, moving)
    return {"logit_diff": _logit_diff(got["logits"], ref["logits"]),
            "loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])),
            "grad_gap": max(_gaps(got["grads"], ref["grads"], moving)),
            "change_gap": max(change[-1].values()),
            "change_gap_step1": max(change[0].values()),
            "change_median_gap": statistics.median(change[-1].values()),
            "grad_diff": max(diffs),
            "grad_diff_median": statistics.median(diffs)}


def _gaps(got: Dict[str, float], ref: Dict[str, float], moving):
    med = statistics.median(ref[k] for k in moving)
    return [abs(got[k] - ref[k]) / max(ref[k], med) for k in moving]


def change_gaps(got: dict, ref: dict, moving=None) -> List[Dict[str, float]]:
    """After each step, every moving leaf's gap between the two sides'
    change norms over the larger of its and the median leaf's reference
    change norm."""
    if moving is None:
        med_g = statistics.median(ref["grads"].values())
        moving = [k for k, g in ref["grads"].items()
                  if g >= STILL_LEAF * med_g]
    return [dict(zip(moving, _gaps(g, r, moving)))
            for g, r in zip(got["changes"], ref["changes"])]


class HostWatch:
    """What the host did over the window, for reading a spread between
    runs: the dispatching thread's CPU seconds, the collector's passes and
    pauses, and the step time over each quarter of the window's batches
    (taken when the stager asked for them, the first and last few left
    out, where its queue fills and drains)."""

    EDGE = 4

    def __init__(self):
        self.pauses: List[float] = []
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append(time.perf_counter() - self._t)

    def __enter__(self):
        gc.callbacks.append(self._gc)
        self.cpu0 = time.thread_time()
        return self

    def __exit__(self, *exc):
        self.cpu_s = time.thread_time() - self.cpu0
        gc.callbacks.remove(self._gc)

    def line(self, times: List[float], window_s: float) -> str:
        steps = len(times)
        inner = times[self.EDGE:steps - self.EDGE]
        cuts = [round(q * (len(inner) - 1) / 4) for q in range(5)]
        ms = [round(1e3 * (inner[b] - inner[a]) / (b - a), 3)
              for a, b in zip(cuts, cuts[1:]) if b > a]
        return (f"window: {steps} steps in {window_s:.3f} s; main thread "
                f"cpu {1e3 * self.cpu_s / max(steps, 1):.3f} ms a step; "
                f"collector {len(self.pauses)} passes "
                f"{sum(self.pauses):.4f} s (longest "
                f"{max(self.pauses, default=0.0):.4f} s); ms a step by "
                f"quarter {ms}")


def run(ctx) -> dict:
    cell, device, seed = ctx.cell, ctx.device, ctx.seed
    cfg, traffic = cell.config, cell.traffic
    fam = common.family(cfg)
    from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
    from deeplearning4j_tpu_torch.util import metrics as _metrics
    conf = fam.port_conf(cfg)
    shapes = common.program_shapes(conf)
    common.program_precision(cfg)
    batches = _traffic.FitBatches(traffic, cfg, seed, device)
    t0 = time.perf_counter()
    net = ComputationGraph(conf, device=device)
    net.set_params(common.make_params(fam, cfg, shapes, seed, device))
    net.init_updater()
    t1 = time.perf_counter()
    got = program_readings(net, fam, cfg, shapes, seed, device, batches)
    print(f"set-up: batches, net and weights {t1 - t0:.3f} s, the first "
          f"{CHECK_STEPS} steps {time.perf_counter() - t1:.3f} s",
          file=sys.stderr)

    window = WindowIterator(batches, start=CHECK_STEPS)
    record = ctx.record
    _sync(device)
    record.before = _metrics.REGISTRY.snapshot()
    with HostWatch() as watch:
        t0 = time.perf_counter()
        window.until = t0 + ctx.seconds
        if ctx.seconds > 0:
            net.fit(window)
        _sync(device)
        t1 = time.perf_counter()
    record.after = _metrics.REGISTRY.snapshot()
    record.window_s, record.steps = t1 - t0, window.served
    print(watch.line(window.times, t1 - t0), file=sys.stderr)
    out = {"setup_s": t0 - ctx.t_start}
    if record.steps:
        out["e2e"] = {"train_step_ms": 1e3 * record.window_s / record.steps}

    if ctx.trace:
        lead, count = int(traffic["trace_lead"]), int(traffic["trace_steps"])
        profile = ProfileSteps(lead, count, device)
        net.set_listeners(profile)
        net.fit(WindowIterator(batches, start=CHECK_STEPS + record.steps,
                               count=lead + 2 * count))
        record.trace = _trace.TraceView(
            profile.profs[0], profile.window_s, profile.count,
            profile.profs[1], threading.get_native_id())
    out["memory"] = common.device_info(device)

    del net, window
    precision.exact_f32()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(fam, cfg, shapes, seed, device, batches)
    out["readings"] = compare(got, ref)
    out["attempted"] = record.steps + CHECK_STEPS
    out["failed"] = 0 if all(np.isfinite(got["losses"])) else CHECK_STEPS
    ctx.program_readings, ctx.reference_readings = got, ref
    ctx.batches, ctx.shapes, ctx.family = batches, shapes, fam
    return out
