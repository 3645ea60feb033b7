"""The phases of a training step (``util.tracing.phase``) measured on the
card, in the shapes of one of the benchmark's training cells.

    python3 experiments/torch_fit_phases.py --mode tracer|profile
        [--root DIR] [--cell opt-125m.train.t2048] [--seed N]
        [--blocks 4] [--steps 30]

Imports the program and the benchmark's harness from the checkout
``--root`` (this one by default), builds the cell's net with weights from
the seed as the benchmark does, and feeds ``fit`` the cell's batches.

- ``tracer``: ``--blocks`` pairs of ``fit`` calls of ``--steps`` steps, one
  with ``net.tracer`` a ``Tracer`` and one without, in turns (A B B A ...);
  the milliseconds a step of each, from the call to a synchronise.
- ``profile``: ``--blocks`` calls of 5 steps under ``torch.profiler``
  (CPU and CUDA), each after 2 unprofiled steps; the wall and
  dispatching-thread CPU milliseconds a profiled step. Of the last
  profile: the milliseconds a step in each ``fit.*`` range; by range, the
  launch calls in it, their durations and the device time of their
  kernels (through the profiler's correlation ids); for each
  ``fit.updater`` range, when its first launch and first kernel start and
  its last kernel ends; the device's idle gaps put down to the ``fit.*``
  range that holds each gap's middle, at any depth.

A checkout without the phases runs both modes and reports no ranges: run
it beside this one in one command to compare them on one card. Prints
one JSON object, last. Needs one card; imports nothing of JAX.
"""

import argparse
import bisect
import collections
import json
import os
import sys
import time

PHASES = ("fit.batch_wait", "fit.forward_backward", "fit.updater",
          "fit.device_wait")


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(ranges, calls):
    """The ``calls`` that lie inside one of ``ranges`` (which do not
    overlap: one thread's ranges of one name)."""
    spans = sorted((r.time_range.start, r.time_range.end) for r in ranges)
    starts = [s for s, _ in spans]
    out = []
    for c in calls:
        i = bisect.bisect_right(starts, c.time_range.start) - 1
        if i >= 0 and c.time_range.end <= spans[i][1]:
            out.append(c)
    return out


def analyse(prof, steps: int) -> dict:
    from torch.autograd import DeviceType
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    host = [e for e in events
            if e.device_type == DeviceType.CPU and not e.is_async]
    kernel_of = {k.id: k for k in device}
    launches = [c for c in host
                if c.name.startswith("cu") and "Launch" in c.name]
    out = {"kernels_per_step": sum(
        1 for k in device if not k.name.startswith(("Memcpy", "Memset")))
        / steps}
    ranges = {p: [e for e in host if e.name == p] for p in PHASES}
    out["phase_ms_per_step"] = {
        p: sum(e.time_range.end - e.time_range.start for e in rs)
        / 1e3 / steps for p, rs in ranges.items() if rs}
    for p in ("fit.forward_backward", "fit.updater"):
        if not ranges[p]:
            continue
        ls = _inside(ranges[p], launches)
        durs = sorted(c.time_range.end - c.time_range.start for c in ls)
        ks = [kernel_of[c.id] for c in ls if c.id in kernel_of]
        out[p] = {
            "launches_per_step": len(ls) / steps,
            "launch_us_median": durs[len(durs) // 2] if durs else None,
            "launches_over_100us_per_step": sum(d > 100 for d in durs)
            / steps,
            "launch_ms_over_100us_per_step": sum(d for d in durs if d > 100)
            / 1e3 / steps,
            "kernel_device_ms_per_step": sum(
                k.time_range.end - k.time_range.start for k in ks)
            / 1e3 / steps}
    align = []
    for u in ranges["fit.updater"]:
        ls = _inside([u], launches)
        ks = [(kernel_of[c.id], c) for c in ls if c.id in kernel_of]
        if ks:
            first, launch = min(ks, key=lambda kc: kc[0].time_range.start)
            align.append({
                "first_launch_us": launch.time_range.start
                - u.time_range.start,
                "first_kernel_us": first.time_range.start
                - u.time_range.start,
                "last_kernel_end_minus_range_end_us": max(
                    k.time_range.end for k, _ in ks) - u.time_range.end})
    out["updater_alignment"] = align
    busy = _merged([(k.time_range.start, k.time_range.end) for k in device])
    holders = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in host if e.name in PHASES)
    gaps = collections.Counter()
    for (_, a1), (b0, _) in zip(busy, busy[1:]):
        mid = (a1 + b0) / 2
        who = "outside any phase"
        for r0, r1, name in holders:
            if r0 <= mid <= r1:
                who = name
        gaps[who] += (b0 - a1) / 1e3
    out["idle_gap_ms_by_phase"] = dict(gaps)
    out["device_busy_ms_per_step"] = sum(e - s for s, e in busy) / 1e3 / steps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("tracer", "profile"), required=True)
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--cell", default="opt-125m.train.t2048")
    ap.add_argument("--seed", type=int, default=2147600777)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path[:0] = [os.path.join(root, "benchmark"), root]
    import run as bench_run
    bench_run.configure_environment()
    import torch
    from harness import common, traffic as _traffic
    from harness.drive_fit import WindowIterator
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = json.loads(open(os.path.join(root, "BENCHMARK.json")).read())
    cell = common.Cell(bench, a.cell, bench_run.ROOT)
    cfg, fam = cell.config, common.family(cell.config)
    from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
    conf = fam.port_conf(cfg)
    shapes = common.program_shapes(conf)
    common.program_precision(cfg)
    batches = _traffic.FitBatches(cell.traffic, cfg, a.seed, dev)
    net = ComputationGraph(conf, device=dev)
    net.set_params(common.make_params(fam, cfg, shapes, a.seed, dev))
    net.init_updater()
    served = [0]

    def fit(n):
        net.fit(WindowIterator(batches, start=served[0], count=n))
        served[0] += n

    fit(3)
    torch.cuda.synchronize(dev)
    out = {"root": root, "mode": a.mode, "cell": a.cell,
           "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__}
    res = collections.defaultdict(list)
    if a.mode == "tracer":
        from deeplearning4j_tpu_torch.util.tracing import Tracer
        for b in range(a.blocks):
            for m in (("off", "on") if b % 2 == 0 else ("on", "off")):
                net.tracer = Tracer() if m == "on" else None
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                fit(a.steps)
                torch.cuda.synchronize(dev)
                res[f"step_ms_tracer_{m}"].append(
                    1e3 * (time.perf_counter() - t0) / a.steps)
    else:
        from torch.profiler import ProfilerActivity, profile
        for b in range(a.blocks):
            fit(2)
            torch.cuda.synchronize(dev)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            c0, t0 = time.thread_time(), time.perf_counter()
            fit(5)
            torch.cuda.synchronize(dev)
            res["profiled_wall_ms"].append(1e3 * (time.perf_counter() - t0)
                                           / 5)
            res["profiled_cpu_ms"].append(1e3 * (time.thread_time() - c0) / 5)
            prof.stop()
        out.update(analyse(prof, 5))
    out.update(res)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
