"""Readings that set a training cell's limits when its batch is one row,
on the card, at the cell's own size:

    python3 benchmark/control_tokens.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3]

As ``control.py``, for each seed: one run of the cell as ``run.py`` makes
it (with a window of ``--seconds``) gives the program's numbers, and in
the same process the control, the plain reference in the precision below
the configuration's (``reference.precision.CONTROL``), is put in the
program's place, each compared with the float32 reference as the program
is. ``control.py``'s fault, a step that leaves out half of each batch's
rows, leaves nothing of a batch of one row; here the fault leaves out the
second half of each row's positions and takes the loss over the rest at
the whole row's scale (twice its sum), planted in the reference put in
the program's place.

One JSON line per seed on standard output. The benchmark's own runs never
run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run as bench_run  # noqa: E402


class HalfTokens:
    """A family whose loss leaves out the second half of each row's
    positions and doubles the rest's sum."""

    def __init__(self, fam):
        self.fam = fam
        self.REFERENCE_ROWS = fam.REFERENCE_ROWS
        self.init = fam.init
        self.logits = fam.logits

    def summed_loss(self, logits, labels):
        t = labels.shape[1] // 2
        return 2.0 * self.fam.summed_loss(logits[:, :t], labels[:, :t])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    bench_run.configure_environment()
    import torch
    from harness import common, drive_fit
    from reference import precision
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = common.Cell(bench, args.workload, bench_run.ROOT)
        t0 = time.perf_counter()
        ctx, result = bench_run.run_cell(cell, seed, args.seconds, False,
                                         device, t0)
        line = {"seed": seed, "correct": result["correct"],
                "checks": {k: c["value"] for k, c in result["checks"].items()},
                "metrics": {k: m["value"]
                            for k, m in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
        control = precision.CONTROL[cell.config["program"]["dtype"]]
        line["control_arithmetic"] = control
        ref = ctx.reference_readings
        line["program"] = drive_fit.compare(ctx.program_readings, ref)
        for name, fam, arithmetic in (
                ("control", ctx.family, control),
                ("half_tokens", HalfTokens(ctx.family), "f32")):
            got = drive_fit.reference_readings(
                fam, cell.config, ctx.shapes, seed, device, ctx.batches,
                arithmetic=arithmetic)
            line[name] = drive_fit.compare(got, ref)
            del got
        line["seconds"] = time.perf_counter() - t0
        line["reference_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        print(json.dumps(line), flush=True)
        del ctx, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
