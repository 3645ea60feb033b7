"""Readings that set a cell's limits, on the card, at the cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3]

For each seed, one run of the cell as ``run.py`` makes it (with a window
of ``--seconds``) gives the program's numbers, and in the same process the
control, the plain reference in the precision below the configuration's
(``reference.precision.CONTROL``) put in the program's place, and the
fault of a step that leaves out half of each batch and takes the mean
over the rest, planted in the reference put in the program's place, each
compared with the float32 reference as the program is. Beside them, the
leaf whose change after three steps is furthest from the reference's, and
its gap after each step on each side.

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
                            for k, m in result["metrics"].items()}}
        control = precision.CONTROL[cell.config["program"]["dtype"]]
        line["control_arithmetic"] = control
        args_ref = (ctx.family, cell.config, ctx.shapes, seed, device,
                    ctx.batches)
        ref = ctx.reference_readings
        got = ctx.program_readings
        line["program"] = drive_fit.compare(got, ref)
        readings = {"control": drive_fit.reference_readings(
                        *args_ref, arithmetic=control),
                    "half_batch": drive_fit.reference_readings(
                        *args_ref, rows="half")}
        for name, r in readings.items():
            line[name] = drive_fit.compare(r, ref)
        steps = drive_fit.change_gaps(got, ref)
        worst = max(steps[-1], key=steps[-1].get)
        line["worst_change_leaf"] = {
            "leaf": worst, "program": [s[worst] for s in steps],
            "control": [s[worst] for s in drive_fit.change_gaps(
                readings["control"], ref)]}
        del readings
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
