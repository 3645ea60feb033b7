"""One run of one cell of ``BENCHMARK.json``, in a fresh process:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It builds the cell's model with weights from the seed on the card, warms
the cell's own shapes, measures for ``--seconds`` and judges what the
timed path produced against the plain reference under
``benchmark/reference/``. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: each number compared
with its limit, also printed as the last lines of standard error.

The run exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), without the program, or when a module of
jax, jaxlib, flax or the JAX package is loaded once the window has
closed. Every build and kernel cache stays under ``build/`` in the
checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
          "CUDA_CACHE_PATH": "cuda_cache"}


def configure_environment() -> None:
    """Fixed cache directories inside the checkout; no JAX through any
    library; the harness's modules importable."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (str(BENCH), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)


class Context:
    """What the module of a traffic kind (``harness/drive_<kind>.py``)
    gets: the cell, the seed, the window's length, whether it is traced,
    the device, the process's start and the run record."""

    def __init__(self, cell, seed, seconds, trace, device, t_start, record):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.record = record


def install_annotations(cell) -> None:
    """The profiler annotations the cell's per-layer readers ask for."""
    from harness import common, trace as _trace
    for m in cell.per_layer:
        mod = common.load_reader(m["name"])
        for module, attr, label in getattr(mod, "ANNOTATE", ()):
            _trace.annotate(importlib.import_module(module), attr, label)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START):
    """Drive one run of ``cell``; returns (the run's context, the result
    dict for the last line)."""
    from harness import common
    from harness.record import RunRecord
    record = RunRecord(cell, common.device_info(device)["kind"])
    if trace:
        install_annotations(cell)
    ctx = Context(cell, seed, seconds, trace, device, t_start, record)
    kind = importlib.import_module(f"harness.drive_{cell.traffic['kind']}")
    out = kind.run(ctx)

    limits = json.loads((BENCH / "limits" / f"{cell.name}.json").read_text())
    checks = {k: {"value": out["readings"][k], "limit": lim}
              for k, lim in limits.items()}
    e2e = out.get("e2e")
    correct = (e2e is not None and out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = common.load_reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(e2e or {}, setup_s=out["setup_s"])
        for m in cell.end_to_end:
            if common.quantity(m["name"]) in values:
                metrics[m["name"]] = {
                    "value": values[common.quantity(m["name"])],
                    "unit": m["unit"]}
    dev = out["memory"]
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and record.trace is not None:
        dev["busy_s"] = record.trace.busy_s()
        dev["window_s"] = record.trace.window_s
        result["breakdown"] = {"device_ops": record.trace.device_ops(),
                               "idle_gaps": record.trace.idle_gaps()}
    result["checks"] = checks
    return ctx, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    configure_environment()
    import torch
    from harness import common
    cell = common.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                       args.workload, ROOT)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    _, result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0))
    bad = common.forbidden_modules()
    if bad:
        print(f"modules of {bad} are loaded; the run is void",
              file=sys.stderr)
        return 3
    common.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
