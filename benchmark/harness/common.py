"""Shared pieces of a run: loading what a cell names, weights from the
seed, the device's description and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List

import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


# --------------------------------------------------------------------------
# what a cell names
# --------------------------------------------------------------------------


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with what it names:
    the configuration (its file's contents), the traffic mix
    (``traffic/<name>.json``) and the metrics it reports."""

    def __init__(self, bench: dict, name: str, root: Path):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        conf_entry = {c["name"]: c for c in bench["configs"]}[
            self.entry["config"]]
        self.config = json.loads((root / conf_entry["file"]).read_text())
        self.traffic = json.loads(
            (BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
            .read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quantity(metric: str) -> str:
    """What a metric measures: its name up to the first dot. The cells of
    ``train_step_ms`` and ``train_step_ms.resnet`` report one quantity
    under two names, each with its own bound."""
    return metric.split(".")[0]


def load_reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, or, where
    the metric has none of its own, its quantity's."""
    if (BENCH_DIR / "metrics" / f"{metric}.py").exists():
        return load_module("metrics", metric)
    return load_module("metrics", quantity(metric))


def family(cfg: dict):
    return importlib.import_module(f"families.{cfg['family']}")


# --------------------------------------------------------------------------
# weights from the seed
# --------------------------------------------------------------------------


def make_params(fam, cfg: dict, shapes: Dict[str, Dict[str, tuple]],
                seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every leaf of ``shapes`` in float32 on ``device``, as the family's
    ``init`` says: the normal leaves cut from one draw of a generator on
    the device seeded by ``seed``, scaled leaf by leaf."""
    plan = [(v, k, tuple(s), fam.init(cfg, v, k, tuple(s)))
            for v, ks in shapes.items() for k, s in ks.items()]
    total = sum(math.prod(s) for _, _, s, how in plan
                if not isinstance(how, str))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree: Dict[str, Dict[str, torch.Tensor]] = {v: {} for v in shapes}
    at = 0
    for v, k, s, how in plan:
        if how == "ones":
            tree[v][k] = torch.ones(s, device=device)
        elif how == "zeros":
            tree[v][k] = torch.zeros(s, device=device)
        else:
            n = math.prod(s)
            tree[v][k] = flat[at:at + n].view(s).mul(how)
            at += n
    return tree


def program_precision(cfg: dict) -> None:
    """The process settings a configuration states for the program: with
    ``"tf32": false``, float32 products stay float32 (PyTorch lets cuDNN
    run float32 convolutions in TF32 by default)."""
    if "tf32" in cfg["program"]:
        from reference import precision
        precision.set_tf32(bool(cfg["program"]["tf32"]))


def program_shapes(conf) -> Dict[str, Dict[str, tuple]]:
    """The parameter shapes the configuration declares, vertex by vertex."""
    from deeplearning4j_tpu_torch.dtypes import policy_from_name
    policy = policy_from_name(conf.training.dtype)
    return {n: conf.vertices[n].param_shapes(policy)
            for n in conf.topological_order()}


# --------------------------------------------------------------------------
# the device and the result
# --------------------------------------------------------------------------


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (names compared whole, so the port's own package is none)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def emit(result: dict) -> None:
    """The checks on the last lines of standard error, then the result as
    the last line of standard output, its ``checks`` key last."""
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
