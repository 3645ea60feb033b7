"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it resolving to the files of its own that the harness finds by name."""

import importlib
import json
import re

import pytest

from harness import common
import run as bench_run

BENCH = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    cells = 24      # the most cells a later PR may bring
    need = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
            + cells * 2 * 90 + 1200)
    assert need <= 43200
    assert len((bench_run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    cfg = json.loads((bench_run.ROOT / entry["file"]).read_text())
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg
        assert key in cfg["changed"]
    assert set(cfg["changed"]) == set(entry["reduced"])
    importlib.import_module(f"families.{cfg['family']}")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve(name):
    cell = common.Cell(BENCH, name, bench_run.ROOT)
    assert cell.entry["chips"] in (1, 4)
    importlib.import_module(f"harness.drive_{cell.traffic['kind']}")
    limits = json.loads((bench_run.BENCH / "limits" / f"{name}.json")
                        .read_text())
    assert limits and all(v > 0 for v in limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(common.load_reader(m["name"]).read)


def test_metrics_contract():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
