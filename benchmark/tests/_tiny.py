"""The benchmark's cells at sizes a CPU test run holds: every width and
length cut, everything else (the traffic kinds' modules, the references,
the checks and their limits) as on the card."""

from __future__ import annotations

import json

import torch

import run as bench_run
from harness import common

CONFIGS = {
    "lm": {"hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "ffn_dim": 256, "vocab_size": 512},
    "resnet": {"depths": [1, 1], "hidden_sizes": [64, 128],
               "embedding_size": 16, "image_size": 32, "num_labels": 10},
}
TRAFFIC = {"lm-fit-8x2048": {"batch": 4, "seq_len": 64},
           "image-fit-b128": {"batch": 8, "pool": 4}}
SEED = 2 ** 31 + 12345


def cell(name: str):
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    c = common.Cell(bench, name, bench_run.ROOT)
    c.config.update(CONFIGS[c.config["family"]])
    c.traffic.update(TRAFFIC[c.entry["traffic"]])
    return c


def run(name: str, seconds: float = 1.0, trace: bool = False,
        seed: int = SEED):
    """One CPU run of the tiny cell: (context, result)."""
    return bench_run.run_cell(cell(name), seed, seconds, trace,
                              torch.device("cpu"))
