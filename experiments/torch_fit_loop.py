"""The flagship's ``fit`` loop timed on the card, for one checkout or two.

    python3 experiments/torch_fit_loop.py [--root DIR] [--modes M,...]
                                          [--steps 16] [--rounds 4]

Imports ``deeplearning4j_tpu_torch`` from the checkout ``--root`` (this one
by default), builds the flagship transformer LM (d 768, 12 layers, 12
heads, d_ff 3072, V 32768, ids input, mixed bf16, adam lr 3e-4) with
random weights from its seed, and calls ``net.fit`` over a list of
``--steps`` in-memory [8, 2048] batches of token ids (each id an affine
function of the last, one in ten random, as chip_smoke.py's record set):
one call of two batches in each mode to warm up (its first step counts
the step's FLOPs), then ``--rounds`` timed calls, each from the call to a
device synchronise after it. The modes take turns (A B B A ...):
``default`` runs ``fit`` as the checkout ships it, ``unstaged`` sets
``DL4JTPU_INGEST=0`` for its calls (a checkout that does not read the
variable runs its default). To compare two checkouts, run the script once
per checkout in turns, in one command on one card; a second checkout finds
the kernels the first built when its ``build/`` is a link to the first's.

Prints the card's name and power limit and, last, one JSON object: the
milliseconds a step of every timed round by mode. Needs one card; imports
nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

FLAGSHIP = {"V": 32768, "L": 12, "D": 768, "H": 12, "F": 3072, "T": 2048,
            "B": 8}
SEED = 0


def token_batches(n, seed=SEED):
    V, T, B = FLAGSHIP["V"], FLAGSHIP["T"], FLAGSHIP["B"]
    rng = np.random.default_rng(seed)
    ids = np.empty((n * B, T + 1), np.int64)
    ids[:, 0] = rng.integers(0, V, n * B)
    for t in range(1, T + 1):
        ids[:, t] = (ids[:, t - 1] * 5 + 17) % V
    noise = rng.random(ids.shape) < 0.1
    ids[noise] = rng.integers(0, V, int(noise.sum()))
    ids = ids.astype(np.int32).reshape(n, B, T + 1)
    return [(np.ascontiguousarray(b[:, :-1]), np.ascontiguousarray(b[:, 1:]))
            for b in ids]


def fit_in(net, batches, mode):
    """Seconds of one ``net.fit(batches)`` in ``mode``, to a synchronise."""
    if mode == "unstaged":
        os.environ["DL4JTPU_INGEST"] = "0"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(batches)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        os.environ.pop("DL4JTPU_INGEST", None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--modes", default="default")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fit_loop: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch.models import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: none")
    V, L, D, H, F = (FLAGSHIP[k] for k in "VLDHF")
    net = ComputationGraph(transformer_lm(
        V, n_layers=L, d_model=D, n_heads=H, d_ff=F, dtype="mixed_bf16",
        input_ids=True)).init()
    batches = token_batches(args.steps)
    modes = args.modes.split(",")
    for mode in modes:    # each mode's first call counts its FLOPs
        fit_in(net, batches[:2], mode)
    # A B B A ...: every other pass over the modes runs them backwards
    order = [modes[r % len(modes)] if (r // len(modes)) % 2 == 0
             else modes[-1 - r % len(modes)] for r in range(args.rounds)]
    ms = {m: [] for m in modes}
    for mode in order:
        ms[mode].append(fit_in(net, batches, mode) / args.steps * 1e3)
    print(json.dumps({"root": root, "steps": args.steps, "order": order,
                      "ms_per_step": ms,
                      "iterations": net.iteration_count}))


if __name__ == "__main__":
    main()
