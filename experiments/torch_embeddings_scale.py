"""Word2Vec and DeepWalk fits of chip_smoke.py's embeddings phase at other
run lengths and batch sizes, on one card.

    python3 experiments/torch_embeddings_scale.py [--tokens 2000000]
        [--walks-per-vertex 2] [--w2v-batch 4096] [--probe-batch 65536]

Runs parts B and C of the phase (``chip_smoke.embed_word2vec`` and
``embed_deepwalk``, gates included) with the Zipf corpus at ``--tokens``
tokens, DeepWalk at ``--walks-per-vertex`` walks from each vertex and
Word2Vec at ``--w2v-batch`` pairs a batch; then, with ``--probe-batch``,
one more Word2Vec fit of the same corpus at that batch, unprofiled, whose
largest |syn0| and finiteness it prints (the summed loss of a Zipf text's
frequent words at large batches). Prints the card's name and power limit
and, last, one JSON object of the readings. Needs one card; imports
nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=2_000_000)
    ap.add_argument("--walks-per-vertex", type=int, default=2)
    ap.add_argument("--w2v-batch", type=int, default=4096)
    ap.add_argument("--probe-batch", type=int, default=65_536)
    args = ap.parse_args()
    print(cs.card_line())
    cs.W2V_FIT.update(tokens=args.tokens, batch=args.w2v_batch)
    cs.DEEPWALK.update(walks_per_vertex=args.walks_per_vertex)
    failures, out = [], {}
    out["word2vec"] = cs.embed_word2vec(failures)
    out["deepwalk"] = cs.embed_deepwalk(failures)
    if args.probe_batch:
        cfg = dict(cs.W2V_FIT, batch=args.probe_batch)
        sentences = cs.zipf_sentences(np.random.default_rng(cs.SEED + 51),
                                      cfg["types"], cfg["tokens"],
                                      cfg["sentence"])
        t0 = time.perf_counter()
        w2v = cs.word2vec(cfg, sentences, cs.DEV).fit()
        syn0 = w2v._syn0()
        finite = np.isfinite(syn0)
        out["probe"] = {"batch": args.probe_batch,
                        "wall_s": time.perf_counter() - t0,
                        "finite": bool(finite.all()),
                        "max_abs_finite": float(np.abs(syn0[finite]).max())
                        if finite.any() else None}
        print(f"probe: Word2Vec.fit at {args.probe_batch} pairs a batch: "
              f"{out['probe']}")
    print(json.dumps(out))
    if failures:
        raise SystemExit(f"failed gates: {failures}")


if __name__ == "__main__":
    main()
