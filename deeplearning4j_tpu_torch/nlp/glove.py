"""GloVe: global-vector embeddings from co-occurrence statistics
(counterpart of the JAX package's ``nlp/glove.py``).

Parity: reference ``models/glove/Glove.java`` (+ ``glove/count/`` co-occurrence
counting): weighted least squares  f(X_ij)(w_i·w̃_j + b_i + b̃_j − log X_ij)²
with AdaGrad per-parameter learning rates.

Co-occurrence counting is a host-side dict sweep (its insertion order fixes
the pair order) and the tables start from the same numpy draws as the
reference's; training is an AdaGrad step on the device over shuffled
(i, j, X_ij) triples — gathers, the gradient in closed form, sorted
scatter-adds into dense tables, like the word2vec steps (learning.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from . import learning as _learning
from .sequence_vectors import SequenceVectors


@torch.no_grad()
def _glove_step(params, accum, rows, cols, logx, weight, lr):
    """One AdaGrad step over a batch of (i, j, log X_ij, f(X_ij)): the
    weighted least-squares loss, mean over the batch, its gradients summed
    into dense tables; ``accum += g²``, ``p -= lr·g/√(accum+1e-12)`` in
    place. Returns (params, accum, loss)."""
    rows, cols = rows.long(), cols.long()
    rows_of = _learning._rows
    wi, wj = rows_of(params["w"], rows), rows_of(params["w_tilde"], cols)
    bi, bj = rows_of(params["b"], rows), rows_of(params["b_tilde"], cols)
    diff = (wi * wj).sum(dim=1) + bi + bj - logx
    n = rows.shape[0]
    loss = 0.5 * (weight * diff * diff).sum() / n
    gd = weight * diff / n                    # d loss / d diff
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    _learning._accumulate(grads["w"], rows, gd[:, None] * wj)
    _learning._accumulate(grads["w_tilde"], cols, gd[:, None] * wi)
    _learning._accumulate(grads["b"], rows, gd)
    _learning._accumulate(grads["b_tilde"], cols, gd)
    lr = _learning._lr(lr)
    for k, g in grads.items():
        # AdaGrad: accumulate squared grads, scale updates
        accum[k].add_(g * g)
        params[k].sub_(g.mul_(lr) / torch.sqrt(accum[k] + 1e-12))
    return params, accum, loss


class Glove(SequenceVectors):
    """GloVe trainer (reference builder knobs: ``xMax``, ``alpha``,
    ``symmetric``, ``shuffle``, ``learningRate``, ``epochs``)."""

    def __init__(self, *, x_max: float = 100.0, alpha: float = 0.75,
                 symmetric: bool = True, shuffle: bool = True, **kw):
        kw.setdefault("learning_rate", 0.05)
        super().__init__(**kw)
        self.x_max = float(x_max)
        self.alpha = float(alpha)
        self.symmetric = symmetric
        self.shuffle = shuffle
        self._accum = None

    def _count_cooccurrences(self, seqs: Iterable[List[int]]
                             ) -> Dict[Tuple[int, int], float]:
        counts: Dict[Tuple[int, int], float] = {}
        W = self.window
        for idx in seqs:
            n = len(idx)
            for pos in range(n):
                for off in range(1, W + 1):
                    j = pos + off
                    if j >= n:
                        break
                    a, b = int(idx[pos]), int(idx[j])
                    inc = 1.0 / off  # distance weighting (GloVe convention)
                    counts[(a, b)] = counts.get((a, b), 0.0) + inc
                    if self.symmetric:
                        counts[(b, a)] = counts.get((b, a), 0.0) + inc
        return counts

    def fit(self, sequences: Iterable[List[str]],
            resettable: bool = True) -> "Glove":
        seqs = list(sequences)
        if self.vocab is None:
            self.build_vocab(seqs)
        indexed = []
        for seq in seqs:
            idx = [self.vocab.index_of(t) for t in seq]
            indexed.append([i for i in idx if i >= 0])
        counts = self._count_cooccurrences(indexed)
        if not counts:
            raise ValueError("empty co-occurrence matrix")
        pairs = np.array(list(counts.keys()), dtype=np.int32)
        xs = np.array(list(counts.values()), dtype=np.float32)
        logx = np.log(xs)
        weight = np.minimum((xs / self.x_max) ** self.alpha, 1.0).astype(np.float32)

        V, D = self.vocab.num_words(), self.layer_size
        rng = np.random.default_rng(self.seed)
        init = lambda shape: (  # noqa: E731
            (rng.random(shape, dtype=np.float32) - 0.5) / D)
        self.params = _learning.params_from_numpy(
            {"w": init((V, D)), "w_tilde": init((V, D)),
             "b": np.zeros(V, np.float32),
             "b_tilde": np.zeros(V, np.float32)}, self.device)
        self._accum = {k: torch.zeros_like(p)
                       for k, p in self.params.items()}

        B = self.batch_size
        order = np.arange(len(pairs))
        for _ in range(self.epochs):
            if self.shuffle:
                rng.shuffle(order)
            for s in range(0, len(order), B):
                sel = order[s:s + B]
                self.params, self._accum, _ = _glove_step(
                    self.params, self._accum, *self._to_device(
                        pairs[sel, 0], pairs[sel, 1], logx[sel],
                        weight[sel]),
                    np.float32(self.learning_rate))
        self._syn0_normed = None
        return self

    def _syn0(self) -> np.ndarray:
        # GloVe convention: final embedding = w + w̃
        return (self._host(self.params["w"])
                + self._host(self.params["w_tilde"]))
