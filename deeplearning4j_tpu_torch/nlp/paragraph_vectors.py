"""ParagraphVectors: document embeddings (PV-DBOW / PV-DM; counterpart of
the JAX package's ``nlp/paragraph_vectors.py``).

Parity: reference ``models/paragraphvectors/ParagraphVectors.java``
(labelled-document training, ``inferVector`` for unseen docs) with the
``sequence/DBOW.java`` / ``DM.java`` learning algorithms.

Doc vectors are EXTRA rows of ``syn0`` (indices ``vocab_size + doc_id``),
so the same ns_step trains them:
- PV-DBOW: (center=doc_row → target=word) pairs — exactly skip-gram with the
  doc row as the center.
- PV-DM: CBOW with the doc row appended to every context window.
``infer_vector`` freezes word/output tables and SGD-fits one new row
(numpy-seeded start, its own mean-loss step, gradient in closed form).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import learning as _learning
from .sequence_vectors import SequenceVectors


class ParagraphVectors(SequenceVectors):
    def __init__(self, *, dm: bool = False, **kw):
        kw.setdefault("negative", 5)
        super().__init__(use_cbow=dm, **kw)
        self.dm = dm
        self.labels: List[str] = []
        self._label_index: Dict[str, int] = {}

    # ------------------------------------------------------------------

    def fit_documents(self, documents: Sequence[Tuple[str, List[str]]]
                      ) -> "ParagraphVectors":
        """documents: [(label, tokens)]."""
        self.labels = [lbl for lbl, _ in documents]
        self._label_index = {l: i for i, l in enumerate(self.labels)}
        token_seqs = [toks for _, toks in documents]
        self.build_vocab(token_seqs)
        self._init_params(extra_vectors=len(documents))
        self._train_docs(documents)
        self._syn0_normed = None
        return self

    def _train_docs(self, documents) -> None:
        rng = np.random.default_rng(self.seed)
        V = self.vocab.num_words()
        W = self.window
        B = self.batch_size
        for epoch in range(self.epochs):
            lr = max(self.min_learning_rate,
                     self.learning_rate * (1 - epoch / max(self.epochs, 1)))
            centers, targets, ctxs, masks = [], [], [], []
            for doc_id, (_, toks) in enumerate(documents):
                idx = np.array([self.vocab.index_of(t) for t in toks
                                if self.vocab.index_of(t) >= 0], dtype=np.int32)
                if len(idx) == 0:
                    continue
                doc_row = V + doc_id
                for pos in range(len(idx)):
                    if self.dm:
                        # PV-DM: context = window words + doc row, predict word
                        b = rng.integers(1, W + 1)
                        lo, hi = max(0, pos - b), min(len(idx), pos + b + 1)
                        win = [idx[j] for j in range(lo, hi) if j != pos]
                        ctx = np.zeros(2 * W + 1, dtype=np.int32)
                        m = np.zeros(2 * W + 1, dtype=np.float32)
                        ctx[0] = doc_row
                        m[0] = 1.0
                        ctx[1:1 + len(win)] = win
                        m[1:1 + len(win)] = 1.0
                        centers.append(idx[pos])
                        targets.append(idx[pos])
                        ctxs.append(ctx)
                        masks.append(m)
                    else:
                        # PV-DBOW: doc row predicts each word
                        centers.append(doc_row)
                        targets.append(idx[pos])
                    if len(centers) >= B:
                        self._flush(centers, targets, ctxs, masks, lr, rng)
                        centers, targets, ctxs, masks = [], [], [], []
            if centers:
                self._flush(centers, targets, ctxs, masks, lr, rng)

    def _flush(self, centers, targets, ctxs, masks, lr, rng) -> None:
        c = np.asarray(centers, dtype=np.int32)
        t = np.asarray(targets, dtype=np.int32)
        negs = self._draw_negatives(rng, t)
        if self.dm:
            ctx = np.stack(ctxs)
            m = np.stack(masks)
        else:
            ctx = np.zeros((len(c), 1), dtype=np.int32)
            m = np.ones((len(c), 1), dtype=np.float32)
        self.params, _ = _learning.ns_step(
            self.params, *self._to_device(c, t, negs, ctx, m),
            np.float32(lr), cbow=self.dm)

    # ------------------------------------------------------------------

    def get_paragraph_vector(self, label: str) -> Optional[np.ndarray]:
        i = self._label_index.get(label)
        if i is None:
            return None
        return self._host(self.params["syn0"][self.vocab.num_words() + i])

    def infer_vector(self, tokens: List[str], steps: int = 20,
                     learning_rate: Optional[float] = None,
                     seed: int = 0) -> np.ndarray:
        """Fit a fresh doc vector against frozen word/output tables
        (parity: ``ParagraphVectors.inferVector``)."""
        lr = learning_rate if learning_rate is not None else self.learning_rate
        idx = np.array([self.vocab.index_of(t) for t in tokens
                        if self.vocab.index_of(t) >= 0], dtype=np.int32)
        if len(idx) == 0:
            return np.zeros(self.layer_size, dtype=np.float32)
        rng = np.random.default_rng(seed)
        vec, = self._to_device(
            (rng.random(self.layer_size, dtype=np.float32) - 0.5)
            / self.layer_size)
        vec = vec.clone()
        syn1neg = self.params["syn1neg"]
        targets, = self._to_device(idx)
        for s in range(steps):
            negs, = self._to_device(self._draw_negatives(rng, idx))
            decayed = max(self.min_learning_rate, lr * (1 - s / steps))
            vec = _infer_step(syn1neg, vec, targets, negs,
                              np.float32(decayed))
        return self._host(vec)

    def nearest_labels(self, tokens_or_vec, top: int = 5) -> List[str]:
        """Most similar documents to an inferred vector / token list."""
        vec = (self.infer_vector(tokens_or_vec)
               if isinstance(tokens_or_vec, list) else np.asarray(tokens_or_vec))
        V = self.vocab.num_words()
        docs = self._host(self.params["syn0"][V:V + len(self.labels)])
        docs = docs / np.maximum(np.linalg.norm(docs, axis=1, keepdims=True), 1e-12)
        vec = vec / max(np.linalg.norm(vec), 1e-12)
        order = np.argsort(-(docs @ vec))
        return [self.labels[int(i)] for i in order[:top]]


@torch.no_grad()
def _infer_step(syn1neg, vec, targets, negs, lr):
    """One step of ``infer_vector``: the mean over the document's words of
    the negative-sampling loss of ``vec`` against the frozen output table,
    ``vec - lr·grad``."""
    targets, negs = targets.long(), negs.long()
    u_pos = _learning._rows(syn1neg, targets)                   # [T,D]
    u_neg = _learning._rows(syn1neg, negs)                      # [T,K,D]
    n = targets.shape[0]
    d_pos = -torch.sigmoid(-(u_pos @ vec)) / n    # d loss / d (u_pos·v)
    d_neg = torch.sigmoid(u_neg @ vec) / n        # d loss / d (u_neg·v)
    g = d_pos @ u_pos + torch.einsum("tk,tkd->d", d_neg, u_neg)
    return vec - g * _learning._lr(lr)
