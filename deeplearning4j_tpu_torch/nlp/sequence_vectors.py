"""SequenceVectors: the generic embedding trainer over token sequences
(counterpart of the JAX package's ``nlp/sequence_vectors.py``).

Parity: reference ``models/sequencevectors/SequenceVectors.java:161``
(``fit()``: vocab build → training threads → per-sequence ``trainSequence``)
with the Hogwild thread pool (``:245-260``) replaced by host-side batch
preparation + vectorized update steps on the device (see learning.py).

The host side is the JAX package's numpy code verbatim (``_indexed``,
``_pairs``, ``_draw_negatives`` and the learning-rate schedule of
``_train``), so the same seed gives the same batches bit for bit; each
batch goes to ``device`` as int32/f32 tensors. The tables live on
``device`` (``"cuda"`` unless the caller asks for the CPU); the lookup API
works on a host f32 copy of ``syn0``, as the reference's does with
``np.asarray``.

Also the base for Word2Vec / ParagraphVectors / DeepWalk, exactly as in the
reference's class hierarchy.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

import torch

from ..dtypes import resolve_device
from . import learning as _learning
from .vocab import Huffman, VocabCache, VocabConstructor


class SequenceVectors:
    """Train word/sequence embeddings from an iterable of token sequences.

    Key hyperparameters mirror the reference builder: ``layer_size``
    (vector dim), ``window``, ``negative`` (0 → hierarchical softmax),
    ``min_word_frequency``, ``sample`` (frequent-word subsampling),
    ``learning_rate``/``min_learning_rate`` (linear decay), ``epochs``,
    ``use_cbow`` (elements algo: skip-gram default), ``seed``;
    ``device`` holds the tables (``"cuda"`` by default: without a card it
    raises; pass ``"cpu"`` to run on the CPU).
    """

    def __init__(self, *, layer_size: int = 100, window: int = 5,
                 negative: int = 5, min_word_frequency: int = 1,
                 sample: float = 0.0, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, epochs: int = 1,
                 batch_size: int = 4096, use_cbow: bool = False,
                 seed: int = 42, vocab_limit: Optional[int] = None,
                 mesh=None, device="cuda"):
        self.layer_size = layer_size
        self.window = window
        self.negative = negative
        self.min_word_frequency = min_word_frequency
        self.sample = sample
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.use_cbow = use_cbow
        self.seed = seed
        self.vocab_limit = vocab_limit
        self.device = resolve_device(device)
        # data-parallel training: pair batches split over mesh's "data"
        # axis (every rank handed the global batch), params replicated,
        # grads all-reduced over the axis (parity role: dl4j-spark-nlp's
        # distributed Word2Vec; see learning.make_sharded_ns_step). NS mode
        # only.
        self.mesh = mesh
        self._sharded_step = None

        self.vocab: Optional[VocabCache] = None
        self.params: Optional[Dict] = None
        self._codes = self._points = self._lengths = None
        self._neg_table: Optional[np.ndarray] = None
        self._syn0_normed: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # vocab + fit
    # ------------------------------------------------------------------

    def build_vocab(self, sequences: Iterable[List[str]]) -> None:
        self.vocab = VocabConstructor(
            self.min_word_frequency, self.vocab_limit).build(sequences)
        if self.negative <= 0:
            h = Huffman(self.vocab)
            h.apply()
            self._codes, self._points, self._lengths = h.padded_tables()
        else:
            self._neg_table = _learning.build_unigram_table(
                self.vocab.counts_array())

    def _init_params(self, extra_vectors: int = 0) -> None:
        V = self.vocab.num_words()
        self.params = _learning.init_params(
            V, self.layer_size, seed=self.seed,
            hs_nodes=(V - 1 if self.negative <= 0 else 0),
            use_neg=self.negative > 0,
            extra_vectors=extra_vectors, device=self.device)

    def fit(self, sequences: Iterable[List[str]],
            resettable: bool = True) -> "SequenceVectors":
        """Build vocab (if absent) + train. For multiple epochs `sequences`
        must be re-iterable (e.g. a list or SentenceIterator)."""
        seqs = sequences if not hasattr(sequences, "__next__") else list(sequences)
        if self.vocab is None:
            self.build_vocab(seqs)
        if self.params is None:
            self._init_params()
        self._train(seqs)
        self._syn0_normed = None
        return self

    # ------------------------------------------------------------------
    # training loop: host-side batching + device steps
    # ------------------------------------------------------------------

    def _indexed(self, seqs: Iterable[List[str]], rng: np.random.Generator
                 ) -> Iterable[np.ndarray]:
        """Token sequences → filtered index arrays (+ subsampling)."""
        vocab = self.vocab
        total = max(vocab.total_word_count, 1)
        sample = self.sample
        for seq in seqs:
            idx = [vocab.index_of(t) for t in seq]
            idx = np.array([i for i in idx if i >= 0], dtype=np.int32)
            if sample > 0 and len(idx):
                freqs = vocab.counts_array()[idx] / total
                # word2vec subsampling keep probability
                keep_p = np.minimum(
                    (np.sqrt(freqs / sample) + 1) * sample / freqs, 1.0)
                idx = idx[rng.random(len(idx)) < keep_p]
            if len(idx) >= 2:
                yield idx

    def _pairs(self, seqs, rng) -> Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (center, target, ctx, ctx_mask) batches. For skip-gram the
        (center→target) pairs; for CBOW ctx is the padded window.

        Vectorized per sequence, the JAX package's code verbatim:
        bit-exact with the per-position generator — the per-position
        reduced-window draw consumes the SAME rng stream, pairs appear in
        the same (position-major, ascending-j) order, and batch
        boundaries fall after the same positions — so seeded training
        runs give the same batches in both packages.
        """
        W = self.window
        B = self.batch_size
        # ascending-j offsets: positions j = pos + off, off in [-W..-1, 1..W]
        offs = np.concatenate([np.arange(-W, 0), np.arange(1, W + 1)])
        pend: List[Tuple[np.ndarray, ...]] = []   # sub-B leftovers
        pend_n = 0

        def _flush(chunks):
            parts = [np.concatenate([c[i] for c in chunks])
                     for i in range(len(chunks[0]))]
            if self.use_cbow:
                return tuple(parts)
            c = parts[0]
            return (c, parts[1], np.zeros((len(c), 1), dtype=np.int32),
                    np.ones((len(c), 1), dtype=np.float32))

        for idx in self._indexed(seqs, rng):
            n = len(idx)
            red = rng.integers(1, W + 1, size=n)  # reduced window per position
            j = np.arange(n)[:, None] + offs[None, :]
            valid = ((np.abs(offs)[None, :] <= red[:, None])
                     & (j >= 0) & (j < n))
            if self.use_cbow:
                keep = valid.any(axis=1)
                # left-pack each row's window ids (stable sort: valid
                # entries first, original ascending-j order preserved)
                order = np.argsort(~valid, axis=1, kind="stable")
                vm = np.take_along_axis(valid, order, axis=1)
                jj = np.take_along_axis(j, order, axis=1)
                ctx = np.where(vm, idx[np.clip(jj, 0, n - 1)],
                               np.int32(0)).astype(np.int32)
                arrays = (idx[keep].astype(np.int32),
                          idx[keep].astype(np.int32),
                          ctx[keep], vm[keep].astype(np.float32))
                cnt = keep.astype(np.int64)
            else:
                cnt = valid.sum(axis=1)
                arrays = (np.repeat(idx, cnt).astype(np.int32),
                          idx[j[valid]].astype(np.int32))
            cum = np.cumsum(cnt)
            pair_off = np.concatenate([[0], cum])
            emitted = 0
            while True:
                # first position where the accumulated count crosses B —
                # the original loop emitted right after that position
                carry = pend_n if not emitted else 0
                p = int(np.searchsorted(cum, B - carry + emitted, "left"))
                if p >= n:
                    break
                end = int(pair_off[p + 1])
                chunk = tuple(a[emitted:end] for a in arrays)
                yield _flush(pend + [chunk] if pend else [chunk])
                pend, pend_n = [], 0
                emitted = end
            total = int(cum[-1]) if n else 0
            if emitted < total:
                pend.append(tuple(a[emitted:total] for a in arrays))
                pend_n += total - emitted
        if pend_n:
            yield _flush(pend)

    def _to_device(self, *arrays):
        return _learning.to_device(arrays, self.device)

    def _train(self, seqs) -> None:
        rng = np.random.default_rng(self.seed)
        # one pass to count total batches for the linear LR decay
        approx_total = None
        step_i = 0
        for epoch in range(self.epochs):
            for batch in self._pairs(seqs, rng):
                center, target, ctx, ctx_mask = batch
                frac = (step_i / approx_total) if approx_total else \
                    (epoch / max(self.epochs, 1))
                lr = max(self.min_learning_rate,
                         self.learning_rate * (1.0 - frac))
                if self.negative > 0:
                    negs = self._draw_negatives(rng, target)
                    if self.mesh is not None:
                        from ..parallel.mesh import axis_size
                        n_dev = axis_size(self.mesh, "data")
                        keep = (len(center) // n_dev) * n_dev
                        if keep == 0:
                            continue  # tail smaller than the mesh: skip
                        if self._sharded_step is None:
                            self._sharded_step = \
                                _learning.make_sharded_ns_step(
                                    self.mesh, cbow=self.use_cbow)
                        self.params, _ = self._sharded_step(
                            self.params, *self._to_device(
                                center[:keep], target[:keep], negs[:keep],
                                ctx[:keep], ctx_mask[:keep]),
                            np.float32(lr))
                    else:
                        self.params, _ = _learning.ns_step(
                            self.params, *self._to_device(
                                center, target, negs, ctx, ctx_mask),
                            np.float32(lr), cbow=self.use_cbow)
                else:
                    codes = self._codes[target]
                    points = self._points[target]
                    L = self._lengths[target]
                    cmask = (np.arange(codes.shape[1])[None, :]
                             < L[:, None]).astype(np.float32)
                    self.params, _ = _learning.hs_step(
                        self.params, *self._to_device(
                            center, codes, points, cmask, ctx, ctx_mask),
                        np.float32(lr), cbow=self.use_cbow)
                step_i += 1
            if approx_total is None:
                approx_total = max(step_i * self.epochs, 1)

    def _draw_negatives(self, rng, target: np.ndarray) -> np.ndarray:
        K = self.negative
        draws = self._neg_table[
            rng.integers(0, len(self._neg_table), size=(len(target), K))]
        # avoid sampling the positive target (word2vec redraws; we remap to a
        # random other word which is equivalent in expectation)
        clash = draws == target[:, None]
        if clash.any():
            draws = np.where(clash, (draws + 1) % self.vocab.num_words(), draws)
        return draws.astype(np.int32)

    # ------------------------------------------------------------------
    # lookup API (parity: WordVectors/BasicModelUtils)
    # ------------------------------------------------------------------

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """A host f32 copy (never a view of a table the next step updates
        in place)."""
        return t.detach().to("cpu", copy=True).numpy()

    def _syn0(self) -> np.ndarray:
        return self._host(self.params["syn0"][:self.vocab.num_words()])

    def _normed(self) -> np.ndarray:
        if self._syn0_normed is None:
            s = self._syn0()
            n = np.linalg.norm(s, axis=1, keepdims=True)
            self._syn0_normed = s / np.maximum(n, 1e-12)
        return self._syn0_normed

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.index_of(word) >= 0

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self._syn0()[i]

    def similarity(self, a: str, b: str) -> float:
        ia, ib = self.vocab.index_of(a), self.vocab.index_of(b)
        if ia < 0 or ib < 0:
            return float("nan")
        n = self._normed()
        return float(n[ia] @ n[ib])

    def words_nearest(self, word_or_vec, top: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            i = self.vocab.index_of(word_or_vec)
            if i < 0:
                return []
            vec = self._normed()[i]
            exclude = {i}
        else:
            vec = np.asarray(word_or_vec, dtype=np.float32)
            vec = vec / max(np.linalg.norm(vec), 1e-12)
            exclude = set()
        sims = self._normed() @ vec
        order = np.argsort(-sims)
        out = []
        for j in order:
            if j in exclude:
                continue
            out.append(self.vocab.word_for(int(j)))
            if len(out) >= top:
                break
        return out
