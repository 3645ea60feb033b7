"""Vocabulary: word cache, constructor scan, Huffman coding (a copy of the
JAX package's ``nlp/vocab.py``, host numpy code: the same indices, counts,
codes, points and lengths bit for bit).

Parity: reference ``models/word2vec/wordstore/inmemory/AbstractCache.java``
(word↔index, frequencies, min-frequency filtering),
``VocabConstructor.java`` (corpus scan), ``models/word2vec/Huffman.java``
(codes/points for hierarchical softmax).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class VocabWord:
    word: str
    count: int = 0
    index: int = -1
    # hierarchical-softmax path (filled by Huffman.apply)
    codes: Tuple[int, ...] = ()
    points: Tuple[int, ...] = ()


class VocabCache:
    """In-memory vocab (parity: ``AbstractCache``)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0

    def add_token(self, word: str, count: int = 1) -> None:
        vw = self._words.get(word)
        if vw is None:
            self._words[word] = VocabWord(word=word, count=count)
        else:
            vw.count += count
        self.total_word_count += count

    def finalize(self, min_word_frequency: int = 1,
                 limit: Optional[int] = None) -> None:
        """Drop rare words, assign indices by descending frequency.
        total_word_count shrinks to the RETAINED words' counts (word2vec
        convention — subsampling frequencies are relative to kept words)."""
        kept = [w for w in self._words.values()
                if w.count >= min_word_frequency]
        kept.sort(key=lambda w: (-w.count, w.word))
        if limit is not None:
            kept = kept[:limit]
        self._words = {w.word: w for w in kept}
        self._by_index = kept
        for i, w in enumerate(kept):
            w.index = i
        self.total_word_count = sum(w.count for w in kept)

    # -- lookups --
    def has_token(self, word: str) -> bool:
        return word in self._words

    def word_for(self, index: int) -> str:
        return self._by_index[index].word

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw is not None else -1

    def word_frequency(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.count if vw else 0

    def num_words(self) -> int:
        return len(self._by_index)

    def words(self) -> List[str]:
        return [w.word for w in self._by_index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def counts_array(self) -> np.ndarray:
        return np.array([w.count for w in self._by_index], dtype=np.int64)


class VocabConstructor:
    """Corpus scan → finalized VocabCache (parity: ``VocabConstructor``)."""

    def __init__(self, min_word_frequency: int = 1,
                 limit: Optional[int] = None):
        self.min_word_frequency = min_word_frequency
        self.limit = limit

    def build(self, token_sequences: Iterable[List[str]]) -> VocabCache:
        cache = VocabCache()
        for seq in token_sequences:
            for tok in seq:
                cache.add_token(tok)
        cache.finalize(self.min_word_frequency, self.limit)
        return cache


class Huffman:
    """Huffman tree over word frequencies → (codes, points) per word for
    hierarchical softmax (parity: ``Huffman.java``). ``points`` index the
    inner-node parameter table (size vocab-1)."""

    MAX_CODE_LENGTH = 40

    def __init__(self, vocab: VocabCache):
        self.vocab = vocab

    def apply(self) -> int:
        """Fill codes/points on every VocabWord. Returns max code length."""
        words = self.vocab.vocab_words()
        n = len(words)
        if n == 0:
            return 0
        if n == 1:
            words[0].codes, words[0].points = (0,), (0,)
            return 1
        # heap of (count, tie, node_id); leaves are 0..n-1, inner n..2n-2
        heap: List[Tuple[int, int, int]] = [
            (w.count, i, i) for i, w in enumerate(words)]
        heapq.heapify(heap)
        parent = {}
        binary = {}
        next_id = n
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            parent[n1], parent[n2] = next_id, next_id
            binary[n1], binary[n2] = 0, 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = next_id - 1
        max_len = 0
        for i, w in enumerate(words):
            code, points = [], []
            node = i
            while node != root:
                code.append(binary[node])
                points.append(parent[node] - n)  # inner-node param index
                node = parent[node]
            code.reverse()
            points.reverse()
            w.codes = tuple(code)
            w.points = tuple(points)
            max_len = max(max_len, len(code))
        return max_len

    def padded_tables(self, max_len: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(codes [V, L], points [V, L], lengths [V]) padded int arrays for
        the vectorized HS training step."""
        words = self.vocab.vocab_words()
        L = max_len or max((len(w.codes) for w in words), default=0)
        V = len(words)
        codes = np.zeros((V, L), dtype=np.int32)
        points = np.zeros((V, L), dtype=np.int32)
        lengths = np.zeros((V,), dtype=np.int32)
        for i, w in enumerate(words):
            l = min(len(w.codes), L)
            codes[i, :l] = w.codes[:l]
            points[i, :l] = w.points[:l]
            lengths[i] = l
        return codes, points, lengths
