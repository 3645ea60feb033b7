"""Bag-of-words / TF-IDF text vectorizers (a copy of the JAX package's
``nlp/vectorizers.py``, host numpy code, over the port's
``datasets.DataSet``).

Parity: reference ``bagofwords/vectorizer/`` — ``TextVectorizer`` interface
(``TextVectorizer.java:35``: fit → vocab, ``transform(text)`` → vector,
``vectorize(text, label)`` → DataSet), ``BagOfWordsVectorizer.java`` (raw
counts) and ``TfidfVectorizer.java`` (count × idf weighting, idf from
document frequencies).

Vectorization is host-side ETL (numpy); the output feeds
``MultiLayerNetwork.fit`` as dense [docs, vocab] arrays, as in the
reference.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..datasets.dataset import DataSet
from .documents import LabelAwareIterator, LabelsSource
from .tokenization import DefaultTokenizerFactory, TokenizerFactory


class TextVectorizer:
    """Shared fit/transform machinery (parity: ``BaseTextVectorizer.java``).

    fit() builds the vocabulary (min_word_frequency filter, stop words) and
    document frequencies from a LabelAwareIterator or an iterable of strings.
    """

    def __init__(self, *, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1,
                 stop_words: Optional[Iterable[str]] = None):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = max(1, int(min_word_frequency))
        self.stop_words = frozenset(stop_words or ())
        self.vocab: Dict[str, int] = {}
        self.doc_freq: Dict[str, int] = {}
        self.n_docs = 0
        self.labels_source = LabelsSource()

    # ------------------------------------------------------------------

    def _tokens(self, text: str) -> List[str]:
        toks = self.tokenizer_factory.create(text).get_tokens()
        return [t for t in toks if t and t not in self.stop_words]

    def _documents(self, source):
        if isinstance(source, LabelAwareIterator):
            self.labels_source = source.labels_source
            for doc in source:
                yield doc.content
        else:
            for item in source:
                if hasattr(item, "content"):
                    for l in item.labels:
                        self.labels_source.store_label(l)
                    yield item.content
                else:
                    yield item

    def fit(self, source) -> "TextVectorizer":
        counts: Counter = Counter()
        dfs: Counter = Counter()
        n = 0
        for content in self._documents(source):
            toks = self._tokens(content)
            counts.update(toks)
            dfs.update(set(toks))
            n += 1
        self.n_docs = n
        words = sorted(w for w, c in counts.items()
                       if c >= self.min_word_frequency)
        self.vocab = {w: i for i, w in enumerate(words)}
        self.doc_freq = {w: dfs[w] for w in words}
        return self

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def index_of(self, word: str) -> int:
        return self.vocab.get(word, -1)

    # ------------------------------------------------------------------

    def _weight(self, count: int, word: str, doc_len: int) -> float:
        raise NotImplementedError

    def transform(self, text: str) -> np.ndarray:
        """One text → [vocab] weight vector (parity: ``transform``)."""
        if not self.vocab:
            raise ValueError("call fit() first")
        toks = self._tokens(text)
        out = np.zeros((self.vocab_size,), dtype=np.float32)
        for w, c in Counter(toks).items():
            i = self.vocab.get(w, -1)
            if i >= 0:
                out[i] = self._weight(c, w, len(toks))
        return out

    def transform_documents(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.transform(t) for t in texts])

    def vectorize(self, text: str, label: str) -> DataSet:
        """text + label → DataSet row (parity: ``vectorize(String, String)``,
        ``TfidfVectorizer.java:66``)."""
        x = self.transform(text)[None, :]
        idx = self.labels_source.index_of(label)
        if idx < 0:
            self.labels_source.store_label(label)
            idx = self.labels_source.index_of(label)
        y = np.zeros((1, max(1, self.labels_source.size())), dtype=np.float32)
        y[0, idx] = 1.0
        return DataSet(x, y)

    def fit_transform(self, source) -> DataSet:
        """Fit on a LabelAwareIterator and return the full [docs, vocab] /
        [docs, labels] design matrix as one DataSet."""
        docs: List[str] = []
        labels: List[Optional[str]] = []
        if isinstance(source, LabelAwareIterator):
            self.labels_source = source.labels_source
            for d in source:
                docs.append(d.content)
                labels.append(d.label)
        else:
            for item in source:
                if hasattr(item, "content"):
                    docs.append(item.content)
                    labels.append(item.label)
                    for l in item.labels:
                        self.labels_source.store_label(l)
                else:
                    docs.append(item)
                    labels.append(None)
        self.fit(docs)
        x = self.transform_documents(docs)
        n_lab = max(1, self.labels_source.size())
        y = np.zeros((len(docs), n_lab), dtype=np.float32)
        for r, l in enumerate(labels):
            if l is not None:
                y[r, self.labels_source.index_of(l)] = 1.0
        return DataSet(x, y)


class BagOfWordsVectorizer(TextVectorizer):
    """Raw term counts (parity: ``BagOfWordsVectorizer.java``)."""

    def _weight(self, count: int, word: str, doc_len: int) -> float:
        return float(count)


class TfidfVectorizer(TextVectorizer):
    """count × idf weighting, idf = log(n_docs / df) (parity:
    ``TfidfVectorizer.java`` via ``MathUtils.idf``; +1 smoothing guards
    unseen/degenerate df)."""

    def idf(self, word: str) -> float:
        df = self.doc_freq.get(word, 0)
        if df == 0 or self.n_docs == 0:
            return 0.0
        return math.log(self.n_docs / df) + 1.0

    def _weight(self, count: int, word: str, doc_len: int) -> float:
        return float(count) * self.idf(word)
