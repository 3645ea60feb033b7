"""In-memory inverted index: word → posting list of document ids (a copy
of the JAX package's ``nlp/inverted_index.py``, host code).

Parity: reference ``text/invertedindex/InvertedIndex.java:35`` — the
contract behind corpus sampling and doc retrieval (``document(index)``,
``documents(word)``, ``numDocuments()``, ``addWordsToDoc``, batch/sample
iteration). The reference's only in-tree impl was Lucene-backed; this is a
dependency-free postings map with the same surface.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class InvertedIndex:
    """Postings over tokenized documents."""

    def __init__(self):
        self._docs: List[List[str]] = []
        self._postings: Dict[str, List[int]] = {}

    # ------------------------------------------------------------------
    # construction (parity: addWordsToDoc / addWordToDoc)
    # ------------------------------------------------------------------

    def add_words_to_doc(self, doc_id: Optional[int],
                         words: Sequence[str]) -> int:
        """Append a document (or extend an existing id); returns the doc id."""
        if doc_id is None or doc_id >= len(self._docs):
            doc_id = len(self._docs)
            self._docs.append([])
        doc = self._docs[doc_id]
        for w in words:
            doc.append(w)
            plist = self._postings.setdefault(w, [])
            # keep postings sorted + unique even when an earlier doc is
            # re-extended after newer docs exist (code review r4)
            i = bisect.bisect_left(plist, doc_id)
            if i >= len(plist) or plist[i] != doc_id:
                plist.insert(i, doc_id)
        return doc_id

    def add_word_to_doc(self, doc_id: int, word: str) -> None:
        self.add_words_to_doc(doc_id if doc_id < len(self._docs) else None,
                              [word])

    # ------------------------------------------------------------------
    # retrieval (parity: document / documents / numDocuments / allDocs)
    # ------------------------------------------------------------------

    def document(self, index: int) -> List[str]:
        return list(self._docs[index])

    def documents(self, word: str) -> List[int]:
        """Posting list: ids of documents containing the word."""
        return list(self._postings.get(word, ()))

    def num_documents(self) -> int:
        return len(self._docs)

    def num_documents_containing(self, word: str) -> int:
        return len(self._postings.get(word, ()))

    def all_docs(self) -> Iterator[List[str]]:
        for d in self._docs:
            yield list(d)

    def total_words(self) -> int:
        return sum(len(d) for d in self._docs)

    # ------------------------------------------------------------------
    # sampling (parity: the batch/sample methods backing corpus iteration)
    # ------------------------------------------------------------------

    def sample_docs(self, n: int, seed: Optional[int] = None) -> List[int]:
        """n document ids sampled without replacement (or all, if fewer)."""
        rng = np.random.default_rng(seed)
        total = len(self._docs)
        if n >= total:
            return list(range(total))
        return list(rng.choice(total, size=n, replace=False))

    def batches(self, batch_size: int) -> Iterator[List[List[str]]]:
        """Documents in fixed-size batches (last may be short)."""
        for i in range(0, len(self._docs), batch_size):
            yield [list(d) for d in self._docs[i:i + batch_size]]

    def eachdoc(self, fn) -> None:
        """Apply fn(tokens, doc_id) to every document (parity: eachDoc)."""
        for i, d in enumerate(self._docs):
            fn(list(d), i)
