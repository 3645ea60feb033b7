"""Sentence iterators (a copy of the JAX package's
``nlp/sentence_iterator.py``, host code; parity: reference
``text/sentenceiterator/`` — ``BasicLineIterator``,
``CollectionSentenceIterator``, ``FileSentenceIterator``,
``LineSentenceIterator`` + preprocessors)."""

from __future__ import annotations

import os
from typing import Callable, Iterable, Iterator, List, Optional


class SentenceIterator:
    """Streaming sentence source with reset semantics."""

    def __init__(self, preprocessor: Optional[Callable[[str], str]] = None):
        self.preprocessor = preprocessor

    def _raw(self) -> Iterator[str]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        for s in self._raw():
            s = s.strip()
            if not s:
                continue
            yield self.preprocessor(s) if self.preprocessor else s

    def reset(self) -> None:
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str], preprocessor=None):
        super().__init__(preprocessor)
        self.sentences = list(sentences)

    def _raw(self) -> Iterator[str]:
        return iter(self.sentences)


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a text file (parity: ``BasicLineIterator``)."""

    def __init__(self, path: str, preprocessor=None, encoding: str = "utf-8"):
        super().__init__(preprocessor)
        self.path = path
        self.encoding = encoding

    def _raw(self) -> Iterator[str]:
        with open(self.path, "r", encoding=self.encoding) as f:
            for line in f:
                yield line


class FileSentenceIterator(SentenceIterator):
    """Every file under a directory, one sentence per line (parity:
    ``FileSentenceIterator``)."""

    def __init__(self, directory: str, preprocessor=None,
                 encoding: str = "utf-8"):
        super().__init__(preprocessor)
        self.directory = directory
        self.encoding = encoding

    def _raw(self) -> Iterator[str]:
        for root, _, files in os.walk(self.directory):
            for name in sorted(files):
                with open(os.path.join(root, name), "r",
                          encoding=self.encoding, errors="replace") as f:
                    for line in f:
                        yield line
