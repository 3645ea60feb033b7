"""Label-aware document iteration (the doc2vec / supervised-text ETL seam).

Parity: reference ``text/documentiterator/`` — ``LabelledDocument``,
``LabelsSource`` (auto-generated or declared label sets,
``LabelsSource.java:16-117``), ``LabelAwareIterator`` and its
implementations (``BasicLabelAwareIterator``, ``SimpleLabelAwareIterator``,
``FileLabelAwareIterator``, ``FilenamesLabelAwareIterator``,
``AsyncLabelAwareIterator``) plus the plain ``FileDocumentIterator``.

Host-side ETL: pure Python/queue code, a copy of the JAX package's
``nlp/documents.py`` (the device never sees strings); feeds
ParagraphVectors and the vectorizers (:mod:`.vectorizers`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterable, Iterator, List, Optional


@dataclasses.dataclass
class LabelledDocument:
    """One document with its label(s) (parity: ``LabelledDocument.java``)."""

    content: str
    labels: List[str] = dataclasses.field(default_factory=list)

    @property
    def label(self) -> Optional[str]:
        return self.labels[0] if self.labels else None


class LabelsSource:
    """Label bookkeeping: declared list or generated from a template
    (parity: ``LabelsSource.java`` — ``%d`` template → DOC_0, DOC_1, ...)."""

    def __init__(self, labels: Optional[List[str]] = None,
                 template: Optional[str] = None):
        self.template = template
        self._labels: List[str] = list(labels) if labels else []
        self._index = {l: i for i, l in enumerate(self._labels)}
        self._counter = 0

    def next_label(self) -> str:
        if self.template is None:
            raise ValueError("next_label() needs a template LabelsSource")
        label = (self.template % self._counter if "%" in self.template
                 else f"{self.template}{self._counter}")
        self._counter += 1
        self.store_label(label)
        return label

    def store_label(self, label: str) -> None:
        if label not in self._index:
            self._index[label] = len(self._labels)
            self._labels.append(label)

    def index_of(self, label: str) -> int:
        return self._index.get(label, -1)

    @property
    def labels(self) -> List[str]:
        return list(self._labels)

    def size(self) -> int:
        return len(self._labels)

    def reset(self) -> None:
        self._counter = 0


class LabelAwareIterator:
    """Iterator of :class:`LabelledDocument` (parity:
    ``LabelAwareIterator.java``)."""

    labels_source: LabelsSource

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_document(self) -> LabelledDocument:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[LabelledDocument]:
        self.reset()
        while self.has_next():
            yield self.next_document()


class SimpleLabelAwareIterator(LabelAwareIterator):
    """Over an in-memory collection of LabelledDocuments (parity:
    ``SimpleLabelAwareIterator.java``)."""

    def __init__(self, documents: Iterable[LabelledDocument]):
        self._docs = list(documents)
        self.labels_source = LabelsSource()
        for d in self._docs:
            for l in d.labels:
                self.labels_source.store_label(l)
        self._cursor = 0

    def has_next(self) -> bool:
        return self._cursor < len(self._docs)

    def next_document(self) -> LabelledDocument:
        if not self.has_next():
            raise StopIteration
        d = self._docs[self._cursor]
        self._cursor += 1
        return d

    def reset(self) -> None:
        self._cursor = 0


class BasicLabelAwareIterator(LabelAwareIterator):
    """Wraps a sentence iterator, assigning generated labels (parity:
    ``BasicLabelAwareIterator.java`` — the doc2vec default where every
    sentence is a document labelled DOC_n)."""

    def __init__(self, sentences: Iterable[str],
                 label_template: str = "DOC_%d"):
        self._sentences = sentences
        self.labels_source = LabelsSource(template=label_template)
        self._iter: Optional[Iterator[str]] = None
        self._peek: Optional[str] = None

    def _ensure(self) -> None:
        if self._iter is None:
            if hasattr(self._sentences, "reset"):
                self._sentences.reset()
            self._iter = iter(self._sentences)

    def has_next(self) -> bool:
        self._ensure()
        if self._peek is None:
            self._peek = next(self._iter, None)
        return self._peek is not None

    def next_document(self) -> LabelledDocument:
        if not self.has_next():
            raise StopIteration
        content, self._peek = self._peek, None
        return LabelledDocument(content=content,
                                labels=[self.labels_source.next_label()])

    def reset(self) -> None:
        self._iter = None
        self._peek = None
        self.labels_source.reset()


class FileLabelAwareIterator(LabelAwareIterator):
    """Directory layout ``root/<label>/<file>`` → one document per file,
    labelled by its parent dir (parity: ``FileLabelAwareIterator.java``)."""

    def __init__(self, root: str, encoding: str = "utf-8"):
        self.root = Path(root)
        self.encoding = encoding
        self._files: List[Path] = sorted(
            p for p in self.root.glob("*/*") if p.is_file())
        self.labels_source = LabelsSource()
        for p in self._files:
            self.labels_source.store_label(p.parent.name)
        self._cursor = 0

    def has_next(self) -> bool:
        return self._cursor < len(self._files)

    def next_document(self) -> LabelledDocument:
        if not self.has_next():
            raise StopIteration
        p = self._files[self._cursor]
        self._cursor += 1
        return LabelledDocument(content=p.read_text(self.encoding),
                                labels=[p.parent.name])

    def reset(self) -> None:
        self._cursor = 0


class FilenamesLabelAwareIterator(LabelAwareIterator):
    """One document per file, labelled by the FILENAME (parity:
    ``FilenamesLabelAwareIterator.java``)."""

    def __init__(self, files: Iterable[str], encoding: str = "utf-8",
                 absolute_labels: bool = False):
        self._files = [Path(f) for f in files]
        self.encoding = encoding
        self.absolute_labels = absolute_labels
        self.labels_source = LabelsSource()
        for p in self._files:
            self.labels_source.store_label(self._label_of(p))
        self._cursor = 0

    def _label_of(self, p: Path) -> str:
        return str(p) if self.absolute_labels else p.name

    def has_next(self) -> bool:
        return self._cursor < len(self._files)

    def next_document(self) -> LabelledDocument:
        if not self.has_next():
            raise StopIteration
        p = self._files[self._cursor]
        self._cursor += 1
        return LabelledDocument(content=p.read_text(self.encoding),
                                labels=[self._label_of(p)])

    def reset(self) -> None:
        self._cursor = 0


class AsyncLabelAwareIterator(LabelAwareIterator):
    """Background-thread prefetch over any LabelAwareIterator (parity:
    ``AsyncLabelAwareIterator.java`` — same producer/queue design as
    AsyncDataSetIterator)."""

    _SENTINEL = object()

    def __init__(self, base: LabelAwareIterator, buffer_size: int = 64):
        self.base = base
        self.labels_source = base.labels_source
        self.buffer_size = max(1, int(buffer_size))
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        self._error: Optional[BaseException] = None
        self._peek = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start()

    def _producer(self, stop: threading.Event, q: "queue.Queue") -> None:
        try:
            while not stop.is_set() and self.base.has_next():
                doc = self.base.next_document()
                while True:
                    try:
                        q.put(doc, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            return
        except BaseException as e:
            self._error = e
        finally:
            if stop.is_set():
                # reset() already drained and abandoned this queue
                try:
                    q.put_nowait(self._SENTINEL)
                except queue.Full:
                    pass
            else:
                q.put(self._SENTINEL)

    def _start(self) -> None:
        self._thread = threading.Thread(
            target=self._producer, args=(self._stop, self._queue), daemon=True)
        self._thread.start()

    def has_next(self) -> bool:
        if self._peek is None:
            self._peek = self._queue.get()
        if self._peek is self._SENTINEL:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            return False
        return True

    def next_document(self) -> LabelledDocument:
        if not self.has_next():
            raise StopIteration
        out, self._peek = self._peek, None
        return out

    def reset(self) -> None:
        # signal the producer to stop (no full-corpus drain — code review r4),
        # unblock it, and restart on a reset base with a fresh queue
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                # a stale producer still touching the shared base iterator
                # would race the restarted one — refuse to double-consume
                raise RuntimeError(
                    "async producer did not stop within 5s; cannot safely "
                    "reset while it may still consume the base iterator")
        self._peek = None
        self._error = None
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self.buffer_size)
        self.base.reset()
        self._start()


class FileDocumentIterator:
    """Plain (label-free) document iterator over files in a directory
    (parity: ``FileDocumentIterator.java``)."""

    def __init__(self, root: str, encoding: str = "utf-8"):
        self.root = Path(root)
        self.encoding = encoding
        self._files = sorted(p for p in self.root.rglob("*") if p.is_file())
        self._cursor = 0

    def has_next(self) -> bool:
        return self._cursor < len(self._files)

    def next_document(self) -> str:
        if not self.has_next():
            raise StopIteration
        p = self._files[self._cursor]
        self._cursor += 1
        return p.read_text(self.encoding)

    def reset(self) -> None:
        self._cursor = 0

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_document()
