"""Record readers: the ETL entry point (DataVec analog).

Parity: the reference consumes the external DataVec library through
``deeplearning4j-core/.../datasets/datavec/RecordReaderDataSetIterator.java``;
the reader contracts mirrored here are DataVec's ``RecordReader`` /
``SequenceRecordReader`` (``next()`` returning a list of Writables,
``hasNext``, ``reset``, per-record ``RecordMetaData``).

Counterpart of the JAX package's ``datavec/readers.py``: a "record" is a
plain Python list whose entries are numbers, strings (coerced lazily), or
``np.ndarray`` (the NDArrayWritable analog) — no Writable class
hierarchy. Readers do host-side IO only; batch assembly into numpy arrays
happens in ``datavec.iterator``.
"""

from __future__ import annotations

import csv
import io
import os
from typing import Iterable, List, NamedTuple, Optional, Sequence

import numpy as np


class RecordMetaData(NamedTuple):
    """Provenance of one record (parity: DataVec ``RecordMetaData`` —
    location + source URI, used by the reference's ``loadFromMetaData``)."""

    index: int
    source: str

    def location(self) -> str:
        return f"{self.source}:{self.index}"


class RecordReader:
    """One flat record per ``next_record()`` call.

    Contract parity: DataVec ``RecordReader`` (``next``/``hasNext``/``reset``);
    ``load_from_metadata`` mirrors ``RecordReaderMetaData`` record recovery.
    """

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_record(self) -> List:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def record_metadata(self) -> Optional[RecordMetaData]:
        """Metadata of the record most recently returned by next_record()."""
        return None

    def load_from_metadata(self, meta: Sequence[RecordMetaData]) -> List[List]:
        raise NotImplementedError(
            f"{type(self).__name__} does not support metadata record loading")

    # Seekable cursor protocol (optional — probed via the presence of the
    # methods, see ``util.durable.is_seekable``): ``state() -> dict`` /
    # ``restore(state)`` reproduce the remaining record stream exactly on
    # an equivalently constructed reader. Every in-tree reader implements
    # it; a custom reader without a cursor simply leaves them undefined.

    @property
    def labels(self) -> Optional[List[str]]:
        """Declared class-label ordering, if the source provides one."""
        return getattr(self, "_declared_labels", None)

    @labels.setter
    def labels(self, value: Optional[List[str]]) -> None:
        self._declared_labels = None if value is None else list(value)

    def __iter__(self):
        while self.has_next():
            yield self.next_record()


class SequenceRecordReader(RecordReader):
    """One sequence (list of timestep records) per ``next_sequence()``."""

    def next_sequence(self) -> List[List]:
        raise NotImplementedError


def _parse_value(v):
    """Coerce a CSV field to float when numeric; keep strings otherwise."""
    if isinstance(v, str):
        s = v.strip()
        try:
            return float(s)
        except ValueError:
            return s
    return v


class CSVRecordReader(RecordReader):
    """CSV file/strings → records (parity: DataVec ``CSVRecordReader``).

    ``skip_lines`` drops header rows; ``delimiter`` defaults to ','. Numeric
    fields parse to float, everything else stays a string (converted or
    one-hot-mapped downstream by the iterators).
    """

    def __init__(self, path: Optional[str] = None, skip_lines: int = 0,
                 delimiter: str = ",", lines: Optional[Iterable[str]] = None):
        if (path is None) == (lines is None):
            raise ValueError("provide exactly one of path= or lines=")
        self.path = path
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter
        self._lines = None if lines is None else list(lines)
        self._records: List[List] = []
        self._cursor = 0
        self._load()

    def _load(self) -> None:
        from . import native as _native
        if self._lines is not None:
            raw = self._lines
            body = raw[self.skip_lines:]
            # skip by LIST ELEMENT (an element may hold embedded newlines) —
            # so the native path always sees pre-skipped content
            native_input = ("\n".join(body), 0)
        else:
            with open(self.path, "r", newline="") as f:
                text = f.read()
            raw = text.splitlines()
            body = raw[self.skip_lines:]
            native_input = (text, self.skip_lines)
        # fast path: strictly numeric rectangular CSV parses in the native
        # kernel (GIL released); strings/ragged rows fall back to Python csv
        if _native.load() is not None:
            src, skip = native_input
            mat = _native.parse_numeric_csv(src.encode(), self.delimiter,
                                            skip)
            if mat is not None:
                self._records = mat.tolist()
                return
        reader = csv.reader(io.StringIO("\n".join(body)),
                            delimiter=self.delimiter)
        self._records = [[_parse_value(v) for v in row]
                         for row in reader if row]

    @property
    def source(self) -> str:
        return self.path if self.path is not None else "<memory>"

    def has_next(self) -> bool:
        return self._cursor < len(self._records)

    def next_record(self) -> List:
        if not self.has_next():
            raise StopIteration
        rec = self._records[self._cursor]
        self._cursor += 1
        return list(rec)

    def record_metadata(self) -> RecordMetaData:
        return RecordMetaData(self._cursor - 1, self.source)

    def load_from_metadata(self, meta: Sequence[RecordMetaData]) -> List[List]:
        return [list(self._records[m.index]) for m in meta]

    def reset(self) -> None:
        self._cursor = 0

    def state(self) -> dict:
        return {"cursor": int(self._cursor)}

    def restore(self, state: dict) -> None:
        self._cursor = int(state["cursor"])

    def __len__(self) -> int:
        return len(self._records)


class CollectionRecordReader(RecordReader):
    """In-memory records (parity: DataVec ``CollectionRecordReader``)."""

    def __init__(self, records: Iterable[Sequence]):
        self._records = [list(r) for r in records]
        self._cursor = 0

    def has_next(self) -> bool:
        return self._cursor < len(self._records)

    def next_record(self) -> List:
        if not self.has_next():
            raise StopIteration
        rec = self._records[self._cursor]
        self._cursor += 1
        return list(rec)

    def record_metadata(self) -> RecordMetaData:
        return RecordMetaData(self._cursor - 1, "<collection>")

    def load_from_metadata(self, meta: Sequence[RecordMetaData]) -> List[List]:
        return [list(self._records[m.index]) for m in meta]

    def reset(self) -> None:
        self._cursor = 0

    def state(self) -> dict:
        return {"cursor": int(self._cursor)}

    def restore(self, state: dict) -> None:
        self._cursor = int(state["cursor"])

    def __len__(self) -> int:
        return len(self._records)


class LineRecordReader(RecordReader):
    """One raw line per record (parity: DataVec ``LineRecordReader``)."""

    def __init__(self, path: Optional[str] = None,
                 lines: Optional[Iterable[str]] = None):
        if (path is None) == (lines is None):
            raise ValueError("provide exactly one of path= or lines=")
        if path is not None:
            with open(path, "r") as f:
                self._lines = f.read().splitlines()
        else:
            self._lines = list(lines)
        self.path = path
        self._cursor = 0

    def has_next(self) -> bool:
        return self._cursor < len(self._lines)

    def next_record(self) -> List:
        if not self.has_next():
            raise StopIteration
        line = self._lines[self._cursor]
        self._cursor += 1
        return [line]

    def record_metadata(self) -> RecordMetaData:
        return RecordMetaData(self._cursor - 1, self.path or "<memory>")

    def reset(self) -> None:
        self._cursor = 0

    def state(self) -> dict:
        return {"cursor": int(self._cursor)}

    def restore(self, state: dict) -> None:
        self._cursor = int(state["cursor"])


class CSVSequenceRecordReader(SequenceRecordReader):
    """Sequences from CSV: one file per sequence, or in-memory groups
    (parity: DataVec ``CSVSequenceRecordReader`` — each file is a time
    series, one row per timestep).
    """

    def __init__(self, paths: Optional[Sequence[str]] = None,
                 skip_lines: int = 0, delimiter: str = ",",
                 sequences: Optional[Sequence[Sequence[Sequence]]] = None):
        if (paths is None) == (sequences is None):
            raise ValueError("provide exactly one of paths= or sequences=")
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter
        if sequences is not None:
            self._sequences = [[list(step) for step in seq]
                               for seq in sequences]
            self._sources = ["<memory>"] * len(self._sequences)
        else:
            self._sequences = []
            self._sources = []
            for p in paths:
                rr = CSVRecordReader(path=p, skip_lines=skip_lines,
                                     delimiter=delimiter)
                self._sequences.append(list(rr))
                self._sources.append(p)
        self._cursor = 0
        self._flat_seq: Optional[List[List]] = None
        self._flat_step = 0

    def has_next(self) -> bool:
        if self._flat_seq is not None and self._flat_step < len(self._flat_seq):
            return True
        # flat-contract accuracy: only count remaining sequences that hold at
        # least one timestep, so next_record() never raises after
        # has_next()==True when empty sequences trail
        return any(len(self._sequences[i]) > 0
                   for i in range(self._cursor, len(self._sequences)))

    def next_sequence(self) -> List[List]:
        if self._cursor >= len(self._sequences):
            raise StopIteration
        seq = self._sequences[self._cursor]
        self._cursor += 1
        self._flat_read = False
        return [list(s) for s in seq]

    def next_record(self) -> List:
        """Flat RecordReader view: ONE timestep at a time, walking each
        sequence in order — so this reader also composes with the flat
        RecordReaderDataSetIterator contract."""
        while self._flat_seq is None or self._flat_step >= len(self._flat_seq):
            self._flat_seq = self.next_sequence()
            self._flat_step = 0
        self._flat_read = True
        step = self._flat_seq[self._flat_step]
        self._flat_step += 1
        return list(step)

    def record_metadata(self) -> Optional[RecordMetaData]:
        # metadata here addresses whole SEQUENCES (load_from_metadata returns
        # sequences); a flat timestep read has no per-record address, so it
        # reports no metadata rather than an ambiguous/crashing one
        if getattr(self, "_flat_read", False):
            return None
        return RecordMetaData(self._cursor - 1,
                              self._sources[self._cursor - 1])

    def load_from_metadata(self, meta) -> List[List[List]]:
        return [[list(s) for s in self._sequences[m.index]] for m in meta]

    def reset(self) -> None:
        self._cursor = 0
        self._flat_seq = None
        self._flat_step = 0
        self._flat_read = False

    def state(self) -> dict:
        # the flat view's mid-sequence position rides along; _flat_seq
        # itself is derived (sequences[cursor-1]) so only indices persist
        return {"cursor": int(self._cursor),
                "flat_step": (None if self._flat_seq is None
                              else int(self._flat_step)),
                "flat_read": bool(getattr(self, "_flat_read", False))}

    def restore(self, state: dict) -> None:
        self._cursor = int(state["cursor"])
        if state.get("flat_step") is None:
            self._flat_seq, self._flat_step = None, 0
        else:
            self._flat_seq = [list(s)
                              for s in self._sequences[self._cursor - 1]]
            self._flat_step = int(state["flat_step"])
        self._flat_read = bool(state.get("flat_read", False))

    def __len__(self) -> int:
        return len(self._sequences)


class CollectionSequenceRecordReader(CSVSequenceRecordReader):
    """In-memory sequence records (parity: DataVec
    ``CollectionSequenceRecordReader``)."""

    def __init__(self, sequences: Sequence[Sequence[Sequence]]):
        super().__init__(sequences=sequences)
