"""RecordReader → DataSet/MultiDataSet iterators (the ETL bridge).

Parity: ``deeplearning4j-core/.../datasets/datavec/RecordReaderDataSetIterator.java:1-417``
(classification one-hot, multi-output regression, NDArray writables, max
batches, metadata collection), ``SequenceRecordReaderDataSetIterator.java``
(single- and dual-reader modes, ``AlignmentMode`` EQUAL_LENGTH / ALIGN_START /
ALIGN_END with masking) and ``RecordReaderMultiDataSetIterator.java``
(named-input builder over multiple readers).

Counterpart of the JAX package's ``datavec/iterator.py``: batches are
dense numpy arrays, which the fit loop stages onto the net's device
(``util.ingest``); sequences use the framework's ``[batch, time,
features]`` layout (the reference uses ``[batch, features, time]``; both
packages keep the feature axis contiguous) with 0/1 masks for ragged
lengths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..datasets.dataset import DataSet, MultiDataSet
from ..datasets.iterator import DataSetIterator
from .readers import RecordMetaData, RecordReader, SequenceRecordReader


def _reader_seekable(reader) -> bool:
    """Both halves of the cursor protocol: a reader with state() but no
    restore() must not be reported seekable — the failure would otherwise
    surface as an AttributeError at resume time. Delegates to the one
    shared probe so the protocol cannot drift between call sites."""
    from ..util.durable import is_seekable
    return is_seekable(reader)


def _to_float(v, label_map: Optional[Dict[str, int]] = None):
    if isinstance(v, str):
        if label_map is not None:
            return float(label_map[v])
        raise ValueError(
            f"non-numeric field {v!r} in a numeric column (string labels "
            "need num_classes so they can be index-mapped)")
    return float(v)


def _flatten_features(values, label_map=None) -> np.ndarray:
    """Record entries → flat float vector; ndarray entries are flattened
    in place (NDArrayWritable parity)."""
    parts = []
    for v in values:
        if isinstance(v, np.ndarray):
            parts.append(v.astype(np.float32).reshape(-1))
        else:
            parts.append(np.asarray([_to_float(v, label_map)],
                                    dtype=np.float32))
    return np.concatenate(parts) if parts else np.zeros((0,), np.float32)


class _LabelMapper:
    """Lazily maps string class labels to indices (stable: reader-declared
    labels first, then first-seen order)."""

    def __init__(self, declared: Optional[List[str]] = None):
        self.map: Dict[str, int] = {}
        if declared:
            for i, name in enumerate(declared):
                self.map[name] = i

    def index(self, v) -> int:
        if isinstance(v, str):
            if v not in self.map:
                self.map[v] = len(self.map)
            return self.map[v]
        return int(v)


class RecordReaderDataSetIterator(DataSetIterator):
    """Flat records → classification/regression DataSets.

    - classification: ``label_index`` column holds the class (int index or
      string name) → one-hot over ``num_classes``.
    - regression: ``label_index``..``label_index_to`` (inclusive) columns are
      the targets (``regression=True``).
    - ``label_index=None``: unsupervised — all columns become features and
      ``labels is features`` (reference behavior for autoencoders).
    - ``collect_metadata``: keep per-example ``RecordMetaData`` so evaluation
      errors can be traced back to source records.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 label_index_to: Optional[int] = None,
                 regression: bool = False,
                 max_num_batches: int = -1,
                 preprocessor=None,
                 collect_metadata: bool = False):
        if regression and label_index_to is None:
            label_index_to = label_index
        if not regression and label_index_to is not None:
            raise ValueError("label_index_to requires regression=True")
        self.reader = reader
        self._batch = int(batch_size)
        self.label_index = label_index
        self.label_index_to = label_index_to
        if (label_index is not None and not regression
                and num_classes is None):
            if reader.labels:
                num_classes = len(reader.labels)
            else:
                raise ValueError(
                    "classification needs num_classes (or a reader that "
                    "declares its label set)")
        self.num_classes = num_classes
        self.regression = regression
        self.max_num_batches = int(max_num_batches)
        self.preprocessor = preprocessor
        self.collect_metadata = collect_metadata
        self._batch_num = 0
        self._mapper = _LabelMapper(reader.labels)
        self.last_metadata: List[RecordMetaData] = []

    @property
    def batch_size(self) -> int:
        return self._batch

    def has_next(self) -> bool:
        if 0 <= self.max_num_batches <= self._batch_num:
            return False
        return self.reader.has_next()

    def _split(self, record: List):
        """One record → (feature values, label values)."""
        if self.label_index is None:
            return record, None
        if self.regression:
            lo, hi = self.label_index, self.label_index_to
            labels = record[lo:hi + 1]
            feats = record[:lo] + record[hi + 1:]
        else:
            labels = [record[self.label_index]]
            feats = (record[:self.label_index]
                     + record[self.label_index + 1:])
        return feats, labels

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        feats, labels, metas = [], [], []
        while self.reader.has_next() and len(feats) < self._batch:
            rec = self.reader.next_record()
            if self.collect_metadata:
                m = self.reader.record_metadata()
                if m is not None:
                    metas.append(m)
            f, l = self._split(rec)
            feats.append(_flatten_features(f))
            if l is not None:
                if self.regression:
                    labels.append(np.asarray(
                        [_to_float(v) for v in l], dtype=np.float32))
                else:
                    idx = self._mapper.index(l[0])
                    n = self.num_classes
                    onehot = np.zeros((n,), dtype=np.float32)
                    if not 0 <= idx < n:
                        raise ValueError(
                            f"label index {idx} out of range [0, {n}) — "
                            "check num_classes / label_index")
                    onehot[idx] = 1.0
                    labels.append(onehot)
        x = np.stack(feats)
        y = x if not labels else np.stack(labels)
        ds = DataSet(x, y)
        if self.collect_metadata:
            ds.example_metadata = list(metas)
            self.last_metadata = list(metas)
        if self.preprocessor is not None:
            ds = self.preprocessor(ds) or ds
        self._batch_num += 1
        return ds

    def load_from_metadata(self, meta: Sequence[RecordMetaData]) -> DataSet:
        """Rebuild a DataSet for specific source records (parity:
        ``loadFromMetaData`` — evaluation-error drill-down)."""
        records = self.reader.load_from_metadata(meta)
        saved = (self.reader, self._batch_num)
        from .readers import CollectionRecordReader
        self.reader = CollectionRecordReader(records)
        self._batch_num = 0
        old_batch = self._batch
        self._batch = max(1, len(records))
        # don't let the temporary CollectionRecordReader's metadata clobber
        # the ongoing iteration's provenance state
        old_collect, old_last = self.collect_metadata, self.last_metadata
        self.collect_metadata = False
        try:
            ds = self.next()
        finally:
            self.reader, self._batch_num = saved
            self._batch = old_batch
            self.collect_metadata, self.last_metadata = old_collect, old_last
        ds.example_metadata = list(meta)
        return ds

    def reset(self) -> None:
        self.reader.reset()
        self._batch_num = 0

    def seekable(self) -> bool:
        return _reader_seekable(self.reader)

    def state(self) -> dict:
        # the lazily grown string→index label map is part of the cursor:
        # without it a resumed run could assign different class indices to
        # labels first seen after the restore point
        return {"batch_num": int(self._batch_num),
                "reader": self.reader.state(),
                "label_map": dict(self._mapper.map)}

    def restore(self, state: dict) -> None:
        self._batch_num = int(state["batch_num"])
        self.reader.restore(state["reader"])
        self._mapper.map = dict(state.get("label_map", {}))


class AlignmentMode:
    EQUAL_LENGTH = "equal_length"
    ALIGN_START = "align_start"
    ALIGN_END = "align_end"


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence records → [batch, time, features] DataSets with masks.

    Two modes (parity: ``SequenceRecordReaderDataSetIterator.java``):

    - single reader: every timestep row carries features + label column
      (``label_index``); classification one-hot or regression per step.
    - dual reader: ``labels_reader`` provides the label sequence separately;
      ``alignment`` pads/aligns when lengths differ (ALIGN_START zero-pads at
      the end, ALIGN_END at the front) and emits 0/1 masks.
    """

    def __init__(self, reader: SequenceRecordReader, batch_size: int,
                 num_classes: Optional[int] = None,
                 label_index: Optional[int] = None,
                 regression: bool = False,
                 labels_reader: Optional[SequenceRecordReader] = None,
                 alignment: str = AlignmentMode.EQUAL_LENGTH):
        self.reader = reader
        self.labels_reader = labels_reader
        self._batch = int(batch_size)
        self.num_classes = num_classes
        self.label_index = label_index
        self.regression = regression
        self.alignment = alignment
        # dual-reader mode: declared label ordering comes from the LABELS
        # reader, not the features reader
        self._mapper = _LabelMapper(
            labels_reader.labels if labels_reader is not None
            else reader.labels)
        if labels_reader is None and label_index is None:
            raise ValueError(
                "single-reader mode needs label_index; dual-reader mode "
                "needs labels_reader")

    @property
    def batch_size(self) -> int:
        return self._batch

    def has_next(self) -> bool:
        return self.reader.has_next()

    def _label_row(self, values: List) -> np.ndarray:
        if self.regression:
            return np.asarray([_to_float(v) for v in values],
                              dtype=np.float32)
        idx = self._mapper.index(values[0])
        n = self.num_classes
        if n is None:
            raise ValueError("classification needs num_classes")
        onehot = np.zeros((n,), dtype=np.float32)
        onehot[idx] = 1.0
        return onehot

    def _one_sequence(self):
        seq = self.reader.next_sequence()
        if self.labels_reader is not None:
            if not self.labels_reader.has_next():
                raise ValueError(
                    "labels reader exhausted before features reader — the "
                    "two readers must yield the same number of sequences")
            lab_seq = self.labels_reader.next_sequence()
            f = np.stack([_flatten_features(step) for step in seq])
            l = np.stack([self._label_row(step) for step in lab_seq])
        else:
            li = self.label_index
            f = np.stack([_flatten_features(step[:li] + step[li + 1:])
                          for step in seq])
            l = np.stack([self._label_row([step[li]]) for step in seq])
        return f, l

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        fs, ls = [], []
        while self.reader.has_next() and len(fs) < self._batch:
            f, l = self._one_sequence()
            fs.append(f)
            ls.append(l)
        t_f = max(f.shape[0] for f in fs)
        t_l = max(l.shape[0] for l in ls)
        t = max(t_f, t_l)
        n = len(fs)
        x = np.zeros((n, t, fs[0].shape[1]), dtype=np.float32)
        y = np.zeros((n, t, ls[0].shape[1]), dtype=np.float32)
        xm = np.zeros((n, t), dtype=np.float32)
        ym = np.zeros((n, t), dtype=np.float32)
        ragged = False
        for i, (f, l) in enumerate(zip(fs, ls)):
            if f.shape[0] != t or l.shape[0] != t:
                ragged = True
            if self.alignment == AlignmentMode.ALIGN_END:
                x[i, t - f.shape[0]:] = f
                xm[i, t - f.shape[0]:] = 1.0
                y[i, t - l.shape[0]:] = l
                ym[i, t - l.shape[0]:] = 1.0
            else:
                if (ragged and self.alignment == AlignmentMode.EQUAL_LENGTH):
                    raise ValueError(
                        "sequences differ in length; use alignment="
                        "ALIGN_START or ALIGN_END")
                x[i, :f.shape[0]] = f
                xm[i, :f.shape[0]] = 1.0
                y[i, :l.shape[0]] = l
                ym[i, :l.shape[0]] = 1.0
        if ragged:
            return DataSet(x, y, xm, ym)
        return DataSet(x, y)

    def reset(self) -> None:
        self.reader.reset()
        if self.labels_reader is not None:
            self.labels_reader.reset()

    def seekable(self) -> bool:
        return _reader_seekable(self.reader) and (
            self.labels_reader is None
            or _reader_seekable(self.labels_reader))

    def state(self) -> dict:
        return {"reader": self.reader.state(),
                "labels_reader": (None if self.labels_reader is None
                                  else self.labels_reader.state()),
                "label_map": dict(self._mapper.map)}

    def restore(self, state: dict) -> None:
        self.reader.restore(state["reader"])
        if self.labels_reader is not None:
            self.labels_reader.restore(state["labels_reader"])
        self._mapper.map = dict(state.get("label_map", {}))


class RecordReaderMultiDataSetIterator:
    """Named multi-input/multi-output batches for ComputationGraph training
    (parity: ``RecordReaderMultiDataSetIterator.java`` builder API).

    >>> it = (RecordReaderMultiDataSetIterator.Builder(batch_size=32)
    ...       .add_reader("csv", reader)
    ...       .add_input("csv", 0, 3)            # columns [0, 3] inclusive
    ...       .add_output_one_hot("csv", 4, 10)  # column 4 as 10-class
    ...       .build())
    """

    class Builder:
        def __init__(self, batch_size: int):
            self.batch_size = int(batch_size)
            self.readers: Dict[str, RecordReader] = {}
            self.inputs: List[tuple] = []
            self.outputs: List[tuple] = []

        def add_reader(self, name: str, reader: RecordReader):
            self.readers[name] = reader
            return self

        def add_input(self, reader_name: str, col_from: int, col_to: int):
            self.inputs.append(("raw", reader_name, col_from, col_to))
            return self

        def add_output(self, reader_name: str, col_from: int, col_to: int):
            self.outputs.append(("raw", reader_name, col_from, col_to))
            return self

        def add_output_one_hot(self, reader_name: str, col: int,
                               num_classes: int):
            self.outputs.append(("onehot", reader_name, col, num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            if not self.readers or not self.inputs:
                raise ValueError("need at least one reader and one input")
            return RecordReaderMultiDataSetIterator(self)

    def __init__(self, builder: "RecordReaderMultiDataSetIterator.Builder"):
        self._b = builder
        self._mappers: Dict[str, _LabelMapper] = {
            name: _LabelMapper(r.labels)
            for name, r in builder.readers.items()}

    @property
    def batch_size(self) -> int:
        return self._b.batch_size

    def has_next(self) -> bool:
        return all(r.has_next() for r in self._b.readers.values())

    def _extract(self, spec, records: Dict[str, List]) -> np.ndarray:
        kind, name = spec[0], spec[1]
        rec = records[name]
        if kind == "onehot":
            col, n = spec[2], spec[3]
            idx = self._mappers[name].index(rec[col])
            if not 0 <= idx < n:
                raise ValueError(
                    f"label index {idx} out of range [0, {n}) for output "
                    f"column {col} of reader {name!r} — check num_classes")
            onehot = np.zeros((n,), dtype=np.float32)
            onehot[idx] = 1.0
            return onehot
        lo, hi = spec[2], spec[3]
        return _flatten_features(rec[lo:hi + 1])

    def next(self) -> MultiDataSet:
        if not self.has_next():
            raise StopIteration
        ins = [[] for _ in self._b.inputs]
        outs = [[] for _ in self._b.outputs]
        count = 0
        while count < self._b.batch_size and self.has_next():
            records = {name: r.next_record()
                       for name, r in self._b.readers.items()}
            for i, spec in enumerate(self._b.inputs):
                ins[i].append(self._extract(spec, records))
            for i, spec in enumerate(self._b.outputs):
                outs[i].append(self._extract(spec, records))
            count += 1
        return MultiDataSet([np.stack(c) for c in ins],
                            [np.stack(c) for c in outs])

    def reset(self) -> None:
        for r in self._b.readers.values():
            r.reset()

    def __iter__(self):
        while self.has_next():
            yield self.next()
