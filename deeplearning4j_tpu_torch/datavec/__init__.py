"""DataVec-analog ETL: record readers → DataSet/MultiDataSet iterators.

Parity: the external DataVec library as consumed by
``deeplearning4j-core/.../datasets/datavec/`` (the reference's primary data
entry point). See module docstrings for the per-class mapping.
"""

from .iterator import (
    AlignmentMode,
    RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)
from .readers import (
    CollectionRecordReader,
    CollectionSequenceRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    LineRecordReader,
    RecordMetaData,
    RecordReader,
    SequenceRecordReader,
)

__all__ = [
    "AlignmentMode",
    "CollectionRecordReader",
    "CollectionSequenceRecordReader",
    "CSVRecordReader",
    "CSVSequenceRecordReader",
    "LineRecordReader",
    "RecordMetaData",
    "RecordReader",
    "RecordReaderDataSetIterator",
    "RecordReaderMultiDataSetIterator",
    "SequenceRecordReaderDataSetIterator",
    "SequenceRecordReader",
]
