"""Data containers and the iterator framework (counterpart of the JAX
package's ``datasets/``): ``DataSet``/``MultiDataSet``, the seekable
iterators, and the async prefetch iterators that stage batches onto the
card. The canned-dataset fetchers are not ported yet."""

from .dataset import DataSet, MultiDataSet
from .iterator import (
    ArrayDataSetIterator,
    AsyncDataSetIterator,
    AsyncMultiDataSetIterator,
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
)

__all__ = [
    "DataSet",
    "MultiDataSet",
    "DataSetIterator",
    "ArrayDataSetIterator",
    "ListDataSetIterator",
    "ExistingDataSetIterator",
    "MultipleEpochsIterator",
    "SamplingDataSetIterator",
    "AsyncDataSetIterator",
    "AsyncMultiDataSetIterator",
]
