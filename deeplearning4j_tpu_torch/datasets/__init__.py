"""Data containers and the iterator framework (counterpart of the JAX
package's ``datasets/``): ``DataSet``/``MultiDataSet``, the seekable
iterators, and the async prefetch iterators that stage batches onto the
card; the canned-dataset fetchers (MNIST, CIFAR-10, LFW, Iris, curves)
and their downloader."""

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
from .fetchers import (
    CifarDataSetIterator,
    IrisDataSetIterator,
    LFWDataSetIterator,
    MnistDataSetIterator,
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
    "MnistDataSetIterator",
    "IrisDataSetIterator",
    "CifarDataSetIterator",
    "LFWDataSetIterator",
]
