"""The batch-iteration helper of the network runtimes' ``fit``, ``pretrain``
and ``evaluate`` (counterpart of the JAX package's ``util/batching.py``):
one dispatch over (features, labels[, mask]) arrays, a DataSet-like
object (``.features``/``.labels``) or an iterable of either. The epoch
loop over it is ``util.ingest.run_fit_loop``."""

from __future__ import annotations

from typing import Iterator, Optional, Tuple


def iter_batches(data, labels=None, mask=None,
                 with_meta: bool = False) -> Iterator[Tuple]:
    """Yield (features, labels, features_mask) triples — or, with
    ``with_meta=True``, (features, labels, features_mask, metadata)
    quadruples where metadata is the per-example ``RecordMetaData`` list a
    DataSet carries (``collect_metadata=True`` readers), else None.

    `data` may be: (features, labels[, mask]) arrays; a bare feature
    array with no labels (ONE unlabeled batch, labels None — the
    pretrain() call pattern); a DataSet (has .features/.labels); or an
    iterator yielding DataSets or tuples. ONE dispatch chain for every
    caller, so the eval-with-provenance path cannot drift from fit's.
    """
    def out(x, y, m, meta=None):
        return (x, y, m, meta) if with_meta else (x, y, m)

    def ds_out(ds):
        return out(ds.features, ds.labels,
                   getattr(ds, "features_mask", None),
                   getattr(ds, "example_metadata", None) or None)

    if labels is not None:
        yield out(data, labels, mask)
        return
    if hasattr(data, "shape"):
        # bare feature array, no labels: ONE unlabeled batch (the
        # pretrain() call pattern) — iterating its rows is never meant
        yield out(data, None, mask)
        return
    if hasattr(data, "features"):
        yield ds_out(data)
        return
    # a 2/3-tuple of arrays — or of lists of arrays (multi-input graphs) —
    # is ONE batch, not an iterator of batches
    def _batchlike(a):
        if a is None or hasattr(a, "shape"):
            return True
        return (isinstance(a, list) and len(a) > 0
                and all(hasattr(e, "shape") or e is None for e in a))

    if (isinstance(data, tuple) and len(data) in (2, 3)
            and all(_batchlike(a) for a in data)):
        x, y = data[0], data[1]
        m = data[2] if len(data) > 2 else mask
        yield out(x, y, m)
        return
    for item in data:
        if hasattr(item, "features"):
            yield ds_out(item)
        else:
            x, y = item[0], item[1]
            m = item[2] if len(item) > 2 else None
            yield out(x, y, m)
