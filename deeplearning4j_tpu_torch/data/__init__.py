"""Sharded-record input pipeline (counterpart of the JAX package's
``data/``): seekable sharded record files (:mod:`.records` — crc32-framed
records, O(1) index footer, fsck), and a composable pipeline
(:mod:`.pipeline` — deterministic per-host shard assignment, epoch-seeded
shuffles, an augmentation stage, and a ``DataSetIterator`` with the full
seekable-cursor protocol so ``DurableSession`` resumes a preempted
mid-epoch run bit-exactly).

Lazy attribute surface: ``python -m deeplearning4j_tpu_torch.data.records``
(the fsck CLI) does not import the pipeline's torch surface just to walk
shard files.
"""

_FROM = {
    name: "records" for name in (
        "RecordCorruptError", "RecordFormatError", "ShardReader",
        "ShardSet", "ShardSetError", "ShardWriter", "decode_example",
        "encode_example", "fsck", "shard_filename", "write_shard_set")
}
_FROM.update({
    name: "pipeline" for name in (
        "Augment", "AugmentStage", "RecordDataSetIterator",
        "assignment_for_round", "shard_assignment")
})

__all__ = sorted(_FROM) + ["pipeline", "records"]


def __getattr__(name):
    import importlib
    if name in ("records", "pipeline"):
        mod = importlib.import_module(f"{__name__}.{name}")
        globals()[name] = mod
        return mod
    if name in _FROM:
        mod = importlib.import_module(f"{__name__}.{_FROM[name]}")
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
