"""Sharded seekable record files: the on-disk dataset format (a copy of
the JAX package's ``data/records.py``; the byte layout is the same, so a
shard set written by either package reads in the other, CRCs included).

Production TPU input stacks (tf.data snapshots, ArrayRecord/Grain, the
reference era's DataVec record files) converge on the same shape: a
dataset is N independent shard files, each a sequence of length+checksum
framed records with an index so any record is one seek away. That shape
is what makes every downstream property cheap — per-host sharding is
file assignment, shuffling is permutation over (shard, record) ids, and
exact mid-epoch resume is "seek these offsets again".

Layout of one ``name-SSSSS-of-NNNNN.rec`` shard::

    header  := b"DL4JREC1" | u32 json_len | header_json
    record  := u32 payload_len | u32 crc32(payload) | payload
    index   := u64 offset[count]          (file offset of each record)
    footer  := u64 index_off | u32 count | u32 crc32(index) | b"DL4JIDX1"

The fixed 24-byte footer at EOF locates the index; the index crc proves
it; each record's crc proves the payload. A shard is written to a
``.tmp`` path and renamed into place on close, so a crashed writer never
leaves a ``.rec`` file at all — and a truncated/torn copy loses its
footer, so it is REFUSED at open rather than silently feeding garbage.

Corrupt-record policy on read: ``corrupt="raise"`` (default — a bad crc
raises :class:`RecordCorruptError`) or ``corrupt="skip"`` (count into
``reader.skipped`` and keep going; the fsck walk uses this).

``python -m deeplearning4j_tpu_torch.data.records --fsck DIR`` walks
every shard set under DIR (header/index/footer structure, every record's
crc32, shard-count contiguity) and exits nonzero with a per-shard
report. Host code on numpy alone: the CLI and the chaos tests that reuse
:func:`fsck` import no torch.
"""

from __future__ import annotations

import io
import json
import os
import re
import struct
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

FORMAT_VERSION = 1

_FILE_MAGIC = b"DL4JREC1"
_INDEX_MAGIC = b"DL4JIDX1"
_HDR_LEN = struct.Struct("<I")
_REC_HDR = struct.Struct("<II")           # payload_len, crc32
_FOOTER = struct.Struct("<QII8s")         # index_off, count, index_crc, magic

SHARD_RE = re.compile(r"^(?P<name>.+)-(?P<idx>\d{5})-of-(?P<of>\d{5})\.rec$")


class RecordFormatError(Exception):
    """Structural damage: bad magic, missing/corrupt index footer,
    offsets outside the file. A shard in this state is refused at open —
    no record of it can be trusted."""


class RecordCorruptError(RecordFormatError):
    """One record's payload failed its crc32 or was truncated."""


class ShardSetError(Exception):
    """Set-level damage: missing shard index, inconsistent ``-of-N``,
    duplicate indices, or no shards at all."""


def shard_filename(name: str, index: int, num_shards: int) -> str:
    if not 0 <= index < num_shards:
        raise ValueError(f"shard index {index} outside 0..{num_shards - 1}")
    return f"{name}-{index:05d}-of-{num_shards:05d}.rec"


# ----------------------------------------------------------------------
# example serialization (dict of named numpy arrays <-> bytes)
# ----------------------------------------------------------------------

_KEY_LEN = struct.Struct("<H")
_ARR_HDR = struct.Struct("<B")            # ndim (and array count)
_DIM = struct.Struct("<q")


def encode_example(arrays: Dict[str, np.ndarray]) -> bytes:
    """Serialize a dict of named numpy arrays (sorted key order, C-order
    raw bytes — deterministic: the same dict always encodes to the same
    payload, so record crcs are stable across writers)."""
    out = io.BytesIO()
    out.write(_ARR_HDR.pack(len(arrays)))
    for key in sorted(arrays):
        a = np.asarray(arrays[key])
        if not a.flags["C_CONTIGUOUS"]:
            # NB: np.ascontiguousarray unconditionally would promote 0-d
            # scalars to 1-d and corrupt the round-tripped shape
            a = np.ascontiguousarray(a)
        kb = key.encode("utf-8")
        out.write(_KEY_LEN.pack(len(kb)))
        out.write(kb)
        db = a.dtype.str.encode("ascii")
        out.write(_KEY_LEN.pack(len(db)))
        out.write(db)
        out.write(_ARR_HDR.pack(a.ndim))
        for d in a.shape:
            out.write(_DIM.pack(d))
        out.write(a.tobytes())
    return out.getvalue()


def decode_example(payload: bytes) -> Dict[str, np.ndarray]:
    buf = io.BytesIO(payload)

    def take(n: int) -> bytes:
        b = buf.read(n)
        if len(b) != n:
            raise RecordCorruptError("example payload truncated")
        return b

    (count,) = _ARR_HDR.unpack(take(1))
    out: Dict[str, np.ndarray] = {}
    for _ in range(count):
        (klen,) = _KEY_LEN.unpack(take(2))
        key = take(klen).decode("utf-8")
        (dlen,) = _KEY_LEN.unpack(take(2))
        dtype = np.dtype(take(dlen).decode("ascii"))
        (ndim,) = _ARR_HDR.unpack(take(1))
        shape = tuple(_DIM.unpack(take(8))[0] for _ in range(ndim))
        nbytes = int(dtype.itemsize * int(np.prod(shape, dtype=np.int64)))
        out[key] = np.frombuffer(take(nbytes), dtype=dtype).reshape(shape)
    return out


# ----------------------------------------------------------------------
# writer
# ----------------------------------------------------------------------

class ShardWriter:
    """Append records to one shard; ``close()`` writes the index footer,
    fsyncs and atomically renames ``path.tmp`` -> ``path``. Usable as a
    context manager (exceptions abandon the .tmp file — no torn .rec)."""

    def __init__(self, path: str, *, name: str, shard_index: int,
                 num_shards: int):
        self.path = path
        self._tmp = path + ".tmp"
        self._offsets: List[int] = []
        self._f = open(self._tmp, "wb")
        header = json.dumps({
            "version": FORMAT_VERSION, "name": name,
            "shard": int(shard_index), "of": int(num_shards)},
            sort_keys=True).encode()
        self._f.write(_FILE_MAGIC)
        self._f.write(_HDR_LEN.pack(len(header)))
        self._f.write(header)

    def append(self, payload: bytes) -> int:
        """Write one record; returns its record index within the shard."""
        if self._f is None:
            raise ValueError("writer is closed")
        self._offsets.append(self._f.tell())
        self._f.write(_REC_HDR.pack(len(payload),
                                    zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        return len(self._offsets) - 1

    def __len__(self) -> int:
        return len(self._offsets)

    def close(self) -> str:
        if self._f is None:
            return self.path
        index_off = self._f.tell()
        index = b"".join(struct.pack("<Q", o) for o in self._offsets)
        self._f.write(index)
        self._f.write(_FOOTER.pack(index_off, len(self._offsets),
                                   zlib.crc32(index) & 0xFFFFFFFF,
                                   _INDEX_MAGIC))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        self._f = None
        os.replace(self._tmp, self.path)
        return self.path

    def abandon(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
            try:
                os.remove(self._tmp)
            except OSError:
                pass

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is None:
            self.close()
        else:
            self.abandon()
        return False


def write_shard_set(directory: str, name: str,
                    examples: Iterable[Dict[str, np.ndarray]],
                    num_shards: int, *, split: str = "round_robin",
                    encode=encode_example) -> List[str]:
    """Write ``examples`` (dicts of named arrays, or pre-encoded bytes
    via ``encode=None``) into ``num_shards`` shard files.

    ``split="round_robin"`` streams (example i -> shard i % N; works on
    any iterable); ``split="contiguous"`` keeps the original order as N
    consecutive chunks (needs a sized sequence) — the mode that makes a
    1-host unshuffled read bit-identical to iterating the source.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    os.makedirs(directory, exist_ok=True)
    writers = [ShardWriter(os.path.join(
        directory, shard_filename(name, i, num_shards)),
        name=name, shard_index=i, num_shards=num_shards)
        for i in range(num_shards)]
    try:
        if split == "round_robin":
            for i, ex in enumerate(examples):
                writers[i % num_shards].append(
                    encode(ex) if encode is not None else ex)
        elif split == "contiguous":
            examples = list(examples)
            bounds = np.linspace(0, len(examples), num_shards + 1)
            for i, ex in enumerate(examples):
                shard = int(np.searchsorted(bounds, i, side="right")) - 1
                writers[min(shard, num_shards - 1)].append(
                    encode(ex) if encode is not None else ex)
        else:
            raise ValueError(f"unknown split mode {split!r}")
        return [w.close() for w in writers]
    except BaseException:
        for w in writers:
            w.abandon()
        raise


# ----------------------------------------------------------------------
# reader
# ----------------------------------------------------------------------

class ShardReader:
    """One shard file: sequential iteration + O(1) ``read(i)`` via the
    index footer. Open validates magic + footer + index crc + offset
    sanity and REFUSES structurally damaged files; per-record crc
    failures follow the ``corrupt`` policy ("raise" | "skip")."""

    def __init__(self, path: str, *, corrupt: str = "raise"):
        if corrupt not in ("raise", "skip"):
            raise ValueError(f"corrupt policy must be 'raise' or 'skip', "
                             f"got {corrupt!r}")
        self.path = path
        self.corrupt = corrupt
        self.skipped = 0
        self._f = open(path, "rb")
        try:
            self._open()
        except BaseException:
            self._f.close()
            raise

    def _open(self) -> None:
        size = os.fstat(self._f.fileno()).st_size
        min_size = len(_FILE_MAGIC) + _HDR_LEN.size + _FOOTER.size
        if size < min_size:
            raise RecordFormatError(
                f"{self.path}: {size} bytes — too short to be a shard "
                "(truncated?)")
        if self._f.read(len(_FILE_MAGIC)) != _FILE_MAGIC:
            raise RecordFormatError(f"{self.path}: bad file magic")
        (hdr_len,) = _HDR_LEN.unpack(self._f.read(_HDR_LEN.size))
        try:
            self.header = json.loads(self._f.read(hdr_len))
        except ValueError as e:
            raise RecordFormatError(f"{self.path}: unreadable header ({e})")
        self._f.seek(size - _FOOTER.size)
        index_off, count, index_crc, magic = _FOOTER.unpack(
            self._f.read(_FOOTER.size))
        if magic != _INDEX_MAGIC:
            raise RecordFormatError(
                f"{self.path}: no index footer (torn or in-progress "
                "write — refusing the whole shard)")
        if index_off + 8 * count != size - _FOOTER.size:
            raise RecordFormatError(
                f"{self.path}: index footer geometry inconsistent "
                f"(off={index_off}, count={count}, size={size})")
        self._f.seek(index_off)
        index = self._f.read(8 * count)
        if zlib.crc32(index) & 0xFFFFFFFF != index_crc:
            raise RecordFormatError(f"{self.path}: index crc32 mismatch")
        self.offsets = [struct.unpack_from("<Q", index, 8 * i)[0]
                        for i in range(count)]
        prev = 0
        for o in self.offsets:
            if o < prev or o + _REC_HDR.size > index_off:
                raise RecordFormatError(
                    f"{self.path}: index offset {o} out of bounds")
            prev = o
        self._data_end = index_off

    def __len__(self) -> int:
        return len(self.offsets)

    def read(self, i: int) -> Optional[bytes]:
        """Record ``i``'s payload, crc-verified. Under ``corrupt="skip"``
        a bad record returns None (and counts into ``skipped``)."""
        if not 0 <= i < len(self.offsets):
            raise IndexError(f"record {i} outside 0..{len(self) - 1}")
        self._f.seek(self.offsets[i])
        hdr = self._f.read(_REC_HDR.size)
        problem = None
        payload = b""
        if len(hdr) != _REC_HDR.size:
            problem = "record header truncated"
        else:
            length, crc = _REC_HDR.unpack(hdr)
            if self.offsets[i] + _REC_HDR.size + length > self._data_end:
                problem = f"record length {length} runs past the data region"
            else:
                payload = self._f.read(length)
                if len(payload) != length:
                    problem = "record payload truncated"
                elif zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    problem = "crc32 mismatch"
        if problem is None:
            return payload
        if self.corrupt == "skip":
            self.skipped += 1
            return None
        raise RecordCorruptError(f"{self.path}: record {i}: {problem}")

    def __iter__(self):
        """Yield (record_index, payload) for every GOOD record (corrupt
        ones raise or are skipped per policy)."""
        for i in range(len(self)):
            payload = self.read(i)
            if payload is not None:
                yield i, payload

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "ShardReader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# ----------------------------------------------------------------------
# shard sets
# ----------------------------------------------------------------------

def _discover(directory: str) -> Dict[Tuple[str, int], Dict[int, str]]:
    """{(name, of): {index: filename}} for every .rec under directory."""
    out: Dict[Tuple[str, int], Dict[int, str]] = {}
    for fn in sorted(os.listdir(directory)):
        m = SHARD_RE.match(fn)
        if m is None:
            continue
        key = (m.group("name"), int(m.group("of")))
        out.setdefault(key, {})[int(m.group("idx"))] = fn
    return out


class ShardSet:
    """The complete shard set ``name-*-of-N.rec`` in one directory.

    Open REFUSES an incomplete set (missing index, duplicate/extra
    indices, inconsistent ``-of-N``): training over a silently partial
    dataset is the failure mode this exists to prevent. Readers open
    lazily and are cached; ``corrupt`` is passed through to them.
    """

    def __init__(self, directory: str, name: Optional[str] = None, *,
                 corrupt: str = "raise"):
        self.directory = directory
        self.corrupt = corrupt
        sets = _discover(directory)
        if name is not None:
            sets = {k: v for k, v in sets.items() if k[0] == name}
        if not sets:
            raise ShardSetError(
                f"{directory}: no shard files"
                + (f" named {name!r}" if name else ""))
        names = {k[0] for k in sets}
        if len(names) > 1:
            raise ShardSetError(
                f"{directory}: multiple shard sets {sorted(names)} — "
                "pass name= to pick one")
        self.name = next(iter(names))
        if len(sets) > 1:
            raise ShardSetError(
                f"{directory}: {self.name!r} has shards from different "
                f"-of-N generations: {sorted(k[1] for k in sets)}")
        (_, of), files = next(iter(sets.items()))
        missing = sorted(set(range(of)) - set(files))
        if missing:
            raise ShardSetError(
                f"{directory}: {self.name!r} is missing shard(s) "
                f"{missing} of {of} — refusing the set")
        extra = sorted(set(files) - set(range(of)))
        if extra:
            raise ShardSetError(
                f"{directory}: {self.name!r} has out-of-range shard "
                f"indices {extra} for -of-{of}")
        self.num_shards = of
        self._files = files
        self._readers: Dict[int, ShardReader] = {}

    def reader(self, i: int) -> ShardReader:
        r = self._readers.get(i)
        if r is None:
            r = ShardReader(os.path.join(self.directory, self._files[i]),
                            corrupt=self.corrupt)
            if (r.header.get("shard"), r.header.get("of")) != \
                    (i, self.num_shards):
                raise ShardSetError(
                    f"{self._files[i]}: header says shard "
                    f"{r.header.get('shard')}/{r.header.get('of')}, "
                    f"filename says {i}/{self.num_shards}")
            self._readers[i] = r
        return r

    def record_count(self, i: int) -> int:
        return len(self.reader(i))

    def total_records(self) -> int:
        return sum(self.record_count(i) for i in range(self.num_shards))

    @property
    def skipped(self) -> int:
        return sum(r.skipped for r in self._readers.values())

    def close(self) -> None:
        for r in self._readers.values():
            r.close()
        self._readers.clear()


# ----------------------------------------------------------------------
# fsck
# ----------------------------------------------------------------------

def fsck(directory: str, name: Optional[str] = None) -> dict:
    """Verify every shard set under ``directory``: structure (magic /
    index footer / offsets), every record's crc32, and shard-count
    contiguity. Returns a report dict with ``report["ok"]``; the CLI
    prints it and exits nonzero when not ok."""
    sets = _discover(directory)
    if name is not None:
        sets = {k: v for k, v in sets.items() if k[0] == name}
    report: dict = {"directory": directory, "sets": {}, "ok": True}
    if not sets:
        report["ok"] = False
        report["error"] = ("no shard files"
                           + (f" named {name!r}" if name else ""))
        return report
    by_name: Dict[str, List[Tuple[int, Dict[int, str]]]] = {}
    for (nm, of), files in sorted(sets.items()):
        by_name.setdefault(nm, []).append((of, files))
    for nm, gens in by_name.items():
        entry: dict = {"shards": {}, "errors": []}
        report["sets"][nm] = entry
        if len(gens) > 1:
            entry["errors"].append(
                f"mixed -of-N generations: {sorted(of for of, _ in gens)}")
        of = gens[0][0] if len(gens) == 1 else None
        files: Dict[int, str] = {}
        for _, fs in gens:
            files.update(fs)
        if of is not None:
            missing = sorted(set(range(of)) - set(files))
            if missing:
                entry["errors"].append(f"missing shard(s) {missing} of {of}")
            entry["num_shards"] = of
        for idx in sorted(files):
            fn = files[idx]
            shard: dict = {"records": 0, "bad_records": 0, "error": None}
            entry["shards"][fn] = shard
            try:
                with ShardReader(os.path.join(directory, fn),
                                 corrupt="skip") as r:
                    n = sum(1 for _ in r)
                    shard["records"] = n
                    shard["bad_records"] = r.skipped
                    shard["indexed"] = len(r)
            except RecordFormatError as e:
                shard["error"] = str(e)
            if shard["error"] or shard["bad_records"]:
                entry["errors"].append(f"{fn}: "
                                       + (shard["error"]
                                          or f"{shard['bad_records']} "
                                             "corrupt record(s)"))
        if entry["errors"]:
            report["ok"] = False
    return report


def format_report(report: dict) -> str:
    lines = [f"fsck {report['directory']}"]
    if report.get("error"):
        lines.append(f"  ERROR: {report['error']}")
    for nm, entry in report.get("sets", {}).items():
        n = entry.get("num_shards", "?")
        lines.append(f"  set {nm!r} (-of-{n}):")
        for fn, shard in entry["shards"].items():
            status = (f"ERROR: {shard['error']}" if shard["error"] else
                      f"{shard['records']} records"
                      + (f", {shard['bad_records']} CORRUPT"
                         if shard["bad_records"] else " ok"))
            lines.append(f"    {fn}: {status}")
        for err in entry["errors"]:
            lines.append(f"    SET ERROR: {err}")
    lines.append("FSCK " + ("OK" if report["ok"] else "FAILED"))
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.data.records",
        description="Verify sharded record files (crc32, index footers, "
                    "shard-count contiguity).")
    p.add_argument("--fsck", metavar="DIR", required=True,
                   help="directory holding name-SSSSS-of-NNNNN.rec shards")
    p.add_argument("--name", default=None,
                   help="restrict to one shard-set name")
    args = p.parse_args(argv)
    report = fsck(args.fsck, args.name)
    print(format_report(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
