"""The port's record files and pipeline (``data/records.py``,
``data/pipeline.py``) against the JAX package's, on the CPU: the cases of
``tests/test_records.py``, plus the cross-package checks — a shard set
written by one package reads back in the other (CRCs included, payloads
byte-equal), the per-epoch orders and the two-host partition equal the
reference's for the same seed, and cursors restore across packages.

Exact everywhere except the augmentation: the port's draws come from a
``torch.Generator``, not jax's, so the augment tests feed the port the
reference's own offsets and flips (recomputed from its key schedule) and
hold the result to the reference's output bit for bit (the same f32
multiplies and divides); the normalize-only test allows 1e-6, against a
numpy recomputation as the reference's does and against the reference
(XLA's CPU fusion contracts ``x·scale − mean`` into one fma there).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data.pipeline as JP
import deeplearning4j_tpu.data.records as JR
from deeplearning4j_tpu_torch.data import records as records_mod
from deeplearning4j_tpu_torch.data.pipeline import (Augment, AugmentStage,
                                                    RecordDataSetIterator,
                                                    assignment_for_round,
                                                    shard_assignment)
from deeplearning4j_tpu_torch.data.records import (RecordCorruptError,
                                                   RecordFormatError,
                                                   ShardReader, ShardSet,
                                                   ShardSetError,
                                                   decode_example,
                                                   encode_example, fsck,
                                                   shard_filename,
                                                   write_shard_set)
from deeplearning4j_tpu_torch.util.metrics import MetricsRegistry

N_EXAMPLES = 23
N_SHARDS = 4
IMG = (4, 4, 1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _examples(n=N_EXAMPLES, seed=0):
    rng = np.random.default_rng(seed)
    return [{"features": rng.integers(0, 256, IMG, dtype=np.uint8),
             "labels": np.eye(3, dtype=np.float32)[i % 3],
             "id": np.asarray(i, dtype=np.int64)}
            for i in range(n)]


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """One clean shard set written by the port; tests that corrupt files
    copy out of here first."""
    d = str(tmp_path_factory.mktemp("records"))
    write_shard_set(d, "toy", _examples(), N_SHARDS)
    return d


def _copy_set(src, dst):
    os.makedirs(dst, exist_ok=True)
    for fn in os.listdir(src):
        if fn.endswith(".rec"):
            shutil.copy(os.path.join(src, fn), os.path.join(dst, fn))


# ----------------------------------------------------------------------
# format
# ----------------------------------------------------------------------

class TestRecordFormat:
    def test_example_serde_roundtrip_dtypes(self):
        ex = {"a": np.arange(6, dtype=np.int16).reshape(2, 3),
              "b": np.asarray(3.5, np.float64),
              "c": np.zeros((0, 4), np.float32),
              "d": np.asarray([True, False])}
        back = decode_example(encode_example(ex))
        assert sorted(back) == sorted(ex)
        for k in ex:
            assert back[k].dtype == ex[k].dtype
            assert back[k].shape == ex[k].shape
            np.testing.assert_array_equal(back[k], ex[k])

    def test_encoding_byte_equal_to_reference(self):
        for ex in _examples(5, seed=4):
            assert encode_example(ex) == JR.encode_example(ex)

    def test_write_read_roundtrip_and_seek(self, shard_dir):
        s = ShardSet(shard_dir, "toy")
        assert s.num_shards == N_SHARDS
        assert s.total_records() == N_EXAMPLES
        r = s.reader(1)
        ex = decode_example(r.read(2))
        assert int(ex["id"]) == 2 * N_SHARDS + 1     # round robin
        ids = sorted(int(decode_example(p)["id"])
                     for i in range(N_SHARDS) for _, p in s.reader(i))
        assert ids == list(range(N_EXAMPLES))

    def test_contiguous_split_preserves_order(self, tmp_path):
        write_shard_set(str(tmp_path), "seq", _examples(10, seed=1), 3,
                        split="contiguous")
        s = ShardSet(str(tmp_path), "seq")
        ids = [int(decode_example(p)["id"])
               for i in range(3) for _, p in s.reader(i)]
        assert ids == list(range(10))

    def test_writer_crash_leaves_no_rec_file(self, tmp_path):
        class Boom(Exception):
            pass

        def gen():
            yield {"x": np.zeros(3, np.float32)}
            raise Boom
        with pytest.raises(Boom):
            write_shard_set(str(tmp_path), "torn", gen(), 2)
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".rec")]

    @pytest.mark.parametrize("split", ["round_robin", "contiguous"])
    def test_shards_byte_equal_to_reference(self, tmp_path, split):
        a, b = str(tmp_path / "port"), str(tmp_path / "ref")
        write_shard_set(a, "toy", _examples(), N_SHARDS, split=split)
        JR.write_shard_set(b, "toy", _examples(), N_SHARDS, split=split)
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for fn in os.listdir(a):
            with open(os.path.join(a, fn), "rb") as fa, \
                    open(os.path.join(b, fn), "rb") as fb:
                assert fa.read() == fb.read(), fn

    def test_reference_shards_read_in_the_port(self, tmp_path):
        d = str(tmp_path)
        JR.write_shard_set(d, "toy", _examples(), N_SHARDS)
        s = ShardSet(d, "toy")
        got = {int(decode_example(p)["id"]): decode_example(p)
               for i in range(N_SHARDS) for _, p in s.reader(i)}
        for i, ex in enumerate(_examples()):
            np.testing.assert_array_equal(got[i]["features"], ex["features"])
        assert fsck(d)["ok"]

    def test_port_shards_read_in_the_reference(self, shard_dir):
        s = JR.ShardSet(shard_dir, "toy")
        ids = sorted(int(JR.decode_example(p)["id"])
                     for i in range(N_SHARDS) for _, p in s.reader(i))
        assert ids == list(range(N_EXAMPLES))
        assert JR.fsck(shard_dir)["ok"]


# ----------------------------------------------------------------------
# chaos: torn / corrupt / incomplete shard sets
# ----------------------------------------------------------------------

class TestShardChaos:
    def test_missing_shard_refused_at_open(self, shard_dir, tmp_path):
        d = str(tmp_path / "missing")
        _copy_set(shard_dir, d)
        os.remove(os.path.join(d, shard_filename("toy", 2, N_SHARDS)))
        with pytest.raises(ShardSetError, match=r"missing shard\(s\) \[2\]"):
            ShardSet(d, "toy")
        rep = fsck(d)
        assert not rep["ok"]
        assert any("missing shard(s) [2]" in e
                   for e in rep["sets"]["toy"]["errors"])

    def test_truncated_shard_refused_at_open(self, shard_dir, tmp_path):
        d = str(tmp_path / "trunc")
        _copy_set(shard_dir, d)
        victim = os.path.join(d, shard_filename("toy", 1, N_SHARDS))
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.truncate(size - 11)
        with pytest.raises(RecordFormatError, match="no index footer"):
            ShardReader(victim)
        with pytest.raises(RecordFormatError):
            ShardSet(d, "toy").reader(1)
        rep = fsck(d)
        assert not rep["ok"]
        bad = rep["sets"]["toy"]["shards"][os.path.basename(victim)]
        assert "no index footer" in bad["error"]

    @pytest.fixture()
    def flipped(self, shard_dir, tmp_path):
        d = str(tmp_path / "flip")
        _copy_set(shard_dir, d)
        victim = os.path.join(d, shard_filename("toy", 0, N_SHARDS))
        clean = ShardReader(victim)
        pos = clean.offsets[2] + 8 + 3
        n_records = len(clean)
        clean.close()
        with open(victim, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))
        return d, victim, n_records

    def test_flipped_byte_crc_raise(self, flipped):
        _, victim, _ = flipped
        r = ShardReader(victim)
        assert r.read(1) is not None
        with pytest.raises(RecordCorruptError, match="record 2: crc32"):
            r.read(2)
        with pytest.raises(JR.RecordCorruptError, match="record 2: crc32"):
            JR.ShardReader(victim).read(2)

    def test_flipped_byte_crc_skip_with_counter(self, flipped):
        d, victim, n_records = flipped
        r = ShardReader(victim, corrupt="skip")
        good = [i for i, _ in r]
        assert len(good) == n_records - 1 and 2 not in good
        assert r.skipped == 1
        rep = fsck(d)
        assert not rep["ok"]
        shard = rep["sets"]["toy"]["shards"][os.path.basename(victim)]
        assert shard["bad_records"] == 1

    def test_pipeline_skip_policy_counts_into_registry(self, flipped):
        d, _, _ = flipped
        reg = MetricsRegistry()
        it = RecordDataSetIterator(d, "toy", batch_size=4,
                                   shuffle_shards=False, corrupt="skip",
                                   stage_name="chaos", registry=reg)
        total = 0
        while it.has_next():
            total += int(np.asarray(it.next().features).shape[0])
        assert total == N_EXAMPLES - 1
        assert reg.get("pipeline_records_skipped_total").value(
            stage="chaos") == 1

    def test_corrupt_tail_ends_stream_cleanly(self, tmp_path):
        d = str(tmp_path)
        write_shard_set(d, "t", _examples(10, seed=2), 2, split="contiguous")
        victim = os.path.join(d, shard_filename("t", 1, 2))
        r = ShardReader(victim)
        offsets = list(r.offsets)
        r.close()
        with open(victim, "r+b") as f:
            for off in offsets:
                f.seek(off + 8)
                b = f.read(1)
                f.seek(off + 8)
                f.write(bytes([b[0] ^ 0xFF]))
        reg = MetricsRegistry()
        it = RecordDataSetIterator(d, "t", batch_size=4,
                                   shuffle_shards=False, corrupt="skip",
                                   stage_name="tail", registry=reg)
        sizes = [np.asarray(b.features).shape[0] for b in it]
        assert sum(sizes) == 10 - len(offsets)
        assert reg.get("pipeline_records_skipped_total").value(
            stage="tail") == len(offsets)

    def test_fsck_cli_exit_codes(self, shard_dir, tmp_path):
        assert records_mod.main(["--fsck", shard_dir]) == 0
        d = str(tmp_path / "cli")
        _copy_set(shard_dir, d)
        os.remove(os.path.join(d, shard_filename("toy", 0, N_SHARDS)))
        assert records_mod.main(["--fsck", d]) == 1
        proc = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.data.records",
             "--fsck", d], capture_output=True, text=True, timeout=60,
            cwd=REPO)
        assert proc.returncode == 1
        assert "FSCK FAILED" in proc.stdout
        assert "missing shard(s) [0]" in proc.stdout
        assert records_mod.format_report(fsck(d)) == \
            JR.format_report(JR.fsck(d))


# ----------------------------------------------------------------------
# per-host shard assignment
# ----------------------------------------------------------------------

class TestShardAssignment:
    @pytest.mark.parametrize("n_hosts", [1, 2, 4])
    @pytest.mark.parametrize("num_shards", [4, 7, 16])
    def test_disjoint_covering_equal_to_reference(self, n_hosts, num_shards):
        hosts = [f"h{i}" for i in range(n_hosts)]
        parts = [shard_assignment(num_shards, hosts, h) for h in hosts]
        assert sorted(s for p in parts for s in p) == list(range(num_shards))
        assert parts == [shard_assignment(num_shards, list(reversed(hosts)),
                                          h) for h in hosts]
        assert parts == [JP.shard_assignment(num_shards, hosts, h)
                         for h in hosts]

    def test_refusals(self):
        with pytest.raises(ValueError, match="cannot feed"):
            shard_assignment(2, ["h0", "h1", "h2"], "h0")
        with pytest.raises(ValueError, match="not in members"):
            shard_assignment(4, ["h0", "h1"], "h9")

    def test_assignment_for_round_over_the_reference_log(self):
        from deeplearning4j_tpu.parallel.elastic import (
            ElasticConfig, ElasticCoordinator, InMemoryCoordinationStore)
        from deeplearning4j_tpu.util.metrics import \
            MetricsRegistry as JRegistry
        fleet = ("h0", "h1", "h2", "h3")
        coord = ElasticCoordinator(
            InMemoryCoordinationStore(),
            ElasticConfig(fleet=fleet, host="h0", steps_per_round=1),
            registry=JRegistry())
        coord._append_log("evict", "h1", 3)
        for round_, members in ((2, fleet), (3, ("h0", "h2", "h3"))):
            for h in members:
                assert assignment_for_round(8, coord, round_, h) == \
                    JP.assignment_for_round(8, coord, round_, h)
        with pytest.raises(ValueError, match="not in members"):
            assignment_for_round(8, coord, 3, "h1")


# ----------------------------------------------------------------------
# pipeline: orders against the reference, augmentation, cursor
# ----------------------------------------------------------------------

def _drain(it):
    out = []
    while it.has_next():
        b = it.next()
        out.append((np.asarray(b.features), np.asarray(b.labels)))
    return out


def _make(shard_dir, cls=RecordDataSetIterator, **kw):
    kw.setdefault("batch_size", 5)
    kw.setdefault("seed", 3)
    kw.setdefault("shuffle_shards", True)
    kw.setdefault("shuffle_buffer", 6)
    return cls(shard_dir, "toy", **kw)


CONFIGS = [dict(), dict(shuffle_buffer=0), dict(shuffle_shards=False),
           dict(batch_size=4, drop_remainder=True, seed=11)]


class TestRecordPipeline:
    @pytest.mark.parametrize("cfg", CONFIGS)
    def test_epoch_orders_byte_equal_to_reference(self, shard_dir, cfg):
        a, b = _make(shard_dir, **cfg), _make(shard_dir, JP.
                                              RecordDataSetIterator, **cfg)
        for _ in range(3):          # three epochs: the seeds differ
            got, want = _drain(a), _drain(b)
            assert len(got) == len(want) > 0
            for (fa, la), (fb, lb) in zip(got, want):
                assert fa.tobytes() == fb.tobytes()
                assert la.tobytes() == lb.tobytes()
            a.reset()
            b.reset()

    def test_two_hosts_partition_equal_to_reference(self, shard_dir):
        seen = {}
        for h in ("h0", "h1"):
            kw = dict(batch_size=4, seed=1, hosts=("h0", "h1"), host=h,
                      shuffle_shards=True, shuffle_buffer=4,
                      features_key="id", labels_key=None)
            got = _drain(RecordDataSetIterator(shard_dir, "toy", **kw))
            want = _drain(JP.RecordDataSetIterator(shard_dir, "toy", **kw))
            assert [g[0].tolist() for g in got] == \
                [w[0].tolist() for w in want]
            seen[h] = {int(v) for b in got for v in b[0]}
        assert seen["h0"] & seen["h1"] == set()
        assert seen["h0"] | seen["h1"] == set(range(N_EXAMPLES))

    def test_epoch_covers_every_record_once(self, shard_dir):
        it = RecordDataSetIterator(shard_dir, "toy", batch_size=4, seed=1,
                                   shuffle_shards=True, shuffle_buffer=8,
                                   features_key="id", labels_key=None)
        ids = [int(v) for f, _ in _drain(it) for v in f]
        assert sorted(ids) == list(range(N_EXAMPLES))

    def test_stream_deterministic_and_epochs_differ(self, shard_dir):
        a = _make(shard_dir)
        ea = _drain(a)
        a.reset()
        ea2 = _drain(a)
        assert not all(np.array_equal(f1, f2)
                       for (f1, _), (f2, _) in zip(ea, ea2))

    def test_reshuffle_off_replays_the_epoch(self, shard_dir):
        it = _make(shard_dir, reshuffle_each_epoch=False)
        first = _drain(it)
        it.reset()
        again = _drain(it)
        assert all(np.array_equal(f1, f2)
                   for (f1, _), (f2, _) in zip(first, again))

    def test_drop_remainder(self, shard_dir):
        batches = _drain(_make(shard_dir, drop_remainder=True))
        assert [b[0].shape[0] for b in batches] == [5, 5, 5, 5]

    def test_augment_normalize_matches_reference(self, shard_dir):
        aug = Augment(scale=1 / 255.0, mean=(0.5,), std=(0.25,))
        it = _make(shard_dir, shuffle_shards=False, shuffle_buffer=0,
                   augment=aug)
        raw = _make(shard_dir, shuffle_shards=False, shuffle_buffer=0)
        got = it.next().features.numpy()
        want = (np.asarray(raw.next().features).astype(np.float32)
                / 255.0 - 0.5) / 0.25
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        ref = _make(shard_dir, JP.RecordDataSetIterator,
                    shuffle_shards=False, shuffle_buffer=0,
                    augment=JP.Augment(scale=1 / 255.0, mean=(0.5,),
                                       std=(0.25,)))
        # XLA's CPU fusion contracts x·scale − mean into one fma, the
        # port rounds the product first: one f32 ulp apart at most
        np.testing.assert_allclose(got, np.asarray(ref.next().features),
                                   rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("n", [0, 7])
    def test_augment_crop_flip_equals_reference_given_its_draws(
            self, shard_dir, n):
        """The reference's offsets and flips for batch counter n,
        recomputed from its key schedule, fed to the port's arithmetic:
        the output equals the reference stage's bit for bit."""
        import jax
        from deeplearning4j_tpu import rng as jrng
        x = np.asarray(_make(shard_dir).next().features)
        aug_kw = dict(crop_pad=1, flip=True, scale=1 / 255.0, mean=(0.1,),
                      std=(0.5,))
        want = np.asarray(JP.AugmentStage(JP.Augment(**aug_kw), 3)(x, n))
        key = jax.random.fold_in(jrng.fold_name(jrng.key(3), "augment"),
                                 np.uint32(n))
        k_crop, key = jax.random.split(key)
        off = np.asarray(jax.random.randint(k_crop, (x.shape[0], 2), 0, 3))
        k_flip, key = jax.random.split(key)
        flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (x.shape[0],)))
        stage = AugmentStage(Augment(**aug_kw), 3)
        got = stage.apply(x, torch.from_numpy(off.copy()),
                          torch.from_numpy(flips.copy()))
        assert got.numpy().tobytes() == want.tobytes()

    def test_augment_draws_seeded_by_batch_counter(self, shard_dir):
        aug = Augment(crop_pad=1, flip=True, scale=1 / 255.0)
        a, b = _make(shard_dir, augment=aug), _make(shard_dir, augment=aug)
        fa, fb = a.next().features, b.next().features
        assert tuple(fa.shape) == (5,) + IMG
        assert torch.equal(fa, fb)
        stage = a._augment
        raw = np.asarray(_make(shard_dir).next().features)
        one, two = stage(raw, 100), stage(raw, 101)
        assert torch.equal(one, stage(raw, 100))
        assert not torch.equal(one, two)

    def test_augment_rejects_flat_features_for_crop(self, shard_dir):
        it = _make(shard_dir, features_key="labels", labels_key="id",
                   augment=Augment(flip=True))
        with pytest.raises(ValueError, match="NHWC"):
            it.next()

    def test_cursor_restore_bit_identical_with_augment(self, shard_dir):
        aug = Augment(crop_pad=1, flip=True, scale=1 / 255.0)
        run, ref = _make(shard_dir, augment=aug), _make(shard_dir,
                                                        augment=aug)
        for _ in range(2):
            assert torch.equal(run.next().features, ref.next().features)
        cursor = json.loads(json.dumps(run.state()))
        resumed = _make(shard_dir, augment=aug)
        resumed.restore(cursor)
        tail = 0
        while ref.has_next():
            assert torch.equal(resumed.next().features, ref.next().features)
            tail += 1
        assert not resumed.has_next() and tail > 0

    def test_cursor_restore_across_epoch_boundary(self, shard_dir):
        run, ref = _make(shard_dir), _make(shard_dir)
        _drain(run), _drain(ref)
        run.reset(), ref.reset()
        run.next(), ref.next()
        resumed = _make(shard_dir)
        resumed.restore(json.loads(json.dumps(run.state())))
        for f, _ in _drain(ref):
            np.testing.assert_array_equal(f,
                                          np.asarray(resumed.next().features))
        assert not resumed.has_next()

    @pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
    def test_cursor_restores_across_packages(self, shard_dir, direction):
        src_cls, dst_cls = ((JP.RecordDataSetIterator, RecordDataSetIterator)
                            if direction == "ref_to_port" else
                            (RecordDataSetIterator, JP.RecordDataSetIterator))
        src = _make(shard_dir, src_cls)
        _drain(src)
        src.reset()
        src.next()
        cursor = json.loads(json.dumps(src.state()))
        want = _drain(src)
        dst = _make(shard_dir, dst_cls)
        dst.restore(cursor)
        got = _drain(dst)
        assert [g[0].tobytes() for g in got] == [w[0].tobytes() for w in want]

    def test_cursor_config_mismatch_refused(self, shard_dir, tmp_path):
        it = _make(shard_dir)
        it.next()
        st = it.state()
        with pytest.raises(ValueError, match="shuffle_buffer=0"):
            _make(shard_dir, shuffle_buffer=0).restore(st)
        d2 = str(tmp_path / "other")
        write_shard_set(d2, "toy", _examples(12, seed=9), 2)
        with pytest.raises(ValueError, match="different pipeline"):
            _make(d2).restore(st)
        resized = RecordDataSetIterator(
            shard_dir, "toy", batch_size=5, seed=3, shuffle_shards=True,
            shuffle_buffer=6, hosts=("host0", "host1"), host="host0")
        with pytest.raises(ValueError, match="fleet membership"):
            resized.restore(st)
