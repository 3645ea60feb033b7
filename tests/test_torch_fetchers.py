"""The port's canned-dataset fetchers (``datasets/fetchers.py``) and their
downloader (``datasets/downloader.py``) against the JAX package's, on the
CPU: the cases of ``tests/test_datasets.py::TestFetchers`` and
``TestCurves``, each run through both packages and compared bitwise —
the synthetic surrogates (numpy from a seed), and the file readers over
files written here from a seed (MNIST idx, plain and gzipped; CIFAR-10
binary batches; an LFW directory of JPEGs). The downloader fetches from a
``http.server`` on 127.0.0.1: the same bytes as the file served, a sha256
mismatch refused and nothing left behind, a failed host remembered.

Nothing reaches the network: every test runs with
``DL4J_TPU_AUTO_DOWNLOAD=0`` (the downloader tests turn it on for their
local server only) and with ``HOME`` and ``DL4J_TPU_DATA_DIR`` inside its
temporary directory.
"""

import gzip
import hashlib
import http.server
import struct
import threading
import types

import numpy as np
import pytest

import deeplearning4j_tpu.datasets.downloader as j_down
import deeplearning4j_tpu.datasets.fetchers as j_fetch

import deeplearning4j_tpu_torch.datasets as t_datasets
import deeplearning4j_tpu_torch.datasets.downloader as t_down
import deeplearning4j_tpu_torch.datasets.fetchers as t_fetch

JAX = types.SimpleNamespace(f=j_fetch, d=j_down)
TORCH = types.SimpleNamespace(f=t_fetch, d=t_down)


@pytest.fixture(autouse=True)
def offline(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_AUTO_DOWNLOAD", "0")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "data"))
    (tmp_path / "data").mkdir()
    for mod in (j_down, t_down):
        monkeypatch.setattr(mod, "_failed_hosts", set())
    return tmp_path / "data"


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def batches(it):
    out = []
    while it.has_next():
        ds = it.next()
        out.append((np.asarray(ds.features), np.asarray(ds.labels)))
    return out


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert same(gx, wx) and same(gy, wy)


def write_idx(path, arr, gz=False):
    code = {np.dtype(np.uint8): 0x08, np.dtype(np.int32): 0x0C,
            np.dtype(np.float32): 0x0D}[arr.dtype]
    body = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape) + \
        arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(body)


def write_mnist(d, n_train=40, n_test=12, gz=False, seed=0):
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    sfx = ".gz" if gz else ""
    out = {}
    for split, n in (("train", n_train), ("t10k", n_test)):
        imgs = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
        labs = rng.integers(0, 10, n).astype(np.uint8)
        write_idx(d / f"{split}-images-idx3-ubyte{sfx}", imgs, gz)
        write_idx(d / f"{split}-labels-idx1-ubyte{sfx}", labs, gz)
        out[split] = (imgs, labs)
    return out


class TestSynthetic:
    @pytest.mark.parametrize("train", [True, False])
    def test_mnist_surrogate(self, train):
        for kw in ({}, {"binarize": True}, {"shuffle": False}):
            got = t_fetch.MnistDataSetIterator(16, 48, train=train, seed=7,
                                               **kw)
            want = j_fetch.MnistDataSetIterator(16, 48, train=train, seed=7,
                                                **kw)
            assert got.synthetic and want.synthetic
            assert_same_batches(batches(got), batches(want))

    def test_cifar_surrogate(self):
        for kw in ({}, {"flatten": True, "train": False}):
            got = t_fetch.CifarDataSetIterator(8, 24, seed=3, **kw)
            want = j_fetch.CifarDataSetIterator(8, 24, seed=3, **kw)
            assert got.synthetic
            assert_same_batches(batches(got), batches(want))

    def test_lfw_surrogate(self):
        got = t_fetch.LFWDataSetIterator(4, num_examples=12, num_labels=5,
                                         image_shape=(20, 16), seed=2)
        want = j_fetch.LFWDataSetIterator(4, num_examples=12, num_labels=5,
                                          image_shape=(20, 16), seed=2)
        assert got.synthetic and got.labels_list == want.labels_list
        assert_same_batches(batches(got), batches(want))

    def test_iris(self):
        for n, b in ((150, 150), (31, 8)):
            got = t_fetch.IrisDataSetIterator(b, n)
            want = j_fetch.IrisDataSetIterator(b, n)
            assert_same_batches(batches(got), batches(want))

    def test_curves(self):
        got = t_fetch.CurvesDataSetIterator(batch_size=16, num_examples=48,
                                            seed=3)
        want = j_fetch.CurvesDataSetIterator(batch_size=16, num_examples=48,
                                             seed=3)
        assert got.synthetic
        out = batches(got)
        assert_same_batches(out, batches(want))
        for x, y in out:
            assert same(x, y)                 # autoencoder convention

    def test_package_exports(self):
        import deeplearning4j_tpu.datasets as j_datasets
        assert t_datasets.__all__ == j_datasets.__all__
        assert t_datasets.MnistDataSetIterator is t_fetch.MnistDataSetIterator


class TestFileReaders:
    @pytest.mark.parametrize("gz", [False, True])
    def test_read_idx(self, tmp_path, gz):
        rng = np.random.default_rng(9)
        for arr in (rng.integers(0, 256, (5, 3, 4)).astype(np.uint8),
                    rng.integers(-9, 9, (7,)).astype(np.int32),
                    rng.normal(size=(2, 6)).astype(np.float32)):
            p = tmp_path / (f"a{arr.dtype}.idx" + (".gz" if gz else ""))
            write_idx(p, arr, gz)
            got, want = t_fetch.read_idx(str(p)), j_fetch.read_idx(str(p))
            assert same(got, want) and np.array_equal(got, arr)
        bad = tmp_path / "bad.idx"
        bad.write_bytes(b"\x01\x00\x08\x01" + b"\x00" * 8)
        with pytest.raises(ValueError, match="not an idx file"):
            t_fetch.read_idx(str(bad))

    @pytest.mark.parametrize("gz", [False, True])
    def test_mnist_from_idx_files(self, offline, gz):
        """The real-file path: images equal the written pixels / 255, in
        both packages, shuffled or not, train and test."""
        written = write_mnist(offline / "mnist", gz=gz)
        for train, split in ((True, "train"), (False, "t10k")):
            for kw in ({"shuffle": False}, {"seed": 5},
                       {"binarize": True, "shuffle": False}):
                got = t_fetch.MnistDataSetIterator(8, train=train, **kw)
                want = j_fetch.MnistDataSetIterator(8, train=train, **kw)
                assert not got.synthetic and not want.synthetic
                out = batches(got)
                assert_same_batches(out, batches(want))
                if kw == {"shuffle": False}:
                    imgs, labs = written[split]
                    x = np.concatenate([b[0] for b in out])
                    y = np.concatenate([b[1] for b in out])
                    assert same(x, imgs.reshape(len(imgs), -1).astype(
                        np.float32) / 255.0)
                    assert np.array_equal(y.argmax(1), labs)

    def test_mnist_without_files_stays_offline(self, offline):
        """No cache and downloads off: the synthetic fallback, with no
        network attempt."""
        (offline / "mnist").mkdir()
        write_idx(offline / "mnist" / "train-images-idx3-ubyte",
                  np.zeros((2, 28, 28), np.uint8))       # labels missing
        calls = []
        orig = t_down.download_file

        def spy(*a, **k):
            calls.append(a)
            return orig(*a, **k)

        t_down.download_file = spy
        try:
            it = t_fetch.MnistDataSetIterator(4, 8, seed=1)
        finally:
            t_down.download_file = orig
        assert it.synthetic and calls == []

    def test_cifar_binary_batches(self, offline, tmp_path):
        rng = np.random.default_rng(0)
        n = 7
        recs = np.zeros((n, 3073), dtype=np.uint8)
        recs[:, 0] = np.arange(n) % 10
        recs[:, 1:] = rng.integers(0, 256, size=(n, 3072))
        p = tmp_path / "one.bin"
        recs.tofile(p)
        got, want = t_fetch.read_cifar_bin(str(p)), j_fetch.read_cifar_bin(
            str(p))
        assert same(got[0], want[0]) and same(got[1], want[1])
        assert same(got[0][0, :, :, 0], recs[0, 1:1025].reshape(32, 32)
                    .astype(np.float32) / 255.0)
        cache = offline / "cifar10"
        cache.mkdir()
        for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
                ["test_batch.bin"]:
            recs.tofile(cache / name)
        for kw in ({"train": True, "shuffle": False},
                   {"train": False, "seed": 4, "num_examples": 5}):
            t_it = t_fetch.CifarDataSetIterator(5, **kw)
            j_it = j_fetch.CifarDataSetIterator(5, **kw)
            assert not t_it.synthetic
            assert_same_batches(batches(t_it), batches(j_it))
        short = tmp_path / "short.bin"
        recs.reshape(-1)[:100].tofile(short)
        with pytest.raises(ValueError, match="CIFAR records"):
            t_fetch.read_cifar_bin(str(short))

    def test_lfw_directory(self, offline):
        from PIL import Image
        rng = np.random.default_rng(0)
        for person, count in [("Alice_A", 3), ("Bob_B", 2), ("Cy_C", 4)]:
            d = offline / "lfw" / person
            d.mkdir(parents=True)
            for i in range(count):
                arr = rng.integers(0, 256, size=(48, 48, 3)).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{person}_{i:04d}.jpg")
        kw = dict(num_examples=6, num_labels=2, image_shape=(24, 20))
        got = t_fetch.LFWDataSetIterator(3, shuffle=False, **kw)
        want = j_fetch.LFWDataSetIterator(3, shuffle=False, **kw)
        assert not got.synthetic and got.labels_list == want.labels_list
        assert_same_batches(batches(got), batches(want))

    def test_lfw_foreign_cache_falls_back(self, offline):
        (offline / "mnist").mkdir()
        it = t_fetch.LFWDataSetIterator(2, num_examples=4, num_labels=2,
                                        image_shape=(16, 16))
        assert it.synthetic

    def test_curves_cache_file(self, offline):
        data = np.random.default_rng(1).random((10, 784))
        (offline / "curves").mkdir()
        np.savez(offline / "curves" / "curves.npz", data=data)
        got = t_fetch.CurvesDataSetIterator(batch_size=4, num_examples=6)
        want = j_fetch.CurvesDataSetIterator(batch_size=4, num_examples=6)
        assert not got.synthetic
        assert_same_batches(batches(got), batches(want))


@pytest.fixture
def served(tmp_path):
    """A local http.server over a directory of seeded files."""
    root = tmp_path / "www"
    root.mkdir()
    rng = np.random.default_rng(77)
    files = {"a.bin": rng.integers(0, 256, 300_000).astype(np.uint8)
             .tobytes(), "b.bin": b"small file\n"}
    for name, body in files.items():
        (root / name).write_bytes(body)

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(root), **k)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, args=(0.05,),
                          daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", files
    finally:
        srv.shutdown()
        srv.server_close()


class TestDownloader:
    @pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
    def test_fetch_same_bytes(self, served, tmp_path, monkeypatch, pkg):
        base, files = served
        monkeypatch.setenv("DL4J_TPU_AUTO_DOWNLOAD", "1")
        sha = hashlib.sha256(files["a.bin"]).hexdigest()
        dest = tmp_path / "cache" / "a.bin"
        got = pkg.d.download_file([base + "/missing.bin", base + "/a.bin"],
                                  dest, sha256=sha)
        # the first mirror's 404 marks its host failed, so the second
        # (same host) is skipped: the reference's per-host memory
        assert got is None and pkg.d._failed_hosts
        pkg.d._failed_hosts.clear()
        assert pkg.d.download_file([base + "/a.bin"], dest,
                                   sha256=sha) == dest
        assert dest.read_bytes() == files["a.bin"]
        assert pkg.d.sha256_of(dest) == sha
        assert not list(dest.parent.glob("*.part*"))

    def test_packages_agree(self, served, tmp_path, monkeypatch):
        base, files = served
        monkeypatch.setenv("DL4J_TPU_AUTO_DOWNLOAD", "1")
        a = t_down.download_file([base + "/b.bin"], tmp_path / "t" / "b")
        b = j_down.download_file([base + "/b.bin"], tmp_path / "j" / "b")
        assert a.read_bytes() == b.read_bytes() == files["b.bin"]

    def test_checksum_mismatch_refused(self, served, tmp_path, monkeypatch):
        base, _ = served
        monkeypatch.setenv("DL4J_TPU_AUTO_DOWNLOAD", "1")
        dest = tmp_path / "cache" / "a.bin"
        assert t_down.download_file([base + "/a.bin"], dest,
                                    sha256="0" * 64) is None
        assert not dest.exists() and not list(dest.parent.glob("*"))
        host = base.split("//")[1]
        assert host in t_down._failed_hosts

    def test_cached_file_reused_or_replaced(self, served, tmp_path,
                                            monkeypatch):
        base, files = served
        dest = tmp_path / "cache" / "b.bin"
        dest.parent.mkdir()
        dest.write_bytes(files["b.bin"])
        sha = hashlib.sha256(files["b.bin"]).hexdigest()
        # downloads off: a good cached file is still returned
        assert t_down.download_file([base + "/b.bin"], dest,
                                    sha256=sha) == dest
        dest.write_bytes(b"corrupt")
        assert t_down.download_file([base + "/b.bin"], dest,
                                    sha256=sha) is None
        assert not dest.exists()                  # the bad entry is dropped
        monkeypatch.setenv("DL4J_TPU_AUTO_DOWNLOAD", "1")
        assert t_down.download_file([base + "/b.bin"], dest,
                                    sha256=sha) == dest
        assert dest.read_bytes() == files["b.bin"]

    def test_fetch_mnist_from_local_mirror(self, served, tmp_path,
                                           monkeypatch):
        """fetch_mnist over a local mirror of gzipped idx files, then the
        iterator reads them."""
        base, _ = served
        www = tmp_path / "www"
        written = write_mnist(www, gz=True)
        sums = {name: t_down.sha256_of(www / name)
                for name in t_down.MNIST_FILES}
        monkeypatch.setenv("DL4J_TPU_AUTO_DOWNLOAD", "1")
        cache = tmp_path / "data" / "mnist"
        assert t_down.fetch_mnist(cache, base_urls=[base],
                                  checksums=sums) == cache
        monkeypatch.setenv("DL4J_TPU_AUTO_DOWNLOAD", "0")
        it = t_fetch.MnistDataSetIterator(8, shuffle=False)
        assert not it.synthetic
        x = np.concatenate([b[0] for b in batches(it)])
        imgs = written["train"][0]
        assert same(x, imgs.reshape(len(imgs), -1).astype(np.float32)
                    / 255.0)
