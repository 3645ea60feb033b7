"""Canned datasets: MNIST and Iris.

Parity: reference ``deeplearning4j-core/.../datasets/fetchers/MnistDataFetcher.java``
(+ ``base/MnistFetcher.java:43-51`` download/cache, ``mnist/MnistManager.java``
idx readers) and ``IrisDataFetcher.java``; iterators
``MnistDataSetIterator.java`` / ``IrisDataSetIterator.java``.

Counterpart of the JAX package's ``datasets/fetchers.py`` (host numpy
code; the synthetic surrogates draw from numpy's seeded generator exactly
as the reference does, so the arrays are equal bit for bit). Offline
behavior: besides the reference's lazy HTTP download (``downloader``;
``DL4J_TPU_AUTO_DOWNLOAD=0`` turns it off) we (1) read standard idx-format
files from a local cache directory if present (``$DL4J_TPU_DATA_DIR``,
``~/.cache/mnist``, ``~/.deeplearning4j/MNIST``), and (2) otherwise
synthesize a deterministic
MNIST-surrogate: 28×28 images with class-dependent geometric structure plus
noise — learnable to >97% by LeNet, so the end-to-end milestone is exercised
with identical shapes/dtypes to real MNIST. The surrogate is clearly flagged
via ``MnistDataSetIterator.synthetic``.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .dataset import DataSet
from .iterator import ArrayDataSetIterator

# ----------------------------------------------------------------------
# idx-file parsing (the real MNIST binary format, MnistManager analog)
# ----------------------------------------------------------------------


def read_idx(path: str) -> np.ndarray:
    """Parse an idx-format file (optionally gzipped)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: not an idx file (magic={zero})")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}[dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims)


_MNIST_FILES = {
    "train_images": ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz"),
}


def _cache_dirs(*names: str):
    """Candidate cache dirs for a dataset: ``$DL4J_TPU_DATA_DIR/<name>``
    (plus the root itself), ``~/.cache/<name>``, ``~/.deeplearning4j/<name>``."""
    env = os.environ.get("DL4J_TPU_DATA_DIR")
    cands = []
    if env:
        for n in names:
            cands.append(Path(env) / n)
        cands.append(Path(env))
    for n in names:
        cands.append(Path.home() / ".cache" / n)
        cands.append(Path.home() / ".deeplearning4j" / n)
    return cands


def _mnist_dirs():
    return _cache_dirs("mnist", "MNIST")


def _mnist_file(d: Path, key: str) -> Optional[Path]:
    for cand in _MNIST_FILES[key]:
        if (d / cand).exists():
            return d / cand
    return None


def _find_mnist(train: bool) -> Optional[Path]:
    """Directory holding BOTH the image and label file for the requested
    split; attempts an HTTP download into the cache when absent (parity:
    ``MnistFetcher.java:43`` lazy download); None → synthetic fallback."""
    img_key = "train_images" if train else "test_images"
    lbl_key = "train_labels" if train else "test_labels"
    for d in _mnist_dirs():
        if not d.is_dir():
            continue
        if _mnist_file(d, img_key) and _mnist_file(d, lbl_key):
            return d
    from .downloader import auto_download_enabled, fetch_mnist
    if auto_download_enabled():
        d = fetch_mnist()
        if d is not None and _mnist_file(d, img_key) and _mnist_file(d, lbl_key):
            return d
    return None


def _load_real_mnist(d: Path, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    img_key = "train_images" if train else "test_images"
    lbl_key = "train_labels" if train else "test_labels"
    images = read_idx(str(_mnist_file(d, img_key))).astype(np.float32) / 255.0
    labels = read_idx(str(_mnist_file(d, lbl_key))).astype(np.int64)
    return images.reshape(len(images), -1), labels


# ----------------------------------------------------------------------
# deterministic synthetic MNIST surrogate
# ----------------------------------------------------------------------


def _synthetic_mnist(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """28×28 grayscale images whose class determines geometric structure:
    each digit d gets a distinct combination of a horizontal bar, vertical
    bar, and filled disc whose positions derive from d. Learnable by a
    convnet but not linearly trivial (noise + jitter)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    imgs = np.zeros((n, 28, 28), dtype=np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    for i in range(n):
        d = int(labels[i])
        jx, jy = rng.integers(-2, 3, size=2)
        # horizontal bar at row 4 + 2*d (mod 24), vertical bar mirrored
        r = (4 + 2 * d) % 24 + jy
        c = (24 - 2 * d) % 24 + jx
        img = np.zeros((28, 28), dtype=np.float32)
        img[np.clip(r, 0, 27):np.clip(r + 3, 0, 28), 4:24] = 0.8
        img[4:24, np.clip(c, 0, 27):np.clip(c + 3, 0, 28)] = 0.8
        # disc whose center angle encodes d
        ang = 2 * np.pi * d / 10.0
        cy, cx = 14 + 8 * np.sin(ang) + jy, 14 + 8 * np.cos(ang) + jx
        disc = ((yy - cy) ** 2 + (xx - cx) ** 2) < (3 + (d % 3)) ** 2
        img[disc] = 1.0
        imgs[i] = img
    imgs += rng.normal(0.0, 0.08, size=imgs.shape).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    return imgs.reshape(n, 784), labels


def _one_hot(labels: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((len(labels), n), dtype=np.float32)
    out[np.arange(len(labels)), labels] = 1.0
    return out


class MnistDataSetIterator(ArrayDataSetIterator):
    """MNIST batches: features [b, 784] in [0,1], labels one-hot [b, 10].

    Parity: ``MnistDataSetIterator(batch, numExamples, binarize, train,
    shuffle, seed)``.
    """

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 binarize: bool = False, train: bool = True,
                 shuffle: bool = True, seed: int = 123):
        d = _find_mnist(train)
        self.synthetic = d is None
        if d is not None:
            feats, labels = _load_real_mnist(d, train)
        else:
            total = num_examples or (60000 if train else 10000)
            # train/test draw from disjoint seed streams
            feats, labels = _synthetic_mnist(total, seed + (0 if train else 10_000_019))
        if num_examples is not None:
            feats, labels = feats[:num_examples], labels[:num_examples]
        if binarize:
            feats = (feats > 0.5).astype(np.float32)
        if shuffle:
            order = np.random.default_rng(seed).permutation(len(feats))
            feats, labels = feats[order], labels[order]
        super().__init__(feats.astype(np.float32), _one_hot(labels, 10), batch_size)


# ----------------------------------------------------------------------
# CIFAR-10 (binary-batch format) — CifarDataSetIterator.java:1-175 analog
# ----------------------------------------------------------------------

_CIFAR_TRAIN = [f"data_batch_{i}.bin" for i in range(1, 6)]
_CIFAR_TEST = ["test_batch.bin"]
_CIFAR_RECORD = 1 + 3 * 32 * 32  # label byte + CHW uint8 pixels


def _cifar_dirs():
    base = _cache_dirs("cifar10", "cifar-10-batches-bin", "cifar")
    # fetch_cifar10 extracts to <cache>/cifar-10-batches-bin — scan those
    # nested layouts too so cached downloads are found even with
    # DL4J_TPU_AUTO_DOWNLOAD=0
    return base + [d / "cifar-10-batches-bin" for d in base]


def _find_cifar(train: bool) -> Optional[Path]:
    names = _CIFAR_TRAIN if train else _CIFAR_TEST
    for d in _cifar_dirs():
        if d.is_dir() and all((d / n).exists() for n in names):
            return d
    from .downloader import auto_download_enabled, fetch_cifar10
    if auto_download_enabled():
        d = fetch_cifar10()
        if d is not None and all((d / n).exists() for n in names):
            return d
    return None


def read_cifar_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one CIFAR-10 binary batch: each record is a label byte followed
    by 3072 CHW uint8 pixels. Returns (images [n, 32, 32, 3] float32 in
    [0,1] NHWC — the framework's conv layout — and labels [n])."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % _CIFAR_RECORD != 0:
        raise ValueError(f"{path}: size {raw.size} not a multiple of "
                         f"{_CIFAR_RECORD}-byte CIFAR records")
    recs = raw.reshape(-1, _CIFAR_RECORD)
    labels = recs[:, 0].astype(np.int64)
    imgs = recs[:, 1:].reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
    return imgs.transpose(0, 2, 3, 1), labels


def _synthetic_cifar(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """32×32 RGB surrogate: class determines a dominant hue gradient plus a
    textured patch, so a convnet can learn it but pixels aren't trivially
    separable."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    yy, xx = np.mgrid[0:32, 0:32] / 31.0
    imgs = np.zeros((n, 32, 32, 3), dtype=np.float32)
    for i in range(n):
        d = int(labels[i])
        ang = 2 * np.pi * d / 10.0
        base = 0.5 + 0.4 * np.cos(ang) * xx + 0.4 * np.sin(ang) * yy
        img = np.stack([base * (0.4 + 0.06 * ((d + k) % 3))
                        for k in range(3)], axis=-1)
        cy, cx = rng.integers(8, 24, size=2)
        img[cy - 4:cy + 4, cx - 4:cx + 4, d % 3] += 0.45
        imgs[i] = img
    imgs += rng.normal(0.0, 0.05, size=imgs.shape).astype(np.float32)
    return np.clip(imgs, 0.0, 1.0), labels


class CifarDataSetIterator(ArrayDataSetIterator):
    """CIFAR-10 batches (parity: ``CifarDataSetIterator.java:1-175``).

    Features ``[b, 32, 32, 3]`` NHWC float32 in [0,1] (the reference emits
    CHW; NHWC is the framework's conv layout), labels one-hot
    ``[b, 10]``. Reads the standard binary-batch files from a local cache
    dir; deterministic synthetic surrogate otherwise (``synthetic`` flag).
    """

    NUM_CLASSES = 10
    LABELS = ["airplane", "automobile", "bird", "cat", "deer",
              "dog", "frog", "horse", "ship", "truck"]

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, shuffle: bool = True, seed: int = 123,
                 flatten: bool = False):
        d = _find_cifar(train)
        self.synthetic = d is None
        if d is not None:
            names = _CIFAR_TRAIN if train else _CIFAR_TEST
            parts = [read_cifar_bin(str(d / n)) for n in names]
            feats = np.concatenate([p[0] for p in parts])
            labels = np.concatenate([p[1] for p in parts])
        else:
            total = num_examples or (50000 if train else 10000)
            feats, labels = _synthetic_cifar(
                total, seed + (0 if train else 10_000_019))
        # shuffle BEFORE truncating: a subset must sample across the whole
        # training set, not a deterministic prefix of data_batch_1
        if shuffle:
            order = np.random.default_rng(seed).permutation(len(feats))
            feats, labels = feats[order], labels[order]
        if num_examples is not None:
            feats, labels = feats[:num_examples], labels[:num_examples]
        if flatten:
            feats = feats.reshape(len(feats), -1)
        super().__init__(feats, _one_hot(labels, 10), batch_size)


# ----------------------------------------------------------------------
# LFW (labeled faces) — LFWDataSetIterator analog
# ----------------------------------------------------------------------


def _lfw_dirs():
    return _cache_dirs("lfw")


def _find_lfw() -> Optional[Path]:
    """A directory is an LFW cache only if it actually holds the standard
    ``<person>/*.jpg`` layout (a root cached for another dataset must fall
    through to the synthetic surrogate, not crash the loader)."""
    for d in _lfw_dirs():
        if not d.is_dir():
            continue
        if any(p.is_dir() and any(p.glob("*.jpg")) for p in d.iterdir()):
            return d
    return None


class LFWDataSetIterator(ArrayDataSetIterator):
    """Labeled-faces batches (parity: ``LFWDataSetIterator.java``).

    Scans ``<cache>/lfw/<person>/*.jpg`` directories (the standard LFW
    layout), decodes + resizes via PIL, labels = person identity one-hot
    over the ``num_labels`` most-photographed people. Synthetic face-like
    surrogate (``synthetic`` flag) when the dataset is absent.
    """

    def __init__(self, batch_size: int, num_examples: int = 1000,
                 num_labels: int = 10, image_shape: Tuple[int, int] = (64, 64),
                 shuffle: bool = True, seed: int = 123):
        d = _find_lfw()
        self.synthetic = d is None
        h, w = image_shape
        if d is not None:
            from PIL import Image
            people = sorted((p for p in d.iterdir()
                             if p.is_dir() and any(p.glob("*.jpg"))),
                            key=lambda p: -len(list(p.glob("*.jpg"))))
            people = people[:num_labels]
            self.labels_list = [p.name for p in people]
            feats, labels = [], []
            for ci, person in enumerate(people):
                for img_path in sorted(person.glob("*.jpg")):
                    if len(feats) >= num_examples:
                        break
                    img = Image.open(img_path).convert("RGB").resize((w, h))
                    feats.append(np.asarray(img, dtype=np.float32) / 255.0)
                    labels.append(ci)
            feats = np.stack(feats)
            labels = np.asarray(labels)
        else:
            rng = np.random.default_rng(seed)
            labels = rng.integers(0, num_labels, size=num_examples)
            yy, xx = np.mgrid[0:h, 0:w]
            feats = np.zeros((num_examples, h, w, 3), dtype=np.float32)
            self.labels_list = [f"person_{i}" for i in range(num_labels)]
            for i in range(num_examples):
                c = int(labels[i])
                # face-ish blob whose geometry depends on identity
                cy, cx = h * (0.35 + 0.03 * (c % 5)), w * (0.5 + 0.02 * (c % 3))
                r2 = ((yy - cy) / (0.30 * h)) ** 2 + ((xx - cx) / (0.22 * w)) ** 2
                face = np.clip(1.2 - r2, 0, 1)
                tone = 0.35 + 0.05 * (c % 7)
                img = np.stack([face * (tone + 0.08 * k) for k in range(3)],
                               axis=-1)
                feats[i] = np.clip(
                    img + rng.normal(0, 0.04, size=img.shape), 0, 1)
        if shuffle:
            order = np.random.default_rng(seed).permutation(len(feats))
            feats, labels = feats[order], labels[order]
        super().__init__(feats, _one_hot(labels, num_labels), batch_size)


class IrisDataSetIterator(ArrayDataSetIterator):
    """Iris-shaped 3-class dataset: features [b, 4], labels one-hot [b, 3].

    Parity: ``IrisDataFetcher.java`` / ``IrisDataSetIterator.java``. Offline
    surrogate: three 4-D Gaussian clusters with means/covariances matching the
    published per-class statistics of Fisher's iris data (setosa/versicolor/
    virginica sepal+petal length/width), deterministic by seed — same shapes,
    same learnability profile.
    """

    # per-class feature means (sepal_l, sepal_w, petal_l, petal_w) and stds —
    # the published summary statistics of the classic dataset
    _MEANS = np.array([[5.006, 3.428, 1.462, 0.246],
                       [5.936, 2.770, 4.260, 1.326],
                       [6.588, 2.974, 5.552, 2.026]])
    _STDS = np.array([[0.352, 0.379, 0.174, 0.105],
                      [0.516, 0.314, 0.470, 0.198],
                      [0.636, 0.322, 0.552, 0.275]])

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 seed: int = 6):
        rng = np.random.default_rng(seed)
        per = num_examples // 3
        feats, labels = [], []
        for c in range(3):
            n = per if c < 2 else num_examples - 2 * per
            feats.append(rng.normal(self._MEANS[c], self._STDS[c], size=(n, 4)))
            labels.append(np.full(n, c))
        feats = np.concatenate(feats).astype(np.float32)
        labels = np.concatenate(labels)
        order = rng.permutation(len(feats))
        super().__init__(feats[order], _one_hot(labels[order], 3), batch_size)


# ----------------------------------------------------------------------
# Curves — CurvesDataFetcher analog
# ----------------------------------------------------------------------


def _synthetic_curves(n: int, seed: int, size: int = 28) -> np.ndarray:
    """28×28 grayscale images of random cubic Bézier curves — the shape of
    Hinton's deep-autoencoder "curves" dataset.

    Parity: ``deeplearning4j-core/.../datasets/fetchers/CurvesDataFetcher.java``
    downloads a pre-serialized ND4J DataSet (a JVM binary this framework
    deliberately does not parse); this is a faithful generative surrogate —
    each example is a smooth random curve rasterized with anti-aliasing,
    matching the original's construction (random control points → curve
    image) and its unsupervised use (features double as targets).
    """
    rng = np.random.default_rng(seed)
    # sample the Bézier densely and splat with bilinear weights
    t = np.linspace(0.0, 1.0, 160)
    b0 = (1 - t) ** 3
    b1 = 3 * t * (1 - t) ** 2
    b2 = 3 * t ** 2 * (1 - t)
    b3 = t ** 3
    imgs = np.zeros((n, size, size), dtype=np.float32)
    pts = rng.uniform(2.0, size - 3.0, size=(n, 4, 2))
    basis = np.stack([b0, b1, b2, b3])                  # [4, T]
    curves = np.einsum("kt,nkd->ntd", basis, pts)       # [n, T, 2]
    cx, cy = curves[..., 0], curves[..., 1]             # [n, T]
    x0, y0 = np.floor(cx).astype(int), np.floor(cy).astype(int)
    fx, fy = cx - x0, cy - y0
    idx = np.broadcast_to(np.arange(n)[:, None], cx.shape)
    np.add.at(imgs, (idx, y0, x0), (1 - fx) * (1 - fy))
    np.add.at(imgs, (idx, y0, x0 + 1), fx * (1 - fy))
    np.add.at(imgs, (idx, y0 + 1, x0), (1 - fx) * fy)
    np.add.at(imgs, (idx, y0 + 1, x0 + 1), fx * fy)
    return np.clip(imgs, 0.0, 1.0).reshape(n, size * size)


class CurvesDataSetIterator(ArrayDataSetIterator):
    """Curves dataset for unsupervised pretraining (labels == features, the
    autoencoder convention of the reference's fetcher).

    Parity: ``CurvesDataFetcher.java`` + ``datasets/iterator/impl`` usage in
    deep-autoencoder examples. A cached ``curves.npz`` (key ``data``,
    [n, 784] float) under the dataset cache dirs is used when present;
    otherwise the generative surrogate above.
    """

    def __init__(self, batch_size: int = 100, num_examples: int = 1000,
                 seed: int = 42):
        data = None
        for d in _cache_dirs("curves"):
            f = d / "curves.npz"
            if f.exists():
                data = np.load(f)["data"][:num_examples].astype(np.float32)
                break
        self.synthetic = data is None
        if data is None:
            data = _synthetic_curves(num_examples, seed)
        super().__init__(data, data.copy(), batch_size)
