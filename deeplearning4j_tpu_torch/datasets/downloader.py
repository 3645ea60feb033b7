"""HTTP dataset download + cache + checksum verification.

Parity: reference ``base/MnistFetcher.java:43-54`` — ``downloadAndUntar``
fetches the canonical archives into ``~/.deeplearning4j`` and is invoked
lazily by the data fetchers when local files are absent.

Counterpart of the JAX package's ``datasets/downloader.py``. Design: mirror
lists per file (primary + alternates), streaming download to
a temp file, optional sha256 verification, atomic rename into the cache dir.
Zero-egress environments simply get ``None`` back (offline-safe: fetchers
fall through to their synthetic surrogates). ``DL4J_TPU_AUTO_DOWNLOAD=0``
disables network attempts entirely.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

DEFAULT_TIMEOUT = float(os.environ.get("DL4J_TPU_DOWNLOAD_TIMEOUT", "15"))

# Hosts that already failed this process — never re-attempted, so offline
# (zero-egress) environments pay each unreachable mirror's timeout at most
# once per run instead of once per iterator construction.
_failed_hosts: set = set()


def _host(url: str) -> str:
    return urllib.parse.urlsplit(url).netloc


def auto_download_enabled() -> bool:
    return os.environ.get("DL4J_TPU_AUTO_DOWNLOAD", "1") != "0"


def sha256_of(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_file(urls: Sequence[str], dest: Path, *,
                  sha256: Optional[str] = None,
                  timeout: float = DEFAULT_TIMEOUT) -> Optional[Path]:
    """Fetch the first working mirror into ``dest`` (atomic). Returns the
    path, or None if every mirror fails / network is unavailable. An existing
    file that passes the checksum is reused without touching the network."""
    dest = Path(dest)
    if dest.exists():
        if sha256 is None or sha256_of(dest) == sha256:
            return dest
        dest.unlink()  # corrupt/partial cache entry
    if not auto_download_enabled():
        return None
    dest.parent.mkdir(parents=True, exist_ok=True)
    for url in urls:
        if _host(url) in _failed_hosts:
            continue
        tmp = None
        try:
            fd, tmp = tempfile.mkstemp(dir=str(dest.parent),
                                       prefix=dest.name + ".part")
            # own the fd via fdopen BEFORE urlopen can raise, so failed
            # mirrors never leak descriptors
            with os.fdopen(fd, "wb") as out, \
                    urllib.request.urlopen(url, timeout=timeout) as r:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
            if sha256 is not None and sha256_of(Path(tmp)) != sha256:
                raise IOError(f"checksum mismatch for {url}")
            os.replace(tmp, dest)
            return dest
        except Exception:
            _failed_hosts.add(_host(url))
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)
            continue
    return None


# ----------------------------------------------------------------------
# dataset manifests (canonical + mirror URLs; checksums of the canonical
# archives where stable)
# ----------------------------------------------------------------------

MNIST_BASE_URLS = (
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
    "http://yann.lecun.com/exdb/mnist/",   # the reference's canonical host
)

MNIST_FILES: Dict[str, str] = {
    "train-images-idx3-ubyte.gz":
        "440fcabf73cc546fa21475e81ea370265605f56be210a4024d2ca8f203523609",
    "train-labels-idx1-ubyte.gz":
        "3552534a0a558bbed6aed32b30c495cca23d567ec52cac8be1a0730e8010255c",
    "t10k-images-idx3-ubyte.gz":
        "8d422c7b0a1c1c79245a5bcf07fe86e33eeafee792b84584aec276f5a2dbc4e6",
    "t10k-labels-idx1-ubyte.gz":
        "f7ae60f92e00ec6debd23a6088c31dbd2371eca3ffa0defaefb259924204aec6",
}

CIFAR10_URLS = (
    "https://www.cs.toronto.edu/~kriz/cifar-10-binary.tar.gz",
)
CIFAR10_SHA256 = \
    "c4a38c50a1bc5f3a1c5537f2155ab9d68f9f25eb1ed8d9ddda3db29a59bca1dd"


def fetch_mnist(cache_dir: Optional[Path] = None,
                base_urls: Iterable[str] = MNIST_BASE_URLS,
                checksums: Optional[Dict[str, str]] = MNIST_FILES,
                ) -> Optional[Path]:
    """Download the four MNIST idx archives into the cache; returns the cache
    dir if all four are present afterwards, else None."""
    cache = Path(cache_dir) if cache_dir else Path.home() / ".cache" / "mnist"
    names = (checksums or MNIST_FILES).keys()
    ok = True
    for name in names:
        sha = checksums.get(name) if checksums else None
        urls = [b.rstrip("/") + "/" + name for b in base_urls]
        if download_file(urls, cache / name, sha256=sha) is None:
            ok = False
    return cache if ok else None


def fetch_cifar10(cache_dir: Optional[Path] = None,
                  urls: Iterable[str] = CIFAR10_URLS,
                  sha256: Optional[str] = CIFAR10_SHA256) -> Optional[Path]:
    """Download + extract the CIFAR-10 binary batches; returns the directory
    holding data_batch_*.bin, else None."""
    import tarfile

    cache = Path(cache_dir) if cache_dir else Path.home() / ".cache" / "cifar10"
    marker = cache / "cifar-10-batches-bin" / "data_batch_1.bin"
    if marker.exists():
        return marker.parent
    archive = download_file(list(urls), cache / "cifar-10-binary.tar.gz",
                            sha256=sha256)
    if archive is None:
        return None
    try:
        with tarfile.open(archive) as tf:
            tf.extractall(cache, filter="data")
    except TypeError:  # python < 3.12 lacks the filter kwarg
        with tarfile.open(archive) as tf:
            tf.extractall(cache)
    return marker.parent if marker.exists() else None
