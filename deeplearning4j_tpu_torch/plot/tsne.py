"""t-SNE (parity: reference ``plot/Tsne.java`` exact version and
``plot/BarnesHutTsne.java``; counterpart of the JAX package's
``plot/tsne.py``).

Two regimes, both real:

- **Dense exact** (:class:`Tsne`, and BarnesHutTsne with ``theta=0`` or
  n ≤ ``dense_threshold``): the [n, n] affinity and repulsion matrices as
  dense PyTorch ops on ``device`` (f32 products, never TF32); the momentum
  loop reads nothing back to the host until it ends.
- **Barnes-Hut** (:class:`BarnesHutTsne`, ``theta>0`` above the threshold):
  on the host, as the reference runs it — O(uN) sparse input similarities
  from k-nearest-neighbors (k = 3·perplexity) + O(N log N) repulsion
  through the SpTree walk in C++ (``clustering/native.py``), or the
  pure-Python tree (``clustering/sptree.py``) when no compiler is there.
  The host code is the reference's numpy, carried over as written.

Perplexity calibration (binary search for per-point precisions) runs over
all points at once: 40 fixed steps on the device for the dense path, 50
over the kNN distances in numpy for the BH path.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import dtypes as _dtypes


def _calibrated_P(x: torch.Tensor, *, perplexity: float) -> torch.Tensor:
    """Symmetrised P matrix via a vectorised binary search on the
    precisions. As in the reference, the entropy ``h`` is [n] while the
    precisions start [n, 1], so the first ``where`` broadcasts them to
    [n, n] and every later step searches per (row, column)."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    with _dtypes.exact_f32_matmul():
        x2 = torch.sum(x * x, dim=1)
        d2 = x2[:, None] + x2[None, :] - 2.0 * (x @ x.T)
    d2 = d2.masked_fill(eye, 0.0)
    log_u = float(np.log(np.float32(perplexity)))

    def entropy_and_p(beta):
        logits = (-d2 * beta).masked_fill(eye, -math.inf)
        p = torch.softmax(logits, dim=1)
        # p·log p only where p > 1e-12: the clamp keeps log(0) (and with
        # it 0·-inf = NaN) out of the branch that ``where`` drops
        plogp = torch.where(p > 1e-12, p * torch.log(p.clamp_min(1e-12)),
                            0.0)
        return -torch.sum(plogp, dim=1), p

    beta = torch.ones((n, 1), dtype=torch.float32, device=x.device)
    lo = torch.zeros((n, 1), dtype=torch.float32, device=x.device)
    hi = torch.full((n, 1), math.inf, dtype=torch.float32, device=x.device)
    p = None
    for _ in range(40):   # fixed-iteration binary search
        h, p = entropy_and_p(beta)
        too_high = h > log_u            # entropy too high → raise beta
        new_lo = torch.where(too_high, beta, lo)
        new_hi = torch.where(too_high, hi, beta)
        beta = torch.where(
            too_high,
            torch.where(torch.isinf(new_hi), beta * 2.0,
                        (beta + new_hi) / 2.0),
            torch.where(new_lo <= 0.0, beta / 2.0, (beta + new_lo) / 2.0))
        lo, hi = new_lo, new_hi
    p = (p + p.T) / (2.0 * n)
    return torch.clamp_min(p, 1e-12)


def _tsne_grad(y: torch.Tensor, P: torch.Tensor):
    """(gradient [n, d], KL) of the exact t-SNE cost."""
    n = y.shape[0]
    with _dtypes.exact_f32_matmul():
        y2 = torch.sum(y * y, dim=1)
        num = 1.0 / (1.0 + y2[:, None] + y2[None, :] - 2.0 * (y @ y.T))
        num = num.masked_fill(torch.eye(n, dtype=torch.bool, device=y.device),
                              0.0)
        Q = torch.clamp_min(num / torch.sum(num), 1e-12)
        PQ = (P - Q) * num
        grad = 4.0 * ((torch.diag(torch.sum(PQ, dim=1)) - PQ) @ y)
    kl = torch.sum(P * torch.log(P / Q))
    return grad, kl


class Tsne:
    """Exact t-SNE (reference builder knobs: ``perplexity``,
    ``learningRate``, ``maxIter``, momentum switch, early exaggeration).
    The dense path runs on ``device`` (``"cuda"`` unless the caller passes
    ``"cpu"``)."""

    def __init__(self, *, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, max_iter: int = 500,
                 early_exaggeration: float = 12.0, exaggeration_iters: int = 100,
                 initial_momentum: float = 0.5, final_momentum: float = 0.8,
                 momentum_switch: int = 250, seed: int = 42,
                 use_pca_init: bool = True, device="cuda"):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.momentum_switch = momentum_switch
        self.seed = seed
        self.use_pca_init = use_pca_init
        self.device = _dtypes.resolve_device(device)
        self.embedding: Optional[np.ndarray] = None
        self.kl_divergence: Optional[float] = None

    def _initial_y(self, x: np.ndarray) -> np.ndarray:
        """PCA scaled by 1e-2, else N(0, 1e-4) draws from the seed."""
        rng = np.random.default_rng(self.seed)
        if self.use_pca_init and x.shape[1] > self.n_components:
            xc = x - x.mean(axis=0)
            _, _, vt = np.linalg.svd(xc, full_matrices=False)
            return (xc @ vt[:self.n_components].T) * 1e-2
        return rng.normal(0, 1e-4, size=(x.shape[0], self.n_components))

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        n = x.shape[0]
        if n - 1 < 3 * self.perplexity:
            raise ValueError(
                f"perplexity {self.perplexity} too large for n={n} "
                "(need n-1 >= 3*perplexity)")
        P = _calibrated_P(torch.from_numpy(x).to(self.device),
                          perplexity=self.perplexity)
        P_ex = P * self.early_exaggeration
        y = torch.from_numpy(self._initial_y(x).astype(np.float32)).to(
            self.device)
        vel = torch.zeros_like(y)
        kl = None
        for it in range(self.max_iter):
            grad, kl = _tsne_grad(y, P_ex if it < self.exaggeration_iters
                                  else P)
            mom = self.initial_momentum if it < self.momentum_switch \
                else self.final_momentum
            vel = mom * vel - self.learning_rate * grad
            y = y + vel
            y = y - torch.mean(y, dim=0)
        self.embedding = y.cpu().numpy()
        self.kl_divergence = float(kl) if kl is not None else None
        return self.embedding


def _knn_sparse_p(x: np.ndarray, perplexity: float, k: int
                  ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """Symmetrized sparse input similarities over k nearest neighbors
    (parity: ``BarnesHutTsne.computeGaussianPerplexity`` sparse variant).
    Returns CSR (row_ptr, cols, vals); vals sum to 1."""
    n = x.shape[0]
    k = min(k, n - 1)
    # chunked exact kNN (the reference uses a VPTree; brute-force chunks are
    # simpler and BLAS-fast at the n this path serves)
    x2 = np.sum(x * x, axis=1)
    nbr = np.empty((n, k), dtype=np.int64)
    nbr_d2 = np.empty((n, k), dtype=np.float64)
    chunk = max(1, int(2e8 // max(n, 1)))
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        d2 = x2[s:e, None] + x2[None, :] - 2.0 * (x[s:e] @ x.T)
        np.fill_diagonal(d2[:, s:e], np.inf)
        idx = np.argpartition(d2, k, axis=1)[:, :k]
        part = np.take_along_axis(d2, idx, axis=1)
        order = np.argsort(part, axis=1)
        nbr[s:e] = np.take_along_axis(idx, order, axis=1)
        nbr_d2[s:e] = np.take_along_axis(part, order, axis=1)
    # per-point beta binary search on the kNN distances
    log_u = np.log(perplexity)
    beta = np.ones(n)
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    P = np.zeros((n, k))
    for _ in range(50):
        logits = -nbr_d2 * beta[:, None]
        logits -= logits.max(axis=1, keepdims=True)
        expd = np.exp(logits)
        P = expd / expd.sum(axis=1, keepdims=True)
        H = -np.sum(np.where(P > 1e-12, P * np.log(P), 0.0), axis=1)
        too_high = H > log_u
        lo = np.where(too_high, beta, lo)
        hi = np.where(too_high, hi, beta)
        beta = np.where(
            too_high,
            np.where(np.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            np.where(lo <= 0.0, beta / 2.0, (beta + lo) / 2.0))
    # symmetrize: P_ij = (P_j|i + P_i|j) / 2n over the union of edges
    from collections import defaultdict
    sym: "defaultdict[tuple, float]" = defaultdict(float)
    for i in range(n):
        for c in range(k):
            j = int(nbr[i, c])
            v = P[i, c] / (2.0 * n)
            sym[(i, j)] += v
            sym[(j, i)] += v
    rows = np.fromiter((ij[0] for ij in sym), dtype=np.int64, count=len(sym))
    cols = np.fromiter((ij[1] for ij in sym), dtype=np.int64, count=len(sym))
    vals = np.fromiter(sym.values(), dtype=np.float64, count=len(sym))
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(row_ptr, rows + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    return row_ptr, cols, vals


def _bh_gradient_python(y, row_ptr, cols, vals, theta):
    """Pure-Python BH gradient via clustering.sptree (oracle/fallback)."""
    from ..clustering.sptree import SpTree
    n, d = y.shape
    tree = SpTree(y)
    neg = np.zeros((n, d))
    sum_q = 0.0
    for i in range(n):
        f, q = tree.compute_non_edge_forces(i, theta)
        neg[i] = f
        sum_q += q
    sum_q = max(sum_q, 1e-12)
    pos = np.zeros((n, d))
    kl = 0.0
    for i in range(n):
        for e in range(row_ptr[i], row_ptr[i + 1]):
            j = cols[e]
            diff = y[i] - y[j]
            q = 1.0 / (1.0 + diff @ diff)
            pos[i] += vals[e] * q * diff
            qn = max(q / sum_q, 1e-12)
            if vals[e] > 1e-12:
                kl += vals[e] * np.log(vals[e] / qn)
    return 4.0 * (pos - neg / sum_q), kl


class BarnesHutTsne(Tsne):
    """Barnes-Hut t-SNE (parity: ``plot/BarnesHutTsne.java``): sparse kNN
    input similarities + SpTree-approximated repulsion, O(N log N) per
    iteration, on the host. ``theta=0`` (or n ≤ ``dense_threshold``) takes
    the exact dense path on ``device`` instead."""

    def __init__(self, *, theta: float = 0.5, dense_threshold: int = 2048,
                 **kw):
        super().__init__(**kw)
        self.theta = theta
        self.dense_threshold = int(dense_threshold)

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        if self.theta <= 0.0 or n <= self.dense_threshold:
            return super().fit_transform(x)
        if n - 1 < 3 * self.perplexity:
            raise ValueError(
                f"perplexity {self.perplexity} too large for n={n}")
        k = int(3 * self.perplexity)
        row_ptr, cols, vals = _knn_sparse_p(x, self.perplexity, k)
        y = np.ascontiguousarray(self._initial_y(x), dtype=np.float64)
        vel = np.zeros_like(y)

        from ..clustering import native
        use_native = native.load() is not None
        kl = None
        for it in range(self.max_iter):
            scale = (self.early_exaggeration
                     if it < self.exaggeration_iters else 1.0)
            v = vals * scale
            if use_native:
                grad, kl = native.bh_gradient(y, row_ptr, cols, v,
                                              self.theta)
            else:
                grad, kl = _bh_gradient_python(y, row_ptr, cols, v,
                                               self.theta)
            mom = (self.initial_momentum if it < self.momentum_switch
                   else self.final_momentum)
            vel = mom * vel - self.learning_rate * grad
            y = y + vel
            y = y - y.mean(axis=0)
        self.embedding = np.asarray(y, dtype=np.float32)
        self.kl_divergence = float(kl) if kl is not None else None
        return self.embedding
