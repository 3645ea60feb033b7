"""KMeans (parity: reference ``clustering/kmeans/KMeansClustering.java`` over
``algorithm/BaseClusteringAlgorithm.java`` — iterative assign/update with a
distance function and convergence condition; counterpart of the JAX
package's ``clustering/kmeans.py``).

k-means++ seeding on the host from ``np.random.default_rng(seed)``; each
iteration on the device: the [n, k] squared-distance matrix through the
||a-b||² = ||a||²+||b||²-2ab expansion, argmin assignment, the centroid
sums as one one-hot product, all in f32 (never TF32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import dtypes as _dtypes


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)
    return x2 + c2 - 2.0 * (x @ c.T)


def _kmeans_iter(x: torch.Tensor, centroids: torch.Tensor, *, k: int):
    """One assign/update step: (new centroids, assignments, cost). The
    argmin takes the first index on a tie; an empty cluster keeps its
    centroid; the cost is the sum of the minimum distances."""
    with _dtypes.exact_f32_matmul():
        d = _sq_dists(x, centroids)
        assign = torch.argmin(d, dim=1)
        one_hot = F.one_hot(assign, k).to(x.dtype)
        counts = torch.sum(one_hot, dim=0)
        sums = one_hot.T @ x
    new_c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp_min(counts[:, None], 1.0),
                        centroids)
    cost = torch.sum(torch.min(d, dim=1).values)
    return new_c, assign, cost


class KMeansClustering:
    """Usage (reference: ``KMeansClustering.setup(k, maxIter, distance)``)::

        km = KMeansClustering(k=3, max_iterations=100, seed=0)
        assignments = km.fit(points).predict(points)

    Runs on ``device`` (``"cuda"`` unless the caller passes ``"cpu"``)."""

    def __init__(self, k: int, max_iterations: int = 100,
                 tolerance: float = 1e-6, seed: Optional[int] = None,
                 device="cuda"):
        self.k = int(k)
        self.max_iterations = int(max_iterations)
        self.tolerance = float(tolerance)
        self.seed = seed
        self.device = _dtypes.resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.cost: Optional[float] = None
        self.iterations_run = 0

    def _kmeanspp_init(self, x: np.ndarray, rng) -> np.ndarray:
        """The reference's draws from ``rng``, with ``d2`` kept as a running
        minimum over the centroids chosen so far instead of the reference's
        [n, j, d] broadcast (the same values: each centroid's row sums are
        the broadcast's, and the minimum is exact)."""
        n = x.shape[0]
        centroids = [x[rng.integers(0, n)]]
        d2, buf = None, np.empty_like(x)
        for _ in range(1, self.k):
            # ((x - c) ** 2).sum(-1), in one reused buffer
            np.subtract(x, centroids[-1], out=buf)
            np.square(buf, out=buf)
            new = buf.sum(-1)
            d2 = new if d2 is None else np.minimum(d2, new, out=d2)
            probs = d2 / max(d2.sum(), 1e-12)
            centroids.append(x[rng.choice(n, p=probs)])
        return np.stack(centroids)

    def fit(self, points) -> "KMeansClustering":
        x = np.asarray(points, dtype=np.float32)
        if x.shape[0] < self.k:
            raise ValueError(f"need at least k={self.k} points, got {x.shape[0]}")
        rng = np.random.default_rng(self.seed)
        c = torch.from_numpy(self._kmeanspp_init(x, rng)).to(self.device)
        xt = torch.from_numpy(x).to(self.device)
        prev_cost = None
        for it in range(self.max_iterations):
            c, _, cost = _kmeans_iter(xt, c, k=self.k)
            cost = float(cost)
            self.iterations_run = it + 1
            if prev_cost is not None and abs(prev_cost - cost) <= \
                    self.tolerance * max(abs(prev_cost), 1.0):
                prev_cost = cost
                break
            prev_cost = cost
        self.centroids = c.cpu().numpy()
        self.cost = prev_cost
        return self

    def predict(self, points) -> np.ndarray:
        if self.centroids is None:
            raise ValueError("fit() first")
        x = torch.from_numpy(np.asarray(points, np.float32)).to(self.device)
        with _dtypes.exact_f32_matmul():
            d = _sq_dists(x, torch.from_numpy(self.centroids).to(self.device))
        return torch.argmin(d, dim=1).cpu().numpy().astype(np.int32)
