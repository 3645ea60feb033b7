"""Vantage-point tree (parity: reference ``vptree/VPTree.java`` — metric-space
nearest-neighbour search; used by the reference for wordsNearest-style
queries). Host numpy, carried over as written from the JAX package's
``clustering/vptree.py``: the same seeded vantage points from the same
``np.random`` calls."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


class VPTree:
    """distance: "euclidean" (default) or "cosine" (parity: VPTree's
    configurable distance function)."""

    def __init__(self, points, distance: str = "euclidean",
                 seed: Optional[int] = 0):
        self.points = np.asarray(points, dtype=np.float64)
        self.distance = distance
        if distance == "cosine":
            norms = np.linalg.norm(self.points, axis=1, keepdims=True)
            self._normed = self.points / np.maximum(norms, 1e-12)
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(len(self.points))))

    def _dist(self, i: int, q: np.ndarray) -> float:
        if self.distance == "cosine":
            qn = q / max(np.linalg.norm(q), 1e-12)
            return float(1.0 - self._normed[i] @ qn)
        return float(np.linalg.norm(self.points[i] - q))

    def _build(self, idx: List[int]) -> Optional[_VPNode]:
        if not idx:
            return None
        vp = idx[self._rng.integers(0, len(idx))]
        rest = [i for i in idx if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        dists = [self._dist(i, self.points[vp]) for i in rest]
        node.threshold = float(np.median(dists))
        inside = [i for i, d in zip(rest, dists) if d <= node.threshold]
        outside = [i for i, d in zip(rest, dists) if d > node.threshold]
        if not outside and len(inside) == len(rest):
            # all distances equal (duplicate points): split arbitrarily so
            # the recursion always makes progress
            half = len(inside) // 2 or 1
            inside, outside = inside[:half], inside[half:]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    def knn(self, query, k: int) -> List[Tuple[int, float]]:
        import heapq
        q = np.asarray(query, dtype=np.float64)
        heap: List[Tuple[float, int]] = []

        def search(node: Optional[_VPNode]):
            if node is None:
                return
            d = self._dist(node.index, q)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            tau = -heap[0][0] if len(heap) == k else np.inf
            if d <= node.threshold:
                search(node.inside)
                if d + tau > node.threshold:
                    search(node.outside)
            else:
                search(node.outside)
                if d - tau <= node.threshold:
                    search(node.inside)

        search(self.root)
        return sorted(((i, -nd) for nd, i in heap), key=lambda t: t[1])

    def nn(self, query) -> Tuple[int, float]:
        return self.knn(query, 1)[0]
