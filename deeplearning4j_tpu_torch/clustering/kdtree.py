"""KD-tree (parity: reference ``kdtree/KDTree.java`` — axis-cycling median
tree with nearest-neighbour and k-NN search). Host numpy, carried over as
written from the JAX package's ``clustering/kdtree.py``."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index: int, axis: int):
        self.index = index
        self.axis = axis
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class KDTree:
    def __init__(self, points):
        self.points = np.asarray(points, dtype=np.float64)
        if self.points.ndim != 2:
            raise ValueError("points must be [n, d]")
        self.dims = self.points.shape[1]
        idx = np.arange(len(self.points))
        self.root = self._build(idx, depth=0)

    def _build(self, idx: np.ndarray, depth: int) -> Optional[_Node]:
        if len(idx) == 0:
            return None
        axis = depth % self.dims
        order = np.argsort(self.points[idx, axis], kind="stable")
        idx = idx[order]
        mid = len(idx) // 2
        node = _Node(int(idx[mid]), axis)
        node.left = self._build(idx[:mid], depth + 1)
        node.right = self._build(idx[mid + 1:], depth + 1)
        return node

    def size(self) -> int:
        return len(self.points)

    def nn(self, query) -> Tuple[int, float]:
        """Nearest neighbour: (index, distance)."""
        res = self.knn(query, 1)
        return res[0]

    def knn(self, query, k: int) -> List[Tuple[int, float]]:
        """k nearest: [(index, distance)] sorted ascending."""
        import heapq
        q = np.asarray(query, dtype=np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated dist

        def search(node: Optional[_Node]):
            if node is None:
                return
            p = self.points[node.index]
            d = float(np.linalg.norm(p - q))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = q[node.axis] - p[node.axis]
            near, far = (node.left, node.right) if diff <= 0 else \
                (node.right, node.left)
            search(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                search(far)

        search(self.root)
        return sorted(((i, -nd) for nd, i in heap), key=lambda t: t[1])
