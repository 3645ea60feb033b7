"""SpTree / QuadTree: Barnes-Hut space-partitioning trees.

Parity: reference ``clustering/sptree/SpTree.java`` (k-dimensional,
center-of-mass nodes, ``computeNonEdgeForces`` with the theta criterion,
``computeEdgeForces`` over sparse similarities) and
``clustering/quadtree/QuadTree.java`` (the 2-D special case).

Host numpy, carried over as written from the JAX package's
``clustering/sptree.py``. This is the pure-Python reference
implementation — the correctness oracle for the C++ kernel
(:mod:`.native`) that BarnesHutTsne actually uses at scale. Array-based (no per-node objects): children/centers/masses live in
preallocated numpy arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class SpTree:
    """k-d Barnes-Hut tree over points [n, d] (parity: ``SpTree.java``)."""

    def __init__(self, points: np.ndarray, capacity_mult: int = 4):
        points = np.asarray(points, dtype=np.float64)
        n, d = points.shape
        self.points = points
        self.n, self.d = n, d
        self.n_children = 1 << d
        max_nodes = max(4 * n + 64, 64)
        self._center = np.zeros((max_nodes, d))       # cell geometric center
        self._width = np.zeros((max_nodes, d))        # cell half-width
        self._com = np.zeros((max_nodes, d))          # center of mass
        self._count = np.zeros(max_nodes, dtype=np.int64)
        self._point = np.full(max_nodes, -1, dtype=np.int64)  # leaf payload
        self._children = np.full((max_nodes, self.n_children), -1,
                                 dtype=np.int64)
        self._n_nodes = 1
        lo, hi = points.min(axis=0), points.max(axis=0)
        mid = (lo + hi) / 2.0
        half = np.maximum((hi - lo) / 2.0, 1e-10) * 1.0000001
        self._center[0] = mid
        self._width[0] = half
        for i in range(n):
            self._insert(0, i)
        # per-node max half-width, computed once — recomputing this over the
        # whole preallocated array per query point is O(n^2) across a t-SNE
        # iteration (the C++ kernel keeps the same maxw[] cache)
        self._maxw = self._width[:self._n_nodes].max(axis=1)

    # ------------------------------------------------------------------

    def _child_index(self, node: int, p: np.ndarray) -> int:
        idx = 0
        for a in range(self.d):
            if p[a] > self._center[node, a]:
                idx |= (1 << a)
        return idx

    def _alloc_child(self, node: int, ci: int) -> int:
        new = self._n_nodes
        if new >= len(self._count):
            self._grow()
        self._n_nodes += 1
        half = self._width[node] / 2.0
        offs = np.array([half[a] if (ci >> a) & 1 else -half[a]
                         for a in range(self.d)])
        self._center[new] = self._center[node] + offs
        self._width[new] = half
        self._children[node, ci] = new
        return new

    def _grow(self) -> None:
        for name in ("_center", "_width", "_com"):
            arr = getattr(self, name)
            setattr(self, name, np.concatenate([arr, np.zeros_like(arr)]))
        self._count = np.concatenate([self._count,
                                      np.zeros_like(self._count)])
        self._point = np.concatenate([self._point,
                                      np.full_like(self._point, -1)])
        self._children = np.concatenate(
            [self._children, np.full_like(self._children, -1)])

    def _insert(self, node: int, i: int) -> None:
        p = self.points[i]
        while True:
            c = self._count[node]
            self._com[node] = (self._com[node] * c + p) / (c + 1)
            self._count[node] = c + 1
            if c == 0:                      # empty leaf: store point
                self._point[node] = i
                return
            if self._point[node] >= 0:      # occupied leaf: split
                j = self._point[node]
                if np.allclose(self.points[j], p, atol=1e-12):
                    return                  # duplicate point: mass only
                self._point[node] = -1
                cj = self._child_index(node, self.points[j])
                child = self._children[node, cj]
                if child < 0:
                    child = self._alloc_child(node, cj)
                # re-descend the displaced point into the subtree (its mass
                # above `node` is already accounted)
                self._insert(child, j)
            ci = self._child_index(node, p)
            child = self._children[node, ci]
            if child < 0:
                child = self._alloc_child(node, ci)
            node = child

    # ------------------------------------------------------------------

    def is_correct(self) -> bool:
        """Every point lies inside its cell (parity: SpTree.isCorrect)."""
        for node in range(self._n_nodes):
            i = self._point[node]
            if i < 0:
                continue
            p = self.points[i]
            if np.any(np.abs(p - self._center[node]) > self._width[node]):
                return False
        return True

    def depth(self) -> int:
        def _d(node):
            kids = [c for c in self._children[node] if c >= 0]
            return 1 + (max(_d(c) for c in kids) if kids else 0)
        return _d(0)

    def compute_non_edge_forces(self, i: int, theta: float
                                ) -> Tuple[np.ndarray, float]:
        """Repulsive force on point i via the theta criterion; returns
        (neg_force [d], sum_Q contribution) — parity:
        ``SpTree.computeNonEdgeForces``."""
        p = self.points[i]
        neg = np.zeros(self.d)
        sum_q = 0.0
        max_width = self._maxw
        stack = [0]
        while stack:
            node = stack.pop()
            cnt = self._count[node]
            if cnt == 0:
                continue
            if self._point[node] == i and cnt == 1:
                continue
            diff = p - self._com[node]
            d2 = float(diff @ diff)
            is_leaf = self._point[node] >= 0
            if is_leaf or (max_width[node] * max_width[node]
                           < theta * theta * d2):
                # single point, or far enough: treat cell as one mass
                cnt_eff = cnt - (1 if self._point[node] == i else 0)
                if cnt_eff <= 0:
                    continue
                q = 1.0 / (1.0 + d2)
                sum_q += cnt_eff * q
                neg += cnt_eff * q * q * diff
            else:
                for c in self._children[node]:
                    if c >= 0:
                        stack.append(c)
        return neg, sum_q


class QuadTree(SpTree):
    """2-D Barnes-Hut tree (parity: ``quadtree/QuadTree.java``)."""

    def __init__(self, points: np.ndarray):
        points = np.asarray(points, dtype=np.float64)
        if points.shape[1] != 2:
            raise ValueError("QuadTree requires 2-D points")
        super().__init__(points)
