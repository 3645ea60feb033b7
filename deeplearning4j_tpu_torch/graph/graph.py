"""Adjacency-list graph (a copy of the JAX package's ``graph/graph.py``,
host code; parity: reference ``graph/graph/Graph.java`` over
``api/IGraph.java`` — vertices 0..n-1, optional edge weights, directed or
undirected)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class Graph:
    def __init__(self, n_vertices: int, directed: bool = False):
        self.n = int(n_vertices)
        self.directed = directed
        self._adj: List[List[Tuple[int, float]]] = [[] for _ in range(self.n)]

    def num_vertices(self) -> int:
        return self.n

    def add_edge(self, a: int, b: int, weight: float = 1.0) -> None:
        if not (0 <= a < self.n and 0 <= b < self.n):
            raise ValueError(f"edge ({a},{b}) out of range for n={self.n}")
        self._adj[a].append((b, float(weight)))
        if not self.directed and a != b:
            self._adj[b].append((a, float(weight)))

    def neighbors(self, v: int) -> List[int]:
        return [u for u, _ in self._adj[v]]

    def neighbors_weighted(self, v: int) -> List[Tuple[int, float]]:
        return list(self._adj[v])

    def degree(self, v: int) -> int:
        return len(self._adj[v])

    def num_edges(self) -> int:
        total = sum(len(a) for a in self._adj)
        return total if self.directed else total // 2
