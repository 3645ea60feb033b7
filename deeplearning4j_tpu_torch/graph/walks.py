"""Random-walk iterators (a copy of the JAX package's ``graph/walks.py``,
host numpy code: the same seed gives the same walks bit for bit).

Parity: reference ``iterator/RandomWalkIterator.java`` — uniform
next-vertex choice, NoEdgeHandling SELF_LOOP_ON_DISCONNECTED — and
``WeightedRandomWalkIterator.java`` — edge-weight-proportional choice.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from .graph import Graph


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex."""

    def __init__(self, graph: Graph, walk_length: int,
                 seed: Optional[int] = None, walks_per_vertex: int = 1):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.seed = seed
        self.walks_per_vertex = int(walks_per_vertex)

    def _next_vertex(self, rng, v: int) -> int:
        nbrs = self.graph.neighbors(v)
        if not nbrs:
            return v  # self-loop on disconnected (reference NoEdgeHandling)
        return int(nbrs[rng.integers(0, len(nbrs))])

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(self.walks_per_vertex):
            order = rng.permutation(self.graph.num_vertices())
            for start in order:
                walk = [int(start)]
                v = int(start)
                for _ in range(self.walk_length - 1):
                    v = self._next_vertex(rng, v)
                    walk.append(v)
                yield walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Next vertex ∝ edge weight (parity: ``WeightedRandomWalkIterator``)."""

    def _next_vertex(self, rng, v: int) -> int:
        nbrs = self.graph.neighbors_weighted(v)
        if not nbrs:
            return v
        weights = np.array([w for _, w in nbrs], dtype=np.float64)
        probs = weights / weights.sum()
        return int(nbrs[rng.choice(len(nbrs), p=probs)][0])
