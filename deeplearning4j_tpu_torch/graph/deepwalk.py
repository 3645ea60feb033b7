"""DeepWalk: vertex embeddings from random walks (counterpart of the JAX
package's ``graph/deepwalk.py``).

Parity: reference ``models/deepwalk/DeepWalk.java`` (skip-gram with
hierarchical softmax over degree-weighted Huffman codes —
``GraphHuffman.java``) on walks from ``RandomWalkIterator``.

Walks are token sequences ("0", "1", ...) fed to the same vectorized
SequenceVectors engine as Word2Vec on ``device``; HS is the default to match
the reference, negative sampling available as an option.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..dtypes import resolve_device
from ..nlp.sequence_vectors import SequenceVectors
from .graph import Graph
from .walks import RandomWalkIterator


class DeepWalk:
    """Builder-style API (reference: ``DeepWalk.Builder`` —
    ``vectorSize``, ``windowSize``, ``learningRate``, walk length);
    ``device`` holds the tables (``"cuda"`` by default)."""

    def __init__(self, *, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, walk_length: int = 40,
                 walks_per_vertex: int = 4, epochs: int = 1,
                 negative: int = 0, seed: int = 42, batch_size: int = 4096,
                 device="cuda"):
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.epochs = epochs
        self.negative = negative
        self.seed = seed
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._sv: Optional[SequenceVectors] = None
        self._n_vertices = 0

    def fit(self, graph: Graph) -> "DeepWalk":
        walks = RandomWalkIterator(graph, self.walk_length, seed=self.seed,
                                   walks_per_vertex=self.walks_per_vertex)
        token_walks = [[str(v) for v in walk] for walk in walks]
        self._n_vertices = graph.num_vertices()
        self._sv = SequenceVectors(
            layer_size=self.vector_size, window=self.window_size,
            negative=self.negative, learning_rate=self.learning_rate,
            epochs=self.epochs, seed=self.seed, batch_size=self.batch_size,
            min_word_frequency=1, device=self.device)
        self._sv.fit(token_walks)
        return self

    # -- lookup --
    def get_vertex_vector(self, v: int) -> np.ndarray:
        return self._sv.get_word_vector(str(v))

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(str(a), str(b))

    def verticies_nearest(self, v: int, top: int = 10) -> List[int]:
        return [int(w) for w in self._sv.words_nearest(str(v), top=top)]
