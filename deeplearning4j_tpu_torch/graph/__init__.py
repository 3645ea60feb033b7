"""Graph embeddings: structures, random walks, DeepWalk (counterpart of the
JAX package's ``graph/``).

Parity: reference ``deeplearning4j-graph`` — ``graph/api/IGraph.java`` /
``graph/graph/Graph.java`` (adjacency-list digraph), ``data/GraphLoader.java``
(edge-list files), ``iterator/RandomWalkIterator.java`` /
``WeightedRandomWalkIterator.java``, ``models/deepwalk/DeepWalk.java``
(skip-gram-with-HS over walks) + ``GraphHuffman.java``.

Walks are generated host-side (numpy, the JAX package's code: the same
seed gives the same walks), then embedded with the same vectorized
SequenceVectors engine as Word2Vec on ``device`` (walks are just token
sequences) — replacing the reference's per-edge gemv updates.
"""

from .deepwalk import DeepWalk
from .graph import Graph
from .loader import GraphLoader
from .walks import RandomWalkIterator, WeightedRandomWalkIterator

__all__ = ["Graph", "GraphLoader", "RandomWalkIterator",
           "WeightedRandomWalkIterator", "DeepWalk"]
