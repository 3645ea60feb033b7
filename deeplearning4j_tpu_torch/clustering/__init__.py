"""Clustering + spatial search structures (counterpart of the JAX package's
``clustering/``).

Parity: reference ``deeplearning4j-core/.../clustering/`` — ``kmeans/``
(KMeansClustering over the generic ``BaseClusteringAlgorithm``),
``kdtree/KDTree.java``, ``vptree/VPTree.java`` (nearest-neighbour search),
``sptree/``/``quadtree/`` (used by Barnes-Hut t-SNE, see ``plot/``).

KMeans assignment and update run on the device in PyTorch (the [n, k]
distance product in f32); the tree structures are host-side numpy, and
the Barnes-Hut walk is host C++ (``_sptree.cpp`` through ``native.py``).
"""

from .kdtree import KDTree
from .kmeans import KMeansClustering
from .vptree import VPTree

__all__ = ["KMeansClustering", "KDTree", "VPTree"]
