"""Visualization embeddings: t-SNE (counterpart of the JAX package's
``plot/``).

Parity: reference ``plot/Tsne.java`` (exact) and ``plot/BarnesHutTsne.java``
(θ-approximate via SpTree).
"""

from .tsne import BarnesHutTsne, Tsne

__all__ = ["Tsne", "BarnesHutTsne"]
