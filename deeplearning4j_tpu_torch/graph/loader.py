"""Graph loaders (a copy of the JAX package's ``graph/loader.py``; parity:
reference ``data/GraphLoader.java`` + ``DelimitedEdgeLineProcessor`` —
edge-list text files)."""

from __future__ import annotations

from typing import Optional

from .graph import Graph


class GraphLoader:
    @staticmethod
    def load_undirected_graph_edge_list_file(
            path: str, n_vertices: int, delimiter: str = ",") -> Graph:
        return GraphLoader._load(path, n_vertices, delimiter, directed=False)

    @staticmethod
    def load_directed_graph_edge_list_file(
            path: str, n_vertices: int, delimiter: str = ",") -> Graph:
        return GraphLoader._load(path, n_vertices, delimiter, directed=True)

    @staticmethod
    def _load(path: str, n_vertices: int, delimiter: str,
              directed: bool) -> Graph:
        g = Graph(n_vertices, directed=directed)
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                if len(parts) < 2:
                    continue
                a, b = int(parts[0]), int(parts[1])
                w = float(parts[2]) if len(parts) > 2 else 1.0
                g.add_edge(a, b, w)
        return g
