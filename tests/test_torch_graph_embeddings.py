"""The port's graph embeddings (``graph/``) against the JAX package's, on
the CPU: the graph structures and the edge-list loader, random walks
(uniform and weighted) bitwise from the same seed, and a seeded
``DeepWalk.fit`` (hierarchical softmax, the reference's default, and
negative sampling) whose vertex vectors and similarities agree within
``FIT_ATOL``. The port runs with ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as j_graph
import deeplearning4j_tpu_torch.graph as t_graph

FIT_ATOL = 1e-5


def barbell(m, n_per_side=8):
    """Two dense clusters joined by a single bridge edge (the reference
    test's graph)."""
    g = m.Graph(2 * n_per_side)
    for base in (0, n_per_side):
        for i in range(n_per_side):
            for j in range(i + 1, n_per_side):
                g.add_edge(base + i, base + j)
    g.add_edge(n_per_side - 1, n_per_side)
    return g


def skewed(m, n=60, seed=0):
    """A seeded weighted graph with degree skew and an isolated vertex."""
    rng = np.random.default_rng(seed)
    g = m.Graph(n + 1)
    for v in range(1, n):
        for u in rng.choice(v, size=min(v, 3), replace=False):
            g.add_edge(v, int(u), float(rng.integers(1, 5)))
    return g


def test_structure_and_loader_are_the_references(tmp_path):
    p = tmp_path / "edges.csv"
    p.write_text("# comment\n0,1\n1,2,3.5\n\n2,0\n")

    def trace(m):
        g = barbell(m, 4)
        d = m.Graph(3, directed=True)
        d.add_edge(0, 1)
        loaded = m.GraphLoader.load_undirected_graph_edge_list_file(
            str(p), 3)
        loaded_d = m.GraphLoader.load_directed_graph_edge_list_file(
            str(p), 3)
        with pytest.raises(ValueError):
            m.Graph(2).add_edge(0, 5)
        return ([g.neighbors_weighted(v) for v in range(8)], g.num_edges(),
                [g.degree(v) for v in range(8)], d.neighbors(0),
                d.neighbors(1), d.num_edges(),
                [loaded.neighbors_weighted(v) for v in range(3)],
                [loaded_d.neighbors_weighted(v) for v in range(3)])

    assert trace(t_graph) == trace(j_graph)


@pytest.mark.parametrize("kind", ["RandomWalkIterator",
                                  "WeightedRandomWalkIterator"])
def test_walks_are_the_references(kind):
    def walks(m):
        it = getattr(m, kind)(skewed(m), walk_length=12, seed=4,
                              walks_per_vertex=3)
        return [list(w) for w in it]

    got = walks(t_graph)
    assert len(got) == 3 * 61 and all(len(w) == 12 for w in got)
    assert got == walks(j_graph)


@pytest.fixture(scope="module")
def deepwalk_runs():
    kw = {"hs": dict(vector_size=16, window_size=4, walk_length=20,
                     walks_per_vertex=6, epochs=2, seed=3, batch_size=512),
          "ns": dict(vector_size=12, window_size=3, walk_length=10,
                     walks_per_vertex=4, epochs=1, seed=4, batch_size=256,
                     negative=4)}
    return {name: (j_graph.DeepWalk(**k).fit(barbell(j_graph)),
                   t_graph.DeepWalk(**k, device="cpu").fit(barbell(t_graph)))
            for name, k in kw.items()}


@pytest.mark.parametrize("name", ["hs", "ns"])
def test_deepwalk_fit_matches_the_references(deepwalk_runs, name):
    j_dw, t_dw = deepwalk_runs[name]
    assert t_dw._sv.vocab.words() == j_dw._sv.vocab.words()
    for v in range(16):
        err = np.abs(t_dw.get_vertex_vector(v)
                     - np.asarray(j_dw.get_vertex_vector(v))).max()
        assert err <= FIT_ATOL, (v, err)
    for a, b in ((0, 1), (0, 12), (7, 8)):
        assert abs(t_dw.similarity(a, b) - j_dw.similarity(a, b)) <= FIT_ATOL
    if name == "hs":
        assert "syn1" in t_dw._sv.params and "syn1neg" not in t_dw._sv.params
        assert t_dw.similarity(0, 1) > t_dw.similarity(0, 12)
        assert t_dw.verticies_nearest(2, 5) == j_dw.verticies_nearest(2, 5)


def test_deepwalk_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_graph.DeepWalk(vector_size=8)
