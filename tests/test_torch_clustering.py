"""The port's ``clustering/`` against the JAX package's, on the CPU.

k-means: one ``_kmeans_iter`` within ``ITER_TOL``; ``fit`` with the same
seed draws the same k-means++ rows (the port keeps ``d2`` as a running
minimum where the reference broadcasts [n, j, d]; equal bit for bit),
then centroids within ``FIT_TOL`` and equal assignments and iteration
counts on separated blobs. The trees are host numpy carried over as
written: KDTree, VPTree (euclidean, cosine) and SpTree/QuadTree answer
exactly as the reference's. The Barnes-Hut C++ kernel (the port's own
copy of ``_sptree.cpp``) equals the reference's build bit for bit, and
the Python tree within ``TREE_TOL``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.clustering import kmeans as j_kmeans
from deeplearning4j_tpu.clustering import native as j_native
from deeplearning4j_tpu.clustering import sptree as j_sptree
from deeplearning4j_tpu.clustering import KDTree as JKDTree
from deeplearning4j_tpu.clustering import VPTree as JVPTree
from deeplearning4j_tpu.plot.tsne import _knn_sparse_p
from deeplearning4j_tpu_torch.clustering import kmeans as t_kmeans
from deeplearning4j_tpu_torch.clustering import native as t_native
from deeplearning4j_tpu_torch.clustering import sptree as t_sptree
from deeplearning4j_tpu_torch.clustering import KDTree, VPTree

ITER_TOL = 1e-5     # f32 distances and sums, relative to their scale
FIT_TOL = 1e-4      # centroids after a few f32 iterations
TREE_TOL = 1e-10    # C++ against the Python tree, f64


def _blobs(rng, k=4, per=60, d=6, spread=0.2):
    centers = rng.normal(scale=8.0, size=(k, d))
    return np.concatenate([c + spread * rng.normal(size=(per, d))
                           for c in centers]).astype(np.float32)


@pytest.mark.parametrize("n,d,k", [(500, 16, 7), (300, 128, 32)])
def test_kmeans_iter_matches(n, d, k):
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = x[rng.choice(n, k, replace=False)]
    jc, ja, jcost = j_kmeans._kmeans_iter(jnp.asarray(x), jnp.asarray(c), k=k)
    tc, ta, tcost = t_kmeans._kmeans_iter(torch.from_numpy(x),
                                          torch.from_numpy(c), k=k)
    jc = np.asarray(jc)
    assert np.abs(tc.numpy() - jc).max() <= ITER_TOL * np.abs(jc).max()
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert abs(float(tcost) - float(jcost)) <= ITER_TOL * abs(float(jcost))


def test_empty_cluster_keeps_its_centroid():
    x = np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]], np.float32)
    c = np.array([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]], np.float32)
    tc, ta, _ = t_kmeans._kmeans_iter(torch.from_numpy(x),
                                      torch.from_numpy(c), k=3)
    jc, ja, _ = j_kmeans._kmeans_iter(jnp.asarray(x), jnp.asarray(c), k=3)
    np.testing.assert_array_equal(tc.numpy()[2], c[2])
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("n,d,k,seed", [(2000, 128, 8, 3), (600, 6, 24, 0)])
def test_kmeanspp_seeding_draws_the_reference_rows(n, d, k, seed):
    x = np.random.default_rng(seed + 7).normal(size=(n, d)).astype(np.float32)
    want = j_kmeans.KMeansClustering(k=k, seed=seed)._kmeanspp_init(
        x, np.random.default_rng(seed))
    got = t_kmeans.KMeansClustering(k=k, seed=seed, device="cpu") \
        ._kmeanspp_init(x, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 5])
def test_fit_matches_on_separated_blobs(seed):
    x = _blobs(np.random.default_rng(seed))
    jkm = j_kmeans.KMeansClustering(k=4, seed=seed).fit(x)
    tkm = t_kmeans.KMeansClustering(k=4, seed=seed, device="cpu").fit(x)
    assert tkm.iterations_run == jkm.iterations_run
    np.testing.assert_allclose(tkm.centroids, jkm.centroids, atol=FIT_TOL)
    np.testing.assert_array_equal(tkm.predict(x), jkm.predict(x))
    assert abs(tkm.cost - jkm.cost) <= FIT_TOL * abs(jkm.cost)


def test_fit_needs_k_points():
    with pytest.raises(ValueError, match="at least k=5"):
        t_kmeans.KMeansClustering(k=5, device="cpu").fit(np.zeros((3, 2)))
    with pytest.raises(ValueError, match="fit"):
        t_kmeans.KMeansClustering(k=2, device="cpu").predict(np.zeros((3, 2)))


@pytest.mark.parametrize("k", [1, 5])
def test_kdtree_queries_equal(k):
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(300, 3))
    jt, tt = JKDTree(pts), KDTree(pts)
    assert tt.size() == jt.size()
    for q in rng.normal(size=(20, 3)):
        assert tt.knn(q, k) == jt.knn(q, k)
        assert tt.nn(q) == jt.nn(q)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_vptree_queries_equal(distance):
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(250, 5))
    pts[10] = pts[11]                       # duplicates split as the reference
    jt = JVPTree(pts, distance=distance, seed=4)
    tt = VPTree(pts, distance=distance, seed=4)
    for q in rng.normal(size=(15, 5)):
        assert tt.knn(q, 6) == jt.knn(q, 6)
        assert tt.nn(q) == jt.nn(q)


@pytest.mark.parametrize("cls,d", [("SpTree", 3), ("QuadTree", 2)])
def test_sptree_forces_equal(cls, d):
    rng = np.random.default_rng(13)
    y = rng.normal(size=(200, d))
    jt, tt = getattr(j_sptree, cls)(y), getattr(t_sptree, cls)(y)
    assert tt.is_correct() and tt.depth() == jt.depth()
    for i in (0, 17, 199):
        for theta in (0.0, 0.5):
            jf, jq = jt.compute_non_edge_forces(i, theta)
            tf, tq = tt.compute_non_edge_forces(i, theta)
            np.testing.assert_array_equal(tf, jf)
            assert tq == jq


def test_quadtree_needs_2d():
    with pytest.raises(ValueError, match="2-D"):
        t_sptree.QuadTree(np.zeros((4, 3)))


@pytest.fixture(scope="module")
def csr_case():
    rng = np.random.default_rng(14)
    x = rng.normal(size=(150, 5))
    row_ptr, cols, vals = _knn_sparse_p(x, 10.0, 30)
    y = rng.normal(size=(150, 2))
    return y, row_ptr, cols, vals


@pytest.mark.parametrize("theta", [0.0, 0.5, 1.0])
def test_native_gradient_equals_reference_and_python_tree(csr_case, theta):
    if t_native.load() is None or j_native.load() is None:
        pytest.skip("no C++ compiler for the Barnes-Hut kernel")
    y, row_ptr, cols, vals = csr_case
    tg, tkl = t_native.bh_gradient(y, row_ptr, cols, vals, theta)
    jg, jkl = j_native.bh_gradient(y, row_ptr, cols, vals, theta)
    np.testing.assert_array_equal(tg, jg)
    assert tkl == jkl
    from deeplearning4j_tpu_torch.plot.tsne import _bh_gradient_python
    pg, pkl = _bh_gradient_python(y, row_ptr, cols, vals, theta)
    np.testing.assert_allclose(tg, pg, rtol=0, atol=TREE_TOL)
    assert abs(tkl - pkl) <= TREE_TOL * max(1.0, abs(pkl))


def test_native_non_edge_forces(csr_case):
    if t_native.load() is None or j_native.load() is None:
        pytest.skip("no C++ compiler for the Barnes-Hut kernel")
    y = csr_case[0]
    tree = t_sptree.SpTree(y)
    for i in (0, 42, 149):
        tn, tq = t_native.non_edge_forces(y, i, 0.5)
        jn, jq = j_native.non_edge_forces(y, i, 0.5)
        np.testing.assert_array_equal(tn, jn)
        assert tq == jq
        pn, pq = tree.compute_non_edge_forces(i, 0.5)
        np.testing.assert_allclose(tn, pn, rtol=0, atol=TREE_TOL)
        assert abs(tq - pq) <= TREE_TOL * max(1.0, abs(pq))


def test_native_library_builds_under_the_checkout():
    """The port builds its own copy of the source into build/native/."""
    if t_native.load() is None:
        pytest.skip("no C++ compiler for the Barnes-Hut kernel")
    from deeplearning4j_tpu_torch.util.native import library_path
    assert library_path(t_native._SRC).exists()
    assert t_native._SRC.read_bytes() == (
        __import__("pathlib").Path(j_native.__file__).parent
        / "_sptree.cpp").read_bytes()
