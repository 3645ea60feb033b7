"""The port's ROC, ROCMultiClass and RegressionEvaluation against the JAX
package's, on the CPU: the ROC and regression cases of
``tests/test_eval.py``, and every number of both packages on the same
data, made from a seed with numpy, within 1e-12 (both accumulate in
float64 on the host; the counts are exact).
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.eval as jeval
import deeplearning4j_tpu_torch.eval as teval

TOL = 1e-12


def _close(a, b):
    assert abs(a - b) <= TOL * max(1.0, abs(b)), (a, b)


# --------------------------------------------------------------------------
# the reference's own cases, on the port
# --------------------------------------------------------------------------


def test_regression_exact_values():
    re = teval.RegressionEvaluation()
    re.eval(np.array([[1.0], [2.0], [3.0]]), np.array([[1.5], [2.0], [2.5]]))
    assert re.mean_squared_error(0) == pytest.approx((0.25 + 0 + 0.25) / 3)
    assert re.mean_absolute_error(0) == pytest.approx(1.0 / 3)
    assert re.root_mean_squared_error(0) == pytest.approx(
        np.sqrt((0.25 + 0 + 0.25) / 3))


def test_regression_r2_perfect_linear():
    x = np.random.default_rng(2).normal(size=(100, 2))
    re = teval.RegressionEvaluation()
    re.eval(x, 2 * x + 1)
    assert re.average_correlation_r2() == pytest.approx(1.0)


def test_regression_streaming_merge():
    rng = np.random.default_rng(3)
    y = rng.normal(size=(80, 3))
    p = y + rng.normal(0, 0.1, (80, 3))
    full = teval.RegressionEvaluation()
    full.eval(y, p)
    a, b = teval.RegressionEvaluation(), teval.RegressionEvaluation()
    a.eval(y[:40], p[:40])
    b.eval(y[40:], p[40:])
    a.merge(b)
    assert a.average_mean_squared_error() == pytest.approx(
        full.average_mean_squared_error())
    assert a.average_correlation_r2() == pytest.approx(
        full.average_correlation_r2())


def test_roc_perfect_separation_auc_1():
    roc = teval.ROC(100)
    roc.eval(np.array([0] * 50 + [1] * 50), np.array([0.1] * 50 + [0.9] * 50))
    assert roc.calculate_auc() == pytest.approx(1.0, abs=0.02)


def test_roc_random_predictions_auc_half():
    rng = np.random.default_rng(4)
    roc = teval.ROC(200)
    roc.eval(rng.integers(0, 2, 5000), rng.random(5000))
    assert roc.calculate_auc() == pytest.approx(0.5, abs=0.05)


def test_roc_one_hot_two_column_form():
    roc = teval.ROC(50)
    roc.eval(np.eye(2)[[0, 1, 1, 0]],
             np.array([[0.8, 0.2], [0.1, 0.9], [0.4, 0.6], [0.7, 0.3]]))
    assert roc.calculate_auc() == pytest.approx(1.0, abs=0.05)


def test_roc_merge():
    rng = np.random.default_rng(5)
    lab, pred = rng.integers(0, 2, 400), rng.random(400)
    full = teval.ROC(100)
    full.eval(lab, pred)
    a, b = teval.ROC(100), teval.ROC(100)
    a.eval(lab[:200], pred[:200])
    b.eval(lab[200:], pred[200:])
    a.merge(b)
    assert a.calculate_auc() == pytest.approx(full.calculate_auc())
    with pytest.raises(ValueError, match="threshold steps"):
        a.merge(teval.ROC(50))


def test_roc_multiclass():
    rng = np.random.default_rng(6)
    y = np.eye(3)[rng.integers(0, 3, 300)]
    p = np.clip(y * 0.7 + rng.random((300, 3)) * 0.3, 0, 1)
    mroc = teval.ROCMultiClass(100)
    mroc.eval(y, p)
    assert mroc.calculate_average_auc() > 0.8
    assert 0 <= mroc.calculate_auc(0) <= 1.0
    with pytest.raises(ValueError, match="one-hot"):
        mroc.eval(np.zeros(4), np.zeros(4))


def test_roc_two_col_predictions_one_col_labels():
    y = np.array([0, 1, 1, 0])
    p2 = np.array([[0.9, 0.1], [0.2, 0.8], [0.3, 0.7], [0.6, 0.4]])
    roc2, roc1 = teval.ROC(threshold_steps=10), teval.ROC(threshold_steps=10)
    roc2.eval(y, p2)
    roc1.eval(y, p2[:, 1])
    assert roc2.calculate_auc() == roc1.calculate_auc() == 1.0


def test_roc_mismatched_lengths_raise():
    with pytest.raises(ValueError, match="labels"):
        teval.ROC().eval(np.zeros(4), np.zeros((3, 5)))


# --------------------------------------------------------------------------
# every number against the reference's on the same data
# --------------------------------------------------------------------------


def _roc_data(seed, n=500, masked=False):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    p = np.clip(0.35 * y + 0.65 * rng.random(n), 0.0, 1.0)
    m = (rng.random(n) > 0.2).astype(np.float32) if masked else None
    return y, p, m


@pytest.mark.parametrize("steps,masked,batches", [
    (100, False, 1), (37, True, 3), (250, False, 4), (10, True, 2)])
def test_roc_numbers_equal_reference(steps, masked, batches):
    y, p, m = _roc_data(steps, masked=masked)
    j, t = jeval.ROC(steps), teval.ROC(steps)
    for idx in np.array_split(np.arange(len(y)), batches):
        mm = None if m is None else m[idx]
        j.eval(y[idx], p[idx], mask=mm)
        t.eval(y[idx], p[idx], mask=mm)
    _close(t.calculate_auc(), j.calculate_auc())
    for got, want in ((t.get_roc_curve(), j.get_roc_curve()),
                      (t.get_precision_recall_curve(),
                       j.get_precision_recall_curve())):
        assert len(got) == len(want) == steps + 1
        for a, b in zip(got, want):
            for u, v in zip(a, b):
                _close(u, v)


def test_roc_takes_tensors_like_arrays():
    y, p, m = _roc_data(8, masked=True)
    j, t = jeval.ROC(64), teval.ROC(64)
    j.eval(np.eye(2)[y], np.stack([1 - p, p], 1), mask=m)
    t.eval(torch.as_tensor(np.eye(2)[y]),
           torch.as_tensor(np.stack([1 - p, p], 1)), mask=torch.as_tensor(m))
    _close(t.calculate_auc(), j.calculate_auc())


@pytest.mark.parametrize("classes,steps", [(3, 100), (5, 40), (2, 7)])
def test_roc_multiclass_numbers_equal_reference(classes, steps):
    rng = np.random.default_rng(classes * 100 + steps)
    y = np.eye(classes)[rng.integers(0, classes, 400)]
    p = rng.dirichlet(np.ones(classes), 400) * 0.6 + 0.4 * y
    j, t = jeval.ROCMultiClass(steps), teval.ROCMultiClass(steps)
    ja, jb = jeval.ROCMultiClass(steps), jeval.ROCMultiClass(steps)
    ta, tb = teval.ROCMultiClass(steps), teval.ROCMultiClass(steps)
    j.eval(y, p)
    t.eval(y, p)
    ja.eval(y[:150], p[:150]), jb.eval(y[150:], p[150:]), ja.merge(jb)
    ta.eval(y[:150], p[:150]), tb.eval(y[150:], p[150:]), ta.merge(tb)
    _close(t.calculate_average_auc(), j.calculate_average_auc())
    _close(ta.calculate_average_auc(), ja.calculate_average_auc())
    for c in range(classes):
        _close(t.calculate_auc(c), j.calculate_auc(c))


REG_METRICS = ("mean_squared_error", "mean_absolute_error",
               "root_mean_squared_error", "correlation_r2",
               "relative_squared_error")


@pytest.mark.parametrize("shape,masked", [
    ((60, 1), False), ((60,), False), ((40, 4), True), ((6, 9, 3), True),
    ((6, 9, 3), False)])
def test_regression_numbers_equal_reference(shape, masked):
    rng = np.random.default_rng(sum(shape))
    y = rng.normal(size=shape)
    p = 0.8 * y + rng.normal(0, 0.3, shape)
    mask = None
    if masked:
        mask = (rng.random(shape[:2] if len(shape) == 3 else shape[:1])
                > 0.25).astype(np.float32)
    names = ["a", "b"]
    j = jeval.RegressionEvaluation(column_names=names)
    t = teval.RegressionEvaluation(column_names=names)
    if len(shape) == 3:
        j.eval(y, p, mask=mask)
        t.eval(y, p, mask=mask)
    else:
        half = shape[0] // 2
        for s in (slice(0, half), slice(half, None)):
            mm = None if mask is None else mask[s]
            j.eval(y[s], p[s], mask=mm)
            t.eval(torch.as_tensor(y[s]), torch.as_tensor(p[s]),
                   mask=None if mm is None else torch.as_tensor(mm))
    assert t.n_columns == j.n_columns
    for c in range(t.n_columns):
        for name in REG_METRICS:
            _close(getattr(t, name)(c), getattr(j, name)(c))
    for name in ("average_mean_squared_error", "average_mean_absolute_error",
                 "average_root_mean_squared_error", "average_correlation_r2"):
        _close(getattr(t, name)(), getattr(j, name)())
    assert t.stats() == j.stats() and str(t) == str(j)


def test_regression_merge_and_empty_equal_reference():
    assert (teval.RegressionEvaluation().stats()
            == jeval.RegressionEvaluation().stats())
    rng = np.random.default_rng(11)
    y = rng.normal(size=(50, 2))
    p = y ** 2
    j, t = jeval.RegressionEvaluation(), teval.RegressionEvaluation()
    empty_j, empty_t = jeval.RegressionEvaluation(), teval.RegressionEvaluation()
    empty_j.merge(j), empty_t.merge(t)          # merging nothing: a no-op
    j.eval(y, p), t.eval(y, p)
    empty_j.merge(j), empty_t.merge(t)
    for c in range(2):
        for name in REG_METRICS:
            _close(getattr(empty_t, name)(c), getattr(empty_j, name)(c))
