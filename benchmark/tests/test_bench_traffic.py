"""The traffic generator: the same seed gives the same inputs, and every
value lies in its range."""

import numpy as np
import torch

from harness import traffic

LM = {"vocab_size": 1000}
IMG = {"image_size": 8, "num_channels": 3, "num_labels": 10}


def test_token_batches_deterministic_and_shifted():
    t = {"inputs": "token_ids", "batch": 3, "seq_len": 16}
    a = traffic.FitBatches(t, LM, 2 ** 31 + 7, "cpu")
    b = traffic.FitBatches(t, LM, 2 ** 31 + 7, "cpu")
    x, y = a(5)
    np.testing.assert_array_equal(x, b(5)[0])
    assert x.shape == y.shape == (3, 16) and x.dtype == np.int32
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
    assert 0 <= x.min() and max(x.max(), y.max()) < LM["vocab_size"]
    assert not np.array_equal(x, a(6)[0])


def test_image_batches_deterministic_one_hot():
    t = {"inputs": "images", "batch": 4, "pool": 2}
    a = traffic.FitBatches(t, IMG, 11, torch.device("cpu"))
    b = traffic.FitBatches(t, IMG, 11, torch.device("cpu"))
    x, y = a(3)
    np.testing.assert_array_equal(x, b(3)[0])
    np.testing.assert_array_equal(y, b(3)[1])
    assert x.shape == (4, 8, 8, 3)
    np.testing.assert_array_equal(y.sum(axis=1), np.ones(4))
    assert not np.array_equal(a(0)[0], a(1)[0])
