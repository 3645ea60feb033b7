"""The yardstick's counts against values worked out by hand."""

import json

import pytest

from harness import counts
import run as bench_run

UNIT = {"bf16_flops": 1.0, "bytes": 1.0}


def test_opt_125m_train_flops_per_token():
    # 3·(2·(12·(4·768² + 2·768·3072) + 768·50272) + 12·2·1024·768·2)
    assert counts.lm_train_flops_per_token(768, 12, 3072, 50272, 2048) \
        == 854_507_520


def test_resnet50_train_flops_per_example():
    cfg = json.loads((bench_run.BENCH / "configs" / "resnet50-f32.json")
                     .read_text())
    stem = counts.resnet_layers(cfg)[0]
    assert (stem["hw_out"], stem["c_out"], stem["k"]) == (112, 64, 7)
    # 53 convs: the stem, 16 blocks of three and 4 projections
    assert len(counts.resnet_layers(cfg)) == 53
    # 3 × (4,089,184,256 MACs of convs + 2,048,000 of the classifier) × 2
    assert counts.resnet_train_flops_per_example(cfg) == 24_535_105_536


def test_causal_attention_bound():
    # b 1, t 2, h 1, d 2 in bf16: 3 attended pairs; one tensor 8 bytes,
    # the lse row 8; forward max(4·2·3, 4·8 + 8), backward
    # max(10·2·3, 8·8 + 8)
    assert counts.causal_attention_bound_s(1, 2, 1, 2, 2, UNIT) == 40 + 72


def test_batchnorm_train_bound():
    cfg = {"image_size": 8, "num_channels": 3, "embedding_size": 16,
           "stem_kernel": 7, "stem_stride": 2, "hidden_sizes": [64],
           "depths": [1], "expansion": 4, "num_labels": 10}
    # outputs of stem 4·4·16, a 2·2·16, b 2·2·16, c 2·2·64, projection
    # 2·2·64 = 896 values; 5 passes of 2 bytes, 9 f32 vectors per channel
    assert counts.batchnorm_train_bound_s(cfg, 1, 2, UNIT) == \
        5 * 896 * 2 + 9 * 4 * (16 + 16 + 16 + 64 + 64)


@pytest.mark.parametrize("kind, found", [("NVIDIA H100 80GB HBM3", True),
                                         ("cpu", False)])
def test_peaks_by_device_name(kind, found):
    assert (counts.peaks_for(kind) is not None) == found
