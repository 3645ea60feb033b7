"""A run whose timed path is broken underneath comes out not correct: the
look for a card skipped, everything else as in a run, at tiny sizes.
A step that returns its state unchanged, and a step that leaves out half
of the batch and takes the mean over the rest."""

import pytest

import _tiny

TRAIN = ["opt-125m.train.t2048", "resnet50-f32.train.b128"]


def _change_check(result):
    """The cell's compared number of the parameters' change after the
    three steps."""
    (name,) = [k for k in result["checks"] if k.startswith("change")
               and not k.startswith("change_gap_step")]
    return result["checks"][name]


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_is_caught(name, monkeypatch):
    from deeplearning4j_tpu_torch.optimize import updaters
    _, sound = _tiny.run(name)
    monkeypatch.setattr(updaters, "apply_updates", lambda params, d: None)
    _, broken = _tiny.run(name)
    assert broken["correct"] is False
    change = _change_check(broken)
    assert change["value"] == pytest.approx(1.0)
    assert change["value"] > change["limit"]
    assert _change_check(sound)["value"] < 0.5


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_is_caught(name, monkeypatch):
    from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
    _, sound = _tiny.run(name)
    whole = ComputationGraph._loss_and_grads

    def half(self, inputs, labels, masks, *a, **kw):
        n = inputs[0].shape[0] // 2
        return whole(self, [x[:n] for x in inputs], [y[:n] for y in labels],
                     masks, *a, **kw)

    monkeypatch.setattr(ComputationGraph, "_loss_and_grads", half)
    _, broken = _tiny.run(name)
    assert broken["correct"] is False
    failed = [k for k, c in broken["checks"].items()
              if c["value"] > c["limit"]
              and c["value"] > 2 * sound["checks"][k]["value"]]
    assert failed
