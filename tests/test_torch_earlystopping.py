"""The port's early stopping (``earlystopping/``) on the CPU: the cases of
``tests/test_earlystopping.py``, the graph trainer, and the early-stopping
run against the reference's from the same checkpoint (the per-epoch
held-out scores within 1e-4 relative: adam steps, as in
``tests/test_torch_multilayer.py``; the terminations and best epochs
equal).
"""

import numpy as np
import pytest

from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.earlystopping import (
    BestScoreEpochTerminationCondition, DataSetLossCalculator,
    EarlyStoppingConfiguration, EarlyStoppingGraphTrainer,
    EarlyStoppingTrainer, EvaluationScoreCalculator,
    InvalidScoreIterationTerminationCondition, LocalFileModelSaver,
    MaxEpochsTerminationCondition, MaxScoreIterationTerminationCondition,
    MaxTimeTerminationCondition, ScoreImprovementEpochTerminationCondition)
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import faults

TOL = 1e-4


def _net(lr=0.05):
    conf = (NeuralNetConfiguration.builder().seed(1).updater("adam")
            .learning_rate(lr).list()
            .layer(DenseLayer(n_out=12, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _arrays(rng, n=96):
    x = rng.normal(size=(n, 6)).astype(np.float32)
    w = rng.normal(size=(6, 3))
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return x, y


def _iters(rng, n=96, batch=32):
    x, y = _arrays(rng, n)
    return (ArrayDataSetIterator(x[:64], y[:64], batch),
            ArrayDataSetIterator(x[64:], y[64:], batch))


class TestEarlyStopping:
    def test_max_epochs_terminates(self, rng):
        train, test = _iters(rng)
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(DataSetLossCalculator(test))
               .epoch_termination_conditions(MaxEpochsTerminationCondition(5))
               .build())
        result = EarlyStoppingTrainer(cfg, _net(), train).fit()
        assert result.total_epochs == 5
        assert result.termination_reason == "epoch_condition"
        assert "MaxEpochs" in result.termination_details
        assert result.best_model is not None
        assert len(result.score_vs_epoch) == 5

    def test_best_model_is_restored(self, rng):
        train, test = _iters(rng)
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(DataSetLossCalculator(test))
               .epoch_termination_conditions(MaxEpochsTerminationCondition(4))
               .build())
        result = EarlyStoppingTrainer(cfg, _net(), train).fit()
        best = result.best_model
        score = DataSetLossCalculator(test).calculate_score(best)
        assert score == pytest.approx(result.best_model_score, rel=1e-5)

    def test_score_improvement_patience(self, rng):
        train, test = _iters(rng)
        # lr=0 → score never improves → patience triggers after 2 stale epochs
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(DataSetLossCalculator(test))
               .epoch_termination_conditions(
                   ScoreImprovementEpochTerminationCondition(2),
                   MaxEpochsTerminationCondition(50))
               .build())
        result = EarlyStoppingTrainer(cfg, _net(lr=0.0), train).fit()
        assert result.termination_reason == "epoch_condition"
        assert "ScoreImprovement" in result.termination_details
        assert result.total_epochs <= 4

    def test_max_time_terminates_immediately(self, rng):
        train, test = _iters(rng)
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(DataSetLossCalculator(test))
               .iteration_termination_conditions(MaxTimeTerminationCondition(0.0))
               .epoch_termination_conditions(MaxEpochsTerminationCondition(100))
               .build())
        result = EarlyStoppingTrainer(cfg, _net(), train).fit()
        assert result.termination_reason == "iteration_condition"
        assert "MaxTime" in result.termination_details

    def test_max_score_abort(self, rng):
        train, test = _iters(rng)
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(DataSetLossCalculator(test))
               .iteration_termination_conditions(
                   MaxScoreIterationTerminationCondition(1e-9))
               .epoch_termination_conditions(MaxEpochsTerminationCondition(100))
               .build())
        result = EarlyStoppingTrainer(cfg, _net(), train).fit()
        assert result.termination_reason == "iteration_condition"

    def test_local_file_saver(self, rng, tmp_path):
        train, test = _iters(rng)
        saver = LocalFileModelSaver(str(tmp_path))
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(DataSetLossCalculator(test))
               .epoch_termination_conditions(MaxEpochsTerminationCondition(2))
               .model_saver(saver).save_last_model(True)
               .build())
        result = EarlyStoppingTrainer(cfg, _net(), train).fit()
        assert (tmp_path / "bestModel.zip").exists()
        assert (tmp_path / "latestModel.zip").exists()
        assert result.best_model is not None

    def test_evaluation_score_calculator(self, rng):
        train, test = _iters(rng)
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(EvaluationScoreCalculator(test))
               .epoch_termination_conditions(MaxEpochsTerminationCondition(3))
               .build())
        result = EarlyStoppingTrainer(cfg, _net(), train).fit()
        assert 0.0 <= result.best_model_score <= 1.0


class TestLocalFileSaverDurability:
    """A crash or torn write mid-``save_best_model`` must never cost the
    best model. Saves stage + validate before they
    publish; the outgoing model rotates to ``*.prev.zip``; reads fall
    back past an invalid file like ``CheckpointRecovery.latest_valid``."""

    def _saver_with_two_bests(self, rng, tmp_path):
        saver = LocalFileModelSaver(str(tmp_path))
        x = rng.normal(size=(16, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        net = _net()
        net.fit(x, y, epochs=1)
        saver.save_best_model(net, 1.0)
        net.fit(x, y, epochs=1)
        saver.save_best_model(net, 0.5)     # rotates the first to .prev
        return saver, net

    def test_rotation_keeps_previous_as_fallback(self, rng, tmp_path):
        saver, net = self._saver_with_two_bests(rng, tmp_path)
        assert (tmp_path / "bestModel.zip").exists()
        assert (tmp_path / "bestModel.prev.zip").exists()
        assert saver.get_best_model().iteration_count == net.iteration_count

    def test_torn_write_never_publishes(self, rng, tmp_path):
        """A writer dying mid-stream (scripted at the checkpoint.write
        seam) leaves the PUBLISHED best model untouched and loadable."""
        saver, net = self._saver_with_two_bests(rng, tmp_path)
        good_iter = net.iteration_count
        x = rng.normal(size=(16, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        net.fit(x, y, epochs=1)

        def tear(payload):
            with open(payload["path"], "wb") as f:
                f.write(payload["data"][:len(payload["data"]) // 2])
            raise IOError("writer killed mid-stream")

        plan = faults.FaultPlan().fail("checkpoint.write", exc=tear)
        with plan.active():
            with pytest.raises(IOError, match="mid-stream"):
                saver.save_best_model(net, 0.25)
        assert saver.get_best_model().iteration_count == good_iter

    def test_corrupt_published_best_falls_back_to_prev(self, rng,
                                                       tmp_path):
        saver, net = self._saver_with_two_bests(rng, tmp_path)
        best = tmp_path / "bestModel.zip"
        blob = bytearray(best.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        best.write_bytes(bytes(blob))
        restored = saver.get_best_model()       # falls back to .prev
        assert restored is not None
        assert restored.iteration_count < net.iteration_count

    def test_all_invalid_returns_none(self, rng, tmp_path):
        saver, net = self._saver_with_two_bests(rng, tmp_path)
        for name in ("bestModel.zip", "bestModel.prev.zip"):
            (tmp_path / name).write_bytes(b"")
        assert saver.get_best_model() is None

    def test_corrupt_current_never_clobbers_good_prev(self, rng,
                                                      tmp_path):
        """Rotation is gated on the outgoing file still validating: a
        corrupt current best must not overwrite a good .prev fallback."""
        saver, net = self._saver_with_two_bests(rng, tmp_path)
        prev_bytes = (tmp_path / "bestModel.prev.zip").read_bytes()
        (tmp_path / "bestModel.zip").write_bytes(b"garbage")
        x = rng.normal(size=(16, 6)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        net.fit(x, y, epochs=1)
        saver.save_best_model(net, 0.1)
        assert (tmp_path / "bestModel.prev.zip").read_bytes() == prev_bytes
        assert saver.get_best_model().iteration_count == net.iteration_count


class TestMoreConditions:
    def test_best_score_and_invalid_score_conditions(self, rng):
        train, test = _iters(rng)
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(DataSetLossCalculator(test))
               .iteration_termination_conditions(
                   InvalidScoreIterationTerminationCondition())
               .epoch_termination_conditions(
                   BestScoreEpochTerminationCondition(10.0),
                   MaxEpochsTerminationCondition(20))
               .build())
        result = EarlyStoppingTrainer(cfg, _net(), train).fit()
        assert "BestScore" in result.termination_details
        assert result.total_epochs == 1

    def test_graph_trainer_best_model_rescores_to_its_record(self, rng,
                                                             tmp_path):
        conf = (NeuralNetConfiguration.builder().seed(1).updater("adam")
                .learning_rate(0.05).graph_builder().add_inputs("in")
                .add_layer("d", DenseLayer(n_in=6, n_out=12,
                                           activation="relu"), "in")
                .add_layer("out", OutputLayer(n_in=12, n_out=3,
                                              activation="softmax",
                                              loss="mcxent"), "d")
                .set_outputs("out").build())
        train, test = _iters(rng)
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(DataSetLossCalculator(test))
               .epoch_termination_conditions(MaxEpochsTerminationCondition(2))
               .model_saver(LocalFileModelSaver(str(tmp_path)))
               .build())
        net = ComputationGraph(conf, device="cpu").init()
        result = EarlyStoppingGraphTrainer(cfg, net, train).fit()
        best = result.best_model
        assert type(best).__name__ == "ComputationGraph"
        assert DataSetLossCalculator(test).calculate_score(best) == \
            pytest.approx(result.best_model_score, rel=1e-6)


def test_early_stopping_tracks_reference(tmp_path, rng):
    """Both packages' EarlyStoppingTrainer from the same checkpoint over
    the same iterators: per-epoch scores within 1e-4, the same
    termination and best epoch."""
    import deeplearning4j_tpu.datasets as J
    import deeplearning4j_tpu.earlystopping as JE
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.conf.layers import (DenseLayer as JD,
                                                   OutputLayer as JO)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JM
    from deeplearning4j_tpu.util.serialization import save_model as j_save
    from deeplearning4j_tpu_torch.util.serialization import load_model
    conf = (JNNC.builder().seed(1).updater("adam").learning_rate(0.05).list()
            .layer(JD(n_out=12, activation="relu"))
            .layer(JO(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(6)).build())
    jnet = JM(conf).init()
    j_save(jnet, str(tmp_path / "es.zip"))
    tnet = load_model(str(tmp_path / "es.zip"), device="cpu")
    x, y = _arrays(rng)

    def run(pkg, E, trainer_cls, net):
        cfg = (E.EarlyStoppingConfiguration.builder()
               .score_calculator(E.DataSetLossCalculator(
                   pkg.ArrayDataSetIterator(x[64:], y[64:], 32)))
               .epoch_termination_conditions(
                   E.ScoreImprovementEpochTerminationCondition(1),
                   E.MaxEpochsTerminationCondition(4))
               .build())
        return trainer_cls(cfg, net, pkg.ArrayDataSetIterator(
            x[:64], y[:64], 16)).fit()

    import deeplearning4j_tpu_torch.datasets as T
    import deeplearning4j_tpu_torch.earlystopping as TE
    jr = run(J, JE, JE.EarlyStoppingTrainer, jnet)
    tr = run(T, TE, TE.EarlyStoppingTrainer, tnet)
    assert tr.termination_reason == jr.termination_reason
    assert tr.total_epochs == jr.total_epochs
    assert tr.best_model_epoch == jr.best_model_epoch
    assert sorted(tr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    for e, s in jr.score_vs_epoch.items():
        assert tr.score_vs_epoch[e] == pytest.approx(s, rel=TOL)
