"""The port's checkpoint recovery (``util/recovery.py``) on the CPU: the
cases of ``tests/test_recovery.py``, and recovery points across packages
(a zip written by the reference's ``CheckpointRecovery`` restored by the
port's and the reverse: counters exact, parameters bit for bit).

Within the port, resume is exact: final parameters bit for bit (the
reference's own test allowed 1e-5 on outputs; the port's CPU steps are
deterministic, so it is held to equality here).
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import faults
from deeplearning4j_tpu_torch.util.recovery import (CheckpointRecovery,
                                                    RecoverableTrainer,
                                                    _CheckpointListener)


def _net(seed=11):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater("adam")
            .learning_rate(0.01).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(rng):
    x = rng.normal(size=(64, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    return x, y


def _out(net, x):
    return net.output(x).detach().numpy()


def _same_params(a, b):
    for v in a.params:
        for k in a.params[v]:
            assert torch.equal(a.params[v][k], b.params[v][k]), (v, k)


class TestCheckpointRecovery:
    def test_rolling_save_keeps_newest(self, tmp_path, rng):
        net = _net()
        x, y = _data(rng)
        rec = CheckpointRecovery(str(tmp_path), device="cpu", keep=2)
        for _ in range(4):
            net.fit(x, y, epochs=1)
            rec.save(net)
        names = sorted(os.listdir(tmp_path))
        assert len(names) == 2
        assert rec.latest().endswith(f"epoch{net.epoch_count}"
                                     f"_iter{net.iteration_count}.zip")

    def test_restore_roundtrips_counters_and_params(self, tmp_path, rng):
        net = _net()
        x, y = _data(rng)
        net.fit(x, y, epochs=2)
        rec = CheckpointRecovery(str(tmp_path), device="cpu")
        rec.save(net)
        restored = rec.restore()
        assert restored.epoch_count == net.epoch_count
        assert restored.iteration_count == net.iteration_count
        np.testing.assert_array_equal(_out(net, x[:4]),
                                      _out(restored, x[:4]))
        _same_params(net, restored)

    def test_restore_empty_dir_returns_none(self, tmp_path):
        assert CheckpointRecovery(str(tmp_path), device="cpu").restore() is None


class TestCorruptCheckpointFallback:
    """Integrity validation on restore: flipped bytes, truncation, empty
    files and torn writes never brick recovery — restore() falls back to
    the newest checkpoint that still validates."""

    def _two_checkpoints(self, tmp_path, rng):
        net = _net()
        x, y = _data(rng)
        rec = CheckpointRecovery(str(tmp_path), device="cpu", keep=3)
        net.fit(x, y, epochs=1)
        first = rec.save(net)
        net.fit(x, y, epochs=1)
        second = rec.save(net)
        return rec, first, second

    def test_flipped_bytes_fall_back_to_previous(self, tmp_path, rng):
        rec, first, second = self._two_checkpoints(tmp_path, rng)
        blob = bytearray(open(second, "rb").read())
        mid = len(blob) // 2
        blob[mid] ^= 0xFF          # corrupt the arrays payload, size intact
        blob[mid + 1] ^= 0xFF
        with open(second, "wb") as f:
            f.write(bytes(blob))
        assert rec.latest() == second             # newest by name...
        assert rec.latest_valid() == first        # ...but invalid by CRC
        restored = rec.restore()
        assert restored is not None
        assert restored.epoch_count == 1          # the first checkpoint

    def test_truncated_file_falls_back(self, tmp_path, rng):
        rec, first, second = self._two_checkpoints(tmp_path, rng)
        blob = open(second, "rb").read()
        with open(second, "wb") as f:
            f.write(blob[:len(blob) // 3])        # partial write
        assert rec.latest_valid() == first
        assert rec.restore().epoch_count == 1

    def test_empty_file_falls_back(self, tmp_path, rng):
        rec, first, second = self._two_checkpoints(tmp_path, rng)
        open(second, "wb").close()
        assert rec.latest_valid() == first
        assert rec.restore().epoch_count == 1

    def test_all_corrupt_returns_none(self, tmp_path, rng):
        rec, first, second = self._two_checkpoints(tmp_path, rng)
        for p in (first, second):
            open(p, "wb").close()
        assert rec.latest_valid() is None
        assert rec.restore() is None

    def test_verify_checkpoint_reports_reason(self, tmp_path, rng):
        from deeplearning4j_tpu_torch.util.serialization import (
            CheckpointInvalid, verify_checkpoint)
        rec, first, second = self._two_checkpoints(tmp_path, rng)
        verify_checkpoint(second)                  # intact: no raise
        open(second, "wb").close()
        with pytest.raises(CheckpointInvalid, match="empty"):
            verify_checkpoint(second)

    def test_faultplan_kills_write_midstream(self, tmp_path, rng):
        """FaultPlan scripts the checkpoint writer dying mid-stream: the
        save raises, no corrupt artifact appears under the final name, and
        the next restore transparently serves the previous valid
        checkpoint (the acceptance scenario — no sleeps, no monkeypatched
        internals)."""
        net = _net()
        x, y = _data(rng)
        rec = CheckpointRecovery(str(tmp_path), device="cpu", keep=3)
        net.fit(x, y, epochs=1)
        first = rec.save(net)
        net.fit(x, y, epochs=1)

        def torn_write(payload):
            # emulate the writer crashing mid-stream: half the artifact
            # lands on disk, then the process "dies" before the rename
            with open(payload["path"], "wb") as f:
                f.write(payload["data"][:len(payload["data"]) // 2])
            raise IOError("writer killed mid-stream")

        plan = faults.FaultPlan().fail("checkpoint.write", exc=torn_write)
        with plan.active():
            with pytest.raises(IOError, match="mid-stream"):
                rec.save(net)
        assert plan.triggered == [("checkpoint.write", 1)]
        # a fresh recovery (new process) sweeps the debris and falls back
        rec2 = CheckpointRecovery(str(tmp_path), device="cpu", keep=3)
        assert not [n for n in os.listdir(tmp_path)
                    if n.startswith((".tmp_", ".wip_"))]
        assert rec2.latest_valid("boundary") == first
        restored = rec2.restore()
        assert restored is not None
        assert restored.epoch_count == 1

    def test_clean_injected_failure_leaves_no_final_artifact(self, tmp_path,
                                                            rng):
        """A fault that raises BEFORE any bytes land (e.g. ENOSPC) leaves
        the directory exactly as it was."""
        net = _net()
        x, y = _data(rng)
        rec = CheckpointRecovery(str(tmp_path), device="cpu")
        net.fit(x, y, epochs=1)
        first = rec.save(net)
        names_before = sorted(os.listdir(tmp_path))
        net.fit(x, y, epochs=1)
        plan = faults.FaultPlan().fail("checkpoint.write",
                                       exc=IOError("disk full"))
        with plan.active():
            with pytest.raises(IOError, match="disk full"):
                rec.save(net)
        assert sorted(os.listdir(tmp_path)) == names_before
        assert rec.restore().epoch_count == 1


class TestRecoverableTrainer:
    def test_resume_matches_uninterrupted_run(self, tmp_path, rng):
        """Train 4 epochs straight vs 2 epochs + 'crash' + resume to 4 —
        identical final parameters (exact-resume semantics via updater
        state in the checkpoint)."""
        x, y = _data(rng)

        straight = _net()
        straight.fit(x, y, epochs=4)

        # interrupted run: 2 epochs, checkpointed, process "dies"
        first = RecoverableTrainer(_net(), str(tmp_path), frequency=10_000)
        first.fit(x, y, epochs=2)
        assert not first.resumed

        # new process: trainer restores and finishes the remaining epochs
        second = RecoverableTrainer(_net(), str(tmp_path), frequency=10_000)
        assert second.resumed
        assert second.net.epoch_count == 2
        second.fit(x, y, epochs=4)
        assert second.net.epoch_count == 4

        _same_params(straight, second.net)

    def test_fit_is_noop_when_target_epochs_reached(self, tmp_path, rng):
        x, y = _data(rng)
        t = RecoverableTrainer(_net(), str(tmp_path), frequency=10_000)
        t.fit(x, y, epochs=2)
        t2 = RecoverableTrainer(_net(), str(tmp_path), frequency=10_000)
        before = t2.net.iteration_count
        t2.fit(x, y, epochs=2)   # already done
        assert t2.net.iteration_count == before

    def test_iteration_frequency_checkpoints(self, tmp_path, rng):
        """Periodic (mid-epoch) checkpoints are written every `frequency`
        iterations, distinct from the boundary recovery points."""
        x, y = _data(rng)
        batches = [DataSet(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])
                   for i in range(8)]   # 8 iterations per epoch
        t = RecoverableTrainer(_net(), str(tmp_path), frequency=3, keep=50)
        t.fit(ListDataSetIterator(batches, batch_size=8), epochs=1)
        names = os.listdir(tmp_path)
        periodic = [n for n in names if n.startswith("periodic_")]
        boundary = [n for n in names if n.startswith("checkpoint_")]
        # iterations 3 and 6 hit the frequency, epoch end writes a boundary
        assert len(periodic) == 2
        assert len(boundary) == 1

    def test_resume_ignores_newer_periodic_checkpoint(self, tmp_path, rng):
        """Automatic resume uses the newest epoch BOUNDARY, not a mid-epoch
        periodic save — re-running a partial epoch on top of its own
        periodic checkpoint would double-apply its first batches."""
        x, y = _data(rng)
        t = RecoverableTrainer(_net(), str(tmp_path), frequency=10_000)
        t.fit(x, y, epochs=1)
        # simulate a crash mid-epoch-2: a periodic save newer than boundary
        t.net.fit(x, y, epochs=1)
        t.net.epoch_count = 1        # mid-epoch: counter not yet bumped
        t.recovery.save(t.net, kind="periodic")
        t2 = RecoverableTrainer(_net(), str(tmp_path), frequency=10_000)
        assert t2.resumed
        # boundary (iteration 1), not the newer periodic save (iteration 2)
        assert t2.net.iteration_count == 1

    def test_unloadable_newer_boundary_falls_back_to_durable(
            self, tmp_path, rng):
        """A boundary zip that validates but fails to LOAD must fall
        back to the next-newest recovery point ACROSS kinds — here an
        older durable snapshot — not silently past it to an even older
        zip (or to nothing)."""
        from deeplearning4j_tpu_torch.util.durable import (CheckpointStore,
                                                           TrainingState)

        net = _net()
        x, y = _data(rng)
        net.fit(x, y, epochs=1)
        CheckpointStore(str(tmp_path), device="cpu").save(TrainingState.capture(net))
        net.fit(x, y, epochs=1)
        CheckpointRecovery(str(tmp_path), device="cpu").save(net)   # newer legacy zip

        def boom(payload):
            if payload["path"].endswith(".zip"):
                raise IOError("validates but will not load")

        plan = faults.FaultPlan()
        plan.always("recovery.restore", exc=boom)
        with plan.active():
            t = RecoverableTrainer(_net(), str(tmp_path))
        assert t.resumed
        assert t.net.epoch_count == 1     # the durable snapshot won

    def test_listener_removed_after_fit(self, tmp_path, rng):
        x, y = _data(rng)
        t = RecoverableTrainer(_net(), str(tmp_path))
        t.fit(x, y, epochs=1)
        assert not any(isinstance(l, _CheckpointListener)
                       for l in t.net.listeners)

    def test_works_with_computation_graph(self, tmp_path, rng):
        from deeplearning4j_tpu_torch.nn.graph_runtime import \
            ComputationGraph

        def gnet():
            b = (NeuralNetConfiguration.builder().seed(2).updater("adam")
                 .learning_rate(0.01).graph_builder()
                 .add_inputs("in")
                 .add_layer("d", DenseLayer(n_in=6, n_out=12,
                                            activation="tanh"), "in")
                 .add_layer("out", OutputLayer(n_in=12, n_out=3,
                                               activation="softmax",
                                               loss="mcxent"), "d")
                 .set_outputs("out"))
            return ComputationGraph(b.build(), device="cpu").init()

        x, y = _data(rng)
        t = RecoverableTrainer(gnet(), str(tmp_path), frequency=10_000)
        t.fit(x, y, epochs=2)
        t2 = RecoverableTrainer(gnet(), str(tmp_path), frequency=10_000)
        assert t2.resumed and t2.net.epoch_count == 2
        with pytest.raises(ValueError, match="mask"):
            t2.fit(x, y, epochs=3, mask=np.ones((64, 1), np.float32))


class TestRecoverableTrainerExactResume:
    """With a seekable source, RecoverableTrainer's mid-epoch recovery
    points are cursor-bearing TrainingState snapshots — resume replays
    zero batches and matches the uninterrupted run bit for bit."""

    def _batches(self):
        # a FRESH seeded stream per call: every run (reference, killed,
        # resumed) must see the identical dataset
        x, y = _data(np.random.default_rng(99))
        return ListDataSetIterator(
            [DataSet(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])
             for i in range(8)], batch_size=8)

    def test_mid_epoch_crash_resumes_bit_exactly(self, tmp_path):
        straight = _net()
        straight.fit(self._batches(), epochs=2)

        t1 = RecoverableTrainer(_net(), str(tmp_path), frequency=2)
        plan = faults.FaultPlan()

        def die(payload):
            if payload["iteration"] == 11:   # mid-epoch 2 (8 per epoch)
                raise faults.InjectedFault("killed mid-epoch")
        plan.always("training.step", exc=die)
        with plan.active():
            with pytest.raises(faults.InjectedFault):
                t1.fit(self._batches(), epochs=2)

        t2 = RecoverableTrainer(_net(), str(tmp_path), frequency=2)
        assert t2.resumed
        # the resume point depends on which async snapshot committed
        # before the kill (epoch boundary at 8, or the mid-epoch cursor
        # snapshot at 10); the exactness contract holds from either
        assert t2.net.iteration_count >= 8
        t2.fit(self._batches(), epochs=2)
        assert t2.net.iteration_count == 16
        assert t2.net.epoch_count == 2
        _same_params(straight, t2.net)


class TestAcrossPackages:
    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_boundary_checkpoint_restores_in_the_other(self, tmp_path, rng,
                                                       writer):
        from deeplearning4j_tpu.nn.conf import \
            NeuralNetConfiguration as JNNC
        from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
        from deeplearning4j_tpu.nn.conf.layers import (DenseLayer as JD,
                                                       OutputLayer as JO)
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JM
        from deeplearning4j_tpu.util.recovery import \
            CheckpointRecovery as JRecovery
        x, y = _data(rng)
        if writer == "reference":
            conf = (JNNC.builder().seed(11).updater("adam")
                    .learning_rate(0.01).list()
                    .layer(JD(n_out=16, activation="tanh"))
                    .layer(JO(n_out=3, activation="softmax", loss="mcxent"))
                    .set_input_type(JIT.feed_forward(6)).build())
            src = JM(conf).init()
            src.fit(x, y, epochs=2)
            JRecovery(str(tmp_path)).save(src)
            got = CheckpointRecovery(str(tmp_path), device="cpu").restore()
            params = {v: {k: np.asarray(a) for k, a in ps.items()}
                      for v, ps in src.params.items()}
            loaded = {v: {k: p.detach().numpy() for k, p in ps.items()}
                      for v, ps in got.params.items()}
        else:
            src = _net()
            src.fit(x, y, epochs=2)
            CheckpointRecovery(str(tmp_path), device="cpu").save(src)
            got = JRecovery(str(tmp_path)).restore()
            params = {v: {k: p.detach().numpy() for k, p in ps.items()}
                      for v, ps in src.params.items()}
            loaded = {v: {k: np.asarray(a) for k, a in ps.items()}
                      for v, ps in got.params.items()}
        assert (got.epoch_count, got.iteration_count) == (2, 2)
        for v, ps in params.items():
            for k, a in ps.items():
                np.testing.assert_array_equal(loaded[v][k], a)
