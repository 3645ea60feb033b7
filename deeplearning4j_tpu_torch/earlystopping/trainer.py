"""Early-stopping trainers (counterpart of the JAX package's
``earlystopping/trainer.py``; parity: reference
``earlystopping/trainer/BaseEarlyStoppingTrainer.java`` — the epoch loop:
fit one epoch → every N epochs compute held-out score → save best → poll
termination conditions; iteration conditions polled per minibatch).
"""

from __future__ import annotations

from typing import Optional

from .config import EarlyStoppingConfiguration, EarlyStoppingResult


class BaseEarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, net, train_data,
                 watchdog=None):
        self.config = config
        self.net = net
        self.train_data = train_data
        # optional util.durable.StepWatchdog: petted once per minibatch,
        # so a hung dispatch/ingest surfaces as a diagnosed timeout
        # instead of a silent stall
        self.watchdog = watchdog

    def fit(self) -> EarlyStoppingResult:
        net = self.net
        if net.params is None:
            net.init()
        if self.watchdog is not None:
            self.watchdog.arm()
        try:
            return self._fit_loop()
        finally:
            if self.watchdog is not None:
                self.watchdog.disarm()

    def _fit_loop(self) -> EarlyStoppingResult:
        from ..util import faults as _faults
        cfg = self.config
        net = self.net
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()

        best_score: Optional[float] = None
        best_epoch = -1
        score_vs_epoch = {}
        epoch = 0
        reason, details = "epoch_condition", ""

        while True:
            # lazy epoch-start reset: the final epoch (or an
            # iteration-condition stop) never restarts the producer just
            # to discard the work; epoch 0 revives an iterator a previous
            # fit() left exhausted (same contract as run_fit_loop)
            if hasattr(self.train_data, "reset") and (
                    epoch > 0 or (hasattr(self.train_data, "has_next")
                                  and not self.train_data.has_next())):
                self.train_data.reset()
            stop_iteration = None
            for x, y, mask in self._staged_batches():
                _faults.check("training.step", {
                    "model": type(net).__name__, "epoch": epoch,
                    "iteration": net.iteration_count,
                    "kind": "earlystopping"})
                loss = float(self._fit_batch(x, y, mask))
                if self.watchdog is not None:
                    self.watchdog.pet()
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(loss):
                        stop_iteration = c
                        break
                if stop_iteration is not None:
                    break

            if stop_iteration is not None:
                reason = "iteration_condition"
                details = repr(stop_iteration)
                break

            last_score = None
            if epoch % cfg.evaluate_every_n_epochs == 0:
                last_score = float(cfg.score_calculator.calculate_score(net))
                score_vs_epoch[epoch] = last_score
                if best_score is None or last_score < best_score:
                    best_score, best_epoch = last_score, epoch
                    cfg.model_saver.save_best_model(net, last_score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(net, last_score)
            # epoch conditions are polled EVERY epoch (parity with the
            # reference loop), using the most recent score when this epoch
            # had no evaluation
            poll_score = (last_score if last_score is not None
                          else (score_vs_epoch[max(score_vs_epoch)]
                                if score_vs_epoch else float("inf")))
            stop_epoch = None
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, poll_score):
                    stop_epoch = c
                    break
            if stop_epoch is not None:
                reason = "epoch_condition"
                details = repr(stop_epoch)
                break
            epoch += 1

        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch + 1,
            best_model_epoch=best_epoch,
            best_model_score=best_score if best_score is not None else float("nan"),
            score_vs_epoch=score_vs_epoch,
            best_model=cfg.model_saver.get_best_model(),
        )

    def _fit_batch(self, x, y, mask):
        raise NotImplementedError

    def _staged_batches(self):
        """The ingest-staged view of ``_batches()``: background staging
        onto the net's device for iterator sources (the stage ``fit()``
        uses), plain pass-through for single DataSets or already staged
        async iterators."""
        from ..util import ingest as _ingest
        data = self.train_data
        if (hasattr(data, "features") or not _ingest.staging_enabled()
                or _ingest.already_staged(data)):
            yield from self._batches()
            return
        staged = _ingest.stage(self._batches(), stage_name="earlystopping",
                               device=self.net.device)
        try:
            yield from staged
        finally:
            staged.close()

    def _batches(self):
        """Yield (features, labels, mask) triples from train_data."""
        data = self.train_data
        if hasattr(data, "features"):
            yield (data.features, data.labels,
                   getattr(data, "features_mask", None))
            return
        for item in data:
            if hasattr(item, "features"):
                yield (item.features, item.labels,
                       getattr(item, "features_mask", None))
            else:
                x, y = item[0], item[1]
                yield (x, y, item[2] if len(item) > 2 else None)


class EarlyStoppingTrainer(BaseEarlyStoppingTrainer):
    """For MultiLayerNetwork (parity: ``EarlyStoppingTrainer.java``)."""

    def _fit_batch(self, x, y, mask):
        return self.net.fit_batch(x, y, mask)


class EarlyStoppingGraphTrainer(BaseEarlyStoppingTrainer):
    """For ComputationGraph (parity: ``EarlyStoppingGraphTrainer.java``)."""

    def _fit_batch(self, x, y, mask):
        return self.net.fit_batch(x, y, None if mask is None else [mask])
