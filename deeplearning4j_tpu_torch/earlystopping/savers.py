"""Model savers (counterpart of the JAX package's
``earlystopping/savers.py``; parity: reference ``earlystopping/saver/`` —
InMemory, LocalFileModelSaver persisting best/latest models). A restored
model is built on the device of the network that was saved."""

from __future__ import annotations

import os
from typing import Optional


class ModelSaver:
    def save_best_model(self, net, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, net, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(ModelSaver):
    """Keeps deep param copies in memory (parity: ``InMemoryModelSaver``)."""

    def __init__(self):
        self._best = None
        self._latest = None

    @staticmethod
    def _snapshot(net):
        from ..util.durable import _clone_tree
        return {
            "conf_json": net.conf.to_json(),
            "params": net.clone_params(),
            "state": _clone_tree(net.state),
            "model_class": type(net).__name__,
            "device": net.device,
        }

    @staticmethod
    def _restore(snap):
        if snap is None:
            return None
        if snap["model_class"] == "ComputationGraph":
            from ..nn.graph_runtime import ComputationGraph
            from ..nn.conf.graph import ComputationGraphConfiguration
            net = ComputationGraph(
                ComputationGraphConfiguration.from_json(snap["conf_json"]),
                device=snap["device"])
        else:
            from ..nn.multilayer import MultiLayerNetwork
            from ..nn.conf.multi_layer import MultiLayerConfiguration
            net = MultiLayerNetwork(
                MultiLayerConfiguration.from_json(snap["conf_json"]),
                device=snap["device"])
        net.set_params(snap["params"])
        net.state = snap["state"]
        return net

    def save_best_model(self, net, score: float) -> None:
        self._best = self._snapshot(net)

    def save_latest_model(self, net, score: float) -> None:
        self._latest = self._snapshot(net)

    def get_best_model(self):
        return self._restore(self._best)

    def get_latest_model(self):
        return self._restore(self._latest)


class LocalFileModelSaver(ModelSaver):
    """Writes checkpoint zips to a directory (parity: ``LocalFileModelSaver``).

    Durability: each save stages through a temp file (the serializer's
    tmp+rename), is manifest-validated BEFORE it replaces the published
    name, and the previously published model rotates to ``*.prev.zip`` —
    so a crash or torn write mid-``save_best_model`` can never leave the
    best model unreadable. ``get_best_model``/``get_latest_model``
    validate on read and fall back past an invalid file to the rotated
    predecessor, the same newest-VALID-wins contract as
    ``CheckpointRecovery.latest_valid()``.
    """

    def __init__(self, directory: str, device=None):
        self.directory = directory
        # where get_*_model builds the network: the saved net's device
        # unless given (``"cuda"`` before anything was saved)
        self.device = device
        os.makedirs(directory, exist_ok=True)
        # staging leftovers from a process killed mid-_save would
        # otherwise accumulate across crash/restart cycles forever
        # (.wip_* is the serializer's own atomic-write temp, left when
        # the kill lands inside save_model itself)
        for name in os.listdir(directory):
            if name.startswith((".staging_", ".wip_")):
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:
                    pass

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "bestModel.zip")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.directory, "latestModel.zip")

    @staticmethod
    def _prev(path: str) -> str:
        return path[:-len(".zip")] + ".prev.zip"

    def _save(self, net, path: str) -> None:
        from ..util.serialization import (CheckpointInvalid, save_model,
                                          verify_checkpoint)
        if self.device is None:
            self.device = net.device
        staging = os.path.join(
            self.directory,
            f".staging_{os.getpid()}_{os.path.basename(path)}")
        try:
            save_model(net, staging)
            verify_checkpoint(staging)      # never publish an invalid zip
            if os.path.exists(path):
                try:
                    # rotate the outgoing model only while it is still a
                    # valid fallback — never clobber a good .prev with a
                    # corrupt current
                    verify_checkpoint(path)
                    os.replace(path, self._prev(path))
                except CheckpointInvalid:
                    pass
            os.replace(staging, path)
        finally:
            if os.path.exists(staging):
                try:
                    os.remove(staging)
                except OSError:
                    pass

    def save_best_model(self, net, score: float) -> None:
        self._save(net, self.best_path)

    def save_latest_model(self, net, score: float) -> None:
        self._save(net, self.latest_path)

    def _load(self, path: str):
        import logging
        from ..util.serialization import load_model, verify_checkpoint
        for candidate in (path, self._prev(path)):
            if not os.path.exists(candidate):
                continue
            try:
                verify_checkpoint(candidate)
                return load_model(candidate, device=self.device or "cuda")
            except Exception as e:
                logging.getLogger("deeplearning4j_tpu_torch").warning(
                    "saved model %s unusable (%s: %s) — falling back",
                    candidate, type(e).__name__, e)
        return None

    def get_best_model(self):
        return self._load(self.best_path)

    def get_latest_model(self):
        return self._load(self.latest_path)
