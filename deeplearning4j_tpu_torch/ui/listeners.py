"""Visualization listeners beyond StatsListener.

Parity: reference ``deeplearning4j-ui/.../ConvolutionalIterationListener.java``
(activation image grids for conv layers, rendered by
``ConvolutionalListenerModule``) — re-done probe-based, as the JAX package's
``ui/listeners.py`` does: instead of hooking per-layer activations inside
the train step, the listener re-runs ``feed_forward`` on a fixed probe
batch every N iterations and posts downsampled activation maps (f32 host
copies of the net's activations) to stats storage, where the UI's
activations module renders them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..storage.stats_storage import Persistable, StatsStorageRouter
from ..optimize.listeners import TrainingListener

ACTIVATIONS_TYPE_ID = "ConvolutionalListener"


class ConvolutionalIterationListener(TrainingListener):
    """Posts activation-map grids for the first convolutional (4-D NHWC)
    activation every ``frequency`` iterations.

    ``probe_input``: a fixed input batch (only the first example is used) so
    successive grids are comparable across training, like the reference's
    last-minibatch capture but deterministic.
    """

    def __init__(self, router: StatsStorageRouter, probe_input,
                 frequency: int = 25, session_id: str = "default",
                 worker_id: str = "worker_0", max_channels: int = 16,
                 max_size: int = 28):
        self.router = router
        self.probe = np.asarray(probe_input)[:1]
        self.frequency = max(1, int(frequency))
        self.session_id = session_id
        self.worker_id = worker_id
        self.max_channels = int(max_channels)
        self.max_size = int(max_size)

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.frequency:
            return
        acts = model.feed_forward(self.probe, train=False)
        if isinstance(acts, dict):  # ComputationGraph: name → activation
            items = list(acts.items())
        else:
            # MLN list has the input at index 0 (feedForward parity) —
            # render layer OUTPUTS, like the reference listener
            items = [(f"layer_{i}", a) for i, a in enumerate(acts[1:])]
        for name, a in items:
            a = (a.detach().float().cpu().numpy() if torch.is_tensor(a)
                 else np.asarray(a))
            if a.ndim != 4:  # NHWC conv activation
                continue
            self._post(name, a[0], iteration)
            return  # first conv layer only, like the reference default

    def _post(self, layer_name: str, hwc: np.ndarray, iteration: int) -> None:
        h, w, c = hwc.shape
        sh = max(1, h // self.max_size)
        sw = max(1, w // self.max_size)
        maps = []
        for ch in range(min(c, self.max_channels)):
            m = hwc[::sh, ::sw, ch].astype(np.float64)
            lo, hi = float(m.min()), float(m.max())
            scale = (hi - lo) or 1.0
            maps.append(np.round((m - lo) / scale, 3).tolist())
        self.router.put_update(Persistable(
            session_id=self.session_id, type_id=ACTIVATIONS_TYPE_ID,
            worker_id=self.worker_id, timestamp=time.time(),
            data={"iteration": int(iteration), "layer": layer_name,
                  "shape": [int(h), int(w), int(c)], "maps": maps}))
