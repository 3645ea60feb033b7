"""Gradient checking: central finite differences against autograd
(counterpart of the JAX package's ``gradientcheck.py``; the same
thresholds and result types).

Each checked parameter entry is moved by ±epsilon in float64 and the
loss's central difference compared with the analytic gradient torch
autograd gives through the port's forward functions — including the
preprocessors, masks, regularization, BatchNormalization's hand-written
backward and the LSTM loop.

    from deeplearning4j_tpu_torch.gradientcheck import check_gradients
    result = check_gradients(conf, x, y, device="cpu")   # re-run in float64
    assert result.passed, result.summary()
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

DEFAULT_EPS = 1e-6
DEFAULT_MAX_REL_ERROR = 1e-5
# below this absolute difference the relative error is not meaningful
DEFAULT_MIN_ABS_ERROR = 1e-9


@dataclasses.dataclass
class GradCheckFailure:
    param: str
    index: Tuple[int, ...]
    analytic: float
    numeric: float
    rel_error: float


@dataclasses.dataclass
class GradCheckResult:
    passed: bool
    n_checked: int
    max_rel_error: float
    failures: List[GradCheckFailure]

    def summary(self) -> str:
        lines = [f"gradient check: {'PASS' if self.passed else 'FAIL'} "
                 f"({self.n_checked} entries, max rel err {self.max_rel_error:.3e})"]
        for f in self.failures[:20]:
            lines.append(f"  {f.param}{list(f.index)}: analytic={f.analytic:.6e} "
                         f"numeric={f.numeric:.6e} rel={f.rel_error:.3e}")
        if len(self.failures) > 20:
            lines.append(f"  ... and {len(self.failures) - 20} more")
        return "\n".join(lines)


def _f64(conf):
    conf64 = copy.deepcopy(conf)
    conf64.training.dtype = "float64"
    return conf64


def _check_loss_fn(loss, params, eps, max_rel_error, min_abs_error,
                   max_per_param, seed) -> GradCheckResult:
    """Compare autograd of ``loss(params)`` with central differences, the
    entries of each parameter moved in place."""
    named = [(f"['{k}']['{n}']", p) for k, ps in params.items()
             for n, p in ps.items()]
    grads = torch.autograd.grad(loss(params), [p for _, p in named],
                                allow_unused=True)
    rng = np.random.default_rng(seed)
    failures: List[GradCheckFailure] = []
    n_checked = 0
    max_rel = 0.0
    with torch.no_grad():
        for (name, p), g in zip(named, grads):
            g_np = (np.zeros(tuple(p.shape)) if g is None
                    else g.detach().cpu().numpy().astype(np.float64))
            flat = p.view(-1)
            idxs = np.arange(flat.numel())
            if max_per_param is not None and flat.numel() > max_per_param:
                idxs = rng.choice(flat.numel(), size=max_per_param,
                                  replace=False)
            for flat_idx in idxs:
                idx = np.unravel_index(flat_idx, tuple(p.shape))
                orig = float(flat[flat_idx])
                flat[flat_idx] = orig + eps
                f_plus = float(loss(params))
                flat[flat_idx] = orig - eps
                f_minus = float(loss(params))
                flat[flat_idx] = orig
                numeric = (f_plus - f_minus) / (2.0 * eps)
                analytic = float(g_np[idx])
                denom = max(abs(numeric), abs(analytic))
                abs_err = abs(numeric - analytic)
                rel = 0.0 if denom == 0.0 else abs_err / denom
                n_checked += 1
                if abs_err > min_abs_error and rel > max_rel_error:
                    failures.append(GradCheckFailure(
                        name, tuple(int(i) for i in idx), analytic, numeric,
                        rel))
                if abs_err > min_abs_error:
                    max_rel = max(max_rel, rel)
    return GradCheckResult(passed=not failures, n_checked=n_checked,
                           max_rel_error=max_rel, failures=failures)


def _tensor(a, device, dtype=torch.float64):
    return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype,
                                                  device=device)


def check_gradients(conf, x, y, mask=None, *,
                    epsilon: float = DEFAULT_EPS,
                    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                    max_per_param: Optional[int] = None,
                    seed: int = 0, params=None,
                    device="cuda") -> GradCheckResult:
    """Gradient-check a MultiLayerConfiguration on one batch, re-run under
    the float64 policy on ``device``. ``params`` (``{layer_i: {name:
    array}}``) replaces the random initialisation. Configurations under
    test must not use dropout."""
    from .nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(_f64(conf), device=device)
    if params is None:
        net.init()
    else:
        net.set_params({k: {n: _tensor(a, device) for n, a in ps.items()}
                        for k, ps in params.items()})
    x64, y64 = _tensor(x, device), _tensor(y, device)
    m64 = _tensor(mask, device)
    states = net._states_list()

    def loss(p):
        return net._loss_fn(x64, y64, m64, params=p, states=states)[0]

    return _check_loss_fn(loss, net.params, epsilon, max_rel_error,
                          min_abs_error, max_per_param, seed)


def check_graph_gradients(conf, inputs, labels, masks=None, *,
                          epsilon: float = DEFAULT_EPS,
                          max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                          min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                          max_per_param: Optional[int] = None,
                          seed: int = 0, device="cuda") -> GradCheckResult:
    """Gradient-check a ComputationGraphConfiguration, in float64."""
    from .nn.graph_runtime import ComputationGraph
    net = ComputationGraph(_f64(conf), device=device).init()
    inputs64 = [_tensor(a, device) for a in _as_list(inputs)]
    labels64 = [_tensor(a, device) for a in _as_list(labels)]
    masks64 = (None if masks is None
               else [_tensor(m, device) for m in _as_list(masks)])

    def loss(p):
        return net._loss_fn(inputs64, labels64, masks64, params=p)

    return _check_loss_fn(loss, net.params, epsilon, max_rel_error,
                          min_abs_error, max_per_param, seed)


def _as_list(v) -> List[Any]:
    return list(v) if isinstance(v, (list, tuple)) else [v]
