"""Recurrent-family layer configs (counterpart of the JAX package's
``nn/conf/recurrent.py``): GravesLSTM, GravesBidirectionalLSTM,
LastTimeStepLayer and TimeDistributedDenseLayer.

The LSTM has the reference's parameter layout — ``W`` [n_in, 4n],
``RW`` [n, 4n], peepholes ``P`` [3, n], bias ``b`` [4n] with gate order
[a (block input), i, f, o] — and its math: the input projection of all
timesteps in one matmul, then the recurrence. The reference runs the
recurrence as ``lax.scan``; here it is a Python loop over the timesteps
(a few small kernels per step), and backpropagation through time is
autograd through that loop. Masked timesteps carry the state through and
output 0. Streaming inference (``rnn_time_step``) feeds ``(h, c)`` in
``state``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ... import dtypes as _dtypes
from ..weights import init_weights
from .inputs import InputType
from .layers import Layer, _full, register_layer
from .preprocessors import CnnToRnnPreProcessor, FeedForwardToRnnPreProcessor


@dataclasses.dataclass
class BaseRecurrentLayer(Layer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def set_n_in(self, input_type: InputType, override: bool = False) -> None:
        if self.n_in is None or override:
            self.n_in = input_type.flat_size()

    def preprocessor_for(self, input_type: InputType):
        if input_type.kind == "feedforward":
            return FeedForwardToRnnPreProcessor()
        if input_type.kind == "convolutional":
            return CnnToRnnPreProcessor(height=input_type.height,
                                        width=input_type.width,
                                        channels=input_type.channels)
        return None


def _lstm_shapes(n_in, n):
    return {"W": (n_in, 4 * n), "RW": (n, 4 * n), "P": (3, n), "b": (4 * n,)}


def _lstm_init(gen, n_in, n, weight_init, dist, forget_bias, dtype, device):
    w = init_weights(gen, (n_in, 4 * n), weight_init, fan_in=n_in,
                     fan_out=n, distribution=dist, dtype=dtype, device=device)
    rw = init_weights(gen, (n, 4 * n), weight_init, fan_in=n, fan_out=n,
                      distribution=dist, dtype=dtype, device=device)
    b = torch.zeros((4 * n,), dtype=dtype, device=device)
    b[2 * n:3 * n] = forget_bias           # the forget-gate slice
    return {"W": w, "RW": rw, "P": torch.zeros((3, n), dtype=dtype,
                                               device=device), "b": b}


def lstm_scan(params, x, act, gate_act, h0, c0, mask, policy):
    """An LSTM over [b, t, n_in] → ([b, t, n], (h, c)) in the compute
    dtype: the input projection of every step in one matmul, then one
    cell per timestep."""
    n = params["RW"].shape[0]
    cdt = policy.compute_dtype
    w, rw, p, b = (params[k].to(cdt) for k in ("W", "RW", "P", "b"))
    zx = torch.matmul(x.to(cdt), w) + b          # [b, t, 4n]
    h, c = h0, c0
    hs = []
    for t in range(zx.shape[1]):
        z = zx[:, t] + h @ rw
        a = act(z[:, :n])
        i = gate_act(z[:, n:2 * n] + c * p[0])
        f = gate_act(z[:, 2 * n:3 * n] + c * p[1])
        c_new = f * c + i * a
        o = gate_act(z[:, 3 * n:] + c_new * p[2])
        h_new = o * act(c_new)
        if mask is not None:
            m = mask[:, t, None].to(h_new.dtype)
            h_new = m * h_new + (1 - m) * h
            c_new = m * c_new + (1 - m) * c
        hs.append(h_new)
        h, c = h_new, c_new
    out = torch.stack(hs, dim=1)
    if mask is not None:
        out = out * mask[..., None].to(out.dtype)
    return out, (h, c)


@register_layer("graves_lstm")
@dataclasses.dataclass
class GravesLSTM(BaseRecurrentLayer):
    """LSTM with peepholes (the Graves 2013 formulation)."""

    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    def regularized_params(self):
        return ("W", "RW")

    def param_shapes(self, policy=None):
        return _lstm_shapes(self.n_in, self.n_out)

    def init_params(self, gen, policy=None, device="cpu"):
        return _lstm_init(gen, self.n_in, self.n_out,
                          self.weight_init or "XAVIER", self.dist,
                          self.forget_gate_bias_init,
                          (policy or _dtypes.FLOAT32).param_dtype, device)

    def _zero_state(self, batch, policy, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).compute_dtype
        return {"h": torch.zeros((batch, self.n_out), dtype=dt, device=device),
                "c": torch.zeros((batch, self.n_out), dtype=dt, device=device)}

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        policy = policy or _dtypes.FLOAT32
        x = self._dropout_in(x, train, generator)
        if state and "h" in state:
            h0 = state["h"].to(policy.compute_dtype)
            c0 = state["c"].to(policy.compute_dtype)
        else:
            z = self._zero_state(x.shape[0], policy, x.device)
            h0, c0 = z["h"], z["c"]
        act = self._act("tanh" if self.activation is None else self.activation)
        out, (h, c) = lstm_scan(params, x, act, self._act(self.gate_activation),
                                h0, c0, mask, policy)
        return out, {"h": h, "c": c}

    def step(self, params, x_t, state, *, policy=None):
        """One timestep for streaming inference: [b, n_in] → [b, n]."""
        out, new_state = self.apply(params, x_t[:, None, :], state=state,
                                    policy=policy)
        return out[:, 0, :], new_state


@register_layer("graves_bidirectional_lstm")
@dataclasses.dataclass
class GravesBidirectionalLSTM(BaseRecurrentLayer):
    """Bidirectional Graves LSTM: the forward and backward passes are
    summed. Params: ``F_*`` (forward) and ``B_*`` (backward) LSTM sets."""

    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    def param_shapes(self, policy=None):
        base = _lstm_shapes(self.n_in, self.n_out)
        return {f"{d}_{k}": v for d in ("F", "B") for k, v in base.items()}

    def init_params(self, gen, policy=None, device="cpu"):
        out = {}
        for d in ("F", "B"):
            p = _lstm_init(gen, self.n_in, self.n_out,
                           self.weight_init or "XAVIER", self.dist,
                           self.forget_gate_bias_init,
                           (policy or _dtypes.FLOAT32).param_dtype, device)
            out.update({f"{d}_{k}": v for k, v in p.items()})
        return out

    def regularized_params(self):
        return ("F_W", "F_RW", "B_W", "B_RW")

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        policy = policy or _dtypes.FLOAT32
        x = self._dropout_in(x, train, generator)
        act = self._act("tanh" if self.activation is None else self.activation)
        gact = self._act(self.gate_activation)
        zeros = torch.zeros((x.shape[0], self.n_out),
                            dtype=policy.compute_dtype, device=x.device)
        fp = {k[2:]: v for k, v in params.items() if k.startswith("F_")}
        bp = {k[2:]: v for k, v in params.items() if k.startswith("B_")}
        out_f, _ = lstm_scan(fp, x, act, gact, zeros, zeros, mask, policy)
        out_b, _ = lstm_scan(bp, torch.flip(x, [1]), act, gact, zeros, zeros,
                             None if mask is None else torch.flip(mask, [1]),
                             policy)
        return out_f + torch.flip(out_b, [1]), state


@register_layer("last_time_step")
@dataclasses.dataclass
class LastTimeStepLayer(Layer):
    """[b, t, f] → [b, f] at the last unmasked step."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        if mask is None:
            return x[:, -1, :], state
        last = torch.argmax(torch.flip(mask > 0, [1]).to(torch.int8), dim=1)
        idx = x.shape[1] - 1 - last
        return x[torch.arange(x.shape[0], device=x.device), idx], state


@register_layer("time_distributed_dense")
@dataclasses.dataclass
class TimeDistributedDenseLayer(BaseRecurrentLayer):
    """Dense applied independently at every timestep:
    [b, t, n_in] → [b, t, n_out]."""

    def param_shapes(self, policy=None):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    def init_params(self, gen, policy=None, device="cpu"):
        dt = (policy or _dtypes.FLOAT32).param_dtype
        w = init_weights(gen, (self.n_in, self.n_out),
                         self.weight_init or "XAVIER", fan_in=self.n_in,
                         fan_out=self.n_out, distribution=self.dist,
                         dtype=dt, device=device)
        return {"W": w, "b": _full((self.n_out,), self.bias_init or 0.0, dt,
                                   device)}

    def apply(self, params, x, *, state=None, train=False, generator=None,
              mask=None, policy=None):
        policy = policy or _dtypes.FLOAT32
        x = self._dropout_in(x, train, generator)
        xc, wc = policy.cast_to_compute(x, params["W"])
        z = torch.matmul(xc, wc) + params["b"].to(xc.dtype)
        return self._act()(z), state
