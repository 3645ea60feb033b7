"""Plain PyTorch updates of the references: Adam (Kingma and Ba, bias
corrected, ε added after the square root) and Sutskever-style Nesterov
momentum (v ← μv − ηg, p ← p + μv − ηg), on float32 trees
``{vertex: {name: tensor}}``."""

from __future__ import annotations

import torch


def zeros_like_tree(tree):
    return {v: {k: torch.zeros_like(p) for k, p in ps.items()}
            for v, ps in tree.items()}


class Adam:
    def __init__(self, lr, beta1=0.9, beta2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps

    def init(self, params):
        return {"m": zeros_like_tree(params), "v": zeros_like_tree(params),
                "t": 0}

    @torch.no_grad()
    def step(self, params, grads, state):
        state["t"] += 1
        t = state["t"]
        bc1, bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        for v, ps in params.items():
            for k, p in ps.items():
                g = grads[v][k]
                m = state["m"][v][k].mul_(self.b1).add_(g, alpha=1 - self.b1)
                s = state["v"][v][k].mul_(self.b2).addcmul_(
                    g, g, value=1 - self.b2)
                p.sub_(self.lr * (m / bc1) / (torch.sqrt(s / bc2) + self.eps))


class Nesterov:
    def __init__(self, lr, momentum=0.9):
        self.lr, self.mu = lr, momentum

    def init(self, params):
        return {"v": zeros_like_tree(params)}

    @torch.no_grad()
    def step(self, params, grads, state):
        for v, ps in params.items():
            for k, p in ps.items():
                g = grads[v][k]
                vel = state["v"][v][k].mul_(self.mu).sub_(g, alpha=self.lr)
                p.add_(self.mu * vel - self.lr * g)


def make(training: dict):
    """The update that a configuration's ``training`` block names."""
    name = training["updater"]
    if name == "adam":
        return Adam(training["learning_rate"], training.get("beta1", 0.9),
                    training.get("beta2", 0.999), training.get("eps", 1e-8))
    if name == "nesterovs":
        return Nesterov(training["learning_rate"], training["momentum"])
    raise ValueError(f"no reference update for {name!r}")
