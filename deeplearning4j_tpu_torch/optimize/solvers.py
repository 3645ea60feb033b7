"""Full-batch optimizers: L-BFGS, conjugate gradient, line gradient
descent (counterpart of the JAX package's ``optimize/solvers.py``;
parity: reference ``optimize/Solver.java``, ``solvers/LBFGS.java``,
``ConjugateGradient.java``, ``LineGradientDescent.java``,
``BackTrackLineSearch.java``).

These are deterministic optimizers over the network's FLAT parameter
vector: every parameter tensor, in the params dict's order (vertex or
layer, then parameter), concatenated. Loss and gradient are one forward
(and one autograd backward) of the network's ``_loss_fn`` at the
parameters the vector spells, without dropout draws. The minibatch path
(``sgd``) is the network's own ``fit_batch``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch


class BackTrackLineSearch:
    """Armijo backtracking (parity: ``BackTrackLineSearch.java`` — step
    halving until sufficient decrease, maxIterations bounded)."""

    def __init__(self, c1: float = 1e-4, shrink: float = 0.5,
                 max_iterations: int = 5):
        self.c1 = float(c1)
        self.shrink = float(shrink)
        self.max_iterations = int(max_iterations)

    def search(self, f: Callable[[torch.Tensor], float], x: torch.Tensor,
               fx: float, g: torch.Tensor, direction: torch.Tensor,
               initial_step: float = 1.0) -> Tuple[float, float]:
        """Returns (step, f(x + step*direction))."""
        slope = float(torch.dot(g, direction))
        step = initial_step
        best_step, best_val = 0.0, fx
        for _ in range(self.max_iterations):
            val = float(f(x + step * direction))
            if val <= fx + self.c1 * step * slope:
                return step, val
            if val < best_val:
                best_step, best_val = step, val
            step *= self.shrink
        return best_step, best_val


class _Flat:
    """The params dict as one vector and back, in the dict's order."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]]):
        self.keys = [(v, k) for v, ps in params.items() for k in ps]
        self.shapes = [tuple(params[v][k].shape) for v, k in self.keys]
        self.sizes = [params[v][k].numel() for v, k in self.keys]

    def ravel(self, tree) -> torch.Tensor:
        return torch.cat([tree[v][k].reshape(-1) for v, k in self.keys])

    def unravel(self, vec: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for (v, k), shape, part in zip(self.keys, self.shapes,
                                       torch.split(vec, self.sizes)):
            out.setdefault(v, {})[k] = part.reshape(shape)
        return out


class Solver:
    """Full-batch solver over a network and one batch (parity:
    ``Solver.java``)::

        Solver(net).optimize(x, y, iterations=50)   # algorithm from conf

    The algorithm comes from ``conf.training.optimization_algo``:
    ``"lbfgs" | "conjugate_gradient" | "line_gradient_descent"``
    (``"sgd"`` hands off to the network's own ``fit_batch``).
    """

    def __init__(self, net, algo: Optional[str] = None,
                 memory: int = 10,
                 line_search: Optional[BackTrackLineSearch] = None):
        self.net = net
        self.algo = (algo or net.training.optimization_algo or "sgd").lower()
        self.memory = int(memory)
        self.line_search = line_search or BackTrackLineSearch(
            max_iterations=getattr(net.training,
                                   "max_line_search_iterations", 5))

    def _flat_loss(self, x, y, mask=None):
        net = self.net
        flat = _Flat(net._require_params())
        graph = hasattr(net.conf, "vertices")

        def loss_tree(params):
            if graph:
                return net._loss_fn([x], [y], None if mask is None
                                    else [mask], params=params)
            return net._loss_fn(x, y, mask, params=params)[0]

        def f(vec):
            with torch.no_grad():
                return loss_tree(flat.unravel(vec))

        def g(vec):
            v = vec.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = loss_tree(flat.unravel(v))
                return torch.autograd.grad(loss, v)[0]

        with torch.no_grad():
            flat0 = flat.ravel(net.params).detach().clone()
        return flat0, flat, f, g

    def optimize(self, x, y, mask=None, iterations: Optional[int] = None,
                 tolerance: float = 1e-8) -> float:
        net = self.net
        iters = iterations or net.training.iterations or 10
        if self.algo in ("sgd", "stochastic_gradient_descent"):
            loss = None
            for _ in range(iters):
                loss = net.fit_batch(x, y, mask)
            return float(loss)
        x = net._to_input(x)
        y = net._to_input(y)
        mask = None if mask is None else net._to_input(mask)
        flat0, flat, f, g = self._flat_loss(x, y, mask)
        if self.algo == "lbfgs":
            final, score = self._lbfgs(flat0, f, g, iters, tolerance)
        elif self.algo in ("cg", "conjugate_gradient"):
            final, score = self._cg(flat0, f, g, iters, tolerance)
        elif self.algo in ("line_gradient_descent", "linegd"):
            final, score = self._line_gd(flat0, f, g, iters, tolerance)
        else:
            raise ValueError(f"unknown optimization algorithm {self.algo!r}")
        with torch.no_grad():
            for (v, k), t in zip(flat.keys,
                                 (p for ps in flat.unravel(final).values()
                                  for p in ps.values())):
                net.params[v][k].copy_(t)
        net._score = torch.tensor(score)
        return float(score)

    # ---- algorithms ----

    def _line_gd(self, x0, f, g, iters, tol):
        x = x0
        fx = float(f(x))
        for _ in range(iters):
            grad = g(x)
            step, fnew = self.line_search.search(f, x, fx, grad, -grad,
                                                 initial_step=1.0)
            if step == 0.0 or abs(fx - fnew) < tol:
                break
            x = x - step * grad
            fx = fnew
        return x, fx

    def _cg(self, x0, f, g, iters, tol):
        """Polak-Ribière nonlinear CG with restart (parity:
        ``ConjugateGradient.java``)."""
        x = x0
        fx = float(f(x))
        grad = g(x)
        direction = -grad
        for _ in range(iters):
            step, fnew = self.line_search.search(f, x, fx, grad, direction,
                                                 initial_step=1.0)
            if step == 0.0 or abs(fx - fnew) < tol:
                break
            x = x + step * direction
            new_grad = g(x)
            beta = float(torch.dot(new_grad, new_grad - grad)
                         / torch.clamp(torch.dot(grad, grad), min=1e-30))
            beta = max(0.0, beta)  # PR+ restart
            direction = -new_grad + beta * direction
            if float(torch.dot(direction, new_grad)) > 0:  # not a descent dir
                direction = -new_grad
            grad, fx = new_grad, fnew
        return x, fx

    def _lbfgs(self, x0, f, g, iters, tol):
        """Two-loop-recursion L-BFGS (parity: ``LBFGS.java``, memory m)."""
        m = self.memory
        x = x0
        fx = float(f(x))
        grad = g(x)
        s_hist: List[torch.Tensor] = []
        y_hist: List[torch.Tensor] = []
        for _ in range(iters):
            q = grad
            alphas = []
            for s, yv in zip(reversed(s_hist), reversed(y_hist)):
                rho = 1.0 / float(torch.clamp(torch.dot(yv, s), min=1e-30))
                a = rho * float(torch.dot(s, q))
                alphas.append((a, rho, s, yv))
                q = q - a * yv
            if y_hist:
                s_last, y_last = s_hist[-1], y_hist[-1]
                gamma = float(torch.dot(s_last, y_last)
                              / torch.clamp(torch.dot(y_last, y_last),
                                            min=1e-30))
                q = gamma * q
            for a, rho, s, yv in reversed(alphas):
                b = rho * float(torch.dot(yv, q))
                q = q + (a - b) * s
            direction = -q
            step, fnew = self.line_search.search(f, x, fx, grad, direction,
                                                 initial_step=1.0)
            if step == 0.0 or abs(fx - fnew) < tol:
                break
            x_new = x + step * direction
            new_grad = g(x_new)
            s_hist.append(x_new - x)
            y_hist.append(new_grad - grad)
            if len(s_hist) > m:
                s_hist.pop(0)
                y_hist.pop(0)
            x, grad, fx = x_new, new_grad, fnew
        return x, fx
