"""Routed, dropless dispatch of a sparse mixture-of-experts layer, for a
chip that holds a contiguous block of the layer's experts.

It replaces no TPU kernel: the JAX package's ``MoELayer`` runs every
expert on every token (the dense dispatch that ``nn/conf/moe.py`` keeps).
Here each token's ``top_k`` assignments are routed over all of the
layer's experts, sorted by expert, and only the assignments to the held
experts are computed, as grouped products over the held experts. Four
steps, each under its own ``util.tracing.phase``:

* ``moe.route`` (:func:`route`): sigmoid scores over every expert from
  f32 router logits, the top ``k`` of scores plus the selection bias, and
  the chosen scores normalised to sum 1 (+1e-6) times the scaling factor;
* ``moe.dispatch`` (:func:`plan`, :func:`gather_rows`): the assignments
  sorted by expert (stably, the absent experts' last), each held expert's
  end row, and the token rows gathered in that order;
* ``moe.experts`` (:func:`grouped_swiglu`): ``W₂(silu(W₁x) ⊙ W₃x)`` for
  each held expert over its rows, as three grouped products;
* ``moe.combine`` (:func:`combine`): each token's rows weighted and summed
  back, one batched ``[1, k] @ [k, d]`` product a token.

Every buffer has a static size, ``tokens × top_k`` rows, whatever the
routing: the rows past the held experts' groups are computed by no
product and read as zero. Nothing reads an expert's count on the host, so
a step never waits for the device here. On the card the grouped products
are PyTorch's ``torch._grouped_mm`` with device-side group ends (no
hand-written kernel of the port's yet), which takes bf16 alone, so the
card runs the layer in a bf16 compute dtype; on the CPU
:func:`grouped_mm_plain` computes the same groups with masks. What bounds
the experts: their products, ``2·d·h`` FLOPs a row and matrix, at ≈ 1,024
rows an expert at 8k tokens; the routing and gathers are passes over
memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..util import tracing as _tracing

NORM_EPS = 1e-6


def grouped_mm_plain(a: torch.Tensor, b: torch.Tensor,
                     ends: torch.Tensor) -> torch.Tensor:
    """``a [R, K] @ b[g] [K, N]`` for the rows of each group ``g``
    (``[ends[g-1], ends[g])``, the first from 0); rows past the last group
    read 0. With a 2-D ``b [R, N]`` it is the per-group ``a[rows]ᵀ @
    b[rows]`` → ``[G, K, N]`` (the weight gradient). Plain PyTorch, one
    masked product a group."""
    rows = torch.arange(a.shape[0], device=a.device)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    if b.ndim == 3:
        out = a.new_zeros(a.shape[0], b.shape[-1])
        for g in range(b.shape[0]):
            inside = ((rows >= starts[g]) & (rows < ends[g]))[:, None]
            out = torch.where(inside, a @ b[g], out)
        return out
    outs = []
    for g in range(ends.shape[0]):
        inside = ((rows >= starts[g]) & (rows < ends[g]))[:, None]
        outs.append(torch.where(inside, a, 0).transpose(0, 1)
                    @ torch.where(inside, b, 0))
    return torch.stack(outs)


def grouped_mm(a: torch.Tensor, b: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_mm_plain`'s product: on the card
    ``torch._grouped_mm`` for bf16 operands (``ends`` int32 on the device;
    the rows past the last group are left as the product leaves them,
    callers mask them), on the CPU the plain version. A 2-D ``b`` gives
    the per-group ``aᵀb``. Other dtypes on the card raise: the plain
    version there would compute every group over every row."""
    if a.device.type != "cuda":
        return grouped_mm_plain(a, b, ends)
    if not a.dtype == b.dtype == torch.bfloat16:
        raise ValueError(
            f"the routed experts' grouped products on the card take bf16 "
            f"operands, not {a.dtype} and {b.dtype}: run the net in a bf16 "
            f"compute dtype (mixed_bf16) there, or on the CPU")
    ends = ends.to(torch.int32)
    if b.ndim == 3:
        return torch._grouped_mm(a, b, offs=ends)
    return torch._grouped_mm(a.transpose(0, 1), b, offs=ends)


# --------------------------------------------------------------------------
# moe.route
# --------------------------------------------------------------------------


class _RouterLogits(torch.autograd.Function):
    """``x @ w`` in at least f32 for compute-dtype ``x``, saving ``x`` as
    it came (not its f32 copy)."""

    @staticmethod
    def forward(ctx, x, w):
        ct = torch.promote_types(x.dtype, w.dtype)
        ctx.save_for_backward(x, w)
        return torch.matmul(x.to(ct), w.to(ct))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        ct = g.dtype
        gx = torch.matmul(g, w.to(ct).transpose(0, 1)).to(x.dtype)
        gw = torch.matmul(x.to(ct).reshape(-1, x.shape[-1]).transpose(0, 1),
                          g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          top_k: int, scaling: float = 1.0):
    """(``chosen [N, k]`` expert ids, ``weights [N, k]``) of the tokens
    ``x [N, d]``: scores ``sigmoid(x·router)`` in at least f32, the top
    ``k`` experts of ``scores + bias`` (the bias steers the choice and
    gets no gradient), their scores normalised to sum 1 (+1e-6) and scaled
    by ``scaling``. The weights carry the router's gradient."""
    scores = torch.sigmoid(_RouterLogits.apply(x, router))
    _, chosen = torch.topk(scores.detach() + bias.to(scores.dtype), top_k,
                           dim=-1)
    weights = scores.gather(-1, chosen)
    weights = weights / (weights.sum(-1, keepdim=True) + NORM_EPS)
    return chosen, weights * scaling


# --------------------------------------------------------------------------
# moe.dispatch
# --------------------------------------------------------------------------


class Plan(NamedTuple):
    """The assignments of one batch sorted by expert: ``order [R]`` the
    flat assignment (``token·k + slot``) of each sorted row, ``inverse
    [R]`` the sorted row of each assignment, ``tokens [R]`` each row's
    token, ``ends [E_held]`` each held expert's end row,
    ``held [R]`` whether the row is an assignment to a held expert (the
    first ``ends[-1]`` rows), ``loads [E_held]`` each held expert's
    assignments. ``R = tokens × k``; all on the device."""

    order: torch.Tensor
    inverse: torch.Tensor
    tokens: torch.Tensor
    ends: torch.Tensor
    held: torch.Tensor
    loads: torch.Tensor


def plan(chosen: torch.Tensor, first: int, n_held: int) -> Plan:
    """Sort the assignments ``chosen [N, k]`` by expert for a chip that
    holds experts ``first … first + n_held − 1``: stably, so that within
    an expert the rows keep token order, with the assignments to experts
    held elsewhere after every group. No host read."""
    k = chosen.shape[-1]
    local = chosen.reshape(-1) - first
    inside = (local >= 0) & (local < n_held)
    key = torch.where(inside, local, torch.full_like(local, n_held))
    key_sorted, order = torch.sort(key, stable=True)
    bounds = torch.arange(1, n_held + 1, device=chosen.device,
                          dtype=key_sorted.dtype)
    ends = torch.searchsorted(key_sorted, bounds)
    loads = torch.diff(ends, prepend=ends.new_zeros(1))
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=order.device)
    return Plan(order, inverse, order // k, ends, key_sorted < n_held,
                loads)


class _GatherRows(torch.autograd.Function):
    """``x[tokens]``, whose backward sums each token's rows in at least
    f32 in a fixed order (no atomics): the rows are gathered back into
    assignment order (``inverse``) and each token's ``k`` are summed."""

    @staticmethod
    def forward(ctx, x, tokens, inverse, k):
        ctx.save_for_backward(inverse)
        ctx.k, ctx.n = k, x.shape[0]
        return x.index_select(0, tokens)

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        slots = g.index_select(0, inverse).view(ctx.n, ctx.k, -1)
        ct = torch.promote_types(g.dtype, torch.float32)
        return slots.sum(1, dtype=ct).to(g.dtype), None, None, None


def gather_rows(x: torch.Tensor, p: Plan, k: int) -> torch.Tensor:
    """The token rows of ``x [N, d]`` in the plan's order, ``[N·k, d]``."""
    return _GatherRows.apply(x, p.tokens, p.inverse, k)


# --------------------------------------------------------------------------
# moe.experts
# --------------------------------------------------------------------------


def swiglu_from(h: torch.Tensor) -> torch.Tensor:
    """``silu(h₁) ⊙ h₃`` of ``h = [h₁ | h₃]``, in ``h``'s dtype (each op's
    arithmetic in at least f32, its result rounded once)."""
    h1, h3 = h.chunk(2, dim=-1)
    return F.silu(h1) * h3


def swiglu_grad(h: torch.Tensor, ga: torch.Tensor) -> torch.Tensor:
    """The gradient with respect to ``h = [h₁ | h₃]`` of
    :func:`swiglu_from` for the output gradient ``ga``, in ``h``'s dtype,
    written into one ``[.., 2h]`` buffer: ``ga ⊙ silu(h₁)`` for ``h₃`` and
    ``silu'(h₁) ⊙ ga ⊙ h₃`` (ATen's fused ``silu_backward``) for ``h₁``."""
    h1, h3 = h.chunk(2, dim=-1)
    n = h1.shape[-1]
    gh = torch.empty_like(h)
    torch.mul(ga, F.silu(h1), out=gh[..., n:])
    torch.ops.aten.silu_backward.grad_input(ga * h3, h1,
                                            grad_input=gh[..., :n])
    return gh


class SwiGLU(torch.autograd.Function):
    """:func:`swiglu_from` saving ``h`` alone (the product's gradient is
    formed again from it)."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return swiglu_from(h)

    @staticmethod
    def backward(ctx, ga):
        (h,) = ctx.saved_tensors
        return swiglu_grad(h, ga)


class _GroupedSwiGLU(torch.autograd.Function):
    """Each held expert's SwiGLU over its rows: ``h = xs @ W13[g]``, ``y =
    swiglu(h) @ W2[g]`` by group, rows past the groups read 0 (and pass
    back 0). Saves ``xs`` and ``h``."""

    @staticmethod
    def forward(ctx, xs, w13, w2, ends, held):
        h = grouped_mm(xs, w13, ends)
        y = grouped_mm(swiglu_from(h), w2, ends)
        y = y.masked_fill(~held[:, None], 0)
        ctx.save_for_backward(xs, h, w13, w2, ends, held)
        return y

    @staticmethod
    def backward(ctx, gy):
        xs, h, w13, w2, ends, held = ctx.saved_tensors
        gy = gy.contiguous()
        ga = grouped_mm(gy, w2.transpose(1, 2), ends)
        # rows past the groups hold whatever the products left there; no
        # grouped product reads them, and their dx is masked below
        gh = swiglu_grad(h, ga)
        gw2 = grouped_mm(swiglu_from(h), gy, ends)
        gw13 = grouped_mm(xs, gh, ends)
        gxs = grouped_mm(gh, w13.transpose(1, 2), ends)
        return (gxs.masked_fill(~held[:, None], 0), gw13, gw2, None, None)


def grouped_swiglu(xs: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
                   p: Plan) -> torch.Tensor:
    """The held experts' SwiGLU outputs ``[R, d]`` of the sorted rows
    ``xs``: ``w13 [E_held, d, 2h]`` (W₁ and W₃ side by side), ``w2
    [E_held, h, d]``, all in one dtype."""
    return _GroupedSwiGLU.apply(xs, w13, w2, p.ends, p.held)


# --------------------------------------------------------------------------
# moe.combine
# --------------------------------------------------------------------------


class _Combine(torch.autograd.Function):
    """``out[n] = Σ_j w[n, j] · y[inverse[n·k + j]]`` as one batched
    product a token (``[1, k] @ [k, d]``, summed in f32 by the product,
    rounded once), saving the rows in assignment order and the weights in
    ``y``'s dtype."""

    @staticmethod
    def forward(ctx, y, weights, order, inverse):
        n, k = weights.shape
        y_slots = y.index_select(0, inverse).view(n, k, -1)
        w = weights.to(y.dtype)
        ctx.save_for_backward(y_slots, w, order)
        ctx.w_dtype = weights.dtype
        return torch.bmm(w[:, None, :], y_slots)[:, 0]

    @staticmethod
    def backward(ctx, g):
        y_slots, w, order = ctx.saved_tensors
        n, k, d = y_slots.shape
        g = g.contiguous()
        gw = torch.bmm(y_slots, g[:, :, None])[..., 0]
        gy = torch.bmm(w[:, :, None], g[:, None, :]).view(n * k, d)
        return (gy.index_select(0, order), gw.to(ctx.w_dtype), None, None)


def combine(y: torch.Tensor, weights: torch.Tensor, p: Plan) -> torch.Tensor:
    """``out[n] = Σ_j weights[n, j] · y[row of (n, j)]``, ``[N, d]`` in
    ``y``'s dtype; assignments to experts held elsewhere add nothing
    (their rows of ``y`` are 0)."""
    return _Combine.apply(y, weights, p.order, p.inverse)


def sparse_moe(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
               w13: torch.Tensor, w2: torch.Tensor, *, top_k: int, first: int,
               scaling: float = 1.0):
    """The held experts' part of the layer's output for tokens ``x [N,
    d]`` (compute dtype), and the plan (its ``loads`` and ``ends`` count
    the work): the four phases in order. ``w13 [E_held, d, 2h]`` (W₁ and
    W₃ side by side) and ``w2 [E_held, h, d]`` are cast to ``x``'s dtype
    inside ``moe.experts``; ``router [d, E]`` and ``bias [E]`` span every
    expert."""
    with _tracing.phase("moe.route"):
        chosen, weights = route(x, router, bias, top_k, scaling)
    with _tracing.phase("moe.dispatch"):
        p = plan(chosen, first, w13.shape[0])
        xs = gather_rows(x, p, top_k)
    with _tracing.phase("moe.experts"):
        y = grouped_swiglu(xs, w13.to(x.dtype), w2.to(x.dtype), p)
    with _tracing.phase("moe.combine"):
        out = combine(y, weights, p)
    return out, p
