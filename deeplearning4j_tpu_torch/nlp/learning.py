"""Embedding learning steps: SkipGram / CBOW × negative sampling /
hierarchical softmax (counterpart of the JAX package's
``nlp/learning.py``).

Parity: reference ``models/embeddings/learning/impl/elements/SkipGram.java:216``
(``iterateSample`` — per-word HS dot/gradient loop + negative sampling) and
``CBOW.java``.

One SGD step per index batch, the reference's arithmetic: the loss is the
SUM over pairs (each pair takes a full lr-sized step; colliding rows
accumulate, the batched analog of word2vec's sequential updates), and the
update is the dense ``p - lr·g`` XLA applies after differentiating the
gathers.

Gradients are explicit, not autograd: each step gathers rows with
``index_select``, computes the sigmoid-dot losses and their derivatives in
closed form, and sums the row gradients into dense zero tables in a fixed
order (:func:`_accumulate`), so a step is repeatable bit for bit on either
device. Autograd's backward of a gather is ``index_add_``, which sums
colliding rows with float atomics on the card (a different order, and
different low bits, from run to run). Explicit gradients also skip
autograd's graph and the dense gradient of every intermediate. Untouched
rows get ``g = 0``, so ``p - lr·0`` leaves them as they were: the dense
update and one restricted to the touched rows give the same bits.

Parameters are updated in place (the reference donates them) and every
step returns ``(params, mean loss)`` as device tensors, with no host read.
The unigram^0.75 negative table and the window/subsampling logic stay on
the host (numpy) in sequence_vectors.py.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import resolve_device


def params_from_numpy(params: Dict[str, np.ndarray], device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """The port's tables from numpy arrays (the reference's ``syn0`` /
    ``syn1neg`` / ``syn1`` carried across as ``np.asarray`` of its
    parameters): f32 copies on ``device``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in params.items()}


def init_params(vocab_size: int, dim: int, seed: int = 42,
                hs_nodes: int = 0, use_neg: bool = True,
                extra_vectors: int = 0, device="cuda"
                ) -> Dict[str, torch.Tensor]:
    """syn0 ~ U(-0.5/dim, 0.5/dim) (word2vec convention); output tables zero.

    Drawn with numpy from ``seed`` exactly as the reference draws them, so
    both packages start from the same bits. extra_vectors: additional rows
    in syn0 beyond the vocab (ParagraphVectors doc vectors live there).
    """
    rng = np.random.default_rng(seed)
    rows = vocab_size + extra_vectors
    params = {"syn0": (rng.random((rows, dim), dtype=np.float32) - 0.5) / dim}
    if use_neg:
        params["syn1neg"] = np.zeros((vocab_size, dim), np.float32)
    if hs_nodes > 0:
        params["syn1"] = np.zeros((hs_nodes, dim), np.float32)
    return params_from_numpy(params, device)


def to_device(arrays: Sequence[np.ndarray], device) -> list:
    """Host index/mask batches onto ``device``: on a card through pinned
    memory with ``non_blocking`` copies (the host goes on preparing the
    next batch; the caching host allocator keeps each pinned buffer until
    its copy has run), on the CPU as views of the arrays."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            .to(dev, non_blocking=True) for a in arrays]


# ----------------------------------------------------------------------
# gathers, scatters and the update
# ----------------------------------------------------------------------


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an index tensor of any shape: [*idx, *row]."""
    return table.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *table.shape[1:])


def _accumulate(grad: torch.Tensor, idx: torch.Tensor,
                rows: torch.Tensor) -> None:
    """grad[idx] += rows, colliding indices summed in a fixed order. On the
    card ``index_put_(accumulate=True)`` sorts the indices and sums each
    index's run serially (``index_add_`` there adds with float atomics); on
    the CPU ``index_add_`` adds in index order (``index_put_`` there adds
    from several threads with atomics)."""
    flat = idx.reshape(-1)
    rows = rows.reshape(flat.shape[0], *grad.shape[1:])
    if grad.is_cuda:
        grad.index_put_((flat,), rows, accumulate=True)
    else:
        grad.index_add_(0, flat, rows)


def _spread_masked(idx: torch.Tensor, mask: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """``idx`` with its masked slots sent to distinct rows (slot i to row
    i mod ``rows``). A masked slot scatters an exact zero, so where it
    lands changes no sum; left on its padding id (0), every padded slot of
    the batch would join one run, which the card's sorted scatter sums
    serially."""
    spread = torch.arange(idx.numel(), device=idx.device).reshape(
        idx.shape) % rows
    return torch.where(mask > 0, idx, spread)


def _lr(lr):
    """The reference's ``jnp.float32(lr)``: the rate in f32 (a number
    rounded on the host, a tensor cast where it lies, with no host read)."""
    if torch.is_tensor(lr):
        return lr.to(torch.float32)
    return float(np.float32(lr))


def _apply(params: Dict[str, torch.Tensor],
           grads: Dict[str, torch.Tensor], lr) -> None:
    """``p - lr·g`` in place for every table with a gradient."""
    for k, g in grads.items():
        params[k].sub_(g.mul_(lr))


# ----------------------------------------------------------------------
# loss terms and their gradients (shared by skip-gram and CBOW: they
# differ only in how the input vector v is formed)
# ----------------------------------------------------------------------


def _input_vector(syn0, center, ctx, ctx_mask, cbow):
    """skip-gram: v = syn0[center]; cbow: v = masked mean of syn0[ctx]
    (divided by max(Σm, 1)). Returns v and what its gradient needs."""
    if cbow:
        vecs = _rows(syn0, ctx)                                  # [B,W,D]
        m = ctx_mask.to(syn0.dtype)[..., None]
        den = torch.clamp(m.sum(dim=1), min=1.0)                 # [B,1]
        return (vecs * m).sum(dim=1) / den, (m, den)
    return _rows(syn0, center), None


def _input_grad(g0, center, ctx, gv, aux) -> None:
    """Scatter the input vector's gradient gv [B,D] back into syn0's."""
    if aux is None:
        _accumulate(g0, center, gv)
    else:
        m, den = aux
        _accumulate(g0, _spread_masked(ctx, m[..., 0], g0.shape[0]),
                    (gv / den)[:, None, :] * m)


def _ns_terms(syn1neg, v, target, negs):
    """Negative-sampling loss (sum over the batch) of input vectors v [B,D]
    against target ids [B] and negatives [B,K]; gv and syn1neg's grad."""
    target, negs = target.long(), negs.long()
    u_pos = _rows(syn1neg, target)                               # [B,D]
    u_neg = _rows(syn1neg, negs)                                 # [B,K,D]
    s_pos = (v * u_pos).sum(dim=-1)
    s_neg = torch.einsum("bd,bkd->bk", v, u_neg)
    loss = -(F.logsigmoid(s_pos).sum() + F.logsigmoid(-s_neg).sum())
    d_pos = -torch.sigmoid(-s_pos)            # d loss / d s_pos
    d_neg = torch.sigmoid(s_neg)              # d loss / d s_neg
    gv = d_pos[:, None] * u_pos + torch.einsum("bk,bkd->bd", d_neg, u_neg)
    g1 = torch.zeros_like(syn1neg)
    _accumulate(g1, target, d_pos[:, None] * v)
    _accumulate(g1, negs, d_neg[..., None] * v[:, None, :])
    return loss, gv, g1


def _hs_terms(syn1, v, codes, points, code_mask):
    """Hierarchical-softmax loss: codes/points/mask [B,L] (padded)."""
    points = points.long()
    u = _rows(syn1, points)                                      # [B,L,D]
    dots = torch.einsum("bd,bld->bl", v, u)
    # code 0 → predict sigmoid→1, code 1 → 0 (word2vec convention)
    sign = 1.0 - 2.0 * codes.to(v.dtype)
    z = sign * dots
    mask = code_mask.to(v.dtype)
    loss = -(F.logsigmoid(z) * mask).sum()
    d = -torch.sigmoid(-z) * mask * sign      # d loss / d dots
    gv = torch.einsum("bl,bld->bd", d, u)
    g1 = torch.zeros_like(syn1)
    _accumulate(g1, _spread_masked(points, mask, g1.shape[0]),
                d[..., None] * v[:, None, :])
    return loss, gv, g1


def _loss_grads(params, out, terms, center, ctx, ctx_mask, cbow, *targets):
    """Summed loss and the dense gradients of syn0 and the output table
    ``out`` (``terms``: :func:`_ns_terms` or :func:`_hs_terms` over
    ``targets``)."""
    syn0 = params["syn0"]
    center = center.long()
    ctx = ctx.long() if cbow else ctx
    v, aux = _input_vector(syn0, center, ctx, ctx_mask, cbow)
    loss, gv, g_out = terms(params[out], v, *targets)
    g0 = torch.zeros_like(syn0)
    _input_grad(g0, center, ctx, gv, aux)
    return loss, {"syn0": g0, out: g_out}


# ----------------------------------------------------------------------
# the steps
# ----------------------------------------------------------------------


@torch.no_grad()
def ns_step(params, center, target, negs, ctx, ctx_mask, lr, *, cbow=False):
    """One SGD step, negative sampling.

    skip-gram: v = syn0[center];  cbow: v = masked mean of syn0[ctx].
    center/target [B], negs [B,K], ctx [B,W], ctx_mask [B,W] (tensors on
    the parameters' device). Returns (params, mean loss).
    """
    loss, grads = _loss_grads(params, "syn1neg", _ns_terms, center, ctx,
                              ctx_mask, cbow, target, negs)
    _apply(params, grads, _lr(lr))
    return params, loss / center.shape[0]


@torch.no_grad()
def hs_step(params, center, codes, points, code_mask, ctx, ctx_mask, lr, *,
            cbow=False):
    """One SGD step, hierarchical softmax. codes/points/mask [B,L]."""
    loss, grads = _loss_grads(params, "syn1", _hs_terms, center, ctx,
                              ctx_mask, cbow, codes, points, code_mask)
    _apply(params, grads, _lr(lr))
    return params, loss / center.shape[0]


@torch.no_grad()
def ns_step_scan(params, centers, targets, negss, ctxs, ctx_masks, lr, *,
                 cbow=False):
    """K negative-sampling SGD steps with no host read between them.

    centers/targets [K,B], negss [K,B,N]; cbow adds ctxs/ctx_masks [K,B,W].
    The reference fuses the K steps into one dispatch with ``lax.scan``;
    here the host issues the K steps back to back onto the device's queue
    (the same update semantics as calling :func:`ns_step` K times). Returns
    (params, [K] mean losses).
    """
    k, b = centers.shape
    if ctxs is None:
        ctxs = torch.zeros((k, b, 1), dtype=torch.int32,
                           device=centers.device)
        ctx_masks = torch.zeros((k, b, 1), dtype=torch.float32,
                                device=centers.device)
    losses = []
    for i in range(k):
        params, loss = ns_step(params, centers[i], targets[i], negss[i],
                               ctxs[i], ctx_masks[i], lr, cbow=cbow)
        losses.append(loss)
    return params, torch.stack(losses)


def make_sharded_ns_step(mesh, *, cbow: bool = False, axis: str = "data"):
    """Data-parallel negative-sampling step over a device mesh.

    Parity: the reference's distributed embedding training is Spark
    word2vec (``dl4j-spark-nlp/.../word2vec/Word2Vec.java`` — partitions
    train replicas whose tables are then averaged). As in the JAX
    package, the PAIR BATCH is split over the mesh's ``axis`` and the
    tables stay replicated. One process per device: every rank is handed
    the GLOBAL batch and keeps its block; its summed loss and gradients
    over that block are summed over the ``axis`` group (one flat
    all-reduce), so each rank applies the global batch's update —
    per-step exact synchronization, the same as the single-process step
    up to the order of the sums.

    Returns ``step(params, center, target, negs, ctx, ctx_mask, lr) ->
    (params, global mean loss)``; the batch length must divide by the
    ``axis`` size.
    """
    from ..parallel import collectives, mesh as _mesh

    group = _mesh.axis_group(mesh, axis)
    n = _mesh.axis_size(mesh, axis)

    @torch.no_grad()
    def step(params, center, target, negs, ctx, ctx_mask, lr):
        b = center.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by the {n}-rank "
                             f"{axis!r} mesh dim")
        block = [collectives.local_slice(t, group, 0)
                 for t in (center, target, negs, ctx, ctx_mask)]
        center_, target_, negs_, ctx_, mask_ = block
        loss, grads = _loss_grads(params, "syn1neg", _ns_terms, center_,
                                  ctx_, mask_, cbow, target_, negs_)
        collectives.all_reduce_tree([loss, grads], [group])
        _apply(params, grads, _lr(lr))
        return params, loss / b

    return step


def build_unigram_table(counts: np.ndarray, power: float = 0.75,
                        table_size: int = 1 << 20) -> np.ndarray:
    """word2vec's unigram^0.75 negative-sampling table (parity: the
    ``table`` in the reference's SkipGram negative sampling)."""
    probs = counts.astype(np.float64) ** power
    probs /= probs.sum()
    return np.searchsorted(np.cumsum(probs),
                           (np.arange(table_size) + 0.5) / table_size
                           ).astype(np.int32)
