"""The arithmetic of the f32 flash backward kernels (3xTF32), on the CPU.

The card's f32 dq and dk/dv kernels (``ops/csrc/flash_bwd_f32.cu``) split
every f32 operand x into hi = tf32(x) and lo = tf32(x − hi), rounded to
nearest with ties away from zero (``cvt.rna.tf32.f32``), and take each
product A·B as lo(A)·hi(B) + hi(A)·lo(B) + hi(A)·hi(B) on the tensor
cores: the tf32 products are exact in f32 and the sums are f32. These tests
model that scheme with its own TF32 rounding on ``x.view(torch.int32)``
and hold it to a float64 backward; they check the port's split
(``tf32_split``) and its scratch layout (``flash_bwd_split_plain``), the
plain version the pre-pass kernel is held to on the card.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as tfa

# f32 gradient tolerance of the kernels against the plain backward on the
# card (chip_smoke.TOL_GRAD_F32)
TOL_GRAD_F32 = 1e-4
# The 3xTF32 backward against the float64 one may err at most this many
# times the plain f32 backward's own error (observed: 0.81-1.43 of it) plus
# 2^-24 of the gradient's largest magnitude
FACTOR = 2.0


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest tf32 value, ties away from zero: add half
    of the 13 dropped mantissa bits to the magnitude, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 4096) & ~8191).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x.float() - hi)


def product(a, b, mode):
    """a @ b in f32 as the kernels take it: "3xtf32" (lo·hi + hi·lo, then
    hi·hi), "tf32" (hi·hi only) or "f32" (plain f32). tf32 products are
    exact in f32, so each f32 matmul of two splits sums exact products."""
    if mode == "f32":
        return a.float() @ b.float()
    (ah, al), (bh, bl) = split(a), split(b)
    if mode == "tf32":
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def backward(q, k, v, dout, out, lse, causal, mode, dtype=torch.float32):
    """(dq, dk, dv) [b, h, t, d] of dense attention from the forward's out
    and lse: its five products (S, dP, dS·K, dSᵀ·Q, Pᵀ·dO) by ``mode``, or
    everything in float64 (``dtype``)."""
    t, d = q.shape[-2:]
    scale = d ** -0.5
    q, k, v, dout, out, lse = (x.to(dtype) for x in (q, k, v, dout, out, lse))

    def mm(a, b):
        return a @ b if dtype == torch.float64 else product(a, b, mode)
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), 0.0)
    dp = mm(dout, v.transpose(-1, -2))
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), dout))


def _case(t, d, causal, seed=0):
    """Seeded q, k, v, dout [1, 2, t, d] and the float64 forward's out and
    lse (rounded to f32, the inputs every variant shares)."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, 2, t, d))
                                      .astype(np.float32)) for _ in range(4))
    s = (q.double() @ k.double().transpose(-1, -2)) * d ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1),
                          float("-inf"))
    lse = torch.logsumexp(s, -1)
    out = torch.softmax(s, -1) @ v.double()
    return q, k, v, dout, out.float(), lse.float()


def _errors(grads, ref):
    return [(g.double() - r).abs().max().item() for g, r in zip(grads, ref)]


def _btd(x):
    return x.transpose(1, 2)


def _plain(q, k, v, dout, out, lse, causal):
    """The port's plain f32 backward (the kernels' yardstick on the card)
    on the same inputs, as [b, h, t, d]."""
    grads = tfa.flash_attention_bwd_plain(
        _btd(q), _btd(k), _btd(v), None, _btd(out), lse, _btd(dout),
        causal=causal)
    return [_btd(g) for g in grads]


def test_rna_tf32_matches_an_independent_model():
    """The port's split, the test's model and a numpy one on uint32 bits
    agree, ties included (1 + 2^-11 rounds up, away from zero)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32),
                        np.float32([1 + 2 ** -11, -(1 + 2 ** -11),
                                    1 + 3 * 2 ** -11, 1 - 2 ** -12, 0.0])])
    u = x.view(np.uint32).astype(np.int64)
    want = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    hi, lo = tfa.tf32_split(torch.from_numpy(x))
    assert np.array_equal(hi.numpy(), want)
    assert torch.equal(hi, rna_tf32(torch.from_numpy(x)))
    assert torch.equal(lo, rna_tf32(torch.from_numpy(x) - hi))
    assert hi[-5].item() == 1 + 2 ** -10 and hi[-4].item() == -(1 + 2 ** -10)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 8191).any()
    # hi + lo is x to within 2^-22 of |x|
    err = (hi.double() + lo.double() - torch.from_numpy(x).double()).abs()
    assert (err <= 2.0 ** -22 * torch.from_numpy(x).double().abs()).all()


def test_split_plain_layout():
    """The scratch ``[7, 2, b·h, t·d]``: hi and lo of q, k, v, dO row by row,
    then of q, k, dO transposed with t permuted within each group of 8."""
    b, t, h, d = 2, 32, 3, 64
    rng = np.random.default_rng(2)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((b, t, h, d))
                                      .astype(np.float32)) for _ in range(4))
    got = tfa.flash_bwd_split_plain(q, k, v, dout)
    assert got.shape == (tfa.SPLIT_TENSORS, 2, b * h, t * d)
    rows = [x.permute(0, 2, 1, 3).reshape(b * h, t, d)
            for x in (q, k, v, dout)]
    for i, x in enumerate(rows):
        hi, lo = split(x)
        assert torch.equal(got[i, 0].view(b * h, t, d), hi)
        assert torch.equal(got[i, 1].view(b * h, t, d), lo)
    perm = [8 * (u // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[u % 8] for u in range(t)]
    for i, x in zip((4, 5, 6), (rows[0], rows[1], rows[3])):
        hi, lo = split(x)
        assert torch.equal(got[i, 0].view(b * h, d, t),
                           hi[:, perm].transpose(1, 2))
        assert torch.equal(got[i, 1].view(b * h, d, t),
                           lo[:, perm].transpose(1, 2))


def test_fragment_permutation_pairs_the_same_terms():
    """The kernels pass an accumulator's values to the tf32 A fragment as
    they lie: k slot p of a group of 8 gets column 2p (p < 4) or 2(p − 4) + 1.
    With the transposed plane's rows permuted the same way, the product is
    the plain one."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((16, 32)))    # [m, keys]
    bm = torch.from_numpy(rng.standard_normal((32, 8)))    # [keys, n]
    slot_col = [8 * (u // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[u % 8]
                for u in range(32)]
    a_frag = a[:, slot_col]           # what the fragment's k slots hold
    b_plane = bm[slot_col]            # the permuted transposed plane
    assert torch.allclose(a_frag @ b_plane, a @ bm, rtol=0, atol=1e-12)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_backward_is_as_close_as_f32(d, causal):
    """The 3xTF32 backward's dq, dk, dv against float64: within FACTOR times
    the port's plain f32 backward's own error (plus 2^-24 of max|g|), and
    inside the kernels' TOL_GRAD_F32."""
    case = _case(256, d, causal)
    ref = backward(*case, causal, None, torch.float64)
    e3 = _errors(backward(*case, causal, "3xtf32"), ref)
    e32 = _errors(_plain(*case, causal), ref)
    for name, a, b, r in zip(("dq", "dk", "dv"), e3, e32, ref):
        assert a <= FACTOR * b + 2.0 ** -24 * r.abs().max().item(), \
            (name, a, b)
        assert a <= TOL_GRAD_F32, (name, a)


def test_plain_tf32_fails_the_same_bound():
    """hi·hi alone (plain TF32, about 3 decimal digits) is far outside the
    bound the 3xTF32 scheme meets: the test can tell them apart."""
    case = _case(256, 64, True)
    ref = backward(*case, True, None, torch.float64)
    e1 = _errors(backward(*case, True, "tf32"), ref)
    e32 = _errors(_plain(*case, True), ref)
    assert all(a > TOL_GRAD_F32 for a in e1), e1
    assert all(a > 100 * FACTOR * b for a, b in zip(e1, e32)), (e1, e32)


def test_plain_backward_agrees_with_the_dense_f32_model():
    """The port's plain backward (what the kernels are held to on the card)
    and the dense f32 model here are two f32 computations of the same
    gradients: they agree within f32 noise."""
    case = _case(256, 64, True)
    dense = backward(*case, True, "f32")
    for a, b in zip(_plain(*case, True), dense):
        assert (a - b).abs().max().item() <= 1e-5
