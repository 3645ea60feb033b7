"""The f32 flash forward (3xTF32) and the auto route, on the CPU and the card.

The card's f32 forward (``ops/csrc/flash_fwd_f32.cu``) takes S = Q·Kᵀ and
P·V in 3xTF32: every f32 operand x is split into hi = tf32(x) and
lo = tf32(x − hi) (round to nearest, ties away from zero), and each product
A·B is lo(A)·hi(B) + hi(A)·lo(B) + hi(A)·hi(B) on the tensor cores, whose
tf32 products are exact in f32. Its pre-pass writes the hi/lo planes of q
and k row by row and of v transposed, t permuted within groups of 8 so
that P goes from S's accumulator to the register operand of P·V as it
lies. These tests model that arithmetic with the TF32 rounding of
``tests/test_torch_tf32_backward.py``, blockwise as the kernel runs it,
and hold it to a float64 forward and to the JAX package's Pallas forward
(interpret mode); they check the pre-pass's plain layout
(``flash_fwd_split_plain``), and the auto route's rule (``kernels_take``,
``flash_available``, ``ring_flash_available``) without a card.

The tests marked ``cuda`` need a card and no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_tf32_forward.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

from test_torch_tf32_backward import FACTOR, product, split

# f32 out and lse tolerance of the kernel against the plain forward on the
# card (chip_smoke.TOL_F32)
TOL_F32 = 1e-4
# the port's plain forward against the Pallas forward, both f32 (as in
# tests/test_torch_flash_attention.py)
TOL_PALLAS = 2e-5
# keys per tile and per P·V product of the kernel, by head dim
# (flash_fwd_f32.cu, FwdGeom: C and KC), and the parts of d that S is
# summed in (SK)
KEY_TILE = {64: 64, 128: 32}
PV_KEYS = {64: 32, 128: 16}
S_PARTS = 4
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def forward(q, k, v, causal, mode, mask=None):
    """(out, lse) of [b, h, t, d] q, k, v as the kernel computes them: key
    tiles of KEY_TILE[d], S of each tile (summed over S_PARTS parts of d)
    and P·V of each PV_KEYS[d] keys by ``mode`` ("3xtf32", "tf32" or
    "f32", see ``product``), the online softmax in f32 with the plain
    version's NEG_INF rules; ``mask`` [b, t] (key valid iff > 0)."""
    t, d = q.shape[-2:]
    c = KEY_TILE[d]
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    m = torch.full(q.shape[:-1], tfa.NEG_INF)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    rows = torch.arange(t)[:, None]
    w = d // S_PARTS
    for k0 in range(0, t, c):
        kt = k[..., k0:k0 + c, :].transpose(-1, -2)
        s = product(q[..., :w], kt[..., :w, :], mode)
        for j in range(w, d, w):
            s = s + product(q[..., j:j + w], kt[..., j:j + w, :], mode)
        s = s * scale
        if causal:
            s = torch.where(rows >= torch.arange(k0, k0 + c)[None], s,
                            tfa.NEG_INF)
        if mask is not None:
            s = torch.where(mask[:, None, None, k0:k0 + c] > 0, s,
                            tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= tfa.NEG_INF / 2, 0.0, m_new)
        corr = torch.where(m <= tfa.NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        p = torch.where(s <= tfa.NEG_INF / 2, 0.0,
                        torch.exp(s - m_safe[..., None]))
        l = l * corr + p.sum(-1)
        # O rescaled, then each product of PV_KEYS[d] keys taken on its own
        # and added
        o = o * corr[..., None]
        for j in range(0, c, PV_KEYS[d]):
            o = o + product(p[..., j:j + PV_KEYS[d]],
                            v[..., k0 + j:k0 + j + PV_KEYS[d], :], mode)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      tfa.NEG_INF)
    return out, lse


def _case(t, d, seed):
    """Seeded q, k, v [1, 2, t, d] f32."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, t, d))
                                .astype(np.float32)) for _ in range(3))
    return q, k, v


def _dense64(q, k, v, causal):
    t, d = q.shape[-2:]
    s = (q.double() @ k.double().transpose(-1, -2)) * d ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1),
                          float("-inf"))
    return torch.softmax(s, -1) @ v.double(), torch.logsumexp(s, -1)


def _errors(got, ref):
    return [(g.double() - r).abs().max().item() for g, r in zip(got, ref)]


def _plain(q, k, v, causal):
    """The port's plain f32 forward (the kernel's yardstick on the card) on
    [b, h, t, d] inputs, as [b, h, t, d] out and [b, h, t] lse."""
    out, lse = tfa.flash_attention_fwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal)
    return out.transpose(1, 2), lse


# --------------------------------------------------------------------------
# the auto route
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,t,mask_shape,takes", [
    (torch.float32, 64, 256, None, True),
    (torch.bfloat16, 64, 256, None, True),
    (torch.float32, 128, 128, (2, 128), True),      # a [b, t] key mask
    (torch.bfloat16, 128, 2048, None, True),
    (torch.float32, 32, 256, None, False),          # head dim 32
    (torch.bfloat16, 32, 1024, None, False),
    (torch.float16, 64, 256, None, False),          # float16
    (torch.float64, 64, 256, None, False),
    (torch.float32, 64, 200, None, False),          # t % 128 != 0
    (torch.float32, 64, 256, (2, 256, 1), False),   # not a [b, t] mask
])
def test_kernels_take_is_a_rule_of_types_and_shapes(dtype, d, t,
                                                    mask_shape, takes):
    """What the kernels take: bf16 or f32, head dim 64 or 128,
    t % 128 == 0, no mask or a [b, t] one — decided from the dtype and
    shapes alone, before any launch."""
    assert tfa.kernels_take(dtype, (2, t, 3, d), mask_shape) is takes


def _card_query(shape, dtype):
    """A stand-in for a CUDA query tensor (no card needed): the routing
    rule reads only its shape, dtype and device."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=dtype,
                           device=torch.device("cuda"))


@pytest.mark.parametrize("dtype,d,auto", [
    (torch.float32, 32, False),
    (torch.bfloat16, 32, False),
    (torch.float32, 64, True),
    (torch.bfloat16, 64, True),
    (torch.float32, 128, True),
    (torch.bfloat16, 128, True),
    (torch.float16, 64, False),
])
def test_auto_routes_a_cuda_call_to_the_kernels_only_if_they_take_it(
        monkeypatch, dtype, d, auto):
    """Unset, the flag sends a CUDA call to the kernels only when they
    take it and every other call to the dense path (as the reference's
    auto rule sends it to XLA); forced on, every eligible call goes to the
    kernels, and one they do not take raises there."""
    q = _card_query((2, 1024, 16, d), dtype)
    monkeypatch.delenv("DL4JTPU_FLASH_ATTENTION", raising=False)
    assert tfa.flash_available(q, None) is auto
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    assert tfa.flash_available(q, None) is True
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "0")
    assert tfa.flash_available(q, None) is False


@pytest.mark.parametrize("d,auto", [(32, False), (16, False), (64, True),
                                    (128, True)])
def test_auto_ring_routes_by_head_dim(monkeypatch, d, auto):
    """A ring hop runs in f32, so under auto only its head dim decides:
    the kernels' (64, 128) take the flash route on CUDA, any other the
    plain online-softmax hop; the CPU always the plain hop; forced on, the
    flash route."""
    monkeypatch.delenv("DL4JTPU_FLASH_ATTENTION", raising=False)
    assert tattn.ring_flash_available(512, torch.device("cuda"), d) is auto
    assert not tattn.ring_flash_available(512, torch.device("cpu"), d)
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    assert tattn.ring_flash_available(512, torch.device("cuda"), d)


def test_ring_attention_under_auto_passes_its_head_dim(monkeypatch):
    """``ring_attention`` with no ``impl`` asks the rule with the head dim
    of its shards, and takes the plain hop where the rule says no."""
    seen = []

    def rule(t_local, device, head_dim):
        seen.append(head_dim)
        return False
    monkeypatch.setattr(tattn, "ring_flash_available", rule)
    monkeypatch.setattr(tattn, "_ring_plain",
                        lambda q, *a: torch.zeros_like(q))
    q = torch.zeros((1, 128, 2, 32))
    tattn.ring_attention(q, q, q, group=None, causal=True)
    assert seen == [32]


# --------------------------------------------------------------------------
# the pre-pass's layout and the fragment permutation
# --------------------------------------------------------------------------

def test_fwd_split_plain_layout():
    """The scratch ``[3, 2, b·h, t·d]``: hi and lo of q and k row by row,
    then of v transposed with t permuted within each group of 8."""
    b, t, h, d = 2, 32, 3, 64
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d))
                                .astype(np.float32)) for _ in range(3))
    got = tfa.flash_fwd_split_plain(q, k, v)
    assert got.shape == (tfa.FWD_SPLIT_TENSORS, 2, b * h, t * d)
    rows = [x.permute(0, 2, 1, 3).reshape(b * h, t, d) for x in (q, k, v)]
    for i in (0, 1):
        hi, lo = split(rows[i])
        assert torch.equal(got[i, 0].view(b * h, t, d), hi)
        assert torch.equal(got[i, 1].view(b * h, t, d), lo)
    perm = [8 * (u // 8) + PERM[u % 8] for u in range(t)]
    hi, lo = split(rows[2])
    assert torch.equal(got[2, 0].view(b * h, d, t),
                       hi[:, perm].transpose(1, 2))
    assert torch.equal(got[2, 1].view(b * h, d, t),
                       lo[:, perm].transpose(1, 2))
    for part in got:
        assert not (part.view(torch.int32) & 8191).any()


def test_fwd_split_plain_takes_strided_views():
    """The pre-pass reads the strided q/k/v slices of one qkv tensor in
    place; its plain version gives what it gives on contiguous copies."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 64, 3, 2, 64))
                           .astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    assert torch.equal(tfa.flash_fwd_split_plain(q, k, v),
                       tfa.flash_fwd_split_plain(*(x.contiguous()
                                                   for x in (q, k, v))))


def test_fragment_permutation_pairs_the_same_terms_for_pv():
    """The kernel passes S's accumulator to the tf32 A fragment of P·V as
    it lies: k slot u of a group of 8 holds key 2u (u < 4) or 2(u − 4) + 1.
    The pre-pass's transposed v plane holds the same key at position u, so
    the product over the planes is P·V."""
    b, t, h, d = 1, 64, 1, 64
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
    p = torch.from_numpy(rng.random((16, t)).astype(np.float32))
    scratch = tfa.flash_fwd_split_plain(v, v, v)
    vt = (scratch[2, 0] + scratch[2, 1]).view(d, t)    # hi + lo, [d][u]
    slot_key = [8 * (u // 8) + PERM[u % 8] for u in range(t)]
    p_frag = p[:, slot_key]            # what the fragments' k slots hold
    got = p_frag.double() @ vt.double().T
    want = p.double() @ v[0, :, 0].double()
    # hi + lo is v to within 2^-22 of |v|
    assert (got - want).abs().max().item() <= 2.0 ** -20
    wrong = p.double() @ vt.double().T     # fragments without the perm
    assert (wrong - want).abs().max().item() > 1e-2


# --------------------------------------------------------------------------
# the 3xTF32 arithmetic
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_forward_is_as_close_as_f32(d, causal):
    """The 3xTF32 forward's out and lse against float64: within FACTOR
    times the port's plain f32 forward's own error (observed 0.58-1.70 of
    it) plus 2^-24 of the largest magnitude, and inside the kernel's
    TOL_F32."""
    for seed in range(2):
        q, k, v = _case(256, d, seed)
        ref = _dense64(q, k, v, causal)
        e3 = _errors(forward(q, k, v, causal, "3xtf32"), ref)
        e32 = _errors(_plain(q, k, v, causal), ref)
        for name, a, b, r in zip(("out", "lse"), e3, e32, ref):
            assert a <= FACTOR * b + 2.0 ** -24 * r.abs().max().item(), \
                (name, a, b)
            assert a <= TOL_F32, (name, a)


def test_plain_tf32_fails_the_same_bound():
    """hi·hi alone (plain TF32, about 3 decimal digits) is far outside the
    bound the 3xTF32 scheme meets: the test can tell them apart."""
    q, k, v = _case(256, 64, 0)
    ref = _dense64(q, k, v, True)
    e1 = _errors(forward(q, k, v, True, "tf32"), ref)
    e32 = _errors(_plain(q, k, v, True), ref)
    assert all(a > 100 * FACTOR * b for a, b in zip(e1, e32)), (e1, e32)
    assert e1[0] > TOL_F32 / 2, e1


def test_tile_sums_of_the_model_are_the_plain_forward_in_f32():
    """The model in plain f32 ("f32") and the port's plain forward are two
    f32 computations of the same blockwise forward (key tiles of 64 against
    128): they agree within f32 noise."""
    q, k, v = _case(256, 64, 5)
    got = forward(q, k, v, True, "f32")
    for a, b in zip(got, _plain(q, k, v, True)):
        assert (a - b).abs().max().item() <= 2e-6


@pytest.fixture(scope="module")
def ref():
    """The JAX package's flash attention (jax.numpy as ``jnp``)."""
    jnp = pytest.importorskip("jax.numpy")
    from deeplearning4j_tpu.ops import flash_attention
    return SimpleNamespace(jnp=jnp, fa=flash_attention)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask_kind", ["none", "padded"])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_forward_matches_pallas_fwd_btd(ref, d, mask_kind, causal):
    """The 3xTF32 model on the kernel's tiles against the reference's
    Pallas forward (``_flash_fwd_btd``, interpret mode) on the same seeded
    inputs: out and lse within TOL_PALLAS, and rows with no attendable key
    (0, -1e30) on both sides."""
    jnp = ref.jnp
    b, h, t = 2, 2, 256
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, t), np.float32)
    if mask_kind == "padded":
        mask[0, :90] = 0.0
        mask[1, :] = 0.0

    def btd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, t, d))
    j_out, j_lse = ref.fa._flash_fwd_btd(
        btd(q), btd(k), btd(v), jnp.asarray(mask), n_heads=h,
        scale=float(1.0 / np.sqrt(d)), causal=causal, block_q=128,
        interpret=True)
    j_out = np.asarray(j_out).reshape(b, h, t, d)
    j_lse = np.asarray(j_lse).reshape(b, h, t)
    bh = [torch.from_numpy(x.transpose(0, 2, 1, 3).copy()) for x in (q, k, v)]
    out, lse = forward(*bh, causal, "3xtf32",
                       None if mask_kind == "none"
                       else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), j_out, atol=TOL_PALLAS, rtol=0)
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=TOL_PALLAS, rtol=0)
    if mask_kind == "padded":
        assert np.all(out.numpy()[1] == 0.0) and np.all(j_out[1] == 0.0)
        assert np.all(lse.numpy()[1] == tfa.NEG_INF)
        assert np.all(j_lse[1] == ref.fa.NEG_INF)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the f32 flash forward kernel runs "
                    "only there (CUDA C++, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(device, t, d, mask_kind, seed):
    """q/k/v as the strided slices of one [2, t, 3, 3, d] f32 tensor and a
    [2, t] mask: none, random, or leading padding in row 0 and a fully
    masked row 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((2, t, 3, 3, d), generator=gen, device=device)
    mask = None
    if mask_kind == "random":
        mask = (torch.rand((2, t), generator=gen, device=device) > 0.3).float()
    elif mask_kind == "padded":
        mask = torch.ones((2, t), device=device)
        mask[0, :t // 3 + 5] = 0.0
        mask[1] = 0.0
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_fwd_split_is_its_plain_version(cuda_device, d):
    """The pre-pass kernel's scratch equals flash_fwd_split_plain bit for
    bit on the strided qkv slices; one launch of its counter."""
    q, k, v, _ = _card_inputs(cuda_device, 256, d, "none", 1)
    before = tfa.FLASH_FWD_SPLIT_F32.launches
    got = tfa._flash_fwd_split_cuda(q, k, v)
    torch.cuda.synchronize()
    assert tfa.FLASH_FWD_SPLIT_F32.launches == before + 1
    assert torch.equal(got, tfa.flash_fwd_split_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 384, 2048])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mask_kind", ["none", "random", "padded"])
def test_cuda_f32_forward_matches_plain_and_repeats_bitwise(
        cuda_device, t, d, causal, mask_kind):
    """The 3xTF32 kernel against flash_attention_fwd_plain: out and lse
    within TOL_F32, exact (0, -1e30) where a row has no attendable key;
    a second launch gives the same bits; the pre-pass and the kernel
    launch once each and the bf16 forward not at all."""
    q, k, v, mask = _card_inputs(cuda_device, t, d, mask_kind, 2)
    kernels = (tfa.FLASH_FWD_SPLIT_F32, tfa.FLASH_FWD_F32, tfa.FLASH_FWD)
    before = [kn.launches for kn in kernels]
    out, lse = tfa.flash_attention_fwd(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert [kn.launches for kn in kernels] == [before[0] + 1, before[1] + 1,
                                               before[2]]
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, mask,
                                                     causal=causal)
    assert (out - ref_out).abs().max().item() <= TOL_F32
    assert (lse - ref_lse).abs().max().item() <= TOL_F32
    if mask_kind == "padded":
        dead = [(1, slice(None))] + ([(0, slice(0, t // 3 + 5))]
                                     if causal else [])
        for bi, rows in dead:
            assert (out[bi, rows] == 0).all()
            assert (lse[bi, :, rows] == tfa.NEG_INF).all()
    again = tfa.flash_attention_fwd(q, k, v, mask, causal=causal)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
def test_cuda_auto_trains_a_d32_attention_net_on_the_dense_path(
        cuda_device, monkeypatch):
    """Under auto, a transformer with head dim 32 (which no kernel takes)
    trains on the card through the dense path: a finite loss, and no flash
    kernel launched; forced on, the same step raises."""
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph
    monkeypatch.delenv("DL4JTPU_FLASH_ATTENTION", raising=False)
    vocab, t = 64, 128
    net = ComputationGraph(transformer_lm(
        vocab, n_layers=1, d_model=64, n_heads=2, d_ff=64,
        input_ids=True), device="cuda").init()
    ids = np.random.default_rng(0).integers(0, vocab, (2, t + 1))
    x = torch.as_tensor(ids[:, :-1].astype(np.int32), device=cuda_device)
    y = torch.as_tensor(ids[:, 1:].astype(np.int32), device=cuda_device)
    kernels = [kn for kn in tfa._nvcc.KERNELS.values()]
    before = [kn.launches for kn in kernels]
    loss = float(net.fit_batch(x, y))
    torch.cuda.synchronize()
    assert np.isfinite(loss)
    assert [kn.launches for kn in kernels] == before
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    with pytest.raises(ValueError, match="flash kernel takes"):
        net.fit_batch(x, y)
