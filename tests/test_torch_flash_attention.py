"""The port's flash-attention forward against the JAX package's.

The port's plain blockwise version (what the CPU path runs, and what the
CUDA kernel is held against on the card) is compared with the reference's
Pallas forward run in interpret mode: ``_flash_fwd_btd`` directly and the
public ``flash_attention``. t=256 with 128-row blocks, so the online
softmax runs across several k-tiles. All inputs are explicit float32
(``tests/conftest.py`` turns on jax x64).

The tests marked ``cuda`` need a card and no JAX; the JAX package is
imported inside the ``ref`` fixture, so on a machine with a card and
without jax they run with
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.

Tolerance: 2e-5 on out and lse at f32 — both sides compute in f32 from the
same inputs; only the blocking and summation order differ.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import _nvcc
from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

TOL = 2e-5
B, T, H = 2, 256, 2
PAD = 90   # leading padded keys of batch row 0 (crosses a 64- and a 128-row tile)


def _inputs(d, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, d)).astype(np.float32)
               for _ in range(3))
    if mask_kind == "none":
        mask = None
    elif mask_kind == "random":
        mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    else:   # leading padding in row 0, a fully masked row 1
        mask = np.ones((B, T), np.float32)
        mask[0, :PAD] = 0.0
        mask[1, :] = 0.0
    return q, k, v, mask


def _dead_rows(mask_kind, causal):
    """(batch row, query rows) that attend no key."""
    if mask_kind != "padded":
        return []
    dead = [(1, slice(None))]
    if causal:
        dead.append((0, slice(0, PAD)))
    return dead


@pytest.fixture(scope="module")
def ref():
    """The JAX package's attention ops (jax.numpy as ``jnp``)."""
    jnp = pytest.importorskip("jax.numpy")
    from deeplearning4j_tpu.ops import attention, flash_attention
    return SimpleNamespace(jnp=jnp, attn=attention, fa=flash_attention)


def _btd(jnp, a):
    b, t, h, d = a.shape
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, t, d))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask_kind", ["none", "random", "padded"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_fwd_btd(ref, d, mask_kind, causal):
    jnp = ref.jnp
    q, k, v, mask = _inputs(d, mask_kind)
    jmask = np.ones((B, T), np.float32) if mask is None else mask
    j_out, j_lse = ref.fa._flash_fwd_btd(
        _btd(jnp, q), _btd(jnp, k), _btd(jnp, v), jnp.asarray(jmask),
        n_heads=H, scale=float(1.0 / np.sqrt(d)), causal=causal, block_q=128,
        interpret=True)
    j_out = np.asarray(j_out).reshape(B, H, T, d).transpose(0, 2, 1, 3)
    j_lse = np.asarray(j_lse).reshape(B, H, T)
    t_out, t_lse = tfa.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), causal=causal)
    assert t_out.dtype == torch.float32 and t_lse.shape == (B, H, T)
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=TOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, atol=TOL, rtol=0)
    for bi, rows in _dead_rows(mask_kind, causal):
        assert np.all(t_out.numpy()[bi, rows] == 0.0)
        assert np.all(t_lse.numpy()[bi, :, rows] == tfa.NEG_INF)
        assert np.all(j_lse[bi, :, rows] == ref.fa.NEG_INF)


@pytest.mark.parametrize("d,mask_kind,causal", [(64, "padded", True),
                                                (128, "random", False)])
def test_flash_attention_matches_pallas_public_op(ref, d, mask_kind, causal):
    jnp = ref.jnp
    q, k, v, mask = _inputs(d, mask_kind, seed=1)
    j_out = np.asarray(ref.fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, mask=None if mask is None else jnp.asarray(mask)))
    t_out = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=TOL, rtol=0)


def test_cpu_wrapper_runs_the_plain_version():
    q, k, v, mask = _inputs(64, "random", seed=2)
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    before = tfa.FLASH_FWD.launches
    out, lse = tfa.flash_attention_fwd(*args, causal=True)
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(*args, causal=True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert tfa.FLASH_FWD.launches == before   # no kernel on the CPU


@pytest.mark.parametrize("causal", [True, False])
def test_launch_reports_kernel_flops_to_the_counter(causal):
    # the pairs a head scores are the entries its mask keeps, and a
    # launch's FLOPs reach a compiled_costs count in progress
    from types import SimpleNamespace
    from deeplearning4j_tpu_torch.util import xla as txla
    t = 16
    kept = torch.ones(t, t).tril() if causal else torch.ones(t, t)
    assert tfa.attention_pairs(t, causal) == int(kept.sum())
    kernel = SimpleNamespace(name="probe", launches=0)
    want = 4.0 * 2 * 3 * 64 * tfa.attention_pairs(t, causal)

    def launch():
        tfa._launched(kernel, 0, tfa._flops(tfa.FWD_FLOPS_PER_PAIR, 2, 3, t,
                                            64, causal))
    _, costs = txla.compiled_costs(launch)
    assert costs == {"flops": want} and kernel.launches == 1
    with pytest.raises(RuntimeError, match="probe kernel launch failed"):
        tfa._launched(kernel, 2, 1.0)


@pytest.mark.parametrize("mask_kind", ["none", "padded"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_path_matches_reference(ref, monkeypatch, mask_kind, causal):
    """The guarded dense path (flash forced off) against the reference's,
    including rows with no attendable key (0, not NaN)."""
    jnp = ref.jnp
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "0")
    q, k, v, mask = _inputs(64, mask_kind, seed=3)
    j = np.asarray(ref.attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mask=None if mask is None else jnp.asarray(mask)))
    t = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, mask=None if mask is None else torch.from_numpy(mask))
    assert np.isfinite(t.numpy()).all()
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_and_dense_routes_agree(monkeypatch, causal):
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(64, "padded", seed=4))
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    flash = tattn.dot_product_attention(q, k, v, causal=causal, mask=mask)
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "0")
    dense = tattn.dot_product_attention(q, k, v, causal=causal, mask=mask)
    torch.testing.assert_close(flash, dense, atol=1e-5, rtol=0)


@pytest.mark.parametrize("flag,shape,mask_shape,expected", [
    ("1", (2, 256, 2, 64), None, True),          # forced on
    ("1", (2, 256, 2, 64), (2, 256), True),      # [b, t] key mask
    ("1", (2, 256, 2, 16), None, True),          # any head dim (the CUDA
                                                 # kernel raises for it)
    ("1", (2, 200, 2, 64), None, False),         # t % 128 != 0
    ("1", (2, 256, 2, 64), (2, 256, 1), False),  # not a [b, t] mask
    ("1", (2, 256, 2, 64), (1, 256), False),
    ("0", (2, 256, 2, 64), None, False),         # forced off
    ("auto", (2, 4096, 2, 64), None, False),     # auto: CPU → dense
])
def test_flash_available_routing(monkeypatch, flag, shape, mask_shape,
                                 expected):
    if flag == "auto":
        monkeypatch.delenv("DL4JTPU_FLASH_ATTENTION", raising=False)
    else:
        monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", flag)
    q = torch.empty(shape)
    mask = None if mask_shape is None else torch.ones(mask_shape)
    assert tfa.flash_available(q, mask) is expected


def _kernel_rounding_out(q, k, v, skip=None):
    """Causal bf16 forward that rounds P to bf16 for P·V and sums the f32 P
    in the denominator, as the CUDA kernel does. ``skip=(k0, k1)`` leaves
    those keys out for the rows past them: a kernel fault to be caught."""
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    t, d = q.shape[1], q.shape[3]
    logits = qf @ kf.transpose(-1, -2) / d ** 0.5
    keep = torch.ones((t, t), dtype=torch.bool).tril()
    if skip is not None:
        keep[skip[1]:, skip[0]:skip[1]] = False
    logits = logits.masked_fill(~keep, float("-inf"))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = (p.bfloat16().float() @ vf) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2).bfloat16()


@pytest.mark.parametrize("t", [256, 2048])
def test_bf16_out_tolerance_admits_p_rounding_and_catches_a_skipped_tile(t):
    """The bound the card holds bf16 kernel output to: the kernel's own
    rounding stays within half of it (max ratio ≈ 0.5 here), while leaving
    one 64-key tile out of late rows — where |out| is ≈ 0.04 — exceeds it."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, t, 2, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    ref, _ = tfa.flash_attention_fwd_plain(q, k, v, causal=True)
    tol = tfa.bf16_out_tolerance(q, k, v, None, ref, causal=True)
    err = (_kernel_rounding_out(q, k, v).float() - ref.float()).abs()
    assert (err <= 0.75 * tol).all()
    bad = _kernel_rounding_out(q, k, v, skip=(t - 128, t - 64)).float()
    assert ((bad - ref.float()).abs() > tol).any()


def test_shape_mismatch_raises():
    q = torch.zeros((1, 128, 2, 64))
    with pytest.raises(ValueError, match="equal"):
        tfa.flash_attention_fwd(q, q, torch.zeros((1, 128, 2, 32)))
    with pytest.raises(ValueError, match="mask"):
        tfa.flash_attention_fwd(q, q, q, torch.ones((1, 127)))


def _views_tma_cannot_read():
    """bf16 [2, 256, 3, 64] views the bf16 forward's tensor maps cannot
    read (CPU tensors: the wrapper checks them before any CUDA call)."""
    shape = (2, 256, 3, 64)
    wide = torch.zeros((2, 256, 3, 136), dtype=torch.bfloat16)
    flat = torch.zeros(2 * 256 * 3 * 64 + 8, dtype=torch.bfloat16)
    return {
        # 68-column rows: a 136-byte h stride is not a multiple of 16
        "h stride": wide[..., :68][..., :64].as_strided(
            shape, (256 * 3 * 68, 3 * 68, 68, 1)),
        # the base 2 bytes past a 16-byte boundary
        "base": flat[1:].as_strided(shape, (256 * 3 * 64, 3 * 64, 64, 1)),
        # the head dim not contiguous
        "head dim": wide[..., :128:2],
        # a broadcast batch dim: a stride of 0, which only TMA refuses
        "broadcast": wide[:1, ..., :64].expand(2, -1, -1, -1),
    }


@pytest.mark.parametrize("case", ["h stride", "base", "head dim",
                                  "broadcast"])
@pytest.mark.parametrize("operand", [0, 1, 2])
def test_forward_wrapper_refuses_views_tma_cannot_read(case, operand):
    """The bf16 forward reads q, k and v through TMA: a view it cannot
    read raises ValueError in the wrapper, before any CUDA call."""
    good = torch.zeros((2, 256, 3, 64), dtype=torch.bfloat16)
    qkv = [good, good, good]
    qkv[operand] = _views_tma_cannot_read()[case]
    before = tfa.FLASH_FWD.launches
    with pytest.raises(ValueError):
        tfa._flash_fwd_cuda(*qkv, None, True, 0.125)
    assert tfa.FLASH_FWD.launches == before


def test_forward_wrapper_refuses_a_scale_that_is_not_positive():
    """The bf16 kernel takes the row max of the raw scores, which is the
    max of the scaled ones only for a positive scale."""
    q = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="positive scale"):
        tfa._flash_fwd_cuda(q, q, q, None, True, -0.125)


def test_kernel_mask_is_16_byte_aligned():
    """The bf16 forward bulk-copies mask tiles, which needs a 16-byte
    aligned [b, t] f32 mask: a view at an odd offset is copied."""
    mask = torch.ones(2 * 256 + 1)[1:].view(2, 256)
    assert mask.data_ptr() % 16
    kmask = tfa._kernel_mask(mask, mask.device)
    assert kmask.data_ptr() % 16 == 0 and torch.equal(kmask, mask)
    aligned = torch.ones((2, 256))
    assert tfa._kernel_mask(aligned, aligned.device) is aligned


def test_library_digest_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library rebuilds when its source or any csrc/*.cuh header changes
    (the kernels include hopper.cuh), and not for other files."""
    monkeypatch.setattr(_nvcc, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// a\n")
    lib = _nvcc.Library("k")
    first = lib._digest()
    assert lib._digest() == first
    (tmp_path / "a.cuh").write_text("// a, edited\n")
    edited = lib._digest()
    assert edited != first
    (tmp_path / "b.cuh").write_text("// b\n")
    added = lib._digest()
    assert added not in (first, edited)
    (tmp_path / "notes.txt").write_text("not a header\n")
    assert lib._digest() == added
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    assert lib._digest() != added
    assert lib.library_path().parent.name == f"k-{lib._digest()}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel runs only there")
    return torch.device("cuda")


def _fwd_kernel(dtype):
    """The forward kernel a call in ``dtype`` launches: the bf16 kernel,
    or the f32 (3xTF32) one after its pre-pass."""
    return tfa.FLASH_FWD if dtype == torch.bfloat16 else tfa.FLASH_FWD_F32


@pytest.mark.cuda
def test_cuda_wrapper_takes_inputs_that_need_grad(cuda_device):
    """The kernel forward builds an autograd graph when its inputs need a
    gradient (the backward kernels are tested in
    tests/test_torch_flash_backward.py), and none under no_grad."""
    q = torch.randn((1, 128, 2, 64), device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    out, lse = tfa.flash_attention_fwd(q, q, q, causal=True)
    assert out.requires_grad and not lse.requires_grad
    with torch.no_grad():
        out, _ = tfa.flash_attention_fwd(q, q, q, causal=True)
    assert not out.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    """f32: out within 1e-4 (f32 on both sides, no TF32); bf16: out within
    ``bf16_out_tolerance`` element by element. lse within 1e-3."""
    q, k, v, mask = (torch.from_numpy(a).to(cuda_device)
                     for a in _inputs(64, "padded", seed=5))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    kernel = _fwd_kernel(dtype)
    before = kernel.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, mask, causal=True)
    assert kernel.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, mask, causal=True)
    err = (out.float() - ref_out.float()).abs()
    if dtype == torch.bfloat16:
        assert (err <= tfa.bf16_out_tolerance(q, k, v, mask, ref_out,
                                              causal=True)).all()
    else:
        assert err.max().item() <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(32, torch.bfloat16),
                                     (64, torch.float16)])
def test_cuda_forced_flash_raises_for_what_the_kernel_does_not_take(
        cuda_device, monkeypatch, d, dtype):
    """Forced on, a head dim or dtype the kernel does not take raises on
    the card; it never drops to the dense path."""
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    q = torch.randn((1, 128, 2, d), device=cuda_device).to(dtype)
    before = tfa.FLASH_FWD.launches
    with pytest.raises(ValueError, match="flash kernel takes"):
        tattn.dot_product_attention(q, q, q, causal=True)
    assert tfa.FLASH_FWD.launches == before


def _card_fwd_inputs(t, d, mask_kind, dtype, device, seed):
    """q/k/v as the strided slices of one [b, t, 3, h, d] qkv tensor (the
    layout the attention layer hands the kernel, read in place by TMA) and
    a [b, t] mask: none, random, or leading padding in row 0 and a fully
    masked row 1."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, t, 3, H, d)).astype(np.float32)
    qkv = torch.from_numpy(qkv).to(device, dtype)
    if mask_kind == "none":
        mask = None
    elif mask_kind == "random":
        mask = (rng.random((B, t)) > 0.3).astype(np.float32)
    else:
        mask = np.ones((B, t), np.float32)
        mask[0, :PAD] = 0.0
        mask[1, :] = 0.0
    mask = None if mask is None else torch.from_numpy(mask).to(device)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 256, 2048])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mask_kind", ["none", "random", "padded"])
def test_cuda_forward_kernel_matches_plain(cuda_device, t, d, dtype, causal,
                                           mask_kind):
    """One tile, a few tiles and the flagship length, q/k/v read in place
    from a qkv tensor. f32: out within 1e-4 (f32 on both sides, no TF32);
    bf16: out within ``bf16_out_tolerance`` element by element; lse within
    1e-4 (f32) or 1e-3 (bf16). Rows with no attendable key give exactly
    (0, -1e30). The kernel launches once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _card_fwd_inputs(t, d, mask_kind, dtype, cuda_device,
                                     seed=7)
    assert not q.is_contiguous()
    kernel = _fwd_kernel(dtype)
    before = kernel.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.dtype == dtype and lse.shape == (B, H, t)
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, mask,
                                                     causal=causal)
    err = (out.float() - ref_out.float()).abs()
    if dtype == torch.bfloat16:
        assert (err <= tfa.bf16_out_tolerance(q, k, v, mask, ref_out,
                                              causal=causal)).all()
        lse_tol = 1e-3
    else:
        assert err.max().item() <= 1e-4
        lse_tol = 1e-4
    assert (lse - ref_lse).abs().max().item() <= lse_tol
    for bi, rows in _dead_rows(mask_kind, causal):
        assert (out[bi, rows] == 0).all()
        assert (lse[bi, :, rows] == tfa.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_forward_kernel_is_deterministic(cuda_device, d):
    """Each block owns its output tile, so two launches on the same inputs
    give bitwise equal out and lse, with and without a mask."""
    q, k, v, mask = _card_fwd_inputs(2048, d, "random", torch.bfloat16,
                                     cuda_device, seed=8)
    for m in (None, mask):
        first = tfa.flash_attention_fwd(q, k, v, m, causal=True)
        second = tfa.flash_attention_fwd(q, k, v, m, causal=True)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_preprocess_matches_plain_on_a_strided_view(cuda_device, d,
                                                         dtype):
    """Δ = rowsum(dO∘O) from the preprocess kernel, with dO a strided
    slice of [b, t, 2, h, d], against the plain version: within 1e-4 (f32
    sums of the same products). It launches once."""
    rng = np.random.default_rng(9)
    out = torch.from_numpy(rng.standard_normal((B, 2048, H, d))
                           .astype(np.float32)).to(cuda_device, dtype)
    douts = torch.from_numpy(rng.standard_normal((B, 2048, 2, H, d))
                             .astype(np.float32)).to(cuda_device, dtype)
    dout = douts[:, :, 1]
    assert not dout.is_contiguous()
    before = tfa.FLASH_BWD_PREPROCESS.launches
    delta = tfa._flash_bwd_preprocess_cuda(out, dout)
    torch.cuda.synchronize()
    assert tfa.FLASH_BWD_PREPROCESS.launches == before + 1
    assert delta.shape == (B, H, 2048) and delta.dtype == torch.float32
    ref = tfa.flash_bwd_preprocess_plain(out, dout)
    assert (delta - ref).abs().max().item() <= 1e-4
