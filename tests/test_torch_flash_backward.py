"""The port's flash-attention backward against the JAX package's.

On the CPU the port's ``flash_attention`` differentiates through
``FlashAttentionFunction``, whose backward is the plain blockwise version
(what the CUDA kernels are held against on the card). It is compared with
``jax.vjp`` of the reference's ``flash_attention(..., interpret=True)`` —
the Pallas backward kernels in interpret mode, or the ``lax.scan``
fallback under ``DL4JTPU_FLASH_BWD=jax`` — and with torch autograd through
the port's dense attention. All inputs are explicit float32
(``tests/conftest.py`` turns on jax x64).

The tests marked ``cuda`` need a card and no JAX (the JAX package is
imported inside the ``ref`` fixture):
``python -m pytest --noconftest -m cuda tests/test_torch_flash_backward.py``.

Tolerance: 1e-5 on out, lse, dq, dk and dv at f32 — both sides compute in
f32 from the same inputs; only the blocking and summation order differ
(observed ≤ 1.1e-6).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5
B, H = 2, 2
PAD = 90   # leading padded keys of batch row 0 (crosses a 64- and a 128-row tile)


def _inputs(t, d, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((B, t, H, d)).astype(np.float32)
                     for _ in range(4))
    if mask_kind == "none":
        mask = None
    elif mask_kind == "random":
        mask = (rng.random((B, t)) > 0.3).astype(np.float32)
    else:   # leading padding in row 0, a fully masked row 1
        mask = np.ones((B, t), np.float32)
        mask[0, :PAD] = 0.0
        mask[1, :] = 0.0
    return q, k, v, dout, mask


def _port_grads(q, k, v, dout, mask, causal):
    """(out, lse, dq, dk, dv) of the port's flash_attention on the CPU."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = tfa.flash_attention_fwd(
        tq, tk, tv, None if mask is None else torch.from_numpy(mask),
        causal=causal)
    out.backward(torch.from_numpy(dout))
    return (out.detach().numpy(), lse.numpy(), tq.grad.numpy(),
            tk.grad.numpy(), tv.grad.numpy())


@pytest.fixture(scope="module")
def ref():
    """The JAX package's flash attention (with jax and jax.numpy)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deeplearning4j_tpu.ops import flash_attention
    return SimpleNamespace(jax=jax, jnp=jnp, fa=flash_attention)


# (t, d, mask, causal, DL4JTPU_FLASH_BWD): every value of each axis, with
# the Pallas route on most cases and the lax.scan fallback on three
CASES = [
    (128, 64, "none", True, "pallas"),
    (256, 64, "random", False, "pallas"),
    (256, 128, "padded", True, "pallas"),
    (128, 128, "padded", False, "pallas"),
    (256, 64, "padded", True, "pallas"),
    (256, 128, "none", False, "pallas"),
    (128, 64, "random", True, "pallas"),
    (256, 64, "padded", True, "jax"),
    (128, 128, "random", False, "jax"),
    (128, 64, "none", False, "jax"),
]


@pytest.mark.parametrize("t,d,mask_kind,causal,bwd", CASES)
def test_backward_matches_reference_vjp(ref, monkeypatch, t, d, mask_kind,
                                        causal, bwd):
    jnp = ref.jnp
    if bwd == "jax":
        monkeypatch.setenv("DL4JTPU_FLASH_BWD", "jax")
    else:
        monkeypatch.delenv("DL4JTPU_FLASH_BWD", raising=False)
    q, k, v, dout, mask = _inputs(t, d, mask_kind, seed=t + d)
    jmask = jnp.asarray(np.ones((B, t), np.float32) if mask is None else mask)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_out, vjp = ref.jax.vjp(
        lambda a, b, c: ref.fa.flash_attention(a, b, c, causal=causal,
                                               interpret=True, mask=jmask),
        jq, jk, jv)
    j_grads = vjp(jnp.asarray(dout))
    _, j_lse = ref.fa._core_fwd(jq, jk, jv, jmask, causal, None, None, True)
    out, lse, *grads = _port_grads(q, k, v, dout, mask, causal)
    np.testing.assert_allclose(out, np.asarray(j_out), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.reshape(B * H, t), np.asarray(j_lse),
                               atol=TOL, rtol=0)
    for name, g, jg in zip(("dq", "dk", "dv"), grads, j_grads):
        np.testing.assert_allclose(g, np.asarray(jg), atol=TOL, rtol=0,
                                   err_msg=name)
    if mask_kind == "padded":
        dq, dk, dv = grads
        assert np.all(dq[1] == 0.0)                     # a row with no key
        assert np.all(dk[0, :PAD] == 0.0) and np.all(dv[0, :PAD] == 0.0)
        assert np.all(dk[1] == 0.0) and np.all(dv[1] == 0.0)
        if causal:
            assert np.all(dq[0, :PAD] == 0.0)


@pytest.mark.parametrize("mask_kind", ["none", "random", "padded"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_dense_autograd(monkeypatch, mask_kind, causal):
    """The flash route's gradients against torch autograd through the
    port's dense ``dot_product_attention`` (flash forced off)."""
    q, k, v, dout, mask = _inputs(256, 64, mask_kind, seed=11)
    _, _, *grads = _port_grads(q, k, v, dout, mask, causal)
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "0")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.dot_product_attention(
        tq, tk, tv, causal=causal,
        mask=None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(dout))
    for g, dg in zip(grads, (tq.grad, tk.grad, tv.grad)):
        assert torch.isfinite(dg).all()
        np.testing.assert_allclose(g, dg.numpy(), atol=TOL, rtol=0)


def test_flash_route_of_the_attention_op_differentiates(monkeypatch):
    """``dot_product_attention`` forced onto the flash route builds an
    autograd graph through FlashAttentionFunction (the CPU path runs the
    plain backward; no kernel launch count moves)."""
    q, k, v, dout, mask = (torch.from_numpy(a) for a in
                           _inputs(128, 64, "random", seed=12))
    q.requires_grad_()
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    counts = [kn.launches for kn in (tfa.FLASH_FWD, tfa.FLASH_BWD_DQ)]
    out = tattn.dot_product_attention(q, k, v, causal=True, mask=mask)
    assert out.grad_fn is not None and "FlashAttention" in out.grad_fn.name()
    out.backward(dout)
    want = tfa.flash_attention_bwd_plain(
        q.detach(), k, v, mask, *tfa.flash_attention_fwd_plain(
            q.detach(), k, v, mask, causal=True), dout, causal=True)[0]
    assert torch.equal(q.grad, want)
    assert [kn.launches for kn in (tfa.FLASH_FWD, tfa.FLASH_BWD_DQ)] == counts


def test_mask_gets_no_gradient_and_inference_mode_works():
    q, k, v, dout, mask = (torch.from_numpy(a) for a in
                           _inputs(128, 64, "random", seed=13))
    mask.requires_grad_()
    q.requires_grad_()
    out = tfa.flash_attention(q, k, v, True, mask=mask)
    out.backward(dout)
    assert mask.grad is None and q.grad is not None
    with torch.inference_mode():
        again = tfa.flash_attention(q, k, v, True, mask=mask)
    assert not again.requires_grad
    torch.testing.assert_close(again, out.detach(), atol=0, rtol=0)


def _kernel_rounding_grads(q, k, v, out, lse, dout, causal, skip=None):
    """Backward that rounds P (for dv) and dS (for dq and dk) to bf16
    before the products and the results to bf16, as the CUDA kernels do.
    ``skip=(k0, k1)`` leaves those keys' tile out of every product: a
    kernel fault to be caught."""
    qf, kf, vf, of, dof = (x.float().transpose(1, 2)
                           for x in (q, k, v, out, dout))
    t, d = q.shape[1], q.shape[3]
    delta = (dof * of).sum(-1, keepdim=True)
    s = qf @ kf.transpose(-1, -2) / d ** 0.5
    keep = torch.ones((t, t), dtype=torch.bool)
    if causal:
        keep = keep.tril()
    if skip is not None:
        keep[:, skip[0]:skip[1]] = False
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) / d ** 0.5
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    grads = (dsb @ kf, dsb.transpose(-1, -2) @ qf, pb.transpose(-1, -2) @ dof)
    return tuple(g.transpose(1, 2).bfloat16() for g in grads)


@pytest.mark.parametrize("t", [256, 2048])
def test_bf16_grad_tolerance_admits_rounding_and_catches_a_skipped_tile(t):
    """The bound the card holds bf16 kernel gradients to: the kernels' own
    rounding of P and dS stays within 0.6 of it, while leaving one 64-key
    tile out exceeds it."""
    rng = np.random.default_rng(7)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, t, 2, 64))
                                      .astype(np.float32)).bfloat16()
                     for _ in range(4))
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=True)
    ref = tfa.flash_attention_bwd_plain(q, k, v, None, out, lse, dout,
                                        causal=True)
    tols = tfa.bf16_grad_tolerance(q, k, v, None, out, lse, dout, ref,
                                   causal=True)
    got = _kernel_rounding_grads(q, k, v, out, lse, dout, True)
    for name, g, r, tol in zip(("dq", "dk", "dv"), got, ref, tols):
        ratio = ((g.float() - r.float()).abs() / tol).max().item()
        assert ratio <= 0.6, (name, ratio)
    bad = _kernel_rounding_grads(q, k, v, out, lse, dout, True,
                                 skip=(t // 2, t // 2 + 64))
    for name, g, r, tol in zip(("dq", "dk", "dv"), bad, ref, tols):
        assert ((g.float() - r.float()).abs() > tol).any(), name


def test_backward_shape_checks():
    q = torch.zeros((1, 128, 2, 64))
    lse = torch.zeros((1, 2, 128))
    with pytest.raises(ValueError, match="equal"):
        tfa.flash_attention_bwd(q, q, torch.zeros((1, 128, 2, 32)), None, q,
                                lse, q)
    with pytest.raises(ValueError, match="mask"):
        tfa.flash_attention_bwd(q, q, q, torch.ones((1, 127)), q, lse, q)


# the tensor maps of the bf16 kernels (host-side layout, checked on the CPU)
_MAP_B, _MAP_T, _MAP_H = 2, 256, 3


def test_tma_layout_of_the_qkv_slices():
    """q/k/v sliced from one [b, t, 3, h, d] projection are read in place:
    dims (d, h, t, b) innermost first; byte strides of h, t and b."""
    qkv = torch.zeros((_MAP_B, _MAP_T, 3, _MAP_H, 64), dtype=torch.bfloat16)
    for i in range(3):
        dims, strides = tfa.tma_layout(qkv[:, :, i], "q")
        assert dims == (64, _MAP_H, _MAP_T, _MAP_B)
        assert strides == (64 * 2, 3 * _MAP_H * 64 * 2,
                           _MAP_T * 3 * _MAP_H * 64 * 2)


@pytest.mark.parametrize("d", [64, 128])
def test_tma_layout_of_a_contiguous_view(d):
    x = torch.zeros((_MAP_B, _MAP_T, _MAP_H, d), dtype=torch.bfloat16)
    dims, strides = tfa.tma_layout(x)
    assert dims == (d, _MAP_H, _MAP_T, _MAP_B)
    assert strides == (d * 2, _MAP_H * d * 2, _MAP_T * _MAP_H * d * 2)


def test_tma_layout_packs_the_strides_of_size_one_dims():
    """A dim of size 1 may carry any stride; the map gets the packed one,
    as the C side gives it."""
    x = torch.zeros((1, _MAP_T, 1, 64), dtype=torch.bfloat16)
    odd = x.as_strided(x.shape, (7, 64, 3, 1))
    assert tfa.tma_layout(odd)[1] == (128, 128, _MAP_T * 128)


def _misaligned_views():
    base = torch.zeros((_MAP_B, _MAP_T, _MAP_H, 136), dtype=torch.bfloat16)
    flat = torch.zeros(_MAP_B * _MAP_T * _MAP_H * 64 + 8,
                       dtype=torch.bfloat16)
    shape = (_MAP_B, _MAP_T, _MAP_H, 64)
    packed = (_MAP_T * _MAP_H * 64, _MAP_H * 64, 64, 1)
    return {
        # 68-column rows: a 136-byte h stride is not a multiple of 16
        "h stride": (base[..., :68][..., :64].as_strided(
            shape, (_MAP_T * _MAP_H * 68, _MAP_H * 68, 68, 1)), "stride"),
        # the base 8 bytes past a 16-byte boundary
        "base": (flat[4:].as_strided(shape, packed), "aligned base"),
        # the head dim not contiguous
        "head dim": (base[..., ::2], "contiguous"),
        # a head dim TMA cannot cut into 64-column boxes
        "d=32": (base[..., :32], "boxes of 64"),
        # a broadcast batch dim: stride 0
        "broadcast": (base[:1, ..., :64].expand(_MAP_B, -1, -1, -1),
                      "stride"),
    }


@pytest.mark.parametrize("case", ["h stride", "base", "head dim", "d=32",
                                  "broadcast"])
def test_tma_layout_refuses_what_tma_cannot_read(case):
    view, match = _misaligned_views()[case]
    with pytest.raises(ValueError, match=match):
        tfa.tma_layout(view, "k")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(t, d, dtype, device, seed):
    """q/k/v as the strided slices of one [b, t, 3, h, d] qkv tensor (the
    layout the attention layer hands the kernels, which TMA reads in place)
    and a dout with a non-default stride (a slice of [b, t, 2, h, d]), with
    the padded mask: leading padding in row 0, a fully masked row 1."""
    q, k, v, dout, mask = _inputs(t, d, "padded", seed=seed)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).to(device, dtype)
    douts = torch.from_numpy(np.stack([dout, -dout], axis=2)).to(device, dtype)
    return (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], douts[:, :, 0],
            torch.from_numpy(mask).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 256, 2048])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_backward_kernels_match_plain(cuda_device, t, d, dtype, causal):
    """f32: dq, dk, dv within 1e-4 (f32 on both sides, no TF32); bf16:
    within ``bf16_grad_tolerance`` element by element. One tile, a few
    tiles and the flagship length; q/k/v read in place from a qkv tensor
    and a strided dout. Masked keys and rows with no key give exact zeros.
    Each kernel launches once."""
    q, k, v, dout, mask = _card_inputs(t, d, dtype, cuda_device, seed=14)
    assert not q.is_contiguous() and not dout.is_contiguous()
    out, lse = tfa.flash_attention_fwd(q, k, v, mask, causal=causal)
    kernels = (tfa.FLASH_BWD_PREPROCESS, tfa.FLASH_BWD_DQ, tfa.FLASH_BWD_DKV)
    before = [kn.launches for kn in kernels]
    got = tfa.flash_attention_bwd(q, k, v, mask, out, lse, dout,
                                  causal=causal)
    torch.cuda.synchronize()
    assert [kn.launches for kn in kernels] == [n + 1 for n in before]
    ref = tfa.flash_attention_bwd_plain(q, k, v, mask, out, lse, dout,
                                        causal=causal)
    if dtype == torch.bfloat16:
        tols = tfa.bf16_grad_tolerance(q, k, v, mask, out, lse, dout, ref,
                                       causal=causal)
    else:
        tols = (1e-4,) * 3
    for name, g, r, tol in zip(("dq", "dk", "dv"), got, ref, tols):
        assert g.dtype == dtype and g.is_contiguous()
        assert ((g.float() - r.float()).abs() <= tol).all(), name
    dq, dk, dv = got
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()
    assert (dk[0, :PAD] == 0).all() and (dv[0, :PAD] == 0).all()
    if causal:
        assert (dq[0, :PAD] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_backward_kernels_are_deterministic(cuda_device, d):
    """Each block owns its output tile (two passes, no atomics), so two
    launches on the same inputs give bitwise equal dq, dk and dv."""
    q, k, v, dout, mask = _card_inputs(2048, d, torch.bfloat16, cuda_device,
                                       seed=16)
    for m in (None, mask):
        out, lse = tfa.flash_attention_fwd(q, k, v, m, causal=True)
        first = tfa.flash_attention_bwd(q, k, v, m, out, lse, dout,
                                        causal=True)
        second = tfa.flash_attention_bwd(q, k, v, m, out, lse, dout,
                                         causal=True)
        for name, a, b in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_autograd_runs_the_backward_kernels(cuda_device):
    """Gradients through the flash route on the card come from the three
    kernels, one launch each per backward."""
    q, k, v, dout, mask = (torch.from_numpy(a).to(cuda_device) for a in
                           _inputs(128, 64, "random", seed=15))
    q, k, v = (x.bfloat16().requires_grad_() for x in (q, k, v))
    kernels = (tfa.FLASH_FWD, tfa.FLASH_BWD_PREPROCESS, tfa.FLASH_BWD_DQ,
               tfa.FLASH_BWD_DKV)
    before = [kn.launches for kn in kernels]
    out = tfa.flash_attention(q, k, v, True, mask=mask)
    out.backward(dout.bfloat16())
    torch.cuda.synchronize()
    assert [kn.launches for kn in kernels] == [n + 1 for n in before]
    assert all(x.grad is not None and torch.isfinite(x.grad.float()).all()
               for x in (q, k, v))


@pytest.mark.cuda
def test_cuda_input_that_needs_grad_with_d32_raises(cuda_device, monkeypatch):
    """Forced on, a head dim the kernels do not take raises on the card,
    with or without a gradient; it never drops to the dense path."""
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    q = torch.randn((1, 128, 2, 32), device=cuda_device,
                    dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="flash kernel takes"):
        tattn.dot_product_attention(q, q, q, causal=True)
