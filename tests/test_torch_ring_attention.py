"""Ring attention of the port against the JAX package.

* The flash carry entries (``flash_carry_init``, ``flash_attention_block``,
  ``flash_carry_finalize``, ``flash_attention_bwd_block``) against the JAX
  package's, whose Pallas kernels run with ``interpret=True`` here: causal
  and not, ragged and fully masked keys, a shard length that is not a
  multiple of 128. On the CPU the port's entries run the kernels' plain
  versions; the ``cuda`` cases hold the kernels against those.
* A real ring over gloo process groups of 2 and 4 ranks, both routes
  (``impl="flash"`` and ``"jax"``), against the JAX package's dense
  ``dot_product_attention`` and its ``jax.vjp`` (the JAX package's own
  ring does not run on this jax; see ROADMAP §C); the flash route equals
  the virtual ring (``virtual_ring_fwd``/``virtual_ring_bwd``, n shards
  in one process, which the card runs at the flagship's shape) bitwise.
  A shard of 4 or 8 rows is padded to 128 under the key mask on the
  flash route, so the padding is exercised throughout.

Tolerances (absolute, f32): outputs and carries 2e-5, gradients 1e-4, as
``tests/test_tensor_seq_parallel.py`` holds the JAX package's ring.

The gloo ranks are child processes of this file (``python
tests/test_torch_ring_attention.py --child RANK WORLD DIR``), started once
per world size by a module fixture that runs every case; they import no
JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import flash_attention as tfa

OUT_TOL = 2e-5
GRAD_TOL = 1e-4
B, T, H, D = 2, 16, 2, 8
RING_CASES = [(causal, masked, impl)
              for causal in (False, True)
              for masked in (False, True)
              for impl in ("flash", "jax")]


def _ring_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((B, T), np.float32)
    mask[0, 3:7] = 0.0          # ragged keys inside one shard
    mask[1, 10:] = 0.0          # a ragged tail across shards
    return q, k, v, g, mask


def _case_id(case):
    causal, masked, impl = case
    return (f"{'causal' if causal else 'full'}-"
            f"{'masked' if masked else 'nomask'}-{impl}")


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# ----------------------------------------------------------------------
# the JAX oracle
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_oracle():
    """{case: (out, dq, dk, dv)} from the JAX package's dense attention."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.ops.attention import dot_product_attention
    q, k, v, g, mask = _ring_inputs()
    out = {}
    for causal in (False, True):
        for masked in (False, True):
            m = jnp.asarray(mask) if masked else None

            def f(q, k, v):
                return dot_product_attention(q, k, v, causal=causal, mask=m)
            o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v))
            grads = vjp(jnp.asarray(g))
            out[(causal, masked)] = tuple(np.asarray(x)
                                          for x in (o,) + tuple(grads))
    return out


# ----------------------------------------------------------------------
# the carry entries against the JAX package's interpreted ones
# ----------------------------------------------------------------------

CARRY_CASES = [(causal, mask_kind, t)
               for causal in (False, True)
               for mask_kind in ("none", "ragged", "dead_rows")
               for t in (16, 24)]


def _carry_inputs(mask_kind, t, seed=1):
    rng = np.random.default_rng(seed)
    q, k0, v0, k1, v1, g = (rng.normal(size=(B, t, H, D)).astype(np.float32)
                            for _ in range(6))
    m0 = np.ones((B, t), np.float32)
    m1 = np.ones((B, t), np.float32)
    if mask_kind == "ragged":
        m0[0, : t // 3] = 0.0
        m1[1, t // 2:] = 0.0
    elif mask_kind == "dead_rows":
        # batch row 1 sees no key in either block: out 0, lse -1e30
        m0[1] = 0.0
        m1[1] = 0.0
        m1[0, ::3] = 0.0
    return q, (k0, v0, m0), (k1, v1, m1), g


@pytest.fixture(scope="module")
def jcarry():
    """The JAX package's carry entries, jitted once per static
    configuration (the interpreted kernels cost a second a call eagerly)."""
    import jax
    from deeplearning4j_tpu.ops import flash_attention as jfa
    static = ("causal", "block_q", "interpret")
    return (jfa, jax.jit(jfa.flash_attention_block, static_argnames=static),
            jax.jit(jfa.flash_attention_bwd_block, static_argnames=static))


@pytest.mark.parametrize("case", CARRY_CASES,
                         ids=[f"{'causal' if c else 'full'}-{m}-t{t}"
                              for c, m, t in CARRY_CASES])
def test_carry_entries_match_the_reference(case, jcarry):
    """Two hops — a pre-diagonal block (non-causal kernel) then the
    diagonal block (``causal``) — folded into the carry, finalized, and
    each hop's backward against the global lse."""
    import jax.numpy as jnp
    jfa, jblock, jbwd = jcarry
    causal, mask_kind, t = case
    q, hop0, hop1, g = _carry_inputs(mask_kind, t)
    kinds = (False, causal)
    bq = 8
    jq = jnp.asarray(q)
    jc = jfa.flash_carry_init(jq)
    tc = tfa.flash_carry_init(torch.from_numpy(q))
    for (k, v, m), diag in zip((hop0, hop1), kinds):
        jc = jblock(
            jq, jnp.asarray(k), jnp.asarray(v), jc, causal=diag,
            mask=jnp.asarray(m), block_q=bq, interpret=True)
        tc = tfa.flash_attention_block(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tc, causal=diag, mask=torch.from_numpy(m))
        for got, want in zip(tc, jc):
            assert _max_err(got, want) <= OUT_TOL
    jout, jlse = jfa.flash_carry_finalize(jc)
    tout, tlse = tfa.flash_carry_finalize(tc)
    assert _max_err(tout, jout) <= OUT_TOL
    assert _max_err(tlse, jlse) <= OUT_TOL
    if mask_kind == "dead_rows":
        assert np.all(tout[1].numpy() == 0.0)
        assert np.all(tlse[1].numpy() == tfa.NEG_INF)
    for (k, v, m), diag in zip((hop0, hop1), kinds):
        jg = jbwd(
            jq, jnp.asarray(k), jnp.asarray(v), jout, jlse, jnp.asarray(g),
            causal=diag, mask=jnp.asarray(m), block_q=bq, interpret=True)
        tg = tfa.flash_attention_bwd_block(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tout, tlse, torch.from_numpy(g), causal=diag,
            mask=torch.from_numpy(m))
        for got, want in zip(tg, jg):
            assert _max_err(got, want) <= GRAD_TOL


def test_hop_length_mismatch_rejected():
    q = torch.zeros(B, 16, H, D)
    with pytest.raises(ValueError, match="shard-sized"):
        tfa.flash_attention_block(q, q[:, :8], q[:, :8],
                                  tfa.flash_carry_init(q))


def test_hop_schedule_runs_each_causal_pair_once():
    """Over a ring of n, causal: n diagonal hops, n(n-1)/2 pre-diagonal
    ones, the rest skipped; non-causal: every pair full."""
    for n in (1, 2, 4):
        kinds = [kind for idx in range(n)
                 for _, kind in tattn.hop_schedule(idx, n, True)]
        assert kinds.count(tattn.DIAG) == n
        assert kinds.count(tattn.FULL) == n * (n - 1) // 2
        full = [kind for idx in range(n)
                for _, kind in tattn.hop_schedule(idx, n, False)]
        assert full == [tattn.FULL] * (n * n)


# ----------------------------------------------------------------------
# the virtual ring
# ----------------------------------------------------------------------

def _virtual_flash_ring(q, k, v, g, mask, n, causal):
    """(out, dq, dk, dv) of the flash ring of ``n`` ranks run in one
    process by ``virtual_ring_fwd``/``virtual_ring_bwd``, each shard
    padded at its end under the key mask as a real rank pads it."""
    tl = q.shape[1] // n
    shards = [tattn._pad_shards(*(x[:, r * tl:(r + 1) * tl] for x in (q, k, v)),
                                None if mask is None
                                else mask[:, r * tl:(r + 1) * tl])
              for r in range(n)]
    pad = shards[0][4]
    cat = lambda j: (None if shards[0][j] is None          # noqa: E731
                     else torch.cat([s[j] for s in shards], dim=1))
    gp = torch.cat([torch.nn.functional.pad(
        g[:, r * tl:(r + 1) * tl], (0, 0, 0, 0, 0, pad)) for r in range(n)],
        dim=1)
    qp, kp, vp, mp = cat(0), cat(1), cat(2), cat(3)
    out, lse = tattn.virtual_ring_fwd(qp, kp, vp, mp, n, causal=causal)
    grads = tattn.virtual_ring_bwd(qp, kp, vp, mp, out, lse, gp, n,
                                   causal=causal)
    return tuple(torch.cat([x[:, r * (tl + pad):r * (tl + pad) + tl]
                            for r in range(n)], dim=1).numpy()
                 for x in (out,) + grads)


def test_cpu_routes_plain_and_flag_forces_flash(monkeypatch):
    monkeypatch.delenv("DL4JTPU_FLASH_ATTENTION", raising=False)
    assert not tattn.ring_flash_available(4, torch.device("cpu"), 64)
    assert tattn.ring_flash_available(4, torch.device("cuda"), 64)
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "1")
    assert tattn.ring_flash_available(4, torch.device("cpu"), 64)
    monkeypatch.setenv("DL4JTPU_FLASH_ATTENTION", "0")
    assert not tattn.ring_flash_available(4, torch.device("cuda"), 64)


def test_a_failing_kernel_raises_and_never_falls_back(monkeypatch):
    """The flash route on a device path whose kernel fails raises; it does
    not carry on in the plain route."""
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("flash_fwd kernel launch failed: CUDA error 700")
    monkeypatch.setattr(tfa, "_device_path", lambda q: True)
    monkeypatch.setattr(tfa, "_flash_fwd_cuda", broken)
    q, k, v, g, mask = (torch.from_numpy(a) for a in _ring_inputs())
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _virtual_flash_ring(q, k, v, g, None, 2, causal=True)
    assert calls == [1]


def test_a_process_group_that_cannot_form_raises():
    """No card: an NCCL group raises instead of forming over gloo."""
    from deeplearning4j_tpu_torch.parallel import distributed
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize("localhost:1", num_processes=2, process_id=0,
                               device="cuda")
    assert not torch.distributed.is_initialized()


# ----------------------------------------------------------------------
# a real ring over gloo process groups
# ----------------------------------------------------------------------

def _spawn(world, out_dir, timeout=240):
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(r),
         str(world), str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)
    return dict(np.load(os.path.join(out_dir, "rank0.npz")))


@pytest.fixture(scope="module", params=[2, 4], ids=["ring2", "ring4"])
def gloo_ring(request, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp(f"ring{request.param}")
    np.savez(out_dir / "inputs.npz",
             **dict(zip(("q", "k", "v", "g", "mask"), _ring_inputs())))
    return _spawn(request.param, str(out_dir))


@pytest.mark.parametrize("case", RING_CASES,
                         ids=[_case_id(c) for c in RING_CASES])
def test_gloo_ring_matches_dense_reference(case, gloo_ring, dense_oracle):
    causal, masked, impl = case
    key = _case_id(case)
    want = dense_oracle[(causal, masked)]
    assert _max_err(gloo_ring[f"{key}/out"], want[0]) <= OUT_TOL
    for name, w in zip(("dq", "dk", "dv"), want[1:]):
        assert _max_err(gloo_ring[f"{key}/{name}"], w) <= GRAD_TOL


def test_gloo_ring_matches_the_virtual_ring_bitwise(gloo_ring):
    """The real ring and the virtual one run the same block pairs in the
    same order through the same entries."""
    q, k, v, g, mask = (torch.from_numpy(a) for a in _ring_inputs())
    world = int(gloo_ring["world"])
    for case in RING_CASES:
        causal, masked, impl = case
        if impl != "flash":
            continue
        got = _virtual_flash_ring(q, k, v, g, mask if masked else None,
                                  world, causal)
        key = _case_id(case)
        for name, x in zip(("out", "dq", "dk", "dv"), got):
            np.testing.assert_array_equal(gloo_ring[f"{key}/{name}"], x)


def _child(rank: int, world: int, out_dir: str) -> None:
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import collectives, create_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdv",
                            rank=rank, world_size=world)
    mesh = create_mesh({"seq": world}, device_type="cpu")
    group = mesh.get_group("seq")
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    tl = T // world
    sl = slice(rank * tl, (rank + 1) * tl)
    results = {"world": np.asarray(world)}
    for case in RING_CASES:
        causal, masked, impl = case
        q, k, v = (torch.tensor(data[n][:, sl], requires_grad=True)
                   for n in ("q", "k", "v"))
        m = torch.from_numpy(data["mask"][:, sl]) if masked else None
        out = tattn.ring_attention(q, k, v, group=group, causal=causal,
                                   mask=m, impl=impl)
        grads = torch.autograd.grad(out, (q, k, v),
                                    torch.from_numpy(data["g"][:, sl]))
        key = _case_id(case)
        for name, x in zip(("out", "dq", "dk", "dv"), (out.detach(),) + grads):
            results[f"{key}/{name}"] = collectives.all_gather_dim(
                x.contiguous(), group, 1).numpy()
    if rank == 0:
        np.savez(os.path.join(out_dir, "rank0.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_carry_kernels_match_their_plain_versions(cuda_device, causal):
    """f32 kernel instances at a hop shape: each entry on CUDA tensors
    against the same entry on CPU copies (the plain versions)."""
    gen = torch.Generator().manual_seed(3)
    b, t, h, d = 2, 256, 4, 64
    q, k, v, g = (torch.randn(b, t, h, d, generator=gen) for _ in range(4))
    mask = torch.ones(b, t)
    mask[1, 200:] = 0.0
    res = {}
    for dev in ("cpu", cuda_device):
        x = [a.to(dev) for a in (q, k, v, g, mask)]
        c = tfa.flash_attention_block(x[0], x[1], x[2],
                                      tfa.flash_carry_init(x[0]),
                                      causal=causal, mask=x[4])
        out, lse = tfa.flash_carry_finalize(c)
        grads = tfa.flash_attention_bwd_block(x[0], x[1], x[2], out, lse,
                                              x[3], causal=causal, mask=x[4])
        res[str(dev)] = [a.cpu() for a in (out, lse) + tuple(grads)]
    for got, want in zip(res[str(cuda_device)], res["cpu"]):
        assert _max_err(got, want) <= GRAD_TOL


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
