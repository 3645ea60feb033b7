"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the script exits non-zero:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the flash-attention kernel from deeplearning4j_tpu_torch/ops/csrc
   (a second run reuses the build);
3. kernel vs plain: the flash-attention forward kernel against its plain
   PyTorch version on the same inputs on the card, over head dims, dtypes,
   causal or not, masks (including fully masked rows) and lengths; then
   timed at the flagship shape beside the plain version, the bound, and
   torch's scaled_dot_product_attention (timed only as a yardstick);
4. main path: the flagship transformer LM (d_model 768, 12 layers, 12
   heads, d_ff 3072, V 32768, mixed_bf16) built and initialised by the
   port on the card, one forward over [8, 2048] ids through the kernel —
   which must launch exactly once per layer; every layer's kernel call held
   against the plain version on its own inputs; the vocabulary logits of
   the kernel route held against the plain-kernel and the dense attention
   routes; timed;
5. server: InferenceServer over that model answers concurrent
   POST /predict requests, each equal to net.output on the same ids;
6. a JSON line of the kernels (launches on the main path, error, times,
   bound), the card line, and last {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(1)

from deeplearning4j_tpu_torch.models import transformer_lm  # noqa: E402
from deeplearning4j_tpu_torch.nn.graph_runtime import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.serving import InferenceServer  # noqa: E402

SEED = 20261016
DEV = torch.device("cuda")
# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel vs plain, on the same inputs on the card.
# f32: both accumulate in f32 (TF32 off), only the summation order differs:
# out and lse within 1e-4.
# bf16 out: element by element within fa.bf16_out_tolerance,
# 2^-7·(|out| + (P·|V|)/l) — the kernel rounds P to bf16 for P·V, and both
# sides round out to bf16. With q/k/v ~ N(0, 1) and d = 64 the logits have
# std 1, so |out| is ≈ 1 in the first rows and ≈ 0.04 by row 2000, where
# (P·|V|)/l ≈ 0.8 and the bound is ≈ 0.007. bf16 lse: both sides compute
# it in f32 from the same bf16 q/k: within 1e-3.
TOL_F32 = 1e-4
TOL_LSE = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# Whole forward: the vocabulary logits [8, 2048, 32768] of the kernel route
# against the route whose attention is the plain version (the same network,
# only the kernel swapped) and against the dense attention route (bf16
# logits and softmax inside attention): max|Δ| relative to max|logits| and
# rms(Δ) relative to rms(logits). Every route rounds each layer to bf16, and
# the random-weight network grows that noise over its 12 layers: observed
# (max, rms) on an H100 (PERF.md, PR 1) kernel vs plain (0.0352, 0.0302),
# kernel vs dense (0.0398, 0.0349). The bounds are about twice those; a
# route that leaves one k tile out reads (0.189, 0.1035) and must fail
# them. Each layer's kernel call is held much closer, on its own inputs.
ROUTE_TOL = {"plain": {"max": 0.07, "rms": 0.06},
             "dense": {"max": 0.08, "rms": 0.07}}
# A fault the whole-path check must see: the plain attention with the keys
# [t/2, t/2 + 64) left out, one k tile.
FAULT_KEYS = 64
# /predict against net.output on the same ids: max|Δp| within 4 bf16 ulps
# of the largest p (the same kernel route; only the batch differs).
SERVE_TOL = 2.0 ** -5
ROW_SUM_TOL = 1e-2   # a bf16 softmax row over 32768 classes sums to 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_qkv(gen, b, t, h, d, dtype):
    """q/k/v as the strided [b, t, h, d] slices of one [b, t, 3, h, d]
    projection, the layout the attention layer hands the kernel."""
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device=DEV,
                      dtype=torch.float32).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def make_mask(kind, b, t):
    if kind == "none":
        return None
    m = torch.ones((b, t), device=DEV)
    if kind == "padded":
        m[0, :t // 3 + 5] = 0.0          # leading padding: causal rows
        m[1, :] = 0.0                    # before it see no key; a fully
    else:                                # masked batch row
        g = torch.Generator(device=DEV).manual_seed(SEED)
        m = (torch.rand((b, t), generator=g, device=DEV) > 0.3).float()
    return m


def flash_bound(b, t, h, d, causal, mask, itemsize):
    """(bound_ms, bound_by): the least time for this call's work — each
    input read once, each output written once, and 4·d FLOPs per
    attended (query, key) pair, counted from this call's mask."""
    if mask is None:
        valid = torch.ones((b, t), device=DEV)
    else:
        valid = (mask > 0).float()
    if causal:
        # keys j <= i that are valid: per batch row, sum_i prefix-count(i)
        pairs = torch.cumsum(valid, dim=1).sum().item() * h
    else:
        pairs = valid.sum().item() * t * h
    flops = 4.0 * d * pairs
    nbytes = 4 * b * t * h * d * itemsize + b * h * t * 4
    if mask is not None:
        nbytes += b * t * 4
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def out_error(q, k, v, mask, causal, out, ref_out, scale=None):
    """(max|Δout|, max of |Δout| over its bound): f32 against TOL_F32,
    bf16 element by element against fa.bf16_out_tolerance."""
    err = (out.float() - ref_out.float()).abs()
    if q.dtype == torch.bfloat16:
        bound = fa.bf16_out_tolerance(q, k, v, mask, ref_out, causal=causal,
                                      scale=scale)
    else:
        bound = torch.full_like(err, TOL_F32)
    return err.max().item(), (err / bound).max().item()


def phase_kernel_vs_plain():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    worst = {}
    n_cases = 0
    for t in (256, 2048):
        for d in (64, 128):
            for dtype in (torch.bfloat16, torch.float32):
                for causal in (True, False):
                    for mkind in ("none", "random", "padded"):
                        b, h = 2, 3
                        q, k, v = make_qkv(gen, b, t, h, d, dtype)
                        mask = make_mask(mkind, b, t)
                        out, lse = fa.flash_attention_fwd(
                            q, k, v, mask, causal=causal)
                        ref_out, ref_lse = fa.flash_attention_fwd_plain(
                            q, k, v, mask, causal=causal)
                        e_out, ratio = out_error(q, k, v, mask, causal,
                                                 out, ref_out)
                        e_lse = (lse - ref_lse).abs().max().item()
                        case = f"t={t} d={d} {str(dtype)[6:]} causal={causal} mask={mkind}"
                        if not (ratio <= 1.0 and e_lse <= TOL_LSE[dtype]):
                            raise AssertionError(
                                f"flash kernel disagrees with plain: {case}: "
                                f"max|dout|={e_out:.3g} ({ratio:.3g} of its "
                                f"bound) max|dlse|={e_lse:.3g}")
                        if mkind == "padded":
                            # rows with no attendable key: out 0, lse -1e30
                            dead = [(1, slice(None))]
                            if causal:
                                dead.append((0, slice(0, t // 3 + 5)))
                            for bi, rows in dead:
                                if out[bi, rows].abs().max().item() != 0.0 or \
                                        not bool((lse[bi, :, rows] == fa.NEG_INF).all()):
                                    raise AssertionError(
                                        f"fully masked rows not (0, -1e30): {case}")
                        key = str(dtype)[6:]
                        w = worst.setdefault(key, [0.0, 0.0, 0.0])
                        w[0], w[1] = max(w[0], e_out), max(w[1], ratio)
                        w[2] = max(w[2], e_lse)
                        n_cases += 1
    for key, (e_out, ratio, e_lse) in worst.items():
        out_tol = ("bf16_out_tolerance" if key == "bfloat16"
                   else f"{TOL_F32}")
        print(f"kernel vs plain, {key}: max|dout|={e_out:.6g} (at most "
              f"{ratio:.4g} of the bound {out_tol}) max|dlse|={e_lse:.6g} "
              f"(tolerance {TOL_LSE[getattr(torch, key)]})")
    print(f"kernel vs plain: {n_cases} cases passed")


def phase_flagship_kernel_timing():
    b, t, h, d = 8, 2048, 12, 64
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    q, k, v = make_qkv(gen, b, t, h, d, torch.bfloat16)
    out, _ = fa.flash_attention_fwd(q, k, v, None, causal=True)
    ref, _ = fa.flash_attention_fwd_plain(q, k, v, None, causal=True)
    err, ratio = out_error(q, k, v, None, True, out, ref)
    if not ratio <= 1.0:
        raise AssertionError(f"flagship-shape kernel error {err} is "
                             f"{ratio:.3g} of its bound")
    launches_before = fa.FLASH_FWD.launches
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, None, causal=True), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, None, causal=True), 3, warmup=1)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True), 20)
    fa.FLASH_FWD.launches = launches_before   # timing launches do not count
    bound_ms, bound_by = flash_bound(b, t, h, d, True, None, 2)
    print(f"flash_fwd at [b={b}, t={t}, h={h}, d={d}] causal bf16: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"max|dout| vs plain {err:.6g} ({ratio:.4g} of its bound)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_main_path():
    V, L, D, H, F = 32768, 12, 768, 12, 3072
    conf = transformer_lm(V, n_layers=L, d_model=D, n_heads=H, d_ff=F,
                          dtype="mixed_bf16", input_ids=True)
    t0 = time.perf_counter()
    net = ComputationGraph(conf).init()
    torch.cuda.synchronize()
    print(f"flagship init: {net.num_params()} params on {net.device} in "
          f"{time.perf_counter() - t0:.3f} s")
    ids = np.random.default_rng(SEED).integers(0, V, (8, 2048)).astype(np.int32)
    net.output(ids[:1, :128])          # warm up
    torch.cuda.synchronize()

    fa.FLASH_FWD.launches = 0
    p = net.output(ids)
    torch.cuda.synchronize()
    launches = fa.FLASH_FWD.launches
    if launches != L:
        raise AssertionError(f"main path launched flash_fwd {launches} times, "
                             f"expected {L}")
    if tuple(p.shape) != (8, 2048, V) or p.dtype != torch.bfloat16:
        raise AssertionError(f"output {tuple(p.shape)} {p.dtype}")
    pf = p.float()
    if not bool(torch.isfinite(pf).all()):
        raise AssertionError("non-finite output")
    row_err = (pf.sum(-1) - 1.0).abs().max().item()
    if not row_err <= ROW_SUM_TOL:
        raise AssertionError(f"softmax rows sum off by {row_err}")

    print(f"main path: {launches} flash_fwd launches; output "
          f"{tuple(p.shape)} {p.dtype}, finite; max|row sum - 1|={row_err:.6g}")
    del pf, p

    launches_before = fa.FLASH_FWD.launches
    # every layer's kernel call, on the inputs the main path gave it
    with flash_calls() as calls:
        logits = head_logits(net, ids)
    if len(calls) != L:
        raise AssertionError(f"{len(calls)} flash calls in a forward")
    errs = []
    with torch.inference_mode():
        for q, k, v, mask, causal, scale, out in calls:
            ref, _ = fa.flash_attention_fwd_plain(q, k, v, mask,
                                                  causal=causal, scale=scale)
            errs.append(out_error(q, k, v, mask, causal, out, ref, scale))
    del calls
    print("main path, each layer's kernel call vs plain: max|dout| "
          + ", ".join(f"{e:.4g}" for e, _ in errs)
          + f"; at most {max(r for _, r in errs):.4g} of the bound")
    if not max(r for _, r in errs) <= 1.0:
        raise AssertionError("a main-path kernel call disagrees with plain")

    # the vocabulary logits of the kernel route against the route whose
    # attention is the plain version, the dense route, and a faulty route
    with flash_calls(replace=plain_fwd):
        logits_plain = head_logits(net, ids)
    with flash_calls(replace=faulty_plain_fwd):
        logits_fault = head_logits(net, ids)
    os.environ["DL4JTPU_FLASH_ATTENTION"] = "0"
    try:
        logits_dense = head_logits(net, ids)
    finally:
        del os.environ["DL4JTPU_FLASH_ATTENTION"]
    fa.FLASH_FWD.launches = launches_before   # check launches do not count
    readings = {"plain": route_diff(logits, logits_plain),
                "dense": route_diff(logits, logits_dense),
                "dense vs plain": route_diff(logits_dense, logits_plain),
                "fault": route_diff(logits_fault, logits_plain)}
    print(f"main path logits: max|.| {logits_plain.abs().max().item():.6g}, "
          f"rms {logits_plain.pow(2).mean().sqrt().item():.6g}; relative "
          "(max|d|, rms d) — " + "; ".join(
              f"{name}: ({mx:.4g}, {rms:.4g})"
              for name, (mx, rms) in readings.items())
          + f"; bounds {ROUTE_TOL}")
    del logits, logits_plain, logits_fault, logits_dense
    for name, tol in ROUTE_TOL.items():
        mx, rms = readings[name]
        if not (mx <= tol["max"] and rms <= tol["rms"]):
            raise AssertionError(f"kernel route disagrees with the {name} "
                                 "route")
    mx, rms = readings["fault"]
    if not (mx > ROUTE_TOL["plain"]["max"] and rms > ROUTE_TOL["plain"]["rms"]):
        raise AssertionError("the whole-path check does not see a missing "
                             "k tile")

    fwd_s = forward_seconds(net, ids)
    os.environ["DL4JTPU_FLASH_ATTENTION"] = "0"
    try:
        dense_s = forward_seconds(net, ids)
    finally:
        del os.environ["DL4JTPU_FLASH_ATTENTION"]
    print(f"main path forward [8, 2048]: {fwd_s * 1e3:.3f} ms, "
          f"{ids.size / fwd_s:.1f} tokens/s (dense attention route: "
          f"{dense_s * 1e3:.3f} ms, {ids.size / dense_s:.1f} tokens/s)")
    profile_forward(net, ids)
    fa.FLASH_FWD.launches = launches_before   # timing launches do not count
    return net, launches


@contextlib.contextmanager
def flash_calls(replace=None):
    """Within the block, every flash-attention call on the card goes
    through ``replace(q, k, v, mask, causal, scale)`` instead of the
    kernel; with no ``replace``, the kernel runs and each call's inputs and
    output are recorded in the list the block receives."""
    calls = []
    kernel = fa._flash_fwd_cuda

    def spy(q, k, v, mask, causal, scale):
        if replace is not None:
            return replace(q, k, v, mask, causal, scale)
        out, lse = kernel(q, k, v, mask, causal, scale)
        calls.append((q, k, v, mask, causal, scale, out))
        return out, lse

    fa._flash_fwd_cuda = spy
    try:
        yield calls
    finally:
        fa._flash_fwd_cuda = kernel


def plain_fwd(q, k, v, mask, causal, scale):
    return fa.flash_attention_fwd_plain(q, k, v, mask, causal=causal,
                                        scale=scale)


def faulty_plain_fwd(q, k, v, mask, causal, scale):
    b, t = q.shape[:2]
    keep = torch.ones((b, t), device=q.device) if mask is None else mask.clone()
    keep[:, t // 2:t // 2 + FAULT_KEYS] = 0.0
    return plain_fwd(q, k, v, keep, causal, scale)


def route_diff(a, ref):
    """(max|a - ref| / max|ref|, rms(a - ref) / rms(ref))."""
    d = a - ref
    return ((d.abs().max() / ref.abs().max()).item(),
            (d.pow(2).mean() / ref.pow(2).mean()).sqrt().item())


def head_logits(net, ids):
    """Pre-softmax logits of the vocabulary head, [b, t, V] in f32, from
    the same forward that net.output runs."""
    with torch.inference_mode():
        acts = net._forward([net._to_input(ids)])
        head = net.conf.vertices["out"].layer
        return head.pre_output(net.params["out"], acts["final_ln"],
                               policy=net.policy).float()


def forward_seconds(net, ids, reps=5):
    """Mean wall time of one forward, each ending in a synchronize."""
    net.output(ids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        net.output(ids)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def profile_forward(net, ids, top=10):
    """Device time of one forward by kernel (torch.profiler), largest
    first, and the share of the flash kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.output(ids)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    if not events:
        print("profile: the profiler recorded no device kernels")
        return
    total = sum(e.self_device_time_total for e in events)
    print(f"profile: one forward, {total / 1e3:.3f} ms of device time in "
          f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100.0 * e.self_device_time_total / total:5.1f}% "
              f"x{e.count:<4d} {e.key[:90]}")


def phase_server(net):
    server = InferenceServer(net, max_batch=8, batch_timeout_ms=200.0)
    base = f"http://127.0.0.1:{server.port}"
    rng = np.random.default_rng(SEED + 2)
    reqs = [rng.integers(0, 32768, (1, 128)).astype(np.int32) for _ in range(3)]
    results = [None] * len(reqs)

    def call(i):
        body = json.dumps({"inputs": reqs[i].tolist()}).encode()
        r = urllib.request.Request(base + "/predict", data=body,
                                   method="POST",
                                   headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=300) as resp:
            results[i] = np.asarray(json.loads(resp.read())["outputs"],
                                    dtype=np.float32)

    try:
        before = fa.FLASH_FWD.launches
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if any(th.is_alive() for th in threads) or any(r is None for r in results):
            raise AssertionError("a /predict request did not complete")
        served_launches = fa.FLASH_FWD.launches - before
        if served_launches < 12:
            raise AssertionError(f"server launched flash_fwd {served_launches} times")
        worst = 0.0
        for x, got in zip(reqs, results):
            ref = net.output(x).float().cpu().numpy()
            err = float(np.abs(got - ref).max())
            if not err <= SERVE_TOL * float(ref.max()):
                raise AssertionError(f"/predict differs from output: {err}")
            worst = max(worst, err)
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=30).read())
        if not (health["ok"] and health["served"] == len(reqs)):
            raise AssertionError(f"healthz: {health}")
        print(f"server: {len(reqs)} concurrent /predict answered in "
              f"{server._m_batch_size.count()} model call(s), "
              f"{served_launches} flash_fwd launches, max|dp| vs output "
              f"{worst:.6g} (bound {SERVE_TOL}·max p); healthz served={health['served']}")
    finally:
        server.stop(drain=True, timeout=60)


def main():
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    k = fa.FLASH_FWD
    k.lib()
    print(f"build {k.name}: {k.build_seconds:.3f} s -> {k.library_path()}")
    for ln in k.build_log.splitlines():   # per kernel: registers, spills
        if "Compiling entry function" in ln or "registers" in ln \
                or "spill" in ln:
            print(f"  {ln.strip()}")

    phase_kernel_vs_plain()
    timing = phase_flagship_kernel_timing()
    net, launches = phase_main_path()
    phase_server(net)

    kernels = [{"name": "flash_fwd", "route": "cuda",
                "source": "deeplearning4j_tpu_torch/ops/csrc/flash_fwd.cu",
                "replaces": "deeplearning4j_tpu/ops/flash_attention.py:91",
                "replaces_also": "deeplearning4j_tpu/ops/flash_attention.py:124",
                "tpu_kernels": ["_fwd_kernel_vmem", "_fwd_kernel_stream"],
                "launches": launches, **timing}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
