"""Design variants of the bf16 flash-attention forward, timed on the card.

    python3 experiments/flash_fwd_variants.py

Builds text-edited copies of deeplearning4j_tpu_torch/ops/csrc/flash_fwd.cu
(one nvcc each, all at once, under build/variants/) and times each in turns
with the kernel as committed, at the flagship shape [8, 2048, 12, 64] and at
[8, 2048, 6, 128] (the same d_model), causal, on the strided qkv slices
that chip_smoke.py times. Every variant but no_exp is checked against the
plain forward (bf16_out_tolerance) before it is timed. Variants:

- pingpong: the two consumer warpgroups take turns to issue their products
  (named barriers 3 and 4, 256 threads), FlashAttention-3's ping-pong;
- keys_64_128: the other key-tile size of each head dim (64 keys at d = 64
  with 6 stages, 128 keys at d = 128 with 2 stages);
- stages_2: a ring of 2 stages at d = 64;
- no_exp: P = the exponent, not 2^exponent: the kernel without its MUFU
  work (a wrong result; it times what the exponentials cost).

Prints one line per head dim and, last, a JSON object of the times (ms;
three turns each), with the card's name and power limit. Needs one card
and nvcc; imports nothing of JAX.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

if not torch.cuda.is_available():
    print("flash_fwd_variants: no CUDA device available", file=sys.stderr)
    sys.exit(1)

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.ops import _nvcc  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402

SHAPES = ((8, 2048, 12, 64), (8, 2048, 6, 128))
TURNS, ITERS = 3, 50
TILE_64 = "template <> struct FwdTile<64> { static constexpr int BN = 128, STAGES = 4; };"
TILE_128 = "template <> struct FwdTile<128> { static constexpr int BN = 64, STAGES = 4; };"
EXP = "      s[x] = fast_exp2(fmaf(s[x], sl2, -mu[(x >> 1) & 1]));"
PINGPONG = '''// Ping-pong: named barrier 3 + wg (256 threads) is warpgroup wg's turn to
// issue its products; the other warpgroup passes the turn by arriving.
__device__ __forceinline__ void pingpong_wait(int wg) {
  asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void pingpong_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\\n" ::"r"(4 - wg) : "memory");
}

template <int D>
__device__ __forceinline__ void fwd_produce('''


def edit(text, edits):
    """``text`` with each (old, new) replaced; each old must occur once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"variant edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants(src):
    return {
        "pingpong": edit(src, [
            ("template <int D>\n__device__ __forceinline__ void fwd_produce(",
             PINGPONG),
            ("  issue_s<D, BN>(s, aQ, stage(0) + L::K);\n",
             "  pingpong_wait(wg);\n"
             "  issue_s<D, BN>(s, aQ, stage(0) + L::K);\n"
             "  pingpong_pass(wg);\n"),
            ("    issue_s<D, BN>(s, aQ, stage(i) + L::K);\n"
             "    issue_pv<D, BN>(o, pa, stage(i - 1) + L::V);\n",
             "    pingpong_wait(wg);\n"
             "    issue_s<D, BN>(s, aQ, stage(i) + L::K);\n"
             "    issue_pv<D, BN>(o, pa, stage(i - 1) + L::V);\n"
             "    pingpong_pass(wg);\n"),
            # the second warpgroup goes second; the first takes its last
            # turn back after its last tile, so every arrival is matched
            ("    setmaxnreg_inc<CONSUMER_REGS>();\n",
             "    setmaxnreg_inc<CONSUMER_REGS>();\n"
             "    if (role == 1) pingpong_pass(1);\n"),
            ("      it0 += n_kt;\n    }\n",
             "      it0 += n_kt;\n    }\n"
             "    if (role == 0) pingpong_wait(0);\n")]),
        "keys_64_128": edit(src, [
            (TILE_64, TILE_64.replace("BN = 128, STAGES = 4",
                                      "BN = 64, STAGES = 6")),
            (TILE_128, TILE_128.replace("BN = 64, STAGES = 4",
                                        "BN = 128, STAGES = 2"))]),
        "stages_2": edit(src, [(TILE_64, TILE_64.replace("STAGES = 4",
                                                         "STAGES = 2"))]),
        "no_exp": edit(src, [(EXP, EXP.replace("fast_exp2(", "("))]),
    }


def build(src):
    """{name: (ctypes entry point, ptxas report)} of every variant."""
    procs = {}
    for name, text in variants(src).items():
        out = ROOT / "build" / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "flash_fwd.cu").write_text(text)
        (out / "hopper.cuh").write_text((_nvcc.CSRC / "hopper.cuh").read_text())
        cmd = [_nvcc.nvcc_path(), *_nvcc.NVCC_FLAGS, "-o",
               str(out / "libflash_fwd.so"), str(out / "flash_fwd.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    built = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out / "libflash_fwd.so")).flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = fa._FWD_ARGS
        report = {k: v for k, v in cs.ptxas_report(log).items()
                  if "fwd_bf16" in k}
        built[name] = (fn, report)
    return built


def launcher(fn, q, k, v):
    """A call of entry point ``fn`` on causal bf16 q/k/v, into buffers of
    its own; returns the call and the (out, lse) it writes."""
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    args = (d, q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
            out.data_ptr(), lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], b, t, h, 1.0 / d ** 0.5, 1)

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd variant launch failed: {err}")
    return call, (out, lse)


def main():
    card = cs.card_line()
    _nvcc.build_all()
    built = build(_nvcc.LIBRARIES["flash_fwd"].source.read_text())
    for name, (_, report) in built.items():
        print(f"{name}: " + ", ".join(
            f"{k} {r.get('registers')} registers, {r.get('spill_store_bytes')} "
            "bytes spill stores" for k, r in sorted(report.items())))
    fns = {"committed": fa.FLASH_FWD.fn(fa._FWD_ARGS),
           **{name: fn for name, (fn, _) in built.items()}}
    result = {"card": card, "shapes": {}}
    for b, t, h, d in SHAPES:
        gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 1)
        q, k, v = cs.make_qkv(gen, b, t, h, d, torch.bfloat16)
        calls = {name: launcher(fn, q, k, v) for name, fn in fns.items()}
        ref, _ = fa.flash_attention_fwd_plain(q, k, v, None, causal=True)
        bound = fa.bf16_out_tolerance(q, k, v, None, ref, causal=True)
        checked = {}
        for name, (call, (out, _)) in calls.items():
            call()
            torch.cuda.synchronize()
            if name != "no_exp":
                ratio = ((out.float() - ref.float()).abs() / bound).max().item()
                if not ratio <= 1.0:
                    raise AssertionError(f"variant {name} at d = {d}: "
                                         f"{ratio:.3g} of the bound")
                checked[name] = ratio
        del ref, bound
        times = {name: [] for name in calls}
        for _ in range(TURNS):
            for name, (call, _) in calls.items():
                times[name].append(cs.cuda_ms(call, ITERS))
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        times["sdpa"] = [cs.cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True),
                                    ITERS) for _ in range(TURNS)]
        result["shapes"][f"{b}x{t}x{h}x{d}"] = {"ms": times,
                                                  "err_over_tolerance": checked}
        print(f"[{b}, {t}, {h}, {d}] causal bf16, ms over {TURNS} turns: "
              + "; ".join(f"{n} " + "/".join(f"{x:.4f}" for x in ts)
                          for n, ts in times.items()))
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
