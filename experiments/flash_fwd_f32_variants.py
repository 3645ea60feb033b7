"""Tile sizes of the f32 (3xTF32) flash forward, and the kernel it replaced,
timed on the card.

    python3 experiments/flash_fwd_f32_variants.py [--parent DIR]

Builds text-edited copies of deeplearning4j_tpu_torch/ops/csrc/
flash_fwd_f32.cu (one nvcc each, all at once, under build/variants_f32/)
and times each kernel in turns with the one as committed, on the scratch
of one pre-pass, at [8, 2048, 12, 64] and [8, 2048, 6, 128] causal f32 (the
flagship's d_model), beside scaled_dot_product_attention in f32. Every
variant is checked against the plain forward first (out and lse within
chip_smoke.TOL_F32), and its out and lse errors are printed apart, on the
monolithic call and through the virtual 4-rank ring (chip_smoke.RING, its
forward). Variants (the committed sizes: keys per tile C 64 at d = 64 and
32 at d = 128, 2 ring slots, keys per P·V product KC 32 and 16, S summed
in SK = 4 parts of d):

- slots_4_3: rings of 4 slots at d = 64 and 3 at d = 128 (as many as fit);
- slots_3: rings of 3 slots;
- kc_whole: P·V of a whole tile in one product (KC = C), all of its P
  fragments live at once;
- kc_16, kc_8: P·V in products of 16 or 8 keys at both head dims;
- keys_32: key tiles of 32 at d = 64 too;
- keys_64: key tiles of 64 at d = 128 too, with one ring slot (its Q and
  one 64-key item fill the shared memory);
- s_one: S in one accumulator over all of d (SK = 1);
- s_two: S in two parts of d (SK = 2).

With ``--parent DIR`` (a checkout unpacked with ``git archive``, e.g. the
tree before this kernel) it also builds DIR's flash_fwd.cu and runs its f32
entry (``flash_fwd(dtype=0, ...)``, the signature of the SIMT kernel's
tree) through the same error checks, and times the wrapper's call and the
ring's forward of both kernels in turns: parent, this, this, parent.

Prints each variant's registers and spills, one line per shape and, last,
a JSON object of the readings (ms over three turns), with the card's name
and power limit. Needs one card and nvcc; imports nothing of JAX.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

if not torch.cuda.is_available():
    print("flash_fwd_f32_variants: no CUDA device available", file=sys.stderr)
    sys.exit(1)

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.ops import _nvcc  # noqa: E402
from deeplearning4j_tpu_torch.ops import attention as tattn  # noqa: E402
from deeplearning4j_tpu_torch.ops import flash_attention as fa  # noqa: E402

SHAPES = ((8, 2048, 12, 64), (8, 2048, 6, 128))
TURNS, ITERS = 3, 20
C = "  static constexpr int C = D == 64 ? 64 : 32;"
SLOTS = "  static constexpr int SLOTS = 2;"
KC = "  static constexpr int KC = D == 64 ? 32 : 16;"
SK = "constexpr int SK = 4;"
OUT = ROOT / "build" / "variants_f32"


def edit(text, edits):
    """``text`` with each (old, new) replaced; each old must occur once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"variant edit does not apply: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants(src):
    return {
        "slots_4_3": edit(src, [(SLOTS, SLOTS.replace("2;", "D == 64 ? 4 : 3;"))]),
        "slots_3": edit(src, [(SLOTS, SLOTS.replace("2;", "3;"))]),
        "kc_whole": edit(src, [(KC, KC.replace("32 : 16", "64 : 32"))]),
        "kc_16": edit(src, [(KC, KC.replace("32 : 16", "16 : 16"))]),
        "kc_8": edit(src, [(KC, KC.replace("32 : 16", "8 : 8"))]),
        "keys_32": edit(src, [(C, C.replace("64 : 32", "32 : 32"))]),
        "keys_64": edit(src, [(C, C.replace("64 : 32", "64 : 64")),
                              (SLOTS, SLOTS.replace("2;", "D == 64 ? 2 : 1;"))]),
        "s_one": edit(src, [(SK, SK.replace("4;", "1;"))]),
        "s_two": edit(src, [(SK, SK.replace("4;", "2;"))]),
    }


def start_build(name, source, headers):
    """nvcc on ``source`` in a directory of its own beside ``headers``."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "kernel.cu").write_text(source)
    for h in headers:
        (out / h.name).write_text(h.read_text())
    cmd = [_nvcc.nvcc_path(), *_nvcc.NVCC_FLAGS, "-o", str(out / "lib.so"),
           str(out / "kernel.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def finish_build(name, out, proc, entry, argtypes):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    fn = getattr(ctypes.CDLL(str(out / "lib.so")), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    report = {k: v for k, v in cs.ptxas_report(log).items()
              if k.startswith("flash_fwd_f32<")}
    return fn, report


def kernel_call(fn, split, q):
    """A launch of an f32 forward entry ``fn`` on the pre-pass's scratch,
    into buffers of its own; returns the call and its (out, lse)."""
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    args = (d, split.data_ptr(), None, out.data_ptr(), lse.data_ptr(), b, t,
            h, d ** -0.5, 1)

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd_f32 variant launch failed: {err}")
    return call, (out, lse)


def variant_fwd(fn):
    """A variant's f32 forward as a ``_flash_fwd_cuda`` route: the
    committed pre-pass, then the variant's kernel entry."""
    def fwd(q, k, v, mask, causal, scale):
        b, t, h, d = q.shape
        mask = fa._kernel_mask(mask, q.device)
        split = fa._flash_fwd_split_cuda(q, k, v)
        out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
        lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        err = fn(d, split.data_ptr(), fa._ptr(mask), out.data_ptr(),
                 lse.data_ptr(), b, t, h, float(scale), int(bool(causal)),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd_f32 variant launch failed: {err}")
        return out, lse
    return fwd


def parent_fwd(fn):
    """The parent tree's f32 forward as a ``_flash_fwd_cuda`` route: its
    one-kernel entry ``flash_fwd(dtype, d, ...)`` on the strided views."""
    def fwd(q, k, v, mask, causal, scale):
        b, t, h, d = q.shape
        mask = fa._kernel_mask(mask, q.device)
        out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
        lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        err = fn(0, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 fa._ptr(mask), out.data_ptr(), lse.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], b, t, h,
                 float(scale), int(bool(causal)),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's flash_fwd failed: {err}")
        return out, lse
    return fwd


def errors(out, lse, ref_out, ref_lse):
    """max|d| of out and of lse; a row with no key (lse NEG_INF on both
    sides, each in its own precision) counts 0."""
    dead = (ref_lse <= fa.NEG_INF / 2) & (lse <= fa.NEG_INF / 2)
    d_lse = torch.where(dead, 0.0, lse.double() - ref_lse.double())
    return {"out": (out.double() - ref_out.double()).abs().max().item(),
            "lse": d_lse.abs().max().item()}


def dense64(q, k, v, mask=None):
    """Causal attention of [b, t, h, d] inputs in float64, head by head,
    with an optional [b, t] key mask: (out [b, t, h, d], lse [b, h, t]),
    the exact values to the f32 ones (rows with no key: 0 and NEG_INF)."""
    t = q.shape[1]
    keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()[None]
    if mask is not None:
        keep = keep & (mask > 0)[:, None, :]
    outs, lses = [], []
    for i in range(q.shape[2]):
        qh, kh, vh = (x[:, :, i].double() for x in (q, k, v))
        s = (qh @ kh.transpose(1, 2)) * q.shape[-1] ** -0.5
        s = s.masked_fill(~keep, float("-inf"))
        lse = torch.logsumexp(s, -1)
        p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
        outs.append(p @ vh)
        lses.append(torch.where(torch.isinf(lse), fa.NEG_INF, lse))
        del s, p
    return torch.stack(outs, 2), torch.stack(lses, 1)


def ring_inputs():
    """The virtual ring's operands as chip_smoke.ring_case draws them:
    {"none": (q, k, v, None), "ragged": (q, k, v, mask)} (the ragged mask
    with a batch row of no key and a tail over two shards)."""
    b, t, h, d = (cs.RING[k] for k in ("B", "T", "H", "D"))
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 11)
    cases = {}
    for kind in ("none", "ragged"):
        q, k, v, _ = (torch.randn((b, t, h, d), generator=gen, device=cs.DEV)
                      for _ in range(4))
        mask = None
        if kind == "ragged":
            mask = (torch.rand((b, t), generator=gen, device=cs.DEV)
                    > 0.25).float()
            mask[1] = 0.0
            mask[0, t // 2:] = 0.0
        cases[kind] = (q, k, v, mask)
    return cases


def worst_elements(out, plain_out, exact_out, top=3):
    """The ``top`` elements where ``out`` is furthest from the plain
    version's: [(|out - plain|, out - f64, plain - f64, (b, row, h, col))],
    which says whose error makes up the difference."""
    d = (out.double() - plain_out.double()).abs()
    found = []
    for idx in d.flatten().topk(top).indices.tolist():
        at = tuple(int(i) for i in torch.unravel_index(torch.tensor(idx),
                                                       d.shape))
        found.append((d[at].item(), (out[at].double() - exact_out[at]).item(),
                      (plain_out[at].double() - exact_out[at]).item(), at))
    return found


def route_errors(routes):
    """{route: {case: {"out", "lse"}}}: each ``_flash_fwd_cuda`` route's
    forward at the ring's shape against the plain version (the gates'
    reference) and against the float64 forward ("_f64"; "plain" is the
    plain version itself): on a monolithic call on strided qkv slices
    ("mono") and through the virtual ring on its unmasked and ragged
    operands ("ring", "ring_ragged"); for the committed kernel also the
    ring's elements furthest from the plain version (worst_elements)."""
    b, t, h, d, n = (cs.RING[k] for k in ("B", "T", "H", "D", "ranks"))
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 12)
    cases = {"mono": (*cs.make_qkv(gen, b, t, h, d, torch.float32), None)}
    for kind, ops in ring_inputs().items():
        cases["ring" if kind == "none" else "ring_ragged"] = ops
    plain = {c: fa.flash_attention_fwd_plain(*ops, causal=True)
             for c, ops in cases.items()}
    exact = {c: dense64(*ops) for c, ops in cases.items()}
    saved, errs = fa._flash_fwd_cuda, {"plain": {}}
    for c in cases:
        errs["plain"][c + "_f64"] = errors(*plain[c], *exact[c])
    try:
        for name, route in routes.items():
            fa._flash_fwd_cuda = route
            errs[name] = {}
            for c, ops in cases.items():
                if c == "mono":
                    got = fa.flash_attention_fwd(*ops, causal=True)
                else:
                    out, lse = tattn.virtual_ring_fwd(*ops, n, causal=True)
                    got = (out, lse.transpose(1, 2))
                errs[name][c] = errors(*got, *plain[c])
                errs[name][c + "_f64"] = errors(*got, *exact[c])
                if name == "committed" and c != "mono":
                    errs[name][c + "_worst"] = worst_elements(
                        got[0], plain[c][0], exact[c][0])
    finally:
        fa._flash_fwd_cuda = saved
    for c in ("ring", "ring_ragged"):
        print(f"committed, {c}: the elements furthest from the plain "
              "version (|this - plain|, this - f64, plain - f64, (b, row, "
              "h, col)): " + "; ".join(
                  f"{x:.4g}, {y:+.4g}, {z:+.4g}, {at}"
                  for x, y, z, at in errs["committed"].pop(c + "_worst")))
    for name, e in errs.items():
        print(f"{name}: max|d| at [{b}, {t}, {h}, {d}] causal f32, out/lse"
              + "".join(f"; {key} {x['out']:.4g}/{x['lse']:.4g}"
                        for key, x in e.items())
              + " (mono: a monolithic call, ring: the virtual "
              f"{n}-rank ring, unmasked and ragged; against the plain "
              "version, or _f64 the float64 forward)")
    return errs


def parent_times(parent):
    """The wrapper's call and the virtual ring's forward with the parent's
    kernel and with this one, in turns: parent, this, this, parent."""
    routes = {"parent": parent_fwd(parent), "this": fa._flash_fwd_cuda}
    b, t, h, d, n = (cs.RING[k] for k in ("B", "T", "H", "D", "ranks"))
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 11)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=cs.DEV)
               for _ in range(3))
    qkv = cs.make_qkv(gen, b, t, h, d, torch.float32)
    saved, times = fa._flash_fwd_cuda, {"mono": {}, "ring": {}}
    try:
        for name in ("parent", "this", "this", "parent"):
            fa._flash_fwd_cuda = routes[name]
            times["mono"].setdefault(name, []).append(cs.cuda_ms(
                lambda: fa.flash_attention_fwd(*qkv, None, causal=True), 10))
            times["ring"].setdefault(name, []).append(cs.cuda_ms(
                lambda: tattn.virtual_ring_fwd(q, k, v, None, n,
                                               causal=True), 5))
    finally:
        fa._flash_fwd_cuda = saved
    for name in routes:
        print(f"{name}: wrapper " + "/".join(
            f"{x:.4f}" for x in times["mono"][name]) + " ms, ring forward "
            + "/".join(f"{x:.4f}" for x in times["ring"][name]) + " ms")
    return times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    _nvcc.build_all()
    lib = _nvcc.LIBRARIES["flash_fwd_f32"]
    headers = sorted(_nvcc.CSRC.glob("*.cuh"))
    procs = {name: start_build(name, text, headers)
             for name, text in variants(lib.source.read_text()).items()}
    if args.parent is not None:
        csrc = args.parent / "deeplearning4j_tpu_torch" / "ops" / "csrc"
        procs["parent"] = start_build(
            "parent", (csrc / "flash_fwd.cu").read_text(),
            sorted(csrc.glob("*.cuh")))
    fns, reports = {"committed": fa.FLASH_FWD_F32.fn(fa._FWD32_ARGS)}, {}
    reports["committed"] = {k: v for k, v in cs.ptxas_report(
        lib.build_log).items() if k.startswith("flash_fwd_f32<")}
    parent = None
    for name, (out, proc) in procs.items():
        if name == "parent":
            parent, reports[name] = finish_build(
                name, out, proc, "flash_fwd",
                [ctypes.c_int] + fa._FWD_ARGS)
        else:
            fns[name], reports[name] = finish_build(
                name, out, proc, "flash_fwd_f32", fa._FWD32_ARGS)
    for name, report in reports.items():
        print(f"{name}: " + ", ".join(
            f"{k} {r.get('registers')} registers, {r.get('spill_store_bytes')}"
            " bytes spill stores" for k, r in sorted(report.items())))
    result = {"card": card, "ptxas": reports, "shapes": {}}
    for b, t, h, d in SHAPES:
        gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + 1)
        q, k, v = cs.make_qkv(gen, b, t, h, d, torch.float32)
        split = fa._flash_fwd_split_cuda(q, k, v)
        calls = {name: kernel_call(fn, split, q) for name, fn in fns.items()}
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, None,
                                                        causal=True)
        checked = {}
        for name, (call, (out, lse)) in calls.items():
            call()
            torch.cuda.synchronize()
            checked[name] = errors(out, lse, ref_out, ref_lse)
            if max(checked[name].values()) > cs.TOL_F32:
                raise AssertionError(f"variant {name} at d = {d}: "
                                     f"{checked[name]}")
        del ref_out, ref_lse
        times = {name: [] for name in calls}
        for _ in range(TURNS):
            for name, (call, _) in calls.items():
                times[name].append(cs.cuda_ms(call, ITERS))
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        times["sdpa"] = [cs.cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True),
                                    ITERS) for _ in range(TURNS)]
        result["shapes"][f"{b}x{t}x{h}x{d}"] = {"ms": times,
                                                  "errors": checked}
        print(f"[{b}, {t}, {h}, {d}] causal f32, kernel ms over {TURNS} "
              "turns: " + "; ".join(f"{n} " + "/".join(f"{x:.4f}" for x in ts)
                                    for n, ts in times.items()))
        del split, calls
    routes = {"committed": fa._flash_fwd_cuda,
              **{name: variant_fwd(fn) for name, fn in fns.items()
                 if name != "committed"}}
    if parent is not None:
        routes["parent"] = parent_fwd(parent)
        result["parent_ms"] = parent_times(parent)
    result["errors"] = route_errors(routes)
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
