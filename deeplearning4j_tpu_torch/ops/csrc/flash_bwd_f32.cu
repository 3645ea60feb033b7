// Flash-attention backward in f32 for Hopper (sm_90a): 3xTF32 wgmma fed by
// TMA, bound through a plain C interface (ctypes). Three entry points:
//
//   flash_bwd_split_f32  the pre-pass: the tf32 hi/lo splits of q, k, v and
//                        dO, and transposed copies of the splits of q, k and
//                        dO, into one scratch buffer the wrapper allocates.
//                        Replaces no TPU kernel: it lays out the operands the
//                        two kernels below read (see "Layouts").
//   flash_bwd_dq_f32     dq = sum_k dS K. Replaces the Pallas kernel
//                        _bwd_dq_kernel (deeplearning4j_tpu/ops/
//                        flash_attention.py:359; pallas_call :464).
//   flash_bwd_dkv_f32    dk = sum_q dS^T Q and dv = sum_q P^T dO, fused.
//                        Replaces _bwd_dkv_kernel (:391; pallas_call :494).
//
// The f32 instances of the backward: every f32 attention call on the card
// and every hop of the ring (which casts its hops to f32, as the JAX package
// does) run them. They compute what flash_bwd.cu's bf16 kernels compute:
//   P  = exp(S * scale - lse), 0 where the key is masked, past the causal
//        diagonal, or the query row has lse = NEG_INF (no attendable key);
//   dS = P * (dP - Delta) * scale,   dP = dO V^T,
// with Delta = rowsum(dO * O) from flash_bwd.cu's preprocess. Masked keys
// get dk = dv = 0 exactly and rows with no attendable key dq = 0 exactly
// (P = 0 there, so every term added is an exact zero). Each block owns its
// output tile and sums in a fixed order with no atomics: two launches give
// the same bits.
//
// Precision: 3xTF32 (tf32.cuh, shared with flash_fwd_f32.cu).
//
// Bound at [8, 2048, 12, 64] causal (b*h*t*(t+1)/2 = 201M attended pairs):
// dq does S, dP and dS K, 6 d FLOPs a pair, 77.3 GFLOP; dk/dv 8 d, 103.1
// GFLOP. Three tf32 products per f32 product at
// 495 TFLOP/s (dense TF32) make 165 TFLOP/s: 0.469 and 0.625 ms, against
// 1.15 and 1.54 ms at 67 TFLOP/s of FFMA. Each moves 0.25-0.35 GB of its
// inputs and outputs (0.08-0.1 ms at 3.35 TB/s): compute-bound. The
// pre-pass reads 4 and writes 14 tensors of 50 MB: 0.27 ms at 3.35 TB/s,
// bandwidth-bound.
//
// Layouts (tf32.cuh). S = Q K^T and dP = dO V^T read Q, K, dO and V as
// they are stored (d contiguous), but dq = dS K, dk = dS^T Q and dv = P^T dO
// reduce over keys or queries, so they need K, Q and dO transposed. The
// pre-pass writes, per (b, h), planes of t x d floats: hi and lo of q, k,
// v, dO row by row ([t][d]), and hi and lo of q, k, dO transposed ([d][t],
// t permuted within groups of 8 for the register A operand).
//
// Design (d = 64 or 128). A block is 384 threads: two consumer warpgroups
// (232 registers a thread, setmaxnreg) and a producer warpgroup whose first
// thread issues every TMA load (40 registers).
//   * dq: one block per (b*h, 64-row q tile), heaviest tiles first under
//     causal; the hi and lo of Q and dO (64 rows) are loaded once. dk/dv:
//     one block per (b*h, 64-key tile), K and V loaded once, query tiles
//     from the causal diagonal on (pre-diagonal ones are skipped, loads and
//     math, as the reference's clamped index map skips their loads).
//   * The streamed rows (keys for dq, queries for dk/dv) come in tiles of C
//     (64 at d = 64, 32 at d = 128) through a ring of shared-memory slots
//     on full/empty mbarriers. A tile is two items in ring order: first the
//     row planes S and dP read (with lse and Delta for dk/dv), then the
//     transposed planes of the last products; each slot is released as soon
//     as its products are done, so the next tile's loads overlap this
//     tile's last products. An f32 64-row tile with its hi and lo is 32 KB
//     (d = 64) or 64 KB (d = 128), so the block holds 64 rows, not the bf16
//     kernels' 128, and 2 slots (d = 64) or 1 (d = 128; its loads do not
//     overlap its math) within the 227 KB.
//   * Both warpgroups use the same 64 stationary rows as the A operand of S
//     and dP; warpgroup w takes the streamed rows [w C/2, (w + 1) C/2) of
//     each tile (N = 32 or 16) and keeps its own output accumulator in
//     registers. At the end warpgroup 1 stages its partial in shared memory
//     and warpgroup 0 adds it (a fixed order) and writes the tile.
//   * S and dP: m64nNk8 wgmma, both operands from shared memory, S summed
//     in SK = 4 parts of d as the forward's (product_ss_parts); P from
//     lse with expf, dS in f32; the mask, causal and dead-row predicates run
//     only on diagonal tiles or under a key mask. P and dS are split into
//     hi/lo tf32 fragments in registers (cvt.rna) and are the register A
//     operand of the last products (m64n64k8, one or two per tile).
//   * The accumulators stay in registers: 32 or 64 floats of dq, or of each
//     of dk and dv, a thread. The last products are taken tile by tile into
//     a fresh 64-column accumulator and added with FADD (see product_rs).

#include <math.h>

#include "tf32.cuh"

namespace {

using namespace hopper;

constexpr float HALF_NEG = -5e29f;   // NEG_INF / 2, NEG_INF = -1e30

// planes of the scratch buffer: (tensor, part) -> 2 * tensor + part, each
// [b*h][t * d] floats
enum Plane { Q = 0, K = 1, V = 2, O = 3, QT = 4, KT = 5, OT = 6, PLANES = 14 };

// parts of d that S is summed in (tf32.cuh, product_ss_parts; the same as
// the forward's, flash_fwd_f32.cu, so that P = exp(S scale - lse) meets
// the S that lse was taken from)
constexpr int SK = 4;

struct F32Params {
  const float* mask;    // [b, t] or nullptr (every key valid)
  const float* lse;     // [b, h, t] contiguous
  const float* delta;   // [b, h, t] contiguous
  float* g0;            // dq (dq pass) or dk (dk/dv pass), [b, t, h, d]
  float* g1;            // dv (dk/dv pass)
  int b, t, h;
  float scale;
  int causal;
};

// streamed rows per tile and ring slots, by head dim
template <int D>
struct Geom {
  static constexpr int C = D == 64 ? 64 : 32;
  static constexpr int N = C / 2;      // streamed rows per warpgroup
  static constexpr int SLOTS = D == 64 ? 2 : 1;
  static constexpr int T64 = R * D * 4;   // one 64-row plane tile
  static constexpr int TC = C * D * 4;    // one C-row (or d x C) plane tile
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// Warpgroup 1's partial (64 x D, accumulator layout) into `scratch`, then
// warpgroup 0 adds it to its own and writes the rows [r0, r0 + 64) of
// head (bi, hi) of the contiguous [b, t, h, D] output.
template <int D>
__device__ __forceinline__ void reduce_store(float* acc, uint32_t scratch,
                                             float* out, const F32Params& p,
                                             int bi, int hi, int r0, int wg) {
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      st_shared_u32(scratch + (i * 128 + tw) * 4, __float_as_uint(acc[i]));
  }
  consumers_sync();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    float other;
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(other)
                 : "r"(scratch + (i * 128 + tw) * 4)
                 : "memory");
    acc[i] += other;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + warp * 16 + g + 8 * hr;
      *reinterpret_cast<float2*>(
          out + (((long long)bi * p.t + row) * p.h + hi) * D + 8 * j +
          2 * t4) = make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
}

// ---------------------------------------------------------------------------
// pre-pass: tf32 splits and transposed copies
// ---------------------------------------------------------------------------

// One block per (b*h, 32 rows, tensor): q, k, v and dO row by row, and q,
// k and dO transposed (tf32.cuh).
template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
flash_bwd_split_f32_kernel(SplitParams p) {
  split_rows<D>(p);
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  using G = Geom<D>;
  static constexpr int QH = 0, QL = G::T64, OH = 2 * G::T64, OL = 3 * G::T64;
  static constexpr int SLOT0 = 4 * G::T64;
  // item A: K and V hi/lo (C rows); item B: K^T hi/lo (D rows x C)
  static constexpr int KH = 0, KL = G::TC, VH = 2 * G::TC, VL = 3 * G::TC;
  static constexpr int TH = 0, TL = G::TC;
  static constexpr int SLOT = 4 * G::TC;
  static constexpr int TX_A = 4 * G::TC, TX_B = 2 * G::TC;
  static constexpr int BARS = SLOT0 + G::SLOTS * SLOT;
  static constexpr int BYTES = BARS + RingBars<G::SLOTS>::BYTES + 1024;
  static_assert(BYTES <= 232448, "dq shared memory");
};

template <int D>
__device__ __forceinline__ void dq_produce(uint32_t base,
                                           const RingBars<Geom<D>::SLOTS>& bar,
                                           const CUtensorMap* tm_r,
                                           const CUtensorMap* tm_c,
                                           const CUtensorMap* tm_t, int q0,
                                           int n_kt, int bh, int bhs) {
  using G = Geom<D>;
  using L = DqSmem<D>;
  mbar_expect_tx(bar.once, 4 * G::T64);
  load_plane_rows<D>(base + L::QH, tm_r, R, q0, plane_z(Q, 0, bh, bhs), bar.once);
  load_plane_rows<D>(base + L::QL, tm_r, R, q0, plane_z(Q, 1, bh, bhs), bar.once);
  load_plane_rows<D>(base + L::OH, tm_r, R, q0, plane_z(O, 0, bh, bhs), bar.once);
  load_plane_rows<D>(base + L::OL, tm_r, R, q0, plane_z(O, 1, bh, bhs), bar.once);
  for (int n = 0; n < 2 * n_kt; ++n) {
    const int s = n % G::SLOTS, k0 = (n / 2) * G::C;
    const uint32_t st = base + L::SLOT0 + s * L::SLOT, full = bar.full + 8 * s;
    mbar_wait(bar.empty + 8 * s, ((n / G::SLOTS) & 1) ^ 1);
    if ((n & 1) == 0) {
      mbar_expect_tx(full, L::TX_A);
      load_plane_rows<D>(st + L::KH, tm_c, G::C, k0, plane_z(K, 0, bh, bhs), full);
      load_plane_rows<D>(st + L::KL, tm_c, G::C, k0, plane_z(K, 1, bh, bhs), full);
      load_plane_rows<D>(st + L::VH, tm_c, G::C, k0, plane_z(V, 0, bh, bhs), full);
      load_plane_rows<D>(st + L::VL, tm_c, G::C, k0, plane_z(V, 1, bh, bhs), full);
    } else {
      mbar_expect_tx(full, L::TX_B);
      load_plane_cols<D, G::C>(st + L::TH, tm_t, k0, plane_z(KT, 0, bh, bhs), full);
      load_plane_cols<D, G::C>(st + L::TL, tm_t, k0, plane_z(KT, 1, bh, bhs), full);
    }
  }
}

template <int D>
__device__ __forceinline__ void dq_consume(uint32_t base,
                                           const RingBars<Geom<D>::SLOTS>& bar,
                                           const F32Params& p, int q0,
                                           int n_kt, int bh, int bi, int hi) {
  using G = Geom<D>;
  using L = DqSmem<D>;
  constexpr int N = G::N;
  const int wg = threadIdx.x >> 7;
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;
  const float* mg = p.mask ? p.mask + (long long)bi * p.t : nullptr;

  int row[2];
  float lse[2], dl[2];
  bool live[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    row[hr] = q0 + warp * 16 + g + 8 * hr;
    lse[hr] = p.lse[(long long)bh * p.t + row[hr]];
    dl[hr] = p.delta[(long long)bh * p.t + row[hr]];
    live[hr] = !(lse[hr] <= HALF_NEG);
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(bar.once, 0);

  for (int i = 0; i < n_kt; ++i) {
    const int na = 2 * i, nb = 2 * i + 1;
    const int sa = na % G::SLOTS, sb = nb % G::SLOTS;
    const uint32_t slot_a = base + L::SLOT0 + sa * L::SLOT;
    const uint32_t slot_b = base + L::SLOT0 + sb * L::SLOT;
    const int kw0 = i * G::C + wg * N;   // this warpgroup's first key
    mbar_wait(bar.full + 8 * sa, (na / G::SLOTS) & 1);
    float sacc[N / 2], pacc[N / 2], tacc[N / 2];
    // S = Q K^T over this warpgroup's N keys (waited for), then dP = dO V^T
    // issued
    product_ss_parts<D, N, SK>(sacc, tacc, base + L::QH, base + L::QL,
                               slot_a + L::KH + wg * N * 128,
                               slot_a + L::KL + wg * N * 128, G::C);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) pacc[j] = 0.f;
    fence_regs<N / 2>(pacc);
    wgmma_fence();
    product_ss<D, N>(pacc, base + L::OH, base + L::OL,
                     slot_a + L::VH + wg * N * 128,
                     slot_a + L::VL + wg * N * 128, G::C);
    wgmma_commit();
    if (mg != nullptr || (p.causal && kw0 + N - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kw0 + 8 * j + 2 * t4 + e;
          const bool key_ok = mg == nullptr || mg[col] > 0.f;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int x = 4 * j + 2 * hr + e;
            const bool ok = key_ok && live[hr] && !(p.causal && col > row[hr]);
            sacc[x] = ok ? expf(__fsub_rn(__fmul_rn(sacc[x], p.scale), lse[hr]))
                         : 0.f;
          }
        }
    } else {
#pragma unroll
      for (int x = 0; x < N / 2; ++x) {
        const int hr = (x >> 1) & 1;
        sacc[x] = live[hr]
                      ? expf(__fsub_rn(__fmul_rn(sacc[x], p.scale), lse[hr]))
                      : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs<N / 2>(pacc);
    mbar_arrive(bar.empty + 8 * sa);   // K and V are read no more
    // dS = P (dP - Delta) scale, split into the A fragments of dS K
#pragma unroll
    for (int x = 0; x < N / 2; ++x)
      pacc[x] = __fmul_rn(__fmul_rn(sacc[x], __fsub_rn(pacc[x], dl[(x >> 1) & 1])),
                          p.scale);
    uint32_t ahi[N / 8][4], alo[N / 8][4];
    split_frags<N>(ahi, alo, pacc);
    mbar_wait(bar.full + 8 * sb, (nb / G::SLOTS) & 1);
    product_rs<D, N>(dq, ahi, alo, slot_b + L::TH, slot_b + L::TL, wg * N);
    mbar_arrive(bar.empty + 8 * sb);   // K^T is read no more
  }

  // the two partials, through the Q hi rows that no wgmma reads any more
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
  reduce_store<D>(dq, base + L::QH, p.g0, p, bi, hi, q0, wg);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tm_r,
                        const __grid_constant__ CUtensorMap tm_c,
                        const __grid_constant__ CUtensorMap tm_t,
                        F32Params p) {
  using G = Geom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const RingBars<G::SLOTS> bar(base + DqSmem<D>::BARS);
  const int n_qt = p.t / R;
  const int qt = p.causal ? (n_qt - 1 - (int)blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * R;   // causal: heaviest q tiles first
  const int bh = blockIdx.x;
  const int n_kt = p.causal ? (q0 + R) / G::C : p.t / G::C;

  if (threadIdx.x == 0) bar.init();
  __syncthreads();
  if (warpgroup_index() == CONSUMERS / 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      dq_produce<D>(base, bar, &tm_r, &tm_c, &tm_t, q0, n_kt, bh,
                    p.b * p.h);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    dq_consume<D>(base, bar, p, q0, n_kt, bh, bh / p.h, bh % p.h);
  }
}

// ---------------------------------------------------------------------------
// dk/dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  using G = Geom<D>;
  static constexpr int KH = 0, KL = G::T64, VH = 2 * G::T64, VL = 3 * G::T64;
  static constexpr int SLOT0 = 4 * G::T64;
  // item A: Q and dO hi/lo (C rows), lse and Delta; item B: Q^T and dO^T
  // hi/lo (D rows x C)
  static constexpr int QH = 0, QL = G::TC, OH = 2 * G::TC, OL = 3 * G::TC;
  static constexpr int LSE = 4 * G::TC, DL = LSE + G::C * 4;
  static constexpr int QTH = 0, QTL = G::TC, OTH = 2 * G::TC, OTL = 3 * G::TC;
  static constexpr int SLOT = round_up(DL + G::C * 4, 1024);
  static constexpr int TX_A = 4 * G::TC + 2 * G::C * 4, TX_B = 4 * G::TC;
  static constexpr int BARS = SLOT0 + G::SLOTS * SLOT;
  static constexpr int BYTES = BARS + RingBars<G::SLOTS>::BYTES + 1024;
  static_assert(BYTES <= 232448, "dk/dv shared memory");
};

template <int D>
__device__ __forceinline__ void dkv_produce(
    uint32_t base, const RingBars<Geom<D>::SLOTS>& bar, const CUtensorMap* tm_r,
    const CUtensorMap* tm_c, const CUtensorMap* tm_t, const F32Params& p,
    int k0, int q_start, int n_tiles, int bh, int bhs) {
  using G = Geom<D>;
  using L = DkvSmem<D>;
  mbar_expect_tx(bar.once, 4 * G::T64);
  load_plane_rows<D>(base + L::KH, tm_r, R, k0, plane_z(K, 0, bh, bhs), bar.once);
  load_plane_rows<D>(base + L::KL, tm_r, R, k0, plane_z(K, 1, bh, bhs), bar.once);
  load_plane_rows<D>(base + L::VH, tm_r, R, k0, plane_z(V, 0, bh, bhs), bar.once);
  load_plane_rows<D>(base + L::VL, tm_r, R, k0, plane_z(V, 1, bh, bhs), bar.once);
  for (int n = 0; n < 2 * n_tiles; ++n) {
    const int s = n % G::SLOTS, q0 = q_start + (n / 2) * G::C;
    const uint32_t st = base + L::SLOT0 + s * L::SLOT, full = bar.full + 8 * s;
    mbar_wait(bar.empty + 8 * s, ((n / G::SLOTS) & 1) ^ 1);
    if ((n & 1) == 0) {
      mbar_expect_tx(full, L::TX_A);
      load_plane_rows<D>(st + L::QH, tm_c, G::C, q0, plane_z(Q, 0, bh, bhs), full);
      load_plane_rows<D>(st + L::QL, tm_c, G::C, q0, plane_z(Q, 1, bh, bhs), full);
      load_plane_rows<D>(st + L::OH, tm_c, G::C, q0, plane_z(O, 0, bh, bhs), full);
      load_plane_rows<D>(st + L::OL, tm_c, G::C, q0, plane_z(O, 1, bh, bhs), full);
      bulk_load(st + L::LSE, p.lse + (long long)bh * p.t + q0, G::C * 4, full);
      bulk_load(st + L::DL, p.delta + (long long)bh * p.t + q0, G::C * 4, full);
    } else {
      mbar_expect_tx(full, L::TX_B);
      load_plane_cols<D, G::C>(st + L::QTH, tm_t, q0, plane_z(QT, 0, bh, bhs), full);
      load_plane_cols<D, G::C>(st + L::QTL, tm_t, q0, plane_z(QT, 1, bh, bhs), full);
      load_plane_cols<D, G::C>(st + L::OTH, tm_t, q0, plane_z(OT, 0, bh, bhs), full);
      load_plane_cols<D, G::C>(st + L::OTL, tm_t, q0, plane_z(OT, 1, bh, bhs), full);
    }
  }
}

template <int D>
__device__ __forceinline__ void dkv_consume(uint32_t base,
                                            const RingBars<Geom<D>::SLOTS>& bar,
                                            const F32Params& p, int k0,
                                            int q_start, int n_tiles, int bi,
                                            int hi) {
  using G = Geom<D>;
  using L = DkvSmem<D>;
  constexpr int N = G::N;
  const int wg = threadIdx.x >> 7;
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;

  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    key[hr] = k0 + warp * 16 + g + 8 * hr;
    key_ok[hr] =
        p.mask == nullptr || p.mask[(long long)bi * p.t + key[hr]] > 0.f;
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(bar.once, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int na = 2 * i, nb = 2 * i + 1;
    const int sa = na % G::SLOTS, sb = nb % G::SLOTS;
    const uint32_t slot_a = base + L::SLOT0 + sa * L::SLOT;
    const uint32_t slot_b = base + L::SLOT0 + sb * L::SLOT;
    const int qw0 = q_start + i * G::C + wg * N;   // this warpgroup's queries
    mbar_wait(bar.full + 8 * sa, (na / G::SLOTS) & 1);
    float sacc[N / 2], pacc[N / 2], tacc[N / 2];
    // S^T = K Q^T, 64 keys x N queries (waited for), then dP^T = V dO^T
    // issued
    product_ss_parts<D, N, SK>(sacc, tacc, base + L::KH, base + L::KL,
                               slot_a + L::QH + wg * N * 128,
                               slot_a + L::QL + wg * N * 128, G::C);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) pacc[j] = 0.f;
    fence_regs<N / 2>(pacc);
    wgmma_fence();
    product_ss<D, N>(pacc, base + L::VH, base + L::VL,
                     slot_a + L::OH + wg * N * 128,
                     slot_a + L::OL + wg * N * 128, G::C);
    wgmma_commit();
    const uint32_t lse_at = slot_a + L::LSE + wg * N * 4;
    const bool pred = p.mask != nullptr || (p.causal && qw0 < k0 + R - 1);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 l = ld_shared_f2(lse_at + (8 * j + 2 * t4) * 4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float le = e ? l.y : l.x;
        const int qi = qw0 + 8 * j + 2 * t4 + e;
        const bool live = !(le <= HALF_NEG);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int x = 4 * j + 2 * hr + e;
          const bool ok =
              live && (!pred || (key_ok[hr] && !(p.causal && key[hr] > qi)));
          sacc[x] = ok ? expf(__fsub_rn(__fmul_rn(sacc[x], p.scale), le)) : 0.f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs<N / 2>(pacc);
    // dS^T = P^T (dP^T - Delta) scale
    const uint32_t dl_at = slot_a + L::DL + wg * N * 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 dl = ld_shared_f2(dl_at + (8 * j + 2 * t4) * 4);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int x = 4 * j + 2 * hr;
        pacc[x] = __fmul_rn(__fmul_rn(sacc[x], __fsub_rn(pacc[x], dl.x)), p.scale);
        pacc[x + 1] =
            __fmul_rn(__fmul_rn(sacc[x + 1], __fsub_rn(pacc[x + 1], dl.y)), p.scale);
      }
    }
    mbar_arrive(bar.empty + 8 * sa);   // Q, dO, lse and Delta read no more
    // dv += P^T dO, then dk += dS^T Q: A from registers (P's fragments,
    // then dS's, so that only one pair is live), B transposed
    mbar_wait(bar.full + 8 * sb, (nb / G::SLOTS) & 1);
    {
      uint32_t ahi[N / 8][4], alo[N / 8][4];
      split_frags<N>(ahi, alo, sacc);
      product_rs<D, N>(dv, ahi, alo, slot_b + L::OTH, slot_b + L::OTL, wg * N);
    }
    {
      uint32_t ahi[N / 8][4], alo[N / 8][4];
      split_frags<N>(ahi, alo, pacc);
      product_rs<D, N>(dk, ahi, alo, slot_b + L::QTH, slot_b + L::QTL, wg * N);
    }
    mbar_arrive(bar.empty + 8 * sb);   // Q^T and dO^T read no more
  }

  // the two partials, through the K rows that no wgmma reads any more
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
  reduce_store<D>(dk, base + L::KH, p.g0, p, bi, hi, k0, wg);
  reduce_store<D>(dv, base + L::KL, p.g1, p, bi, hi, k0, wg);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap tm_r,
                         const __grid_constant__ CUtensorMap tm_c,
                         const __grid_constant__ CUtensorMap tm_t,
                         F32Params p) {
  using G = Geom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const RingBars<G::SLOTS> bar(base + DkvSmem<D>::BARS);
  const int k0 = (int)blockIdx.y * R;   // causal: heaviest (k tile 0) first
  const int bh = blockIdx.x;
  const int q_start = p.causal ? k0 : 0;
  const int n_tiles = (p.t - q_start) / G::C;

  if (threadIdx.x == 0) bar.init();
  __syncthreads();
  if (warpgroup_index() == CONSUMERS / 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      dkv_produce<D>(base, bar, &tm_r, &tm_c, &tm_t, p, k0, q_start, n_tiles,
                     bh, p.b * p.h);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    dkv_consume<D>(base, bar, p, k0, q_start, n_tiles, bh / p.h, bh % p.h);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The three maps over the scratch buffer: its row planes in boxes of 64
// and of C rows, and its transposed planes in boxes of all d rows.
template <typename Kernel>
cudaError_t launch_tf32(Kernel kernel, int d, int c, size_t smem,
                        const float* split, const F32Params& p,
                        cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(p.lse) & 15) ||
      (reinterpret_cast<uintptr_t>(p.delta) & 15) ||
      (reinterpret_cast<uintptr_t>(split) & 15))
    return cudaErrorInvalidValue;
  CUtensorMap tr, tc, tt;
  if (!encode_planes(&tr, &tc, &tt, split, d, p.t,
                     (long long)PLANES * p.b * p.h, R, c))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.b * p.h, p.t / R);
  kernel<<<grid, THREADS, smem, stream>>>(tr, tc, tt, p);
  return cudaGetLastError();
}

// what the kernels take: t a positive multiple of 128, b*h blocks on x,
// t / 64 on y
bool shape_ok(int b, int t, int h) {
  return b > 0 && h > 0 && t > 0 && t % 128 == 0 &&
         (long long)b * h <= 0x7fffffffLL && t / R <= 65535;
}

}  // namespace

// Strides are in elements; `split` is the [14][b*h][t*d] f32 scratch the
// pre-pass writes and the gradient kernels read. Each function returns a
// cudaError_t (0 = launched); the kernel runs on `stream` asynchronously.
extern "C" int flash_bwd_split_f32(int d, const float* q, const float* k,
                                   const float* v, const float* dout,
                                   long long q_sb, long long q_st,
                                   long long q_sh, long long k_sb,
                                   long long k_st, long long k_sh,
                                   long long v_sb, long long v_st,
                                   long long v_sh, long long o_sb,
                                   long long o_st, long long o_sh,
                                   float* split, int b, int t, int h,
                                   void* stream) {
  if (!shape_ok(b, t, h) || (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  SplitParams p{{q, k, v, dout},
                {q_sb, k_sb, v_sb, o_sb},
                {q_st, k_st, v_st, o_st},
                {q_sh, k_sh, v_sh, o_sh},
                {Q, K, V, O},
                {QT, KT, -1, OT},
                split, b, t, h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(d == 64 ? launch_split(flash_bwd_split_f32_kernel<64>, p, 4, st)
                       : launch_split(flash_bwd_split_f32_kernel<128>, p, 4,
                                      st));
}

extern "C" int flash_bwd_dq_f32(int d, const float* split, const float* mask,
                                const float* lse, const float* delta,
                                float* dq, int b, int t, int h, float scale,
                                int causal, void* stream) {
  if (!shape_ok(b, t, h)) return (int)cudaErrorInvalidValue;
  F32Params prm{mask, lse, delta, dq, nullptr, b, t, h, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)launch_tf32(flash_bwd_dq_f32_kernel<64>, 64, Geom<64>::C,
                            DqSmem<64>::BYTES, split, prm, st);
  if (d == 128)
    return (int)launch_tf32(flash_bwd_dq_f32_kernel<128>, 128, Geom<128>::C,
                            DqSmem<128>::BYTES, split, prm, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_f32(int d, const float* split, const float* mask,
                                 const float* lse, const float* delta,
                                 float* dk, float* dv, int b, int t, int h,
                                 float scale, int causal, void* stream) {
  if (!shape_ok(b, t, h)) return (int)cudaErrorInvalidValue;
  F32Params prm{mask, lse, delta, dk, dv, b, t, h, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)launch_tf32(flash_bwd_dkv_f32_kernel<64>, 64, Geom<64>::C,
                            DkvSmem<64>::BYTES, split, prm, st);
  if (d == 128)
    return (int)launch_tf32(flash_bwd_dkv_f32_kernel<128>, 128, Geom<128>::C,
                            DkvSmem<128>::BYTES, split, prm, st);
  return (int)cudaErrorInvalidValue;
}
