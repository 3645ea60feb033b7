// Flash-attention backward for Hopper (sm_90a), bound through a plain C
// interface (ctypes). Three entry points:
//
//   flash_bwd_preprocess  Delta [b, h, t] f32 = rowsum(dO * O) over d
//                         (d = 64 or 128). Replaces the XLA pass of the JAX
//                         package's _flash_bwd_btd_pallas (deeplearning4j_tpu/
//                         ops/flash_attention.py:442; not a Pallas kernel).
//   flash_bwd_dq          dq = sum_k dS K, bf16. Replaces the Pallas kernel
//                         _bwd_dq_kernel (flash_attention.py:359, tile math
//                         _bwd_p_ds :336, driver _flash_bwd_btd_pallas :430).
//   flash_bwd_dkv         dk = sum_q dS^T Q and dv = sum_q P^T dO, fused, bf16.
//                         Replaces the Pallas kernel _bwd_dkv_kernel (:391).
//
// Both gradient kernels recompute P from the forward's saved lse:
//   P  = exp(S * scale - lse), 0 where the key is masked, past the causal
//        diagonal, or the query row has lse = NEG_INF (no attendable key);
//   dS = P * (dO V^T - Delta) * scale.
// Masked keys get dk = dv = 0 exactly and a query row with no attendable key
// gets dq = 0 exactly (P = 0 there, so every term added is an exact zero).
// Two passes and no atomics, as in the reference: each block owns its output
// tile, so the gradients are bitwise deterministic.
//
// Inputs: q, k, v, dO as [b, t, h, d] strided views (head dim contiguous; the
// attention layer's q/k/v are slices of one qkv projection, read in place),
// O [b, t, h, d] strided, lse and Delta [b, h, t] f32 contiguous, an optional
// [b, t] f32 key mask (key valid iff > 0). Outputs dq, dk, dv contiguous
// [b, t, h, d] in the input dtype, accumulated in f32.
//
// Bound at the flagship shape (b=8, h=12, t=2048, d=64, causal, bf16;
// b*h*t*(t+1)/2 = 201M attended pairs): dq does S, dP and dS K, 3 products of
// 2*d FLOPs per pair = 77 GFLOP, 78 us at 989 TFLOP/s; dk/dv does S, dP, dS^T Q
// and P^T dO = 103 GFLOP, 104 us. Each moves about 0.1-0.2 GB (about 40-60 us
// at 3.35 TB/s), so both are compute-bound: what matters is keeping the
// tensor cores fed. The preprocess reads O and dO (50 MB) and writes Delta
// (0.8 MB): memory-bound, about 15 us. One main-path training step of the
// flagship launches each entry 12 times, once per layer.
//
// The preprocess is a separate kernel built for bandwidth: 16-byte loads
// (8 bf16 or 4 f32 values a thread, so a 128-byte d = 64 bf16 row is 8
// threads), two rows a thread in flight, the row sum reduced by shuffles
// among the row's threads, and rows numbered t fastest within one (b, h),
// so Delta [b, h, t] is written coalesced. Strided O and dO views are read
// in place.
//
// The Hopper primitives (mbarriers, TMA, wgmma and its descriptors,
// setmaxnreg, the tensor maps) are in hopper.cuh, shared with flash_fwd.cu.
//
// Design of the bf16 kernels (d = 64 or 128). On the TPU the two Pallas
// kernels carry their accumulator across a sequential grid dimension. Here
// blocks run in no order, so each block owns an output tile and loops over
// the other axis itself, accumulating in registers. A block is 384 threads:
// two consumer warpgroups (64 output rows each, 232 registers a thread) and
// a producer warpgroup that gives its registers back (setmaxnreg, 40).
//   * Loads: the producer's first thread feeds a ring of STAGES shared-
//     memory stages with TMA (cp.async.bulk.tensor, 128-byte swizzle) on
//     full/empty mbarriers, so the next tiles are in flight while the
//     consumers compute. One 4-D tensor map per operand over its strided
//     [b, t, h, d] view (dims d, h, t, b; a box of 64 columns x 1 x rows x 1;
//     d = 128 takes two boxes), so the qkv slices are read in place.
//   * Products: every product is a warpgroup wgmma (m64nNk16, bf16 in, f32
//     accumulate). The first two (S and dP, or their transposes) read both
//     operands from shared memory, K-major. P and dS, rounded to bf16, stay
//     in registers: the accumulator layout of m64nN is the A-fragment layout
//     of the next product, so they are its A operand directly. Its B operand
//     (dO, Q or K, stored row by row as the TMA wrote it) is read MN-major
//     through the descriptor's transpose bit: no transposed copy exists.
//   * dq: one block per (b*h, 128-row q tile), heaviest tiles first under
//     causal; Q, dO, lse and Delta are loaded once; the ring streams 64-key
//     (K, V) tiles up to the causal diagonal.
//   * dk/dv: one block per (b*h, 128-key tile); K and V are loaded once; the
//     ring streams (Q, dO, lse, Delta) tiles of BQ queries from the causal
//     diagonal on (pre-diagonal q tiles are skipped, loads and math, as the
//     reference's clamped index map skips their loads). The consumers compute
//     S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out in the rows of
//     their own keys, then dv += P^T dO and dk += dS^T Q.
//   * The mask, causal and dead-row predicates run only on diagonal tiles or
//     when a key mask is given; elsewhere P = exp2(S * scale * log2 e -
//     lse * log2 e) with no test (one MUFU.EX2). The elementwise work per
//     score shares the SM with the other warpgroup's products, so it is
//     kept short: dS is formed without the softmax scale, which dq and dk
//     take once in the epilogue (exact at d = 64, where it is 2^-3).
//   * Epilogue: each warpgroup stages its gradient tile in bf16 in the
//     shared memory of its own (finished) K/V or Q/dO rows, swizzled, and
//     writes it out with 16-byte stores.
//
// The f32 dq and dk/dv kernels are in flash_bwd_f32.cu (3xTF32 wgmma fed by
// TMA), a library of its own so that it compiles beside this one. They
// serve every f32 attention call on the card and every hop of the ring;
// they take the Delta this file's preprocess writes.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float HALF_NEG = -5e29f;   // NEG_INF / 2, NEG_INF = -1e30

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* mask;   // [b, t] or nullptr (every key valid)
  const float* lse;    // [b, h, t] contiguous
  const float* delta;  // [b, h, t] contiguous
  void* g0;            // dq (dq pass) or dk (dk/dv pass), [b, t, h, d]
  void* g1;            // dv (dk/dv pass), [b, t, h, d]
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;   // dO strides
  int b, t, h;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// Delta = rowsum(dO * O), at memory bandwidth
// ---------------------------------------------------------------------------

constexpr int PRE_THREADS = 256;
constexpr int PRE_ROWS = 2;   // rows per thread, their loads all in flight

// The sum of the products of two 16-byte vectors of 8 bf16 or 4 f32 values.
__device__ __forceinline__ float dot16(uint4 a, uint4 b, bf16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}
__device__ __forceinline__ float dot16(uint4 a, uint4 b, float) {
  return fmaf(__uint_as_float(a.x), __uint_as_float(b.x),
              fmaf(__uint_as_float(a.y), __uint_as_float(b.y),
                   fmaf(__uint_as_float(a.z), __uint_as_float(b.z),
                        __uint_as_float(a.w) * __uint_as_float(b.w))));
}

// How a block of the preprocess splits its rows: a row of D values is read
// by TPR neighbouring threads with 16-byte loads (VEC values each), a warp
// covers RPW rows per load step, and a block RPB consecutive rows.
template <typename T, int D>
struct PreSplit {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int TPR = D / VEC;
  static constexpr int RPW = 32 / TPR;
  static constexpr int RPB = PRE_THREADS / 32 * RPW * PRE_ROWS;
  static_assert(D % VEC == 0 && 32 % TPR == 0, "row split");
};

// One block per (b*h, run of RPB consecutive t): each thread holds PRE_ROWS
// rows of O and dO in flight, the row sum is reduced by shuffles within the
// row's threads, and consecutive rows (consecutive t of one head) write
// consecutive values of Delta [b, h, t]. No division per row: the block's
// (b, h) is found once.
template <typename T, int D>
__global__ void __launch_bounds__(PRE_THREADS)
flash_bwd_preprocess_kernel(const T* out, long long o_sb, long long o_st,
                            long long o_sh, const T* dout, long long d_sb,
                            long long d_st, long long d_sh, float* delta,
                            int t, int h) {
  using S = PreSplit<T, D>;
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % S::TPR;
  const int t0 = (int)blockIdx.y * S::RPB + warp * S::RPW * PRE_ROWS +
                 lane / S::TPR;
  const T* ob = out + bi * o_sb + hi * o_sh + c * S::VEC;
  const T* db = dout + bi * d_sb + hi * d_sh + c * S::VEC;
  uint4 ov[PRE_ROWS], dv[PRE_ROWS];
#pragma unroll
  for (int i = 0; i < PRE_ROWS; ++i) {
    const int ti = t0 + i * S::RPW;
    ov[i] = dv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (ti < t) {
      ov[i] = __ldg(reinterpret_cast<const uint4*>(ob + ti * o_st));
      dv[i] = __ldg(reinterpret_cast<const uint4*>(db + ti * d_st));
    }
  }
#pragma unroll
  for (int i = 0; i < PRE_ROWS; ++i) {
    float acc = dot16(ov[i], dv[i], T());
#pragma unroll
    for (int off = S::TPR / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const int ti = t0 + i * S::RPW;
    if (c == 0 && ti < t) delta[(long long)bh * t + ti] = acc;
  }
}

template <typename T, int D>
cudaError_t launch_preprocess(const void* out, long long o_sb, long long o_st,
                              long long o_sh, const void* dout,
                              long long d_sb, long long d_st, long long d_sh,
                              float* delta, int b, int t, int h,
                              cudaStream_t stream) {
  constexpr int RPB = PreSplit<T, D>::RPB;
  // b*h on x (up to 2^31 - 1 blocks), runs of t on y (at most 65535)
  const long long bhs = (long long)b * h;
  if (bhs > 0x7fffffffLL || (t + RPB - 1) / RPB > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)bhs, (t + RPB - 1) / RPB);
  flash_bwd_preprocess_kernel<T, D><<<grid, PRE_THREADS, 0, stream>>>(
      static_cast<const T*>(out), o_sb, o_st, o_sh,
      static_cast<const T*>(dout), d_sb, d_st, d_sh, delta, t, h);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernels fed by TMA
// ---------------------------------------------------------------------------

constexpr int STAGES = 3;                  // depth of the TMA ring
constexpr int KT = 64;                     // keys per streamed dq tile
using Bars = RingBars<STAGES>;

// Shared memory of the dq kernel (byte offsets from a 1024-aligned base).
// A tile of r rows is D/64 column halves of r x 128 bytes.
template <int D>
struct DqSmem {
  static constexpr int Q = 0;                        // [ROWS] rows
  static constexpr int O = Q + ROWS * D * 2;         // dO, [ROWS] rows
  static constexpr int STAGE0 = O + ROWS * D * 2;
  static constexpr int K = 0, V = KT * D * 2;        // within a stage
  static constexpr int STAGE = 2 * KT * D * 2;
  static constexpr int BARS = STAGE0 + STAGES * STAGE;
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;
};

// Shared memory of the dk/dv kernel: K and V once, then a ring of
// (Q, dO, lse, Delta) stages of BQ queries.
template <int D, int BQ>
struct DkvSmem {
  static constexpr int K = 0;                        // [ROWS] keys
  static constexpr int V = K + ROWS * D * 2;
  static constexpr int STAGE0 = V + ROWS * D * 2;
  static constexpr int Q = 0, O = BQ * D * 2;        // within a stage
  static constexpr int LSE = 2 * BQ * D * 2, DL = LSE + BQ * 4;
  static constexpr int STAGE = round_up(DL + BQ * 4, 1024);
  static constexpr int TX = 2 * BQ * D * 2 + 2 * BQ * 4;   // bytes per stage
  static constexpr int BARS = STAGE0 + STAGES * STAGE;
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;
};



// ---- dq --------------------------------------------------------------------

template <int D>
__device__ __forceinline__ void dq_produce(
    uint32_t base, const Bars& bar, const CUtensorMap* tm_q,
    const CUtensorMap* tm_k, const CUtensorMap* tm_v, const CUtensorMap* tm_o,
    int q0, int n_kt, int bi, int hi) {
  using L = DqSmem<D>;
  mbar_expect_tx(bar.once, 2 * ROWS * D * 2);
  load_rows<D>(base + L::Q, tm_q, ROWS, hi, q0, bi, bar.once);
  load_rows<D>(base + L::O, tm_o, ROWS, hi, q0, bi, bar.once);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % STAGES;
    mbar_wait(bar.empty + 8 * s, ((i / STAGES) & 1) ^ 1);
    const uint32_t st = base + L::STAGE0 + s * L::STAGE;
    mbar_expect_tx(bar.full + 8 * s, L::STAGE);
    load_rows<D>(st + L::K, tm_k, KT, hi, i * KT, bi, bar.full + 8 * s);
    load_rows<D>(st + L::V, tm_v, KT, hi, i * KT, bi, bar.full + 8 * s);
  }
}

template <int D>
__device__ __forceinline__ void dq_consume(uint32_t base, const Bars& bar,
                                           const BwdParams& p, int q0,
                                           int n_kt, int bh, int bi, int hi) {
  using L = DqSmem<D>;
  // warpgroup wg owns query rows qw0 .. qw0 + 63
  const int wg = threadIdx.x >> 7;
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;
  const int qw0 = q0 + wg * 64;
  const float* mg = p.mask ? p.mask + (long long)bi * p.t : nullptr;
  const float sl2 = p.scale * LOG2E;

  int row[2];
  float l2[2], dl[2];
  bool live[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    row[hr] = qw0 + warp * 16 + g + 8 * hr;
    const float lse = p.lse[(long long)bh * p.t + row[hr]];
    dl[hr] = p.delta[(long long)bh * p.t + row[hr]];
    live[hr] = !(lse <= HALF_NEG);
    l2[hr] = lse * LOG2E;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  const uint32_t aQ = base + L::Q + wg * 64 * 128;   // this warpgroup's rows
  const uint32_t aO = base + L::O + wg * 64 * 128;
  mbar_wait(bar.once, 0);

  for (int i = 0; i < n_kt; ++i) {
    const int s = i % STAGES;
    const int k0 = i * KT;
    mbar_wait(bar.full + 8 * s, (i / STAGES) & 1);
    if (p.causal && k0 > qw0 + 63) {   // a tile wholly past the diagonal
      mbar_arrive(bar.empty + 8 * s);
      continue;
    }
    const uint32_t sK = base + L::STAGE0 + s * L::STAGE + L::K;
    const uint32_t sV = base + L::STAGE0 + s * L::STAGE + L::V;
    float sacc[KT / 2], pacc[KT / 2];
#pragma unroll
    for (int j = 0; j < KT / 2; ++j) sacc[j] = pacc[j] = 0.f;
    fence_regs<KT / 2>(sacc);
    fence_regs<KT / 2>(pacc);
    // S = Q K^T and dP = dO V^T, 64 rows x 64 keys each
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<KT>::ss(sacc, kmajor_desc(aQ, ROWS, kk), kmajor_desc(sK, KT, kk),
                    kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<KT>::ss(pacc, kmajor_desc(aO, ROWS, kk), kmajor_desc(sV, KT, kk),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // S is done; dP may still run
    fence_regs<KT / 2>(sacc);

    // P from lse; the predicates run only on the diagonal or with a mask
    if (mg != nullptr || (p.causal && k0 + KT - 1 > qw0)) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t4 + e;
          const bool key_ok = mg == nullptr || mg[col] > 0.f;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int x = 4 * j + 2 * hr + e;
            const bool ok =
                key_ok && live[hr] && !(p.causal && col > row[hr]);
            sacc[x] = ok ? fast_exp2(fmaf(sacc[x], sl2, -l2[hr])) : 0.f;
          }
        }
    } else {
#pragma unroll
      for (int x = 0; x < KT / 2; ++x)
        sacc[x] = fast_exp2(fmaf(sacc[x], sl2, -l2[(x >> 1) & 1]));
    }
    wgmma_wait<0>();
    fence_regs<KT / 2>(pacc);
    // dS / scale = P (dP - Delta); dq is scaled once, in the epilogue
#pragma unroll
    for (int x = 0; x < KT / 2; ++x)
      pacc[x] = sacc[x] * (pacc[x] - dl[(x >> 1) & 1]);

    // dq += dS K: dS from registers, K read MN-major
    uint32_t da[KT / 16][4];
    acc_to_frags<KT>(da, pacc);
    fence_regs<KT / 4>(&da[0][0]);
    fence_regs<D / 2>(dq);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc)
      Wgmma<D>::rs(dq, da[kc], mnmajor_desc(sK, KT, kc));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dq);
    fence_regs<KT / 4>(&da[0][0]);
    mbar_arrive(bar.empty + 8 * s);   // this stage is read no more
  }

  // epilogue: through this warpgroup's own Q rows, which no wgmma reads now
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] *= p.scale;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  store_tile<D>(dq, base + L::Q, ROWS, wg * 64, static_cast<bf16*>(p.g0), p,
                bi, hi, qw0, wg);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_o,
                         BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Bars bar(base + DqSmem<D>::BARS);
  const int n_qt = p.t / ROWS;
  const int qt = p.causal ? (n_qt - 1 - (int)blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * ROWS;   // causal: heaviest q tiles first
  const int bh = blockIdx.x;
  const int n_kt = p.causal ? (q0 + ROWS) / KT : p.t / KT;

  if (threadIdx.x == 0) bar.init();
  __syncthreads();
  if (warpgroup_index() == CONSUMERS / 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      dq_produce<D>(base, bar, &tm_q, &tm_k, &tm_v, &tm_o, q0, n_kt,
                    bh / p.h, bh % p.h);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    dq_consume<D>(base, bar, p, q0, n_kt, bh, bh / p.h, bh % p.h);
  }
}

// ---- dk/dv -----------------------------------------------------------------

template <int D, int BQ>
__device__ __forceinline__ void dkv_produce(
    uint32_t base, const Bars& bar, const CUtensorMap* tm_q,
    const CUtensorMap* tm_k, const CUtensorMap* tm_v, const CUtensorMap* tm_o,
    const BwdParams& p, int k0, int q_start, int n_tiles, int bh, int bi,
    int hi) {
  using L = DkvSmem<D, BQ>;
  mbar_expect_tx(bar.once, 2 * ROWS * D * 2);
  load_rows<D>(base + L::K, tm_k, ROWS, hi, k0, bi, bar.once);
  load_rows<D>(base + L::V, tm_v, ROWS, hi, k0, bi, bar.once);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int q0 = q_start + i * BQ;
    mbar_wait(bar.empty + 8 * s, ((i / STAGES) & 1) ^ 1);
    const uint32_t st = base + L::STAGE0 + s * L::STAGE;
    const uint32_t full = bar.full + 8 * s;
    mbar_expect_tx(full, L::TX);
    load_rows<D>(st + L::Q, tm_q, BQ, hi, q0, bi, full);
    load_rows<D>(st + L::O, tm_o, BQ, hi, q0, bi, full);
    bulk_load(st + L::LSE, p.lse + (long long)bh * p.t + q0, BQ * 4, full);
    bulk_load(st + L::DL, p.delta + (long long)bh * p.t + q0, BQ * 4, full);
  }
}

template <int D, int BQ>
__device__ __forceinline__ void dkv_consume(uint32_t base, const Bars& bar,
                                            const BwdParams& p, int k0,
                                            int q_start, int n_tiles, int bi,
                                            int hi) {
  using L = DkvSmem<D, BQ>;
  // warpgroup wg owns keys kw0 .. kw0 + 63
  const int wg = threadIdx.x >> 7;
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;
  const int kw0 = k0 + wg * 64;
  const float sl2 = p.scale * LOG2E;

  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    key[hr] = kw0 + warp * 16 + g + 8 * hr;
    key_ok[hr] =
        p.mask == nullptr || p.mask[(long long)bi * p.t + key[hr]] > 0.f;
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t aK = base + L::K + wg * 64 * 128;   // this warpgroup's keys
  const uint32_t aV = base + L::V + wg * 64 * 128;
  mbar_wait(bar.once, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int q0 = q_start + i * BQ;
    mbar_wait(bar.full + 8 * s, (i / STAGES) & 1);
    if (p.causal && q0 + BQ - 1 < kw0) {   // a tile wholly before the keys
      mbar_arrive(bar.empty + 8 * s);
      continue;
    }
    const uint32_t st = base + L::STAGE0 + s * L::STAGE;
    const uint32_t sQ = st + L::Q, sO = st + L::O;
    float sacc[BQ / 2], pacc[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) sacc[j] = pacc[j] = 0.f;
    fence_regs<BQ / 2>(sacc);
    fence_regs<BQ / 2>(pacc);
    // S^T = K Q^T and dP^T = V dO^T, 64 keys x BQ queries each
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ>::ss(sacc, kmajor_desc(aK, ROWS, kk), kmajor_desc(sQ, BQ, kk),
                    kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ>::ss(pacc, kmajor_desc(aV, ROWS, kk), kmajor_desc(sO, BQ, kk),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<1>();   // S^T is done; dP^T may still run
    fence_regs<BQ / 2>(sacc);

    // P^T from lse; the predicates run only on the diagonal or with a mask
    const bool pred = p.mask != nullptr || (p.causal && q0 < kw0 + 63);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l = ld_shared_f2(st + L::LSE + (8 * j + 2 * t4) * 4);
      const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
      if (pred) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * j + 2 * t4 + e;
          const bool live = !((e ? l.y : l.x) <= HALF_NEG);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int x = 4 * j + 2 * hr + e;
            const bool ok = key_ok[hr] && live && !(p.causal && key[hr] > qi);
            sacc[x] = ok ? fast_exp2(fmaf(sacc[x], sl2, -l2[e])) : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int x = 4 * j; x < 4 * j + 4; ++x)
          sacc[x] = fast_exp2(fmaf(sacc[x], sl2, -l2[x & 1]));
      }
    }
    wgmma_wait<0>();
    fence_regs<BQ / 2>(pacc);
    // dS^T / scale = P^T (dP^T - Delta); dk is scaled once, in the epilogue
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 dl = ld_shared_f2(st + L::DL + (8 * j + 2 * t4) * 4);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int x = 4 * j + 2 * hr;
        pacc[x] = sacc[x] * (pacc[x] - dl.x);
        pacc[x + 1] = sacc[x + 1] * (pacc[x + 1] - dl.y);
      }
    }

    // dv += P^T dO and dk += dS^T Q: A from registers, B read MN-major
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    acc_to_frags<BQ>(pa, sacc);
    acc_to_frags<BQ>(da, pacc);
    fence_regs<BQ / 4>(&pa[0][0]);
    fence_regs<BQ / 4>(&da[0][0]);
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)
      Wgmma<D>::rs(dv, pa[kc], mnmajor_desc(sO, BQ, kc));
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)
      Wgmma<D>::rs(dk, da[kc], mnmajor_desc(sQ, BQ, kc));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    fence_regs<BQ / 4>(&pa[0][0]);
    fence_regs<BQ / 4>(&da[0][0]);
    mbar_arrive(bar.empty + 8 * s);   // this stage is read no more
  }

  // epilogue: through this warpgroup's own K and V rows
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] *= p.scale;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  store_tile<D>(dk, base + L::K, ROWS, wg * 64, static_cast<bf16*>(p.g0), p,
                bi, hi, kw0, wg);
  store_tile<D>(dv, base + L::V, ROWS, wg * 64, static_cast<bf16*>(p.g1), p,
                bi, hi, kw0, wg);
}

template <int D, int BQ>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o,
                          BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Bars bar(base + DkvSmem<D, BQ>::BARS);
  const int k0 = (int)blockIdx.y * ROWS;   // causal: heaviest (k tile 0) first
  const int bh = blockIdx.x;
  const int q_start = p.causal ? k0 : 0;
  const int n_tiles = (p.t - q_start) / BQ;

  if (threadIdx.x == 0) bar.init();
  __syncthreads();
  if (warpgroup_index() == CONSUMERS / 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      dkv_produce<D, BQ>(base, bar, &tm_q, &tm_k, &tm_v, &tm_o, p, k0,
                         q_start, n_tiles, bh, bh / p.h, bh % p.h);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    dkv_consume<D, BQ>(base, bar, p, k0, q_start, n_tiles, bh / p.h,
                       bh % p.h);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The bf16 kernels: maps for q, k, v and dO with box heights q_rows (q and
// dO) and kv_rows (k and v), then one block per (b*h, 128-row tile).
template <typename Kernel>
cudaError_t launch_tma(Kernel kernel, int q_rows, int kv_rows, size_t smem,
                       const BwdParams& p, int d, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(p.lse) & 15) ||
      (reinterpret_cast<uintptr_t>(p.delta) & 15))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  if (!encode_view(&tq, p.q, p.b, p.t, p.h, d, p.q_sb, p.q_st, p.q_sh,
                   q_rows) ||
      !encode_view(&tk, p.k, p.b, p.t, p.h, d, p.k_sb, p.k_st, p.k_sh,
                   kv_rows) ||
      !encode_view(&tv, p.v, p.b, p.t, p.h, d, p.v_sb, p.v_st, p.v_sh,
                   kv_rows) ||
      !encode_view(&to, p.dout, p.b, p.t, p.h, d, p.o_sb, p.o_st, p.o_sh,
                   q_rows))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.b * p.h, p.t / ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

bool shape_ok(int t) { return t > 0 && t % ROWS == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the preprocess takes both; dq and
// dk/dv take bf16 here, f32 in flash_bwd_f32.cu). Strides are in elements.
// Each function returns a cudaError_t (0 = launched); the kernel runs on
// `stream` asynchronously.
extern "C" int flash_bwd_preprocess(int dtype, int d, const void* out,
                                    long long o_sb, long long o_st,
                                    long long o_sh, const void* dout,
                                    long long d_sb, long long d_st,
                                    long long d_sh, float* delta, int b,
                                    int t, int h, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || t <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && d == 64)
    err = launch_preprocess<bf16, 64>(out, o_sb, o_st, o_sh, dout, d_sb, d_st,
                                      d_sh, delta, b, t, h, st);
  else if (dtype == 1 && d == 128)
    err = launch_preprocess<bf16, 128>(out, o_sb, o_st, o_sh, dout, d_sb,
                                       d_st, d_sh, delta, b, t, h, st);
  else if (dtype == 0 && d == 64)
    err = launch_preprocess<float, 64>(out, o_sb, o_st, o_sh, dout, d_sb,
                                       d_st, d_sh, delta, b, t, h, st);
  else if (dtype == 0 && d == 128)
    err = launch_preprocess<float, 128>(out, o_sb, o_st, o_sh, dout, d_sb,
                                        d_st, d_sh, delta, b, t, h, st);
  return (int)err;
}

extern "C" int flash_bwd_dq(int dtype, int d, const void* q, const void* k,
                            const void* v, const void* dout,
                            const float* mask, const float* lse,
                            const float* delta, void* dq, long long q_sb,
                            long long q_st, long long q_sh, long long k_sb,
                            long long k_st, long long k_sh, long long v_sb,
                            long long v_st, long long v_sh, long long o_sb,
                            long long o_st, long long o_sh, int b, int t,
                            int h, float scale, int causal, void* stream) {
  BwdParams prm{q, k, v, dout, mask, lse, delta, dq, nullptr,
                q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                o_sb, o_st, o_sh, b, t, h, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(t)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (d == 64)
      return (int)launch_tma(flash_bwd_dq_bf16_kernel<64>, ROWS, KT,
                             DqSmem<64>::BYTES, prm, d, st);
    if (d == 128)
      return (int)launch_tma(flash_bwd_dq_bf16_kernel<128>, ROWS, KT,
                             DqSmem<128>::BYTES, prm, d, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(int dtype, int d, const void* q, const void* k,
                             const void* v, const void* dout,
                             const float* mask, const float* lse,
                             const float* delta, void* dk, void* dv,
                             long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh,
                             long long v_sb, long long v_st, long long v_sh,
                             long long o_sb, long long o_st, long long o_sh,
                             int b, int t, int h, float scale, int causal,
                             void* stream) {
  BwdParams prm{q, k, v, dout, mask, lse, delta, dk, dv,
                q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                o_sb, o_st, o_sh, b, t, h, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(t)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    // BQ queries per ring stage: 64 at d = 64; 32 at d = 128, where the dk
    // and dv accumulators (64 registers each) leave less room for S^T/dP^T
    if (d == 64)
      return (int)launch_tma(flash_bwd_dkv_bf16_kernel<64, 64>, 64, ROWS,
                             DkvSmem<64, 64>::BYTES, prm, d, st);
    if (d == 128)
      return (int)launch_tma(flash_bwd_dkv_bf16_kernel<128, 32>, 32, ROWS,
                             DkvSmem<128, 32>::BYTES, prm, d, st);
  }
  return (int)cudaErrorInvalidValue;
}
