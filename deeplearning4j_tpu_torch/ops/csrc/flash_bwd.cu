// Flash-attention backward for Hopper (sm_90a), bound through a plain C
// interface (ctypes). Three entry points:
//
//   flash_bwd_preprocess  Delta [b, h, t] f32 = rowsum(dO * O) over d.
//                         Replaces the XLA pass of the JAX package's
//                         _flash_bwd_btd_pallas (deeplearning4j_tpu/ops/
//                         flash_attention.py:442; not a Pallas kernel there).
//   flash_bwd_dq          dq = sum_k dS K. Replaces the Pallas kernel
//                         _bwd_dq_kernel (flash_attention.py:359, tile math
//                         _bwd_p_ds :336, driver _flash_bwd_btd_pallas :430).
//   flash_bwd_dkv         dk = sum_q dS^T Q and dv = sum_q P^T dO, fused.
//                         Replaces the Pallas kernel _bwd_dkv_kernel (:391).
//
// Both gradient kernels recompute P from the forward's saved lse:
//   P  = exp(S * scale - lse), 0 where the key is masked, past the causal
//        diagonal, or the query row has lse = NEG_INF (no attendable key);
//   dS = P * (dO V^T - Delta) * scale.
// Masked keys get dk = dv = 0 exactly and a query row with no attendable key
// gets dq = 0 exactly (P = 0 there, so every term added is an exact zero).
// Two passes and no atomics, as in the reference, so the gradients are
// deterministic.
//
// Inputs: q, k, v, dO as [b, t, h, d] strided views (head dim contiguous; the
// attention layer's q/k/v are slices of one qkv projection, read in place),
// O [b, t, h, d] strided, lse and Delta [b, h, t] f32 contiguous, an optional
// [b, t] f32 key mask (key valid iff > 0). Outputs dq, dk, dv contiguous
// [b, t, h, d] in the input dtype, accumulated in f32.
//
// Design. On the TPU the two Pallas kernels carry their accumulator across a
// sequential grid dimension. Here blocks run in no order, so each block owns
// its output tile and loops over the other axis itself, accumulating in
// registers:
//   * dq: one block per (b*h, 64-row q tile), looping over 64-key tiles up to
//     the causal diagonal; q tiles are scheduled heaviest first.
//   * dk/dv: one block per (b*h, 64-key tile), looping over q tiles from the
//     diagonal on (pre-diagonal q tiles are skipped, loads and math, as the
//     reference's clamped index map skips their loads). P and dS are computed
//     once per tile and feed both dk and dv. The warp computes the transposed
//     tile S^T = K Q^T, so its P^T and dS^T accumulators are directly the A
//     fragments of the dv and dk products.
//   * bf16: 4 warps of 16 rows; S, dP, dq, dk and dv run on the tensor cores
//     with mma.sync m16n8k16 (bf16 in, f32 accumulate). P and dS are rounded
//     to bf16 for the dq, dk and dv products (flash_attention.
//     bf16_grad_tolerance bounds what that rounding costs). Tiles that a
//     product reads along its reduction axis are staged transposed in shared
//     memory, so every fragment is one 32-bit load from a padded,
//     conflict-free row.
//   * f32: one thread per row on the CUDA cores (fp32 FMA, no TF32), so the
//     f32 gradients keep full f32 precision.
//
// Bound at the flagship shape (b=8, h=12, t=2048, d=64, causal, bf16;
// b*h*t*(t+1)/2 = 201M attended pairs): dq does S, dP and dS K, 3 products of
// 2*d FLOPs per pair = 77 GFLOP, 78 us at 989 TFLOP/s; dk/dv does S, dP, dS^T Q
// and P^T dO = 103 GFLOP, 104 us. Each moves about 0.1-0.2 GB (about 40-60 us
// at 3.35 TB/s), so both are compute-bound. The preprocess reads O and dO
// (50 MB) and writes Delta (0.8 MB): memory-bound, about 15 us. This simple
// version (synchronous loads, no TMA, no wgmma, no pipelining) does not reach
// those bounds; PERF.md records its times. One main-path training step of the
// flagship launches each entry 12 times, once per layer.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float HALF_NEG = -5e29f;   // NEG_INF / 2, NEG_INF = -1e30

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// The A fragment (16 rows x 16 columns) at rows r0.., columns c0.. of a
// row-major bf16 tile with row pitch `pitch`.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile,
                                       int pitch, int r0, int c0, int g,
                                       int t4) {
  a[0] = ld32(&tile[(r0 + g) * pitch + c0 + 2 * t4]);
  a[1] = ld32(&tile[(r0 + g + 8) * pitch + c0 + 2 * t4]);
  a[2] = ld32(&tile[(r0 + g) * pitch + c0 + 8 + 2 * t4]);
  a[3] = ld32(&tile[(r0 + g + 8) * pitch + c0 + 8 + 2 * t4]);
}

// acc += A B for one 16x8 output tile, B read from the tile stored [n][k]
// (row n of `tile` holds B's column n along the reduction axis).
__device__ __forceinline__ void mma_nk(float* acc, const uint32_t* a,
                                       const bf16* tile, int pitch, int n0,
                                       int k0, int g, int t4) {
  const bf16* r = &tile[(n0 + g) * pitch + k0 + 2 * t4];
  mma_bf16(acc, a, ld32(r), ld32(r + 8));
}

// Two neighbouring 16x8 accumulator tiles, rounded to bf16, are exactly the
// A fragment of one 16-wide reduction chunk.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo,
                                         const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Rows [r0, r0 + rows) of a strided [t, d] bf16 head into a padded smem tile
// (16-byte chunks); with `tr`, also its transpose [d][rows + 8].
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, bf16* tr, int tr_pitch,
                                           const bf16* src, long long st,
                                           int r0, int rows) {
  constexpr int DP = D + 8;
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
    const int r = c / CH, cc = (c % CH) * 8;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(&src[(long long)(r0 + r) * st + cc]);
    *reinterpret_cast<uint4*>(&dst[r * DP + cc]) = raw;
    if (tr != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(cc + i) * tr_pitch + r] = e[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Delta = rowsum(dO * O): one warp per (b, t, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_preprocess_kernel(const T* out, long long o_sb, long long o_st,
                            long long o_sh, const T* dout, long long d_sb,
                            long long d_st, long long d_sh, float* delta,
                            int b, int t, int h, int d) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= (long long)b * t * h) return;   // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int hi = (int)(row % h);
  const long long bt = row / h;
  const int ti = (int)(bt % t);
  const int bi = (int)(bt / t);
  const T* orow = out + bi * o_sb + ti * o_st + hi * o_sh;
  const T* drow = dout + bi * d_sb + ti * d_st + hi * d_sh;
  float acc = 0.f;
  for (int i = lane; i < d; i += 32)
    acc = fmaf(to_f32(drow[i]), to_f32(orow[i]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)bi * h + hi) * t + ti] = acc;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per dq block (4 warps x 16)
constexpr int BK = 64;   // keys per k tile (dq) and per dk/dv block

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16_kernel(BwdParams p) {
  constexpr int DP = D + 8;    // padded row of a row-major tile
  constexpr int TP = BK + 8;   // padded row of the transposed K tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][DP]
  bf16* dOs = Qs + BQ * DP;                        // [BQ][DP]
  bf16* Ks = dOs + BQ * DP;                        // [BK][DP]
  bf16* Vs = Ks + BK * DP;                         // [BK][DP]
  bf16* Kt = Vs + BK * DP;                         // [D][TP]

  const int n_qt = p.t / BQ;
  const int qt = p.causal ? (n_qt - 1 - (int)blockIdx.y) : (int)blockIdx.y;
  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row within the 8-row group
  const int t4 = lane & 3;   // fragment column pair

  const bf16* qg = static_cast<const bf16*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + bi * p.o_sb + hi * p.o_sh;
  const float* mg = p.mask ? p.mask + (long long)bi * p.t : nullptr;

  stage_rows<D>(Qs, nullptr, 0, qg, p.q_st, q0, BQ);
  stage_rows<D>(dOs, nullptr, 0, dog, p.o_st, q0, BQ);

  const int qr = warp * 16;          // this warp's first row in the tile
  const int row[2] = {q0 + qr + g, q0 + qr + g + 8};
  float lse[2], dl[2];
  bool live[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lse[hr] = p.lse[(long long)bh * p.t + row[hr]];
    dl[hr] = p.delta[(long long)bh * p.t + row[hr]];
    live[hr] = !(lse[hr] <= HALF_NEG);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_kt = p.causal ? (q0 + BQ + BK - 1) / BK : p.t / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous K/V tile
    stage_rows<D>(Ks, Kt, TP, kg, p.k_st, k0, BK);
    stage_rows<D>(Vs, nullptr, 0, vg, p.v_st, k0, BK);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] =
          dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4], da[4];
      load_a(qa, Qs, DP, qr, kc * 16, g, t4);
      load_a(da, dOs, DP, qr, kc * 16, g, t4);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mma_nk(s[j], qa, Ks, DP, j * 8, kc * 16, g, t4);
        mma_nk(dp[j], da, Vs, DP, j * 8, kc * 16, g, t4);
      }
    }

    // P from lse, then dS = P (dP - Delta) scale, kept in s
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + 2 * t4 + e;
        const bool key_ok = mg == nullptr || mg[col] > 0.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 2 * hr + e;
          const bool ok = key_ok && live[hr] && !(p.causal && col > row[hr]);
          const float pv = ok ? expf(s[j][i] * p.scale - lse[hr]) : 0.f;
          s[j][i] = pv * (dp[j][i] - dl[hr]) * p.scale;
        }
      }
    }

    // dq += dS K
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_nk(acc[n], a, Kt, TP, n * 8, kc * 16, g, t4);
    }
  }

  bf16* dqg = static_cast<bf16*>(p.g0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    bf16* r = dqg + (((long long)bi * p.t + row[hr]) * p.h + hi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(&r[n * 8 + 2 * t4]) =
          pack_bf16(acc[n][2 * hr], acc[n][2 * hr + 1]);
  }
}

// BQ2 query rows per step of the dk/dv loop: 64 at d = 64, 32 at d = 128 (the
// dk and dv accumulators of d = 128 leave fewer registers for the S tile).
template <int D, int BQ2>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_bf16_kernel(BwdParams p) {
  constexpr int DP = D + 8;
  constexpr int TP = BQ2 + 8;   // padded row of the transposed Q / dO tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][DP]
  bf16* Vs = Ks + BK * DP;                         // [BK][DP]
  bf16* Qs = Vs + BK * DP;                         // [BQ2][DP]
  bf16* dOs = Qs + BQ2 * DP;                       // [BQ2][DP]
  bf16* Qt = dOs + BQ2 * DP;                       // [D][TP]
  bf16* dOt = Qt + D * TP;                         // [D][TP]
  float* lse_s = reinterpret_cast<float*>(dOt + D * TP);   // [BQ2]
  float* dl_s = lse_s + BQ2;                               // [BQ2]

  const int k0 = (int)blockIdx.y * BK;   // causal: heaviest (k tile 0) first
  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const bf16* qg = static_cast<const bf16*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + bi * p.o_sb + hi * p.o_sh;
  const float* lg = p.lse + (long long)bh * p.t;
  const float* dg = p.delta + (long long)bh * p.t;

  stage_rows<D>(Ks, nullptr, 0, kg, p.k_st, k0, BK);
  stage_rows<D>(Vs, nullptr, 0, vg, p.v_st, k0, BK);

  const int kr = warp * 16;   // this warp's first key in the tile
  const int key[2] = {k0 + kr + g, k0 + kr + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    key_ok[hr] = p.mask == nullptr || p.mask[(long long)bi * p.t + key[hr]] > 0.f;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] =
        dv[n][2] = dv[n][3] = 0.f;

  for (int q0 = p.causal ? k0 : 0; q0 < p.t; q0 += BQ2) {
    __syncthreads();   // every warp is done with the previous Q/dO tile
    stage_rows<D>(Qs, Qt, TP, qg, p.q_st, q0, BQ2);
    stage_rows<D>(dOs, dOt, TP, dog, p.o_st, q0, BQ2);
    for (int i = threadIdx.x; i < BQ2; i += blockDim.x) {
      lse_s[i] = lg[q0 + i];
      dl_s[i] = dg[q0 + i];
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ2 queries
    float s[BQ2 / 8][4], dp[BQ2 / 8][4];
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] =
          dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, DP, kr, kc * 16, g, t4);
      load_a(va, Vs, DP, kr, kc * 16, g, t4);
#pragma unroll
      for (int j = 0; j < BQ2 / 8; ++j) {
        mma_nk(s[j], ka, Qs, DP, j * 8, kc * 16, g, t4);
        mma_nk(dp[j], va, dOs, DP, j * 8, kc * 16, g, t4);
      }
    }

    // P^T into s, dS^T into dp
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = j * 8 + 2 * t4 + e;
        const float l = lse_s[qi];
        const bool live = !(l <= HALF_NEG);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 2 * hr + e;
          const bool ok =
              key_ok[hr] && live && !(p.causal && key[hr] > q0 + qi);
          const float pv = ok ? expf(s[j][i] * p.scale - l) : 0.f;
          s[j][i] = pv;
          dp[j][i] = pv * (dp[j][i] - dl_s[qi]) * p.scale;
        }
      }
    }

    // dv += P^T dO, dk += dS^T Q
#pragma unroll
    for (int kc = 0; kc < BQ2 / 16; ++kc) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
      acc_to_a(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        mma_nk(dv[n], pa, dOt, TP, n * 8, kc * 16, g, t4);
        mma_nk(dk[n], da, Qt, TP, n * 8, kc * 16, g, t4);
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(p.g0);
  bf16* dvg = static_cast<bf16*>(p.g1);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const long long off = (((long long)bi * p.t + key[hr]) * p.h + hi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(&dkg[off + n * 8 + 2 * t4]) =
          pack_bf16(dk[n][2 * hr], dk[n][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(&dvg[off + n * 8 + 2 * t4]) =
          pack_bf16(dv[n][2 * hr], dv[n][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels, one thread per row
// ---------------------------------------------------------------------------

constexpr int R32 = 64;   // rows (threads) per block: queries (dq), keys (dk/dv)
constexpr int C32 = 32;   // keys (dq) or queries (dk/dv) per loop step

template <int D>
__global__ void __launch_bounds__(R32)
flash_bwd_dq_f32_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [R32][D + 1]
  float* dOs = Qs + R32 * (D + 1);                  // [R32][D + 1]
  float* Ks = dOs + R32 * (D + 1);                  // [C32][D]
  float* Vs = Ks + C32 * D;                         // [C32][D]

  const int n_qt = p.t / R32;
  const int qt = p.causal ? (n_qt - 1 - (int)blockIdx.y) : (int)blockIdx.y;
  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int q0 = qt * R32;
  const int tid = threadIdx.x;
  const int row = q0 + tid;

  const float* qg = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  const float* dog =
      static_cast<const float*>(p.dout) + bi * p.o_sb + hi * p.o_sh;
  const float* mg = p.mask ? p.mask + (long long)bi * p.t : nullptr;

  for (int c = tid; c < R32 * D; c += R32) {
    const int r = c / D, cc = c % D;
    Qs[r * (D + 1) + cc] = qg[(long long)(q0 + r) * p.q_st + cc];
    dOs[r * (D + 1) + cc] = dog[(long long)(q0 + r) * p.o_st + cc];
  }
  const float lse = p.lse[(long long)bh * p.t + row];
  const float dl = p.delta[(long long)bh * p.t + row];
  const bool live = !(lse <= HALF_NEG);

  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.f;

  const int n_kt = p.causal ? (q0 + R32 + C32 - 1) / C32 : p.t / C32;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * C32;
    __syncthreads();
    for (int c = tid; c < C32 * D; c += R32) {
      const int r = c / D, cc = c % D;
      Ks[c] = kg[(long long)(k0 + r) * p.k_st + cc];
      Vs[c] = vg[(long long)(k0 + r) * p.v_st + cc];
    }
    __syncthreads();

    float ds[C32];
#pragma unroll
    for (int j = 0; j < C32; ++j) {
      float sa = 0.f, pa = 0.f;
#pragma unroll 16
      for (int i = 0; i < D; ++i) {
        sa = fmaf(Qs[tid * (D + 1) + i], Ks[j * D + i], sa);
        pa = fmaf(dOs[tid * (D + 1) + i], Vs[j * D + i], pa);
      }
      const int col = k0 + j;
      const bool ok = live && (mg == nullptr || mg[col] > 0.f) &&
                      !(p.causal && col > row);
      const float pv = ok ? expf(sa * p.scale - lse) : 0.f;
      ds[j] = pv * (pa - dl) * p.scale;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float a = acc[i];
#pragma unroll
      for (int j = 0; j < C32; ++j) a = fmaf(ds[j], Ks[j * D + i], a);
      acc[i] = a;
    }
  }

  float* r = static_cast<float*>(p.g0) + (((long long)bi * p.t + row) * p.h + hi) * D;
#pragma unroll
  for (int i = 0; i < D; ++i) r[i] = acc[i];
}

template <int D>
__global__ void __launch_bounds__(R32)
flash_bwd_dkv_f32_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [R32][D + 1]
  float* Vs = Ks + R32 * (D + 1);                   // [R32][D + 1]
  float* dKa = Vs + R32 * (D + 1);                  // [R32][D + 1] dk sums
  float* dVa = dKa + R32 * (D + 1);                 // [R32][D + 1] dv sums
  float* Qs = dVa + R32 * (D + 1);                  // [C32][D]
  float* dOs = Qs + C32 * D;                        // [C32][D]
  float* lse_s = dOs + C32 * D;                     // [C32]
  float* dl_s = lse_s + C32;                        // [C32]

  const int k0 = (int)blockIdx.y * R32;
  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int tid = threadIdx.x;
  const int key = k0 + tid;

  const float* qg = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  const float* dog =
      static_cast<const float*>(p.dout) + bi * p.o_sb + hi * p.o_sh;
  const float* lg = p.lse + (long long)bh * p.t;
  const float* dg = p.delta + (long long)bh * p.t;

  for (int c = tid; c < R32 * D; c += R32) {
    const int r = c / D, cc = c % D;
    Ks[r * (D + 1) + cc] = kg[(long long)(k0 + r) * p.k_st + cc];
    Vs[r * (D + 1) + cc] = vg[(long long)(k0 + r) * p.v_st + cc];
    dKa[r * (D + 1) + cc] = 0.f;
    dVa[r * (D + 1) + cc] = 0.f;
  }
  const bool key_ok =
      p.mask == nullptr || p.mask[(long long)bi * p.t + key] > 0.f;

  for (int q0 = p.causal ? k0 : 0; q0 < p.t; q0 += C32) {
    __syncthreads();
    for (int c = tid; c < C32 * D; c += R32) {
      const int r = c / D, cc = c % D;
      Qs[c] = qg[(long long)(q0 + r) * p.q_st + cc];
      dOs[c] = dog[(long long)(q0 + r) * p.o_st + cc];
    }
    if (tid < C32) {
      lse_s[tid] = lg[q0 + tid];
      dl_s[tid] = dg[q0 + tid];
    }
    __syncthreads();

    float pr[C32], ds[C32];
#pragma unroll
    for (int j = 0; j < C32; ++j) {
      float sa = 0.f, pa = 0.f;
#pragma unroll 16
      for (int i = 0; i < D; ++i) {
        sa = fmaf(Ks[tid * (D + 1) + i], Qs[j * D + i], sa);
        pa = fmaf(Vs[tid * (D + 1) + i], dOs[j * D + i], pa);
      }
      const float l = lse_s[j];
      const bool ok = key_ok && !(l <= HALF_NEG) &&
                      !(p.causal && key > q0 + j);
      const float pv = ok ? expf(sa * p.scale - l) : 0.f;
      pr[j] = pv;
      ds[j] = pv * (pa - dl_s[j]) * p.scale;
    }
    for (int i = 0; i < D; ++i) {
      float av = dVa[tid * (D + 1) + i], ak = dKa[tid * (D + 1) + i];
#pragma unroll
      for (int j = 0; j < C32; ++j) {
        av = fmaf(pr[j], dOs[j * D + i], av);
        ak = fmaf(ds[j], Qs[j * D + i], ak);
      }
      dVa[tid * (D + 1) + i] = av;
      dKa[tid * (D + 1) + i] = ak;
    }
  }

  const long long off = (((long long)bi * p.t + key) * p.h + hi) * D;
  float* dkr = static_cast<float*>(p.g0) + off;
  float* dvr = static_cast<float*>(p.g1) + off;
  for (int i = 0; i < D; ++i) {
    dkr[i] = dKa[tid * (D + 1) + i];
    dvr[i] = dVa[tid * (D + 1) + i];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int rows_per_block,
                   size_t smem, const BwdParams& prm, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // b*h on x (up to 2^31 - 1 blocks), row tiles on y (t / 64 <= 65535)
  dim3 grid(prm.b * prm.h, prm.t / rows_per_block);
  kernel<<<grid, threads, smem, stream>>>(prm);
  return cudaGetLastError();
}

constexpr size_t dq_bf16_smem(int d) {
  return (size_t)(2 * BQ * (d + 8) + 2 * BK * (d + 8) + d * (BK + 8)) * 2;
}
constexpr size_t dkv_bf16_smem(int d, int bq2) {
  return (size_t)(2 * BK * (d + 8) + 2 * bq2 * (d + 8) + 2 * d * (bq2 + 8)) * 2 +
         2 * bq2 * sizeof(float);
}
constexpr size_t dq_f32_smem(int d) {
  return (size_t)(2 * R32 * (d + 1) + 2 * C32 * d) * sizeof(float);
}
constexpr size_t dkv_f32_smem(int d) {
  return (size_t)(4 * R32 * (d + 1) + 2 * C32 * d + 2 * C32) * sizeof(float);
}

bool shape_ok(int t) { return t > 0 && t % BQ == 0 && t % BK == 0 && t % R32 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Each function
// returns a cudaError_t (0 = launched); the kernel runs on `stream`
// asynchronously.
extern "C" int flash_bwd_preprocess(int dtype, int d, const void* out,
                                    long long o_sb, long long o_st,
                                    long long o_sh, const void* dout,
                                    long long d_sb, long long d_st,
                                    long long d_sh, float* delta, int b,
                                    int t, int h, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)b * t * h;
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (rows + threads / 32 - 1) / (threads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    flash_bwd_preprocess_kernel<bf16><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const bf16*>(out), o_sb, o_st, o_sh,
        static_cast<const bf16*>(dout), d_sb, d_st, d_sh, delta, b, t, h, d);
  } else if (dtype == 0) {
    flash_bwd_preprocess_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(out), o_sb, o_st, o_sh,
        static_cast<const float*>(dout), d_sb, d_st, d_sh, delta, b, t, h, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
      return (int)launch(flash_bwd_dq_bf16_kernel<64>, 128, BQ,
                         dq_bf16_smem(64), prm, st);
    if (d == 128)
      return (int)launch(flash_bwd_dq_bf16_kernel<128>, 128, BQ,
                         dq_bf16_smem(128), prm, st);
  } else if (dtype == 0) {
    if (d == 64)
      return (int)launch(flash_bwd_dq_f32_kernel<64>, R32, R32,
                         dq_f32_smem(64), prm, st);
    if (d == 128)
      return (int)launch(flash_bwd_dq_f32_kernel<128>, R32, R32,
                         dq_f32_smem(128), prm, st);
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
    if (d == 64)
      return (int)launch(flash_bwd_dkv_bf16_kernel<64, 64>, 128, BK,
                         dkv_bf16_smem(64, 64), prm, st);
    if (d == 128)
      return (int)launch(flash_bwd_dkv_bf16_kernel<128, 32>, 128, BK,
                         dkv_bf16_smem(128, 32), prm, st);
  } else if (dtype == 0) {
    if (d == 64)
      return (int)launch(flash_bwd_dkv_f32_kernel<64>, R32, R32,
                         dkv_f32_smem(64), prm, st);
    if (d == 128)
      return (int)launch(flash_bwd_dkv_f32_kernel<128>, R32, R32,
                         dkv_f32_smem(128), prm, st);
  }
  return (int)cudaErrorInvalidValue;
}
