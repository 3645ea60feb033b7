// The 3xTF32 building blocks shared by the f32 flash kernels
// (flash_fwd_f32.cu, flash_bwd_f32.cu): the pre-pass that splits f32
// operands into tf32 hi/lo planes, the TMA loads of those planes, and the
// wgmma products in 3xTF32 (S summed in parts of d by both kernels alike).
//
// 3xTF32. Each f32 operand x is split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) (round to nearest, ties away, for both), and each
// product A B is summed in f32 as lo(A) hi(B) + hi(A) lo(B), then
// hi(A) hi(B) (the small terms first). The dropped lo lo term and lo's own
// rounding leave about 3 * 2^-22 of |A| |B| per product, near f32's 2^-24
// and far from plain TF32's 2^-11.
//
// Layouts. tf32 wgmma reads both shared-memory operands K-major (reduction
// index contiguous) and has no transpose bit. A product that reduces over
// the rows of a [t][d] tensor (P V, dS K, ...) therefore reads that tensor
// transposed, [d][t]. The pre-pass writes, per (b, h), planes of t x d
// floats: the hi and lo of a tensor row by row ([t][d]) and/or transposed
// ([d][t]). The register A operand (P or dS, taken from an accumulator) is
// the other half of the layout problem: the accumulator gives thread t4
// the columns 2 t4 and 2 t4 + 1 of each 8-column group, the tf32 A
// fragment of m64nNk8 wants k = t4 and t4 + 4. Rather than shuffle, the
// kernels pass the accumulator's values as they are and the pre-pass
// stores the transposed planes' t index permuted within each group of 8,
// so that k slot p holds row 2p (p < 4) or 2(p - 4) + 1: the reduction
// pairs the same terms.

#pragma once

#include "hopper.cuh"

namespace hopper {

constexpr int R = 64;   // rows of a stationary tile: one warpgroup's

// the plane (tensor, part) of head bh in a scratch of [tensors][2][bhs]
// planes, as the z coordinate of its tensor maps
__device__ __forceinline__ int plane_z(int tensor, int part, int bh, int bhs) {
  return (2 * tensor + part) * bhs + bh;
}

// the rows [r0, r0 + n) of the plane (tensor, part) of head bh into a tile
// of n rows, one TMA box per 32-column chunk
template <int D>
__device__ __forceinline__ void load_plane_rows(uint32_t dst,
                                                const CUtensorMap* map, int n,
                                                int r0, int z, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < D / 32; ++c)
    tma_load_3d(dst + c * n * 128, map, c * 32, r0, z, bar);
}

// the transposed plane's columns [c0, c0 + C) (all D rows) into a tile of
// D rows, one box per 32 columns
template <int D, int C>
__device__ __forceinline__ void load_plane_cols(uint32_t dst,
                                                const CUtensorMap* map, int c0,
                                                int z, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < C / 32; ++c)
    tma_load_3d(dst + c * D * 128, map, c0 + c * 32, 0, z, bar);
}

// A fragment of k step kc from an accumulator of N columns, the values
// split into tf32 hi and lo. The fragment's k slots t4 and t4 + 4 take the
// accumulator's columns 2 t4 and 2 t4 + 1 (the pre-pass's permutation).
template <int N>
__device__ __forceinline__ void split_frags(uint32_t (*hi)[4],
                                            uint32_t (*lo)[4],
                                            const float* acc) {
#pragma unroll
  for (int kc = 0; kc < N / 8; ++kc) {
    const float v[4] = {acc[4 * kc], acc[4 * kc + 2], acc[4 * kc + 1],
                        acc[4 * kc + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[kc][i] = tf32_rna(v[i]);
      lo[kc][i] = tf32_rna(v[i] - __uint_as_float(hi[kc][i]));
    }
  }
}

// acc (64 x N) = A B^T over the columns [8 K0, 8 K1) of D in 3xTF32
// (all D by default), A (64 rows) and B (N rows of a tile whose 32-column
// chunks are `b_rows` rows apart) K-major.
template <int D, int N, int K0 = 0, int K1 = D / 8>
__device__ __forceinline__ void product_ss(float* acc, uint32_t a_hi,
                                           uint32_t a_lo, uint32_t b_hi,
                                           uint32_t b_lo, int b_rows) {
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
    WgmmaTf32<N>::ss(acc, kmajor_desc(a_lo, R, kk),
                     kmajor_desc(b_hi, b_rows, kk), kk > K0);
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
    WgmmaTf32<N>::ss(acc, kmajor_desc(a_hi, R, kk),
                     kmajor_desc(b_lo, b_rows, kk), 1);
#pragma unroll
  for (int kk = K0; kk < K1; ++kk)
    WgmmaTf32<N>::ss(acc, kmajor_desc(a_hi, R, kk),
                     kmajor_desc(b_hi, b_rows, kk), 1);
}

// acc (64 x N) = A B^T over all D columns as product_ss computes it, but
// summed in SK parts of D / SK columns: each part's three products in a
// fresh accumulator, the parts added with FADD in a fixed order. The
// tensor cores truncate their accumulator at every k step; a part's few k
// steps at a fraction of the full sum's magnitude cost less than all of D
// summed in one accumulator (SK = 1, which is product_ss). Two
// accumulators (acc and tmp): parts 0 and 1 run together, each further
// part in tmp once it has been added. Issues, commits and waits for its
// own products: no other wgmma group may be in flight.
template <int D, int N, int SK>
__device__ __forceinline__ void product_ss_parts(float* acc, float* tmp,
                                                 uint32_t a_hi, uint32_t a_lo,
                                                 uint32_t b_hi, uint32_t b_lo,
                                                 int b_rows) {
  static_assert(SK == 1 || SK == 2 || SK == 4, "1, 2 or 4 parts");
  constexpr int P = D / 8 / SK;
  auto finish = [&](bool add) {
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<N / 2>(acc);
    if (!add) return;
    fence_regs<N / 2>(tmp);
#pragma unroll
    for (int x = 0; x < N / 2; ++x) acc[x] += tmp[x];
  };
  wgmma_fence();
  product_ss<D, N, 0, P>(acc, a_hi, a_lo, b_hi, b_lo, b_rows);
  if constexpr (SK == 1) {
    finish(false);
  } else {
    product_ss<D, N, P, 2 * P>(tmp, a_hi, a_lo, b_hi, b_lo, b_rows);
    finish(true);
    if constexpr (SK == 4) {
      wgmma_fence();
      product_ss<D, N, 2 * P, 3 * P>(tmp, a_hi, a_lo, b_hi, b_lo, b_rows);
      finish(true);
      wgmma_fence();
      product_ss<D, N, 3 * P, 4 * P>(tmp, a_hi, a_lo, b_hi, b_lo, b_rows);
      finish(true);
    }
  }
}

// acc (64 x D) += A B in 3xTF32, A the register fragments of N streamed
// rows (k steps k0/8 ..), B a transposed tile of D rows (32-column chunks
// D rows apart). Each 64-column part of the product is taken alone into a
// fresh accumulator and added to acc with FADD. The tensor cores do not
// round their accumulator to nearest, so hundreds of tiles summed in it
// drift one way (a causal key's first tiles are large, its later ones
// small); a tile's own sum is short.
template <int D, int N>
__device__ __forceinline__ void product_rs(float* acc, uint32_t (*a_hi)[4],
                                           uint32_t (*a_lo)[4], uint32_t b_hi,
                                           uint32_t b_lo, int k0) {
  fence_regs<N / 2>(&a_hi[0][0]);
  fence_regs<N / 2>(&a_lo[0][0]);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    const uint32_t bh = b_hi + c * 64 * 128, bl = b_lo + c * 64 * 128;
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    fence_regs<32>(part);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < N / 8; ++kc) {
      wgmma_tf32_rs_n64(part, a_lo[kc], kmajor_desc(bh, D, k0 / 8 + kc),
                        kc > 0);
      wgmma_tf32_rs_n64(part, a_hi[kc], kmajor_desc(bl, D, k0 / 8 + kc), 1);
    }
#pragma unroll
    for (int kc = 0; kc < N / 8; ++kc)
      wgmma_tf32_rs_n64(part, a_hi[kc], kmajor_desc(bh, D, k0 / 8 + kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * c + i] += part[i];
  }
  fence_regs<N / 2>(&a_hi[0][0]);
  fence_regs<N / 2>(&a_lo[0][0]);
}

// ---------------------------------------------------------------------------
// the pre-pass: tf32 splits and transposed copies
// ---------------------------------------------------------------------------

constexpr int SPLIT_ROWS = 32;
constexpr int SPLIT_THREADS = 256;

struct SplitParams {
  const float* x[4];          // up to 4 [b, t, h, d] strided views
  long long sb[4], st[4], sh[4];
  int rows[4];                // each tensor's row plane, or -1 for none
  int cols[4];                // its transposed plane, or -1 for none
  float* split;               // [planes][2][b*h][t * d]
  int b, t, h;
};

// the t index a transposed plane stores at position u of a group of 8
__device__ __forceinline__ int permuted(int u) {
  const int p = u & 7;
  return (u & ~7) + (p < 4 ? 2 * p : 2 * (p - 4) + 1);
}

// The body of a pre-pass block (b*h, 32 rows, tensor x = blockIdx.z):
// 16-byte loads of the rows, hi and lo written row by row where the tensor
// has a row plane, and, where it has a transposed plane, through shared
// memory to it, 32 consecutive t per warp store.
template <int D>
__device__ __forceinline__ void split_rows(const SplitParams& p) {
  __shared__ float hs[SPLIT_ROWS][D + 1], ls[SPLIT_ROWS][D + 1];
  const int bh = blockIdx.x, r0 = (int)blockIdx.y * SPLIT_ROWS;
  const int x = blockIdx.z;
  const int bi = bh / p.h, hi = bh % p.h;
  const int rp = p.rows[x], cp = p.cols[x];   // uniform over the block
  const long long bhs = (long long)p.b * p.h, plane = (long long)p.t * D;
  const float* src = p.x[x] + bi * p.sb[x] + hi * p.sh[x];
  float* rh = rp < 0 ? nullptr : p.split + (2 * rp * bhs + bh) * plane;
  float* rl = rp < 0 ? nullptr : p.split + ((2 * rp + 1) * bhs + bh) * plane;
  for (int i = threadIdx.x; i < SPLIT_ROWS * D / 4; i += SPLIT_THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        src + (long long)(r0 + r) * p.st[x] + c));
    const float in[4] = {v.x, v.y, v.z, v.w};
    float h4[4], l4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h4[e] = __uint_as_float(tf32_rna(in[e]));
      l4[e] = __uint_as_float(tf32_rna(in[e] - h4[e]));
      if (cp >= 0) {
        hs[r][c + e] = h4[e];
        ls[r][c + e] = l4[e];
      }
    }
    if (rp >= 0) {
      const long long at = (long long)(r0 + r) * D + c;
      *reinterpret_cast<float4*>(rh + at) =
          make_float4(h4[0], h4[1], h4[2], h4[3]);
      *reinterpret_cast<float4*>(rl + at) =
          make_float4(l4[0], l4[1], l4[2], l4[3]);
    }
  }
  if (cp < 0) return;
  __syncthreads();
  float* th = p.split + (2 * cp * bhs + bh) * plane;
  float* tl = p.split + ((2 * cp + 1) * bhs + bh) * plane;
  for (int i = threadIdx.x; i < D * SPLIT_ROWS; i += SPLIT_THREADS) {
    const int d = i / SPLIT_ROWS, u = i % SPLIT_ROWS;
    const int r = permuted(u);
    th[(long long)d * p.t + r0 + u] = hs[r][d];
    tl[(long long)d * p.t + r0 + u] = ls[r][d];
  }
}

// the host side: one pre-pass launch of `kernel` (a __global__ wrapper of
// split_rows<D>) over the first n tensors of p
template <typename Kernel>
cudaError_t launch_split(Kernel kernel, const SplitParams& p, int n,
                         cudaStream_t stream) {
  dim3 grid(p.b * p.h, p.t / SPLIT_ROWS, n);
  kernel<<<grid, SPLIT_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// The maps over a scratch of `planes` planes of t x d floats: its row
// planes in boxes of `rows_a` and of `rows_b` rows, and its transposed
// planes in boxes of all d rows.
inline bool encode_planes(CUtensorMap* ra, CUtensorMap* rb, CUtensorMap* tr,
                          const float* split, int d, int t, long long planes,
                          int rows_a, int rows_b) {
  return encode_f32_3d(ra, split, d, t, planes, rows_a) &&
         encode_f32_3d(rb, split, d, t, planes, rows_b) &&
         encode_f32_3d(tr, split, t, d, planes, d);
}

}  // namespace hopper
