// The gated short convolution of a hybrid conv/attention LM (LFM2), forward
// and backward, bound through a plain C interface (ctypes). For bcx =
// [B | C | x] [b, t, 3c] contiguous and filters w [c, L] (f32; w[:, L-1]
// weighs the current step):
//
//   shortconv_fwd   u = B x,  z[t] = sum_j w[:, j] u[t - (L-1) + j],  y = C z
//                   (u zero before the first step), y [b, t, c] in bcx's
//                   dtype;
//   shortconv_bwd   from dy [b, t, c]:
//                     gz = dy C,  dC = dy z,
//                     gu[t] = sum_j w[:, j] gz[t + L-1 - j]  (zero past t),
//                     dB = gu x,  dx = gu B,
//                   written into one [b, t, 3c] buffer [dB | dC | dx] in
//                   bcx's dtype, and
//                     dw[c, j] = sum_t gz[t] u[t - (L-1) + j]
//                   in f32: each block's sum over its tile to a partials
//                   buffer [P, c, L], then a second launch sums the P
//                   partials of each filter tap in a fixed order. No atomics:
//                   two runs are bitwise equal.
//
// Replaces no TPU kernel: the JAX package has no such layer. It replaces the
// port's plain PyTorch passes (ops/short_conv.py), about 15 f32 passes over
// strided thirds of bcx a call, forward and backward.
//
// Bound: bytes. Per token and channel the forward reads B, C and x and writes
// y; the backward reads dy, B, C and x and writes dB, dC and dx: 11 values,
// 22 B in bf16. At LFM2-8B-A1B's c = 2,048 and 8,192 tokens that is 369 MB,
// 110 us at 3.35 TB/s, for 9 conv layers a step 0.99 ms. The arithmetic
// (about 4L + 8 flops a value) is far below the card's balance point.
//
// Design. Each thread owns 16 bytes of channels (8 bf16 or 4 f32) of one row
// and walks a tile of TILE steps in order, so every value it needs is read
// once with one 16-byte load, neighbouring threads on neighbouring channels.
// The conv's window lives in registers: the forward keeps the last L-1
// values of u as it walks; the backward keeps the last L values of B, x and
// gz, so z[s] is formed again from u with no second read, and gu[s] is
// finished L-1 steps later, when gz[s + L-1] has been read. Only the halos
// are read twice: L-1 steps of B and x before a tile (both passes) and L-1
// steps of C and dy after it (the backward), 1/16 of the backward's reads at
// L = 3. Loads for 4 steps (2 where L > 4) are issued before any of them is
// used, so a thread keeps 3 (forward) or 4 (backward) 16-byte loads a step
// in flight over those steps. Arithmetic is f32, as the plain path's; each
// output is rounded once, at its store. L is a template argument (1..8), so
// the windows are registers and their shifts are renames. Where c is not a
// multiple of the 16-byte group (8 in bf16, 4 in f32) or a pointer is not
// 16-byte aligned, the whole launch takes the scalar path: one channel a
// thread, the same walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define SHORT_CONV_TILE 32      // steps a block walks, forward and backward
#define SHORT_CONV_MAX_L 8

namespace {

constexpr int THREADS = 128;
constexpr int TILE = SHORT_CONV_TILE;

// A thread's channels of one step, as loaded: ALIGNED, 16 bytes of them
// (8 bf16 or 4 f32) in one vector load; else one channel.
template <typename T, bool ALIGNED>
struct Pack;

template <typename T>
struct Pack<T, true> {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float (&v)[N]) const {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = f[i];
    }
  }
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
struct Pack<T, false> {
  static constexpr int N = 1;
  float f;
  __device__ __forceinline__ void load(const T* p) { f = to_f32(*p); }
  __device__ __forceinline__ void zero() { f = 0.f; }
  __device__ __forceinline__ void get(float (&v)[N]) const { v[0] = f; }
};

// store N f32 values as T, each rounded once (round to nearest even)
template <typename T, bool ALIGNED, int N>
__device__ __forceinline__ void store(T* p, const float (&v)[N]) {
  if constexpr (ALIGNED) {
    uint4 raw;
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    } else {
      float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = v[i];
    }
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    if constexpr (sizeof(T) == 2) *p = __float2bfloat16_rn(v[0]);
    else *p = v[0];
  }
}

// The taps w[ch + i, j] of the thread's channels.
template <int L, int N>
__device__ __forceinline__ void load_taps(const float* __restrict__ w,
                                          int ch, float (&wr)[L][N]) {
#pragma unroll
  for (int j = 0; j < L; ++j)
#pragma unroll
    for (int i = 0; i < N; ++i) wr[j][i] = w[(long long)(ch + i) * L + j];
}

template <typename T, int L, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    shortconv_fwd_kernel(const T* __restrict__ bcx,
                         const float* __restrict__ w, T* __restrict__ y,
                         int t, int c) {
  using P = Pack<T, ALIGNED>;
  constexpr int N = P::N;
  const int ch = (blockIdx.x * THREADS + threadIdx.x) * N;
  if (ch >= c) return;
  const int t0 = blockIdx.y * TILE, t1 = min(t, t0 + TILE);
  const long long row = 3LL * c;
  const T* in = bcx + (long long)blockIdx.z * t * row + ch;
  T* out = y + (long long)blockIdx.z * t * c + ch;
  float wr[L][N];
  load_taps<L, N>(w, ch, wr);

  // u[k] = u at step s - (L-1) + k while step s is formed; before the tile,
  // u[1..L-1] = the halo, u at t0 - L + 1 .. t0 - 1 (0 before step 0)
  float u[L][N];
#pragma unroll
  for (int k = 1; k < L; ++k) {
    const int s = t0 - L + k;
    P pb, px;
    if (s >= 0) {
      pb.load(in + s * row);
      px.load(in + s * row + 2 * c);
    } else {
      pb.zero();
      px.zero();
    }
    float bv[N], xv[N];
    pb.get(bv);
    px.get(xv);
#pragma unroll
    for (int i = 0; i < N; ++i) u[k][i] = bv[i] * xv[i];
  }

  // steps whose loads are issued together (fewer for long filters,
  // whose windows take the registers)
  constexpr int UNROLL = L <= 4 ? 4 : 2;
  for (int s0 = t0; s0 < t1; s0 += UNROLL) {
    P pb[UNROLL], pc[UNROLL], px[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      if (s0 + q < t1) {
        const T* at = in + (s0 + q) * row;
        pb[q].load(at);
        pc[q].load(at + c);
        px[q].load(at + 2 * c);
      }
    }
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      if (s0 + q < t1) {
        float bv[N], cv[N], xv[N], yv[N];
        pb[q].get(bv);
        pc[q].get(cv);
        px[q].get(xv);
#pragma unroll
        for (int k = 0; k + 1 < L; ++k)
#pragma unroll
          for (int i = 0; i < N; ++i) u[k][i] = u[k + 1][i];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          u[L - 1][i] = bv[i] * xv[i];
          float z = wr[0][i] * u[0][i];
#pragma unroll
          for (int j = 1; j < L; ++j) z = fmaf(wr[j][i], u[j][i], z);
          yv[i] = cv[i] * z;
        }
        store<T, ALIGNED, N>(out + (long long)(s0 + q) * c, yv);
      }
    }
  }
}

// Step r of the backward's walk over [t0 - (L-1), t1 + L-1): B and x are
// read where r is a step of the tile or of the halo before it, C and dy
// where it is a step of the tile or of the halo after it.
template <typename T, int L, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    shortconv_bwd_kernel(const T* __restrict__ bcx,
                         const float* __restrict__ w,
                         const T* __restrict__ dy, T* __restrict__ grad,
                         float* __restrict__ partials, int t, int c) {
  using P = Pack<T, ALIGNED>;
  constexpr int N = P::N;
  const int ch = (blockIdx.x * THREADS + threadIdx.x) * N;
  if (ch >= c) return;
  const int t0 = blockIdx.y * TILE, t1 = min(t, t0 + TILE);
  const long long row = 3LL * c;
  const long long first = (long long)blockIdx.z * t;
  const T* in = bcx + first * row + ch;
  const T* gin = dy + first * c + ch;
  T* out = grad + first * row + ch;
  float wr[L][N];
  load_taps<L, N>(w, ch, wr);

  // windows over steps r - (L-1) .. r: B and x (u = B x formed again where
  // needed) and gz; 0 outside the row and, for gz, before the tile
  float bw[L][N], xw[L][N], gw[L][N], dw[L][N];
#pragma unroll
  for (int k = 0; k < L; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) bw[k][i] = xw[k][i] = gw[k][i] = dw[k][i] = 0.f;

  const int r_end = t1 + L - 1;
  // steps whose loads are issued together (fewer for long filters,
  // whose windows take the registers)
  constexpr int UNROLL = L <= 4 ? 4 : 2;
  for (int r0 = t0 - (L - 1); r0 < r_end; r0 += UNROLL) {
    P pb[UNROLL], px[UNROLL], pc[UNROLL], pd[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      const int r = r0 + q;
      if (r >= 0 && r < t1) {
        const T* at = in + r * row;
        pb[q].load(at);
        px[q].load(at + 2 * c);
      } else {
        pb[q].zero();
        px[q].zero();
      }
      if (r >= t0 && r < t && r < r_end) {
        pc[q].load(in + r * row + c);
        pd[q].load(gin + (long long)r * c);
      } else {
        pc[q].zero();
        pd[q].zero();
      }
    }
#pragma unroll
    for (int q = 0; q < UNROLL; ++q) {
      const int r = r0 + q;
      if (r < r_end) {
        float cv[N], dv[N], dc[N];
#pragma unroll
        for (int k = 0; k + 1 < L; ++k)
#pragma unroll
          for (int i = 0; i < N; ++i) {
            bw[k][i] = bw[k + 1][i];
            xw[k][i] = xw[k + 1][i];
            gw[k][i] = gw[k + 1][i];
          }
        pb[q].get(bw[L - 1]);
        px[q].get(xw[L - 1]);
        pc[q].get(cv);
        pd[q].get(dv);
#pragma unroll
        for (int i = 0; i < N; ++i) gw[L - 1][i] = dv[i] * cv[i];
        if (r >= t0 && r < t1) {
          // z[r] from the window of u, dC[r], and the taps' sums
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float g = gw[L - 1][i];
            float uk = bw[0][i] * xw[0][i];
            float z = wr[0][i] * uk;
            dw[0][i] = fmaf(g, uk, dw[0][i]);
#pragma unroll
            for (int j = 1; j < L; ++j) {
              uk = bw[j][i] * xw[j][i];
              z = fmaf(wr[j][i], uk, z);
              dw[j][i] = fmaf(g, uk, dw[j][i]);
            }
            dc[i] = dv[i] * z;
          }
          store<T, ALIGNED, N>(out + r * row + c, dc);
        }
        const int s = r - (L - 1);
        if (s >= t0 && s < t1) {
          // gu[s] = sum_j w[j] gz[s + L-1 - j]; B[s], x[s] at the window's
          // start
          float db[N], dx[N];
#pragma unroll
          for (int i = 0; i < N; ++i) {
            float gu = wr[0][i] * gw[L - 1][i];
#pragma unroll
            for (int j = 1; j < L; ++j)
              gu = fmaf(wr[j][i], gw[L - 1 - j][i], gu);
            db[i] = gu * xw[0][i];
            dx[i] = gu * bw[0][i];
          }
          store<T, ALIGNED, N>(out + s * row, db);
          store<T, ALIGNED, N>(out + s * row + 2 * c, dx);
        }
      }
    }
  }
  // this block's sums of the taps over its tile: partials[tile, ch + i, j]
  float* part = partials +
                ((long long)blockIdx.z * gridDim.y + blockIdx.y) * c * L +
                (long long)ch * L;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < L; ++j) part[i * L + j] = dw[j][i];
}

// dw[e] = sum over p of partials[p, e], p in order, for e in [0, n)
__global__ void __launch_bounds__(256)
    shortconv_dw_kernel(const float* __restrict__ partials, int n_partials,
                        long long n, float* __restrict__ dw) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int p = 0; p < n_partials; ++p) sum += partials[p * n + e];
  dw[e] = sum;
}

// blocks over b rows, t steps in tiles, and c channels n a thread
dim3 grid_for(int n, int b, int t, int c) {
  return dim3((c + n * THREADS - 1) / (n * THREADS), (t + TILE - 1) / TILE,
              b);
}

template <typename T>
bool vectors(int c, uintptr_t pointers) {
  return c % Pack<T, true>::N == 0 && (pointers & 15) == 0;
}

template <typename T, int L>
cudaError_t launch_fwd(const void* bcx, const float* w, void* y, int b,
                       int t, int c, cudaStream_t stream) {
  const T* in = static_cast<const T*>(bcx);
  T* out = static_cast<T*>(y);
  if (vectors<T>(c, reinterpret_cast<uintptr_t>(bcx) |
                        reinterpret_cast<uintptr_t>(y)))
    shortconv_fwd_kernel<T, L, true>
        <<<grid_for(Pack<T, true>::N, b, t, c), THREADS, 0, stream>>>(
            in, w, out, t, c);
  else
    shortconv_fwd_kernel<T, L, false>
        <<<grid_for(1, b, t, c), THREADS, 0, stream>>>(in, w, out, t, c);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_bwd(const void* bcx, const float* w, const void* dy,
                       void* grad, float* partials, int b, int t, int c,
                       cudaStream_t stream) {
  const T* in = static_cast<const T*>(bcx);
  const T* gin = static_cast<const T*>(dy);
  T* out = static_cast<T*>(grad);
  if (vectors<T>(c, reinterpret_cast<uintptr_t>(bcx) |
                        reinterpret_cast<uintptr_t>(dy) |
                        reinterpret_cast<uintptr_t>(grad)))
    shortconv_bwd_kernel<T, L, true>
        <<<grid_for(Pack<T, true>::N, b, t, c), THREADS, 0, stream>>>(
            in, w, gin, out, partials, t, c);
  else
    shortconv_bwd_kernel<T, L, false>
        <<<grid_for(1, b, t, c), THREADS, 0, stream>>>(in, w, gin, out,
                                                        partials, t, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(int L, const void* bcx, const float* w, void* y,
                         int b, int t, int c, cudaStream_t s) {
  switch (L) {
    case 1: return launch_fwd<T, 1>(bcx, w, y, b, t, c, s);
    case 2: return launch_fwd<T, 2>(bcx, w, y, b, t, c, s);
    case 3: return launch_fwd<T, 3>(bcx, w, y, b, t, c, s);
    case 4: return launch_fwd<T, 4>(bcx, w, y, b, t, c, s);
    case 5: return launch_fwd<T, 5>(bcx, w, y, b, t, c, s);
    case 6: return launch_fwd<T, 6>(bcx, w, y, b, t, c, s);
    case 7: return launch_fwd<T, 7>(bcx, w, y, b, t, c, s);
    case 8: return launch_fwd<T, 8>(bcx, w, y, b, t, c, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_bwd(int L, const void* bcx, const float* w,
                         const void* dy, void* grad, float* partials, int b,
                         int t, int c, cudaStream_t s) {
  switch (L) {
    case 1: return launch_bwd<T, 1>(bcx, w, dy, grad, partials, b, t, c, s);
    case 2: return launch_bwd<T, 2>(bcx, w, dy, grad, partials, b, t, c, s);
    case 3: return launch_bwd<T, 3>(bcx, w, dy, grad, partials, b, t, c, s);
    case 4: return launch_bwd<T, 4>(bcx, w, dy, grad, partials, b, t, c, s);
    case 5: return launch_bwd<T, 5>(bcx, w, dy, grad, partials, b, t, c, s);
    case 6: return launch_bwd<T, 6>(bcx, w, dy, grad, partials, b, t, c, s);
    case 7: return launch_bwd<T, 7>(bcx, w, dy, grad, partials, b, t, c, s);
    case 8: return launch_bwd<T, 8>(bcx, w, dy, grad, partials, b, t, c, s);
  }
  return cudaErrorInvalidValue;
}

bool valid_shape(int b, int t, int c, int L) {
  return b >= 0 && t >= 0 && c >= 0 && L >= 1 && L <= SHORT_CONV_MAX_L &&
         b <= 65535 && (t + TILE - 1) / TILE <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (bcx and y); w is f32 [c, L]. Returns
// the launch's cudaError_t; nothing is launched for an empty input.
extern "C" int shortconv_fwd(const void* bcx, const float* w, void* y, int b,
                             int t, int c, int L, int dtype, void* stream) {
  if (!valid_shape(b, t, c, L) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)b * t * c == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? dispatch_fwd<__nv_bfloat16>(L, bcx, w, y, b, t, c, s)
                   : dispatch_fwd<float>(L, bcx, w, y, b, t, c, s));
}

// dtype as above for bcx, dy and grad [b, t, 3c]; partials f32 [n_partials,
// c, L] with n_partials = b * ceil(t / SHORT_CONV_TILE); dw f32 [c, L]. Two
// launches: the tiles, then the fixed-order sum of their partials (dw = 0
// where the input has no step).
extern "C" int shortconv_bwd(const void* bcx, const float* w, const void* dy,
                             void* grad, float* partials, int n_partials,
                             float* dw, int b, int t, int c, int L, int dtype,
                             void* stream) {
  if (!valid_shape(b, t, c, L) || (dtype != 0 && dtype != 1) ||
      (long long)n_partials != (long long)b * ((t + TILE - 1) / TILE))
    return (int)cudaErrorInvalidValue;
  if (c == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_partials > 0) {
    const cudaError_t err =
        dtype == 1 ? dispatch_bwd<__nv_bfloat16>(L, bcx, w, dy, grad,
                                                 partials, b, t, c, s)
                   : dispatch_bwd<float>(L, bcx, w, dy, grad, partials, b, t,
                                         c, s);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = (long long)c * L;
  shortconv_dw_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      partials, n_partials, n, dw);
  return (int)cudaGetLastError();
}
