// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface (ctypes).
//
// Replaces the two Pallas TPU forward kernels of the JAX package,
// deeplearning4j_tpu/ops/flash_attention.py: _fwd_kernel_vmem (whole K/V in
// VMEM) and _fwd_kernel_stream (K/V streamed through the grid), with their
// tile math _masked_update and _finalize. On the TPU the two differ only in
// how K/V fit VMEM; here one kernel streams K/V tiles through shared memory
// and covers both.
//
// Computes, for q/k/v [b, t, h, d] (strided views: the head dim must be
// contiguous) and an optional [b, t] f32 key mask (key valid iff > 0):
//   out [b, t, h, d] in the input dtype, lse [b, h, t] f32
// with the reference's NEG_INF = -1e30 sentinel rules: a row with no
// attendable key gets out 0 and lse -1e30.
//
// Design (one thread block per (b*h, 64-row q tile); a loop inside the block
// over k tiles replaces the TPU's sequential grid dimension; the running
// max, numerator and denominator stay in registers in f32):
//   * bf16: 4 warps, each owning 16 query rows. S = Q K^T and O += P V run
//     on the tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate);
//     P is rounded to bf16 for the P V product, as flash attention does on
//     GPUs. Q fragments stay in registers; K is staged row-major and V
//     transposed in shared memory so every fragment is one 32-bit load.
//   * f32: one thread per query row on the CUDA cores (fp32 FMA), so the f32
//     result keeps full f32 precision (no TF32).
//   * causal: the k loop stops at the diagonal tile, skipping both the loads
//     and the compute of post-diagonal tiles; q tiles are scheduled heaviest
//     first.
//
// Bound at the flagship shape (b=8, h=12, t=2048, d=64, causal, bf16):
// 4*b*h*t*t*d/2 = 51.5 GFLOP, about 52 us at 989 TFLOP/s bf16; it moves
// q, k, v, out (4 * 25.2 MB) + lse (0.8 MB) = 101 MB, about 30 us at
// 3.35 TB/s. So it is compute-bound. One main-path forward of the flagship
// launches it 12 times, once per layer. This simple kernel (synchronous
// loads, no TMA/wgmma) does not reach that bound; PERF.md records its time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG = -5e29f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // [b, t] or nullptr (every key valid)
  void* out;          // [b, t, h, d] contiguous
  float* lse;         // [b, h, t] contiguous
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block (4 warps x 16)
constexpr int BK = 64;   // keys per k tile

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(Params p) {
  constexpr int DP = D + 8;    // padded smem row (bf16): conflict-free frags
  constexpr int VP = BK + 8;   // padded row of the transposed V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][DP]
  __nv_bfloat16* Ks = Qs + BQ * DP;                                // [BK][DP]
  __nv_bfloat16* Vt = Ks + BK * DP;                                // [D][VP]

  const int n_qt = p.t / BQ;
  const int qt = p.causal ? (n_qt - 1 - (int)blockIdx.y) : (int)blockIdx.y;
  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row within the 8-row group
  const int t4 = lane & 3;   // fragment column pair

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            bi * p.q_sb + hi * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            bi * p.k_sb + hi * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            bi * p.v_sb + hi * p.v_sh;
  const float* mg = p.mask ? p.mask + (long long)bi * p.t : nullptr;

  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < BQ * CH; c += blockDim.x) {
    const int r = c / CH, cc = (c % CH) * 8;
    *reinterpret_cast<uint4*>(&Qs[r * DP + cc]) =
        *reinterpret_cast<const uint4*>(&qg[(q0 + r) * p.q_st + cc]);
  }
  __syncthreads();

  const int qr = warp * 16 + g;  // this thread's rows: qr and qr + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    qf[kc][0] = ld32(&Qs[qr * DP + kc * 16 + 2 * t4]);
    qf[kc][1] = ld32(&Qs[(qr + 8) * DP + kc * 16 + 2 * t4]);
    qf[kc][2] = ld32(&Qs[qr * DP + kc * 16 + 8 + 2 * t4]);
    qf[kc][3] = ld32(&Qs[(qr + 8) * DP + kc * 16 + 8 + 2 * t4]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  const int row[2] = {q0 + qr, q0 + qr + 8};

  const int n_kt = p.causal ? (q0 + BQ + BK - 1) / BK : p.t / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < BK * CH; c += blockDim.x) {
      const int r = c / CH, cc = (c % CH) * 8;
      *reinterpret_cast<uint4*>(&Ks[r * DP + cc]) =
          *reinterpret_cast<const uint4*>(&kg[(k0 + r) * p.k_st + cc]);
      uint4 raw = *reinterpret_cast<const uint4*>(&vg[(k0 + r) * p.v_st + cc]);
      const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(cc + i) * VP + r] = vv[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* kr = &Ks[(j * 8 + g) * DP + kc * 16 + 2 * t4];
        mma_bf16(s[j], qf[kc], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, key mask, causal mask (the reference's NEG_INF logits)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + 2 * t4 + e;
        const bool valid = mg == nullptr || mg[col] > 0.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float x = s[j][2 * hr + e] * p.scale;
          if (!valid || (p.causal && col > row[hr])) x = NEG_INF;
          s[j][2 * hr + e] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      }
    }
    float corr[2], m_safe[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m_run[hr], mx[hr]);
      m_safe[hr] = m_new <= HALF_NEG ? 0.f : m_new;
      corr[hr] = m_run[hr] <= HALF_NEG ? 0.f : expf(m_run[hr] - m_safe[hr]);
      m_run[hr] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1;
        const float x = s[j][i];
        const float pv = x <= HALF_NEG ? 0.f : expf(x - m_safe[hr]);
        s[j][i] = pv;
        rs[hr] += pv;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
      l_run[hr] = l_run[hr] * corr[hr] + rs[hr];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: the S accumulators of two neighbouring n-tiles are exactly
    // the A fragment of one 16-key chunk
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vr = &Vt[(n * 8 + g) * VP + kc * 16 + 2 * t4];
        mma_bf16(o[n], a, ld32(vr), ld32(vr + 8));
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float inv = 1.f / fmaxf(l_run[hr], 1e-30f);
    __nv_bfloat16* orow = og + (((long long)bi * p.t + row[hr]) * p.h + hi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(&orow[n * 8 + 2 * t4]) =
          pack_bf16(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
    }
    if (t4 == 0) {
      p.lse[(long long)bh * p.t + row[hr]] =
          l_run[hr] > 0.f ? m_run[hr] + logf(fmaxf(l_run[hr], 1e-30f))
                          : NEG_INF;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel, one thread per query row
// ---------------------------------------------------------------------------

constexpr int BQ32 = 64;  // query rows (threads) per block
constexpr int BK32 = 32;  // keys per k tile

template <int D>
__global__ void __launch_bounds__(BQ32)
flash_fwd_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ32][D + 1]
  float* Ks = Qs + BQ32 * (D + 1);                 // [BK32][D]
  float* Vs = Ks + BK32 * D;                       // [BK32][D]

  const int n_qt = p.t / BQ32;
  const int qt = p.causal ? (n_qt - 1 - (int)blockIdx.y) : (int)blockIdx.y;
  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int q0 = qt * BQ32;
  const int tid = threadIdx.x;
  const int row = q0 + tid;

  const float* qg = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  const float* mg = p.mask ? p.mask + (long long)bi * p.t : nullptr;

  for (int c = tid; c < BQ32 * D; c += BQ32) {
    const int r = c / D, cc = c % D;
    Qs[r * (D + 1) + cc] = qg[(q0 + r) * p.q_st + cc];
  }

  float o[D];
#pragma unroll
  for (int i = 0; i < D; ++i) o[i] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;

  const int n_kt = p.causal ? (q0 + BQ32 + BK32 - 1) / BK32 : p.t / BK32;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK32;
    __syncthreads();
    for (int c = tid; c < BK32 * D; c += BQ32) {
      const int r = c / D, cc = c % D;
      Ks[c] = kg[(k0 + r) * p.k_st + cc];
      Vs[c] = vg[(k0 + r) * p.v_st + cc];
    }
    __syncthreads();

    float s[BK32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      float acc = 0.f;
#pragma unroll 16
      for (int i = 0; i < D; ++i) acc = fmaf(Qs[tid * (D + 1) + i], Ks[j * D + i], acc);
      float x = acc * p.scale;
      const int col = k0 + j;
      if ((mg != nullptr && !(mg[col] > 0.f)) || (p.causal && col > row)) x = NEG_INF;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m_run, mx);
    const float m_safe = m_new <= HALF_NEG ? 0.f : m_new;
    const float corr = m_run <= HALF_NEG ? 0.f : expf(m_run - m_safe);
    m_run = m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      s[j] = s[j] <= HALF_NEG ? 0.f : expf(s[j] - m_safe);
      rs += s[j];
    }
    l_run = l_run * corr + rs;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = o[i] * corr;
#pragma unroll
      for (int j = 0; j < BK32; ++j) acc = fmaf(s[j], Vs[j * D + i], acc);
      o[i] = acc;
    }
  }

  const float inv = 1.f / fmaxf(l_run, 1e-30f);
  float* orow = static_cast<float*>(p.out) + (((long long)bi * p.t + row) * p.h + hi) * D;
#pragma unroll
  for (int i = 0; i < D; ++i) orow[i] = o[i] * inv;
  p.lse[(long long)bh * p.t + row] =
      l_run > 0.f ? m_run + logf(fmaxf(l_run, 1e-30f)) : NEG_INF;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int rows_per_block,
                   size_t smem, const Params& prm, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // b*h on x (up to 2^31 - 1 blocks), q tiles on y (t / 64 <= 65535)
  dim3 grid(prm.b * prm.h, prm.t / rows_per_block);
  kernel<<<grid, threads, smem, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns a
// cudaError_t (0 = launched); the kernel runs on `stream` asynchronously.
extern "C" int flash_fwd(int dtype, int d, const void* q, const void* k,
                         const void* v, const float* mask, void* out,
                         float* lse, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, int b, int t, int h, float scale,
                         int causal, void* stream) {
  Params prm{q, k, v, mask, out, lse, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
             v_sb, v_st, v_sh, b, t, h, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t % BQ != 0 || t % BQ32 != 0 || t % BK32 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (d == 64) {
      constexpr size_t smem = (BQ * 72 + BK * 72 + 64 * (BK + 8)) * 2;
      return (int)launch(flash_fwd_bf16_kernel<64>, 128, BQ, smem, prm, st);
    }
    if (d == 128) {
      constexpr size_t smem = (BQ * 136 + BK * 136 + 128 * (BK + 8)) * 2;
      return (int)launch(flash_fwd_bf16_kernel<128>, 128, BQ, smem, prm, st);
    }
  } else if (dtype == 0) {
    if (d == 64) {
      constexpr size_t smem = (BQ32 * 65 + 2 * BK32 * 64) * 4;
      return (int)launch(flash_fwd_f32_kernel<64>, BQ32, BQ32, smem, prm, st);
    }
    if (d == 128) {
      constexpr size_t smem = (BQ32 * 129 + 2 * BK32 * 128) * 4;
      return (int)launch(flash_fwd_f32_kernel<128>, BQ32, BQ32, smem, prm, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
