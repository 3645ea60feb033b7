// Adam over every leaf of a parameter tree in one pass (multi-tensor), bound
// through a plain C interface (ctypes). One entry point:
//
//   fused_adam   for each leaf i: m, v, p updated in place from g, and, where
//                the leaf has one, the delta written to d:
//                  m = b1 m + (1 - b1) g
//                  v = b2 v + (1 - b2) g^2
//                  d = lr_i (m * (1 / bc1)) / (sqrt(v * (1 / bc2)) + eps)
//                  p = p - d
//
// Replaces no TPU kernel: the JAX package's adam (deeplearning4j_tpu/
// optimize/updaters.py) is plain XLA, which jit fuses into a few passes. The
// port's plain path issues it op by op and leaf by leaf (14 launches a leaf,
// 1,918 for OPT-125m's 137 leaves), which makes its training step bound by
// the host's issue; this kernel is one launch for up to MAX_LEAVES leaves.
//
// The arithmetic is the plain path's (optimize/updaters.py), bit for bit:
// the same f32 operations in the same order, each rounded once. The
// intrinsics (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn, __fsub_rn) keep
// nvcc from contracting a multiply and an add into an FMA, which it does
// under the shared flags. The bias corrections come as their f32
// reciprocals, as the plain path multiplies by them (and ATen computes a
// tensor divided by a Python scalar on the card). So p, m and v after any
// number of steps equal the plain path's, and a checkpoint resumes bitwise
// across the two.
//
// Bound: bytes. Per element it reads p, g, m and v once and writes p, m and
// v once, 28 B (32 B with the delta output), for 14 flops: 4.54 GB and
// 1.36 ms at 3.35 TB/s for OPT-125m's 162.3M parameters. It reads nothing
// twice and writes no temporaries.
//
// Design. Work is cut into chunks of CHUNK elements of one leaf; a block
// updates one chunk, so OPT-125m's tree is about 5,100 blocks of 256
// threads, many waves over 132 SMs, and a 768-element LayerNorm vector and a
// 38.6M-element embedding cost the same per element. A block finds its leaf
// by a binary search over the leaves' first chunks (uniform across the
// block, from the constant bank). Each thread moves ILP float4s of each
// operand per trip (all loads before any store, 16-byte vector loads) where
// the leaf's five pointers are 16-byte aligned, which every chunk start then
// is (CHUNK is a multiple of 4); the rest of a chunk, and every element of a
// leaf that is not aligned, goes one float at a time.
//
// The table. The per-leaf pointers (p, g, m, v, d), lengths, first chunks
// and learning rates are kernel parameters: a launch's table is one struct
// passed by value, up to MAX_LEAVES leaves (28,712 B), in the 32,764 bytes
// of kernel parameters that CUDA 12.1 and later allow (above the classic
// 4 KB), read in place through __grid_constant__. The wrapper builds the
// table on the host for every step (the gradients are fresh tensors each
// step), so no pointer is ever cached; a tree of more leaves takes one
// launch per MAX_LEAVES. Nothing is copied to the device before the launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#define FUSED_ADAM_CHUNK 32768
#define FUSED_ADAM_MAX_LEAVES 512

namespace {

constexpr int THREADS = 256;
constexpr int ILP = 4;
constexpr long long CHUNK = FUSED_ADAM_CHUNK;
static_assert(CHUNK % 4 == 0, "chunk starts must keep 16-byte alignment");

// One leaf of the table (the wrapper's numpy LEAF dtype, 56 bytes).
struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  float* d;          // the delta output, or null
  long long n;       // elements (> 0)
  int chunk0;        // the launch's first chunk of this leaf
  float lr;
};
static_assert(sizeof(Leaf) == 56, "Leaf must match the wrapper's LEAF dtype");

struct Scalars {
  float b1, omb1, b2, omb2, ibc1, ibc2, eps;
  int nleaves;
};

struct Table {
  Scalars s;
  Leaf leaf[FUSED_ADAM_MAX_LEAVES];
};
static_assert(sizeof(Table) <= 32764,
              "the table must fit CUDA 12.1's kernel parameter space");

__device__ __forceinline__ float adam_elem(float& p, float g, float& m,
                                           float& v, float lr,
                                           const Scalars& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.ibc2)), s.eps);
  const float d = __fdiv_rn(__fmul_rn(lr, __fmul_rn(m, s.ibc1)), den);
  p = __fsub_rn(p, d);
  return d;
}

__device__ __forceinline__ float4 adam4(float4& p, float4 g, float4& m,
                                        float4& v, float lr,
                                        const Scalars& s) {
  float4 d;
  d.x = adam_elem(p.x, g.x, m.x, v.x, lr, s);
  d.y = adam_elem(p.y, g.y, m.y, v.y, lr, s);
  d.z = adam_elem(p.z, g.z, m.z, v.z, lr, s);
  d.w = adam_elem(p.w, g.w, m.w, v.w, lr, s);
  return d;
}

__global__ void __launch_bounds__(THREADS)
    fused_adam_kernel(const __grid_constant__ Table t) {
  const Scalars& s = t.s;
  const int b = blockIdx.x;
  // this block's leaf: the last one whose first chunk is at or before b
  int lo = 0, hi = s.nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk0 <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long start = (long long)(b - L.chunk0) * CHUNK;
  const long long end = min(L.n, start + CHUNK);
  long long tail = start;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(L.p) |
                         reinterpret_cast<uintptr_t>(L.g) |
                         reinterpret_cast<uintptr_t>(L.m) |
                         reinterpret_cast<uintptr_t>(L.v) |
                         reinterpret_cast<uintptr_t>(L.d);
  if ((bits & 15) == 0) {
    const int n4 = (int)((end - start) >> 2);
    tail = start + 4LL * n4;
    float4* p4 = reinterpret_cast<float4*>(L.p + start);
    const float4* g4 = reinterpret_cast<const float4*>(L.g + start);
    float4* m4 = reinterpret_cast<float4*>(L.m + start);
    float4* v4 = reinterpret_cast<float4*>(L.v + start);
    float4* d4 = L.d ? reinterpret_cast<float4*>(L.d + start) : nullptr;
    for (int i = threadIdx.x; i < n4; i += THREADS * ILP) {
      float4 pr[ILP], gr[ILP], mr[ILP], vr[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int j = i + u * THREADS;
        if (j < n4) {
          pr[u] = p4[j];
          gr[u] = g4[j];
          mr[u] = m4[j];
          vr[u] = v4[j];
        }
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int j = i + u * THREADS;
        if (j < n4) {
          const float4 d = adam4(pr[u], gr[u], mr[u], vr[u], L.lr, s);
          p4[j] = pr[u];
          m4[j] = mr[u];
          v4[j] = vr[u];
          if (d4) d4[j] = d;
        }
      }
    }
  }
  for (long long k = tail + threadIdx.x; k < end; k += THREADS) {
    float p = L.p[k], m = L.m[k], v = L.v[k];
    const float d = adam_elem(p, L.g[k], m, v, L.lr, s);
    L.p[k] = p;
    L.m[k] = m;
    L.v[k] = v;
    if (L.d) L.d[k] = d;
  }
}

}  // namespace

// leaves: nleaves Leaf records (host memory, read before the call returns),
// in order of chunk0, the first at 0, each leaf's chunks following the
// previous leaf's; the launch covers every chunk of every leaf. Returns the
// launch's cudaError_t.
extern "C" int fused_adam(const void* leaves, int nleaves, float b1,
                          float omb1, float b2, float omb2, float ibc1,
                          float ibc2, float eps, void* stream) {
  if (nleaves <= 0 || nleaves > FUSED_ADAM_MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  static thread_local Table t;   // 28 KB: kept off the caller's stack
  t.s = Scalars{b1, omb1, b2, omb2, ibc1, ibc2, eps, nleaves};
  std::memcpy(t.leaf, leaves, sizeof(Leaf) * (size_t)nleaves);
  const Leaf& last = t.leaf[nleaves - 1];
  if (t.leaf[0].chunk0 != 0 || last.n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = last.chunk0 + (last.n + CHUNK - 1) / CHUNK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_adam_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}
