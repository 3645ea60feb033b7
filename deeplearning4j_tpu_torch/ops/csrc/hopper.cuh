// Hopper (sm_90a) primitives shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu, and through tf32.cuh flash_fwd_f32.cu and
// flash_bwd_f32.cu): shared-memory access,
// mbarriers, TMA loads and the host-side tensor maps they read through,
// warpgroup wgmma (bf16 and tf32) with its shared-memory descriptors, the
// register budgets of a warp-specialised block (setmaxnreg), and the layout
// of the tiles TMA writes.
//
// The block layout both kernels use: two consumer warpgroups (threads
// 0..255, 64 output rows each) and a producer warpgroup (256..383) whose
// first thread issues every load. Tiles are stored as they arrive from TMA
// with the 128-byte swizzle: a tile of r rows and D bf16 columns is D/64
// column halves of r x 128 bytes, 1024-byte aligned.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums; the encoder is looked
#include <cuda_runtime.h>  // up at run time, so the library needs no -lcuda
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;

constexpr int CONSUMERS = 256;             // two warpgroups of 64 rows each
constexpr int THREADS = CONSUMERS + 128;   // and a producer warpgroup
constexpr int ROWS = 128;                  // output rows per block

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// shared-memory access, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a broken pipeline) traps after about 2^28 polls, seconds at least,
// so it surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map (coordinates innermost first: d, h, t, b) into
// shared memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// A contiguous run of `bytes` (a multiple of 16, 16-byte aligned) into
// shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barrier over the 128 threads of one consumer warpgroup (ids 1, 2).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// The mbarriers of one block: a full and an empty barrier per ring stage
// (the empty one counts every consumer thread), and one for the operands
// loaded once.
template <int STAGES>
struct RingBars {
  uint32_t full, empty, once;
  __device__ __forceinline__ explicit RingBars(uint32_t at)
      : full(at), empty(at + 8 * STAGES), once(at + 16 * STAGES) {}
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  static constexpr int BYTES = (2 * STAGES + 1) * 8;
};

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x with one MUFU.EX2; results below 2^-126 flush to 0 (P that small
// adds nothing a bf16 result can hold).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Pin registers that an asynchronous wgmma reads or writes, so the compiler
// moves no access to them across the wgmma fence, commit and wait.
template <int R>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a tile written by TMA with 128-byte
// swizzle (rows of 128 bytes, 8-row atoms of 1024 bytes, 1024-byte aligned).
// K-major: `addr` steps 32 bytes per 16-element k step; `lbo` is unused.
// MN-major: `addr` steps 8 rows (1024 bytes, the SBO) per 8 k rows and `lbo`
// is the distance between 64-element chunks of the MN dimension.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The k-th 16-column step of a K-major tile of `rows` rows stored as D/64
// column halves of rows x 128 bytes each.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int kk) {
  return sw128_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16);
}

// The k-th 16-row step of a tile read MN-major (its D columns are N).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int kk) {
  return sw128_desc(tile + kk * 16 * 128, rows * 128);
}

// d (64 x 32, f32) (+)= A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128, f32) (+)= A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) = A B: the first k step of a product (see
// wgmma_ss_n128_first).
__device__ __forceinline__ void wgmma_ss_n64_first(float* d, uint64_t a,
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x 128, f32) = A B: the first k step of a product, A and B from
// shared memory, both K-major. d is output only, so the values it held are
// dead before the product starts (a "+f" operand would keep them live).
__device__ __forceinline__ void wgmma_ss_n128_first(float* d, uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),
        "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x 64, f32) += A B, A (64 x 16 bf16) from registers in the
// accumulator layout, B from shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A B, A (64 x 16 bf16) from registers in the
// accumulator layout, B from shared memory, MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- tf32 (k = 8: 32 bytes of a K-major row per step, as k16 of bf16) ----
// Both shared-memory operands of a tf32 wgmma are K-major (the transpose
// bits exist only for 16-bit types). The register A fragment of m64nNk8 is
// not the accumulator layout: thread (warp, g, t4) holds rows 16 warp + g
// and + 8 at k = t4 and t4 + 4 (CUTLASS's ALayout_64x8, as mma.sync's
// m16n8k8), where the accumulator gives it columns 2 t4 and 2 t4 + 1.

// The tf32 value nearest to x (ties away from zero), as f32 bits with the
// low 13 mantissa bits clear.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// d (64 x 16, f32) (+)= A B, tf32 A and B from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_ss_n16(float* d, uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32, f32) (+)= A B, tf32 A and B from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float* d, uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A B, tf32 A and B from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float* d, uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A B, A (64 x 8 tf32) from registers, B from shared
// memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float* d, const uint32_t* a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N> struct WgmmaTf32;
template <> struct WgmmaTf32<16> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
    wgmma_tf32_ss_n16(d, a, b, scale_d);
  }
};
template <> struct WgmmaTf32<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
    wgmma_tf32_ss_n32(d, a, b, scale_d);
  }
};
template <> struct WgmmaTf32<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
    wgmma_tf32_ss_n64(d, a, b, scale_d);
  }
};
template <int N> struct Wgmma;
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
    wgmma_ss_n32(d, a, b, scale_d);
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
    wgmma_ss_n64(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void ss_first(float* d, uint64_t a,
                                                  uint64_t b) {
    wgmma_ss_n64_first(d, a, b);
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int scale_d) {
    wgmma_ss_n128(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void ss_first(float* d, uint64_t a,
                                                  uint64_t b) {
    wgmma_ss_n128_first(d, a, b);
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};

// Rounds the accumulator columns 16kc..16kc+15 to bf16: exactly the A
// fragment of the k step kc of the next product.
template <int N>
__device__ __forceinline__ void acc_to_frags(uint32_t (*a)[4],
                                             const float* acc) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kc][i] = pack_bf16(acc[8 * kc + 2 * i], acc[8 * kc + 2 * i + 1]);
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

// The rows [r0, r0 + n) of one head of a strided view into a tile of n rows,
// one TMA box per 64-column half.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          int n, int hi, int r0, int bi,
                                          uint32_t bar) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(dst + c * n * 128, map, c * 64, hi, r0, bi, bar);
}

// The 16-byte chunk j (columns 8j..8j+7) of row r of a tile of n rows, with
// the 128-byte swizzle (chunk index XOR row mod 8).
__device__ __forceinline__ uint32_t chunk_addr(uint32_t tile, int n, int r,
                                               int j) {
  return tile + (j >> 3) * n * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// A warpgroup's 64 x D f32 accumulator (wgmma layout) as bf16 into the
// 64 rows of `tile` (a tile of n rows) at row r0, then out to the contiguous
// [b, t, h, d] result, rows g0.. of head (bi, hi): 16-byte stores.
template <int D, typename Params>
__device__ __forceinline__ void store_tile(const float* acc, uint32_t tile,
                                           int n, int r0, bf16* out,
                                           const Params& p, int bi, int hi,
                                           int g0, int wg) {
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + warp * 16 + g + 8 * hr;
      st_shared_u32(chunk_addr(tile, n, r, j) + t4 * 4,
                    pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]));
    }
  warpgroup_sync(wg);
  for (int i = tw; i < 64 * D / 8; i += 128) {
    const int r = i / (D / 8), j = i % (D / 8);
    const uint4 v = ld_shared_v4(chunk_addr(tile, n, r0 + r, j));
    *reinterpret_cast<uint4*>(
        out + (((long long)bi * p.t + g0 + r) * p.h + hi) * D + j * 8) = v;
  }
}

// ---------------------------------------------------------------------------
// warp specialisation
// ---------------------------------------------------------------------------

// Register budgets of the two roles (setmaxnreg): the producer warpgroup
// gives back what the consumers take, 128 x (40 + 2 x 232) = 64,512 of the
// SM's 65,536 registers.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// The warpgroup of this thread, broadcast from lane 0 so that the compiler
// sees a warp-uniform value (setmaxnreg is applied only on such a branch).
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up through the CUDA runtime.
inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-D map over one strided bf16 [b, t, h, d] view (dims innermost first:
// d, h, t, b; strides in elements), read in boxes of 64 columns x 1 head x
// `rows` rows x 1 batch row, 128-byte swizzle. The wrapper has checked what
// TMA needs (16-byte aligned base and strides, contiguous head dim).
inline bool encode_view(CUtensorMap* map, const void* ptr, int b, int t, int h,
                        int d, long long sb, long long st, long long sh,
                        int rows) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  if (h == 1) sh = d;              // a size-1 dim's stride is arbitrary
  if (b == 1) sb = st * t;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D map over a contiguous f32 array [n2][n1][n0] (dims innermost
// first), read in boxes of 32 columns (128 bytes) x `rows` x 1, 128-byte
// swizzle: the K-major tiles of the tf32 kernels.
inline bool encode_f32_3d(CUtensorMap* map, const float* ptr, long long n0,
                          long long n1, long long n2, int rows) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * 4, (cuuint64_t)(n0 * n1) * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
