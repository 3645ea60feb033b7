// Flash-attention forward in bf16 for Hopper (sm_90a), bound through a
// plain C interface (ctypes). Its f32 instance is flash_fwd_f32.cu.
//
// Replaces the two Pallas TPU forward kernels of the JAX package,
// deeplearning4j_tpu/ops/flash_attention.py: _fwd_kernel_vmem (whole K/V in
// VMEM) and _fwd_kernel_stream (K/V streamed through the grid), with their
// tile math _masked_update and _finalize and their caller _flash_fwd_btd. On
// the TPU the two differ only in how K/V fit VMEM; here one kernel streams
// K/V tiles through shared memory and covers both.
//
// Computes, for q/k/v [b, t, h, d] (strided views: the head dim must be
// contiguous) and an optional [b, t] f32 key mask (key valid iff > 0):
//   out [b, t, h, d] bf16, lse [b, h, t] f32
// with the reference's NEG_INF = -1e30 sentinel rules: a row with no
// attendable key gets out exactly 0 and lse -1e30, and a masked key adds
// exactly 0 (its P is set to 0, never taken as the exp of a sentinel).
//
// Bound at the flagship shape (b=8, h=12, t=2048, d=64, causal, bf16):
// 4*b*h*t*t*d/2 = 51.5 GFLOP, about 52 us at 989 TFLOP/s bf16; it moves
// q, k, v, out (4 * 25.2 MB) + lse (0.8 MB) = 101 MB, about 30 us at
// 3.35 TB/s. So it is compute-bound. At d = 64 the softmax costs about as
// much as the products: 2*2*64 FLOPs per score are 1/16 clk of an SM's
// tensor cores (2048 bf16 FMA/clk), and one exponential is 1/16 clk of its
// MUFU (16/clk), so the two must overlap. One main-path forward of the
// flagship launches the kernel 12 times, once per layer.
//
// Design of the bf16 kernel (d = 64 or 128), the pattern of flash_bwd.cu:
// one 384-thread block per (b*h, pair of 128-row q tiles: the y-th from
// each end of the head, the heavier first, so that under causal every
// block does the same work); two consumer warpgroups of 64 query rows
// each (setmaxnreg.inc to 232) and a producer warpgroup (setmaxnreg.dec to
// 40), branched on a warp-uniform role value. The running max, the row sums and O stay in
// registers in f32. What it does about each limit of the mma.sync kernel
// it replaces:
//   * Loads overlap the math: the producer's first thread loads both Q
//     tiles at the start, then streams the (K, V) tiles of BN keys of one
//     q tile and of the next through one ring of STAGES shared-memory
//     stages on full/empty mbarriers with TMA (4-D tensor maps over the
//     strided qkv slices, 128-byte swizzle), so the second tile's loads run
//     under the first's last products and epilogue. Under causal it stops
//     at the diagonal tile: no loads and no math past it. BN and STAGES
//     per head dim: FwdTile below.
//   * No transposed copy of V: O += P V takes P, rounded to bf16 in
//     registers, as the A operand of a register-A wgmma (the accumulator
//     layout of S is the A fragment layout), and V as the B operand read
//     MN-major through the descriptor's transpose bit.
//   * wgmma for both products: S = Q K^T is m64nBNk16 from shared memory,
//     both operands K-major (the head dim is contiguous in Q and K).
//   * Work per score only where needed: the key mask comes with each tile
//     as one bulk copy into the stage (no per-score global reads), and the
//     mask and causal predicates run only on the diagonal tile or when a
//     mask is given. The softmax runs in registers on the accumulator
//     layout in the log2 domain: the row max of the raw scores over the 4
//     threads of a row (two shuffles), then P = exp2(S * scale*log2e - m)
//     as one FMA and one ex2.approx.ftz. Each thread keeps partial row
//     sums, rescaled with the max, summed over the 4 once in the epilogue.
//     l sums the f32 P, not the rounded values, so
//     flash_attention.bf16_out_tolerance holds as derived there.
//   * Bigger blocks: 128 query rows per block share each K/V tile (64
//     before).
//   * The softmax overlaps the products within each warpgroup: tile j's S
//     wgmma and tile j-1's P V wgmma are issued together, and tile j's
//     softmax runs while P V still runs. No ping-pong of the two
//     warpgroups: ordering their issue on named barriers measured within
//     the run-to-run spread of the kernel without it
//     (experiments/flash_fwd_variants.py; PERF.md).
//   * Epilogue: O * (1/l) as bf16 is staged swizzled in the warpgroup's own
//     Q rows (which no wgmma reads any more) and written with 16-byte
//     stores; lse = (m + log2 l) * ln 2 in f32. Each block owns its tile,
//     so the output is bitwise deterministic.
// Every f32 attention call on the card and every hop of the ring (which
// runs in f32) goes to flash_fwd_f32.cu: 3xTF32 wgmma fed by TMA, as the
// f32 backward (flash_bwd_f32.cu).

#include <math.h>   // INFINITY

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // [b, t] or nullptr (every key valid)
  void* out;          // [b, t, h, d] contiguous bf16
  float* lse;         // [b, h, t] contiguous
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int b, t, h;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel fed by TMA
// ---------------------------------------------------------------------------

// Keys per streamed tile and depth of the ring, per head dim, the faster
// of the sizes measured (experiments/flash_fwd_variants.py; PERF.md).
// d = 64: 128 keys, 4 stages (165 KB of shared memory with the two Q
// tiles); a consumer holds S (64 registers), P (32) and O (32). d = 128:
// 64 keys, 4 stages (197 KB); with 128 keys its S, P and O (64 each) do
// not fit the registers ptxas gives a consumer, which then spills and
// serializes its wgmma. (With 64 keys the first warpgroup also runs the
// causal diagonal's last tile, all of it masked for its rows.)
template <int D> struct FwdTile;
template <> struct FwdTile<64> { static constexpr int BN = 128, STAGES = 4; };
template <> struct FwdTile<128> { static constexpr int BN = 64, STAGES = 4; };

// Shared memory (byte offsets from a 1024-aligned base): the block's two Q
// tiles, then the ring of (K, V, key mask) stages, the ring's barriers and
// the second Q tile's. A tile of r rows is D/64 column halves of r x 128
// bytes.
template <int D>
struct FwdSmem {
  static constexpr int BN = FwdTile<D>::BN, STAGES = FwdTile<D>::STAGES;
  static constexpr int QTILE = ROWS * D * 2;           // [ROWS] rows
  static constexpr int STAGE0 = 2 * QTILE;
  static constexpr int K = 0, V = BN * D * 2;          // within a stage
  static constexpr int MASK = 2 * BN * D * 2;          // BN f32
  static constexpr int STAGE = round_up(MASK + BN * 4, 1024);
  static constexpr int BARS = STAGE0 + STAGES * STAGE;
  static constexpr int QBAR1 = BARS + RingBars<STAGES>::BYTES;
  static constexpr int BYTES = QBAR1 + 8 + 1024;
  static_assert(BN / 2 <= 64, "one predicate bit per score of a thread");
};

// The q tiles of a block: y-th from each end of the head, the heaviest
// causal tile first, so that under causal every block has n_qt + 1 k
// tiles of work; the middle tile of an odd count is alone.
struct QTiles {
  int qt[2], n;
  __device__ __forceinline__ QTiles(int n_qt, int y)
      : qt{n_qt - 1 - y, y}, n(n_qt - 1 - y == y ? 1 : 2) {}
};

template <int D>
__device__ __forceinline__ int k_tiles(const Params& p, int qt) {
  constexpr int BN = FwdTile<D>::BN;
  return p.causal ? (qt * ROWS + ROWS + BN - 1) / BN : p.t / BN;
}

// 1/x and log2(x) with one MUFU op each (x >= 1 here: a row sum whose
// largest term is 1). A correctly rounded division or log2f has a slow
// path that is a subroutine call; a call in the consumers' path makes
// ptxas keep them at the block's entry budget of 168 registers (spills)
// and serialize their wgmma.
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Both Q tiles at once (each on its own barrier), then the (K, V, mask)
// tiles of the first q tile and of the second through one ring, so the
// second tile's loads run under the first's last products and epilogue.
template <int D>
__device__ __forceinline__ void fwd_produce(
    uint32_t base, const RingBars<FwdTile<D>::STAGES>& bar,
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const Params& p, const QTiles& qs, int bi, int hi) {
  using L = FwdSmem<D>;
  const float* mg = p.mask ? p.mask + (long long)bi * p.t : nullptr;
  const uint32_t tx = 2 * L::BN * D * 2 + (mg ? L::BN * 4 : 0);
  for (int w = 0; w < qs.n; ++w) {
    const uint32_t qbar = w ? base + L::QBAR1 : bar.once;
    mbar_expect_tx(qbar, L::QTILE);
    load_rows<D>(base + w * L::QTILE, tm_q, ROWS, hi, qs.qt[w] * ROWS, bi,
                 qbar);
  }
  int it = 0;   // position in the ring, across both q tiles
  for (int w = 0; w < qs.n; ++w) {
    const int n_kt = k_tiles<D>(p, qs.qt[w]);
    for (int i = 0; i < n_kt; ++i, ++it) {
      const int s = it % L::STAGES;
      mbar_wait(bar.empty + 8 * s, ((it / L::STAGES) & 1) ^ 1);
      const uint32_t st = base + L::STAGE0 + s * L::STAGE;
      const uint32_t full = bar.full + 8 * s;
      mbar_expect_tx(full, tx);
      load_rows<D>(st + L::K, tm_k, L::BN, hi, i * L::BN, bi, full);
      load_rows<D>(st + L::V, tm_v, L::BN, hi, i * L::BN, bi, full);
      if (mg) bulk_load(st + L::MASK, mg + i * L::BN, L::BN * 4, full);
    }
  }
}

// The scores of this thread that count in tile k0 (bit x of the result for
// accumulator element x = 4j + 2hr + e: row row0 + 8hr, key k0 + 8j + 2t4 +
// e): the key is valid in the mask (when one is given) and not past the
// causal diagonal.
template <int BN>
__device__ __forceinline__ uint64_t valid_bits(uint32_t smask, bool masked,
                                               bool causal, int k0, int row0,
                                               int t4) {
  uint64_t ok = 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 mk = masked ? ld_shared_f2(smask + (8 * j + 2 * t4) * 4)
                             : make_float2(1.f, 1.f);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + 2 * t4 + e;
      const bool key = (e ? mk.y : mk.x) > 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (key && !(causal && col > row0 + 8 * hr))
          ok |= 1ull << (4 * j + 2 * hr + e);
    }
  }
  return ok;
}

// One tile's online softmax in registers. In: s the raw scores Q K^T of
// this thread (wgmma accumulator layout: element x is row 8 * ((x >> 1) & 1)
// past the thread's first), m the running row max of the scaled scores in
// log2 units (-inf while a row has seen no valid key), l this thread's
// partial row sums. With `pred`, only the scores whose bit is set in `ok`
// count. Out: s = P = exp2(S * sl2 - m) in f32, exactly 0 where a score
// does not count; m and l updated; corr the factor that rescales O.
template <int BN>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* corr, float sl2,
                                             bool pred, uint64_t ok) {
  // element x = 4j + 2hr + e: partial maxima and sums per (hr, e), two
  // dependency chains per row instead of one
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  if (pred) {
#pragma unroll
    for (int x = 0; x < BN / 2; ++x)
      if (!((ok >> x) & 1)) s[x] = -INFINITY;
  }
#pragma unroll
  for (int x = 0; x < BN / 2; ++x) mx[x & 3] = fmaxf(mx[x & 3], s[x]);
  float mu[2];   // the max subtracted: 0 for a row with no valid key yet
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[2 * hr], mx[2 * hr + 1]);
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m[hr], mx[hr] * sl2);   // sl2 > 0
    mu[hr] = m_new == -INFINITY ? 0.f : m_new;
    corr[hr] = fast_exp2(m[hr] - mu[hr]);   // 0 while m was -inf
    m[hr] = m_new;
    l[hr] *= corr[hr];
  }
  if (pred) {
#pragma unroll
    for (int x = 0; x < BN / 2; ++x)
      s[x] = ((ok >> x) & 1) ? fast_exp2(fmaf(s[x], sl2, -mu[(x >> 1) & 1]))
                             : 0.f;
  } else {
#pragma unroll
    for (int x = 0; x < BN / 2; ++x)
      s[x] = fast_exp2(fmaf(s[x], sl2, -mu[(x >> 1) & 1]));
  }
  float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int x = 0; x < BN / 2; ++x) rs[x & 3] += s[x];
  l[0] += rs[0] + rs[1];
  l[1] += rs[2] + rs[3];
}

// S = Q K^T of this warpgroup's 64 rows (at aQ in the Q tile) against the
// BN keys at sK, issued (not waited for). Its first k step only writes s:
// the previous tile's P, which s held, is dead by then.
template <int D, int BN>
__device__ __forceinline__ void issue_s(float* s, uint32_t aQ, uint32_t sK) {
  wgmma_fence();
  Wgmma<BN>::ss_first(s, kmajor_desc(aQ, ROWS, 0), kmajor_desc(sK, BN, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    Wgmma<BN>::ss(s, kmajor_desc(aQ, ROWS, kk), kmajor_desc(sK, BN, kk), 1);
  wgmma_commit();
}

// O += P V, P from the registers pa, V the BN keys at sV read MN-major;
// issued.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*pa)[4],
                                         uint32_t sV) {
  fence_regs<D / 2>(o);
  fence_regs<BN / 4>(&pa[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
    Wgmma<D>::rs(o, pa[kc], mnmajor_desc(sV, BN, kc));
  wgmma_commit();
}

// After the P V in flight is done: its registers are free again, and O is
// scaled by f (per row: the rescale to the running max of the tile just
// softmaxed, or 1/l after the last tile), so no instruction but a wgmma
// touches O while a product is in flight.
template <int D, int BN>
__device__ __forceinline__ void pv_done(float* o, uint32_t (*pa)[4],
                                        const float* f) {
  wgmma_wait<0>();
  fence_regs<D / 2>(o);
  fence_regs<BN / 4>(&pa[0][0]);
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] *= f[(x >> 1) & 1];
}

// One q tile of warpgroup wg (0 or 1, a value the compiler sees as
// warp-uniform, so the branches that depend on it are not divergent paths
// to ptxas, which would serialize the wgmma around them): query rows
// q0 + 64 wg .. + 63 of the Q tile at qbuf (loaded on qbar), against the
// n_kt key tiles that sit in the ring from position it0 on.
template <int D>
__device__ __forceinline__ void fwd_consume_tile(
    uint32_t base, const RingBars<FwdTile<D>::STAGES>& bar, const Params& p,
    int wg, uint32_t qbuf, uint32_t qbar, int q0, int n_kt, int it0, int bh,
    int bi, int hi) {
  using L = FwdSmem<D>;
  constexpr int BN = L::BN, STAGES = L::STAGES;
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;
  const int qw0 = q0 + wg * 64;
  const int row0 = qw0 + warp * 16 + g;   // this thread's rows: row0, row0 + 8
  const float sl2 = p.scale * LOG2E;
  const bool masked = p.mask != nullptr;
  const uint32_t aQ = qbuf + wg * 64 * 128;   // this warpgroup's rows
  auto stage = [&](int i) {                   // key tile i's ring stage
    return base + L::STAGE0 + ((it0 + i) % STAGES) * L::STAGE;
  };
  auto full = [&](int i) { return bar.full + 8 * ((it0 + i) % STAGES); };
  auto empty = [&](int i) { return bar.empty + 8 * ((it0 + i) % STAGES); };
  auto parity = [&](int i) { return ((it0 + i) / STAGES) & 1; };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  float o[D / 2], s[BN / 2];
  uint32_t pa[BN / 16][4];   // P of the previous tile, bf16 A fragments
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;

  mbar_wait(qbar, 0);

  // tile 0: S, then its softmax
  mbar_wait(full(0), parity(0));
  issue_s<D, BN>(s, aQ, stage(0) + L::K);
  wgmma_wait<0>();
  fence_regs<BN / 2>(s);
  {
    const bool pred = masked || (p.causal && BN - 1 > qw0);
    const uint64_t ok = pred ? valid_bits<BN>(stage(0) + L::MASK, masked,
                                              p.causal, 0, row0, t4)
                             : ~0ull;
    softmax_tile<BN>(s, m, l, corr, sl2, pred, ok);
  }
  acc_to_frags<BN>(pa, s);

  // tile i: S_i and the previous tile's P V are issued together, and S_i's
  // softmax runs while P V still runs
  for (int i = 1; i < n_kt; ++i) {
    const int k0 = i * BN;
    mbar_wait(full(i), parity(i));
    issue_s<D, BN>(s, aQ, stage(i) + L::K);
    issue_pv<D, BN>(o, pa, stage(i - 1) + L::V);
    wgmma_wait<1>();   // S_i is done; P V may still run
    fence_regs<BN / 2>(s);
    const bool pred = masked || (p.causal && k0 + BN - 1 > qw0);
    const uint64_t ok = pred ? valid_bits<BN>(stage(i) + L::MASK, masked,
                                              p.causal, k0, row0, t4)
                             : ~0ull;
    softmax_tile<BN>(s, m, l, corr, sl2, pred, ok);
    pv_done<D, BN>(o, pa, corr);
    mbar_arrive(empty(i - 1));   // tile i-1 is read
    acc_to_frags<BN>(pa, s);
  }

  // the last tile's P V; meanwhile the row sums are final, and 1/l rescales
  // O once the product is done
  issue_pv<D, BN>(o, pa, stage(n_kt - 1) + L::V);
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    inv[hr] = l[hr] > 0.f ? fast_rcp(l[hr]) : 0.f;   // a dead row has O = 0
  }
  pv_done<D, BN>(o, pa, inv);
  mbar_arrive(empty(n_kt - 1));

  // epilogue: lse, and O / l through this warpgroup's own Q rows
  if (t4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      p.lse[(long long)bh * p.t + row0 + 8 * hr] =
          l[hr] > 0.f ? (m[hr] + fast_log2(l[hr])) * LN2 : NEG_INF;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  store_tile<D>(o, qbuf, ROWS, wg * 64, static_cast<bf16*>(p.out), p, bi,
                hi, qw0, wg);
}

// One block per (b*h, pair of q tiles, QTiles).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, Params p) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const RingBars<L::STAGES> bar(base + L::BARS);
  const QTiles qs(p.t / ROWS, (int)blockIdx.y);
  const int bh = blockIdx.x;

  if (threadIdx.x == 0) {
    mbar_init(base + L::QBAR1, 1);
    bar.init();   // and the fence that publishes both inits
  }
  __syncthreads();
  const int role = warpgroup_index();
  if (role == CONSUMERS / 128) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      fwd_produce<D>(base, bar, &tm_q, &tm_k, &tm_v, p, qs, bh / p.h,
                     bh % p.h);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    int it0 = 0;
    for (int w = 0; w < qs.n; ++w) {
      const int n_kt = k_tiles<D>(p, qs.qt[w]);
      fwd_consume_tile<D>(base, bar, p, role, base + w * L::QTILE,
                          w ? base + L::QBAR1 : bar.once, qs.qt[w] * ROWS,
                          n_kt, it0, bh, bh / p.h, bh % p.h);
      it0 += n_kt;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using L = FwdSmem<D>;
  // the mask tiles arrive by bulk copy, which needs 16-byte alignment; the
  // softmax takes the row max of raw scores, which needs scale > 0
  if ((reinterpret_cast<uintptr_t>(p.mask) & 15) || !(p.scale > 0.f))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_view(&tq, p.q, p.b, p.t, p.h, D, p.q_sb, p.q_st, p.q_sh,
                   ROWS) ||
      !encode_view(&tk, p.k, p.b, p.t, p.h, D, p.k_sb, p.k_st, p.k_sh,
                   L::BN) ||
      !encode_view(&tv, p.v, p.b, p.t, p.h, D, p.v_sb, p.v_st, p.v_sh,
                   L::BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return err;
  // b*h on x (up to 2^31 - 1 blocks), pairs of q tiles on y
  dim3 grid(p.b * p.h, (p.t / ROWS + 1) / 2);
  flash_fwd_bf16_kernel<D><<<grid, THREADS, L::BYTES, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, k, v; strides are in elements. Returns a cudaError_t (0 =
// launched); the kernel runs on `stream` asynchronously.
extern "C" int flash_fwd(int d, const void* q, const void* k,
                         const void* v, const float* mask, void* out,
                         float* lse, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, int b, int t, int h, float scale,
                         int causal, void* stream) {
  Params prm{q, k, v, mask, out, lse, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
             v_sb, v_st, v_sh, b, t, h, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t <= 0 || t % ROWS != 0) return (int)cudaErrorInvalidValue;
  if (d == 64) return (int)launch_bf16<64>(prm, st);
  if (d == 128) return (int)launch_bf16<128>(prm, st);
  return (int)cudaErrorInvalidValue;
}
