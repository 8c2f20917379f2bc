// The bf16 tensor-core prefill block, shared by K1 (fa2_fwd_tc,
// flash_attention.cu: dense K / V), K2 (paged_prefill_tc, paged_prefill.cu:
// prefix pages, then the dense tail) and K2q (paged_prefill_q_tc: the same
// walk over prefix codes widened into bf16 stages). Each kernel keeps
// its own producer and its own walk over KV tiles; the shared-memory
// layout, the barriers and everything the consumer warpgroups do live here
// once.
//
// A block of THREADS threads owns BM = 128 query rows of one (b, q head):
// warpgroups 0 and 1 consume 64 rows each, warpgroup 2 loads. The producer
// fills the Q tile once (qbar) and BN-key K and V tiles through a
// two-stage ring (each stage a "full" mbarrier armed with 2 * TILE bytes
// and an "empty" one the eight consumer warps arrive on; consume's ring
// description, Ring below, which K2q at head_dim 256 replaces by a K ring
// and a V ring of their own barriers: paged_prefill.cu's SplitRing). Tiles are
// 128-byte swizzled: D / 64 column chunks of rows of 128 bytes, each
// chunk 1024-byte aligned. Per tile the consumers run S = Q K^T as wgmma
// m64nBNk16 (both operands K-major in shared memory), the online softmax
// in S's registers (each row over the four threads of a quad, ex2.approx
// with scale * log2(e) folded into one multiply; a softcap first, as one
// ex2 and one rcp: hopper.cuh's softcap_log2), P rounded to bf16 in place
// as the A-register fragment of O += P V (wgmma m64nDk16 with V MN-major,
// the transpose bit set). Masks run only on tiles the walk calls an edge.
// setmaxnreg gives the consumers 240 registers and the producer warpgroup
// 24 (K2q, whose producer warpgroup widens codes: 208 and 88, at head_dim
// 256 216 and 72). O leaves through shared memory by
// a TMA store that drops the rows past the tensor map's extent.
//
// At head_dim 256 the kernels branch to the consumers first and return from
// them (consumers_first). With the producer's branch first and the
// consumers' code joining it at the kernel's end, ptxas allocated the
// consumers the launch's 168 registers, not setmaxnreg's 240: K1 and K2
// spilled 548-964 B (the SASS stored 32 live registers to the stack around
// every S = Q K^T, to make room for S's accumulator, and S around the
// softmax) and ptxas serialised every wgmma (C7512). Consumers first, they
// take up to ~200 registers and spill nothing. D 64 and 128 fit 168 and
// keep the producer first.
//
// BN is 128 keys at D 64 and 128, and 64 at D 256, where two limits meet.
// Shared memory: Q (64 KB at D 256) and two stages of K and V at BN 128
// (4 x 64 KB) would need 320 KB of the 227 KB a block may have; at BN 64
// they take 192 KB. Registers: a consumer thread's O is D / 2 floats (128 at
// D 256), S BN / 2 and P BN / 4: at BN 128 the three take 224 of the 240
// that setmaxnreg gives before any address, row state or mask, at BN 64
// they take 176.
//
// A Walk (templated on BN) names the block's KV tiles in order:
//   int col0(int t)                   the column of tile t's first key;
//   bool edge(int t, int c0, int lo)  whether any (row, key) pair of tile t
//                                     and rows lo .. lo + 63 is masked
//                                     (uniform over a warpgroup);
//   bool ok(int t, int row, int col)  whether row may attend col.
// Columns and rows are in the walk's own coordinates; only the walk reads
// them.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace rt {
namespace ptc {

constexpr int BM = 128;        // q rows of a block: two consumer warpgroups of 64
constexpr int STAGES = 2;      // K / V tiles in flight
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, warpgroup 2 loads
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Keys of a K / V tile at head dim D (the header comment says why 256
// differs).
template <int D>
__host__ __device__ constexpr int kv_tile() {
  static_assert(D == 64 || D == 128 || D == 256, "head_dim 64, 128 or 256");
  return D == 256 ? 64 : 128;
}

// Whether a kernel branches to its consumer warpgroups before its producer
// (the header comment).
template <int D>
__host__ __device__ constexpr bool consumers_first() {
  return D == 256;
}

// Dynamic shared memory, in bytes from a 1024-byte aligned base: Q, then
// the K and V stages, each a tile of D / 64 swizzled column chunks of BN
// rows.
template <int D>
struct Smem {
  static constexpr int BN = kv_tile<D>();
  static constexpr int TILE = BN * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + BM * D * 2;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;   // full[STAGES], empty[STAGES], q
  static constexpr size_t bytes = BAR + 8 * (2 * STAGES + 1) + 1024;   // + base alignment
};

template <int D>
__device__ __forceinline__ uint64_t* full_bars(uint8_t* smem) {
  return reinterpret_cast<uint64_t*>(smem + Smem<D>::BAR);
}

template <int D>
__device__ __forceinline__ uint64_t* empty_bars(uint8_t* smem) {
  return full_bars<D>(smem) + STAGES;
}

template <int D>
__device__ __forceinline__ uint64_t* q_bar(uint8_t* smem) {
  return full_bars<D>(smem) + 2 * STAGES;
}

// The block's 1024-byte aligned base, its barriers set up by thread 0.
// Every thread of the block calls this (it ends in a block-wide barrier).
template <int D>
__device__ __forceinline__ uint8_t* setup(uint8_t* smem_raw) {
  using namespace hopper;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bars<D>(smem)[s], 1);
      mbar_init(&empty_bars<D>(smem)[s], CONSUMER_WARPS);
    }
    mbar_init(q_bar<D>(smem), 1);
    fence_barrier_init();
  }
  __syncthreads();
  return smem;
}

// The bf16 K / V stages a consumer walks and their barriers: consume's R.
// Ring, the default, is Smem<D>'s: STAGES stages, a stage's K and V behind
// one full barrier (the producer's one arrival, with both tiles' bytes) and
// one empty barrier (an arrival from each consumer warp after P V). A ring
// gives the Q tile's barrier (qbar), the shared addresses of tile t's K and
// V stages (k, v), and the four points of a tile's walk: wait_k before S =
// Q K^T, done_k once its wgmma has read K, wait_v before O += P V and
// done_v after it.
template <int D>
struct Ring {
  uint8_t* smem;

  __device__ __forceinline__ uint64_t* qbar() const { return q_bar<D>(smem); }
  __device__ __forceinline__ uint32_t k(int t) const {
    return hopper::smem_u32(smem + Smem<D>::K + (t % STAGES) * Smem<D>::TILE);
  }
  __device__ __forceinline__ uint32_t v(int t) const {
    return hopper::smem_u32(smem + Smem<D>::V + (t % STAGES) * Smem<D>::TILE);
  }
  __device__ __forceinline__ void wait_k(int t) const {
    hopper::mbar_wait(&full_bars<D>(smem)[t % STAGES], (t / STAGES) & 1);
  }
  __device__ __forceinline__ void done_k(int, int) const {}
  __device__ __forceinline__ void wait_v(int) const {}
  __device__ __forceinline__ void done_v(int t, int lane) const {
    if (lane == 0) hopper::mbar_arrive(&empty_bars<D>(smem)[t % STAGES]);
  }
};

// S's registers scaled to log2 units in place (softcap first), masked to
// exactly NEG_INF_F where walk.ok says no under MASK, each row's max into mx.
template <bool SOFTCAP, bool MASK, int BN, class Walk>
__device__ __forceinline__ void scores(float (&s)[BN / 2], float (&mx)[2], const Walk& walk,
                                       int t, int c0, int row0, int lane, float scale,
                                       const hopper::Softcap& cap) {
  const float scale2 = scale * LOG2E;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    float x = hopper::log2_score<SOFTCAP>(s[i], scale2, cap);
    if (MASK) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = c0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      x = walk.ok(t, row, col) ? x : NEG_INF_F;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
}

// The consumer warpgroups (threads 0 .. 255): ntiles tiles of `walk`, then
// O of rows q0 .. q0 + 127 of plane `plane` through the map `to` (boxes of
// 64 rows). LSE: also lse[plane * Sq + row] = m ln 2 + log l (-1e30 for a
// row with nothing live) for rows below Sq. REGS: the registers setmaxnreg
// gives each consumer thread; with the producer warpgroup's count it may sum
// to at most 3 x 168 (the launch's share of a thread at 384 threads). R: the
// ring of bf16 stages (Ring's interface), built on `smem`; Q sits at
// Smem<D>::Q whatever the ring.
template <int D, bool SOFTCAP, bool LSE, int REGS = 240, class R = Ring<D>, class Walk>
__device__ __forceinline__ void consume(uint8_t* smem, const Walk& walk, int ntiles, int q0,
                                        int plane, const CUtensorMap* to, float* lse,
                                        int Sq, float scale, float softcap) {
  using namespace hopper;
  using L = Smem<D>;
  constexpr int BN = L::BN;
  const R ring{smem};
  // Warpgroup wg owns rows q0 + 64 wg .. + 63; this thread rows row0 and
  // row0 + 8, and of every 8 columns the two at 2 (lane % 4).
  regs_alloc<REGS>();
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int row_lo = q0 + 64 * wg;
  const int row0 = row_lo + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const uint32_t qaddr = smem_u32(smem + L::Q) + wg * 64 * 128;
  float s[BN / 2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F};
  float l[2] = {0.f, 0.f};   // this thread's part of each row's sum
  const Softcap cap(scale, softcap);

  mbar_wait(ring.qbar(), 0);
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = walk.col0(t);
    const uint32_t kaddr = ring.k(t);
    const uint32_t vaddr = ring.v(t);
    ring.wait_k(t);

    // S = Q K^T: D / 16 steps of k16; a step is 32 bytes into a 128-byte
    // swizzled row, every four steps the next column chunk.
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t col = (kc % 4) * 32;
      wgmma_ss(s, desc_sw128(qaddr + (kc / 4) * BM * 128 + col, 16, 1024),
               desc_sw128(kaddr + (kc / 4) * BN * 128 + col, 16, 1024), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    ring.done_k(t, lane);

    // Scores in log2 units; masks only where the walk says the tile has a
    // masked pair for this warpgroup's rows. The two loops are written out
    // apart: left to itself the compiler predicates the mask into the one
    // loop, and the unmasked tiles pay for it (5% of K1's time).
    const bool edge = walk.edge(t, c0, row_lo);
    float mx[2] = {NEG_INF_F, NEG_INF_F};
    if (edge)
      scores<SOFTCAP, true, BN>(s, mx, walk, t, c0, row0, lane, scale, cap);
    else
      scores<SOFTCAP, false, BN>(s, mx, walk, t, c0, row0, lane, scale, cap);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }

    // P in bf16, laid out as the A fragments of P V: k16 slice kk of the
    // S accumulator is registers 8 kk .. 8 kk + 7. A masked entry is
    // exactly NEG_INF_F (no live score comes near it) and gets p = 0, so
    // a row with nothing live yet (m = NEG_INF_F) stays at zero.
    uint32_t p[BN / 16][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      float e[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = 8 * kk + u;
        float pv = fast_exp2(s[i] - m[(i >> 1) & 1]);
        if (edge && s[i] == NEG_INF_F) pv = 0.f;
        e[u] = pv;
        sum[(i >> 1) & 1] += pv;
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) p[kk][w] = pack_bf16(e[2 * w], e[2 * w + 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: BN / 16 steps of 16 keys (16 rows of 128 bytes each), each
    // one wgmma over all D columns.
    ring.wait_v(t);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_tb(acc, p[kk], desc_sw128(vaddr + kk * 16 * 128, BN * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    ring.done_v(t, lane);
  }

  // O goes out through this warpgroup's own 64 rows of the Q tile, which
  // only its finished products read: written there in the tensor map's
  // swizzled layout, then stored by TMA, which drops the rows past the
  // map's extent.
  const int tile_row = row0 - row_lo;   // 0 .. 63, plus 8 for r = 1
  uint8_t* otile = smem + L::Q + wg * 64 * 128;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    const int row = row0 + 8 * r;
    if (LSE && (lane & 3) == 0 && row < Sq)
      lse[(size_t)plane * Sq + row] = l[r] == 0.f ? NEG_INF_F : m[r] * LN2 + logf(l[r]);
  }
  stage_tile_bf16<D>(otile, BM * 128, acc, inv, tile_row, lane);
  fence_async_smem();
  named_barrier_sync(1 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c) tma_store_3d(to, otile + c * BM * 128, c * 64, row_lo, plane);
    tma_store_wait();
  }
}

}  // namespace ptc
}  // namespace rt
