// The tensor-core decode consumer, shared by the bf16 decode kernels: K7/K8
// (dense_decode.cu, a stripe's rows by one 4-D tensor-map box per column
// chunk) and K3/K4 (paged_decode.cu, one 3-D box per page). Each kernel
// keeps its own producer; the ring, the barriers and everything the
// consumer warps do live here once.
//
// A block of THREADS threads serves one (b, kv head[, split]) cell with the
// whole GQA group inside, so each K/V byte is read once for all G heads. A
// producer warp fills a ring of 64-row bf16 K and V tiles (128-byte
// swizzled: D / 64 column chunks of BT rows of 128 bytes, each chunk
// 1024-byte aligned) on mbarriers; tile t sits in stage t % STAGES, its
// first key at position first + t * BT. Four consumer warps hold q's G
// rows, zero-padded to 16 (two m16 tiles for G > 16, each taken by two of
// the warps), as mma.sync m16n8k16 A fragments for the whole walk. The
// warps of one m16 tile take whole tiles in turn. Per tile: S = q K^T with K
// fed by ldmatrix, an online softmax in S's registers (exp2, scale * log2(e)
// folded into one multiply; positions outside [lo, hi) masked to P exactly
// 0, so stale or repeated rows never count), then O += P V with P rounded
// to bf16 as the A fragment and V by ldmatrix.trans. A warp releases a
// stage by one mbarrier arrival after a proxy fence. The warps' states merge
// once, through shared memory; one pass writes the normalised bf16 row, a
// split writes float32 (acc, m ln 2, l) for decode_common.cuh's combine.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace rt {
namespace dtc {

constexpr int BT = 64;               // rows (keys) of a K / V tile
constexpr int CONSUMER_WARPS = 4;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);   // + one producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory, in bytes from a 1024-byte aligned base: the ring's
// K and V stages (each tile D / 64 swizzled column chunks of BT rows), then
// its full and empty mbarriers. After the walk the ring holds the warps'
// states for the merge.
template <int D>
struct Ring {
  static constexpr int STAGES = D == 64 ? 8 : 4;   // 128 KB in flight either way
  static constexpr int TILE = BT * D * 2;
  static constexpr int K = 0;
  static constexpr int V = STAGES * TILE;
  static constexpr int BAR = 2 * STAGES * TILE;
  static constexpr size_t bytes = BAR + 8 * 2 * STAGES + 1024;   // + base alignment
};

__device__ __forceinline__ uint8_t* ring_base(uint8_t* smem_raw) {
  return smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
}

template <int D>
__device__ __forceinline__ uint64_t* full_bars(uint8_t* smem) {
  return reinterpret_cast<uint64_t*>(smem + Ring<D>::BAR);
}

template <int D>
__device__ __forceinline__ uint64_t* empty_bars(uint8_t* smem) {
  return full_bars<D>(smem) + Ring<D>::STAGES;
}

// Thread 0 sets up the ring's barriers: a stage is full after the
// producer's one expect-tx arrival and its bytes, empty after one arrival
// of a warp of each of the MT m16 tiles. Every thread of the block calls
// this (it ends in a block-wide barrier).
template <int D, int MT>
__device__ __forceinline__ void ring_init(uint8_t* smem) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < Ring<D>::STAGES; ++st) {
      hopper::mbar_init(&full_bars<D>(smem)[st], 1);
      hopper::mbar_init(&empty_bars<D>(smem)[st], MT);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// The consumer warps' whole part for the cell (s, h, b) = blockIdx: walk
// `ntiles` tiles whose first key is at position `first`, keeping positions
// in [lo, hi), then merge and write. MT m16 tiles of group rows
// (G <= 16 * MT). SPLIT = false writes the normalised row to `out`;
// SPLIT = true writes (acc, m, l) of split s (of gridDim.x).
template <int D, int MT, bool SPLIT>
__device__ __forceinline__ void consume(uint8_t* smem, const __nv_bfloat16* __restrict__ q,
                                        __nv_bfloat16* __restrict__ out,
                                        float* __restrict__ acc_out, float* __restrict__ m_out,
                                        float* __restrict__ l_out, int Hkv, int G, int first,
                                        int lo, int hi, int ntiles, float scale,
                                        float softcap) {
  using namespace hopper;
  using R = Ring<D>;
  constexpr int KS = CONSUMER_WARPS / MT;   // warps per m16 tile, taking tiles in turn
  constexpr int ROWS = 16 * MT;             // group rows, padded
  // Each stage then feeds one warp of each m16 tile, which waits on every
  // phase of it in turn: a parity wait never meets a phase two ahead.
  static_assert(R::STAGES % KS == 0, "a stage must belong to one warp per m16 tile");
  uint64_t* full = full_bars<D>(smem);
  uint64_t* empty = empty_bars<D>(smem);
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Consumer warp (mt, ks): group rows 16 mt .. + 15 over tiles ks, ks + KS,
  // ks + 2 KS, ...: KS tiles are in the products at once. This thread holds
  // rows r0 = 16 mt + lane / 4 and r0 + 8, and of every 8 keys (or columns)
  // the two at 2 (lane % 4).
  const int mt = warp % MT;
  const int ks = warp / MT;
  const int Hq = Hkv * G;
  const int r0 = 16 * mt + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)h * G) * D;
  uint32_t qa[D / 16][4];   // A fragments of q, k16 step kc
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1);
      const int col = kc * 16 + c2 + 8 * (i >> 1);
      qa[kc][i] = row < G ? *reinterpret_cast<const uint32_t*>(qh + (size_t)row * D + col) : 0u;
    }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F};
  float l[2] = {0.f, 0.f};   // this thread's part of each row's sum
  const float scale2 = scale * LOG2E;
  // lo <= pos < hi in one unsigned compare: pos - lo wraps past hi - lo
  // below lo (the walk runs only when hi > lo).
  const unsigned live = (unsigned)(hi - lo);

  for (int t = ks; t < ntiles; t += KS) {
    const int st = t % R::STAGES;
    const uint32_t kbase = smem_u32(smem + R::K + st * R::TILE);
    const uint32_t vbase = smem_u32(smem + R::V + st * R::TILE);
    const int rel0 = first + t * BT - lo;   // the tile's first key, from lo
    mbar_wait(&full[st], (t / R::STAGES) & 1);

    // S = q K^T: n8 tile n holds keys lo + rel0 + 8 n ...; one ldmatrix.x4
    // gives the B fragments of two n8 tiles at one k16 step.
    float sc[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int np = 0; np < BT / 16; ++np) {
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t kb[4];
        ldmatrix_x4(kb, kbase + sw128_offset(row, 2 * kc + ((lane >> 3) & 1), BT));
        mma_bf16_16816(sc[2 * np], qa[kc], kb[0], kb[1]);
        mma_bf16_16816(sc[2 * np + 1], qa[kc], kb[2], kb[3]);
      }

    // Scores in log2 units; a position outside [lo, hi) is masked to
    // exactly NEG_INF_F (no live score comes near it) and gets p = 0.
    float mx[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = softcap > 0.f ? softcap * tanhf(sc[n][i] * scale / softcap) * LOG2E
                                : sc[n][i] * scale2;
        x = (unsigned)(rel0 + 8 * n + c2 + (i & 1)) < live ? x : NEG_INF_F;
        sc[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }

    // P in bf16 as the A fragments of P V: k16 step kk is n8 tiles 2 kk and
    // 2 kk + 1 of S. The row sum takes P unrounded.
    uint32_t pa[BT / 16][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      float e[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = sc[2 * kk + u][i];
          const float pv = x == NEG_INF_F ? 0.f : fast_exp2(x - m[i >> 1]);
          e[u][i] = pv;
          sum[i >> 1] += pv;
        }
      pa[kk][0] = pack_bf16(e[0][0], e[0][1]);
      pa[kk][1] = pack_bf16(e[0][2], e[0][3]);
      pa[kk][2] = pack_bf16(e[1][0], e[1][1]);
      pa[kk][3] = pack_bf16(e[1][2], e[1][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];

    // O += P V: one ldmatrix.x4.trans gives the B fragments of two n8
    // column tiles (16 columns) over 16 keys.
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int row = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vbase + sw128_offset(row, 2 * dp + (lane >> 4), BT));
        mma_bf16_16816(o[2 * dp], pa[kk], vb[0], vb[1]);
        mma_bf16_16816(o[2 * dp + 1], pa[kk], vb[2], vb[3]);
      }
    // The warp read the stage through the generic proxy (ldmatrix); the
    // next TMA load writes it through the async proxy. Without this fence a
    // release can let that write land under the reads (measured: 14 of 100
    // runs wrong at three blocks an SM).
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // Merge the KS warps' states of each group row through shared memory (the
  // ring is idle once every consumer is past its last tile).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* part = reinterpret_cast<float*>(smem);   // [KS][ROWS][D]
  float* pm = part + KS * ROWS * D;               // [KS][ROWS]
  float* pl = pm + KS * ROWS;
  named_barrier_sync(1, 32 * CONSUMER_WARPS);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(part + ((size_t)ks * ROWS + r0 + 8 * r) * D + 8 * n + c2) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pm[ks * ROWS + r0 + 8 * r] = m[r];
      pl[ks * ROWS + r0 + 8 * r] = l[r];
    }
  }
  named_barrier_sync(1, 32 * CONSUMER_WARPS);
  for (int idx = threadIdx.x; idx < G * D; idx += 32 * CONSUMER_WARPS) {
    const int g = idx / D;
    const int d = idx - g * D;
    float m_star = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < KS; ++j) m_star = fmaxf(m_star, pm[j * ROWS + g]);
    float l_star = 0.f, a_star = 0.f;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const float w = fast_exp2(pm[j * ROWS + g] - m_star);
      l_star += pl[j * ROWS + g] * w;
      a_star += part[((size_t)j * ROWS + g) * D + d] * w;
    }
    if (SPLIT) {
      const size_t cell = (((size_t)b * Hkv + h) * gridDim.x + s) * G + g;
      acc_out[cell * D + d] = a_star;
      if (d == 0) {
        m_out[cell] = l_star == 0.f ? NEG_INF_F : m_star * LN2;
        l_out[cell] = l_star;
      }
    } else {
      out[((size_t)b * Hq + (size_t)h * G + g) * D + d] =
          __float2bfloat16(a_star / (l_star == 0.f ? 1.f : l_star));
    }
  }
}

}  // namespace dtc
}  // namespace rt
