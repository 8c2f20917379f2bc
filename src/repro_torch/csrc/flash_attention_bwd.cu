// K5 (dQ) and K6 (dK, dV): FlashAttention-2 backward for Hopper (sm_90a).
//
// Replace the two Pallas kernels of flash_attention_bwd in the JAX package,
// src/repro/kernels/flash_attention_bwd.py: _dq_kernel (:65, launched at
// :228) and _dkv_kernel (:111, launched at :279). Inputs as K1's: q / dO
// (B, Hq, Sq, D) and k / v (B, Hkv, Skv, D), the forward's lse (B, Hq, Sq)
// float32 and delta = rowsum(dO * O) (B, Hq, Sq) float32, computed in
// PyTorch by the wrapper as the JAX package computes it in XLA. Outputs dQ
// in q's type, dK / dV in k's type. p is recomputed from lse; with a
// softcap, dS takes the chain-rule factor 1 - (s_capped/cap)^2; rows with
// lse <= -1e30 / 2 (fully masked) and keys at or past kv_len contribute
// nothing.
//
// What bounds them on an H100: like the forward, these are bound by
// arithmetic at training shapes (K5 does 3 products of 64 x 64 x D per
// tile pair, K6 4), far above the card's balance point, so the tensor cores
// are the only way to that bound: bf16's at 989 TFLOP/s, and for float32
// 3xTF32 at a third of the TF32 rate (165 TFLOP/s on the data sheet, about
// 105 for mma.sync as measured), past the 67 TFLOP/s of the CUDA cores. Two
// routes:
//
// * bf16 (every train step): fa2_dq_tc_kernel and fa2_dkv_tc_kernel, wgmma
//   fed by TMA. A block of two warpgroups owns 128 rows: K5 q rows of one
//   (b, q head), K6 kv rows of one (b, kv head). Its own pair of tiles (K5
//   Q and dO, K6 K and V) comes by TMA once; the other side's 64-row tiles
//   (K5 K and V, K6 Q and dO) come through a two-stage ring, each stage a
//   "full" mbarrier armed with its bytes and an "empty" one the eight warps
//   arrive on. Thread 0 issues every load, one tile ahead of the products
//   (no producer warpgroup: K6 keeps 192 accumulator floats a thread, which
//   needs the 255 registers of a 256-thread block). Per tile, K5 computes
//   S = Q K^T and dP = dO V^T (wgmma m64n64k16, both operands K-major),
//   recomputes P from lse in registers (exp2 with scale * log2(e) folded
//   in), forms dS = P (dP - delta) and accumulates dQ += dS K with dS
//   rounded to bf16 as the A-register fragment and K MN-major (the
//   transpose bit). K6 computes the transposed products S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T come out of the accumulators already
//   laid out as A fragments of dV += P^T dO and dK += dS^T Q; lse and delta
//   are per column there, staged per q tile in shared memory. Masks apply
//   only on tiles that straddle kv_len, the diagonal or the window edge; a
//   warpgroup skips the products of a tile its rows cannot see. The
//   results leave through the warpgroup's own rows of its fixed tiles by a
//   TMA store, which drops rows past Sq / Skv. At head_dim 256 (the gemma
//   family) fa2_dq_tc256_kernel and fa2_dkv_tc256_kernel keep that walk on
//   64-row blocks, both warpgroups on the same rows, one computing S and P,
//   the other dP and dS, each accumulating half of D's columns (the
//   comment above Smem256 says why and how).
// * float32: fa2_dq_tf32_kernel and fa2_dkv_tf32_kernel on the tensor
//   cores in 3xTF32 (mma.sync m16n8k8, csrc/tf32.cuh: each operand split
//   into hi = tf32(x) and lo = tf32(x - hi), rounded as cvt.rna rounds
//   (f32::split_rna), each product lo hi' + hi lo' + hi hi' into float32,
//   about 22 bits). mma.sync and not wgmma:
//   wgmma takes TF32 operands K-major only, and dQ += dS K, dV += P^T dO and
//   dK += dS^T Q contract over the rows of K, dO and Q, which would then
//   need transposed copies; mma.sync fragments load from either layout. A
//   block of 8 warps owns 64 rows (K5 q rows, K6 kv rows) and walks the
//   other side in tiles of 32 rows. The own pair of tiles is split once
//   into hi and lo planes in shared memory (plain loads); each walked pair
//   lands by 16-byte cp.async in a landing buffer while the pair before it,
//   already split into planes for all warps, multiplies (K9's pipeline:
//   each thread splits the chunks it copied). Warp w takes 16 own rows
//   (w % 4) and 16 walked rows (w / 4) of each tile: S and dP (K6 S^T and
//   dP^T) per warp are 16 x 16, P is recomputed from lse with exp2 and
//   scale * log2(e) folded in, and P and dS stay float32, split in
//   registers as the A fragments of the next products with K9's key
//   permutation (column t of a k-step is key 2t, column t + 4 key 2t + 1,
//   so an accumulator is an A fragment without shuffles; the B operand's
//   rows are read in that order). The two warps on the same own rows each
//   sum half of every tile's keys (K6: q rows) and add their sums once at
//   the end, in a fixed order through shared memory. Masks apply only on a
//   warp's 16 x 16 tiles that straddle kv_len, the diagonal or the window
//   edge, a warp skips the tiles its rows cannot see, and rows with lse <=
//   ROW_DEAD give nothing (their -lse log2(e) is -inf). Under causality a
//   block takes own tile i and its mirror n - 1 - i in turn: their walks
//   sum to about the same for every block, so no block started last walks
//   far longer than the rest (head-first, K6's walks would otherwise fall
//   from 256 tiles to 8 in every head's run of blocks).
//   Shared memory, at D 128: own planes 4 x 64 x 128 floats (128 KB),
//   walked planes 4 x 32 x 128 (64 KB), the landing buffer 2 x 32 x 128 (32
//   KB) and K6's 64 column values: 224.3 KB of the 227 KB a block may use,
//   so one block an SM (two at D 64). Own tiles of 64 rows against walked
//   tiles of 64 would need 128 + 128 + 64 KB; split stages of both sides
//   are kept because splitting an operand in registers at each use costs
//   ~10 instructions an element (ptxas expands cvt.rna into four), more
//   issue slots than the three mma it feeds leave free. The planes are
//   unpadded: their 16-byte chunks are permuted by the row's low three bits
//   (f32::swz), so every fragment load is free of bank conflicts and the
//   four planes of a side fit where padded rows would not.
//
// What the design does about the TPU's choices: the Pallas kernels carry
// dQ (and dK / dV) in VMEM scratch across a sequential grid axis; here that
// axis is a loop inside the block, so nothing crosses blocks. K6 sums the
// GQA group inside the block (one block per (b, kv head, kv tile) loops over
// the group's q heads), so no (B, Hq, Skv, D) partials are written and no
// atomics are used: gradients are the same from run to run (at head_dim 256
// a walk too long for the card's blocks is split into parts whose float32
// sums a second kernel adds in a fixed order; see Smem256). One fused
// kernel with an atomic dQ would do 5 products a tile pair against these 7
// (3 + 4), at the price of that determinism. The MappingConfig order
// decodes blockIdx head-first (the tiles of one head consecutive, so blocks
// running together share K / V, or Q / dO, in L2) or block-first (heads
// fastest), the paper's choice for the backward pass. The order changes
// which blocks run together, never a block's sums.
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace rt;

constexpr float ROW_DEAD = NEG_INF_F * 0.5f;   // lse at or below: a fully masked row

// -- bf16 on the tensor cores --------------------------------------------------

namespace tc {

constexpr int BM = 128;        // a block's own rows: two warpgroups of 64
constexpr int BT = 64;         // rows of a ring tile
constexpr int STAGES = 2;      // ring tiles in flight
constexpr int THREADS = 256;   // two warpgroups; thread 0 also issues the loads
constexpr int WARPS = THREADS / 32;
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory, in bytes from a 1024-byte aligned base: the own
// pair of BM-row tiles (K5 Q, dO; K6 K, V), the ring's STAGES pairs of
// BT-row tiles (K5 K, V; K6 Q, dO), each tile D / 64 swizzled column
// chunks; then K6's staged columns, per warpgroup and tile parity the q
// tile's BT values of -lse * log2(e) and BT of delta; then the barriers.
template <int D>
struct Smem {
  static constexpr int HD = D;
  static constexpr int ROWS = BM;   // own rows
  static constexpr int OWN = BM * D * 2;
  static constexpr int TILE = BT * D * 2;
  static constexpr int A = 0;
  static constexpr int B = A + OWN;
  static constexpr int RA = B + OWN;
  static constexpr int RB = RA + STAGES * TILE;
  static constexpr int COLS = RB + STAGES * TILE;
  static constexpr int BAR = COLS + 2 * 2 * 2 * BT * 4;   // full[STAGES], empty[STAGES], own
  static constexpr size_t bytes = BAR + 8 * (2 * STAGES + 1) + 1024;   // + base alignment
};

// Thread 0: the own pair of tiles (rows `row` of plane `plane`) on `own`.
// L is the shared-memory layout (Smem<D>, or Smem256 at head_dim 256).
template <class L>
__device__ __forceinline__ void load_own(uint8_t* smem, uint64_t* own, const CUtensorMap* ta,
                                         const CUtensorMap* tb, int row, int plane) {
  using namespace hopper;
  mbar_expect_tx(own, 2 * L::OWN);
#pragma unroll
  for (int c = 0; c < L::HD / 64; ++c) {
    tma_load_3d(smem + L::A + c * L::ROWS * 128, ta, own, c * 64, row, plane);
    tma_load_3d(smem + L::B + c * L::ROWS * 128, tb, own, c * 64, row, plane);
  }
}

// Thread 0: ring tile t (rows `row` of plane `plane`) into stage t % STAGES.
template <class L>
__device__ __forceinline__ void load_ring(uint8_t* smem, uint64_t* full, const CUtensorMap* ta,
                                          const CUtensorMap* tb, int t, int row, int plane) {
  using namespace hopper;
  const int s = t % STAGES;
  mbar_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
  for (int c = 0; c < L::HD / 64; ++c) {
    tma_load_3d(smem + L::RA + s * L::TILE + c * BT * 128, ta, &full[s], c * 64, row, plane);
    tma_load_3d(smem + L::RB + s * L::TILE + c * BT * 128, tb, &full[s], c * 64, row, plane);
  }
}

// Barriers, then thread 0 issues the own tiles and the first STAGES ring
// tiles; ring(t) gives ring tile t's (row, plane).
template <class L, typename Ring>
__device__ __forceinline__ void start_loads(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                            uint64_t* own, const CUtensorMap* ta,
                                            const CUtensorMap* tb, const CUtensorMap* ra,
                                            const CUtensorMap* rb, int row, int plane,
                                            int ntiles, Ring ring) {
  using namespace hopper;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    mbar_init(own, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    load_own<L>(smem, own, ta, tb, row, plane);
    for (int t = 0; t < min(STAGES, ntiles); ++t) {
      int r, p;
      ring(t, r, p);
      load_ring<L>(smem, full, ra, rb, t, r, p);
    }
  }
}

// At the top of iteration t: thread 0 refills the stage of tile t - 1 with
// tile t + STAGES - 1 once all eight warps have released it; then every
// thread waits for tile t.
template <class L, typename Ring>
__device__ __forceinline__ void next_tile(uint8_t* smem, uint64_t* full, uint64_t* empty,
                                          const CUtensorMap* ra, const CUtensorMap* rb, int t,
                                          int ntiles, Ring ring) {
  using namespace hopper;
  if (threadIdx.x == 0 && t > 0 && t + STAGES - 1 < ntiles) {
    mbar_wait(&empty[(t - 1) % STAGES], ((t - 1) / STAGES) & 1);
    int r, p;
    ring(t + STAGES - 1, r, p);
    load_ring<L>(smem, full, ra, rb, t + STAGES - 1, r, p);
  }
  mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
  __syncwarp();
}

// s (64 x BT) = X R^T over D, both K-major: X this warpgroup's 64 own rows
// (column chunks XROWS * 128 bytes apart: the own tile's rows), R a ring
// tile (chunks BT * 128 apart). One commit group.
template <int D, int XROWS = BM>
__device__ __forceinline__ void scores(float (&s)[BT / 2], uint32_t x, uint32_t r) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint32_t col = (kc % 4) * 32;
    wgmma_ss_n64(s, desc_sw128(x + (kc / 4) * XROWS * 128 + col, 16, 1024),
                 desc_sw128(r + (kc / 4) * BT * 128 + col, 16, 1024), kc > 0);
  }
  wgmma_commit();
}

// acc (64 x D) += F (64 x BT: A fragments, k16 slice kk in f[kk]) . R (a
// ring tile, BT x D, MN-major: the transpose bit). One commit group.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&f)[BT / 16][4],
                                           uint32_t r) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wgmma_rs_tb(acc, f[kk], desc_sw128(r + kk * 16 * 128, BT * 128, 1024));
  wgmma_commit();
}

// p = exp(s_capped - lse) of one score from its raw product s, with
// nl = -lse * log2(e) (-inf for a dead row: p = 0); *f gets the softcap's
// chain-rule factor 1 - tanh^2.
template <bool SOFTCAP>
__device__ __forceinline__ float recompute_p(float s, float nl, float scale2, float cap_scale,
                                             float softcap, float* f) {
  if (SOFTCAP) {
    const float th = tanhf(s * cap_scale);
    *f = 1.f - th * th;
    return hopper::fast_exp2(fmaf(softcap * th, LOG2E, nl));
  }
  *f = 1.f;
  return hopper::fast_exp2(fmaf(s, scale2, nl));
}

__device__ __forceinline__ bool visible(int key, int q, int live, int causal, int window) {
  bool ok = key < live;
  if (causal) ok = ok && key <= q;
  if (window > 0) ok = ok && key > q - window;
  return ok;
}

// -- K5: dQ. Own tiles Q and dO (128 q rows of one (b, q head)); ring K, V.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
fa2_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                 const float* __restrict__ delta, int Hq, int Hkv, int Sq, int Skv,
                 int kv_len, float scale, int causal, int window, float softcap, int order) {
  using namespace hopper;
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;

  int b, h, mb;
  decode_block((Sq + BM - 1) / BM, Hq, order, b, h, mb);
  const int plane = b * Hq + h;
  const int kv_plane = b * Hkv + h / (Hq / Hkv);
  const int q0 = mb * BM;
  const int live = min(Skv, kv_len);
  int n_lo, n_hi;
  kv_tile_range(q0, BM, BT, live, causal, window, n_lo, n_hi);
  const int ntiles = max(0, n_hi - n_lo);
  auto ring = [&](int t, int& row, int& p) {
    row = (n_lo + t) * BT;
    p = kv_plane;
  };
  start_loads<L>(smem, full, empty, own, &tq, &tdo, &tk, &tv, q0, plane, ntiles, ring);

  // Warpgroup wg owns q rows row_lo .. row_lo + 63; this thread rows row0
  // and row0 + 8, and of every 8 keys the two at 2 (lane % 4).
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int row_lo = q0 + 64 * wg;
  const int row0 = row_lo + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const float dead_row = __uint_as_float(0xff800000u);   // -inf: 2^(x - inf) = 0
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l = row < Sq ? lse[(size_t)plane * Sq + row] : NEG_INF_F;
    nl[r] = l > ROW_DEAD ? -l * LOG2E : dead_row;
    dl[r] = row < Sq ? delta[(size_t)plane * Sq + row] : 0.f;
  }
  const float scale2 = scale * LOG2E;
  const float cap_scale = SOFTCAP ? scale / softcap : 0.f;
  const uint32_t qaddr = smem_u32(smem + L::A) + wg * 64 * 128;
  const uint32_t doaddr = smem_u32(smem + L::B) + wg * 64 * 128;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(own, 0);
  for (int t = 0; t < ntiles; ++t) {
    next_tile<L>(smem, full, empty, &tk, &tv, t, ntiles, ring);
    const int st = t % STAGES;
    const int c0 = (n_lo + t) * BT;
    // Uniform over the warpgroup: a tile wholly above its rows' diagonal or
    // left of their window adds nothing.
    const bool dead = row_lo >= Sq || (causal && c0 > row_lo + 63) ||
                      (window > 0 && c0 + BT - 1 <= row_lo - window);
    if (!dead) {
      const uint32_t kaddr = smem_u32(smem + L::RA + st * L::TILE);
      const uint32_t vaddr = smem_u32(smem + L::RB + st * L::TILE);
      float s[BT / 2], dp[BT / 2];
      scores<D>(s, qaddr, kaddr);
      scores<D>(dp, doaddr, vaddr);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const bool edge = c0 + BT > live || (causal && c0 + BT - 1 > row_lo) ||
                        (window > 0 && c0 <= row_lo + 63 - window);
      // dS in bf16, laid out as the A fragments of dS K: k16 slice kk of
      // the accumulators is registers 8 kk .. 8 kk + 7.
      uint32_t ds[BT / 16][4];
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = 8 * kk + u, r = (i >> 1) & 1;
          float f;
          float p = recompute_p<SOFTCAP>(s[i], nl[r], scale2, cap_scale, softcap, &f);
          if (edge && !visible(c0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1), row0 + 8 * r,
                               live, causal, window))
            p = 0.f;
          e[u] = p * (dp[i] - dl[r]) * f;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) ds[kk][w] = pack_bf16(e[2 * w], e[2 * w + 1]);
      }
      fence_regs(acc);
      accumulate<D>(acc, ds, kaddr);
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dQ = scale * acc leaves through this warpgroup's rows of the Q tile,
  // which only its own finished products read.
  uint8_t* tile = smem + L::A + wg * 64 * 128;
  const float mul[2] = {scale, scale};
  stage_tile_bf16<D>(tile, BM * 128, acc, mul, row0 - row_lo, lane);
  fence_async_smem();
  named_barrier_sync(1 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c) tma_store_3d(&tdq, tile + c * BM * 128, c * 64, row_lo, plane);
    tma_store_wait();
  }
}

// -- K6: dK, dV. Own tiles K and V (128 kv rows of one (b, kv head)); ring
// Q and dO over the GQA group's q heads and each head's live q tiles.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
fa2_dkv_tc_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tdk,
                  const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
                  const float* __restrict__ delta, int Hq, int Hkv, int Sq, int Skv,
                  int kv_len, float scale, int causal, int window, float softcap, int order) {
  using namespace hopper;
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;

  int b, hk, nb;
  decode_block((Skv + BM - 1) / BM, Hkv, order, b, hk, nb);
  const int group = Hq / Hkv;
  const int kv_plane = b * Hkv + hk;
  const int c0 = nb * BM;
  const int live = min(Skv, kv_len);
  // Live q tiles of these keys: none if all are past kv_len; causal rows
  // >= c0; window rows <= c0 + BM - 1 + window - 1.
  const int nm = (Sq + BT - 1) / BT;
  const int m_lo = causal ? c0 / BT : 0;
  int m_hi = c0 < live ? nm : 0;
  if (window > 0) m_hi = min(m_hi, (c0 + BM - 1 + window - 1) / BT + 1);
  const int nq = max(0, m_hi - m_lo);
  const int ntiles = group * nq;
  auto ring = [&](int t, int& row, int& p) {   // q head hk * group + t / nq
    row = (m_lo + t % nq) * BT;
    p = b * Hq + hk * group + t / nq;
  };
  start_loads<L>(smem, full, empty, own, &tk, &tv, &tq, &tdo, c0, kv_plane, ntiles, ring);

  // Warpgroup wg owns kv rows r_lo .. r_lo + 63; this thread rows row0 and
  // row0 + 8, and of every 8 q columns the two at 2 (lane % 4).
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int r_lo = c0 + 64 * wg;
  const int row0 = r_lo + 16 * (tid >> 5) + (lane >> 2);
  const float dead_row = __uint_as_float(0xff800000u);   // -inf: 2^(x - inf) = 0
  // Thread tid stages value tid of tile t's columns: -lse * log2(e) (tid <
  // 64; -inf past Sq or for a fully masked row) or delta (tid >= 64), one
  // tile ahead, in a buffer per warpgroup and tile parity.
  float* cols = reinterpret_cast<float*>(smem + L::COLS) + wg * 2 * 2 * BT;
  auto fetch = [&](int t) -> float {
    int row, p;
    ring(t, row, p);
    const int qi = row + (tid & (BT - 1));
    const size_t at = (size_t)p * Sq + qi;
    if (tid < BT) {
      const float l = qi < Sq ? lse[at] : NEG_INF_F;
      return l > ROW_DEAD ? -l * LOG2E : dead_row;
    }
    return qi < Sq ? delta[at] : 0.f;
  };
  float ahead = ntiles > 0 ? fetch(0) : 0.f;
  const float scale2 = scale * LOG2E;
  const float cap_scale = SOFTCAP ? scale / softcap : 0.f;
  const uint32_t kaddr = smem_u32(smem + L::A) + wg * 64 * 128;
  const uint32_t vaddr = smem_u32(smem + L::B) + wg * 64 * 128;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(own, 0);
  for (int t = 0; t < ntiles; ++t) {
    float* cur = cols + (t & 1) * 2 * BT;
    cur[tid] = ahead;
    if (t + 1 < ntiles) ahead = fetch(t + 1);
    named_barrier_sync(1 + wg, 128);
    next_tile<L>(smem, full, empty, &tq, &tdo, t, ntiles, ring);
    const int st = t % STAGES;
    const int q0 = (m_lo + t % nq) * BT;
    const bool dead = r_lo >= live || (causal && q0 + BT - 1 < r_lo) ||
                      (window > 0 && q0 > r_lo + 63 + window - 1);
    if (!dead) {
      const uint32_t qaddr = smem_u32(smem + L::RA + st * L::TILE);
      const uint32_t doaddr = smem_u32(smem + L::RB + st * L::TILE);
      float s[BT / 2], dp[BT / 2];
      scores<D>(s, kaddr, qaddr);     // S^T = K Q^T
      scores<D>(dp, vaddr, doaddr);   // dP^T = V dO^T
      wgmma_wait<1>();
      fence_regs(s);
      const bool edge = r_lo + 63 >= live || (causal && r_lo + 63 > q0) ||
                        (window > 0 && r_lo <= q0 + BT - 1 - window);
      // P^T in bf16 as the A fragments of P^T dO; s keeps P (times the
      // softcap factor) unrounded for dS.
      uint32_t pt[BT / 16][4];
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = 8 * kk + u;
          const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          float f;
          float p = recompute_p<SOFTCAP>(s[i], cur[c], scale2, cap_scale, softcap, &f);
          if (edge && !visible(row0 + 8 * ((i >> 1) & 1), q0 + c, live, causal, window))
            p = 0.f;
          e[u] = p;
          s[i] = p * f;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) pt[kk][w] = pack_bf16(e[2 * w], e[2 * w + 1]);
      }
      fence_regs(dv);
      accumulate<D>(dv, pt, doaddr);   // dV += P^T dO, while dS^T is formed
      wgmma_wait<1>();
      fence_regs(dp);
      uint32_t dst[BT / 16][4];
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = 8 * kk + u;
          e[u] = s[i] * (dp[i] - cur[BT + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)]);
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) dst[kk][w] = pack_bf16(e[2 * w], e[2 * w + 1]);
      }
      fence_regs(dk);
      accumulate<D>(dk, dst, qaddr);   // dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dK = scale * dk and dV leave through this warpgroup's rows of the K and
  // V tiles, which only its own finished products read.
  uint8_t* ktile = smem + L::A + wg * 64 * 128;
  uint8_t* vtile = smem + L::B + wg * 64 * 128;
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
  stage_tile_bf16<D>(ktile, BM * 128, dk, mul_k, row0 - r_lo, lane);
  stage_tile_bf16<D>(vtile, BM * 128, dv, mul_v, row0 - r_lo, lane);
  fence_async_smem();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_store_3d(&tdk, ktile + c * BM * 128, c * 64, r_lo, kv_plane);
      tma_store_3d(&tdv, vtile + c * BM * 128, c * 64, r_lo, kv_plane);
    }
    tma_store_wait();
  }
}

template <int D, bool SOFTCAP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int Hq, int Hkv, int Sq, int Skv,
              int kv_len, float scale, int causal, int window, float softcap, int order,
              cudaStream_t stream) {
  const long long blocks = (long long)B * Hq * ((Sq + BM - 1) / BM);
  if (blocks <= 0) return 0;
  CUtensorMap tq, tdo, tk, tv, tdq;
  int err = hopper::make_map_3d(&tq, q, D, Sq, B * Hq, BM);
  if (err == 0) err = hopper::make_map_3d(&tdo, dout, D, Sq, B * Hq, BM);
  if (err == 0) err = hopper::make_map_3d(&tk, k, D, Skv, B * Hkv, BT);
  if (err == 0) err = hopper::make_map_3d(&tv, v, D, Skv, B * Hkv, BT);
  if (err == 0) err = hopper::make_map_3d(&tdq, dq, D, Sq, B * Hq, BM / 2);
  if (err != 0) return err;
  const size_t smem = Smem<D>::bytes;
  const cudaError_t e = allow_smem(fa2_dq_tc_kernel<D, SOFTCAP>, smem);
  if (e != cudaSuccess) return (int)e;
  fa2_dq_tc_kernel<D, SOFTCAP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      tq, tdo, tk, tv, tdq, lse, delta, Hq, Hkv, Sq, Skv, kv_len, scale, causal, window,
      softcap, order);
  return (int)cudaGetLastError();
}

template <int D, bool SOFTCAP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B, int Hq,
               int Hkv, int Sq, int Skv, int kv_len, float scale, int causal, int window,
               float softcap, int order, cudaStream_t stream) {
  const long long blocks = (long long)B * Hkv * ((Skv + BM - 1) / BM);
  if (blocks <= 0) return 0;
  CUtensorMap tk, tv, tq, tdo, tdk, tdv;
  int err = hopper::make_map_3d(&tk, k, D, Skv, B * Hkv, BM);
  if (err == 0) err = hopper::make_map_3d(&tv, v, D, Skv, B * Hkv, BM);
  if (err == 0) err = hopper::make_map_3d(&tq, q, D, Sq, B * Hq, BT);
  if (err == 0) err = hopper::make_map_3d(&tdo, dout, D, Sq, B * Hq, BT);
  if (err == 0) err = hopper::make_map_3d(&tdk, dk, D, Skv, B * Hkv, BM / 2);
  if (err == 0) err = hopper::make_map_3d(&tdv, dv, D, Skv, B * Hkv, BM / 2);
  if (err != 0) return err;
  const size_t smem = Smem<D>::bytes;
  const cudaError_t e = allow_smem(fa2_dkv_tc_kernel<D, SOFTCAP>, smem);
  if (e != cudaSuccess) return (int)e;
  fa2_dkv_tc_kernel<D, SOFTCAP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      tk, tv, tq, tdo, tdk, tdv, lse, delta, Hq, Hkv, Sq, Skv, kv_len, scale, causal, window,
      softcap, order);
  return (int)cudaGetLastError();
}

// -- head_dim 256 (the gemma family): two warpgroups on one 64-row block --------
//
// The D 64/128 layout does not fit D 256 twice over. Shared memory: two
// 128-row own tiles and two stages of two 64-row ring tiles would take 256
// KB of the 227 KB a block may have. Registers: a K6 warpgroup would hold
// dK and dV of its 64 rows at D floats a thread (256). So here a block owns
// 64 rows (K5 q rows of one (b, q head), K6 kv rows of one (b, kv head)) and
// both warpgroups work on them, warpgroup w accumulating D's columns 128 w
// .. 128 w + 127 (K5 dQ: 64 floats a thread; K6 dK and dV: 128). The
// score-sized products are not split over D: warpgroup 0 computes S (K5 S =
// Q K^T, K6 S^T = K Q^T) over all 256 columns while warpgroup 1 computes dP
// (dO V^T, V dO^T), each 16 wgmma m64n64k16 on its own tile. Warpgroup 0
// recomputes P (with a softcap in one ex2 and one rcp, hopper.cuh's form,
// and the factor 1 - tanh^2 from the same tanh) and hands P times the
// factor, and for K6 P's bf16 A fragments, to warpgroup 1 through shared
// memory (barrier P_READY); warpgroup 1 forms dS = (P f) (dP - delta) in
// bf16 and hands its fragments back (DS_READY). The two warpgroups hold
// the same accumulator layout, so thread t of one exchanges with thread t
// of the other, word w of the exchange at [w][t] (no bank conflicts). Then
// each runs the D-wide products on its half (wgmma m64n128k16, the ring
// tile MN-major): K5 dQ += dS K; K6 dV += P^T dO (issued as soon as P's
// fragments are there) and dK += dS^T Q. Shared memory: the own pair 64
// KB, two ring stages 128 KB, the exchange 32 KB, K6's staged lse and delta
// 1 KB: 226 KB. No tile of a block's walk is dead for all its rows, so
// there is no per-warpgroup skip. Thread 0 issues the loads as above.
//
// The walk. Blocks are issued longest walk first: causal K5 reverses the
// tile index that decode_block gives (block mb walks mb + 1 key tiles); K6's
// kv block nb walks fewer q tiles the larger nb is, so its order stays.
// Where K6's (b, kv head, kv tile) blocks cannot fill the card, the wrapper
// splits each block's walk over the GQA group's q heads and their q tiles
// (flattened head-major) into `parts` ranges of `chunk` tiles, chunk the
// longest walk over parts (launch_dkv256 takes it from dkv_tiles256), one
// block each: every part writes its float32 dK and dV to a scratch slot of its
// own, and fa2_dkv_reduce256_kernel adds a kv tile's parts in part order,
// scales dK and rounds both to bf16 once. No atomics: the same bits from
// run to run and under either order. With one part K6 writes bf16 itself,
// as without the split. Each tile still waits for the last one's D-wide
// products before its S / dP: issuing them behind those products
// (wgmma_wait<1>), or S as soon as warpgroup 0 has handed P over, ran 1-12%
// slower on an H100 (0 B spill either way).
struct Smem256 {
  static constexpr int HD = 256;
  static constexpr int ROWS = 64;   // own rows
  static constexpr int OWN = ROWS * HD * 2;
  static constexpr int TILE = BT * HD * 2;
  static constexpr int A = 0;
  static constexpr int B = A + OWN;
  static constexpr int RA = B + OWN;
  static constexpr int RB = RA + STAGES * TILE;
  // Exchange, 64 words a thread: 0-31 P times the softcap factor (float),
  // 32-47 P's bf16 A fragments (K6), 48-63 dS's.
  static constexpr int XCH = RB + STAGES * TILE;
  static constexpr int XP = 0, XPT = 32, XDS = 48;
  // K6: per warpgroup and tile parity, the ring tile's BT values of -lse *
  // log2(e) (warpgroup 0) or delta (warpgroup 1).
  static constexpr int COLS = XCH + 64 * 128 * 4;
  static constexpr int BAR = COLS + 2 * 2 * BT * 4;   // full[STAGES], empty[STAGES], own
  static constexpr size_t bytes = BAR + 8 * (2 * STAGES + 1) + 1024;   // + base alignment
  // K6's scratch slot of one part: dK then dV, 64 rows of 256 floats each.
  static constexpr int PART = 2 * ROWS * HD;
  static_assert(bytes <= 232448, "above the 227 KB of shared memory a block may use");
};

constexpr int P_READY = 3;    // named barriers over both warpgroups
constexpr int DS_READY = 4;

// The q tiles [m_lo, m_lo + nq) of each GQA head that K6's 64 kv rows from
// c0 see: none if all are past `live`; causal rows >= c0; window rows <=
// c0 + 63 + window - 1.
__host__ __device__ __forceinline__ void dkv_tiles256(int c0, int Sq, int live, int causal,
                                                      int window, int& m_lo, int& nq) {
  const int nm = (Sq + BT - 1) / BT;
  m_lo = causal ? c0 / BT : 0;
  int m_hi = c0 < live ? nm : 0;
  if (window > 0) {
    const int reach = (c0 + Smem256::ROWS - 1 + window - 1) / BT + 1;
    m_hi = reach < m_hi ? reach : m_hi;
  }
  nq = m_hi > m_lo ? m_hi - m_lo : 0;
}

// p = exp(s_capped - lse) of one score from its raw product s, with nl =
// -lse * log2(e) (-inf for a dead row: p = 0), the softcap as hopper.cuh's
// softcap_log2 computes it: tanh(y) = 1 - 2 / (2^(2 y log2 e) + 1), one ex2
// and one rcp; *f gets the chain-rule factor 1 - tanh^2.
template <bool SOFTCAP>
__device__ __forceinline__ float recompute_p256(float s, float nl, float scale2,
                                                const hopper::Softcap& cap, float* f) {
  if (SOFTCAP) {
    const float th = 1.f - 2.f * hopper::fast_rcp(hopper::fast_exp2(s * cap.k) + 1.f);
    *f = 1.f - th * th;
    return hopper::fast_exp2(fmaf(cap.c, th, nl));
  }
  *f = 1.f;
  return hopper::fast_exp2(fmaf(s, scale2, nl));
}

// This thread's word w of the exchange (thread index tid of its warpgroup).
__device__ __forceinline__ float* xch_word(uint8_t* smem, int w, int tid) {
  return reinterpret_cast<float*>(smem + Smem256::XCH) + w * 128 + tid;
}

__device__ __forceinline__ void put_frags(uint8_t* smem, int w0, int tid,
                                          const uint32_t (&f)[BT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      *reinterpret_cast<uint32_t*>(xch_word(smem, w0 + 4 * kk + w, tid)) = f[kk][w];
}

__device__ __forceinline__ void get_frags(uint8_t* smem, int w0, int tid,
                                          uint32_t (&f)[BT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      f[kk][w] = *reinterpret_cast<const uint32_t*>(xch_word(smem, w0 + 4 * kk + w, tid));
}

// Warpgroup 1: dS = (P f) (dP - delta) in bf16 as the A fragments of the
// dS products, from the exchange's P f and this thread's dP; delta(i)
// gives accumulator register i's delta.
template <typename Delta>
__device__ __forceinline__ void form_ds(uint8_t* smem, int tid, const float (&dp)[BT / 2],
                                        Delta delta, uint32_t (&ds)[BT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    float e[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = 8 * kk + u;
      e[u] = *xch_word(smem, Smem256::XP + i, tid) * (dp[i] - delta(i));
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) ds[kk][w] = hopper::pack_bf16(e[2 * w], e[2 * w + 1]);
  }
}

// The block's output: this warpgroup's 128 columns of acc * mul, through
// its two column chunks of the own tile at `tile`, stored by TMA to rows
// row_lo .. row_lo + 63 of `plane` (rows past the map's extent dropped).
__device__ __forceinline__ void store_half(uint8_t* tile, const CUtensorMap* map,
                                           const float (&acc)[64], float mul, int wg,
                                           int tile_row, int lane, int row_lo, int plane) {
  using namespace hopper;
  using L = Smem256;
  uint8_t* half = tile + wg * 2 * L::ROWS * 128;
  const float m[2] = {mul, mul};
  stage_tile_bf16<128>(half, L::ROWS * 128, acc, m, tile_row, lane);
  fence_async_smem();
  named_barrier_sync(1 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
      tma_store_3d(map, half + c * L::ROWS * 128, 128 * wg + 64 * c, row_lo, plane);
    tma_store_wait();
  }
}

// A part's float32 output: this warpgroup's 128 columns of acc (rows
// tile_row and tile_row + 8 of the block's 64) into a 64 x 256 plane of its
// scratch slot.
__device__ __forceinline__ void store_part(float* out, const float (&acc)[64], int wg,
                                           int tile_row, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(out + (tile_row + 8 * r) * Smem256::HD + 128 * wg + 8 * j +
                                 2 * (lane & 3)) = make_float2(acc[4 * j + 2 * r],
                                                               acc[4 * j + 2 * r + 1]);
}

// -- K5 at head_dim 256: own tiles Q and dO (64 q rows); ring K, V.
template <bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
fa2_dq_tc256_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                    const float* __restrict__ delta, int Hq, int Hkv, int Sq, int Skv,
                    int kv_len, float scale, int causal, int window, float softcap,
                    int order) {
  using namespace hopper;
  using L = Smem256;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;

  const int nm = (Sq + L::ROWS - 1) / L::ROWS;
  int b, h, mb;
  decode_block(nm, Hq, order, b, h, mb);
  if (causal) mb = nm - 1 - mb;   // the longest walks (mb + 1 key tiles) first
  const int plane = b * Hq + h;
  const int kv_plane = b * Hkv + h / (Hq / Hkv);
  const int q0 = mb * L::ROWS;
  const int live = min(Skv, kv_len);
  int n_lo, n_hi;
  kv_tile_range(q0, L::ROWS, BT, live, causal, window, n_lo, n_hi);
  const int ntiles = max(0, n_hi - n_lo);
  auto ring = [&](int t, int& row, int& p) {
    row = (n_lo + t) * BT;
    p = kv_plane;
  };
  start_loads<L>(smem, full, empty, own, &tq, &tdo, &tk, &tv, q0, plane, ntiles, ring);

  // Both warpgroups hold rows q0 .. q0 + 63; this thread rows row0 and
  // row0 + 8, and of every 8 keys the two at 2 (lane % 4). Warpgroup 0
  // keeps -lse * log2(e) of its two rows, warpgroup 1 their delta.
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + 16 * (tid >> 5) + (lane >> 2);
  const float dead_row = __uint_as_float(0xff800000u);   // -inf: 2^(x - inf) = 0
  float rv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (wg == 0) {
      const float l = row < Sq ? lse[(size_t)plane * Sq + row] : NEG_INF_F;
      rv[r] = l > ROW_DEAD ? -l * LOG2E : dead_row;
    } else {
      rv[r] = row < Sq ? delta[(size_t)plane * Sq + row] : 0.f;
    }
  }
  const float scale2 = scale * LOG2E;
  const Softcap cap(scale, softcap);
  const uint32_t xaddr = smem_u32(smem + (wg == 0 ? L::A : L::B));   // Q or dO
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  mbar_wait(own, 0);
  for (int t = 0; t < ntiles; ++t) {
    next_tile<L>(smem, full, empty, &tk, &tv, t, ntiles, ring);
    const int st = t % STAGES;
    const int c0 = (n_lo + t) * BT;
    const uint32_t kaddr = smem_u32(smem + L::RA + st * L::TILE);
    const uint32_t vaddr = smem_u32(smem + L::RB + st * L::TILE);
    float s[BT / 2];   // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T
    scores<256, L::ROWS>(s, xaddr, wg == 0 ? kaddr : vaddr);
    wgmma_wait<0>();
    fence_regs(s);
    uint32_t ds[BT / 16][4];
    if (wg == 0) {
      const bool edge = c0 + BT > live || (causal && c0 + BT - 1 > q0) ||
                        (window > 0 && c0 <= q0 + 63 - window);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        const int r = (i >> 1) & 1;
        float f;
        float p = recompute_p256<SOFTCAP>(s[i], rv[r], scale2, cap, &f);
        if (edge && !visible(c0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1), row0 + 8 * r, live,
                             causal, window))
          p = 0.f;
        *xch_word(smem, L::XP + i, tid) = p * f;
      }
      named_barrier_arrive(P_READY, THREADS);
      named_barrier_sync(DS_READY, THREADS);
      get_frags(smem, L::XDS, tid, ds);
    } else {
      named_barrier_sync(P_READY, THREADS);
      form_ds(smem, tid, s, [&](int i) { return rv[(i >> 1) & 1]; }, ds);
      put_frags(smem, L::XDS, tid, ds);
      named_barrier_arrive(DS_READY, THREADS);
    }
    fence_regs(acc);
    accumulate<128>(acc, ds, kaddr + wg * 2 * BT * 128);   // dQ[:, 128 wg ..] += dS K
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(ds);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dQ = scale * acc through this warpgroup's half of the Q tile: no wgmma
  // reads the Q tile once the last S is done (warpgroup 1 is past that
  // tile's P_READY).
  store_half(smem + L::A, &tdq, acc, scale, wg, row0 - q0, lane, q0, plane);
}

// -- K6 at head_dim 256: own tiles K and V (64 kv rows); ring Q and dO over
// the GQA group's q heads and each head's live q tiles, or over one part of
// that walk.
template <bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
fa2_dkv_tc256_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdk,
                     const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ scratch, int Hq,
                     int Hkv, int Sq, int Skv, int kv_len, float scale, int causal, int window,
                     float softcap, int order, int parts, int chunk) {
  using namespace hopper;
  using L = Smem256;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;

  const int nkv = (Skv + L::ROWS - 1) / L::ROWS;
  int b, hk, unit;
  decode_block(nkv * parts, Hkv, order, b, hk, unit);
  const int nb = unit / parts;
  const int part = unit - nb * parts;
  const int group = Hq / Hkv;
  const int kv_plane = b * Hkv + hk;
  const int c0 = nb * L::ROWS;
  const int live = min(Skv, kv_len);
  int m_lo, nq;
  dkv_tiles256(c0, Sq, live, causal, window, m_lo, nq);
  // This part's tiles [t_lo, t_lo + ntiles) of the walk; part 0 always runs
  // (a kv tile that sees no q row writes zeros).
  const int walk = group * nq;
  const int t_lo = part * chunk;
  if (part > 0 && t_lo >= walk) return;
  const int ntiles = parts == 1 ? walk : min(walk - t_lo, chunk);
  auto ring = [&](int t, int& row, int& p) {   // q head hk * group + (t_lo + t) / nq
    row = (m_lo + (t_lo + t) % nq) * BT;
    p = b * Hq + hk * group + (t_lo + t) / nq;
  };
  start_loads<L>(smem, full, empty, own, &tk, &tv, &tq, &tdo, c0, kv_plane, ntiles, ring);

  // Both warpgroups hold kv rows c0 .. c0 + 63; this thread rows row0 and
  // row0 + 8, and of every 8 q columns the two at 2 (lane % 4).
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int row0 = c0 + 16 * (tid >> 5) + (lane >> 2);
  const float dead_row = __uint_as_float(0xff800000u);   // -inf: 2^(x - inf) = 0
  // Thread tid < BT stages value tid of tile t's columns, one tile ahead:
  // warpgroup 0 -lse * log2(e) (-inf past Sq or for a fully masked row),
  // warpgroup 1 delta.
  float* cols = reinterpret_cast<float*>(smem + L::COLS) + wg * 2 * BT;
  auto fetch = [&](int t) -> float {
    int row, p;
    ring(t, row, p);
    const int qi = row + tid;
    const size_t at = (size_t)p * Sq + qi;
    if (wg == 0) {
      const float l = qi < Sq ? lse[at] : NEG_INF_F;
      return l > ROW_DEAD ? -l * LOG2E : dead_row;
    }
    return qi < Sq ? delta[at] : 0.f;
  };
  float ahead = ntiles > 0 && tid < BT ? fetch(0) : 0.f;
  const float scale2 = scale * LOG2E;
  const Softcap cap(scale, softcap);
  const uint32_t xaddr = smem_u32(smem + (wg == 0 ? L::A : L::B));   // K or V
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(own, 0);
  for (int t = 0; t < ntiles; ++t) {
    float* cur = cols + (t & 1) * BT;
    if (tid < BT) {
      cur[tid] = ahead;
      if (t + 1 < ntiles) ahead = fetch(t + 1);
    }
    named_barrier_sync(1 + wg, 128);
    next_tile<L>(smem, full, empty, &tq, &tdo, t, ntiles, ring);
    const int st = t % STAGES;
    const int q0 = (m_lo + (t_lo + t) % nq) * BT;
    const uint32_t qaddr = smem_u32(smem + L::RA + st * L::TILE);
    const uint32_t doaddr = smem_u32(smem + L::RB + st * L::TILE);
    float s[BT / 2];   // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
    scores<256, L::ROWS>(s, xaddr, wg == 0 ? qaddr : doaddr);
    wgmma_wait<0>();
    fence_regs(s);
    uint32_t pt[BT / 16][4], dst[BT / 16][4];
    if (wg == 0) {
      const bool edge = c0 + 63 >= live || (causal && c0 + 63 > q0) ||
                        (window > 0 && c0 <= q0 + BT - 1 - window);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = 8 * kk + u;
          const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          float f;
          float p = recompute_p256<SOFTCAP>(s[i], cur[c], scale2, cap, &f);
          if (edge && !visible(row0 + 8 * ((i >> 1) & 1), q0 + c, live, causal, window))
            p = 0.f;
          e[u] = p;
          *xch_word(smem, L::XP + i, tid) = p * f;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) pt[kk][w] = pack_bf16(e[2 * w], e[2 * w + 1]);
      }
      put_frags(smem, L::XPT, tid, pt);
      named_barrier_arrive(P_READY, THREADS);
      fence_regs(dv);
      accumulate<128>(dv, pt, doaddr);   // dV[:, 0 .. 127] += P^T dO
      named_barrier_sync(DS_READY, THREADS);
      get_frags(smem, L::XDS, tid, dst);
    } else {
      named_barrier_sync(P_READY, THREADS);
      get_frags(smem, L::XPT, tid, pt);
      fence_regs(dv);
      accumulate<128>(dv, pt, doaddr + 2 * BT * 128);   // dV[:, 128 ..] += P^T dO
      form_ds(smem, tid, s,
              [&](int i) { return cur[8 * (i >> 2) + 2 * (lane & 3) + (i & 1)]; }, dst);
      put_frags(smem, L::XDS, tid, dst);
      named_barrier_arrive(DS_READY, THREADS);
    }
    fence_regs(dk);
    accumulate<128>(dk, dst, qaddr + wg * 2 * BT * 128);   // dK[:, 128 wg ..] += dS^T Q
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_frags(pt);
    fence_frags(dst);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  if (parts == 1) {
    // dK = scale * dk and dV through this warpgroup's halves of the K and V
    // tiles: no wgmma reads them once both warpgroups are past the last
    // tile's DS_READY.
    store_half(smem + L::A, &tdk, dk, scale, wg, row0 - c0, lane, c0, kv_plane);
    store_half(smem + L::B, &tdv, dv, 1.f, wg, row0 - c0, lane, c0, kv_plane);
  } else {   // this part's unscaled dk and dv, summed by fa2_dkv_reduce256_kernel
    float* slot = scratch + ((size_t)(kv_plane * nkv + nb) * parts + part) * L::PART;
    store_part(slot, dk, wg, row0 - c0, lane);
    store_part(slot + L::PART / 2, dv, wg, row0 - c0, lane);
  }
}

// K6's sum over parts at head_dim 256: thread i adds four consecutive
// floats of one (kv plane, kv tile, output, row) over that kv tile's parts,
// in part order, and writes them to dK (times scale) or dV in bf16. The
// parts of kv tile nb are those fa2_dkv_tc256_kernel ran for it.
__global__ void __launch_bounds__(256)
fa2_dkv_reduce256_kernel(const float* __restrict__ scratch, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, long long n4, int group, int Sq,
                         int Skv, int kv_len, float scale, int causal, int window, int parts,
                         int chunk) {
  using L = Smem256;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int e = (int)(i % (L::PART / 4)) * 4;   // element of the slot
  const long long slab = i / (L::PART / 4);      // kv plane * nkv + nb
  const int nkv = (Skv + L::ROWS - 1) / L::ROWS;
  const int nb = (int)(slab % nkv);
  const int out = e / (L::PART / 2);             // 0 dK, 1 dV
  const int row = nb * L::ROWS + (e / L::HD) % L::ROWS;
  if (row >= Skv) return;
  int m_lo, nq;
  dkv_tiles256(nb * L::ROWS, Sq, min(Skv, kv_len), causal, window, m_lo, nq);
  const int n = max(1, min(parts, (group * nq + chunk - 1) / chunk));
  const float* src = scratch + slab * parts * L::PART + e;
  float4 sum = *reinterpret_cast<const float4*>(src);
  for (int p = 1; p < n; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(src + (size_t)p * L::PART);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  const float mul = out == 0 ? scale : 1.f;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
      (out == 0 ? dk : dv) + ((slab / nkv) * Skv + row) * (size_t)L::HD + e % L::HD);
  dst[0] = __floats2bfloat162_rn(sum.x * mul, sum.y * mul);
  dst[1] = __floats2bfloat162_rn(sum.z * mul, sum.w * mul);
}

template <bool SOFTCAP>
int launch_dq256(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int B, int Hq, int Hkv,
                 int Sq, int Skv, int kv_len, float scale, int causal, int window,
                 float softcap, int order, cudaStream_t stream) {
  using L = Smem256;
  const long long blocks = (long long)B * Hq * ((Sq + L::ROWS - 1) / L::ROWS);
  if (blocks <= 0) return 0;
  CUtensorMap tq, tdo, tk, tv, tdq;
  int err = hopper::make_map_3d(&tq, q, L::HD, Sq, B * Hq, L::ROWS);
  if (err == 0) err = hopper::make_map_3d(&tdo, dout, L::HD, Sq, B * Hq, L::ROWS);
  if (err == 0) err = hopper::make_map_3d(&tk, k, L::HD, Skv, B * Hkv, BT);
  if (err == 0) err = hopper::make_map_3d(&tv, v, L::HD, Skv, B * Hkv, BT);
  if (err == 0) err = hopper::make_map_3d(&tdq, dq, L::HD, Sq, B * Hq, L::ROWS);
  if (err != 0) return err;
  const cudaError_t e = allow_smem(fa2_dq_tc256_kernel<SOFTCAP>, L::bytes);
  if (e != cudaSuccess) return (int)e;
  fa2_dq_tc256_kernel<SOFTCAP><<<(unsigned)blocks, THREADS, L::bytes, stream>>>(
      tq, tdo, tk, tv, tdq, lse, delta, Hq, Hkv, Sq, Skv, kv_len, scale, causal, window,
      softcap, order);
  return (int)cudaGetLastError();
}

// K6 at head_dim 256 over `parts` parts of a walk each (parts 1: the
// whole walk, bf16 written directly), then, with more than one part, the
// sum over the float32 scratch (B * Hkv, nkv, parts, 2, 64, 256). A part
// walks `chunk` tiles: the longest block's walk over parts, rounded up.
template <bool SOFTCAP>
int launch_dkv256(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int B, int Hq,
                  int Hkv, int Sq, int Skv, int kv_len, float scale, int causal, int window,
                  float softcap, int order, int parts, float* scratch, cudaStream_t stream) {
  using L = Smem256;
  if (parts < 1 || (parts > 1 && scratch == nullptr)) return -1;
  const int nkv = (Skv + L::ROWS - 1) / L::ROWS;
  const long long blocks = (long long)B * Hkv * nkv * parts;
  if (blocks <= 0) return 0;
  int longest = 0;
  for (int nb = 0; nb < nkv; ++nb) {
    int m_lo, nq;
    dkv_tiles256(nb * L::ROWS, Sq, min(Skv, kv_len), causal, window, m_lo, nq);
    longest = max(longest, (Hq / Hkv) * nq);
  }
  const int chunk = max(1, (longest + parts - 1) / parts);
  CUtensorMap tk, tv, tq, tdo, tdk, tdv;
  int err = hopper::make_map_3d(&tk, k, L::HD, Skv, B * Hkv, L::ROWS);
  if (err == 0) err = hopper::make_map_3d(&tv, v, L::HD, Skv, B * Hkv, L::ROWS);
  if (err == 0) err = hopper::make_map_3d(&tq, q, L::HD, Sq, B * Hq, BT);
  if (err == 0) err = hopper::make_map_3d(&tdo, dout, L::HD, Sq, B * Hq, BT);
  if (err == 0) err = hopper::make_map_3d(&tdk, dk, L::HD, Skv, B * Hkv, L::ROWS);
  if (err == 0) err = hopper::make_map_3d(&tdv, dv, L::HD, Skv, B * Hkv, L::ROWS);
  if (err != 0) return err;
  const cudaError_t e = allow_smem(fa2_dkv_tc256_kernel<SOFTCAP>, L::bytes);
  if (e != cudaSuccess) return (int)e;
  fa2_dkv_tc256_kernel<SOFTCAP><<<(unsigned)blocks, THREADS, L::bytes, stream>>>(
      tk, tv, tq, tdo, tdk, tdv, lse, delta, scratch, Hq, Hkv, Sq, Skv, kv_len, scale, causal,
      window, softcap, order, parts, chunk);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || parts == 1) return (int)launched;
  const long long n4 = (long long)B * Hkv * nkv * (L::PART / 4);
  fa2_dkv_reduce256_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      scratch, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n4, Hq / Hkv,
      Sq, Skv, kv_len, scale, causal, window, parts, chunk);
  return (int)cudaGetLastError();
}

}  // namespace tc

// -- float32 on the tensor cores in 3xTF32 --------------------------------------

namespace f32 {

using tc::LOG2E;
using tc::recompute_p;
using tc::visible;

constexpr int OWN = 64;                      // a block's own rows: K5 q rows, K6 kv rows
constexpr int WALK = 32;                     // rows of a walked tile: K5 keys, K6 q rows
constexpr int WN = 16;                       // walked rows of each tile a warp takes
constexpr int ROW_WARPS = OWN / 16;          // 16 own rows a warp
constexpr int HALVES = WALK / WN;            // warps on the same own rows
constexpr int THREADS = ROW_WARPS * HALVES * 32;
// Causal walks grow with the own tile (K5) or shrink (K6): a block then
// takes own tile i and its mirror n - 1 - i in turn, so that every block
// walks about as far and the last blocks to start are no longer than the
// first. Each tile's sums are the same either way.
constexpr bool PAIRED = true;

// Dynamic shared memory, in floats: the own pair of tiles (K5 Q and dO, K6
// K and V), each split into a hi and a lo plane; the walked pair (K5 K and
// V, K6 Q and dO) split the same way; the landing buffer the next walked
// pair arrives in, as cp.async writes it; K6's columns of the walked tile
// (-lse log2(e), then delta). A plane holds unpadded rows of D floats whose
// 16-byte chunks are permuted by the row (swz).
template <int D>
struct Smem {
  static constexpr int OWN_PLANE = OWN * D;
  static constexpr int WALK_PLANE = WALK * D;
  static constexpr int OA = 0;                        // hi, then lo
  static constexpr int OB = OA + 2 * OWN_PLANE;
  static constexpr int WA = OB + 2 * OWN_PLANE;       // hi, then lo
  static constexpr int WB = WA + 2 * WALK_PLANE;
  static constexpr int RAW = WB + 2 * WALK_PLANE;     // A rows, then B rows
  static constexpr int COLS = RAW + 2 * WALK_PLANE;
  static constexpr size_t bytes = sizeof(float) * (COLS + 2 * WALK);
  static_assert(bytes <= 232448, "more than a block's shared memory");
};

// Element (row, col) of a plane: 16-byte chunk col / 4 of the row, XOR the
// row's low three bits. A fragment's 32 loads (rows g or columns g, lanes
// g = lane / 4) then fall in 32 different banks.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// A thread's fragment loads, as offsets into a plane fixed for the whole
// walk: the swizzle's XOR depends only on the thread (g = lane / 4, t =
// lane % 4) and on a column's place in its 32-column group, so every load
// below is one of eight offsets plus a constant.
//
// Rows r + g (r % 8 == 0), column 4 j + t (+ 32 c) of every 32-column
// group: swz(r + g, 32 c + 4 j + t) = x[j] + 32 c.
template <int D>
__device__ __forceinline__ void row_offsets(int (&x)[8], int r, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = (r + g) * D + 4 * (j ^ g) + t;
}

// Rows r + 2t and r + 2t + 1 (r % 8 == 0), column 8 b + g (+ 32 c): x[2 b]
// and x[2 b + 1], plus 32 c.
template <int D>
__device__ __forceinline__ void pair_offsets(int (&x)[8], int r, int g, int t) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int chunk = 2 * b + (g >> 2);
    x[2 * b] = (r + 2 * t) * D + 4 * (chunk ^ (2 * t)) + (g & 3);
    x[2 * b + 1] = (r + 2 * t + 1) * D + 4 * (chunk ^ (2 * t + 1)) + (g & 3);
  }
}

// The A fragment of rows r .. r + 15 and the k-step of columns 4 j .. 4 j
// + 7 of a 32-column group (j even), from planes offset to that group,
// with x = row_offsets(r): (r + g, 4 j + t), (r + g + 8, 4 j + t), (r + g,
// 4 j + t + 4), (r + g + 8, 4 j + t + 4).
template <int D>
__device__ __forceinline__ void frag_a(const float* hi, const float* lo, const int (&x)[8],
                                       int j, uint32_t (&ahi)[4], uint32_t (&alo)[4]) {
  const int o[4] = {x[j], x[j] + 8 * D, x[j + 1], x[j + 1] + 8 * D};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ahi[e] = __float_as_uint(hi[o[e]]);
    alo[e] = __float_as_uint(lo[o[e]]);
  }
}

// The B fragment of M^T for 8 rows of M (the B column n = row n + g) and
// the same k-step, with x = row_offsets of those rows: (n + g, 4 j + t)
// and (n + g, 4 j + t + 4).
template <int D>
__device__ __forceinline__ void frag_bt(const float* hi, const float* lo, const int (&x)[8],
                                        int j, uint32_t (&bhi)[2], uint32_t (&blo)[2]) {
  bhi[0] = __float_as_uint(hi[x[j]]);
  bhi[1] = __float_as_uint(hi[x[j + 1]]);
  blo[0] = __float_as_uint(lo[x[j]]);
  blo[1] = __float_as_uint(lo[x[j + 1]]);
}

// The B fragment of M for a k-step of 8 rows and the 8 columns 8 b .. 8 b
// + 7 of a 32-column group, rows in the permuted order of an A fragment
// made from an accumulator (column t is row 2t, column t + 4 row 2t + 1),
// with x = pair_offsets of those rows: rows 2t and 2t + 1 of column 8 b +
// g.
template <int D>
__device__ __forceinline__ void frag_bk(const float* hi, const float* lo, const int (&x)[8],
                                        int b, uint32_t (&bhi)[2], uint32_t (&blo)[2]) {
  bhi[0] = __float_as_uint(hi[x[2 * b]]);
  bhi[1] = __float_as_uint(hi[x[2 * b + 1]]);
  blo[0] = __float_as_uint(lo[x[2 * b]]);
  blo[1] = __float_as_uint(lo[x[2 * b + 1]]);
}

// part[b] += A B over one k-step for the four 8-column tiles b of a
// 32-column group of B (plane pair hi / lo offset to the group and the
// k-step's rows, x = pair_offsets): each of the three products issued for
// the four tiles in turn, so that four independent accumulators, not one,
// carry each mma's latency.
template <int D>
__device__ __forceinline__ void mma_group(float (&part)[4][4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], const float* hi,
                                          const float* lo, const int (&x)[8]) {
  uint32_t bhi[4][2], blo[4][2];
#pragma unroll
  for (int b = 0; b < 4; ++b) frag_bk<D>(hi, lo, x, b, bhi[b], blo[b]);
#pragma unroll
  for (int b = 0; b < 4; ++b) mma_tf32(part[b], alo, bhi[b]);
#pragma unroll
  for (int b = 0; b < 4; ++b) mma_tf32(part[b], ahi, blo[b]);
#pragma unroll
  for (int b = 0; b < 4; ++b) mma_tf32(part[b], ahi, bhi[b]);
}

// hi = tf32(x), lo = tf32(x - hi), each rounded as cvt.rna rounds (to
// nearest, ties away from zero: add half of the 13 dropped bits' range to
// the magnitude, clear them) by two integer operations: for a finite x
// split_tf32's bits, where ptxas expands each cvt.rna into four
// instructions (csrc/ssd.cu). A NaN or an infinity still ends in NaN
// products. The splits are what these kernels spend on top of their mma: a
// walked tile's operands are split once a tile, P and dS once a score.
__device__ __forceinline__ void split_rna(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// An accumulator tile (rows g and g + 8, columns 2t and 2t + 1 of an 8-wide
// k-step) split as the A fragment of the next product, in the permuted
// order: column t is 2t, column t + 4 is 2t + 1. No shuffles.
__device__ __forceinline__ void acc_to_a(const float (&e)[4], uint32_t (&ahi)[4],
                                         uint32_t (&alo)[4]) {
  split_rna(e[0], ahi[0], alo[0]);   // (g,     2t)
  split_rna(e[2], ahi[1], alo[1]);   // (g + 8, 2t)
  split_rna(e[1], ahi[2], alo[2]);   // (g,     2t + 1)
  split_rna(e[3], ahi[3], alo[3]);   // (g + 8, 2t + 1)
}

// One k-step of the two score products of a warp (K5: S = Q K^T and dP =
// dO V^T; K6: S^T and dP^T), WN / 8 column tiles each, in 3xTF32: x / y
// are the A fragments (Q, dO), bx / by the B fragments (K, V) per column
// tile. The two cross terms are summed apart, in s_x / d_x: the tensor
// core rounds each accumulation toward zero, so a chain of mma into one
// register drifts by up to an ulp of the running sum a step, all one way;
// the sum then takes one accumulation a k-step instead of three, and the
// cross sums (about 2^-11 of it) drift by ulps of a far smaller number.
// Each term is issued for every accumulator in turn, so that 4 WN / 8
// independent chains carry the mma latency.
template <int N>
__device__ __forceinline__ void score_step(float (&s)[N][4], float (&s_x)[N][4],
                                           float (&d)[N][4], float (&d_x)[N][4],
                                           const uint32_t (&xhi)[4], const uint32_t (&xlo)[4],
                                           const uint32_t (&yhi)[4], const uint32_t (&ylo)[4],
                                           const uint32_t (&bxhi)[N][2],
                                           const uint32_t (&bxlo)[N][2],
                                           const uint32_t (&byhi)[N][2],
                                           const uint32_t (&bylo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(s_x[n], xlo, bxhi[n]);
    mma_tf32(d_x[n], ylo, byhi[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(s_x[n], xhi, bxlo[n]);
    mma_tf32(d_x[n], yhi, bylo[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(s[n], xhi, bxhi[n]);
    mma_tf32(d[n], yhi, byhi[n]);
  }
}

__device__ __forceinline__ void store_split(const float4 x, float* hi, float* lo) {
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  split_rna(x.x, h0, l0);
  split_rna(x.y, h1, l1);
  split_rna(x.z, h2, l2);
  split_rna(x.w, h3, l3);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h0, h1, h2, h3);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l0, l1, l2, l3);
}

// Rows r0 .. r0 + OWN - 1 of a row-major (n x D) matrix into the hi and lo
// planes at dst (lo OWN_PLANE after hi), rows at or past n as zeros. Once
// a block: the loads are plain, all of a thread's issued together.
template <int D>
__device__ __forceinline__ void split_own(float* dst, const float* src, int r0, int n) {
  constexpr int C4 = D / 4;
  static_assert(OWN * C4 % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < OWN * C4 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int row = i / C4, c = i % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < n) x = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + row) * D) + c);
    const int o = swz<D>(row, 4 * c);
    store_split(x, dst + o, dst + Smem<D>::OWN_PLANE + o);
  }
}

// Rows r0 .. r0 + WALK - 1 of two row-major (n x D) matrices a and b into
// the landing buffer by 16-byte cp.async, rows at or past n zero-filled.
template <int D>
__device__ __forceinline__ void land(float* raw, const float* a, const float* b, int r0, int n) {
  constexpr int C4 = D / 4, PER = WALK * C4;
  static_assert(PER % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < 2 * PER / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int row = i % PER / C4, c = i % C4;
    const float* src = i < PER ? a : b;
    const bool live = r0 + row < n;
    cp_async16(raw + 4 * i, live ? src + (size_t)(r0 + row) * D + 4 * c : src, live);
  }
}

// The landed pair into the walked planes at dst (A hi, A lo, B hi, B lo).
// Each thread splits the chunks it copied, so its own cp.async.wait_group
// is all it waits for, and the landing buffer is free for the next pair as
// soon as it has split them.
template <int D>
__device__ __forceinline__ void split_walk(const float* raw, float* dst) {
  constexpr int C4 = D / 4, PER = WALK * C4, P = Smem<D>::WALK_PLANE;
#pragma unroll
  for (int j = 0; j < 2 * PER / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int row = i % PER / C4, c = i % C4;
    float* plane = dst + (i < PER ? 0 : 2 * P) + swz<D>(row, 4 * c);
    store_split(*reinterpret_cast<const float4*>(raw + 4 * i), plane, plane + P);
  }
}

// The two halves' sums of one own row block, added in a fixed order: the
// second half's warps leave theirs in `part` (OWN x D, in the own planes,
// which nothing reads after the walk), the first half's add them to their
// own. Every thread calls it.
template <int D>
__device__ __forceinline__ void add_halves(float (&acc)[D / 8][4], float* part, bool second,
                                           int lr, int g, int t) {
  __syncthreads();
  if (second) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<float2*>(part + swz<D>(lr + g, 8 * dn + 2 * t)) =
          make_float2(acc[dn][0], acc[dn][1]);
      *reinterpret_cast<float2*>(part + swz<D>(lr + g + 8, 8 * dn + 2 * t)) =
          make_float2(acc[dn][2], acc[dn][3]);
    }
  }
  __syncthreads();
  if (!second) {
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const float2 x = *reinterpret_cast<const float2*>(part + swz<D>(lr + g, 8 * dn + 2 * t));
      const float2 y =
          *reinterpret_cast<const float2*>(part + swz<D>(lr + g + 8, 8 * dn + 2 * t));
      acc[dn][0] += x.x;
      acc[dn][1] += x.y;
      acc[dn][2] += y.x;
      acc[dn][3] += y.y;
    }
  }
}

// Rows row and row + 8 (those below n) of a (n x D) output, times mul.
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[D / 8][4], int row,
                                           int n, int t, float mul) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (row < n)
      *reinterpret_cast<float2*>(out + (size_t)row * D + col) =
          make_float2(mul * acc[dn][0], mul * acc[dn][1]);
    if (row + 8 < n)
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * D + col) =
          make_float2(mul * acc[dn][2], mul * acc[dn][3]);
  }
}

// -- K5: dQ. Own Q and dO (64 q rows of one (b, q head)); walked K, V.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
fa2_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int kv_len,
                   float scale, int causal, int window, float softcap, int order) {
  using L = Smem<D>;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem + L::OA;     // Q hi, lo
  float* const os = smem + L::OB;     // dO hi, lo
  float* const ks = smem + L::WA;     // K hi, lo, then V hi, lo
  float* const vs = smem + L::WB;
  float* const raw = smem + L::RAW;

  const int nm = (Sq + OWN - 1) / OWN;
  const bool paired = PAIRED && causal;
  int b, h, pb;
  decode_block(paired ? (nm + 1) / 2 : nm, Hq, order, b, h, pb);
  const int hk = h / (Hq / Hkv);
  const size_t qoff = ((size_t)b * Hq + h) * (size_t)Sq;
  const float* kh = k + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const int live = min(Skv, kv_len);

  // Warp w owns q rows lr .. lr + 15 and keys wk .. wk + WN - 1 of every
  // walked tile; this thread rows r_lo + g and r_lo + g + 8.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = 16 * (warp % ROW_WARPS);
  const int wk = WN * (warp / ROW_WARPS);
  const bool second = warp >= ROW_WARPS;
  int xq[8], xk[8], xkp[8];   // Q / dO rows, K / V rows for S and dP, K rows for dQ
  row_offsets<D>(xq, lr, g, t);
  row_offsets<D>(xk, wk, g, t);
  pair_offsets<D>(xkp, wk, g, t);
  const float dead_row = __uint_as_float(0xff800000u);   // -inf: 2^(x - inf) = 0
  const float scale2 = scale * LOG2E;
  const float cap_scale = SOFTCAP ? scale / softcap : 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    const int mb = pass == 0 ? pb : nm - 1 - pb;
    if (pass == 1) {
      if (!paired || mb == pb) break;
      __syncthreads();   // the first tile's sums have left the own planes
    }
    const int q0 = mb * OWN;
    int n_lo, n_hi;
    kv_tile_range(q0, OWN, WALK, live, causal, window, n_lo, n_hi);
    const int ntiles = max(0, n_hi - n_lo);
    if (ntiles > 0) {
      land<D>(raw, kh, vh, n_lo * WALK, Skv);
      cp_async_commit();
    }
    split_own<D>(qs, q + qoff * D, q0, Sq);
    split_own<D>(os, dout + qoff * D, q0, Sq);
    const int r_lo = q0 + lr;
    float nl[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + g + 8 * r;
      const float l = row < Sq ? lse[qoff + row] : NEG_INF_F;
      nl[r] = l > ROW_DEAD ? -l * LOG2E : dead_row;
      dl[r] = row < Sq ? delta[qoff + row] : 0.f;
    }
    float acc[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      // This thread's chunks of tile it have landed: split them, then land
      // tile it + 1 while this one multiplies.
      cp_async_wait_all();
      split_walk<D>(raw, ks);
      if (it + 1 < ntiles) {
        land<D>(raw, kh, vh, (n_lo + it + 1) * WALK, Skv);
        cp_async_commit();
      }
      __syncthreads();
      const int c0 = (n_lo + it) * WALK + wk;   // this warp's first key
      const bool dead = r_lo >= Sq || c0 >= live || (causal && c0 > r_lo + 15) ||
                        (window > 0 && c0 + WN - 1 <= r_lo - window);
      if (!dead) {
        // S = Q K^T and dP = dO V^T (16 x WN), k-steps over D.
        float s[WN / 8][4], dp[WN / 8][4], s_x[WN / 8][4], dp_x[WN / 8][4];
#pragma unroll
        for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = s_x[nt][e] = dp_x[nt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < D; kc += 32) {
#pragma unroll
          for (int j = 0; j < 8; j += 2) {   // the k-step of columns kc + 4 j .. + 7
            uint32_t qhi[4], qlo[4], ohi[4], olo[4];
            uint32_t khi[WN / 8][2], klo[WN / 8][2], vhi[WN / 8][2], vlo[WN / 8][2];
            frag_a<D>(qs + kc, qs + L::OWN_PLANE + kc, xq, j, qhi, qlo);
            frag_a<D>(os + kc, os + L::OWN_PLANE + kc, xq, j, ohi, olo);
#pragma unroll
            for (int nt = 0; nt < WN / 8; ++nt) {
              const int o = kc + 8 * nt * D;
              frag_bt<D>(ks + o, ks + L::WALK_PLANE + o, xk, j, khi[nt], klo[nt]);
              frag_bt<D>(vs + o, vs + L::WALK_PLANE + o, xk, j, vhi[nt], vlo[nt]);
            }
            score_step(s, s_x, dp, dp_x, qhi, qlo, ohi, olo, khi, klo, vhi, vlo);
          }
        }
#pragma unroll
        for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] += s_x[nt][e];
            dp[nt][e] += dp_x[nt][e];
          }
        const bool edge = c0 + WN > live || (causal && c0 + WN - 1 > r_lo) ||
                          (window > 0 && c0 <= r_lo + 15 - window);
        // dS = P (dP - delta), split as the A fragments of dQ += dS K.
        uint32_t ahi[WN / 8][4], alo[WN / 8][4];
#pragma unroll
        for (int nt = 0; nt < WN / 8; ++nt) {
          float e[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1;
            float f;
            float p = recompute_p<SOFTCAP>(s[nt][i], nl[r], scale2, cap_scale, softcap, &f);
            if (edge && !visible(c0 + 8 * nt + 2 * t + (i & 1), r_lo + g + 8 * r, live, causal,
                                 window))
              p = 0.f;
            e[i] = p * (dp[nt][i] - dl[r]) * f;
          }
          acc_to_a(e, ahi[nt], alo[nt]);
        }
        // dQ += dS K by 32-column groups: each group sums this tile's WN
        // keys in zeroed accumulators, then adds them to the walk's sums in
        // float32, so no chain of mma runs over the whole walk.
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          float part[4][4] = {};
#pragma unroll
          for (int nt = 0; nt < WN / 8; ++nt) {
            const int o = 8 * nt * D + 32 * c;
            mma_group<D>(part, ahi[nt], alo[nt], ks + o, ks + L::WALK_PLANE + o, xkp);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[4 * c + n][e] += part[n][e];
        }
      }
      __syncthreads();   // the walked planes are free for the next split
    }

    if constexpr (HALVES > 1) add_halves<D>(acc, smem, second, lr, g, t);
    if (!second) store_rows<D>(dq + qoff * D, acc, r_lo + g, Sq, t, scale);
  }
}

// -- K6: dK, dV. Own K and V (64 kv rows of one (b, kv head)); walked Q and
// dO of the GQA group's q heads, each head's live q tiles in turn.
template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
fa2_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv, int Sq,
                    int Skv, int kv_len, float scale, int causal, int window, float softcap,
                    int order) {
  using L = Smem<D>;
  extern __shared__ __align__(16) float smem[];
  float* const ks = smem + L::OA;     // K hi, lo
  float* const vs = smem + L::OB;     // V hi, lo
  float* const qs = smem + L::WA;     // Q hi, lo, then dO hi, lo
  float* const os = smem + L::WB;
  float* const raw = smem + L::RAW;
  float* const cols = smem + L::COLS;

  const int nkv = (Skv + OWN - 1) / OWN;
  const bool paired = PAIRED && causal;
  int b, hk, pb;
  decode_block(paired ? (nkv + 1) / 2 : nkv, Hkv, order, b, hk, pb);
  const int group = Hq / Hkv;
  const size_t kvoff = ((size_t)b * Hkv + hk) * (size_t)Skv;
  const int live = min(Skv, kv_len);
  const int nm = (Sq + WALK - 1) / WALK;
  const float dead_row = __uint_as_float(0xff800000u);   // -inf: 2^(x - inf) = 0
  const bool fetcher = threadIdx.x < 2 * WALK;

  // Warp w owns kv rows lr .. lr + 15 and q rows wq .. wq + WN - 1 of every
  // walked tile; this thread kv rows k_lo + g and k_lo + g + 8.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = 16 * (warp % ROW_WARPS);
  const int wq = WN * (warp / ROW_WARPS);
  const bool second = warp >= ROW_WARPS;
  int xk[8], xq[8], xqp[8];   // K / V rows, Q / dO rows for S^T and dP^T, for dV and dK
  row_offsets<D>(xk, lr, g, t);
  row_offsets<D>(xq, wq, g, t);
  pair_offsets<D>(xqp, wq, g, t);
  const float scale2 = scale * LOG2E;
  const float cap_scale = SOFTCAP ? scale / softcap : 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    const int nb = pass == 0 ? pb : nkv - 1 - pb;
    if (pass == 1) {
      if (!paired || nb == pb) break;
      __syncthreads();   // the first tile's sums have left the own planes
    }
    const int c0 = nb * OWN;
    // Live q tiles of these keys: none if all are past kv_len; causal rows
    // >= c0; window rows <= c0 + OWN - 1 + window - 1.
    const int m_lo = causal ? c0 / WALK : 0;
    int m_hi = c0 < live ? nm : 0;
    if (window > 0) m_hi = min(m_hi, (c0 + OWN - 1 + window - 1) / WALK + 1);
    const int nq = max(0, m_hi - m_lo);
    const int ntiles = group * nq;
    // Walked tile t: q head hk * group + t / nq, rows from (m_lo + t % nq) * WALK.
    auto plane_of = [&](int t) { return (size_t)b * Hq + (size_t)hk * group + t / nq; };
    auto row_of = [&](int t) { return (m_lo + t % nq) * WALK; };
    auto land_tile = [&](int t) {
      const size_t off = plane_of(t) * Sq * D;
      land<D>(raw, q + off, dout + off, row_of(t), Sq);
      cp_async_commit();
    };
    // Thread i < WALK fetches -lse log2(e) of row i of walked tile t (-inf
    // past Sq or for a fully masked row), thread WALK + i its delta; one tile
    // ahead, stored to `cols` when the tile is split.
    auto fetch = [&](int t) -> float {
      const int row = row_of(t) + (threadIdx.x & (WALK - 1));
      const size_t at = plane_of(t) * Sq + row;
      if (threadIdx.x < WALK) {
        const float l = row < Sq ? lse[at] : NEG_INF_F;
        return l > ROW_DEAD ? -l * LOG2E : dead_row;
      }
      return row < Sq ? delta[at] : 0.f;
    };
    float ahead = 0.f;
    if (ntiles > 0) {
      land_tile(0);
      if (fetcher) ahead = fetch(0);
    }
    split_own<D>(ks, k + kvoff * D, c0, Skv);
    split_own<D>(vs, v + kvoff * D, c0, Skv);
    const int k_lo = c0 + lr;
    float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[dn][e] = acc_v[dn][e] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      cp_async_wait_all();
      split_walk<D>(raw, qs);
      if (fetcher) cols[threadIdx.x] = ahead;
      if (it + 1 < ntiles) {
        land_tile(it + 1);
        if (fetcher) ahead = fetch(it + 1);
      }
      __syncthreads();
      const int m0 = row_of(it);
      const int p_lo = m0 + wq;   // this warp's first q row
      const bool dead = k_lo >= live || p_lo >= Sq || (causal && k_lo > p_lo + WN - 1) ||
                        (window > 0 && k_lo + 15 <= p_lo - window);
      if (!dead) {
        // S^T = K Q^T and dP^T = V dO^T (16 x WN), k-steps over D.
        float st[WN / 8][4], dpt[WN / 8][4], st_x[WN / 8][4], dpt_x[WN / 8][4];
#pragma unroll
        for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = st_x[nt][e] = dpt_x[nt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < D; kc += 32) {
#pragma unroll
          for (int j = 0; j < 8; j += 2) {   // the k-step of columns kc + 4 j .. + 7
            uint32_t khi[4], klo[4], vhi[4], vlo[4];
            uint32_t qhi[WN / 8][2], qlo[WN / 8][2], ohi[WN / 8][2], olo[WN / 8][2];
            frag_a<D>(ks + kc, ks + L::OWN_PLANE + kc, xk, j, khi, klo);
            frag_a<D>(vs + kc, vs + L::OWN_PLANE + kc, xk, j, vhi, vlo);
#pragma unroll
            for (int nt = 0; nt < WN / 8; ++nt) {
              const int o = kc + 8 * nt * D;
              frag_bt<D>(qs + o, qs + L::WALK_PLANE + o, xq, j, qhi[nt], qlo[nt]);
              frag_bt<D>(os + o, os + L::WALK_PLANE + o, xq, j, ohi[nt], olo[nt]);
            }
            score_step(st, st_x, dpt, dpt_x, khi, klo, vhi, vlo, qhi, qlo, ohi, olo);
          }
        }
#pragma unroll
        for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[nt][e] += st_x[nt][e];
            dpt[nt][e] += dpt_x[nt][e];
          }
        const bool edge = k_lo + 15 >= live || (causal && k_lo + 15 > p_lo) ||
                          (window > 0 && k_lo <= p_lo + WN - 1 - window);
        // P^T and dS^T, split as the A fragments of dV += P^T dO and dK +=
        // dS^T Q; lse and delta are per column, from `cols`.
        uint32_t phi[WN / 8][4], plo[WN / 8][4], dhi[WN / 8][4], dlo[WN / 8][4];
#pragma unroll
        for (int nt = 0; nt < WN / 8; ++nt) {
          float pe[4], de[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1;
            const int c = wq + 8 * nt + 2 * t + (i & 1);
            float f;
            float p = recompute_p<SOFTCAP>(st[nt][i], cols[c], scale2, cap_scale, softcap, &f);
            if (edge && !visible(k_lo + g + 8 * r, m0 + c, live, causal, window)) p = 0.f;
            pe[i] = p;
            de[i] = p * (dpt[nt][i] - cols[WALK + c]) * f;
          }
          acc_to_a(pe, phi[nt], plo[nt]);
          acc_to_a(de, dhi[nt], dlo[nt]);
        }
        // dV += P^T dO and dK += dS^T Q by 32-column groups, this tile's WN
        // q rows summed in zeroed accumulators, then added (as K5's dQ).
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          float pv[4][4] = {}, pk[4][4] = {};
#pragma unroll
          for (int nt = 0; nt < WN / 8; ++nt) {
            const int o = 8 * nt * D + 32 * c;
            mma_group<D>(pv, phi[nt], plo[nt], os + o, os + L::WALK_PLANE + o, xqp);
            mma_group<D>(pk, dhi[nt], dlo[nt], qs + o, qs + L::WALK_PLANE + o, xqp);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc_v[4 * c + n][e] += pv[n][e];
              acc_k[4 * c + n][e] += pk[n][e];
            }
        }
      }
      __syncthreads();   // the walked planes and cols are free for the next split
    }

    if constexpr (HALVES > 1) {
      add_halves<D>(acc_k, smem, second, lr, g, t);
      add_halves<D>(acc_v, smem + L::OWN_PLANE, second, lr, g, t);
    }
    if (!second) {
      store_rows<D>(dk + kvoff * D, acc_k, k_lo + g, Skv, t, scale);
      store_rows<D>(dv + kvoff * D, acc_v, k_lo + g, Skv, t, 1.f);
    }
  }
}

template <int D, bool SOFTCAP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int B, int Hq, int Hkv, int Sq, int Skv,
              int kv_len, float scale, int causal, int window, float softcap, int order,
              cudaStream_t stream) {
  const int nm = (Sq + OWN - 1) / OWN;
  const long long blocks = (long long)B * Hq * (PAIRED && causal ? (nm + 1) / 2 : nm);
  if (blocks <= 0) return 0;
  const cudaError_t e = allow_smem(fa2_dq_tf32_kernel<D, SOFTCAP>, Smem<D>::bytes);
  if (e != cudaSuccess) return (int)e;
  fa2_dq_tf32_kernel<D, SOFTCAP><<<(unsigned)blocks, THREADS, Smem<D>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), Hq, Hkv, Sq, Skv, kv_len, scale, causal, window, softcap,
      order);
  return (int)cudaGetLastError();
}

template <int D, bool SOFTCAP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
               int kv_len, float scale, int causal, int window, float softcap, int order,
               cudaStream_t stream) {
  const int nkv = (Skv + OWN - 1) / OWN;
  const long long blocks = (long long)B * Hkv * (PAIRED && causal ? (nkv + 1) / 2 : nkv);
  if (blocks <= 0) return 0;
  const cudaError_t e = allow_smem(fa2_dkv_tf32_kernel<D, SOFTCAP>, Smem<D>::bytes);
  if (e != cudaSuccess) return (int)e;
  fa2_dkv_tf32_kernel<D, SOFTCAP><<<(unsigned)blocks, THREADS, Smem<D>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), Hq, Hkv, Sq, Skv, kv_len, scale,
      causal, window, softcap, order);
  return (int)cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Entry points, all with one signature. Each returns a cudaError_t (0 =
// success), -1 for a head_dim this build does not instantiate, or (the
// bf16 ones) -2 if a tensor map could not be encoded.
#define BWD_DQ_ARGS                                                                       \
  const void *q, const void *k, const void *v, const void *dout, const float *lse,        \
      const float *delta, void *dq, int B, int Hq, int Hkv, int Sq, int Skv, int kv_len,  \
      int D, float scale, int causal, int window, float softcap, int order, void *stream
#define BWD_DKV_ARGS                                                                      \
  const void *q, const void *k, const void *v, const void *dout, const float *lse,        \
      const float *delta, void *dk, void *dv, int B, int Hq, int Hkv, int Sq, int Skv,    \
      int kv_len, int D, float scale, int causal, int window, float softcap, int order,   \
      void *stream
#define DQ_PASS(FN)                                                                    \
  return FN(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, kv_len, scale, causal, \
            window, softcap, order, static_cast<cudaStream_t>(stream))
#define DKV_PASS(FN)                                                                       \
  return FN(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Skv, kv_len, scale, causal, \
            window, softcap, order, static_cast<cudaStream_t>(stream))
#define DKV256_PASS(FN)                                                                    \
  return FN(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Skv, kv_len, scale, causal, \
            window, softcap, order, parts, scratch, static_cast<cudaStream_t>(stream))

// float32 on the tensor cores in 3xTF32, head_dim 64 or 128; 16-byte
// aligned contiguous rows (the 16-byte loads' requirement).
extern "C" int fa2_bwd_dq_tf32(BWD_DQ_ARGS) {
  const bool cap = softcap > 0.f;
  if (D == 128) {
    if (cap) DQ_PASS((f32::launch_dq<128, true>));
    DQ_PASS((f32::launch_dq<128, false>));
  }
  if (D == 64) {
    if (cap) DQ_PASS((f32::launch_dq<64, true>));
    DQ_PASS((f32::launch_dq<64, false>));
  }
  return -1;
}

extern "C" int fa2_bwd_dkv_tf32(BWD_DKV_ARGS) {
  const bool cap = softcap > 0.f;
  if (D == 128) {
    if (cap) DKV_PASS((f32::launch_dkv<128, true>));
    DKV_PASS((f32::launch_dkv<128, false>));
  }
  if (D == 64) {
    if (cap) DKV_PASS((f32::launch_dkv<64, true>));
    DKV_PASS((f32::launch_dkv<64, false>));
  }
  return -1;
}

// bfloat16 on the tensor cores, head_dim 64, 128 or 256; 16-byte aligned
// contiguous rows (the tensor maps' requirement).
extern "C" int fa2_bwd_dq_tc(BWD_DQ_ARGS) {
  const bool cap = softcap > 0.f;
  if (D == 256) {
    if (cap) DQ_PASS((tc::launch_dq256<true>));
    DQ_PASS((tc::launch_dq256<false>));
  }
  if (D == 128) {
    if (cap) DQ_PASS((tc::launch_dq<128, true>));
    DQ_PASS((tc::launch_dq<128, false>));
  }
  if (D == 64) {
    if (cap) DQ_PASS((tc::launch_dq<64, true>));
    DQ_PASS((tc::launch_dq<64, false>));
  }
  return -1;
}

// K6 also takes the split of its walk at head_dim 256: `parts` parts over
// a float32 `scratch` of (B * Hkv, ceil(Skv / 64), parts, 2, 64, 256);
// parts 1 (no scratch) below head_dim 256.
extern "C" int fa2_bwd_dkv_tc(BWD_DKV_ARGS, int parts, float *scratch) {
  const bool cap = softcap > 0.f;
  if (D == 256) {
    if (cap) DKV256_PASS((tc::launch_dkv256<true>));
    DKV256_PASS((tc::launch_dkv256<false>));
  }
  if (parts != 1) return -1;
  if (D == 128) {
    if (cap) DKV_PASS((tc::launch_dkv<128, true>));
    DKV_PASS((tc::launch_dkv<128, false>));
  }
  if (D == 64) {
    if (cap) DKV_PASS((tc::launch_dkv<64, true>));
    DKV_PASS((tc::launch_dkv<64, false>));
  }
  return -1;
}
