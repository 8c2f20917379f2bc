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
// tile pair, K6 4), far above the card's balance point, so the bf16 tensor
// cores (989 TFLOP/s) are the only way to that bound. Two routes:
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
// * float32: fa2_dq_kernel and fa2_dkv_kernel on the CUDA cores in float32
//   (TF32 tensor cores would keep ~3 decimal digits), 4 x 4 register tiles
//   fed from shared memory in the layout of csrc/prefill_tile.cuh.
//
// What the design does about the TPU's choices: the Pallas kernels carry
// dQ (and dK / dV) in VMEM scratch across a sequential grid axis; here that
// axis is a loop inside the block, so nothing crosses blocks. K6 sums the
// GQA group inside the block (one block per (b, kv head, kv tile) loops over
// the group's q heads), so no (B, Hq, Skv, D) partials are written and no
// atomics are used: gradients are the same from run to run. One fused
// kernel with an atomic dQ would do 5 products a tile pair against these 7
// (3 + 4), at the price of that determinism. The MappingConfig order
// decodes blockIdx head-first (the tiles of one head consecutive, so blocks
// running together share K / V, or Q / dO, in L2) or block-first (heads
// fastest), the paper's choice for the backward pass. The order changes
// which blocks run together, never a block's sums.
#include "hopper.cuh"
#include "prefill_tile.cuh"

namespace {

using namespace rt;

constexpr float ROW_DEAD = NEG_INF_F * 0.5f;   // lse at or below: a fully masked row

// -- float32 on the CUDA cores -------------------------------------------------

constexpr int BM = PF_BM;          // q rows per tile
constexpr int BN = PF_BN;          // kv rows per tile
constexpr int THREADS = PF_THREADS;

template <int D>
struct BwdSmem {
  static constexpr int DP = D + 1;    // padded row of Q, dO, K, V
  static constexpr int PP = BN + 1;   // padded row of a P / dS tile
  // K5: Q, dO, K, V tiles + dS tile.
  static constexpr size_t dq_bytes =
      sizeof(float) * (size_t)(4 * BM * DP + BM * PP);
  // K6: K, V, Q, dO tiles + P^T and dS^T tiles + lse and delta of the q tile.
  static constexpr size_t dkv_bytes =
      sizeof(float) * (size_t)(4 * BM * DP + 2 * BN * PP + 2 * BM);
};

// Softcap, the p recomputation and dS for one (row, col) pair.
__device__ __forceinline__ float grad_score(float s_acc, float dp, float lse,
                                            float delta, bool ok, float scale,
                                            float softcap, float* p_out) {
  const float sc = apply_softcap(s_acc * scale, softcap);
  const float p = ok ? expf(sc - lse) : 0.f;
  float ds = p * (dp - delta);
  if (softcap > 0.f) {
    const float t = sc / softcap;
    ds *= 1.f - t * t;
  }
  *p_out = p;
  return ds;
}

// ---- K5: dQ -----------------------------------------------------------------
// One block per (b, q head, 64-row q tile); thread (ty, tx) owns q rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and dQ columns
// tx + 16 c (c < D / 16).
template <int D>
__global__ void __launch_bounds__(THREADS)
fa2_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int kv_len,
              float scale, int causal, int window, float softcap, int order) {
  extern __shared__ float smem[];
  constexpr int DP = BwdSmem<D>::DP;
  constexpr int PP = BwdSmem<D>::PP;
  float* Qs = smem;
  float* dOs = Qs + BM * DP;
  float* Ks = dOs + BM * DP;
  float* Vs = Ks + BN * DP;
  float* dSs = Vs + BN * DP;

  int b, h, mb;
  decode_block((Sq + BM - 1) / BM, Hq, order, b, h, mb);
  const int hk = h / (Hq / Hkv);
  const size_t qoff = ((size_t)b * Hq + h) * (size_t)Sq;
  const float* kh = k + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const int q0 = mb * BM;

  stage_rows<D, DP, float>(Qs, [&](int rr) -> const float* {
    return q0 + rr < Sq ? q + (qoff + q0 + rr) * D : nullptr;
  });
  stage_rows<D, DP, float>(dOs, [&](int rr) -> const float* {
    return q0 + rr < Sq ? dout + (qoff + q0 + rr) * D : nullptr;
  });

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float row_lse[4], row_delta[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < Sq ? lse[qoff + row] : NEG_INF_F;
    row_delta[i] = row < Sq ? delta[qoff + row] : 0.f;
    row_ok[i] = row < Sq && row_lse[i] > ROW_DEAD;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int live = min(Skv, kv_len);
  int n_lo, n_hi;
  kv_tile_range(q0, BM, BN, live, causal, window, n_lo, n_hi);
  for (int n = n_lo; n < n_hi; ++n) {
    const int c0 = n * BN;
    __syncthreads();
    stage_rows<D, DP, float>(Ks, [&](int rr) -> const float* {
      return c0 + rr < Skv ? kh + (size_t)(c0 + rr) * D : nullptr;
    });
    stage_rows<D, DP, float>(Vs, [&](int rr) -> const float* {
      return c0 + rr < Skv ? vh + (size_t)(c0 + rr) * D : nullptr;
    });
    __syncthreads();

    // S = Q K^T and dP = dO V^T, both (64 x 64), in one sweep over D.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + kk];
        ov[i] = dOs[(ty + 16 * i) * DP + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + kk];
        vv[j] = Vs[(tx + 16 * j) * DP + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        bool ok = row_ok[i] && col < live;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        float p;
        dSs[(ty + 16 * i) * PP + tx + 16 * j] =
            grad_score(s[i][j], dp[i][j], row_lse[i], row_delta[i], ok, scale,
                       softcap, &p);
      }
    }
    __syncthreads();

    // dQ += dS K.
#pragma unroll 4
    for (int jj = 0; jj < BN; ++jj) {
      float dsv[4], kv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * PP + jj];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) kv[c] = Ks[jj * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  float* dqh = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      dqh[(size_t)row * D + tx + 16 * c] = scale * acc[i][c];
  }
}

// ---- K6: dK, dV ------------------------------------------------------------
// One block per (b, kv head, 64-row kv tile); thread (ty, tx) owns kv rows
// ty + 16 i (i < 4), q columns tx + 16 j of the transposed score tile and
// dK / dV columns tx + 16 c. The block loops over the group's q heads and,
// for each, the q tiles that causal, window and Sq leave live.
template <int D>
__global__ void __launch_bounds__(THREADS)
fa2_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv, int Sq,
               int Skv, int kv_len, float scale, int causal, int window,
               float softcap, int order) {
  extern __shared__ float smem[];
  constexpr int DP = BwdSmem<D>::DP;
  constexpr int PP = BwdSmem<D>::PP;
  float* Ks = smem;
  float* Vs = Ks + BN * DP;
  float* Qs = Vs + BN * DP;
  float* dOs = Qs + BM * DP;
  float* Pt = dOs + BM * DP;
  float* dSt = Pt + BN * PP;
  float* Ls = dSt + BN * PP;
  float* Ds = Ls + BM;

  int b, hk, nb;
  decode_block((Skv + BN - 1) / BN, Hkv, order, b, hk, nb);
  const int group = Hq / Hkv;
  const size_t kvoff = ((size_t)b * Hkv + hk) * (size_t)Skv;
  const int c0 = nb * BN;
  const int live = min(Skv, kv_len);

  stage_rows<D, DP, float>(Ks, [&](int rr) -> const float* {
    return c0 + rr < Skv ? k + (kvoff + c0 + rr) * D : nullptr;
  });
  stage_rows<D, DP, float>(Vs, [&](int rr) -> const float* {
    return c0 + rr < Skv ? v + (kvoff + c0 + rr) * D : nullptr;
  });

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // Live q tiles of this kv tile: none past kv_len; causal rows >= c0;
  // window rows <= c0 + BN - 1 + window - 1.
  const int nm = (Sq + BM - 1) / BM;
  int m_lo = 0, m_hi = c0 < live ? nm : 0;
  if (causal) m_lo = c0 / BM;
  if (window > 0) m_hi = min(m_hi, (c0 + BN - 1 + window - 1) / BM + 1);

  for (int g = 0; g < group; ++g) {
    const size_t qoff = ((size_t)b * Hq + (size_t)hk * group + g) * (size_t)Sq;
    for (int mb = m_lo; mb < m_hi; ++mb) {
      const int q0 = mb * BM;
      __syncthreads();
      stage_rows<D, DP, float>(Qs, [&](int rr) -> const float* {
        return q0 + rr < Sq ? q + (qoff + q0 + rr) * D : nullptr;
      });
      stage_rows<D, DP, float>(dOs, [&](int rr) -> const float* {
        return q0 + rr < Sq ? dout + (qoff + q0 + rr) * D : nullptr;
      });
      if (threadIdx.x < BM) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < Sq ? lse[qoff + row] : NEG_INF_F;
        Ds[threadIdx.x] = row < Sq ? delta[qoff + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, both (64 kv x 64 q).
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D; ++kk) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * DP + kk];
          vv[i] = Vs[(ty + 16 * i) * DP + kk];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + kk];
          ov[j] = dOs[(tx + 16 * j) * DP + kk];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jl = tx + 16 * j;
          const int row = q0 + jl;
          const float l = Ls[jl];
          bool ok = row < Sq && l > ROW_DEAD && col < live;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          float p;
          dSt[(ty + 16 * i) * PP + jl] =
              grad_score(st[i][j], dpt[i][j], l, Ds[jl], ok, scale, softcap, &p);
          Pt[(ty + 16 * i) * PP + jl] = p;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q.
#pragma unroll 2
      for (int jj = 0; jj < BM; ++jj) {
        float pv[4], dsv[4], ov[D / 16], qv[D / 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(ty + 16 * i) * PP + jj];
          dsv[i] = dSt[(ty + 16 * i) * PP + jj];
        }
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          ov[c] = dOs[jj * DP + tx + 16 * c];
          qv[c] = Qs[jj * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < D / 16; ++c) {
            acc_v[i][c] = fmaf(pv[i], ov[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(dsv[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

  float* dkh = dk + kvoff * D;
  float* dvh = dv + kvoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c0 + ty + 16 * i;
    if (row >= Skv) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dkh[(size_t)row * D + tx + 16 * c] = scale * acc_k[i][c];
      dvh[(size_t)row * D + tx + 16 * c] = acc_v[i][c];
    }
  }
}

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
  static_assert(bytes <= 232448, "above the 227 KB of shared memory a block may use");
};

constexpr int P_READY = 3;    // named barriers over both warpgroups
constexpr int DS_READY = 4;

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

  int b, h, mb;
  decode_block((Sq + L::ROWS - 1) / L::ROWS, Hq, order, b, h, mb);
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
// the GQA group's q heads and each head's live q tiles.
template <bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
fa2_dkv_tc256_kernel(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdk,
                     const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
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

  int b, hk, nb;
  decode_block((Skv + L::ROWS - 1) / L::ROWS, Hkv, order, b, hk, nb);
  const int group = Hq / Hkv;
  const int kv_plane = b * Hkv + hk;
  const int c0 = nb * L::ROWS;
  const int live = min(Skv, kv_len);
  // Live q tiles of these keys: none if all are past kv_len; causal rows
  // >= c0; window rows <= c0 + 63 + window - 1.
  const int nm = (Sq + BT - 1) / BT;
  const int m_lo = causal ? c0 / BT : 0;
  int m_hi = c0 < live ? nm : 0;
  if (window > 0) m_hi = min(m_hi, (c0 + L::ROWS - 1 + window - 1) / BT + 1);
  const int nq = max(0, m_hi - m_lo);
  const int ntiles = group * nq;
  auto ring = [&](int t, int& row, int& p) {   // q head hk * group + t / nq
    row = (m_lo + t % nq) * BT;
    p = b * Hq + hk * group + t / nq;
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
    const int q0 = (m_lo + t % nq) * BT;
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

  // dK = scale * dk and dV through this warpgroup's halves of the K and V
  // tiles: no wgmma reads them once both warpgroups are past the last
  // tile's DS_READY.
  store_half(smem + L::A, &tdk, dk, scale, wg, row0 - c0, lane, c0, kv_plane);
  store_half(smem + L::B, &tdv, dv, 1.f, wg, row0 - c0, lane, c0, kv_plane);
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

template <bool SOFTCAP>
int launch_dkv256(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int B, int Hq,
                  int Hkv, int Sq, int Skv, int kv_len, float scale, int causal, int window,
                  float softcap, int order, cudaStream_t stream) {
  using L = Smem256;
  const long long blocks = (long long)B * Hkv * ((Skv + L::ROWS - 1) / L::ROWS);
  if (blocks <= 0) return 0;
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
      tk, tv, tq, tdo, tdk, tdv, lse, delta, Hq, Hkv, Sq, Skv, kv_len, scale, causal, window,
      softcap, order);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int B, int Hq, int Hkv,
                  int Sq, int Skv, int kv_len, float scale, int causal, int window,
                  float softcap, int order, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dq_bytes;
  cudaError_t err = allow_smem(fa2_dq_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hq * ((Sq + BM - 1) / BM);
  if (blocks <= 0) return 0;
  fa2_dq_kernel<D><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), Hq, Hkv, Sq, Skv, kv_len, scale, causal, window, softcap,
      order);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Skv, int kv_len, float scale, int causal, int window,
                   float softcap, int order, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dkv_bytes;
  cudaError_t err = allow_smem(fa2_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hkv * ((Skv + BN - 1) / BN);
  if (blocks <= 0) return 0;
  fa2_dkv_kernel<D><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), Hq, Hkv, Sq, Skv, kv_len, scale,
      causal, window, softcap, order);
  return (int)cudaGetLastError();
}

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

// float32 on the CUDA cores.
extern "C" int fa2_bwd_dq(BWD_DQ_ARGS) {
  if (D == 128) DQ_PASS(launch_dq_f32<128>);
  if (D == 64) DQ_PASS(launch_dq_f32<64>);
  return -1;
}

extern "C" int fa2_bwd_dkv(BWD_DKV_ARGS) {
  if (D == 128) DKV_PASS(launch_dkv_f32<128>);
  if (D == 64) DKV_PASS(launch_dkv_f32<64>);
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

extern "C" int fa2_bwd_dkv_tc(BWD_DKV_ARGS) {
  const bool cap = softcap > 0.f;
  if (D == 256) {
    if (cap) DKV_PASS((tc::launch_dkv256<true>));
    DKV_PASS((tc::launch_dkv256<false>));
  }
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
