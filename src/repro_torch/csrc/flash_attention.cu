// K1: FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the two Pallas bodies of flash_attention_fwd in the JAX package,
// src/repro/kernels/flash_attention.py: _fwd_resident_kernel (:220) and
// _fwd_stream_kernel (:145). q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D) ->
// o (B, Hq, Sq, D) in q's type and lse (B, Hq, Sq) float32. Causal,
// sliding-window, softcap and kv_len masks; GQA by h / (Hq / Hkv). A fully
// masked row gets o = 0 and lse = -1e30.
//
// What bounds it on an H100: at the prefill shapes of the serving and
// training paths (S >= 512, D 64 or 128) attention does ~S/2 operations per
// byte, far above the card's balance point, so it is bound by arithmetic,
// and the bf16 tensor cores (989 TFLOP/s) are the only way to that bound.
// Two kernels:
//
// * fa2_fwd_tc_kernel, bf16 (every main path): warp-specialised. A block
//   owns 128 query rows of one (b, q head): warpgroups 0 and 1 consume 64
//   rows each, warpgroup 2 loads. One producer thread issues TMA loads of
//   the Q tile (once) and of 128-key K and V tiles through a two-stage ring
//   in shared memory (each stage a "full" mbarrier armed with its bytes and
//   an "empty" one the eight consumer warps arrive on), so the next tile's
//   copy overlaps this tile's products. S = Q K^T is wgmma m64n128k16 with
//   both operands K-major from 128-byte-swizzled shared memory; the online
//   softmax runs on S's registers (each row over the four threads of a
//   quad, ex2.approx with scale * log2(e) folded into one multiply, masks
//   only on tiles that straddle a boundary); P is rounded to bf16 in place,
//   which is the A-register fragment of O += P V (wgmma with V MN-major,
//   the transpose bit set). setmaxnreg gives the consumers 240 registers
//   and the producer 24. Tensor maps are 3-D (D, S, B * H): a tile past S
//   is zero-filled by the hardware instead of reading the next head's rows,
//   and O leaves through shared memory by a TMA store that drops the rows
//   past Sq.
// * fa2_fwd_kernel, float32: the tensor cores take float32 only as TF32
//   (~3 decimal digits), so float32 stays on the CUDA cores in float32, with
//   4 x 4 register tiles over prefill_tile.cuh (shared with K2).
//
// What the design does about the TPU's choices: a 227 KB SM cannot hold the
// TPU's VMEM-resident K/V (64 MiB), so residency becomes L2 reuse. The
// MappingConfig order decides how blockIdx decodes into (b, h, m):
// head-first (order 0) puts the q blocks of one head, and then the heads
// of one GQA group, on consecutive blocks, so blocks running at the same
// time stream the same K/V through L2 (the paper's locality);
// block-first (order 1) cycles heads fastest. The traversal decides the
// KV-tile order of each sweep: linear, or sawtooth (odd q blocks walk their
// tiles backwards, so consecutive sweeps share their boundary tile while it
// is still in L2). Causal and window bounds skip whole KV tiles, so the
// triangular half of the work is never done. No order changes a block's
// arithmetic: head-first and block-first give the same bits.
#include "hopper.cuh"
#include "prefill_tile.cuh"

namespace {

using namespace rt;

// -- float32 on the CUDA cores -------------------------------------------------

template <int D>
__global__ void __launch_bounds__(PF_THREADS)
fa2_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
               int kv_len, float scale, int causal, int window, float softcap,
               int order, int sawtooth) {
  extern __shared__ float smem[];
  constexpr int DP = PrefillSmem<D>::DP;
  float* Qs = smem;
  float* Ks = Qs + PF_BM * DP;
  float* Vs = Ks + PF_BN * DP;
  float* Ps = Vs + PF_BN * D;

  int b, h, mb;
  decode_block((Sq + PF_BM - 1) / PF_BM, Hq, order, b, h, mb);
  const int hk = h / (Hq / Hkv);
  const float* qh = q + ((size_t)b * Hq + h) * (size_t)Sq * D;
  const float* kh = k + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const int q0 = mb * PF_BM;

  stage_rows<D, DP, float>(Qs, [&](int rr) -> const float* {
    return q0 + rr < Sq ? qh + (size_t)(q0 + rr) * D : nullptr;
  });

  RowState<D> st;
  st.init();
  int n_lo, n_hi;
  kv_tile_range(q0, PF_BM, PF_BN, min(Skv, kv_len), causal, window, n_lo, n_hi);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const bool reverse = sawtooth && (mb & 1);
  for (int t = 0; t < n_hi - n_lo; ++t) {
    const int n = reverse ? n_hi - 1 - t : n_lo + t;
    const int c0 = n * PF_BN;
    __syncthreads();
    stage_rows<D, DP, float>(Ks, [&](int rr) -> const float* {
      return c0 + rr < Skv ? kh + (size_t)(c0 + rr) * D : nullptr;
    });
    stage_rows<D, D, float>(Vs, [&](int rr) -> const float* {
      return c0 + rr < Skv ? vh + (size_t)(c0 + rr) * D : nullptr;
    });
    __syncthreads();
    tile_step<D>(Qs, Ks, Vs, Ps, st, scale, softcap, [&](int i, int j) {
      const int row = q0 + ty + 16 * i;
      const int col = c0 + tx + 16 * j;
      bool ok = col < kv_len;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && col > row - window;
      return ok;
    });
  }

  float* oh = o + ((size_t)b * Hq + h) * (size_t)Sq * D;
  float* lh = lse + ((size_t)b * Hq + h) * (size_t)Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l = st.l[i];
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      oh[(size_t)row * D + tx + 16 * c] = st.acc[i][c] / l_safe;
    if (tx == 0) lh[row] = l == 0.f ? NEG_INF_F : st.m[i] + logf(l);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               int Hq, int Hkv, int Sq, int Skv, int kv_len, float scale, int causal,
               int window, float softcap, int order, int sawtooth, cudaStream_t stream) {
  const size_t smem = PrefillSmem<D>::bytes;
  cudaError_t err = allow_smem(fa2_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hq * ((Sq + PF_BM - 1) / PF_BM);
  if (blocks <= 0) return 0;
  fa2_fwd_kernel<D><<<(unsigned)blocks, PF_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hkv, Sq, Skv, kv_len,
      scale, causal, window, softcap, order, sawtooth);
  return (int)cudaGetLastError();
}

// -- bf16 on the tensor cores ----------------------------------------------------

namespace tc {

constexpr int BM = 128;        // q rows of a block: two consumer warpgroups of 64
constexpr int BN = 128;        // keys of a K / V tile
constexpr int STAGES = 2;      // K / V tiles in flight
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, warpgroup 2 loads
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared memory, in bytes from a 1024-byte aligned base: Q, then
// the K and V stages, each a tile of D / 64 swizzled column chunks.
template <int D>
struct Smem {
  static constexpr int TILE = BN * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + BM * D * 2;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;   // full[STAGES], empty[STAGES], q
  static constexpr size_t bytes = BAR + 8 * (2 * STAGES + 1) + 1024;   // + base alignment
};

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
fa2_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to, float* __restrict__ lse, int Hq,
                  int Hkv, int Sq, int Skv, int kv_len, float scale, int causal, int window,
                  float softcap, int order, int sawtooth) {
  using namespace hopper;
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  int b, h, mb;
  decode_block((Sq + BM - 1) / BM, Hq, order, b, h, mb);
  const int hk = h / (Hq / Hkv);
  const int q0 = mb * BM;
  const int live = min(Skv, kv_len);
  int n_lo, n_hi;
  kv_tile_range(q0, BM, BN, live, causal, window, n_lo, n_hi);
  const int ntiles = max(0, n_hi - n_lo);
  const bool reverse = sawtooth && (mb & 1);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, BM * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(smem + L::Q + c * BM * 128, &tq, qbar, c * 64, q0, b * Hq + h);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        const int row = (reverse ? n_hi - 1 - t : n_lo + t) * BN;
        mbar_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(smem + L::K + s * L::TILE + c * BN * 128, &tk, &full[s], c * 64, row,
                      b * Hkv + hk);
          tma_load_3d(smem + L::V + s * L::TILE + c * BN * 128, &tv, &full[s], c * 64, row,
                      b * Hkv + hk);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread rows
    // row0 and row0 + 8, and of every 8 columns the two at 2 (lane % 4).
    regs_alloc<240>();
    const int lane = threadIdx.x & 31;
    const int row_lo = q0 + 64 * wg;
    const int row0 = row_lo + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
    const float scale2 = scale * LOG2E;
    const uint32_t qaddr = smem_u32(smem + L::Q) + wg * 64 * 128;
    float s[BN / 2];
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF_F, NEG_INF_F};
    float l[2] = {0.f, 0.f};   // this thread's part of each row's sum

    mbar_wait(qbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES;
      const int c0 = (reverse ? n_hi - 1 - t : n_lo + t) * BN;
      const uint32_t kaddr = smem_u32(smem + L::K + st * L::TILE);
      const uint32_t vaddr = smem_u32(smem + L::V + st * L::TILE);
      mbar_wait(&full[st], (t / STAGES) & 1);

      // S = Q K^T: D / 16 steps of k16; a step is 32 bytes into a 128-byte
      // swizzled row, every four steps the next column chunk.
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t col = (kc % 4) * 32;
        wgmma_ss_n128(s, desc_sw128(qaddr + (kc / 4) * BM * 128 + col, 16, 1024),
                      desc_sw128(kaddr + (kc / 4) * BN * 128 + col, 16, 1024), kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Scores in log2 units; masks only where the tile straddles kv_len,
      // the diagonal or the window edge (uniform over the warpgroup).
      const bool edge = c0 + BN > live || (causal && c0 + BN - 1 > row_lo) ||
                        (window > 0 && c0 <= row_lo + 63 - window);
      float mx[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = SOFTCAP ? softcap * tanhf(s[i] * scale / softcap) * LOG2E : s[i] * scale2;
        if (edge) {
          const int row = row0 + 8 * ((i >> 1) & 1);
          const int col = c0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          bool ok = col < live;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          x = ok ? x : NEG_INF_F;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
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

      // O += P V: BN / 16 steps of 16 keys (16 rows of 128 bytes each).
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb(acc, p[kk], desc_sw128(vaddr + kk * 16 * 128, BN * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // O goes out through this warpgroup's own 64 rows of the Q tile, which
    // only its finished products read: written there in the tensor map's
    // swizzled layout, then stored by TMA, which drops the rows past Sq.
    const size_t plane = (size_t)b * Hq + h;
    const int tile_row = row0 - row_lo;   // 0 .. 63, plus 8 for r = 1
    uint8_t* otile = smem + L::Q + wg * 64 * 128;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      const int row = row0 + 8 * r;
      if ((lane & 3) == 0 && row < Sq)
        lse[plane * Sq + row] = l[r] == 0.f ? NEG_INF_F : m[r] * LN2 + logf(l[r]);
    }
    stage_tile_bf16<D>(otile, BM * 128, acc, inv, tile_row, lane);
    fence_async_smem();
    named_barrier_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_3d(&to, otile + c * BM * 128, c * 64, row_lo, (int)plane);
      tma_store_wait();
    }
  }
}

template <int D, bool SOFTCAP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
           int Hkv, int Sq, int Skv, int kv_len, float scale, int causal, int window,
           float softcap, int order, int sawtooth, cudaStream_t stream) {
  const long long blocks = (long long)B * Hq * ((Sq + BM - 1) / BM);
  if (blocks <= 0) return 0;
  CUtensorMap tq, tk, tv, to;
  int err = hopper::make_map_3d(&tq, q, D, Sq, B * Hq, BM);
  if (err == 0) err = hopper::make_map_3d(&tk, k, D, Skv, B * Hkv, BN);
  if (err == 0) err = hopper::make_map_3d(&tv, v, D, Skv, B * Hkv, BN);
  if (err == 0) err = hopper::make_map_3d(&to, o, D, Sq, B * Hq, BM / 2);
  if (err != 0) return err;
  const size_t smem = Smem<D>::bytes;
  const cudaError_t e = allow_smem(fa2_fwd_tc_kernel<D, SOFTCAP>, smem);
  if (e != cudaSuccess) return (int)e;
  fa2_fwd_tc_kernel<D, SOFTCAP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      tq, tk, tv, to, lse, Hq, Hkv, Sq, Skv, kv_len, scale, causal, window, softcap, order,
      sawtooth);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// float32 q / k / v. Returns a cudaError_t (0 = success), or -1 for a
// head_dim this build does not instantiate.
extern "C" int fa2_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                       int kv_len, int D, float scale, int causal, int window,
                       float softcap, int order, int sawtooth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA2_CASE(DIM)                                                                 \
  return launch_f32<DIM>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, kv_len, scale, causal, \
                         window, softcap, order, sawtooth, s)
  if (D == 128) FA2_CASE(128);
  if (D == 64) FA2_CASE(64);
#undef FA2_CASE
  return -1;
}

// bfloat16 q / k / v on the tensor cores; 16-byte aligned contiguous rows
// (the tensor maps' requirement). Returns a cudaError_t (0 = success), -1
// for a head_dim this build does not instantiate, -2 if a tensor map could
// not be encoded.
extern "C" int fa2_fwd_tc(const void* q, const void* k, const void* v, void* o,
                          float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                          int kv_len, int D, float scale, int causal, int window,
                          float softcap, int order, int sawtooth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA2_TC_CASE(DIM, CAP)                                                          \
  return tc::launch<DIM, CAP>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, kv_len, scale,     \
                              causal, window, softcap, order, sawtooth, s)
  const bool cap = softcap > 0.f;
  if (D == 128) {
    if (cap) FA2_TC_CASE(128, true);
    FA2_TC_CASE(128, false);
  }
  if (D == 64) {
    if (cap) FA2_TC_CASE(64, true);
    FA2_TC_CASE(64, false);
  }
#undef FA2_TC_CASE
  return -1;
}
