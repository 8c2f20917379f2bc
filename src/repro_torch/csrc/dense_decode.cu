// K7 and K8: dense flash-decode for Hopper (sm_90a), one-pass and split-K.
//
// Replaces the Pallas bodies of the JAX package's
// src/repro/kernels/decode_attention.py: _decode_kernel (:59, launched by
// flash_decode :175) and _decode_split_kernel (:88, launched by
// _flash_decode_split :227), whose split states merge in
// kernels/decode_common.py:combine_split_states (:107). One query token per
// sequence, q (B, Hq, D), against a dense per-slot stripe k / v (B, Hkv,
// Smax, D) with lengths (B,), softcap and sliding window. Length-0 rows give
// exact zeros. The stripe may be a view cut to the live width: the batch
// and head strides are free, the rows of one head contiguous.
//
// What bounds it on an H100: decode reads every live K/V byte once and does
// 4 * group operations per K/V element pair, far below the card's ~295
// operations a byte, so it is bound by memory. A one-pass launch has only
// B * Hkv blocks (40 at hymba-1.5b's B 8, 32 to 64 at llama3-8b's), so each
// block must keep tens of KB of loads in flight to pull its share: one
// block streams a whole 4096-key row (1 MB at D 64).
//
// Two kernels:
//
// * dense_decode_tc_kernel, bf16 (every serve path). One block per (b, kv
//   head) for K7, per (b, kv head, split) for K8 (chunk-granular split
//   ranges from cache.layout.decode_split_ranges, computed by the wrapper);
//   the whole GQA group rides in the block, so each K/V byte is read once
//   for all G heads (the paper's head-first co-location, applied to
//   decode). A producer warp's one thread issues TMA loads of 64-row bf16 K
//   and V tiles (a 4-D tensor map that takes the view's strides, 128-byte
//   swizzled) into a ring of 128 KB (8 stages at D 64, 4 at D 128) on
//   mbarriers, as far ahead as the ring allows. The block reads only the
//   rows a valid position touches: [max(split start, length - window),
//   min(split end, length)), in 64-row tiles from its first row, so a
//   window-1024 layer reads ~1024 rows, not the stripe. Four consumer
//   warps run the products on the tensor cores with mma.sync m16n8k16: q's
//   G rows, zero-padded to 16 (two m16 tiles for G > 16, each taken by two
//   of the warps), sit in registers as A fragments for the whole walk. The
//   warps of one m16 tile take whole tiles in turn, so four (or two) tiles
//   are in the products at once: a tile's chain of loads, products and
//   softmax is latency-bound, and one tile at a time (all warps on key
//   slices of it) kept a block at half the rate (measured). Per tile: S =
//   q K^T with K fed by ldmatrix from the swizzled tile, an online softmax
//   in S's registers (exp2 with scale * log2(e) folded into one multiply;
//   positions past the range get P exactly 0 by masking, so stale rows of
//   an earlier request or pad rows inside the view never count), then O +=
//   P V with P rounded to bf16 as the A fragment and V by ldmatrix.trans.
//   No block-wide barrier per tile: a warp releases a stage by one mbarrier
//   arrival. The warps' states merge once, through shared memory, at the
//   end. K7 writes the normalised bf16 row; K8 writes float32 (acc, m, l)
//   (m in natural units), merged by decode_common.cuh's combine kernel,
//   shared with K4.
// * dense_decode_kernel, float32: the tensor cores take float32 only as
//   TF32 (~3 decimal digits), so float32 stays on the CUDA cores over
//   decode_common.cuh's accumulate_kv_block (shared with K3 / K4), staging
//   DC_BT rows at a time with 16-byte loads and skipping chunks no position
//   of the row can see (chunk_relevant).
#include "decode_common.cuh"
#include "hopper.cuh"

namespace {

using namespace rt;

// -- float32 on the CUDA cores -------------------------------------------------

// SPLIT = false: K7, grid (1, Hkv, B), walks chunks [0, num_chunks) and
// writes the normalised row to `out`. SPLIT = true: K8, grid (S, Hkv, B),
// split s walks chunks [s * cps, min((s + 1) * cps, num_chunks)) and writes
// (acc, m, l).
template <int D, int MAXG, bool SPLIT>
__global__ void __launch_bounds__(DC_THREADS)
dense_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ out, float* __restrict__ acc_out,
                    float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int G,
                    long long stride_b, long long stride_h, int chunk, int num_chunks,
                    int cps, float scale, int window, float softcap) {
  constexpr int DP = D + 1;
  constexpr int CPT = DecodeCols<D>::CPT;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + MAXG * D;
  float* vs = ks + DC_BT * DP;
  float* ss = vs + DC_BT * D;
  float* ms = ss + MAXG * DC_BT;
  float* ls = ms + MAXG;
  float* as = ls + MAXG;

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int Hq = Hkv * G;
  const int length = lengths[b];
  const int c_lo = SPLIT ? s * cps : 0;
  const int c_hi = SPLIT ? min(c_lo + cps, num_chunks) : num_chunks;

  const float* qrow = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int idx = tid; idx < G * D; idx += DC_THREADS) qs[idx] = to_f(qrow[idx]);
  if (tid < MAXG) {
    ms[tid] = NEG_INF_F;
    ls[tid] = 0.f;
  }
  float acc[MAXG][CPT];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[g][c] = 0.f;

  const size_t head = (size_t)b * stride_b + (size_t)h * stride_h;
  for (int c = c_lo; c < c_hi; ++c) {
    const int c_start = c * chunk;
    if (!chunk_relevant(c_start, chunk, length, window)) continue;  // block-uniform
    for (int t0 = 0; t0 < chunk; t0 += DC_BT) {
      const int start = c_start + t0;
      const int limit = start + min(DC_BT, chunk - t0);
      // A sub-tile with no visible position leaves (acc, m, l) unchanged.
      if (!chunk_relevant(start, limit - start, length, window)) continue;
      __syncthreads();
      for (int idx = tid; idx < DC_BT * (D / 8); idx += DC_THREADS) {
        const int t = idx / (D / 8);
        const int c8 = (idx - t * (D / 8)) * 8;
        float tk[8], tv[8];
        if (pos_valid(start + t, length, limit, window)) {
          const size_t off = head + (size_t)(start + t) * D + c8;
          load8(k + off, tk);
          load8(v + off, tv);
        } else {
          zero8(tk);
          zero8(tv);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ks[t * DP + c8 + e] = tk[e];
          vs[t * D + c8 + e] = tv[e];
        }
      }
      __syncthreads();
      accumulate_kv_block<D, MAXG>(qs, ks, vs, ss, ms, ls, as, acc, G, start, length, limit,
                                   window, scale, softcap);
    }
  }
  __syncthreads();

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tid + DC_THREADS * c;
      if (d >= D) continue;
      if (SPLIT) {
        acc_out[((((size_t)b * Hkv + h) * gridDim.x + s) * G + g) * D + d] = acc[g][c];
      } else {
        const float l = ls[g];
        out[((size_t)b * Hq + (size_t)h * G + g) * D + d] =
            acc[g][c] / (l == 0.f ? 1.f : l);
      }
    }
  }
  if (SPLIT && tid < G) {
    const size_t i = (((size_t)b * Hkv + h) * gridDim.x + s) * G + tid;
    m_out[i] = ms[tid];
    l_out[i] = ls[tid];
  }
}

template <int D, int MAXG, bool SPLIT>
int launch_f32(const void* q, const void* k, const void* v, const int* lengths, void* out,
               float* acc, float* m, float* l, int B, int Hkv, int G, long long stride_b,
               long long stride_h, int chunk, int num_chunks, int S, int cps, float scale,
               int window, float softcap, cudaStream_t stream) {
  const size_t smem = DecodeSmem<D, MAXG>::bytes;
  cudaError_t err = allow_smem(dense_decode_kernel<D, MAXG, SPLIT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S, Hkv, B);
  dense_decode_kernel<D, MAXG, SPLIT><<<grid, DC_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, static_cast<float*>(out), acc, m, l, Hkv, G,
      stride_b, stride_h, chunk, num_chunks, cps, scale, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return (int)err;
  combine_kernel<float, D><<<B * Hkv * G, DC_THREADS, 0, stream>>>(
      acc, m, l, static_cast<float*>(out), G, S);
  return (int)cudaGetLastError();
}

template <bool SPLIT>
int dispatch_f32(const void* q, const void* k, const void* v, const int* lengths, void* out,
                 float* acc, float* m, float* l, int B, int Hq, int Hkv, int D,
                 long long stride_b, long long stride_h, int chunk, int num_chunks, int S,
                 int cps, float scale, int window, float softcap, void* stream) {
  if (B <= 0) return 0;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DD_CASE(DIM, MG)                                                                   \
  return launch_f32<DIM, MG, SPLIT>(q, k, v, lengths, out, acc, m, l, B, Hkv, G, stride_b, \
                                    stride_h, chunk, num_chunks, S, cps, scale, window,    \
                                    softcap, st)
  if (D == 128 && G <= 8) DD_CASE(128, 8);
  if (D == 128 && G <= 32) DD_CASE(128, 32);
  if (D == 64 && G <= 8) DD_CASE(64, 8);
  if (D == 64 && G <= 32) DD_CASE(64, 32);
#undef DD_CASE
  return -1;
}

// -- bf16 on the tensor cores ------------------------------------------------------

namespace tc {

constexpr int BT = 64;               // stripe rows of a K / V tile
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

// MT m16 tiles of group rows (G <= 16 * MT). SPLIT = false: K7, grid (1, Hkv,
// B), walks positions [0, width). SPLIT = true: K8, grid (S, Hkv, B), split s
// walks positions [s * span, (s + 1) * span), and writes (acc, m, l).
template <int D, int MT, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
dense_decode_tc_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __nv_bfloat16* __restrict__ q, const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ acc_out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int G,
                       int width, int span, float scale, int window, float softcap) {
  using namespace hopper;
  using R = Ring<D>;
  constexpr int KS = CONSUMER_WARPS / MT;   // warps per m16 tile, taking tiles in turn
  constexpr int ROWS = 16 * MT;             // group rows, padded
  // Each stage then feeds one warp of each m16 tile, which waits on every
  // phase of it in turn: a parity wait never meets a phase two ahead.
  static_assert(R::STAGES % KS == 0, "a stage must belong to one warp per m16 tile");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BAR);
  uint64_t* empty = full + R::STAGES;

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int length = lengths[b];
  // The rows a valid position of this cell touches: [lo, hi).
  int lo = SPLIT ? s * span : 0;
  const int hi = min(min(lo + (SPLIT ? span : width), width), length);
  if (window > 0) lo = max(lo, length - window);
  const int ntiles = hi > lo ? (hi - lo + BT - 1) / BT : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < R::STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], MT);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == CONSUMER_WARPS) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % R::STAGES;
        mbar_wait(&empty[st], ((t / R::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * R::TILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem + R::K + st * R::TILE + c * BT * 128, &tk, &full[st], c * 64,
                      lo + t * BT, h, b);
          tma_load_4d(smem + R::V + st * R::TILE + c * BT * 128, &tv, &full[st], c * 64,
                      lo + t * BT, h, b);
        }
      }
    }
    return;
  }

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

  for (int t = ks; t < ntiles; t += KS) {
    const int st = t % R::STAGES;
    const uint32_t kbase = smem_u32(smem + R::K + st * R::TILE);
    const uint32_t vbase = smem_u32(smem + R::V + st * R::TILE);
    const int key0 = lo + t * BT;   // position of the tile's first key
    mbar_wait(&full[st], (t / R::STAGES) & 1);

    // S = q K^T: n8 tile n holds keys key0 + 8 n ...; one ldmatrix.x4 gives
    // the B fragments of two n8 tiles at one k16 step.
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

    // Scores in log2 units; a position past hi is masked to exactly
    // NEG_INF_F (no live score comes near it) and gets p = 0.
    float mx[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = softcap > 0.f ? softcap * tanhf(sc[n][i] * scale / softcap) * LOG2E
                                : sc[n][i] * scale2;
        x = key0 + 8 * n + c2 + (i & 1) < hi ? x : NEG_INF_F;
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

template <int D, int MT, bool SPLIT>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           float* acc, float* m, float* l, int B, int Hkv, int G, long long stride_b,
           long long stride_h, int width, int span, int S, float scale, int window,
           float softcap, cudaStream_t stream) {
  CUtensorMap tk, tv;
  int err = hopper::make_map_4d(&tk, k, D, width, Hkv, B, stride_h, stride_b, BT);
  if (err == 0) err = hopper::make_map_4d(&tv, v, D, width, Hkv, B, stride_h, stride_b, BT);
  if (err != 0) return err;
  const size_t smem = Ring<D>::bytes;
  const cudaError_t e = allow_smem(dense_decode_tc_kernel<D, MT, SPLIT>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(S, Hkv, B);
  dense_decode_tc_kernel<D, MT, SPLIT><<<grid, THREADS, smem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), lengths,
      static_cast<__nv_bfloat16*>(out), acc, m, l, Hkv, G, width, span, scale, window,
      softcap);
  cudaError_t err2 = cudaGetLastError();
  if (err2 != cudaSuccess || !SPLIT) return (int)err2;
  combine_kernel<__nv_bfloat16, D><<<B * Hkv * G, DC_THREADS, 0, stream>>>(
      acc, m, l, static_cast<__nv_bfloat16*>(out), G, S);
  return (int)cudaGetLastError();
}

template <bool SPLIT>
int dispatch(const void* q, const void* k, const void* v, const int* lengths, void* out,
             float* acc, float* m, float* l, int B, int Hq, int Hkv, int D,
             long long stride_b, long long stride_h, int chunk, int num_chunks, int S,
             int cps, float scale, int window, float softcap, void* stream) {
  if (B <= 0) return 0;
  const int G = Hq / Hkv;
  const int width = chunk * num_chunks;
  const int span = chunk * cps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DD_TC_CASE(DIM, MTILES)                                                            \
  return launch<DIM, MTILES, SPLIT>(q, k, v, lengths, out, acc, m, l, B, Hkv, G, stride_b, \
                                    stride_h, width, span, S, scale, window, softcap, st)
  if (D == 128 && G <= 16) DD_TC_CASE(128, 1);
  if (D == 128 && G <= 32) DD_TC_CASE(128, 2);
  if (D == 64 && G <= 16) DD_TC_CASE(64, 1);
  if (D == 64 && G <= 32) DD_TC_CASE(64, 2);
#undef DD_TC_CASE
  return -1;
}

}  // namespace tc

}  // namespace

// k / v: element (b, h, pos, d) at b * stride_b + h * stride_h + pos * D + d.
// Each entry returns a cudaError_t (0 = success), or -1 for a shape this
// build does not instantiate; the bf16 entries -2 if a tensor map could not
// be encoded (their strides must be multiples of 8 elements and the caches
// 16-byte aligned).

// float32 one pass (K7), on the CUDA cores.
extern "C" int dense_decode(const void* q, const void* k, const void* v, const int* lengths,
                            void* out, int B, int Hq, int Hkv, int D, long long stride_b,
                            long long stride_h, int chunk, int num_chunks, float scale,
                            int window, float softcap, void* stream) {
  return dispatch_f32<false>(q, k, v, lengths, out, nullptr, nullptr, nullptr, B, Hq, Hkv, D,
                             stride_b, stride_h, chunk, num_chunks, 1, num_chunks, scale,
                             window, softcap, stream);
}

// float32 split-K (K8), on the CUDA cores. acc: (B, Hkv, S, G, D), m / l:
// (B, Hkv, S, G) float32 scratch; split s walks chunks [s * chunks_per_split,
// min((s + 1) * chunks_per_split, num_chunks)).
extern "C" int dense_decode_split(const void* q, const void* k, const void* v,
                                  const int* lengths, void* out, float* acc, float* m,
                                  float* l, int B, int Hq, int Hkv, int D, long long stride_b,
                                  long long stride_h, int chunk, int num_chunks,
                                  int num_splits, int chunks_per_split, float scale,
                                  int window, float softcap, void* stream) {
  return dispatch_f32<true>(q, k, v, lengths, out, acc, m, l, B, Hq, Hkv, D, stride_b,
                            stride_h, chunk, num_chunks, num_splits, chunks_per_split, scale,
                            window, softcap, stream);
}

// bf16 one pass (K7), on the tensor cores.
extern "C" int dense_decode_tc(const void* q, const void* k, const void* v,
                               const int* lengths, void* out, int B, int Hq, int Hkv, int D,
                               long long stride_b, long long stride_h, int chunk,
                               int num_chunks, float scale, int window, float softcap,
                               void* stream) {
  return tc::dispatch<false>(q, k, v, lengths, out, nullptr, nullptr, nullptr, B, Hq, Hkv, D,
                             stride_b, stride_h, chunk, num_chunks, 1, num_chunks, scale,
                             window, softcap, stream);
}

// bf16 split-K (K8), on the tensor cores; scratch and ranges as
// dense_decode_split.
extern "C" int dense_decode_split_tc(const void* q, const void* k, const void* v,
                                     const int* lengths, void* out, float* acc, float* m,
                                     float* l, int B, int Hq, int Hkv, int D,
                                     long long stride_b, long long stride_h, int chunk,
                                     int num_chunks, int num_splits, int chunks_per_split,
                                     float scale, int window, float softcap, void* stream) {
  return tc::dispatch<true>(q, k, v, lengths, out, acc, m, l, B, Hq, Hkv, D, stride_b,
                            stride_h, chunk, num_chunks, num_splits, chunks_per_split, scale,
                            window, softcap, stream);
}
