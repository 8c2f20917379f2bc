// K3 and K4: paged flash-decode for Hopper (sm_90a), one-pass and split-K,
// plus the split combine.
//
// Replaces the Pallas bodies of the JAX package's
// src/repro/kernels/paged_decode_attention.py: _paged_decode_kernel (:97,
// launched by paged_flash_decode :201) and _paged_decode_split_kernel (:143,
// launched by _paged_flash_decode_split :306), with the combine of
// kernels/decode_common.py:combine_split_states (:107). One query token per
// sequence, q (B, Hq, D), over the head-major pool (Hkv, P, page_size, D)
// through page_table (B, max_pages) and lengths (B,). Length-0 rows give
// exact zeros. Over a quantized pool (int8 or float8_e4m3fn codes with one
// float32 scale per (kv head, physical page) for K and V) they compute the
// scale branch of the TPU kernels (_paged_decode_kernel :122-134, the split
// body :180-191, decode_common.py:80-83's k * k_scale and v * v_scale).
//
// What bounds it on an H100: decode reads every live K/V byte once and does
// 2 * group operations per element, far below the card's balance point, so
// it is bound by memory bandwidth, and at small batch by how few blocks
// there are to pull it: one block per (b, kv head) is 8 blocks for one
// llama3-8b sequence on a 132-SM card. Split-K (K4) multiplies the blocks
// by the split count over page-granular ranges from
// cache.layout.decode_split_ranges, each block writing float32 (acc, m, l);
// a second small kernel (decode_common.cuh, shared with K8) rescales the
// splits to the global max.
//
// Three kernels:
//
// * paged_decode_tc_kernel, bf16 (every serve path over a bf16 pool). The
//   consumer is decode_tc.cuh's, the one K7/K8 run: four warps on the
//   tensor cores (mma.sync, q as A fragments, whole 64-row tiles in turn, P
//   in bf16) over a 128 KB ring on mbarriers. Its producer fills a stage
//   page by page: each pool (Hkv, P, ps, D) is one 3-D tensor map (Hkv, P *
//   ps, D) whose box is 64 columns by one page, 128-byte swizzled, and a
//   stage of 64 rows takes 64 / ps pages. The swizzle repeats every 8 rows
//   (1024 bytes), so with ps a multiple of 8 a page's box lands its bytes
//   where one 64-row box would put them, and the consumer addresses the
//   stage as K7/K8's. The block reads the pages of the rows a valid position
//   touches, [max(split start, length - window), min(split end, length)),
//   from the first one's page start; positions before the range are masked.
//   The producer warp's lanes each issue one box of a stage (ps 16, D 128:
//   16 boxes, K and V; two at ps 8, D 256), each reading its page id from
//   the table one stage ahead. At head_dim 256 the ring holds three
//   stages and the four warps share each tile, by 64-column chunks of D
//   (decode_tc.cuh's consume_d256). Every slot of every stage is written on every phase: a last
//   stage with fewer live pages loads the range's last live page again
//   into its surplus slots, which the consumer masks to P = 0 (an unwritten
//   slot could hold NaN bits, and 0 * NaN is NaN inside an mma; a page id
//   past the row's live pages is zero only by convention).
// * paged_decode_q_tc_kernel (head_dim 64 and 128) and
//   paged_decode_q_tc256_kernel, bf16 q over a quantized pool (every serve
//   path over an int8 or fp8 pool). The same walk and the same consumer,
//   fed codes: each pool of codes is one 3-D uint8 map whose box is a page
//   of whole D-byte rows, swizzled over the row (decode_tc.cuh's QRing:
//   twice the bf16 ring's stages in the same bytes; at head_dim 256 two
//   boxes a page, one a 128-byte half row). The producer lane of a page
//   also stores that page's scale into the stage's slots before its own
//   expect-tx arrival, whose release orders the store before the wait on
//   the stage. At head_dim 64 and 128 a consumer warp widens each code
//   stage into a bf16 tile of its own (exact; positions outside the range
//   zeroed by select) and releases the stage before P V. At head_dim 256
//   a producer warp loads three 32 KB code stages and a widening warpgroup
//   beside the four consumer warps widens each into one of two bf16 K
//   stages and a bf16 V stage, off the consumers' walk; the consumers read
//   those as they read the bf16 ring's (decode_tc.cuh's header comment:
//   the bytes and the barriers).
//   Either way the consumers fold the K scales into S's columns and the V
//   scales into P's (P V then takes the scaled P as two bf16 fragments,
//   its rounding and the remainder). What bounds it is no longer the
//   float32 work of the CUDA-core walk below but the bytes of the codes
//   and, on the card, the widening's integer instructions and the second
//   P V product (PERF.md).
// * paged_decode_kernel, float32 arithmetic on the CUDA cores, for two
//   inputs. A float32 pool: the tensor cores take float32 only as TF32
//   (~3 decimal digits). A quantized pool with float32 q (held at 2e-5),
//   and with bf16 q only when a caller asks for it
//   (paged_flash_decode_q_cuda_cores: the design the tensor-core kernel
//   replaced, kept to time one against the other). One block of DC_THREADS
//   stages DC_BT rows (whole pages), skips pages no position of the row can
//   see (chunk_relevant), widens each code to float32 and multiplies it by
//   its page's scale where it stages it (where the JAX kernel dequantizes,
//   so HBM streams 1-byte codes), and runs decode_common.cuh's
//   accumulate_kv_block (shared with the float32 K7 / K8). Positions no
//   query may see are staged as zeros by select, never loaded: rows frozen
//   on the null page write codes and scales there, which may be anything.
#include "decode_common.cuh"
#include "decode_tc.cuh"

namespace {

using namespace rt;

// -- float32 arithmetic on the CUDA cores (float32 q and pools; quantized pools) --

// T: q and out (float or bf16); C: the pool's elements (float for a
// float32 pool; int8_t or __nv_fp8_e4m3 codes for a quantized one, whose
// (Hkv, P) float32 scale tables ks_tab / vs_tab dequantize each staged row:
// code -> float, times the scale of (h, page)).
// SPLIT = false: K3, grid (1, Hkv, B), writes the normalised row to `out`.
// SPLIT = true: K4, grid (S, Hkv, B), split s walks pages
// [s * pps, min((s + 1) * pps, mp)) and writes (acc, m, l).
// A staged position no query may see (past the row's length, outside the
// window or the split) is written as zeros, never loaded: its page may be
// the null page, whose codes and scale are whatever rows frozen on it
// wrote, and P = 0 times a NaN is NaN.
template <typename T, typename C, int D, int MAXG, bool SPLIT>
__global__ void __launch_bounds__(DC_THREADS)
paged_decode_kernel(const T* __restrict__ q, const C* __restrict__ k_pages,
                    const C* __restrict__ v_pages, const float* __restrict__ ks_tab,
                    const float* __restrict__ vs_tab, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Hkv, int G, int P, int ps, int mp,
                    int pps, float scale, int window, float softcap) {
  constexpr bool QUANT = sizeof(C) == 1;
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
  const int p_lo = SPLIT ? s * pps : 0;
  const int p_hi = SPLIT ? min(p_lo + pps, mp) : mp;
  const int limit = p_hi * ps;

  const T* qrow = q + ((size_t)b * Hq + (size_t)h * G) * D;
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

  const int ppt = DC_BT / ps;  // pages per staged tile (ps divides DC_BT)
  const int* pt_row = page_table + (size_t)b * mp;
  for (int pg = p_lo; pg < p_hi; pg += ppt) {
    bool relevant = false;
    for (int pp = pg; pp < min(pg + ppt, p_hi); ++pp)
      relevant = relevant || chunk_relevant(pp * ps, ps, length, window);
    if (!relevant) continue;  // block-uniform: every thread agrees
    __syncthreads();
    for (int idx = tid; idx < DC_BT * (D / 8); idx += DC_THREADS) {
      const int t = idx / (D / 8);
      const int c8 = (idx - t * (D / 8)) * 8;
      const int pp = pg + t / ps;
      float tk[8], tv[8];
      if (pp < p_hi && pos_valid(pg * ps + t, length, limit, window)) {
        const int pid = pt_row[pp];
        const size_t off = (((size_t)h * P + pid) * ps + (t - (t / ps) * ps)) * D + c8;
        load8(k_pages + off, tk);
        load8(v_pages + off, tv);
        if (QUANT) {
          const float k_sc = ks_tab[(size_t)h * P + pid];
          const float v_sc = vs_tab[(size_t)h * P + pid];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            tk[e] *= k_sc;
            tv[e] *= v_sc;
          }
        }
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
    accumulate_kv_block<D, MAXG>(qs, ks, vs, ss, ms, ls, as, acc, G, pg * ps, length,
                                 limit, window, scale, softcap);
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
            from_f<T>(acc[g][c] / (l == 0.f ? 1.f : l));
      }
    }
  }
  if (SPLIT && tid < G) {
    const size_t i = (((size_t)b * Hkv + h) * gridDim.x + s) * G + tid;
    m_out[i] = ms[tid];
    l_out[i] = ls[tid];
  }
}

template <typename T, typename C, int D, int MAXG, bool SPLIT>
int launch_cc(const void* q, const void* kp, const void* vp, const float* ks_tab,
              const float* vs_tab, const int* pt, const int* lengths, void* out, float* acc,
              float* m, float* l, int B, int Hkv, int G, int P, int ps, int mp, int S, int pps,
              float scale, int window, float softcap, cudaStream_t stream) {
  const size_t smem = DecodeSmem<D, MAXG>::bytes;
  cudaError_t err = allow_smem(paged_decode_kernel<T, C, D, MAXG, SPLIT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S, Hkv, B);
  paged_decode_kernel<T, C, D, MAXG, SPLIT><<<grid, DC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(kp), static_cast<const C*>(vp), ks_tab,
      vs_tab, pt, lengths, static_cast<T*>(out), acc, m, l, Hkv, G, P, ps, mp, pps, scale,
      window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return (int)err;
  combine_kernel<T, D><<<B * Hkv * G, DC_THREADS, 0, stream>>>(
      acc, m, l, static_cast<T*>(out), G, S);
  return (int)cudaGetLastError();
}

template <typename T, typename C, bool SPLIT>
int dispatch_cc(const void* q, const void* kp, const void* vp, const float* ks_tab,
                const float* vs_tab, const int* pt, const int* lengths, void* out,
                float* acc, float* m, float* l, int B, int Hq, int Hkv, int P, int ps, int mp,
                int D, int S, int pps, float scale, int window, float softcap, void* stream) {
  if (B <= 0) return 0;
  if (ps <= 0 || DC_BT % ps != 0) return -1;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEC_CASE(DIM, MG)                                                                 \
  return launch_cc<T, C, DIM, MG, SPLIT>(q, kp, vp, ks_tab, vs_tab, pt, lengths, out, acc, \
                                         m, l, B, Hkv, G, P, ps, mp, S, pps, scale,        \
                                         window, softcap, st)
  if (D == 128 && G <= 8) DEC_CASE(128, 8);
  if (D == 128 && G <= 32) DEC_CASE(128, 32);
  if (D == 64 && G <= 8) DEC_CASE(64, 8);
  if (D == 64 && G <= 32) DEC_CASE(64, 32);
#undef DEC_CASE
  return -1;
}

// A quantized pool: q / out float32 (q_bf16 0) or bf16 (1), codes int8 (fp8
// 0) or float8_e4m3fn (1).
template <bool SPLIT>
int dispatch_q(const void* q, const void* kp, const void* vp, const float* ks_tab,
               const float* vs_tab, const int* pt, const int* lengths, void* out, float* acc,
               float* m, float* l, int B, int Hq, int Hkv, int P, int ps, int mp, int D, int S,
               int pps, int q_bf16, int fp8, float scale, int window, float softcap,
               void* stream) {
#define Q_CASE(T, C)                                                                       \
  return dispatch_cc<T, C, SPLIT>(q, kp, vp, ks_tab, vs_tab, pt, lengths, out, acc, m, l, B, \
                                  Hq, Hkv, P, ps, mp, D, S, pps, scale, window, softcap,   \
                                  stream)
  if (!q_bf16 && !fp8) Q_CASE(float, int8_t);
  if (!q_bf16 && fp8) Q_CASE(float, __nv_fp8_e4m3);
  if (q_bf16 && !fp8) Q_CASE(__nv_bfloat16, int8_t);
  Q_CASE(__nv_bfloat16, __nv_fp8_e4m3);
#undef Q_CASE
}

// -- bf16 on the tensor cores ------------------------------------------------------

namespace tc {

using dtc::BT;
using dtc::CONSUMER_WARPS;
using dtc::THREADS;
using dtc::Ring;

// The paged producer of decode_tc.cuh's consumer. SPLIT = false: K3, grid
// (1, Hkv, B), walks pages [0, mp). SPLIT = true: K4, grid (S, Hkv, B),
// split s walks pages [s * pps, min((s + 1) * pps, mp)) and writes (acc, m,
// l). ps is a multiple of 8 that divides BT.
template <int D, int MT, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
paged_decode_tc_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __nv_bfloat16* __restrict__ q, const int* __restrict__ page_table,
                       const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int Hkv, int G, int ps, int mp, int pps,
                       float scale, int window, float softcap) {
  using namespace hopper;
  using R = Ring<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = dtc::ring_base(smem_raw);

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int length = lengths[b];
  // The positions a valid query of this cell sees, [lo, hi), on pages
  // first_page .. last_page, 64 / ps pages a stage.
  const int p_lo = SPLIT ? s * pps : 0;
  const int p_hi = SPLIT ? min(p_lo + pps, mp) : mp;
  int lo = p_lo * ps;
  const int hi = min(p_hi * ps, length);
  if (window > 0) lo = max(lo, length - window);
  const int first_page = lo / ps;
  const int last_page = hi > lo ? (hi - 1) / ps : first_page;
  const int per_stage = BT / ps;
  const int ntiles = hi > lo ? (last_page - first_page + per_stage) / per_stage : 0;
  dtc::ring_init<D, MT>(smem);

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >> 5 == CONSUMER_WARPS) {
    // Producer: box j = lane + 32 r of each stage (r < LANE_BOXES: two at
    // ps 8, D 256) is (page i, column chunk c, K or V); boxes past
    // 2 * (D / 64) * per_stage are not issued.
    constexpr int LANE_BOXES = (2 * (D / 64) * (BT / 8) + 31) / 32;
    const int* table = page_table + (size_t)b * mp;
    uint64_t* full = dtc::full_bars<R>(smem);
    uint64_t* empty = dtc::empty_bars<R>(smem);
    // Page ids one stage ahead; a slot past the range's pages repeats its
    // last live page.
    int page[LANE_BOXES];
#pragma unroll
    for (int r = 0; r < LANE_BOXES; ++r) {
      const int i = ((lane + 32 * r) >> 1) / (D / 64);
      page[r] = i < per_stage && ntiles > 0 ? table[min(first_page + i, last_page)] : 0;
    }
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % R::STAGES;
      mbar_wait(&empty[st], ((t / R::STAGES) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(&full[st], 2 * R::TILE);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < LANE_BOXES; ++r) {
        const int j = lane + 32 * r;
        const int kv = j & 1;
        const int c = (j >> 1) % (D / 64);
        const int i = (j >> 1) / (D / 64);
        if (i >= per_stage) continue;
        tma_load_3d(smem + (kv ? R::V : R::K) + c * BT * 128 + i * ps * 128 + st * R::TILE,
                    kv ? &tv : &tk, &full[st], c * 64, page[r] * ps, h);
        if (t + 1 < ntiles)
          page[r] = table[min(first_page + (t + 1) * per_stage + i, last_page)];
      }
    }
    return;
  }
  dtc::consume<D, MT, SPLIT>(smem, q, out, acc_out, m_out, l_out, Hkv, G, first_page * ps, lo,
                             hi, ntiles, scale, softcap);
}

template <int D, int MT, bool SPLIT>
int launch(const void* q, const void* kp, const void* vp, const int* pt, const int* lengths,
           void* out, float* acc, float* m, float* l, int B, int Hkv, int G, int P, int ps,
           int mp, int S, int pps, float scale, int window, float softcap,
           cudaStream_t stream) {
  CUtensorMap tk, tv;
  int err = hopper::make_map_3d(&tk, kp, D, P * ps, Hkv, ps);
  if (err == 0) err = hopper::make_map_3d(&tv, vp, D, P * ps, Hkv, ps);
  if (err != 0) return err;
  const size_t smem = Ring<D>::bytes;
  const cudaError_t e = allow_smem(paged_decode_tc_kernel<D, MT, SPLIT>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(S, Hkv, B);
  paged_decode_tc_kernel<D, MT, SPLIT><<<grid, THREADS, smem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), pt, lengths,
      static_cast<__nv_bfloat16*>(out), acc, m, l, Hkv, G, ps, mp, pps, scale, window,
      softcap);
  cudaError_t err2 = cudaGetLastError();
  if (err2 != cudaSuccess || !SPLIT) return (int)err2;
  combine_kernel<__nv_bfloat16, D><<<B * Hkv * G, DC_THREADS, 0, stream>>>(
      acc, m, l, static_cast<__nv_bfloat16*>(out), G, S);
  return (int)cudaGetLastError();
}

template <bool SPLIT>
int dispatch(const void* q, const void* kp, const void* vp, const int* pt,
             const int* lengths, void* out, float* acc, float* m, float* l, int B, int Hq,
             int Hkv, int P, int ps, int mp, int D, int S, int pps, float scale, int window,
             float softcap, void* stream) {
  if (B <= 0) return 0;
  if (ps % 8 != 0 || BT % ps != 0) return -1;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PD_TC_CASE(DIM, MTILES)                                                              \
  return launch<DIM, MTILES, SPLIT>(q, kp, vp, pt, lengths, out, acc, m, l, B, Hkv, G, P, \
                                    ps, mp, S, pps, scale, window, softcap, st)
  if (D == 128 && G <= 16) PD_TC_CASE(128, 1);
  if (D == 128 && G <= 32) PD_TC_CASE(128, 2);
  if (D == 64 && G <= 16) PD_TC_CASE(64, 1);
  if (D == 64 && G <= 32) PD_TC_CASE(64, 2);
  if (D == 256 && G <= 16) PD_TC_CASE(256, 1);
  if (D == 256 && G <= 32) PD_TC_CASE(256, 2);
#undef PD_TC_CASE
  return -1;
}

// bf16 q over a quantized pool at head_dim 64 and 128: the paged producer
// of decode_tc.cuh's consumer over a QRing of codes. Each pool of codes
// (Hkv, P, ps, D) is one 3-D uint8 map (Hkv, P * ps, D) whose box is one
// page of D-byte rows; lane (page i, K or V) of the producer warp issues
// that page's box of each stage with its own expect-tx arrival (the full
// barrier counts 2 * 64 / ps of them), after it stores the page's scale
// into the stage's slots of the page's 8-key groups. Page ids come two
// stages ahead, scales one. Grid and ranges as paged_decode_tc_kernel's.
template <int D, int MT, bool SPLIT, class Code>
__global__ void __launch_bounds__(THREADS)
paged_decode_q_tc_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __nv_bfloat16* __restrict__ q, const float* __restrict__ ks_tab,
                         const float* __restrict__ vs_tab, const int* __restrict__ page_table,
                         const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ acc_out, float* __restrict__ m_out,
                         float* __restrict__ l_out, int Hkv, int G, int P, int ps, int mp,
                         int pps, float scale, int window, float softcap) {
  using namespace hopper;
  using R = dtc::QRing<D>;
  static_assert(D == 64 || D == 128, "head_dim 256 runs paged_decode_q_tc256_kernel");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = dtc::ring_base(smem_raw);

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int length = lengths[b];
  const int p_lo = SPLIT ? s * pps : 0;
  const int p_hi = SPLIT ? min(p_lo + pps, mp) : mp;
  int lo = p_lo * ps;
  const int hi = min(p_hi * ps, length);
  if (window > 0) lo = max(lo, length - window);
  const int first_page = lo / ps;
  const int last_page = hi > lo ? (hi - 1) / ps : first_page;
  const int per_stage = BT / ps;
  const int ntiles = hi > lo ? (last_page - first_page + per_stage) / per_stage : 0;
  dtc::bars_init(dtc::full_bars<R>(smem), dtc::empty_bars<R>(smem), R::STAGES, 2 * per_stage,
                 MT);

  if (threadIdx.x >> 5 == CONSUMER_WARPS) {
    const int lane = threadIdx.x & 31;
    const int kv = lane & 1;
    const int i = lane >> 1;
    if (i >= per_stage || ntiles == 0) return;
    const int* table = page_table + (size_t)b * mp;
    const float* tab = (kv ? vs_tab : ks_tab) + (size_t)h * P;
    uint64_t* full = dtc::full_bars<R>(smem);
    uint64_t* empty = dtc::empty_bars<R>(smem);
    uint8_t* dst = smem + (kv ? R::V : R::K) + i * ps * D;
    float* slots = dtc::q_scales<D>(smem) + kv * (BT / 8) + i * (ps / 8);
    const CUtensorMap* map = kv ? &tv : &tk;
    // This lane's page of stage t; a slot past the range's pages repeats
    // its last live page.
    auto page_of = [&](int t) { return table[min(first_page + t * per_stage + i, last_page)]; };
    int page = page_of(0);
    int next = ntiles > 1 ? page_of(1) : page;
    float sc = tab[page];
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % R::STAGES;
      mbar_wait(&empty[st], ((t / R::STAGES) & 1) ^ 1);
      for (int r = 0; r < ps / 8; ++r) slots[st * 2 * (BT / 8) + r] = sc;
      mbar_expect_tx(&full[st], ps * D);
      tma_load_3d(dst + st * R::TILE, map, &full[st], 0, page * ps, h);
      page = next;
      if (t + 1 < ntiles) sc = tab[page];
      if (t + 2 < ntiles) next = page_of(t + 2);
    }
    return;
  }
  dtc::CodeTiles<D, Code> tiles{smem, smem + R::OWN + (threadIdx.x >> 5) * R::OWN_TILE};
  dtc::consume_tiles<D, MT, SPLIT>(tiles, smem, q, out, acc_out, m_out, l_out, Hkv, G,
                                   first_page * ps, lo, hi, ntiles, scale, softcap);
}

// bf16 q over a quantized pool at head_dim 256 (decode_tc.cuh's header
// comment): a block of WIDE_THREADS, warps 0-3 the consumers (consume_d256
// over WideChunks), warps 4-7 the widening warpgroup, warp 8 the producer
// (warps 9-11 fill its warpgroup and leave). setmaxnreg raises the
// consumers to CONSUMER_REGS and lowers the producer's warpgroup to
// PRODUCER_REGS, the consumers' branch first (with it second, ptxas holds
// the consumers to the launch's share); the wideners keep the launch's
// share. A code row is two boxes of 128-byte half rows (TMA's 128-byte swizzle
// takes a box at most 128 bytes wide); producer lane (page i, K or V, half)
// issues that box of each code stage with its own expect-tx arrival (the
// full barrier counts 4 * 64 / ps of them: all 32 lanes at ps 8), after the
// lane of the first half stores the page's scale into the stage's slots of
// the page's 8-key groups; page ids come two stages ahead, scales one, and a
// slot past the range's pages repeats its last live page (the consumers
// mask it to P = 0, and its rows are widened to zeros). Tile t's codes sit
// in code stage t % STAGES, its bf16 K in stage t % KSTAGES and its V in t
// % VSTAGES; each ring's parity comes from its own depth. Grid and ranges as
// paged_decode_tc_kernel's. Where trouble lies, each named where it is
// handled below: blocks with no tile (length-0 rows, splits past a row's
// end, rows frozen on the null page at the full table width in the fused
// decode's graph), the rings' phases, the last stage's surplus slots, and
// ps 8's 32 boxes a stage.
template <int MT, bool SPLIT, class Code>
__global__ void __launch_bounds__(dtc::WIDE_THREADS, 1)
paged_decode_q_tc256_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __nv_bfloat16* __restrict__ q,
                            const float* __restrict__ ks_tab, const float* __restrict__ vs_tab,
                            const int* __restrict__ page_table, const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ acc_out,
                            float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int G,
                            int P, int ps, int mp, int pps, float scale, int window,
                            float softcap) {
  using namespace hopper;
  using R = dtc::QRing<256>;
  constexpr int ROW = 128;                          // a box's bytes a row: half a code row
  constexpr int WIDENERS = 32 * CONSUMER_WARPS;     // the widening warpgroup's threads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = dtc::ring_base(smem_raw);

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int length = lengths[b];
  const int p_lo = SPLIT ? s * pps : 0;
  const int p_hi = SPLIT ? min(p_lo + pps, mp) : mp;
  int lo = p_lo * ps;
  const int hi = min(p_hi * ps, length);
  if (window > 0) lo = max(lo, length - window);
  const int first_page = lo / ps;
  const int last_page = hi > lo ? (hi - 1) / ps : first_page;
  const int per_stage = BT / ps;
  const int ntiles = hi > lo ? (last_page - first_page + per_stage) / per_stage : 0;
  uint64_t* cfull = dtc::full_bars<R>(smem);
  uint64_t* cempty = dtc::empty_bars<R>(smem);
  const dtc::WideBars wb = dtc::wide_bars(smem);
  if (threadIdx.x == 0) {
    for (int st = 0; st < R::STAGES; ++st) {
      mbar_init(&cfull[st], 4 * per_stage);   // a box each
      mbar_init(&cempty[st], WIDENERS);
    }
    for (int st = 0; st < R::KSTAGES; ++st) {
      mbar_init(&wb.kfull[st], WIDENERS);
      mbar_init(&wb.kempty[st], CONSUMER_WARPS);
    }
    for (int st = 0; st < R::VSTAGES; ++st) {
      mbar_init(&wb.vfull[st], WIDENERS);
      mbar_init(&wb.vempty[st], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < CONSUMER_WARPS) {
    regs_alloc<R::CONSUMER_REGS>();
    dtc::WideChunks tiles{smem, wb};
    dtc::consume_d256<MT, SPLIT>(tiles, q, out, acc_out, m_out, l_out, Hkv, G, first_page * ps,
                                 lo, hi, ntiles, scale, softcap);
    return;
  }
  // No tile (a length-0 row, a split past the row's end, a frozen row):
  // nothing to load or widen, and nothing waits on the producer or the
  // wideners; the consumers, whose walk is empty, write the empty state.
  // The producer's warpgroup lowers its registers first, whatever it then
  // does: the consumers' setmaxnreg.inc waits for them.
  if (warp >= 2 * CONSUMER_WARPS) {
    regs_dealloc<R::PRODUCER_REGS>();
    // The producer: lane (i, kv, half) of warp 8. At ps 8 a stage holds 8
    // pages, 32 boxes, and every lane loads; at ps 64 four lanes do.
    const int kv = lane & 1;
    const int half = (lane >> 1) & 1;
    const int i = lane >> 2;
    if (warp != 2 * CONSUMER_WARPS || ntiles == 0 || i >= per_stage) return;
    const int* table = page_table + (size_t)b * mp;
    const float* tab = (kv ? vs_tab : ks_tab) + (size_t)h * P;
    uint8_t* dst = smem + (kv ? R::V : R::K) + half * BT * ROW + i * ps * ROW;
    float* slots = dtc::q_scales<256>(smem) + kv * (BT / 8) + i * (ps / 8);
    const CUtensorMap* map = kv ? &tv : &tk;
    // This lane's page of tile t; the last stage's surplus slots repeat the
    // range's last live page, so every slot is written on every phase.
    auto page_of = [&](int t) { return table[min(first_page + t * per_stage + i, last_page)]; };
    int page = page_of(0);
    int next = ntiles > 1 ? page_of(1) : page;
    float sc = tab[page];
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % R::STAGES;
      mbar_wait(&cempty[st], ((t / R::STAGES) & 1) ^ 1);
      if (half == 0)
        for (int r = 0; r < ps / 8; ++r) slots[st * 2 * (BT / 8) + r] = sc;
      mbar_expect_tx(&cfull[st], ps * ROW);
      tma_load_3d(dst + st * R::TILE, map, &cfull[st], half * ROW, page * ps, h);
      page = next;
      if (t + 1 < ntiles) sc = tab[page];
      if (t + 2 < ntiles) next = page_of(t + 2);
    }
    return;
  }
  if (ntiles == 0) return;

  // The widening of tile t by thread ct of warps 4-7 (column chunk ct / 32):
  // its codes from code stage t % STAGES (phase t / STAGES) into registers,
  // the code stage released, then K into bf16 K stage t % KSTAGES (free once
  // the consumers have read tile t - KSTAGES's scores) and V into bf16 V
  // stage t % VSTAGES (free once their P V of tile t - VSTAGES is done). Each
  // thread arrives on each barrier itself, after its own accesses, so the
  // four warps never wait for one another. Rows outside [lo, hi), the
  // surplus slots' and a frozen row's null page among them (e4m3 NaN bits),
  // widen to zeros by select; a tile all of whose rows are inside skips it.
  const int ct = threadIdx.x - WIDENERS;
  const int v = ct >> 5;
  const int first = first_page * ps;
  const unsigned live = (unsigned)(hi - lo);
  const float* cscales = dtc::q_scales<256>(smem);
  float* wscales = dtc::wide_scales(smem);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % R::STAGES;
    const int ks = t % R::KSTAGES;
    const int vs = t % R::VSTAGES;
    const int rel0 = first + t * BT - lo;
    const bool whole = (unsigned)rel0 < live && (unsigned)(rel0 + BT - 1) < live;
    mbar_wait(&cfull[st], (t / R::STAGES) & 1);
    dtc::CodeChunk kc, vc;
    kc.load(smem + R::K + st * R::TILE, v, lane);
    vc.load(smem + R::V + st * R::TILE, v, lane);
    const float tile_sc = ct < 2 * (BT / 8) ? cscales[st * 2 * (BT / 8) + ct] : 0.f;
    // This thread read TMA-written codes with ordinary loads, and TMA
    // rewrites the stage once it is released: the proxy fence first.
    fence_async_smem();
    mbar_arrive(&cempty[st]);
    mbar_wait(&wb.kempty[ks], ((t / R::KSTAGES) & 1) ^ 1);
    uint8_t* wk = smem + R::WK + ks * R::WTILE + v * BT * 128;
    if (whole)
      kc.widen<Code, true>(wk, rel0, live, lane);
    else
      kc.widen<Code, false>(wk, rel0, live, lane);
    if (ct < 2 * (BT / 8)) wscales[ks * 2 * (BT / 8) + ct] = tile_sc;
    mbar_arrive(&wb.kfull[ks]);
    mbar_wait(&wb.vempty[vs], ((t / R::VSTAGES) & 1) ^ 1);
    uint8_t* wv = smem + R::WV + vs * R::WTILE + v * BT * 128;
    if (whole)
      vc.widen<Code, true>(wv, rel0, live, lane);
    else
      vc.widen<Code, false>(wv, rel0, live, lane);
    mbar_arrive(&wb.vfull[vs]);
  }
}

// The quantized kernel of head_dim D.
template <int D, int MT, bool SPLIT, class Code>
constexpr auto q_tc_kernel() {
  if constexpr (D == 256)
    return paged_decode_q_tc256_kernel<MT, SPLIT, Code>;
  else
    return paged_decode_q_tc_kernel<D, MT, SPLIT, Code>;
}

template <int D, int MT, bool SPLIT, class Code>
int launch_q(const void* q, const void* kc, const void* vc, const float* ks_tab,
             const float* vs_tab, const int* pt, const int* lengths, void* out, float* acc,
             float* m, float* l, int B, int Hkv, int G, int P, int ps, int mp, int S, int pps,
             float scale, int window, float softcap, cudaStream_t stream) {
  CUtensorMap tk, tv;
  int err = hopper::make_map_3d_u8(&tk, kc, D, P * ps, Hkv, ps);
  if (err == 0) err = hopper::make_map_3d_u8(&tv, vc, D, P * ps, Hkv, ps);
  if (err != 0) return err;
  const auto kernel = q_tc_kernel<D, MT, SPLIT, Code>();
  const int threads = D == 256 ? dtc::WIDE_THREADS : THREADS;
  if constexpr (D == 256) {
    // setmaxnreg.inc waits until the registers it asks for are free: a
    // launch share too small for the three warpgroups' sum (the wideners
    // keep the share) would hang the consumers, so refuse it.
    using R = dtc::QRing<256>;
    static const int regs = [&] {
      cudaFuncAttributes a;
      return cudaFuncGetAttributes(&a, kernel) == cudaSuccess ? a.numRegs : 0;
    }();
    if (2 * regs < R::CONSUMER_REGS + R::PRODUCER_REGS) return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = dtc::QRing<D>::bytes;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(S, Hkv, B);
  kernel<<<grid, threads, smem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), ks_tab, vs_tab, pt, lengths,
      static_cast<__nv_bfloat16*>(out), acc, m, l, Hkv, G, P, ps, mp, pps, scale, window,
      softcap);
  cudaError_t err2 = cudaGetLastError();
  if (err2 != cudaSuccess || !SPLIT) return (int)err2;
  combine_kernel<__nv_bfloat16, D><<<B * Hkv * G, DC_THREADS, 0, stream>>>(
      acc, m, l, static_cast<__nv_bfloat16*>(out), G, S);
  return (int)cudaGetLastError();
}

// codes int8 (fp8 0) or float8_e4m3fn (1).
template <bool SPLIT>
int dispatch_codes(const void* q, const void* kc, const void* vc, const float* ks_tab,
                   const float* vs_tab, const int* pt, const int* lengths, void* out,
                   float* acc, float* m, float* l, int B, int Hq, int Hkv, int P, int ps,
                   int mp, int D, int S, int pps, int fp8, float scale, int window,
                   float softcap, void* stream) {
  if (B <= 0) return 0;
  if (ps % 8 != 0 || BT % ps != 0) return -1;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PDQ_TC_CASE(DIM, MTILES)                                                            \
  return fp8 ? launch_q<DIM, MTILES, SPLIT, dtc::E4m3Codes>(                                \
                   q, kc, vc, ks_tab, vs_tab, pt, lengths, out, acc, m, l, B, Hkv, G, P, ps, \
                   mp, S, pps, scale, window, softcap, st)                                   \
             : launch_q<DIM, MTILES, SPLIT, dtc::Int8Codes>(                                 \
                   q, kc, vc, ks_tab, vs_tab, pt, lengths, out, acc, m, l, B, Hkv, G, P, ps, \
                   mp, S, pps, scale, window, softcap, st)
  if (D == 128 && G <= 16) PDQ_TC_CASE(128, 1);
  if (D == 128 && G <= 32) PDQ_TC_CASE(128, 2);
  if (D == 64 && G <= 16) PDQ_TC_CASE(64, 1);
  if (D == 64 && G <= 32) PDQ_TC_CASE(64, 2);
  if (D == 256 && G <= 16) PDQ_TC_CASE(256, 1);
  if (D == 256 && G <= 32) PDQ_TC_CASE(256, 2);
#undef PDQ_TC_CASE
  return -1;
}

}  // namespace tc

}  // namespace

// Each entry returns a cudaError_t (0 = success), or -1 for a shape this
// build does not instantiate; the tensor-core entries -2 if a tensor map
// could not be encoded. page_size must divide 64 (the CUDA-core entries),
// and be a multiple of 8 that divides 64 (the tensor-core entries). Split
// scratch: acc (B, Hkv, S, G, D), m / l (B, Hkv, S, G) float32; split s
// walks pages [s * pages_per_split, min((s + 1) * pages_per_split, mp)).

// float32 one pass (K3), on the CUDA cores.
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const int* page_table, const int* lengths, void* out, int B,
                            int Hq, int Hkv, int P, int ps, int mp, int D, float scale,
                            int window, float softcap, void* stream) {
  return dispatch_cc<float, float, false>(q, k_pages, v_pages, nullptr, nullptr, page_table,
                                         lengths, out, nullptr, nullptr, nullptr, B, Hq, Hkv,
                                         P, ps, mp, D, 1, mp, scale, window, softcap, stream);
}

// float32 split-K (K4), on the CUDA cores.
extern "C" int paged_decode_split(const void* q, const void* k_pages, const void* v_pages,
                                  const int* page_table, const int* lengths, void* out,
                                  float* acc, float* m, float* l, int B, int Hq, int Hkv,
                                  int P, int ps, int mp, int D, int num_splits,
                                  int pages_per_split, float scale, int window,
                                  float softcap, void* stream) {
  return dispatch_cc<float, float, true>(q, k_pages, v_pages, nullptr, nullptr, page_table,
                                        lengths, out, acc, m, l, B, Hq, Hkv, P, ps, mp, D,
                                        num_splits, pages_per_split, scale, window, softcap,
                                        stream);
}

// bf16 one pass (K3), on the tensor cores.
extern "C" int paged_decode_tc(const void* q, const void* k_pages, const void* v_pages,
                               const int* page_table, const int* lengths, void* out, int B,
                               int Hq, int Hkv, int P, int ps, int mp, int D, float scale,
                               int window, float softcap, void* stream) {
  return tc::dispatch<false>(q, k_pages, v_pages, page_table, lengths, out, nullptr, nullptr,
                             nullptr, B, Hq, Hkv, P, ps, mp, D, 1, mp, scale, window,
                             softcap, stream);
}

// bf16 split-K (K4), on the tensor cores.
extern "C" int paged_decode_split_tc(const void* q, const void* k_pages, const void* v_pages,
                                     const int* page_table, const int* lengths, void* out,
                                     float* acc, float* m, float* l, int B, int Hq, int Hkv,
                                     int P, int ps, int mp, int D, int num_splits,
                                     int pages_per_split, float scale, int window,
                                     float softcap, void* stream) {
  return tc::dispatch<true>(q, k_pages, v_pages, page_table, lengths, out, acc, m, l, B, Hq,
                            Hkv, P, ps, mp, D, num_splits, pages_per_split, scale, window,
                            softcap, stream);
}

// A quantized pool (K3): q / out float32 or bf16 (q_bf16), int8 or
// float8_e4m3fn codes (fp8) with (Hkv, P) float32 scale tables, on the CUDA
// cores.
extern "C" int paged_decode_q(const void* q, const void* k_codes, const void* v_codes,
                              const float* k_scale_tab, const float* v_scale_tab,
                              const int* page_table, const int* lengths, void* out, int B,
                              int Hq, int Hkv, int P, int ps, int mp, int D, int q_bf16,
                              int fp8, float scale, int window, float softcap, void* stream) {
  return dispatch_q<false>(q, k_codes, v_codes, k_scale_tab, v_scale_tab, page_table, lengths,
                           out, nullptr, nullptr, nullptr, B, Hq, Hkv, P, ps, mp, D, 1, mp,
                           q_bf16, fp8, scale, window, softcap, stream);
}

// A quantized pool, split-K (K4) and the combine.
extern "C" int paged_decode_split_q(const void* q, const void* k_codes, const void* v_codes,
                                    const float* k_scale_tab, const float* v_scale_tab,
                                    const int* page_table, const int* lengths, void* out,
                                    float* acc, float* m, float* l, int B, int Hq, int Hkv,
                                    int P, int ps, int mp, int D, int num_splits,
                                    int pages_per_split, int q_bf16, int fp8, float scale,
                                    int window, float softcap, void* stream) {
  return dispatch_q<true>(q, k_codes, v_codes, k_scale_tab, v_scale_tab, page_table, lengths,
                          out, acc, m, l, B, Hq, Hkv, P, ps, mp, D, num_splits,
                          pages_per_split, q_bf16, fp8, scale, window, softcap, stream);
}

// bf16 q over a quantized pool (K3), on the tensor cores: int8 or
// float8_e4m3fn codes (fp8) with (Hkv, P) float32 scale tables.
extern "C" int paged_decode_q_tc(const void* q, const void* k_codes, const void* v_codes,
                                 const float* k_scale_tab, const float* v_scale_tab,
                                 const int* page_table, const int* lengths, void* out, int B,
                                 int Hq, int Hkv, int P, int ps, int mp, int D, int fp8,
                                 float scale, int window, float softcap, void* stream) {
  return tc::dispatch_codes<false>(q, k_codes, v_codes, k_scale_tab, v_scale_tab,
                                   page_table, lengths, out, nullptr, nullptr, nullptr, B, Hq,
                                   Hkv, P, ps, mp, D, 1, mp, fp8, scale, window, softcap,
                                   stream);
}

// bf16 q over a quantized pool, split-K (K4) and the combine, on the tensor
// cores.
extern "C" int paged_decode_split_q_tc(const void* q, const void* k_codes, const void* v_codes,
                                       const float* k_scale_tab, const float* v_scale_tab,
                                       const int* page_table, const int* lengths, void* out,
                                       float* acc, float* m, float* l, int B, int Hq, int Hkv,
                                       int P, int ps, int mp, int D, int num_splits,
                                       int pages_per_split, int fp8, float scale, int window,
                                       float softcap, void* stream) {
  return tc::dispatch_codes<true>(q, k_codes, v_codes, k_scale_tab, v_scale_tab, page_table,
                                  lengths, out, acc, m, l, B, Hq, Hkv, P, ps, mp, D,
                                  num_splits, pages_per_split, fp8, scale, window, softcap,
                                  stream);
}
