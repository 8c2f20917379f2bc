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
//   swizzled) into a ring of 128 KB (8 stages at D 64, 4 at D 128; at D
//   256 3 stages, 192 KB, where the four warps share each tile by 64-column
//   chunks of D) on mbarriers, as far ahead as the ring allows. The block reads only the
//   rows a valid position touches: [max(split start, length - window),
//   min(split end, length)), in 64-row tiles from its first row, so a
//   window-1024 layer reads ~1024 rows, not the stripe. The four consumer
//   warps are decode_tc.cuh's, shared with K3/K4: mma.sync m16n8k16 with q
//   as A fragments, whole tiles in turn (four tiles in the products at
//   once: one tile at a time, all warps on key slices of it, kept a block
//   at half the rate, measured), an online softmax in registers, P in bf16
//   for P V, one mbarrier arrival per released stage and one merge at the
//   end. K7 writes the normalised bf16 row; K8 writes float32 (acc, m, l)
//   (m in natural units), merged by decode_common.cuh's combine kernel,
//   shared with K4.
// * dense_decode_kernel, float32: the tensor cores take float32 only as
//   TF32 (~3 decimal digits), so float32 stays on the CUDA cores over
//   decode_common.cuh's accumulate_kv_block (shared with the float32 K3 /
//   K4), staging DC_BT rows at a time with 16-byte loads and skipping chunks
//   no position of the row can see (chunk_relevant).
#include "decode_common.cuh"
#include "decode_tc.cuh"

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

using dtc::BT;
using dtc::CONSUMER_WARPS;
using dtc::THREADS;
using dtc::Ring;

// The producer of decode_tc.cuh's consumer for a stripe: one thread issues
// one 4-D box of BT rows per column chunk of K and of V. SPLIT = false: K7,
// grid (1, Hkv, B), walks positions [0, width). SPLIT = true: K8, grid (S,
// Hkv, B), split s walks positions [s * span, (s + 1) * span), and writes
// (acc, m, l).
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
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = dtc::ring_base(smem_raw);

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int length = lengths[b];
  // The rows a valid position of this cell touches: [lo, hi).
  int lo = SPLIT ? s * span : 0;
  const int hi = min(min(lo + (SPLIT ? span : width), width), length);
  if (window > 0) lo = max(lo, length - window);
  const int ntiles = hi > lo ? (hi - lo + BT - 1) / BT : 0;
  dtc::ring_init<D, MT>(smem);

  if (threadIdx.x >> 5 == CONSUMER_WARPS) {
    // Producer: one thread keeps the ring full.
    if ((threadIdx.x & 31) == 0) {
      uint64_t* full = dtc::full_bars<R>(smem);
      uint64_t* empty = dtc::empty_bars<R>(smem);
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
  // The tiles start at lo itself: the consumer's lower mask never fires.
  dtc::consume<D, MT, SPLIT>(smem, q, out, acc_out, m_out, l_out, Hkv, G, lo, lo, hi, ntiles,
                             scale, softcap);
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
  if (D == 256 && G <= 16) DD_TC_CASE(256, 1);
  if (D == 256 && G <= 32) DD_TC_CASE(256, 2);
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
