// K7 and K8: dense flash-decode for Hopper (sm_90a), one-pass and split-K.
//
// Replaces the Pallas bodies of the JAX package's
// src/repro/kernels/decode_attention.py: _decode_kernel (:59, launched by
// flash_decode :175) and _decode_split_kernel (:88, launched by
// _flash_decode_split :227), whose split states merge in
// kernels/decode_common.py:combine_split_states (:107). One query token per
// sequence, q (B, Hq, D), against a dense per-slot stripe k / v (B, Hkv,
// Smax, D) with lengths (B,). The walk goes in chunks of `chunk` positions
// (the plan's KV chunk); chunks no position of the row can see are skipped
// (chunk_relevant), so work follows the live length, not the capacity.
// Length-0 rows give exact zeros.
//
// What bounds it on an H100: decode reads every live K/V byte once and does
// 2 * group operations per element, far below the card's balance point, so
// it is bound by memory bandwidth, and, at small batch, by how few blocks
// there are to pull it: one block per (b, kv head) is 5 blocks for one
// hymba-1.5b sequence on a 132-SM card.
//
// What the design does about it: one block per (b, kv head) stages the
// stripe's contiguous rows DC_BT at a time with 16-byte loads and serves the
// whole GQA group from shared memory (the group is not padded to the TPU's
// 8 sublanes). Split-K (K8) multiplies the blocks by the split count over
// chunk-granular ranges from cache.layout.decode_split_ranges; each block
// writes float32 (acc, m, l) and decode_common.cuh's combine kernel, shared
// with K4, rescales the splits to the global max. The stripe may be a view
// cut to the live width: the kernel takes the batch and head strides, and
// the rows of one head are contiguous.
#include "decode_common.cuh"

namespace {

using namespace rt;

// SPLIT = false: K7, grid (1, Hkv, B), walks chunks [0, num_chunks) and
// writes the normalised row to `out`. SPLIT = true: K8, grid (S, Hkv, B),
// split s walks chunks [s * cps, min((s + 1) * cps, num_chunks)) and writes
// (acc, m, l).
template <typename T, int D, int MAXG, bool SPLIT>
__global__ void __launch_bounds__(DC_THREADS)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ acc_out,
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

template <int D, int MAXG, bool SPLIT, typename T>
int launch_decode(const void* q, const void* k, const void* v, const int* lengths, void* out,
                  float* acc, float* m, float* l, int B, int Hkv, int G, long long stride_b,
                  long long stride_h, int chunk, int num_chunks, int S, int cps, float scale,
                  int window, float softcap, cudaStream_t stream) {
  const size_t smem = DecodeSmem<D, MAXG>::bytes;
  cudaError_t err = allow_smem(dense_decode_kernel<T, D, MAXG, SPLIT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S, Hkv, B);
  dense_decode_kernel<T, D, MAXG, SPLIT><<<grid, DC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), acc, m, l, Hkv, G, stride_b, stride_h, chunk, num_chunks, cps,
      scale, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return (int)err;
  combine_kernel<T, D><<<B * Hkv * G, DC_THREADS, 0, stream>>>(acc, m, l,
                                                              static_cast<T*>(out), G, S);
  return (int)cudaGetLastError();
}

template <bool SPLIT>
int dispatch(const void* q, const void* k, const void* v, const int* lengths, void* out,
             float* acc, float* m, float* l, int B, int Hq, int Hkv, int D,
             long long stride_b, long long stride_h, int chunk, int num_chunks, int S,
             int cps, float scale, int window, float softcap, int dtype, void* stream) {
  if (B <= 0) return 0;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DD_CASE(DIM, MG, T)                                                               \
  return launch_decode<DIM, MG, SPLIT, T>(q, k, v, lengths, out, acc, m, l, B, Hkv, G,    \
                                          stride_b, stride_h, chunk, num_chunks, S, cps, \
                                          scale, window, softcap, st)
#define DD_DTYPE(DIM, MG)                          \
  if (dtype == 1) DD_CASE(DIM, MG, __nv_bfloat16); \
  if (dtype == 0) DD_CASE(DIM, MG, float);
  if (D == 128 && G <= 8) { DD_DTYPE(128, 8) }
  if (D == 128 && G <= 32) { DD_DTYPE(128, 32) }
  if (D == 64 && G <= 8) { DD_DTYPE(64, 8) }
  if (D == 64 && G <= 32) { DD_DTYPE(64, 32) }
#undef DD_DTYPE
#undef DD_CASE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. k / v: element (b, h, pos, d) at
// b * stride_b + h * stride_h + pos * D + d. Returns a cudaError_t
// (0 = success), or -1 for a shape / dtype this build does not instantiate.
extern "C" int dense_decode(const void* q, const void* k, const void* v, const int* lengths,
                            void* out, int B, int Hq, int Hkv, int D, long long stride_b,
                            long long stride_h, int chunk, int num_chunks, float scale,
                            int window, float softcap, int dtype, void* stream) {
  return dispatch<false>(q, k, v, lengths, out, nullptr, nullptr, nullptr, B, Hq, Hkv, D,
                         stride_b, stride_h, chunk, num_chunks, 1, num_chunks, scale, window,
                         softcap, dtype, stream);
}

// acc: (B, Hkv, S, G, D), m / l: (B, Hkv, S, G) float32 scratch; split s
// walks chunks [s * chunks_per_split, min((s + 1) * chunks_per_split,
// num_chunks)).
extern "C" int dense_decode_split(const void* q, const void* k, const void* v,
                                  const int* lengths, void* out, float* acc, float* m,
                                  float* l, int B, int Hq, int Hkv, int D, long long stride_b,
                                  long long stride_h, int chunk, int num_chunks,
                                  int num_splits, int chunks_per_split, float scale,
                                  int window, float softcap, int dtype, void* stream) {
  return dispatch<true>(q, k, v, lengths, out, acc, m, l, B, Hq, Hkv, D, stride_b, stride_h,
                        chunk, num_chunks, num_splits, chunks_per_split, scale, window,
                        softcap, dtype, stream);
}
