// Shared decode arithmetic of the float32 decode kernels on the CUDA cores
// (paged K3 one-pass, K4 split-K, dense K7 one-pass, K8 split-K), and the
// split combine that every K4 and K8 launch runs: the CUDA form of
// repro_torch/kernels/decode_common.py, itself the port of the JAX
// package's src/repro/kernels/decode_common.py (chunk_relevant :36,
// accumulate_kv_block :54, combine_split_states :107). The bf16 kernels'
// consumer is decode_tc.cuh.
//
// A decode block of DC_THREADS threads serves one (b, kv head[, split])
// cell: the whole GQA group of G query rows rides in the block, so every
// KV row is loaded once and used by all G heads. KV is staged DC_BT
// positions at a time (whole pages, or a stripe's contiguous rows).
#pragma once

#include "common.cuh"

namespace rt {

constexpr int DC_THREADS = 128;
constexpr int DC_BT = 64;

// True iff the unit [start, start + len) holds a position valid for a decode
// row of `length` live tokens: pos < length and, under a sliding window W,
// pos > length - 1 - W. Exact, so a skipped unit never held a live key.
__device__ __forceinline__ bool chunk_relevant(int start, int len, int length, int window) {
  bool relevant = start < length;
  if (window > 0) relevant = relevant && (start + len - 1 >= length - window);
  return relevant;
}

__device__ __forceinline__ bool pos_valid(int pos, int length, int limit, int window) {
  bool ok = pos < length && pos < limit;
  if (window > 0) ok = ok && pos > length - 1 - window;
  return ok;
}

template <int D>
struct DecodeCols {
  static constexpr int CPT = (D + DC_THREADS - 1) / DC_THREADS;  // columns per thread
};

// Dynamic shared memory of a decode block: q (MAXG x D), K (DC_BT x (D + 1),
// padded against bank conflicts), V (DC_BT x D), scores (MAXG x DC_BT), and
// the running max, normaliser and rescale per row.
template <int D, int MAXG>
struct DecodeSmem {
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(MAXG * D + DC_BT * (D + 1) + DC_BT * D + MAXG * DC_BT + 3 * MAXG);
};

// One online-softmax step over DC_BT staged positions starting at
// block_start. qs: G x D; ks: DC_BT x (D + 1); vs: DC_BT x D; ss: scratch
// MAXG x DC_BT; ms / ls / as: running max, normaliser and this step's
// rescale per row, in shared memory. Positions at or past `limit` belong to
// another split and are masked like positions past `length`.
template <int D, int MAXG>
__device__ __forceinline__ void accumulate_kv_block(
    const float* __restrict__ qs, const float* __restrict__ ks,
    const float* __restrict__ vs, float* __restrict__ ss, float* ms, float* ls,
    float* as, float (&acc)[MAXG][DecodeCols<D>::CPT], int G, int block_start,
    int length, int limit, int window, float scale, float softcap) {
  constexpr int DP = D + 1;
  constexpr int CPT = DecodeCols<D>::CPT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < G * DC_BT; idx += DC_THREADS) {
    const int g = idx / DC_BT;
    const int t = idx - g * DC_BT;
    const float* qr = qs + g * D;
    const float* kr = ks + t * DP;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < D; ++k) s = fmaf(qr[k], kr[k], s);
    ss[idx] = pos_valid(block_start + t, length, limit, window)
                  ? apply_softcap(s * scale, softcap)
                  : NEG_INF_F;
  }
  __syncthreads();

  for (int g = warp; g < G; g += DC_THREADS / 32) {
    const float m_prev = ms[g];
    const bool oka = pos_valid(block_start + lane, length, limit, window);
    const bool okb = pos_valid(block_start + lane + 32, length, limit, window);
    const float a = ss[g * DC_BT + lane];
    const float c = ss[g * DC_BT + lane + 32];
    float mx = fmaxf(a, c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_prev, mx);
    const float pa = oka ? expf(a - m_new) : 0.f;
    const float pc = okb ? expf(c - m_new) : 0.f;
    ss[g * DC_BT + lane] = pa;
    ss[g * DC_BT + lane + 32] = pc;
    float sum = pa + pc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncwarp();
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      ls[g] = ls[g] * alpha + sum;
      ms[g] = m_new;
      as[g] = alpha;
    }
  }
  __syncthreads();

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    const float alpha = as[g];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tid + DC_THREADS * c;
      if (d >= D) continue;
      float sum = acc[g][c] * alpha;
#pragma unroll 8
      for (int t = 0; t < DC_BT; ++t) sum = fmaf(ss[g * DC_BT + t], vs[t * D + d], sum);
      acc[g][c] = sum;
    }
  }
}

// Merge S split states of one (row, column): sum_s exp(m_s - m*) acc_s over
// sum_s exp(m_s - m*) l_s. Empty splits carry (0, NEG_INF, 0) and vanish; a
// row with no live split gives exact zeros.
__device__ __forceinline__ float combine_split_states(const float* acc, int acc_stride,
                                                      const float* m, const float* l,
                                                      int ml_stride, int S) {
  float m_star = NEG_INF_F;
  for (int s = 0; s < S; ++s) m_star = fmaxf(m_star, m[s * ml_stride]);
  float l_star = 0.f, a_star = 0.f;
  for (int s = 0; s < S; ++s) {
    const float alpha = expf(m[s * ml_stride] - m_star);
    l_star += l[s * ml_stride] * alpha;
    a_star += acc[s * acc_stride] * alpha;
  }
  return a_star / (l_star == 0.f ? 1.f : l_star);
}

// The split combine, one block per (b, kv head, group row): out row =
// combine over the S splits of acc (B, Hkv, S, G, D), m / l (B, Hkv, S, G).
template <typename T, int D>
__global__ void __launch_bounds__(DC_THREADS)
combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
               const float* __restrict__ l, T* __restrict__ out, int G, int S) {
  const int row = blockIdx.x;        // (b * Hkv + h) * G + g
  const int g = row % G;
  const int cell = row / G;          // b * Hkv + h
  const float* mr = m + (size_t)cell * S * G + g;
  const float* lr = l + (size_t)cell * S * G + g;
  for (int d = threadIdx.x; d < D; d += DC_THREADS) {
    const float* ar = acc + ((size_t)cell * S * G + g) * D + d;
    out[(size_t)row * D + d] = from_f<T>(combine_split_states(ar, G * D, mr, lr, G, S));
  }
}

}  // namespace rt
