// The online-softmax step shared by the two prefill kernels (K1 dense
// FA2 forward, K2 paged prefix prefill).
//
// A block of 256 threads owns a tile of PF_BM = 64 query rows and sweeps
// key/value tiles of PF_BN = 64 columns staged in shared memory as float32.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i (i < 4), score
// columns tx + 16 j (j < 4) and output columns tx + 16 c (c < D / 16); the
// running (m, l) of a row is kept, identical, by the 16 threads of its
// half-warp and reduced with shuffles. Rows of K are padded to D + 1 floats
// so the 16 threads of a half-warp read 16 different banks.
//
// The Pallas kernels carried this state across a sequential grid axis in
// VMEM scratch; here the KV sweep is a loop inside the block.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int PF_BM = 64;
constexpr int PF_BN = 64;
constexpr int PF_THREADS = 256;

template <int D>
struct PrefillSmem {
  static constexpr int DP = D + 1;          // padded row of Q and K
  static constexpr int PP = PF_BN + 1;      // padded row of P
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(PF_BM * DP + PF_BN * DP + PF_BN * D + PF_BM * PP);
};

template <int D>
struct RowState {
  float acc[4][D / 16];
  float m[4];
  float l[4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = NEG_INF_F;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
    }
  }
};

// One KV tile, already in shared memory. valid(i, j) says whether local row
// ty + 16 i may attend local column tx + 16 j. Ends with P . V accumulated;
// the caller synchronises before overwriting Ks / Vs.
template <int D, typename Valid>
__device__ __forceinline__ void tile_step(const float* __restrict__ Qs,
                                          const float* __restrict__ Ks,
                                          const float* __restrict__ Vs,
                                          float* __restrict__ Ps, RowState<D>& st,
                                          float scale, float softcap, Valid valid) {
  constexpr int DP = PrefillSmem<D>::DP;
  constexpr int PP = PrefillSmem<D>::PP;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bool ok[4];
    float mx = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = valid(i, j);
      const float v = apply_softcap(s[i][j] * scale, softcap);
      s[i][j] = ok[j] ? v : NEG_INF_F;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[i], mx);
    const float alpha = expf(st.m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
      Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    st.l[i] = st.l[i] * alpha + sum;
    st.m[i] = m_new;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) st.acc[i][c] *= alpha;
  }
  __syncthreads();

#pragma unroll 4
  for (int jj = 0; jj < PF_BN; ++jj) {
    float pv[4], vv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + jj];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) vv[c] = Vs[jj * D + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) st.acc[i][c] = fmaf(pv[i], vv[c], st.acc[i][c]);
  }
}

// Stages rows [r0, r0 + 64) of one (S, D) matrix into padded shared memory;
// row r is read from src_row(r) (nullptr = zeros).
template <int D, int STRIDE, typename T, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, RowPtr src_row) {
  for (int idx = threadIdx.x; idx < PF_BN * (D / 8); idx += PF_THREADS) {
    const int r = idx / (D / 8);
    const int c8 = (idx - r * (D / 8)) * 8;
    float tmp[8];
    const T* src = src_row(r);
    if (src != nullptr) load8(src + c8, tmp); else zero8(tmp);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * STRIDE + c8 + e] = tmp[e];
  }
}

// stage_rows for a quantized pool's rows: row r's codes (src_row(r), nullptr
// = zeros) widen to float32 and are multiplied by scale_of(r), the scale of
// the (kv head, page) that holds it.
template <int D, int STRIDE, typename C, typename RowPtr, typename RowScale>
__device__ __forceinline__ void stage_rows_scaled(float* dst, RowPtr src_row,
                                                  RowScale scale_of) {
  for (int idx = threadIdx.x; idx < PF_BN * (D / 8); idx += PF_THREADS) {
    const int r = idx / (D / 8);
    const int c8 = (idx - r * (D / 8)) * 8;
    float tmp[8];
    const C* src = src_row(r);
    if (src != nullptr) {
      load8(src + c8, tmp);
      const float sc = scale_of(r);
#pragma unroll
      for (int e = 0; e < 8; ++e) tmp[e] *= sc;
    } else {
      zero8(tmp);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * STRIDE + c8 + e] = tmp[e];
  }
}

}  // namespace rt
