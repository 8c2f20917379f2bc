// Shared helpers for the Hopper attention kernels of repro_torch.
//
// Element types: every kernel reads float32 or bfloat16 and computes in
// float32, the precision the JAX package's kernels compute in.
// NEG_INF_F is the large-but-finite mask value of the JAX package
// (kernels/ref.py NEG_INF): fully masked rows stay NaN-free because
// exp(NEG_INF - NEG_INF) == 1 and exp(NEG_INF - x) == 0 for finite x.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)

namespace rt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive elements from a 16-byte aligned address, widened to
// float32: one 16-byte load for bf16, two for float32.
__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void zero8(float* dst) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = 0.f;
}

__device__ __forceinline__ float apply_softcap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// blockIdx.x -> (b, h, tile) for a grid of B x H x n tiles under the
// MappingConfig order: head-first (order 0) makes the n tiles of one head
// consecutive, so blocks running at the same time share that head's
// operands in L2; block-first (order 1) cycles the heads fastest.
__device__ __forceinline__ void decode_block(int n, int H, int order, int& b, int& h,
                                             int& tile) {
  const int per_b = H * n;
  b = blockIdx.x / per_b;
  const int r = blockIdx.x - b * per_b;
  if (order == 0) {
    h = r / n;
    tile = r - h * n;
  } else {
    tile = r / H;
    h = r - tile * H;
  }
}

// The KV tiles [n_lo, n_hi) of width bn that query rows [q0, q0 + bm) can
// see: none at or past `live`, causal keys up to the last row, window keys
// past the first row's edge.
__device__ __forceinline__ void kv_tile_range(int q0, int bm, int bn, int live, int causal,
                                              int window, int& n_lo, int& n_hi) {
  n_hi = (live + bn - 1) / bn;
  if (causal) n_hi = min(n_hi, (q0 + bm + bn - 1) / bn);
  n_lo = 0;
  if (window > 0) {
    const int edge = q0 - window + 1;
    n_lo = edge > 0 ? edge / bn : 0;
  }
}

// Sets the dynamic shared-memory limit of a kernel before its launch.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
