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

// Sets the dynamic shared-memory limit of a kernel before its launch.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
