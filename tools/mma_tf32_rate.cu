// The card's rate for mma.sync m16n8k8 TF32, the instruction K9
// (src/repro_torch/csrc/ssd.cu) issues three times per product in 3xTF32:
// the ceiling a kernel built on it can reach, below the data sheet's dense
// TF32 peak, which wgmma reaches.
//
// Build and run on a machine with a Hopper card and the CUDA toolkit:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_tf32_rate \
//        tools/mma_tf32_rate.cu && build/mma_tf32_rate
//
// Two blocks an SM (264 on an H100) of 4, 8 or 16 warps each run chains
// of independent mma.sync on register operands (no loads), 4 or 8 chains a
// warp; it prints TFLOP/s (2 x 16 x 8 x 8 operations an mma) and mma per
// SM per ns for each.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CHAINS>
__global__ void chains(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 0.001f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(threadIdx.x * 0.002f + i);
  float d[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma_tf32(d[j], a, b);
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;   // keeps the chains live
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out = nullptr;
  if (cudaMalloc(&out, 1 << 24) != cudaSuccess) return 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096, blocks = 2 * sms;
  for (int warps : {4, 8, 16}) {
    for (int n : {4, 8}) {
      auto run = [&]() {
        if (n == 4) chains<4><<<blocks, warps * 32>>>(out, iters);
        else chains<8><<<blocks, warps * 32>>>(out, iters);
      };
      run();
      cudaEventRecord(e0);
      run();
      cudaEventRecord(e1);
      if (cudaEventSynchronize(e1) != cudaSuccess) return 1;
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double mmas = (double)blocks * warps * iters * n;
      printf("mma.sync m16n8k8 tf32: %d blocks of %d warps, %d chains a warp: %.4f ms, "
             "%.1f TFLOP/s, %.3f mma per SM per ns\n",
             blocks, warps, n, ms, mmas * 2 * 16 * 8 * 8 / (ms * 1e9), mmas / sms / (ms * 1e6));
    }
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
