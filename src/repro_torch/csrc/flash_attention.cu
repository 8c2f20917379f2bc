// K1: FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the two Pallas bodies of flash_attention_fwd in the JAX package,
// src/repro/kernels/flash_attention.py: _fwd_resident_kernel (:220) and
// _fwd_stream_kernel (:145). q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D) in
// float32 or bfloat16 -> o (B, Hq, Sq, D) in q's type and lse (B, Hq, Sq)
// float32. Causal, sliding-window, softcap and kv_len masks; GQA by
// h / (Hq / Hkv). A fully masked row gets o = 0 and lse = -1e30.
//
// What bounds it on an H100: at the prefill shapes of the serving path
// (S >= 512, D = 128) attention does ~S/2 operations per byte, far above the
// card's balance point, so it is bound by arithmetic. This first version
// computes on the CUDA cores in float32 (the JAX kernels' precision) with
// 4 x 4 register tiles fed from shared memory; tensor cores (wgmma) and TMA
// are later work.
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
// triangular half of the work is never done.
#include "prefill_tile.cuh"

namespace {

using namespace rt;

template <typename T, int D>
__global__ void __launch_bounds__(PF_THREADS)
fa2_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
               int kv_len, float scale, int causal, int window, float softcap,
               int order, int sawtooth) {
  extern __shared__ float smem[];
  constexpr int DP = PrefillSmem<D>::DP;
  float* Qs = smem;
  float* Ks = Qs + PF_BM * DP;
  float* Vs = Ks + PF_BN * DP;
  float* Ps = Vs + PF_BN * D;

  const int nm = (Sq + PF_BM - 1) / PF_BM;
  const int per_b = Hq * nm;
  const int b = blockIdx.x / per_b;
  const int r = blockIdx.x - b * per_b;
  int h, mb;
  if (order == 0) {  // head-first: q blocks of one head are consecutive
    h = r / nm;
    mb = r - h * nm;
  } else {           // block-first: heads cycle fastest
    mb = r / Hq;
    h = r - mb * Hq;
  }
  const int hk = h / (Hq / Hkv);
  const T* qh = q + ((size_t)b * Hq + h) * (size_t)Sq * D;
  const T* kh = k + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const int q0 = mb * PF_BM;

  stage_rows<D, DP, T>(Qs, [&](int rr) -> const T* {
    return q0 + rr < Sq ? qh + (size_t)(q0 + rr) * D : nullptr;
  });

  RowState<D> st;
  st.init();
  const int live = min(Skv, kv_len);
  int n_hi = (live + PF_BN - 1) / PF_BN;
  if (causal) n_hi = min(n_hi, (q0 + PF_BM + PF_BN - 1) / PF_BN);
  int n_lo = 0;
  if (window > 0) {
    const int edge = q0 - window + 1;
    n_lo = edge > 0 ? edge / PF_BN : 0;
  }
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const bool reverse = sawtooth && (mb & 1);
  for (int t = 0; t < n_hi - n_lo; ++t) {
    const int n = reverse ? n_hi - 1 - t : n_lo + t;
    const int c0 = n * PF_BN;
    __syncthreads();
    stage_rows<D, DP, T>(Ks, [&](int rr) -> const T* {
      return c0 + rr < Skv ? kh + (size_t)(c0 + rr) * D : nullptr;
    });
    stage_rows<D, D, T>(Vs, [&](int rr) -> const T* {
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

  T* oh = o + ((size_t)b * Hq + h) * (size_t)Sq * D;
  float* lh = lse + ((size_t)b * Hq + h) * (size_t)Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l = st.l[i];
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      oh[(size_t)row * D + tx + 16 * c] = from_f<T>(st.acc[i][c] / l_safe);
    if (tx == 0) lh[row] = l == 0.f ? NEG_INF_F : st.m[i] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int Sq, int Skv, int kv_len, float scale,
           int causal, int window, float softcap, int order, int sawtooth,
           cudaStream_t stream) {
  const size_t smem = PrefillSmem<D>::bytes;
  cudaError_t err = allow_smem(fa2_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hq * ((Sq + PF_BM - 1) / PF_BM);
  if (blocks <= 0) return 0;
  fa2_fwd_kernel<T, D><<<(unsigned)blocks, PF_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Hq, Hkv, Sq, Skv, kv_len, scale, causal, window,
      softcap, order, sawtooth);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success),
// or -1 for a head_dim / dtype this build does not instantiate.
extern "C" int fa2_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                       int kv_len, int D, float scale, int causal, int window,
                       float softcap, int order, int sawtooth, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA2_CASE(T, DIM)                                                         \
  return launch<T, DIM>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, kv_len, scale,     \
                        causal, window, softcap, order, sawtooth, s)
  if (dtype == 1) {
    if (D == 128) FA2_CASE(__nv_bfloat16, 128);
    if (D == 64) FA2_CASE(__nv_bfloat16, 64);
  } else if (dtype == 0) {
    if (D == 128) FA2_CASE(float, 128);
    if (D == 64) FA2_CASE(float, 64);
  }
#undef FA2_CASE
  return -1;
}
