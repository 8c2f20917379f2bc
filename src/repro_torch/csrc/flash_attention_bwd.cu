// K5 (dQ) and K6 (dK, dV): FlashAttention-2 backward for Hopper (sm_90a).
//
// Replace the two Pallas kernels of flash_attention_bwd in the JAX package,
// src/repro/kernels/flash_attention_bwd.py: _dq_kernel (:65, launched at
// :228) and _dkv_kernel (:111, launched at :279). Inputs as K1's: q / dO
// (B, Hq, Sq, D) and k / v (B, Hkv, Skv, D) in float32 or bfloat16, the
// forward's lse (B, Hq, Sq) float32 and delta = rowsum(dO * O) (B, Hq, Sq)
// float32, computed in PyTorch by the wrapper as the JAX package computes it
// in XLA. Outputs dQ in q's type, dK / dV in k's type. p is recomputed from
// lse; with a softcap, dS takes the chain-rule factor 1 - (s_capped/cap)^2;
// rows with lse <= -1e30 / 2 (fully masked) and keys at or past kv_len
// contribute nothing.
//
// What bounds them on an H100: like the forward, these are bound by
// arithmetic at training shapes (K5 does 3 products of (64 x 64 x D) per
// tile pair, K6 4), far above the card's balance point. This first version
// computes on the CUDA cores in float32 with 4 x 4 register tiles fed from
// shared memory, in the layout of csrc/prefill_tile.cuh; tensor cores
// (wgmma), TMA and bf16 staging are later work.
//
// What the design does about the TPU's choices: the Pallas kernels carry
// dQ (and dK / dV) in VMEM scratch across a sequential grid axis; here that
// axis is a loop inside the block, so nothing crosses blocks. K6 sums the
// GQA group inside the block (one block per (b, kv head, kv tile) loops over
// the group's q heads), so no (B, Hq, Skv, D) partials are written and no
// atomics are used: gradients are the same from run to run. The
// MappingConfig order decodes blockIdx head-first (the tiles of one head
// consecutive, so blocks running together share K / V, or Q / dO, in L2)
// or block-first (heads fastest), the paper's choice for the backward pass.
// The order changes which blocks run together, never a block's sums.
#include "prefill_tile.cuh"

namespace {

using namespace rt;

constexpr int BM = PF_BM;          // q rows per tile
constexpr int BN = PF_BN;          // kv rows per tile
constexpr int THREADS = PF_THREADS;
constexpr float ROW_DEAD = NEG_INF_F * 0.5f;

template <int D>
struct BwdSmem {
  static constexpr int DP = D + 1;    // padded row of Q, dO, K, V
  static constexpr int PP = BN + 1;   // padded row of a P / dS tile
  // K5: Q, dO, K, V tiles + dS tile.
  static constexpr size_t dq_bytes =
      sizeof(float) * (size_t)(4 * BM * DP + BM * PP);
  // K6: K, V, Q, dO tiles + P^T and dS^T tiles + lse and delta of the q tile.
  static constexpr size_t dkv_bytes =
      sizeof(float) * (size_t)(4 * BM * DP + 2 * BN * PP + 2 * BM);
};

// Softcap, the p recomputation and dS for one (row, col) pair.
__device__ __forceinline__ float grad_score(float s_acc, float dp, float lse,
                                            float delta, bool ok, float scale,
                                            float softcap, float* p_out) {
  const float sc = apply_softcap(s_acc * scale, softcap);
  const float p = ok ? expf(sc - lse) : 0.f;
  float ds = p * (dp - delta);
  if (softcap > 0.f) {
    const float t = sc / softcap;
    ds *= 1.f - t * t;
  }
  *p_out = p;
  return ds;
}

// ---- K5: dQ -----------------------------------------------------------------
// One block per (b, q head, 64-row q tile); thread (ty, tx) owns q rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and dQ columns
// tx + 16 c (c < D / 16).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa2_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int kv_len,
              float scale, int causal, int window, float softcap, int order) {
  extern __shared__ float smem[];
  constexpr int DP = BwdSmem<D>::DP;
  constexpr int PP = BwdSmem<D>::PP;
  float* Qs = smem;
  float* dOs = Qs + BM * DP;
  float* Ks = dOs + BM * DP;
  float* Vs = Ks + BN * DP;
  float* dSs = Vs + BN * DP;

  const int nm = (Sq + BM - 1) / BM;
  const int per_b = Hq * nm;
  const int b = blockIdx.x / per_b;
  const int r = blockIdx.x - b * per_b;
  int h, mb;
  if (order == 0) {  // head-first: q tiles of one head are consecutive
    h = r / nm;
    mb = r - h * nm;
  } else {           // block-first: heads cycle fastest
    mb = r / Hq;
    h = r - mb * Hq;
  }
  const int hk = h / (Hq / Hkv);
  const size_t qoff = ((size_t)b * Hq + h) * (size_t)Sq;
  const T* kh = k + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const T* vh = v + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const int q0 = mb * BM;

  stage_rows<D, DP, T>(Qs, [&](int rr) -> const T* {
    return q0 + rr < Sq ? q + (qoff + q0 + rr) * D : nullptr;
  });
  stage_rows<D, DP, T>(dOs, [&](int rr) -> const T* {
    return q0 + rr < Sq ? dout + (qoff + q0 + rr) * D : nullptr;
  });

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float row_lse[4], row_delta[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < Sq ? lse[qoff + row] : NEG_INF_F;
    row_delta[i] = row < Sq ? delta[qoff + row] : 0.f;
    row_ok[i] = row < Sq && row_lse[i] > ROW_DEAD;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int live = min(Skv, kv_len);
  int n_hi = (live + BN - 1) / BN;
  if (causal) n_hi = min(n_hi, (q0 + BM + BN - 1) / BN);
  int n_lo = 0;
  if (window > 0) {
    const int edge = q0 - window + 1;
    n_lo = edge > 0 ? edge / BN : 0;
  }
  for (int n = n_lo; n < n_hi; ++n) {
    const int c0 = n * BN;
    __syncthreads();
    stage_rows<D, DP, T>(Ks, [&](int rr) -> const T* {
      return c0 + rr < Skv ? kh + (size_t)(c0 + rr) * D : nullptr;
    });
    stage_rows<D, DP, T>(Vs, [&](int rr) -> const T* {
      return c0 + rr < Skv ? vh + (size_t)(c0 + rr) * D : nullptr;
    });
    __syncthreads();

    // S = Q K^T and dP = dO V^T, both (64 x 64), in one sweep over D.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + kk];
        ov[i] = dOs[(ty + 16 * i) * DP + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + kk];
        vv[j] = Vs[(tx + 16 * j) * DP + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        bool ok = row_ok[i] && col < live;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        float p;
        dSs[(ty + 16 * i) * PP + tx + 16 * j] =
            grad_score(s[i][j], dp[i][j], row_lse[i], row_delta[i], ok, scale,
                       softcap, &p);
      }
    }
    __syncthreads();

    // dQ += dS K.
#pragma unroll 4
    for (int jj = 0; jj < BN; ++jj) {
      float dsv[4], kv[D / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * PP + jj];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) kv[c] = Ks[jj * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dqh = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      dqh[(size_t)row * D + tx + 16 * c] = from_f<T>(scale * acc[i][c]);
  }
}

// ---- K6: dK, dV ------------------------------------------------------------
// One block per (b, kv head, 64-row kv tile); thread (ty, tx) owns kv rows
// ty + 16 i (i < 4), q columns tx + 16 j of the transposed score tile and
// dK / dV columns tx + 16 c. The block loops over the group's q heads and,
// for each, the q tiles that causal, window and Sq leave live.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa2_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Sq,
               int Skv, int kv_len, float scale, int causal, int window,
               float softcap, int order) {
  extern __shared__ float smem[];
  constexpr int DP = BwdSmem<D>::DP;
  constexpr int PP = BwdSmem<D>::PP;
  float* Ks = smem;
  float* Vs = Ks + BN * DP;
  float* Qs = Vs + BN * DP;
  float* dOs = Qs + BM * DP;
  float* Pt = dOs + BM * DP;
  float* dSt = Pt + BN * PP;
  float* Ls = dSt + BN * PP;
  float* Ds = Ls + BM;

  const int nn = (Skv + BN - 1) / BN;
  const int per_b = Hkv * nn;
  const int b = blockIdx.x / per_b;
  const int r = blockIdx.x - b * per_b;
  int hk, nb;
  if (order == 0) {  // head-first: kv tiles of one kv head are consecutive
    hk = r / nn;
    nb = r - hk * nn;
  } else {           // block-first: kv heads cycle fastest
    nb = r / Hkv;
    hk = r - nb * Hkv;
  }
  const int group = Hq / Hkv;
  const size_t kvoff = ((size_t)b * Hkv + hk) * (size_t)Skv;
  const int c0 = nb * BN;
  const int live = min(Skv, kv_len);

  stage_rows<D, DP, T>(Ks, [&](int rr) -> const T* {
    return c0 + rr < Skv ? k + (kvoff + c0 + rr) * D : nullptr;
  });
  stage_rows<D, DP, T>(Vs, [&](int rr) -> const T* {
    return c0 + rr < Skv ? v + (kvoff + c0 + rr) * D : nullptr;
  });

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // Live q tiles of this kv tile: none past kv_len; causal rows >= c0;
  // window rows <= c0 + BN - 1 + window - 1.
  const int nm = (Sq + BM - 1) / BM;
  int m_lo = 0, m_hi = c0 < live ? nm : 0;
  if (causal) m_lo = c0 / BM;
  if (window > 0) m_hi = min(m_hi, (c0 + BN - 1 + window - 1) / BM + 1);

  for (int g = 0; g < group; ++g) {
    const size_t qoff = ((size_t)b * Hq + (size_t)hk * group + g) * (size_t)Sq;
    for (int mb = m_lo; mb < m_hi; ++mb) {
      const int q0 = mb * BM;
      __syncthreads();
      stage_rows<D, DP, T>(Qs, [&](int rr) -> const T* {
        return q0 + rr < Sq ? q + (qoff + q0 + rr) * D : nullptr;
      });
      stage_rows<D, DP, T>(dOs, [&](int rr) -> const T* {
        return q0 + rr < Sq ? dout + (qoff + q0 + rr) * D : nullptr;
      });
      if (threadIdx.x < BM) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < Sq ? lse[qoff + row] : NEG_INF_F;
        Ds[threadIdx.x] = row < Sq ? delta[qoff + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, both (64 kv x 64 q).
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D; ++kk) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * DP + kk];
          vv[i] = Vs[(ty + 16 * i) * DP + kk];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + kk];
          ov[j] = dOs[(tx + 16 * j) * DP + kk];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jl = tx + 16 * j;
          const int row = q0 + jl;
          const float l = Ls[jl];
          bool ok = row < Sq && l > ROW_DEAD && col < live;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          float p;
          dSt[(ty + 16 * i) * PP + jl] =
              grad_score(st[i][j], dpt[i][j], l, Ds[jl], ok, scale, softcap, &p);
          Pt[(ty + 16 * i) * PP + jl] = p;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q.
#pragma unroll 2
      for (int jj = 0; jj < BM; ++jj) {
        float pv[4], dsv[4], ov[D / 16], qv[D / 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(ty + 16 * i) * PP + jj];
          dsv[i] = dSt[(ty + 16 * i) * PP + jj];
        }
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          ov[c] = dOs[jj * DP + tx + 16 * c];
          qv[c] = Qs[jj * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < D / 16; ++c) {
            acc_v[i][c] = fmaf(pv[i], ov[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(dsv[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

  T* dkh = dk + kvoff * D;
  T* dvh = dv + kvoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c0 + ty + 16 * i;
    if (row >= Skv) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dkh[(size_t)row * D + tx + 16 * c] = from_f<T>(scale * acc_k[i][c]);
      dvh[(size_t)row * D + tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Skv, int kv_len, float scale, int causal,
              int window, float softcap, int order, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dq_bytes;
  cudaError_t err = allow_smem(fa2_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hq * ((Sq + BM - 1) / BM);
  if (blocks <= 0) return 0;
  fa2_dq_kernel<T, D><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Hq, Hkv, Sq,
      Skv, kv_len, scale, causal, window, softcap, order);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Skv, int kv_len, float scale,
               int causal, int window, float softcap, int order,
               cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dkv_bytes;
  cudaError_t err = allow_smem(fa2_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hkv * ((Skv + BN - 1) / BN);
  if (blocks <= 0) return 0;
  fa2_dkv_kernel<T, D><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), Hq, Hkv, Sq, Skv, kv_len, scale, causal, window,
      softcap, order);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 =
// success), or -1 for a head_dim / dtype this build does not instantiate.
extern "C" int fa2_bwd_dq(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta,
                          void* dq, int B, int Hq, int Hkv, int Sq, int Skv,
                          int kv_len, int D, float scale, int causal, int window,
                          float softcap, int order, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ_CASE(T, DIM)                                                          \
  return launch_dq<T, DIM>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv,   \
                           kv_len, scale, causal, window, softcap, order, s)
  if (dtype == 1) {
    if (D == 128) DQ_CASE(__nv_bfloat16, 128);
    if (D == 64) DQ_CASE(__nv_bfloat16, 64);
  } else if (dtype == 0) {
    if (D == 128) DQ_CASE(float, 128);
    if (D == 64) DQ_CASE(float, 64);
  }
#undef DQ_CASE
  return -1;
}

extern "C" int fa2_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse, const float* delta,
                           void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                           int Skv, int kv_len, int D, float scale, int causal,
                           int window, float softcap, int order, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV_CASE(T, DIM)                                                         \
  return launch_dkv<T, DIM>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq,   \
                            Skv, kv_len, scale, causal, window, softcap, order, s)
  if (dtype == 1) {
    if (D == 128) DKV_CASE(__nv_bfloat16, 128);
    if (D == 64) DKV_CASE(__nv_bfloat16, 64);
  } else if (dtype == 0) {
    if (D == 128) DKV_CASE(float, 128);
    if (D == 64) DKV_CASE(float, 64);
  }
#undef DKV_CASE
  return -1;
}
