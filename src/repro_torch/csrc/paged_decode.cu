// K3 and K4: paged flash-decode for Hopper (sm_90a), one-pass and split-K,
// plus the split combine.
//
// Replaces the Pallas bodies of the JAX package's
// src/repro/kernels/paged_decode_attention.py: _paged_decode_kernel (:97,
// launched by paged_flash_decode :201) and _paged_decode_split_kernel (:143,
// launched by _paged_flash_decode_split :306), with the combine of
// kernels/decode_common.py:combine_split_states (:107). One query token per
// sequence, q (B, Hq, D), over the head-major pool (Hkv, P, page_size, D)
// through page_table (B, max_pages) and lengths (B,). Pages no position of
// the row can see are skipped (chunk_relevant); length-0 rows give exact
// zeros. The quantized-scale branch of the TPU kernels is not ported.
//
// What bounds it on an H100: decode reads every live K/V byte once and does
// 2 * group operations per element, far below the card's balance point, so
// it is bound by memory bandwidth — and, at small batch, by how few blocks
// there are to pull it: one block per (b, kv head) is 8 blocks for one
// llama3-8b sequence on a 132-SM card.
//
// What the design does about it: one block per (b, kv head) loads each live
// page once, with 16-byte loads, and serves the whole GQA group from shared
// memory (the group is not padded to the TPU's 8 sublanes). Split-K (K4)
// multiplies the blocks by the split count over page-granular ranges from
// cache.layout.decode_split_ranges, each block writing float32 (acc, m, l);
// a second small kernel (decode_common.cuh, shared with K8) rescales the
// splits to the global max.
#include "decode_common.cuh"

namespace {

using namespace rt;

// SPLIT = false: K3, grid (1, Hkv, B), writes the normalised row to `out`.
// SPLIT = true: K4, grid (S, Hkv, B), split s walks pages
// [s * pps, min((s + 1) * pps, mp)) and writes (acc, m, l).
template <typename T, int D, int MAXG, bool SPLIT>
__global__ void __launch_bounds__(DC_THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Hkv, int G, int P, int ps, int mp,
                    int pps, float scale, int window, float softcap) {
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
      if (pp < p_hi && chunk_relevant(pp * ps, ps, length, window)) {
        const size_t off = (((size_t)h * P + pt_row[pp]) * ps + (t - (t / ps) * ps)) * D + c8;
        load8(k_pages + off, tk);
        load8(v_pages + off, tv);
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

template <int D, int MAXG, bool SPLIT, typename T>
int launch_decode(const void* q, const void* kp, const void* vp, const int* pt,
                  const int* lengths, void* out, float* acc, float* m, float* l, int B,
                  int Hkv, int G, int P, int ps, int mp, int S, int pps, float scale,
                  int window, float softcap, cudaStream_t stream) {
  const size_t smem = DecodeSmem<D, MAXG>::bytes;
  cudaError_t err = allow_smem(paged_decode_kernel<T, D, MAXG, SPLIT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S, Hkv, B);
  paged_decode_kernel<T, D, MAXG, SPLIT><<<grid, DC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), pt,
      lengths, static_cast<T*>(out), acc, m, l, Hkv, G, P, ps, mp, pps, scale, window,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return (int)err;
  combine_kernel<T, D><<<B * Hkv * G, DC_THREADS, 0, stream>>>(acc, m, l,
                                                              static_cast<T*>(out), G, S);
  return (int)cudaGetLastError();
}

template <bool SPLIT>
int dispatch(const void* q, const void* kp, const void* vp, const int* pt,
             const int* lengths, void* out, float* acc, float* m, float* l, int B,
             int Hq, int Hkv, int P, int ps, int mp, int D, int S, int pps, float scale,
             int window, float softcap, int dtype, void* stream) {
  if (B <= 0) return 0;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEC_CASE(DIM, MG, T)                                                           \
  return launch_decode<DIM, MG, SPLIT, T>(q, kp, vp, pt, lengths, out, acc, m, l, B,  \
                                          Hkv, G, P, ps, mp, S, pps, scale, window,   \
                                          softcap, st)
#define DEC_DTYPE(DIM, MG)                    \
  if (dtype == 1) DEC_CASE(DIM, MG, __nv_bfloat16); \
  if (dtype == 0) DEC_CASE(DIM, MG, float);
  if (D == 128 && G <= 8) { DEC_DTYPE(128, 8) }
  if (D == 128 && G <= 32) { DEC_DTYPE(128, 32) }
  if (D == 64 && G <= 8) { DEC_DTYPE(64, 8) }
  if (D == 64 && G <= 32) { DEC_DTYPE(64, 32) }
#undef DEC_DTYPE
#undef DEC_CASE
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. page_size must divide 64. Returns a
// cudaError_t (0 = success), or -1 for a shape / dtype this build does not
// instantiate.
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const int* page_table, const int* lengths, void* out, int B,
                            int Hq, int Hkv, int P, int ps, int mp, int D, float scale,
                            int window, float softcap, int dtype, void* stream) {
  return dispatch<false>(q, k_pages, v_pages, page_table, lengths, out, nullptr, nullptr,
                         nullptr, B, Hq, Hkv, P, ps, mp, D, 1, mp, scale, window, softcap,
                         dtype, stream);
}

// acc: (B, Hkv, S, G, D), m / l: (B, Hkv, S, G) float32 scratch.
extern "C" int paged_decode_split(const void* q, const void* k_pages, const void* v_pages,
                                  const int* page_table, const int* lengths, void* out,
                                  float* acc, float* m, float* l, int B, int Hq, int Hkv,
                                  int P, int ps, int mp, int D, int num_splits,
                                  int pages_per_split, float scale, int window,
                                  float softcap, int dtype, void* stream) {
  return dispatch<true>(q, k_pages, v_pages, page_table, lengths, out, acc, m, l, B, Hq,
                        Hkv, P, ps, mp, D, num_splits, pages_per_split, scale, window,
                        softcap, dtype, stream);
}
