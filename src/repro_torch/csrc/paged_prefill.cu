// K2: paged prefix-extension prefill for Hopper (sm_90a).
//
// Replaces the Pallas body _paged_prefill_kernel of paged_flash_prefill in
// the JAX package, src/repro/kernels/paged_prefill_attention.py (:66,
// :176). Tail queries q (B, Hq, St, D) sit at absolute positions
// prefix_len[b] + i. Each attends to the live prefix read straight from the
// head-major page pool (Hkv, P, page_size, D) through page_table (B, mp),
// then causally to the dense tail k / v (B, Hkv, St, D), in one online
// softmax. Rows at or past tail_len[b] give exact zeros; prefix_len need not
// be a page multiple; a table of width 0 means no prefix; window and
// softcap as in K1.
//
// What bounds it on an H100: a 256-token tail over a 1000-token prefix does
// ~64 operations per byte of prefix K/V per q head, times the GQA group,
// so it is bound by arithmetic, like K1 (CUDA cores in float32 here).
//
// What the design does about the TPU's choices: the Pallas kernel folds the
// whole GQA group and padded tail into one q block of group * St rows; at
// llama3-8b with a 512-token tail that is a 2048 x 128 float32 accumulator,
// which no SM holds. Here the folded rows are tiled 64 at a time, and folded
// position-major (row = i * group + g), so one row tile holds every q head
// of the group for 64 / group tail positions: each prefix page is read once
// per (b, kv head, row tile) and serves all q heads of the group, never once
// per q head. The page table is read by the block itself (no scalar
// prefetch on a GPU).
#include "prefill_tile.cuh"

namespace {

using namespace rt;

template <typename T, int D>
__global__ void __launch_bounds__(PF_THREADS)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages, const int* __restrict__ page_table,
                     const T* __restrict__ k_tail, const T* __restrict__ v_tail,
                     const int* __restrict__ prefix_len,
                     const int* __restrict__ tail_len, T* __restrict__ o, int Hq,
                     int Hkv, int St, int P, int ps, int mp, float scale,
                     int window, float softcap) {
  extern __shared__ float smem[];
  constexpr int DP = PrefillSmem<D>::DP;
  float* Qs = smem;
  float* Ks = Qs + PF_BM * DP;
  float* Vs = Ks + PF_BN * DP;
  float* Ps = Vs + PF_BN * D;

  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int rows = G * St;          // folded (position, head) rows
  const int R0 = blockIdx.x * PF_BM;
  const int plen = prefix_len[b];
  const int tlen = tail_len[b];
  const size_t q_head0 = (size_t)b * Hq + (size_t)hk * G;

  stage_rows<D, DP, T>(Qs, [&](int rr) -> const T* {
    const int R = R0 + rr;
    if (R >= rows) return nullptr;
    const int i = R / G;
    return q + ((q_head0 + (R - i * G)) * St + i) * D;
  });

  RowState<D> st;
  st.init();
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int i_lo = R0 / G;                                   // first tail row
  const int i_hi = min((R0 + PF_BM - 1) / G, St - 1);        // last tail row

  // Phase A: the live prefix, page-table-indirected.
  const int pref = min(plen, mp * ps);
  int a_lo = 0;
  if (window > 0) {
    const int edge = plen + i_lo - window + 1;
    a_lo = edge > 0 ? edge / PF_BN : 0;
  }
  const int* pt_row = page_table + (size_t)b * mp;
  for (int n = a_lo; n < (pref + PF_BN - 1) / PF_BN; ++n) {
    const int c0 = n * PF_BN;
    __syncthreads();
    auto page_row = [&](const T* pool, int rr) -> const T* {
      const int c = c0 + rr;
      if (c >= pref) return nullptr;
      const int page = c / ps;
      const int pid = pt_row[page];
      return pool + (((size_t)hk * P + pid) * ps + (c - page * ps)) * D;
    };
    stage_rows<D, DP, T>(Ks, [&](int rr) { return page_row(k_pages, rr); });
    stage_rows<D, D, T>(Vs, [&](int rr) { return page_row(v_pages, rr); });
    __syncthreads();
    tile_step<D>(Qs, Ks, Vs, Ps, st, scale, softcap, [&](int ii, int jj) {
      const int R = R0 + ty + 16 * ii;
      const int i = R / G;
      const int c = c0 + tx + 16 * jj;
      bool ok = R < rows && i < tlen && c < plen;
      if (window > 0) ok = ok && c > plen + i - window;
      return ok;
    });
  }

  // Phase B: the dense tail, causal in tail-local positions.
  const int last_col = min(i_hi, tlen - 1);
  int b_lo = 0;
  if (window > 0) {
    const int edge = i_lo - window + 1;
    b_lo = edge > 0 ? edge / PF_BN : 0;
  }
  const size_t tail_head = ((size_t)b * Hkv + hk) * (size_t)St * D;
  for (int n = b_lo; n <= (last_col >= 0 ? last_col / PF_BN : -1); ++n) {
    const int c0 = n * PF_BN;
    __syncthreads();
    stage_rows<D, DP, T>(Ks, [&](int rr) -> const T* {
      return c0 + rr < St ? k_tail + tail_head + (size_t)(c0 + rr) * D : nullptr;
    });
    stage_rows<D, D, T>(Vs, [&](int rr) -> const T* {
      return c0 + rr < St ? v_tail + tail_head + (size_t)(c0 + rr) * D : nullptr;
    });
    __syncthreads();
    tile_step<D>(Qs, Ks, Vs, Ps, st, scale, softcap, [&](int ii, int jj) {
      const int R = R0 + ty + 16 * ii;
      const int i = R / G;
      const int c = c0 + tx + 16 * jj;
      bool ok = R < rows && i < tlen && c <= i;
      if (window > 0) ok = ok && c > i - window;
      return ok;
    });
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int R = R0 + ty + 16 * ii;
    if (R >= rows) continue;
    const int i = R / G;
    const float l = st.l[ii];
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = o + ((q_head0 + (R - i * G)) * St + i) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) orow[tx + 16 * c] = from_f<T>(st.acc[ii][c] / l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* pt,
           const void* kt, const void* vt, const int* plen, const int* tlen,
           void* o, int B, int Hq, int Hkv, int St, int P, int ps, int mp,
           float scale, int window, float softcap, cudaStream_t stream) {
  const size_t smem = PrefillSmem<D>::bytes;
  cudaError_t err = allow_smem(paged_prefill_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Hq / Hkv) * St + PF_BM - 1) / PF_BM;
  if (B <= 0 || tiles <= 0) return 0;
  dim3 grid(tiles, Hkv, B);
  paged_prefill_kernel<T, D><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      pt, static_cast<const T*>(kt), static_cast<const T*>(vt), plen, tlen,
      static_cast<T*>(o), Hq, Hkv, St, P, ps, mp, scale, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success),
// or -1 for a head_dim / dtype this build does not instantiate.
extern "C" int paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                             const int* page_table, const void* k_tail,
                             const void* v_tail, const int* prefix_len,
                             const int* tail_len, void* o, int B, int Hq, int Hkv,
                             int St, int P, int ps, int mp, int D, float scale,
                             int window, float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PP_CASE(T, DIM)                                                              \
  return launch<T, DIM>(q, k_pages, v_pages, page_table, k_tail, v_tail, prefix_len, \
                        tail_len, o, B, Hq, Hkv, St, P, ps, mp, scale, window,       \
                        softcap, s)
  if (dtype == 1) {
    if (D == 128) PP_CASE(__nv_bfloat16, 128);
    if (D == 64) PP_CASE(__nv_bfloat16, 64);
  } else if (dtype == 0) {
    if (D == 128) PP_CASE(float, 128);
    if (D == 64) PP_CASE(float, 64);
  }
#undef PP_CASE
  return -1;
}
