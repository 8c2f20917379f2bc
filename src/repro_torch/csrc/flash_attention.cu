// K1: FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the two Pallas bodies of flash_attention_fwd in the JAX package,
// src/repro/kernels/flash_attention.py: _fwd_resident_kernel (:220) and
// _fwd_stream_kernel (:145). q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D) ->
// o (B, Hq, Sq, D) in q's type and lse (B, Hq, Sq) float32. Causal,
// sliding-window, softcap and kv_len masks; GQA by h / (Hq / Hkv). A fully
// masked row gets o = 0 and lse = -1e30.
//
// Per-row query offsets (the dense extend and the paged extend's gather
// route; the JAX package runs these through XLA with ref.attention's
// q_offset): two optional (B,) int32 device arrays. Query row i of batch
// row b sits at position q_off[b] + i, and key j is live iff j < kv_lens[b],
// j <= q_off[b] + i (causal) and j > q_off[b] + i - window. A null q_off
// means offset 0, a null kv_lens the scalar kv_len. The offset moves only
// the block's KV tile range and the masks' row index: the unmasked score
// loop stays free of predicates.
//
// What bounds it on an H100: at the prefill shapes of the serving and
// training paths (S >= 512, D 64 or 128) attention does ~S/2 operations per
// byte, far above the card's balance point, so it is bound by arithmetic,
// and the bf16 tensor cores (989 TFLOP/s) are the only way to that bound.
// Two kernels:
//
// * fa2_fwd_tc_kernel, bf16 (every main path): warp-specialised. A block
//   owns 128 query rows of one (b, q head): warpgroups 0 and 1 consume 64
//   rows each, warpgroup 2 loads. One producer thread issues TMA loads of
//   the Q tile (once) and of 128-key K and V tiles (64-key at head_dim 256,
//   where shared memory and the consumers' registers run out) through a
//   two-stage ring in shared memory, so the next tile's copy overlaps this
//   tile's products. The consumers are prefill_tc.cuh's, shared with K2:
//   S = Q K^T and O += P V as wgmma (m64n128k16; at head_dim 256 m64n64k16
//   and m64n256k16) from 128-byte-swizzled shared memory,
//   the online softmax on S's registers (masks only on tiles that straddle
//   a boundary), P rounded to bf16 as the A-register fragment of P V,
//   setmaxnreg 240 / 24. Tensor maps are 3-D (D, S, B * H): a tile past S
//   is zero-filled by the hardware instead of reading the next head's rows,
//   and O leaves through shared memory by a TMA store that drops the rows
//   past Sq.
// * fa2_fwd_kernel, float32: the tensor cores take float32 only as TF32
//   (~3 decimal digits), so float32 stays on the CUDA cores in float32, with
//   4 x 4 register tiles over prefill_tile.cuh (shared with K2).
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
// triangular half of the work is never done. No order changes a block's
// arithmetic: head-first and block-first give the same bits.
#include "prefill_tc.cuh"
#include "prefill_tile.cuh"

namespace {

using namespace rt;

// -- float32 on the CUDA cores -------------------------------------------------

template <int D>
__global__ void __launch_bounds__(PF_THREADS)
fa2_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ q_off,
               const int* __restrict__ kv_lens, int Hq, int Hkv, int Sq, int Skv,
               int kv_len, float scale, int causal, int window, float softcap,
               int order, int sawtooth) {
  extern __shared__ float smem[];
  constexpr int DP = PrefillSmem<D>::DP;
  float* Qs = smem;
  float* Ks = Qs + PF_BM * DP;
  float* Vs = Ks + PF_BN * DP;
  float* Ps = Vs + PF_BN * D;

  int b, h, mb;
  decode_block((Sq + PF_BM - 1) / PF_BM, Hq, order, b, h, mb);
  const int hk = h / (Hq / Hkv);
  const float* qh = q + ((size_t)b * Hq + h) * (size_t)Sq * D;
  const float* kh = k + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const float* vh = v + ((size_t)b * Hkv + hk) * (size_t)Skv * D;
  const int q0 = mb * PF_BM;
  const int off = q_off ? q_off[b] : 0;
  const int kvl = kv_lens ? kv_lens[b] : kv_len;

  stage_rows<D, DP, float>(Qs, [&](int rr) -> const float* {
    return q0 + rr < Sq ? qh + (size_t)(q0 + rr) * D : nullptr;
  });

  RowState<D> st;
  st.init();
  int n_lo, n_hi;
  kv_tile_range(q0 + off, PF_BM, PF_BN, min(Skv, kvl), causal, window, n_lo, n_hi);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const bool reverse = sawtooth && (mb & 1);
  for (int t = 0; t < n_hi - n_lo; ++t) {
    const int n = reverse ? n_hi - 1 - t : n_lo + t;
    const int c0 = n * PF_BN;
    __syncthreads();
    stage_rows<D, DP, float>(Ks, [&](int rr) -> const float* {
      return c0 + rr < Skv ? kh + (size_t)(c0 + rr) * D : nullptr;
    });
    stage_rows<D, D, float>(Vs, [&](int rr) -> const float* {
      return c0 + rr < Skv ? vh + (size_t)(c0 + rr) * D : nullptr;
    });
    __syncthreads();
    tile_step<D>(Qs, Ks, Vs, Ps, st, scale, softcap, [&](int i, int j) {
      const int row = q0 + off + ty + 16 * i;
      const int col = c0 + tx + 16 * j;
      bool ok = col < kvl;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && col > row - window;
      return ok;
    });
  }

  float* oh = o + ((size_t)b * Hq + h) * (size_t)Sq * D;
  float* lh = lse + ((size_t)b * Hq + h) * (size_t)Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l = st.l[i];
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      oh[(size_t)row * D + tx + 16 * c] = st.acc[i][c] / l_safe;
    if (tx == 0) lh[row] = l == 0.f ? NEG_INF_F : st.m[i] + logf(l);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
               const int* q_off, const int* kv_lens, int B, int Hq, int Hkv, int Sq,
               int Skv, int kv_len, float scale, int causal, int window, float softcap,
               int order, int sawtooth, cudaStream_t stream) {
  const size_t smem = PrefillSmem<D>::bytes;
  cudaError_t err = allow_smem(fa2_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * Hq * ((Sq + PF_BM - 1) / PF_BM);
  if (blocks <= 0) return 0;
  fa2_fwd_kernel<D><<<(unsigned)blocks, PF_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, q_off, kv_lens, Hq, Hkv,
      Sq, Skv, kv_len, scale, causal, window, softcap, order, sawtooth);
  return (int)cudaGetLastError();
}

// -- bf16 on the tensor cores ----------------------------------------------------

namespace tc {

using ptc::BM;
using ptc::STAGES;
using ptc::THREADS;

// K1's KV tiles of BN keys: [n_lo, n_hi) of the dense K / V, walked
// backwards on odd q blocks under sawtooth; masks past kv_len, above the
// diagonal and before the window. Rows come in as the block's own (q0 + i)
// and sit at position off + q0 + i.
template <int BN>
struct DenseWalk {
  int n_lo, n_hi, live, causal, window, off;
  bool reverse;

  __device__ __forceinline__ int col0(int t) const {
    return (reverse ? n_hi - 1 - t : n_lo + t) * BN;
  }
  __device__ __forceinline__ bool edge(int, int c0, int row_lo) const {
    const int pos = row_lo + off;
    return c0 + BN > live || (causal && c0 + BN - 1 > pos) ||
           (window > 0 && c0 <= pos + 63 - window);
  }
  __device__ __forceinline__ bool ok(int, int row, int col) const {
    const int pos = row + off;
    bool ok = col < live;
    if (causal) ok = ok && col <= pos;
    if (window > 0) ok = ok && col > pos - window;
    return ok;
  }
};

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
fa2_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                  const int* __restrict__ q_off, const int* __restrict__ kv_lens, int Hq,
                  int Hkv, int Sq, int Skv, int kv_len, float scale, int causal, int window,
                  float softcap, int order, int sawtooth) {
  using namespace hopper;
  using L = ptc::Smem<D>;
  constexpr int BN = L::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptc::setup<D>(smem_raw);

  int b, h, mb;
  decode_block((Sq + BM - 1) / BM, Hq, order, b, h, mb);
  const int hk = h / (Hq / Hkv);
  const int q0 = mb * BM;
  const int off = q_off ? q_off[b] : 0;
  const int live = min(Skv, kv_lens ? kv_lens[b] : kv_len);
  int n_lo, n_hi;
  kv_tile_range(q0 + off, BM, BN, live, causal, window, n_lo, n_hi);
  const int ntiles = max(0, n_hi - n_lo);
  const DenseWalk<BN> walk{n_lo, n_hi, live, causal, window, off, sawtooth && (mb & 1)};

  // Producer: one thread keeps the ring full.
  auto produce = [&] {
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      uint64_t* full = ptc::full_bars<D>(smem);
      uint64_t* empty = ptc::empty_bars<D>(smem);
      uint64_t* qbar = ptc::q_bar<D>(smem);
      mbar_expect_tx(qbar, BM * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(smem + L::Q + c * BM * 128, &tq, qbar, c * 64, q0, b * Hq + h);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        const int row = walk.col0(t);
        mbar_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(smem + L::K + s * L::TILE + c * BN * 128, &tk, &full[s], c * 64, row,
                      b * Hkv + hk);
          tma_load_3d(smem + L::V + s * L::TILE + c * BN * 128, &tv, &full[s], c * 64, row,
                      b * Hkv + hk);
        }
      }
    }
  };
  auto consume = [&] {
    ptc::consume<D, SOFTCAP, true>(smem, walk, ntiles, q0, b * Hq + h, &to, lse, Sq, scale,
                                   softcap);
  };
  if constexpr (ptc::consumers_first<D>()) {
    if (threadIdx.x / 128 < 2) {
      consume();
      return;
    }
    produce();
  } else {
    if (threadIdx.x / 128 == 2)
      produce();
    else
      consume();
  }
}

template <int D, bool SOFTCAP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* q_off, const int* kv_lens, int B, int Hq, int Hkv, int Sq, int Skv,
           int kv_len, float scale, int causal, int window, float softcap, int order,
           int sawtooth, cudaStream_t stream) {
  const long long blocks = (long long)B * Hq * ((Sq + BM - 1) / BM);
  if (blocks <= 0) return 0;
  CUtensorMap tq, tk, tv, to;
  int err = hopper::make_map_3d(&tq, q, D, Sq, B * Hq, BM);
  if (err == 0) err = hopper::make_map_3d(&tk, k, D, Skv, B * Hkv, ptc::Smem<D>::BN);
  if (err == 0) err = hopper::make_map_3d(&tv, v, D, Skv, B * Hkv, ptc::Smem<D>::BN);
  if (err == 0) err = hopper::make_map_3d(&to, o, D, Sq, B * Hq, BM / 2);
  if (err != 0) return err;
  const size_t smem = ptc::Smem<D>::bytes;
  const cudaError_t e = allow_smem(fa2_fwd_tc_kernel<D, SOFTCAP>, smem);
  if (e != cudaSuccess) return (int)e;
  fa2_fwd_tc_kernel<D, SOFTCAP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      tq, tk, tv, to, lse, q_off, kv_lens, Hq, Hkv, Sq, Skv, kv_len, scale, causal, window,
      softcap, order, sawtooth);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// float32 q / k / v. q_off and kv_lens: (B,) int32 device arrays, or null
// (offset 0, the scalar kv_len). Returns a cudaError_t (0 = success), or -1
// for a head_dim this build does not instantiate.
extern "C" int fa2_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, const int* q_off, const int* kv_lens, int B, int Hq,
                       int Hkv, int Sq, int Skv, int kv_len, int D, float scale, int causal,
                       int window, float softcap, int order, int sawtooth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA2_CASE(DIM)                                                                  \
  return launch_f32<DIM>(q, k, v, o, lse, q_off, kv_lens, B, Hq, Hkv, Sq, Skv, kv_len, \
                         scale, causal, window, softcap, order, sawtooth, s)
  if (D == 128) FA2_CASE(128);
  if (D == 64) FA2_CASE(64);
#undef FA2_CASE
  return -1;
}

// bfloat16 q / k / v on the tensor cores, head_dim 64, 128 or 256; 16-byte
// aligned contiguous rows (the tensor maps' requirement); q_off and kv_lens
// as for fa2_fwd. Returns
// a cudaError_t (0 = success), -1 for a head_dim this build does not
// instantiate, -2 if a tensor map could not be encoded.
extern "C" int fa2_fwd_tc(const void* q, const void* k, const void* v, void* o,
                          float* lse, const int* q_off, const int* kv_lens, int B, int Hq,
                          int Hkv, int Sq, int Skv, int kv_len, int D, float scale,
                          int causal, int window, float softcap, int order, int sawtooth,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA2_TC_CASE(DIM, CAP)                                                            \
  return tc::launch<DIM, CAP>(q, k, v, o, lse, q_off, kv_lens, B, Hq, Hkv, Sq, Skv,      \
                              kv_len, scale, causal, window, softcap, order, sawtooth, s)
  const bool cap = softcap > 0.f;
  if (D == 128) {
    if (cap) FA2_TC_CASE(128, true);
    FA2_TC_CASE(128, false);
  }
  if (D == 64) {
    if (cap) FA2_TC_CASE(64, true);
    FA2_TC_CASE(64, false);
  }
  if (D == 256) {
    if (cap) FA2_TC_CASE(256, true);
    FA2_TC_CASE(256, false);
  }
#undef FA2_TC_CASE
  return -1;
}
