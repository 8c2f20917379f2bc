// K2: paged prefix-extension prefill for Hopper (sm_90a).
//
// Replaces the Pallas body _paged_prefill_kernel of paged_flash_prefill in
// the JAX package, src/repro/kernels/paged_prefill_attention.py (:66,
// pallas_call :277). Tail queries q (B, Hq, St, D) sit at absolute
// positions prefix_len[b] + i. Each attends to the live prefix read
// straight from the head-major page pool (Hkv, P, page_size, D) through
// page_table (B, mp), then causally to the dense tail k / v (B, Hkv, St,
// D), in one online softmax. Rows at or past tail_len[b] give exact zeros;
// prefix_len need not be a page multiple; a table of width 0 means no
// prefix; window and softcap as in K1.
//
// What bounds it on an H100: a 256-token tail over a 1000-token prefix does
// ~64 operations per byte of prefix K/V per q head, times the GQA group,
// so it is bound by arithmetic, like K1, and the bf16 tensor cores are the
// only way to that bound. Two kernels:
//
// * paged_prefill_tc_kernel, bf16 (every prefix-hit prefill): K1's block on
//   the tensor cores (prefill_tc.cuh: two consumer warpgroups of 64 rows
//   over 128 query rows of one (b, q head), wgmma m64n128k16 for S and for
//   P V, P in bf16, setmaxnreg 240 / 24, O out by a TMA store), with its
//   own producer and walk. Blocks run head-first (decode_block, order 0):
//   the q heads of one GQA group sit on consecutive blocks and stream the
//   same prefix pages through L2 at the same time, and Q is one 3-D TMA
//   box (D, St, B * Hq) of 128 rows. The walk is the live prefix in
//   128-key tiles (64-key at head_dim 256, as K1's, so a 128-row page is
//   refused there) from the page holding the row tile's first visible
//   position, then the tail's tiles up to the last live row;
//   prefix pages wholly before the earliest row's window are skipped, and a
//   row tile whose rows all lie at or past tail_len walks nothing and
//   stores zeros. The producer fills a prefix stage page by page: each pool
//   is one 3-D tensor map (D, P * ps, Hkv) whose box is 64 columns by one
//   page, 128-byte swizzled; with ps a multiple of 8 that divides the
//   tile a page's box lands where one tile-high box would put it, so the
//   consumer reads the stage as K1's. The producer warp's lanes each issue
//   one box (two at ps 8, D 128 or 256), each reading its page id from the
//   table one stage ahead: one lane issuing every box of a stage made K3
//   2.15x slower. A tail stage is one tile-high box per column chunk of the tail
//   map (D, St, B * Hkv), as K1's K / V.
//   Traps this design keeps clear of:
//   - Unfilled stage slots. A slot the producer does not write holds stale
//     shared memory, and P = 0 times a NaN of V is NaN inside an mma. So
//     every slot is written on every phase: slots past the last live page
//     load that page again (masked: their columns lie past the live
//     prefix), and a tail box past St is zero-filled by TMA. Positions
//     past prefix_len inside the last live page are read and masked; the
//     pool holds finite values there (the engine zero-fills it).
//   - The proxy fence. The stages are read only by wgmma, in the async
//     proxy already, so a release needs no fence.proxy.async; a change
//     that reads a TMA-written stage with ordinary loads must add one
//     before the release (without it 14-18 of 100 decode runs were wrong).
//   - Hangs. mbar_wait traps after ~10 s, so a barrier fault fails the
//     launch instead of hanging the card.
// * paged_prefill_q_tc_kernel (K2q), bf16 q over a quantized pool, the
//   scale branch of the TPU kernel (:134-141): int8 or float8_e4m3fn prefix
//   codes with one float32 scale per (kv head, physical page) for K and V
//   (every prefix-hit prefill over an int8 or fp8 pool). The kernel above,
//   with the whole producer warpgroup widening each stage of codes,
//   TMA-loaded a page per box, into a bf16 stage of K2's layout: each
//   code times its page's scale, rounded once to bf16. The consumers are
//   K2's, unchanged, so the output is bit for bit K2's over a bf16 pool of
//   the dequantized values (dequantize_pages(...).to(bfloat16)); the
//   widening runs under the consumers' wgmma. It takes 208 of the 3 x 168
//   registers for each consumer thread and 88 for the producer warpgroup's
//   (QSmem). At head_dim 256 (paged_prefill_q_tc256_kernel, setmaxnreg
//   216 / 72) Q leaves room for five 32 KB stages: K2's ring splits into a
//   K ring of two stages and a V ring of one, with barriers of their own
//   (the consumers hand a K stage back once S = Q K^T has read it, so it is
//   widened again under the softmax and P V), and the codes into a K code
//   ring and a V code ring of two 16 KB stages each (QRing256), each stage
//   reloaded as soon as every thread has read it; each widening thread
//   arrives on the barriers itself: no thread of the warpgroup waits for
//   another.
// * paged_prefill_kernel, float32 arithmetic on the CUDA cores over
//   prefill_tile.cuh (shared with K1's float32 kernel), for two inputs. A
//   float32 pool: the tensor cores take float32 only as TF32 (~3 decimal
//   digits). A quantized pool with float32 q (and with bf16 q only when a
//   caller asks for it, paged_flash_prefill_q_cuda_cores: the design K2q
//   replaced, kept to time one against the other): each code widened and
//   scaled where its prefix row is staged; q, the fresh tail and o in
//   float32 or bf16. The Pallas kernel
//   folds the whole GQA group and padded tail into one q block of group *
//   St rows; here the folded rows are tiled 64 at a time, position-major
//   (row = i * group + g), so each prefix page is read once per (b, kv
//   head, row tile) for every q head of the group. The page table is read
//   by the block itself (no scalar prefetch on a GPU).
#include <type_traits>

#include "prefill_tc.cuh"
#include "prefill_tile.cuh"

namespace {

using namespace rt;

// T: q, the tail and o (float or bf16); C: the pool's elements (float for a
// float32 pool; int8_t or __nv_fp8_e4m3 codes for a quantized one, whose
// (Hkv, P) float32 scale tables ks_tab / vs_tab dequantize each staged
// prefix row: code -> float, times the scale of (hk, page)). The tail is
// fresh K / V in T. Prefix rows at or past prefix_len are staged as zeros,
// never loaded: the table pads with the null page.
template <typename T, typename C, int D>
__global__ void __launch_bounds__(PF_THREADS)
paged_prefill_kernel(const T* __restrict__ q, const C* __restrict__ k_pages,
                     const C* __restrict__ v_pages, const float* __restrict__ ks_tab,
                     const float* __restrict__ vs_tab, const int* __restrict__ page_table,
                     const T* __restrict__ k_tail, const T* __restrict__ v_tail,
                     const int* __restrict__ prefix_len,
                     const int* __restrict__ tail_len, T* __restrict__ o, int Hq,
                     int Hkv, int St, int P, int ps, int mp, float scale,
                     int window, float softcap) {
  constexpr bool QUANT = sizeof(C) == 1;
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
    auto page_row = [&](const C* pool, int rr) -> const C* {
      const int c = c0 + rr;
      if (c >= pref) return nullptr;
      const int page = c / ps;
      const int pid = pt_row[page];
      return pool + (((size_t)hk * P + pid) * ps + (c - page * ps)) * D;
    };
    if constexpr (QUANT) {
      auto row_scale = [&](const float* tab, int rr) -> float {
        return tab[(size_t)hk * P + pt_row[(c0 + rr) / ps]];
      };
      stage_rows_scaled<D, DP, C>(Ks, [&](int rr) { return page_row(k_pages, rr); },
                                  [&](int rr) { return row_scale(ks_tab, rr); });
      stage_rows_scaled<D, D, C>(Vs, [&](int rr) { return page_row(v_pages, rr); },
                                 [&](int rr) { return row_scale(vs_tab, rr); });
    } else {
      stage_rows<D, DP, C>(Ks, [&](int rr) { return page_row(k_pages, rr); });
      stage_rows<D, D, C>(Vs, [&](int rr) { return page_row(v_pages, rr); });
    }
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

template <typename T, typename C, int D>
int launch_cc(const void* q, const void* kp, const void* vp, const float* ks_tab,
              const float* vs_tab, const int* pt, const void* kt, const void* vt,
              const int* plen, const int* tlen, void* o, int B, int Hq, int Hkv, int St, int P,
              int ps, int mp, float scale, int window, float softcap, cudaStream_t stream) {
  const size_t smem = PrefillSmem<D>::bytes;
  cudaError_t err = allow_smem(paged_prefill_kernel<T, C, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Hq / Hkv) * St + PF_BM - 1) / PF_BM;
  if (B <= 0 || tiles <= 0) return 0;
  dim3 grid(tiles, Hkv, B);
  paged_prefill_kernel<T, C, D><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(kp), static_cast<const C*>(vp), ks_tab,
      vs_tab, pt, static_cast<const T*>(kt), static_cast<const T*>(vt), plen, tlen,
      static_cast<T*>(o), Hq, Hkv, St, P, ps, mp, scale, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T, typename C>
int dispatch_cc(const void* q, const void* kp, const void* vp, const float* ks_tab,
                const float* vs_tab, const int* pt, const void* kt, const void* vt,
                const int* plen, const int* tlen, void* o, int B, int Hq, int Hkv, int St,
                int P, int ps, int mp, int D, float scale, int window, float softcap,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PP_CASE(DIM)                                                                        \
  return launch_cc<T, C, DIM>(q, kp, vp, ks_tab, vs_tab, pt, kt, vt, plen, tlen, o, B, Hq, \
                              Hkv, St, P, ps, mp, scale, window, softcap, s)
  if (D == 128) PP_CASE(128);
  if (D == 64) PP_CASE(64);
#undef PP_CASE
  return -1;
}

// -- bf16 on the tensor cores ----------------------------------------------------

namespace tc {

using ptc::BM;
using ptc::STAGES;
using ptc::THREADS;

// The block's KV tiles of BN keys: n_pref prefix tiles from column pref0 (a
// page start), then tail tiles from column tail0. Prefix columns are
// absolute positions (row i of the tail sits at plen + i); tail columns are
// tail-local.
template <int BN>
struct PagedWalk {
  int n_pref, pref0, tail0;
  int live;     // live prefix columns: min(prefix_len, mp * ps)
  int plen, tlen, window;

  __device__ __forceinline__ int col0(int t) const {
    return t < n_pref ? pref0 + t * BN : tail0 + (t - n_pref) * BN;
  }
  __device__ __forceinline__ bool edge(int t, int c0, int row_lo) const {
    const int row_hi = row_lo + 63;
    if (row_hi >= tlen) return true;
    if (t < n_pref) return c0 + BN > live || (window > 0 && c0 <= plen + row_hi - window);
    return c0 + BN - 1 > row_lo || (window > 0 && c0 <= row_hi - window);
  }
  __device__ __forceinline__ bool ok(int t, int row, int col) const {
    bool ok = row < tlen;
    if (t < n_pref) {
      ok = ok && col < live;
      if (window > 0) ok = ok && col > plen + row - window;
    } else {
      ok = ok && col <= row;
      if (window > 0) ok = ok && col > row - window;
    }
    return ok;
  }
};

// Boxes a producer lane issues for one prefix stage: 2 (K, V) x D / 64
// column chunks x BN / ps pages over 32 lanes, at most 2 (ps 8: D 128 at BN
// 128, D 256 at BN 64).
constexpr int MAX_BOXES = 2;

// A block's place in the grid and its walk: blocks run head-first
// (decode_block, order 0), so the q heads of a GQA group sit on consecutive
// blocks. The prefix tiles hold pages first_page .. last_page, BN / ps of
// them a stage (slots past last_page load it again).
template <int BN>
struct Block {
  int b, h, hk, q0, first_page, last_page, ntiles;
  PagedWalk<BN> walk;
};

template <int BN>
__device__ __forceinline__ Block<BN> block_of(const int* __restrict__ prefix_len,
                                          const int* __restrict__ tail_len, int Hq, int Hkv,
                                          int St, int ps, int mp, int window) {
  Block<BN> blk;
  int mb;
  decode_block((St + BM - 1) / BM, Hq, 0, blk.b, blk.h, mb);
  blk.hk = blk.h / (Hq / Hkv);
  blk.q0 = mb * BM;
  const int plen = prefix_len[blk.b];
  const int tlen = tail_len[blk.b];
  const int live = min(plen, mp * ps);
  // The rows q0 .. q_hi of this tile that attend anything; none if q0 is at
  // or past the live tail.
  const int q_hi = min(min(blk.q0 + BM, tlen), St) - 1;
  int n_pref = 0, n_tail = 0, tail_lo = 0;
  blk.first_page = blk.last_page = 0;
  const int per_stage = BN / ps;
  if (q_hi >= blk.q0) {
    // Prefix: the pages from the one holding the first column row q0 sees.
    const int lo = window > 0 ? max(0, plen + blk.q0 - window + 1) : 0;
    if (lo < live) {
      blk.first_page = lo / ps;
      blk.last_page = (live - 1) / ps;
      n_pref = (blk.last_page - blk.first_page + per_stage) / per_stage;
    }
    // Tail: BN-key tiles from the first one row q0 sees to row q_hi's.
    tail_lo = window > 0 ? max(0, blk.q0 - window + 1) / BN : 0;
    n_tail = q_hi / BN + 1 - tail_lo;
  }
  blk.walk = PagedWalk<BN>{n_pref, blk.first_page * ps, tail_lo * BN, live, plen, tlen, window};
  blk.ntiles = n_pref + n_tail;
  return blk;
}

// Lane 0 of the producer warp: the Q tile, and the K / V boxes of tail tile
// t (one BN-row box per column chunk) into stage st.
template <int D>
__device__ __forceinline__ void load_tail(uint8_t* smem, uint64_t* bar, const CUtensorMap* ttk,
                                          const CUtensorMap* ttv, int row, int plane, int st) {
  using L = ptc::Smem<D>;
  hopper::mbar_expect_tx(bar, 2 * L::TILE);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    hopper::tma_load_3d(smem + L::K + st * L::TILE + c * L::BN * 128, ttk, bar, c * 64, row,
                        plane);
    hopper::tma_load_3d(smem + L::V + st * L::TILE + c * L::BN * 128, ttv, bar, c * 64, row,
                        plane);
  }
}

// The Q tile, completing on `qbar`.
template <int D>
__device__ __forceinline__ void load_q(uint8_t* smem, uint64_t* qbar, const CUtensorMap* tq,
                                       int q0, int plane) {
  using L = ptc::Smem<D>;
  hopper::mbar_expect_tx(qbar, BM * D * 2);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    hopper::tma_load_3d(smem + L::Q + c * BM * 128, tq, qbar, c * 64, q0, plane);
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
paged_prefill_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tpk,
                        const __grid_constant__ CUtensorMap tpv,
                        const __grid_constant__ CUtensorMap ttk,
                        const __grid_constant__ CUtensorMap ttv,
                        const __grid_constant__ CUtensorMap to,
                        const int* __restrict__ page_table, const int* __restrict__ prefix_len,
                        const int* __restrict__ tail_len, int Hq, int Hkv, int St, int ps,
                        int mp, float scale, int window, float softcap) {
  using namespace hopper;
  using L = ptc::Smem<D>;
  constexpr int BN = L::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptc::setup<D>(smem_raw);
  const Block<BN> blk = block_of<BN>(prefix_len, tail_len, Hq, Hkv, St, ps, mp, window);
  const int n_pref = blk.walk.n_pref;
  const int per_stage = BN / ps;

  // Producer: warp 8 keeps the ring full; its lanes issue a prefix
  // stage's page boxes side by side, lane 0 the Q and tail boxes.
  auto produce = [&] {
    regs_dealloc<24>();
    if (threadIdx.x >= 256 + 32) return;
    uint64_t* full = ptc::full_bars<D>(smem);
    uint64_t* empty = ptc::empty_bars<D>(smem);
    const int lane = threadIdx.x & 31;
    if (lane == 0) load_q<D>(smem, ptc::q_bar<D>(smem), &tq, blk.q0, blk.b * Hq + blk.h);
    // Box j = lane + 32 r of a prefix stage: K or V (j % 2), column chunk
    // (j / 2) % (D / 64), page slot (j / 2) / (D / 64) of the stage.
    const int boxes = 2 * (D / 64) * per_stage;
    const int* table = page_table + (size_t)blk.b * mp;
    int page[MAX_BOXES];
    auto page_of = [&](int t, int r) {
      const int slot = ((lane + 32 * r) >> 1) / (D / 64);
      return table[min(blk.first_page + t * per_stage + slot, blk.last_page)];
    };
#pragma unroll
    for (int r = 0; r < MAX_BOXES; ++r)
      page[r] = n_pref > 0 && lane + 32 * r < boxes ? page_of(0, r) : 0;
    for (int t = 0; t < blk.ntiles; ++t) {
      const int st = t % STAGES;
      mbar_wait(&empty[st], ((t / STAGES) & 1) ^ 1);
      if (t >= n_pref) {
        if (lane == 0) load_tail<D>(smem, &full[st], &ttk, &ttv, blk.walk.col0(t),
                                    blk.b * Hkv + blk.hk, st);
        continue;
      }
      if (lane == 0) mbar_expect_tx(&full[st], 2 * L::TILE);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < MAX_BOXES; ++r) {
        const int j = lane + 32 * r;
        if (j >= boxes) continue;
        const int kv = j & 1;
        const int c = (j >> 1) % (D / 64);
        const int slot = (j >> 1) / (D / 64);
        tma_load_3d(smem + (kv ? L::V : L::K) + st * L::TILE + c * BN * 128 + slot * ps * 128,
                    kv ? &tpv : &tpk, &full[st], c * 64, page[r] * ps, blk.hk);
        if (t + 1 < n_pref) page[r] = page_of(t + 1, r);
      }
    }
  };
  auto consume = [&] {
    ptc::consume<D, SOFTCAP, false>(smem, blk.walk, blk.ntiles, blk.q0, blk.b * Hq + blk.h,
                                    &to, nullptr, St, scale, softcap);
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

// -- K2q: quantized prefix codes on the tensor cores -----------------------------

// The code ring of paged_prefill_q_tc_kernel (head_dim 64 and 128), after
// K2's shared memory (ptc::Smem<D>): CSTAGES stages of K and V codes (BN
// rows of D bytes each, the stage keys of K2's tile, swizzled over the row
// by TMA), each stage's K and V scales by page slot, then the ring's full
// barriers. At D 128 that is 226.3 KB over two code stages of 128 keys.
constexpr int MAX_SLOTS = 128 / 8;        // pages of a stage at ps 8
constexpr int CONVERTERS = 128;           // the producer warpgroup
constexpr int CONVERT_BAR = 3;            // named barrier (1, 2: the consumers' epilogue)

template <int D>
struct QSmem {
  static_assert(D == 64 || D == 128, "head_dim 256 runs paged_prefill_q_tc256_kernel");
  static constexpr int BN = ptc::Smem<D>::BN;
  static constexpr int CSTAGES = 2;
  static constexpr int CTILE = BN * D;
  static constexpr int K = (ptc::Smem<D>::BAR + 8 * (2 * STAGES + 1) + 1023) / 1024 * 1024;
  static constexpr int V = K + CSTAGES * CTILE;
  static constexpr int SCALES = V + CSTAGES * CTILE;   // float [CSTAGES][K, V][MAX_SLOTS]
  static constexpr int BAR = SCALES + CSTAGES * 2 * MAX_SLOTS * 4;   // full[CSTAGES]
  static constexpr size_t bytes = BAR + 8 * CSTAGES + 1024;          // + base alignment
  // setmaxnreg's registers for each consumer thread and each converter
  // thread: 2 x 208 + 88 = 3 x 168.
  static constexpr int CONSUMER_REGS = 208;
  static constexpr int PRODUCER_REGS = 88;
};
static_assert(QSmem<128>::bytes <= 232448, "K2q's shared memory exceeds a block's 227 KB");

// paged_prefill_q_tc256_kernel's shared memory, from a 1024-byte aligned
// base: K2's Q tile (ptc::Smem<256>::Q, 64 KB, also O's way out), KSTAGES
// bf16 K stages and VSTAGES bf16 V stages (32 KB each: four 128-byte
// swizzled column chunks of BN = 64 rows, K2's tile), CKSTAGES stages of K
// codes and CVSTAGES of V codes (16 KB each: two halves of BN rows of 128
// bytes, one TMA box a page each, as TMA's 128-byte swizzle takes a box at
// most 128 bytes wide), each code stage's scales by page slot, then the
// barriers (QBars). Two bf16 K stages, one bf16 V stage and two stages of
// each code fill 225.2 KB of the 227 KB a block may have: a code stage is
// loaded two tiles ahead, the lead its page boxes need, and a bf16 K stage
// is free again once S = Q K^T has read it (tools/k2q_variants.py --d256
// times other splits).
struct QRing256 {
  static constexpr int D = 256;
  static constexpr int BN = ptc::Smem<D>::BN;
  static constexpr int KSTAGES = 2;                  // bf16 K stages
  static constexpr int VSTAGES = 1;                  // bf16 V stages
  static constexpr int CKSTAGES = 2;                 // K code stages
  static constexpr int CVSTAGES = 2;                 // V code stages
  static constexpr int SLOTS = BN / 8;               // pages of a stage at ps 8
  static constexpr int TILE = ptc::Smem<D>::TILE;    // a bf16 stage
  static constexpr int CTILE = BN * D;               // a code stage
  static constexpr int WK = ptc::Smem<D>::K;         // after Q
  static constexpr int WV = WK + KSTAGES * TILE;
  static constexpr int CK = WV + VSTAGES * TILE;
  static constexpr int CV = CK + CKSTAGES * CTILE;
  static constexpr int SCALES = CV + CVSTAGES * CTILE;   // float [CKSTAGES + CVSTAGES][SLOTS]
  static constexpr int BAR = SCALES + (CKSTAGES + CVSTAGES) * SLOTS * 4;
  static constexpr int NBARS = 1 + 2 * (KSTAGES + VSTAGES + CKSTAGES + CVSTAGES);
  static constexpr size_t bytes = BAR + 8 * NBARS + 1024;   // + base alignment
  // setmaxnreg's registers for each consumer thread and each widening
  // thread: K2's consumers hold O's 128 floats a thread and take ~200.
  static constexpr int CONSUMER_REGS = 216;
  static constexpr int PRODUCER_REGS = 72;
};
static_assert(QRing256::bytes <= 232448, "K2q's head_dim 256 rings exceed a block's 227 KB");
static_assert(QRing256::WK % 1024 == 0 && QRing256::CK % 1024 == 0 && QRing256::CV % 1024 == 0,
              "swizzled stages sit on the swizzle's 1024-byte period");
static_assert(2 * QRing256::CONSUMER_REGS + QRing256::PRODUCER_REGS == 3 * 168,
              "setmaxnreg's roles must sum to the launch's registers");

// QRing256's barriers: the Q tile's, then each ring's full and empty
// barriers. A bf16 stage is full after CONVERTERS arrivals (one from each
// widening thread, or for a tail tile one with the boxes' bytes and 127
// plain), empty after one from each consumer warp; a code stage is full
// after one expect-tx arrival a box and its bytes, empty after one arrival
// from each widening thread.
struct QBars {
  uint64_t *q, *kfull, *kempty, *vfull, *vempty, *ckfull, *ckempty, *cvfull, *cvempty;
};

__device__ __forceinline__ QBars q_bars(uint8_t* smem) {
  using R = QRing256;
  uint64_t* k = reinterpret_cast<uint64_t*>(smem + R::BAR) + 1;
  uint64_t* v = k + 2 * R::KSTAGES;
  uint64_t* ck = v + 2 * R::VSTAGES;
  uint64_t* cv = ck + 2 * R::CKSTAGES;
  return {k - 1, k, k + R::KSTAGES, v, v + R::VSTAGES, ck, ck + R::CKSTAGES, cv,
          cv + R::CVSTAGES};
}

// ptc::consume's ring over QRing256: tile t's K in bf16 K stage t % KSTAGES,
// handed back once S = Q K^T has read it, its V in bf16 V stage t %
// VSTAGES, handed back after P V; each ring's parity from its own depth.
// The stages are read only by wgmma, so a release needs no proxy fence.
struct SplitRing {
  using R = QRing256;
  uint8_t* smem;

  __device__ __forceinline__ uint64_t* qbar() const { return q_bars(smem).q; }
  __device__ __forceinline__ uint32_t k(int t) const {
    return hopper::smem_u32(smem + R::WK + (t % R::KSTAGES) * R::TILE);
  }
  __device__ __forceinline__ uint32_t v(int t) const {
    return hopper::smem_u32(smem + R::WV + (t % R::VSTAGES) * R::TILE);
  }
  __device__ __forceinline__ void wait_k(int t) const {
    hopper::mbar_wait(&q_bars(smem).kfull[t % R::KSTAGES], (t / R::KSTAGES) & 1);
  }
  __device__ __forceinline__ void done_k(int t, int lane) const {
    if (lane == 0) hopper::mbar_arrive(&q_bars(smem).kempty[t % R::KSTAGES]);
  }
  __device__ __forceinline__ void wait_v(int t) const {
    hopper::mbar_wait(&q_bars(smem).vfull[t % R::VSTAGES], (t / R::VSTAGES) & 1);
  }
  __device__ __forceinline__ void done_v(int t, int lane) const {
    if (lane == 0) hopper::mbar_arrive(&q_bars(smem).vempty[t % R::VSTAGES]);
  }
};

// Sixteen codes (one 16-byte chunk, code i in byte i) times a float32
// scale, each product rounded once to bf16, as pairs (codes 2i, 2i + 1 in
// out[i], the lower in the lower half): bit for bit what
// dequantize_pages(codes, scales).to(bfloat16) stores. The product is one
// float32 multiply of two exact values, never fused.
struct Int8Scaled {
  // An int8 code b with its sign bit flipped is the low byte of the float
  // 2^23 + b + 128; less 2^23 + 128 that is b, exactly.
  __device__ static __forceinline__ void widen16(const uint4& c, float s, uint32_t (&out)[8]) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + j)) - 8388736.f;
      out[2 * i] = hopper::pack_bf16(f[0] * s, f[1] * s);
      out[2 * i + 1] = hopper::pack_bf16(f[2] * s, f[3] * s);
    }
  }
};

struct E4m3Scaled {
  // e4m3 -> f16 is exact (cvt.rn.f16x2.e4m3x2), and f16 -> f32 too.
  __device__ static __forceinline__ void widen16(const uint4& c, float s, uint32_t (&out)[8]) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i / 2] >> (16 * (i % 2))), __NV_E4M3));
      const float2 f = __half22float2(h);
      out[i] = hopper::pack_bf16(f.x * s, f.y * s);
    }
  }
};

// K2q at head_dim 64 and 128: bf16 q over int8 or float8_e4m3fn prefix
// codes. K2's walk and K2's consumer warpgroups, fed bf16 stages laid out as
// K2's by the producer warpgroup. Its first warp loads each prefix page's K
// and V codes as one box of a uint8 map (D bytes by ps rows) into the code
// ring, a lane a box, after that lane stores the page's scale into the
// stage's slot (its expect-tx arrival orders the store before the wait),
// and the tail's bf16 boxes straight into the bf16 ring, as K2 does.
// Between those, all four warps widen each prefix code stage into the bf16
// stage: each code times its page's scale rounded once to bf16, positions
// at or past the live prefix written as 0 by select (a frozen row's null
// page holds NaN scales and e4m3 NaN codes: 0 * NaN is NaN in an mma). Each
// thread then fences the proxy (wgmma reads the bf16 stage next and TMA
// rewrites the code stage, both in the async proxy), a named barrier joins
// the warpgroup, one thread arrives on the bf16 stage's full barrier, and
// the first warp refills the code stage CSTAGES tiles ahead. A bf16 stage
// is so filled by the warpgroup's stores for a prefix tile and by TMA for a
// tail tile, either way completing on one arrival; the one warpgroup waits
// on every empty barrier in tile order, so no parity can match a phase two
// behind.
template <int D, bool SOFTCAP, class Code>
__global__ void __launch_bounds__(THREADS, 1)
paged_prefill_q_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tck,
                          const __grid_constant__ CUtensorMap tcv,
                          const __grid_constant__ CUtensorMap ttk,
                          const __grid_constant__ CUtensorMap ttv,
                          const __grid_constant__ CUtensorMap to,
                          const float* __restrict__ ks_tab, const float* __restrict__ vs_tab,
                          const int* __restrict__ page_table,
                          const int* __restrict__ prefix_len, const int* __restrict__ tail_len,
                          int Hq, int Hkv, int St, int P, int ps, int mp, float scale,
                          int window, float softcap) {
  using namespace hopper;
  using L = ptc::Smem<D>;
  using QL = QSmem<D>;
  constexpr int BN = QL::BN;
  constexpr int CSTAGES = QL::CSTAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = ptc::setup<D>(smem_raw);
  const Block<BN> blk = block_of<BN>(prefix_len, tail_len, Hq, Hkv, St, ps, mp, window);
  const int n_pref = blk.walk.n_pref;
  const int per_stage = BN / ps;
  uint64_t* cfull = reinterpret_cast<uint64_t*>(smem + QL::BAR);
  float* scales = reinterpret_cast<float*>(smem + QL::SCALES);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < CSTAGES; ++s) mbar_init(&cfull[s], 2 * per_stage);   // a box each
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 256) {
    ptc::consume<D, SOFTCAP, false, QL::CONSUMER_REGS>(smem, blk.walk, blk.ntiles, blk.q0,
                                                       blk.b * Hq + blk.h, &to, nullptr, St,
                                                       scale, softcap);
    return;
  }
  regs_dealloc<QL::PRODUCER_REGS>();
  uint64_t* full = ptc::full_bars<D>(smem);
  uint64_t* empty = ptc::empty_bars<D>(smem);
  const int ct = threadIdx.x - 256;   // 0 .. 127
  const int lane = ct & 31;
  const bool loader = ct < 32;

  // Lane j < 2 * per_stage of the first warp loads K (j even) or V codes of
  // page slot j / 2 of each prefix stage, its page id and scale read one
  // stage ahead.
  const int kv_box = lane & 1;
  const int slot = lane >> 1;
  const bool mine = loader && slot < per_stage && n_pref > 0;
  const int* table = page_table + (size_t)blk.b * mp;
  const float* tab = (kv_box ? vs_tab : ks_tab) + (size_t)blk.hk * P;
  auto page_of = [&](int t) {
    return table[min(blk.first_page + t * per_stage + slot, blk.last_page)];
  };
  int page = mine ? page_of(0) : 0;
  float page_scale = mine ? tab[page] : 0.f;
  auto load_codes = [&](int t) {
    const int cs = t % CSTAGES;
    scales[(cs * 2 + kv_box) * MAX_SLOTS + slot] = page_scale;
    mbar_expect_tx(&cfull[cs], ps * D);
    tma_load_3d(smem + (kv_box ? QL::V : QL::K) + cs * QL::CTILE + slot * ps * D,
                kv_box ? &tcv : &tck, &cfull[cs], 0, page * ps, blk.hk);
    if (t + 1 < n_pref) {
      page = page_of(t + 1);
      page_scale = tab[page];
    }
  };
  if (loader && lane == 0)
    load_q<D>(smem, ptc::q_bar<D>(smem), &tq, blk.q0, blk.b * Hq + blk.h);
  if (mine) {
    for (int t = 0; t < min(n_pref, CSTAGES); ++t) load_codes(t);
  }

  // Thread ct widens units ct + 128 i of a stage (i < 2 U): K for i < U,
  // then V; one unit is 16-byte code chunk m of row row0 + i' RSTEP (i' = i
  // mod U), m and row0 fixed by ct, so that eight consecutive threads take
  // one chunk of eight consecutive rows (their code reads and both swizzled
  // stores each hit eight distinct bank groups) and every offset is the
  // thread's own plus a constant.
  constexpr int CH = D / 16;             // 16-byte code chunks a row
  constexpr int RSTEP = 128 / CH;        // rows between a thread's units
  constexpr int U = BN / RSTEP;          // a thread's units of K (and of V)
  const int m = (ct >> 3) % CH;
  const int row0 = (ct >> 3) / CH * 8 + (ct & 7);
  const uint32_t code0 = code_offset<D>(row0, m);
  const uint32_t lo0 = sw128_offset(row0, 2 * m, BN);
  const uint32_t hi0 = sw128_offset(row0, 2 * m + 1, BN);
  const int ps_shift = __ffs(ps) - 1;
  for (int t = 0; t < n_pref; ++t) {
    const int cs = t % CSTAGES;
    const int st = t % STAGES;
    mbar_wait(&cfull[cs], (t / CSTAGES) & 1);
    mbar_wait(&empty[st], ((t / STAGES) & 1) ^ 1);
    const int n_live = blk.walk.live - blk.walk.col0(t);   // rows of the stage inside the prefix
    const float* sc = scales + cs * 2 * MAX_SLOTS;
#pragma unroll
    for (int i = 0; i < 2 * U; ++i) {
      const int kv = i / U;
      const int row = row0 + (i % U) * RSTEP;
      uint8_t* dst = smem + (kv ? L::V : L::K) + st * L::TILE + (i % U) * RSTEP * 128;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (row < n_live) {
        const uint4 c = *reinterpret_cast<const uint4*>(
            smem + (kv ? QL::V : QL::K) + cs * QL::CTILE + code0 + (i % U) * RSTEP * D);
        uint32_t o[8];
        Code::widen16(c, sc[kv * MAX_SLOTS + (row >> ps_shift)], o);
        lo = make_uint4(o[0], o[1], o[2], o[3]);
        hi = make_uint4(o[4], o[5], o[6], o[7]);
      }
      *reinterpret_cast<uint4*>(dst + lo0) = lo;
      *reinterpret_cast<uint4*>(dst + hi0) = hi;
    }
    // One fence orders this thread's stores (read next by wgmma) and its
    // code reads (overwritten next by TMA) before the async proxy's accesses.
    fence_async_smem();
    named_barrier_sync(CONVERT_BAR, CONVERTERS);
    if (ct == 0) mbar_arrive(&full[st]);
    if (mine && t + CSTAGES < n_pref) load_codes(t + CSTAGES);
  }

  // The tail, by TMA into the bf16 ring, after the prefix stages in order.
  if (!loader) return;
  for (int t = n_pref; t < blk.ntiles; ++t) {
    const int st = t % STAGES;
    mbar_wait(&empty[st], ((t / STAGES) & 1) ^ 1);
    if (lane == 0) load_tail<D>(smem, &full[st], &ttk, &ttv, blk.walk.col0(t), blk.b * Hkv + blk.hk,
                                st);
  }
}

// K2q at head_dim 256: bf16 q over int8 or float8_e4m3fn prefix codes, K2's
// walk and K2's consumer warpgroups (ptc::consume over SplitRing) beside a
// widening warpgroup, in QRing256's shared memory. Code loads: lane (page
// slot i, K or V, half) of the widening warpgroup's first warp issues that
// box of each K (or V) code stage, then (the lane of the first half) stores
// the page's scale into the stage's slot and arrives (2 * 64 / ps arrivals a
// stage: 16 lanes at ps 8); its page ids come two stages ahead and its
// scales one, so that no lane waits on device memory where it widens, and
// no load waits for a scale. The widening of tile t by each of the four
// warps' threads: its K codes from K code stage t % CKSTAGES into registers
// (the stage then released), then, once bf16 K stage t % KSTAGES is free,
// each code times its page's scale rounded once to bf16 into it; then V the
// same way, through V code stage t % CVSTAGES into bf16 V stage t %
// VSTAGES. A fence and the thread's own arrival follow each step, so no
// widening thread waits for another, but for the loading lanes: once their
// warp has published a half of tile t, that half's lanes refill its code
// stage with tile t + CKSTAGES (or CVSTAGES), waiting for the other warps to
// have left it (they read their codes before they wait for the bf16 stage,
// so they have). A refill earlier in the tile held the loading warp back
// from widening V, which the consumers then waited for. The tail's bf16
// boxes go straight into the two bf16 rings by TMA, as K2's. Where trouble
// lies, each named where it is handled below: the rings' phases, the two
// kinds of bf16 stage, walks shorter than the code rings, the null page, the
// proxy fences and the registers.
template <bool SOFTCAP, class Code>
__global__ void __launch_bounds__(THREADS, 1)
paged_prefill_q_tc256_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tck,
                             const __grid_constant__ CUtensorMap tcv,
                             const __grid_constant__ CUtensorMap ttk,
                             const __grid_constant__ CUtensorMap ttv,
                             const __grid_constant__ CUtensorMap to,
                             const float* __restrict__ ks_tab, const float* __restrict__ vs_tab,
                             const int* __restrict__ page_table,
                             const int* __restrict__ prefix_len,
                             const int* __restrict__ tail_len, int Hq, int Hkv, int St, int P,
                             int ps, int mp, float scale, int window, float softcap) {
  using namespace hopper;
  using R = QRing256;
  constexpr int D = R::D;
  constexpr int BN = R::BN;
  constexpr int ROW = 128;   // a code box's bytes a row: half a code row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Block<BN> blk = block_of<BN>(prefix_len, tail_len, Hq, Hkv, St, ps, mp, window);
  const int n_pref = blk.walk.n_pref;
  const int per_stage = BN / ps;
  const QBars bars = q_bars(smem);
  // Phases: tile t's K codes sit in K code stage t % CKSTAGES, its V codes
  // in V code stage t % CVSTAGES, its bf16 K in K stage t % KSTAGES and its
  // V in V stage t % VSTAGES; every wait below takes its parity from that
  // ring's own depth. Two kinds of bf16 stage: a prefix stage completes on
  // the 128 widening threads' arrivals, a tail stage on one thread's
  // expect-tx arrival (with the boxes' bytes) and the other 127 threads'
  // plain ones, each after its wait on the stage's empty barrier, so that
  // no arrival can fall into the phase before.
  if (threadIdx.x == 0) {
    mbar_init(bars.q, 1);
    for (int s = 0; s < R::KSTAGES; ++s) {
      mbar_init(&bars.kfull[s], CONVERTERS);
      mbar_init(&bars.kempty[s], ptc::CONSUMER_WARPS);
    }
    for (int s = 0; s < R::VSTAGES; ++s) {
      mbar_init(&bars.vfull[s], CONVERTERS);
      mbar_init(&bars.vempty[s], ptc::CONSUMER_WARPS);
    }
    for (int s = 0; s < R::CKSTAGES; ++s) {
      mbar_init(&bars.ckfull[s], 2 * per_stage);   // a box each
      mbar_init(&bars.ckempty[s], CONVERTERS);
    }
    for (int s = 0; s < R::CVSTAGES; ++s) {
      mbar_init(&bars.cvfull[s], 2 * per_stage);
      mbar_init(&bars.cvempty[s], CONVERTERS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // Registers: the consumers' branch first, or ptxas holds them to the
  // launch's share; the widening warpgroup lowers its registers before
  // anything else, as the consumers' setmaxnreg.inc waits for them.
  if (threadIdx.x < 256) {
    ptc::consume<D, SOFTCAP, false, R::CONSUMER_REGS, SplitRing>(
        smem, blk.walk, blk.ntiles, blk.q0, blk.b * Hq + blk.h, &to, nullptr, St, scale,
        softcap);
    return;
  }
  regs_dealloc<R::PRODUCER_REGS>();
  const int ct = threadIdx.x - 256;   // 0 .. 127
  if (ct == 0) load_q<D>(smem, bars.q, &tq, blk.q0, blk.b * Hq + blk.h);
  float* scales = reinterpret_cast<float*>(smem + R::SCALES);

  // The loading lanes: K (kv_box 0) or V codes, half `half` of page slot
  // `slot` of each stage of that ring.
  const int kv_box = ct & 1;
  const int half = (ct >> 1) & 1;
  const int slot = ct >> 2;
  const bool loads = ct < 4 * per_stage && n_pref > 0;
  const int depth = kv_box ? R::CVSTAGES : R::CKSTAGES;
  const int* table = page_table + (size_t)blk.b * mp;
  const float* tab = (kv_box ? vs_tab : ks_tab) + (size_t)blk.hk * P;
  auto page_of = [&](int t) {
    return table[min(blk.first_page + t * per_stage + slot, blk.last_page)];
  };
  int page = 0, next = 0;
  float page_scale = 0.f;
  // Stage u % depth of this lane's ring gets tile u's box, then its scale
  // and the lane's arrival (which orders the scale's store before the
  // wideners' wait); the page id of tile u + 2 and the scale of tile u + 1
  // are read here, used a stage later.
  auto load_codes = [&](int u) {
    const int cs = u % depth;
    uint64_t* full = (kv_box ? bars.cvfull : bars.ckfull) + cs;
    mbar_expect_tx_only(full, ps * ROW);
    tma_load_3d(smem + (kv_box ? R::CV : R::CK) + cs * R::CTILE + half * BN * ROW +
                    slot * ps * ROW,
                kv_box ? &tcv : &tck, full, half * ROW, page * ps, blk.hk);
    if (half == 0) scales[(kv_box * R::CKSTAGES + cs) * R::SLOTS + slot] = page_scale;
    mbar_arrive(full);
    page = next;
    if (u + 1 < n_pref) page_scale = tab[page];
    if (u + 2 < n_pref) next = page_of(u + 2);
  };
  // Walks shorter than the code rings: the prologue loads no tile past n_pref.
  if (loads) {
    page = page_of(0);
    next = n_pref > 1 ? page_of(1) : page;
    page_scale = tab[page];
    for (int u = 0; u < min(n_pref, depth); ++u) load_codes(u);
  }

  // Thread ct widens one row of each stage, row = 8 (ct / 16) + ct % 8, in
  // half h = (ct / 8) % 2 of its codes: U 16-byte units, unit i code chunk
  // 8 h + i, into bf16 column segments 2 (8 h + i) and + 1. Eight
  // consecutive threads take one chunk of eight consecutive rows, so their
  // code reads and both swizzled stores each hit eight distinct bank
  // groups; and a thread's units share one page, so one scale a stage. The
  // code stage is laid out as sw128_offset's tiles too (two halves of BN
  // rows of 128 bytes), so in both unit i's address is the row's own, whose
  // bits 4-6 hold row % 8, with those bits XORed by a constant: one
  // instruction a unit, on 32-bit shared addresses. The codes of GROUP
  // units are read into registers before any is widened (a read after a
  // store would wait for it).
  constexpr int U = 8;
  constexpr int GROUP = 4;   // units read at once (all eight spill at 72 registers)
  const int row = 8 * (ct >> 4) + (ct & 7);
  const uint32_t swz = (row & 7) << 4;
  const uint32_t h = (ct >> 3) & 1;
  const uint32_t code_row = (h * BN + row) * 128 + swz;       // sw128_offset(row, 8 h, BN)
  const uint32_t bf16_row = (2 * h * BN + row) * 128 + swz;   // sw128_offset(row, 16 h, BN)
  const uint32_t base = smem_u32(smem);
  const int ps_shift = __ffs(ps) - 1;
  const uint32_t row_scales = base + R::SCALES + (row >> ps_shift) * 4;
  auto read_codes = [&](uint4 (&c)[GROUP], uint32_t codes, int g) {
#pragma unroll
    for (int i = 0; i < GROUP; ++i) c[i] = lds128(codes ^ ((g + i) << 4));
  };
  // Unit i's two segments: 2 i and 2 i + 1 of column chunk 2 h + i / 4.
  auto seg = [](uint32_t bf16, int i, int part) {
    return (bf16 ^ (((2 * i + part) & 7) << 4)) + (i >> 2) * BN * 128;
  };
  // The null page holds NaN scales and e4m3 NaN codes: rows at or past the
  // live prefix (only in the last prefix tile) are stored as zeros, never
  // widened, so no NaN reaches a product.
  auto widen = [&](uint32_t bf16, const uint4 (&c)[GROUP], float s, bool live, int g) {
    if (live) {
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        uint32_t o[8];
        Code::widen16(c[i], s, o);
        sts128(seg(bf16, g + i, 0), make_uint4(o[0], o[1], o[2], o[3]));
        sts128(seg(bf16, g + i, 1), make_uint4(o[4], o[5], o[6], o[7]));
      }
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        sts128(seg(bf16, g + i, 0), z);
        sts128(seg(bf16, g + i, 1), z);
      }
    }
  };
  // The lanes of ring kv refill the stage tile t read with tile t + depth,
  // once every widening thread has left it.
  auto refill = [&](int kv, int t) {
    if (loads && kv_box == kv && t + depth < n_pref) {
      mbar_wait((kv ? bars.cvempty : bars.ckempty) + t % depth, (t / depth) & 1);
      load_codes(t + depth);
    }
  };
  // Half kv of tile t's widening (K 0, V 1): the codes from code stage t %
  // CKSTAGES (or CVSTAGES) into bf16 stage t % KSTAGES (or VSTAGES) once the
  // consumers have handed that back, then published. Proxy fences: TMA
  // rewrites the code stage once it is released, and wgmma reads the bf16
  // stage next, both in the async proxy.
  auto widen_half = [&](int t, int kv, bool live) {
    const int stages = kv ? R::CVSTAGES : R::CKSTAGES;
    const int bf16_stages = kv ? R::VSTAGES : R::KSTAGES;
    const int cs = t % stages;
    const int bs = t % bf16_stages;
    uint64_t* full = (kv ? bars.cvfull : bars.ckfull) + cs;
    uint64_t* empty = (kv ? bars.cvempty : bars.ckempty) + cs;
    const uint32_t codes = base + (kv ? R::CV : R::CK) + cs * R::CTILE + code_row;
    const uint32_t bf16 = base + (kv ? R::WV : R::WK) + bs * R::TILE + bf16_row;
    mbar_wait(full, (t / stages) & 1);
    const float s = lds32f(row_scales + (kv * R::CKSTAGES + cs) * R::SLOTS * 4);
#pragma unroll
    for (int g = 0; g < U; g += GROUP) {
      uint4 c[GROUP];
      read_codes(c, codes, g);
      if (g + GROUP == U) {   // the code stage's last read: release it
        fence_async_smem();
        mbar_arrive(empty);
      }
      if (g == 0)
        mbar_wait((kv ? bars.vempty : bars.kempty) + bs, ((t / bf16_stages) & 1) ^ 1);
      widen(bf16, c, s, live, g);
    }
    fence_async_smem();
    mbar_arrive((kv ? bars.vfull : bars.kfull) + bs);
    refill(kv, t);
  };
  for (int t = 0; t < n_pref; ++t) {
    const bool live = row < blk.walk.live - blk.walk.col0(t);
    widen_half(t, 0, live);
    widen_half(t, 1, live);
  }

  // The tail, by TMA into the two rings, after the prefix stages in order.
  using L = ptc::Smem<D>;
  const int plane = blk.b * Hkv + blk.hk;
  for (int t = n_pref; t < blk.ntiles; ++t) {
    const int ks = t % R::KSTAGES;
    const int vs = t % R::VSTAGES;
    const int row0 = blk.walk.col0(t);
    mbar_wait(&bars.kempty[ks], ((t / R::KSTAGES) & 1) ^ 1);
    if (ct == 0) {
      mbar_expect_tx(&bars.kfull[ks], L::TILE);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(smem + R::WK + ks * R::TILE + c * BN * 128, &ttk, &bars.kfull[ks], c * 64,
                    row0, plane);
    } else {
      mbar_arrive(&bars.kfull[ks]);
    }
    mbar_wait(&bars.vempty[vs], ((t / R::VSTAGES) & 1) ^ 1);
    if (ct == 0) {
      mbar_expect_tx(&bars.vfull[vs], L::TILE);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(smem + R::WV + vs * R::TILE + c * BN * 128, &ttv, &bars.vfull[vs], c * 64,
                    row0, plane);
    } else {
      mbar_arrive(&bars.vfull[vs]);
    }
  }
}

// The tensor maps of q, the tail and o (bf16, contiguous); 0 or the
// status of the first that could not be encoded.
template <int D>
int tail_maps(CUtensorMap* tq, CUtensorMap* ttk, CUtensorMap* ttv, CUtensorMap* to,
              const void* q, const void* kt, const void* vt, void* o, int B, int Hq, int Hkv,
              int St) {
  int err = hopper::make_map_3d(tq, q, D, St, B * Hq, BM);
  if (err == 0) err = hopper::make_map_3d(ttk, kt, D, St, B * Hkv, ptc::Smem<D>::BN);
  if (err == 0) err = hopper::make_map_3d(ttv, vt, D, St, B * Hkv, ptc::Smem<D>::BN);
  if (err == 0) err = hopper::make_map_3d(to, o, D, St, B * Hq, BM / 2);
  return err;
}

template <int D, bool SOFTCAP>
int launch(const void* q, const void* kp, const void* vp, const int* pt, const void* kt,
           const void* vt, const int* plen, const int* tlen, void* o, int B, int Hq, int Hkv,
           int St, int P, int ps, int mp, float scale, int window, float softcap,
           cudaStream_t stream) {
  const long long blocks = (long long)B * Hq * ((St + BM - 1) / BM);
  if (blocks <= 0) return 0;
  CUtensorMap tq, tpk, tpv, ttk, ttv, to;
  int err = tail_maps<D>(&tq, &ttk, &ttv, &to, q, kt, vt, o, B, Hq, Hkv, St);
  if (err == 0) err = hopper::make_map_3d(&tpk, kp, D, P * ps, Hkv, ps);
  if (err == 0) err = hopper::make_map_3d(&tpv, vp, D, P * ps, Hkv, ps);
  if (err != 0) return err;
  const size_t smem = ptc::Smem<D>::bytes;
  const cudaError_t e = allow_smem(paged_prefill_tc_kernel<D, SOFTCAP>, smem);
  if (e != cudaSuccess) return (int)e;
  paged_prefill_tc_kernel<D, SOFTCAP><<<(unsigned)blocks, THREADS, smem, stream>>>(
      tq, tpk, tpv, ttk, ttv, to, pt, plen, tlen, Hq, Hkv, St, ps, mp, scale, window,
      softcap);
  return (int)cudaGetLastError();
}

// K2q's kernel of head_dim D.
template <int D, bool SOFTCAP, class Code>
constexpr auto q_tc_kernel() {
  if constexpr (D == 256)
    return paged_prefill_q_tc256_kernel<SOFTCAP, Code>;
  else
    return paged_prefill_q_tc_kernel<D, SOFTCAP, Code>;
}

template <int D, bool SOFTCAP, class Code>
int launch_q(const void* q, const void* kc, const void* vc, const float* ks_tab,
             const float* vs_tab, const int* pt, const void* kt, const void* vt,
             const int* plen, const int* tlen, void* o, int B, int Hq, int Hkv, int St, int P,
             int ps, int mp, float scale, int window, float softcap, cudaStream_t stream) {
  const long long blocks = (long long)B * Hq * ((St + BM - 1) / BM);
  if (blocks <= 0) return 0;
  CUtensorMap tq, tck, tcv, ttk, ttv, to;
  int err = tail_maps<D>(&tq, &ttk, &ttv, &to, q, kt, vt, o, B, Hq, Hkv, St);
  if (err == 0) err = hopper::make_map_3d_u8(&tck, kc, D, P * ps, Hkv, ps);
  if (err == 0) err = hopper::make_map_3d_u8(&tcv, vc, D, P * ps, Hkv, ps);
  if (err != 0) return err;
  using QL = std::conditional_t<D == 256, QRing256, QSmem<D>>;
  const auto kernel = q_tc_kernel<D, SOFTCAP, Code>();
  // setmaxnreg.inc waits until the registers it asks for are free: a launch
  // share below the roles' sum would hang the consumers, so refuse it.
  static const int regs = [&] {
    cudaFuncAttributes a;
    return cudaFuncGetAttributes(&a, kernel) == cudaSuccess ? a.numRegs : 0;
  }();
  if (3 * regs < 2 * QL::CONSUMER_REGS + QL::PRODUCER_REGS)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = QL::bytes;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      tq, tck, tcv, ttk, ttv, to, ks_tab, vs_tab, pt, plen, tlen, Hq, Hkv, St, P, ps, mp,
      scale, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// float32 q / pools / tail on the CUDA cores. Returns a cudaError_t (0 =
// success), or -1 for a head_dim this build does not instantiate.
extern "C" int paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                             const int* page_table, const void* k_tail,
                             const void* v_tail, const int* prefix_len,
                             const int* tail_len, void* o, int B, int Hq, int Hkv,
                             int St, int P, int ps, int mp, int D, float scale,
                             int window, float softcap, void* stream) {
  return dispatch_cc<float, float>(q, k_pages, v_pages, nullptr, nullptr, page_table, k_tail,
                                   v_tail, prefix_len, tail_len, o, B, Hq, Hkv, St, P, ps, mp,
                                   D, scale, window, softcap, stream);
}

// A quantized pool on the CUDA cores: q / tail / o float32 (q_bf16 0) or
// bf16 (1); int8 (fp8 0) or float8_e4m3fn (1) prefix codes with (Hkv, P)
// float32 scale tables. Returns as paged_prefill does.
extern "C" int paged_prefill_q(const void* q, const void* k_codes, const void* v_codes,
                               const float* k_scale_tab, const float* v_scale_tab,
                               const int* page_table, const void* k_tail, const void* v_tail,
                               const int* prefix_len, const int* tail_len, void* o, int B,
                               int Hq, int Hkv, int St, int P, int ps, int mp, int D,
                               int q_bf16, int fp8, float scale, int window, float softcap,
                               void* stream) {
#define PQ_CASE(T, C)                                                                        \
  return dispatch_cc<T, C>(q, k_codes, v_codes, k_scale_tab, v_scale_tab, page_table,      \
                           k_tail, v_tail, prefix_len, tail_len, o, B, Hq, Hkv, St, P, ps, \
                           mp, D, scale, window, softcap, stream)
  if (!q_bf16 && !fp8) PQ_CASE(float, int8_t);
  if (!q_bf16 && fp8) PQ_CASE(float, __nv_fp8_e4m3);
  if (q_bf16 && !fp8) PQ_CASE(__nv_bfloat16, int8_t);
  PQ_CASE(__nv_bfloat16, __nv_fp8_e4m3);
#undef PQ_CASE
}

// bfloat16 q / pools / tail on the tensor cores, head_dim 64, 128 or 256;
// contiguous, 16-byte aligned tensors (the tensor maps' requirement) and a
// page size that is a multiple of 8 dividing the stage's keys (128; 64 at
// head_dim 256). Returns a cudaError_t (0 = success), -1 for a head_dim or
// page size this build does not take, -2 if a tensor map could not be
// encoded.
extern "C" int paged_prefill_tc(const void* q, const void* k_pages, const void* v_pages,
                                const int* page_table, const void* k_tail,
                                const void* v_tail, const int* prefix_len,
                                const int* tail_len, void* o, int B, int Hq, int Hkv,
                                int St, int P, int ps, int mp, int D, float scale,
                                int window, float softcap, void* stream) {
  if (ps <= 0 || ps % 8 || (D == 256 ? ptc::kv_tile<256>() : ptc::kv_tile<128>()) % ps)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PP_TC_CASE(DIM, CAP)                                                               \
  return tc::launch<DIM, CAP>(q, k_pages, v_pages, page_table, k_tail, v_tail, prefix_len, \
                              tail_len, o, B, Hq, Hkv, St, P, ps, mp, scale, window,       \
                              softcap, s)
  const bool cap = softcap > 0.f;
  if (D == 128) {
    if (cap) PP_TC_CASE(128, true);
    PP_TC_CASE(128, false);
  }
  if (D == 64) {
    if (cap) PP_TC_CASE(64, true);
    PP_TC_CASE(64, false);
  }
  if (D == 256) {
    if (cap) PP_TC_CASE(256, true);
    PP_TC_CASE(256, false);
  }
#undef PP_TC_CASE
  return -1;
}

// bfloat16 q / tail / o over int8 (fp8 0) or float8_e4m3fn (1) prefix codes
// with (Hkv, P) float32 scale tables, on the tensor cores, head_dim 64, 128
// or 256. Requirements and returns as paged_prefill_tc's.
extern "C" int paged_prefill_q_tc(const void* q, const void* k_codes, const void* v_codes,
                                  const float* k_scale_tab, const float* v_scale_tab,
                                  const int* page_table, const void* k_tail,
                                  const void* v_tail, const int* prefix_len,
                                  const int* tail_len, void* o, int B, int Hq, int Hkv, int St,
                                  int P, int ps, int mp, int D, int fp8, float scale,
                                  int window, float softcap, void* stream) {
  if (ps <= 0 || ps % 8 || (D == 256 ? ptc::kv_tile<256>() : ptc::kv_tile<128>()) % ps)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PQ_TC_CASE(DIM, CAP, CODE)                                                          \
  return tc::launch_q<DIM, CAP, tc::CODE>(q, k_codes, v_codes, k_scale_tab, v_scale_tab,    \
                                          page_table, k_tail, v_tail, prefix_len, tail_len, \
                                          o, B, Hq, Hkv, St, P, ps, mp, scale, window,      \
                                          softcap, s)
#define PQ_TC_CODES(DIM, CAP)                \
  if (fp8) PQ_TC_CASE(DIM, CAP, E4m3Scaled); \
  PQ_TC_CASE(DIM, CAP, Int8Scaled)
  const bool cap = softcap > 0.f;
  if (D == 128) {
    if (cap) { PQ_TC_CODES(128, true); }
    PQ_TC_CODES(128, false);
  }
  if (D == 64) {
    if (cap) { PQ_TC_CODES(64, true); }
    PQ_TC_CODES(64, false);
  }
  if (D == 256) {
    if (cap) { PQ_TC_CODES(256, true); }
    PQ_TC_CODES(256, false);
  }
#undef PQ_TC_CODES
#undef PQ_TC_CASE
  return -1;
}
