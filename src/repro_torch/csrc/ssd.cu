// K9: the Mamba-2 SSD intra-chunk block for Hopper (sm_90a), on the tensor
// cores in 3xTF32.
//
// Replaces the Pallas body _ssd_chunk_kernel (:36) of the JAX package's
// src/repro/kernels/ssd.py, launched by ssd_intra_chunk (:83). Per
// (b, chunk, head), with q the chunk length:
//   y = ((C B^T) * exp(masked segsum)) . (dt x)          (q x P)
//   s = (B * exp(acum_last - acum))^T . (dt x)            (N x P, written P x N)
// where segsum[i, j] = acum[i] - acum[j] for j <= i and -1e30 above the
// diagonal: the mask is applied in log space before exp, because above the
// diagonal the sum is positive and exp overflows. Float32 in and out. The
// inter-chunk recurrence stays in PyTorch (kernels/ssd.py), as it stays in
// jnp.
//
// Layouts (strides in elements, the last dimension contiguous, every row
// 16-byte aligned; kernels/ssd.py checks): xdt and y (B, nc, q, H, P), acum
// (B, nc, q, H) (read by scalar loads, any stride), bh and ch (B, nc, q, G,
// N), head h reading group h / (H / G), so B and C are read per group in
// place; s (B, nc, H, P, N), the order the recurrence reads.
//
// What bounds it on an H100: three products per cell, q (q + 1) (N + P) +
// 2 q N P operations (the causal half of the two q x q products). At q 256
// that is 42 (hymba, N 16, P 64) and 102 (mamba2, N 128, P 64) operations
// per byte of xdt, y, s and acum (B and C per group are read once for all
// heads): both far above float32's balance point of 20 (67 TFLOP/s over
// 3.35 TB/s); against 3xTF32's 49 (165 TFLOP/s) hymba is bound by bytes and
// mamba2 by operations.
//
// What the design does about it: the products run on the tensor cores as
// mma.sync m16n8k8 TF32 (the helpers are csrc/tf32.cuh). TF32 alone keeps
// 10 mantissa bits, so each float32 operand is split into hi = tf32(x)
// and lo = tf32(x - hi) (cvt.rna both times: the tensor core ignores the
// low 13 bits of a raw float32, so the hi it would use is not the one lo
// was taken from), and each product is lo hi' + hi lo' + hi hi',
// accumulated in float32: about 22 bits a product, at a third of the TF32
// rate (165 TFLOP/s), 2.5x the float32 peak. mma.sync and not wgmma: wgmma
// takes tf32 operands K-major only, and W X and B^T X would need X and B
// transposed in staging; mma.sync fragments load from either layout with
// padded ld.shared (rows padded by 4 floats: every fragment load below is
// free of bank conflicts).
//
// A block of 8 warps owns one (b, chunk, head) and walks the causal half:
// 128 query rows at a time (16 per warp) against key tiles of BK rows (64;
// 32 at N 128, P 128) up to the diagonal; a warp skips the key tiles past
// its last row. A tile pair is C B^T (per warp 16 x BK, k over N) into
// registers, the masked decay in the registers (W = S exp(seg), split into
// hi and lo as the A fragment of the next product, keys permuted within
// each k-step of 8 so that the accumulator layout is the A layout: no
// shuffles), then y += W X. The state product rides on the last query
// tile's walk, which visits every key tile: s^T += X^T (B dte), each warp a
// 16 x (N / 8 / warps along N) slab.
//
// The splits are what a TF32 product costs on top of its three mma: ptxas
// expands each cvt.rna into four instructions. So the B and X key tiles
// are split once in shared memory, for all eight warps, into hi and lo
// planes: a two-stage pipeline in which tile t + 1 lands by 16-byte
// cp.async (rows past q zero-filled) in a landing buffer while tile t,
// already split, multiplies. Each thread splits the chunks it copied, so
// its own cp.async.wait_group is all the split waits for. The operands
// split in registers are those a warp reuses across column tiles: C's rows
// (kept as loaded: split planes of a 128 x 128 C tile would not fit beside
// the key tiles), W, and the state's decay-scaled operand (X dte, or B dte
// at N 16, where a warp has one or two column tiles of the state).
// cp.async and not TMA: the tiles are small and row-strided, and a stage read with ld.shared after
// cp.async.wait_group + __syncthreads needs no proxy fence. Blocks are
// numbered head-first, (b, h, chunk) with chunk fastest: the paper's
// order; with G < H the blocks in flight at once share their group's B and
// C through L2. No atomics: every output element is summed by one thread
// in a fixed order, so reruns give the same bits.
#include "tf32.cuh"

namespace {

using namespace rt;

constexpr int SSD_WARPS = 8;
constexpr int SSD_THREADS = SSD_WARPS * 32;
constexpr int SSD_BM = 16 * SSD_WARPS;   // query rows per tile, 16 per warp

struct SsdArgs {
  const float* xdt;
  const float* bh;
  const float* ch;
  const float* acum;
  float* y;
  float* s;
  // Strides of the leading four dimensions (the last one is contiguous):
  // xdt / y / acum (B, nc, q, H), bh / ch (B, nc, q, G), s (B, nc, H, P).
  long long sx[4], sb[4], sc[4], sa[4], sy[4], ss[4];
  int H, nc, q, rep;   // rep = H / G heads per group
};

// Shared memory, in floats: C's query tile as loaded; the landing buffer of
// the next key tile (B rows, then X rows, unpadded, as cp.async writes
// them); this key tile's B and X split into hi and lo planes; acum and its
// decay to the chunk end.
template <int N, int P>
struct SsdTile {
  static constexpr int BK = (N >= 64 && P >= 128) ? 32 : 64;   // key rows per tile
  static constexpr int LDN = N + 4;                             // padded row strides
  static constexpr int LDP = P + 4;
  static constexpr int C_OFF = 0;                               // SSD_BM x LDN
  static constexpr int RAW_OFF = C_OFF + SSD_BM * LDN;          // BK x (N + P)
  static constexpr int BH_OFF = RAW_OFF + BK * (N + P);         // BK x LDN each
  static constexpr int BL_OFF = BH_OFF + BK * LDN;
  static constexpr int XH_OFF = BL_OFF + BK * LDN;              // BK x LDP each
  static constexpr int XL_OFF = XH_OFF + BK * LDP;
  static constexpr int A_OFF = XL_OFF + BK * LDP;               // qpad floats each
  static size_t bytes(int qpad) { return sizeof(float) * (A_OFF + 2 * (size_t)qpad); }
  static_assert(SSD_BM % BK == 0, "a query tile is a whole number of key tiles");
};

// The B fragment (rows k and k + 4 of an 8 x 8 tile, i.e. elements i and i
// + step of a plane) from the hi and lo planes of a split stage.
__device__ __forceinline__ void frag_b(const float* hi, const float* lo, int i, int step,
                                       uint32_t (&bhi)[2], uint32_t (&blo)[2]) {
  bhi[0] = __float_as_uint(hi[i]);
  bhi[1] = __float_as_uint(hi[i + step]);
  blo[0] = __float_as_uint(lo[i]);
  blo[1] = __float_as_uint(lo[i + step]);
}

// Row r0 + r of a row-strided (q x W) matrix, 16-byte chunk c4 / 4, into
// dst; rows at or past q are zero-filled (the source then reads nothing).
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, long long stride,
                                           int row, int c4, int q) {
  const bool live = row < q;
  cp_async16(dst, live ? src + (long long)row * stride + c4 : src, live);
}

// Two blocks an SM at hymba's (N 16, P 64), whose tiles take 77 KB; one at
// the others (127-221 KB).
template <int N, int P>
__global__ void __launch_bounds__(SSD_THREADS, (N <= 32 && P <= 64) ? 2 : 1)
ssd_chunk_tc(const SsdArgs a) {
  using T = SsdTile<N, P>;
  constexpr int BK = T::BK, LDN = T::LDN, LDP = T::LDP;
  constexpr int KN = BK / 8;            // 8-key column tiles of S = k-steps of W X
  constexpr int PN = P / 8;             // 8-column tiles of y
  constexpr int SM = P / 16;            // 16-row tiles of s^T (rows p)
  constexpr int SW_M = SM < SSD_WARPS ? SM : SSD_WARPS;   // warps along p
  constexpr int SW_N = SSD_WARPS / SW_M;                  // warps along n
  constexpr int SN = N / 8 / SW_N;      // 8-column tiles of s^T per warp
  constexpr int BCH = BK * N / 4;       // 16-byte chunks of a B key tile
  constexpr int XCH = BK * P / 4;       // and of an X key tile
  static_assert(SM <= SSD_WARPS && SSD_WARPS % SW_M == 0 && (N / 8) % SW_N == 0,
                "state tiles split evenly over the warps");

  extern __shared__ __align__(16) float smem[];
  float* cs = smem + T::C_OFF;
  float* raw = smem + T::RAW_OFF;
  float* bh_s = smem + T::BH_OFF;
  float* bl_s = smem + T::BL_OFF;
  float* xh_s = smem + T::XH_OFF;
  float* xl_s = smem + T::XL_OFF;

  // Head-first block order: chunk fastest, then head, then batch.
  const int c = blockIdx.x % a.nc;
  const int h = (blockIdx.x / a.nc) % a.H;
  const int b = blockIdx.x / (a.nc * a.H);
  const int grp = h / a.rep;
  const int q = a.q;
  const float* xg = a.xdt + b * a.sx[0] + c * a.sx[1] + h * a.sx[3];
  const float* bg = a.bh + b * a.sb[0] + c * a.sb[1] + grp * a.sb[3];
  const float* cg = a.ch + b * a.sc[0] + c * a.sc[1] + grp * a.sc[3];
  const float* ag = a.acum + b * a.sa[0] + c * a.sa[1] + h * a.sa[3];
  float* yg = a.y + b * a.sy[0] + c * a.sy[1] + h * a.sy[3];

  const int nq = (q + SSD_BM - 1) / SSD_BM;
  const int qpad = nq * SSD_BM;
  const int nk_all = (q + BK - 1) / BK;
  float* as = smem + T::A_OFF;   // acum, zero past q
  float* dte = as + qpad;        // exp(acum_last - acum), zero past q

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in the group

  // Key tile kt into the landing buffer. Each thread copies, and later
  // splits, the same chunks, so a thread reads only what it copied: its
  // own cp.async.wait_group is enough before the split, and the landing
  // buffer is free for the next tile as soon as this thread has split.
  auto land_keys = [&](int kt) {
    for (int i = threadIdx.x; i < BCH; i += SSD_THREADS)
      copy_chunk(raw + 4 * i, bg, a.sb[2], kt * BK + i / (N / 4), i % (N / 4) * 4, q);
    for (int i = threadIdx.x; i < XCH; i += SSD_THREADS)
      copy_chunk(raw + 4 * (BCH + i), xg, a.sx[2], kt * BK + i / (P / 4), i % (P / 4) * 4, q);
  };
  // The landed tile into hi and lo planes, once per element for all warps.
  auto split_keys = [&]() {
    auto split4 = [](const float* src, float* hi, float* lo) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
      split_tf32(v.x, h0, l0);
      split_tf32(v.y, h1, l1);
      split_tf32(v.z, h2, l2);
      split_tf32(v.w, h3, l3);
      *reinterpret_cast<uint4*>(hi) = make_uint4(h0, h1, h2, h3);
      *reinterpret_cast<uint4*>(lo) = make_uint4(l0, l1, l2, l3);
    };
    for (int i = threadIdx.x; i < BCH; i += SSD_THREADS) {
      const int o = i / (N / 4) * LDN + i % (N / 4) * 4;
      split4(raw + 4 * i, bh_s + o, bl_s + o);
    }
    for (int i = threadIdx.x; i < XCH; i += SSD_THREADS) {
      const int o = i / (P / 4) * LDP + i % (P / 4) * 4;
      split4(raw + 4 * (BCH + i), xh_s + o, xl_s + o);
    }
  };

  land_keys(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < qpad; i += SSD_THREADS)
    as[i] = i < q ? ag[(long long)i * a.sa[2]] : 0.f;
  __syncthreads();
  const float a_last = as[q - 1];
  for (int i = threadIdx.x; i < qpad; i += SSD_THREADS)
    dte[i] = i < q ? expf(a_last - as[i]) : 0.f;

  // The state slab of this warp: s^T rows [sp0, sp0 + 16), columns
  // [sn0, sn0 + 8 SN).
  const int sp0 = (warp % SW_M) * 16;
  const int sn0 = (warp / SW_M) * SN * 8;
  float sacc[SN][4];
#pragma unroll
  for (int i = 0; i < SN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[i][e] = 0.f;

  for (int qt = 0; qt < nq; ++qt) {
    const int i0 = qt * SSD_BM;
    const int nk = min(nk_all, (i0 + SSD_BM) / BK);   // key tiles up to the diagonal
    const bool last_qt = qt == nq - 1;
    // The previous tile's last step ended in __syncthreads: C is free.
    for (int i = threadIdx.x; i < SSD_BM * N / 4; i += SSD_THREADS)
      copy_chunk(cs + i / (N / 4) * LDN + i % (N / 4) * 4, cg, a.sc[2], i0 + i / (N / 4),
                 i % (N / 4) * 4, q);
    cp_async_commit();
    float yacc[PN][4];
#pragma unroll
    for (int i = 0; i < PN; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[i][e] = 0.f;
    const int row0 = i0 + 16 * warp;                 // this warp's first row
    const int r0 = row0 + g, r1 = r0 + 8;            // this thread's rows
    const int row_last = min(row0 + 15, q - 1);      // its last live row, if row0 < q

    for (int kt = 0; kt < nk; ++kt) {
      // This thread's chunks of the key tile (and of C) have landed: split
      // them, then land the next step's key tile (this query tile's next,
      // or the next query tile's first) while this one multiplies.
      cp_async_wait_all();
      split_keys();
      if (kt + 1 < nk || !last_qt) {
        land_keys(kt + 1 < nk ? kt + 1 : 0);
        cp_async_commit();
      }
      __syncthreads();
      const int j0 = kt * BK;

      if (row0 < q && j0 <= row_last) {
        float sfr[KN][4];
#pragma unroll
        for (int nt = 0; nt < KN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sfr[nt][e] = 0.f;
        // S = C B^T over k = N: C's A fragment split here (it serves the KN
        // column tiles), B's from the split planes.
#pragma unroll
        for (int kk = 0; kk < N; kk += 8) {
          const float* cr = cs + (16 * warp + g) * LDN + kk + t;
          uint32_t ahi[4], alo[4];
          split_tf32(cr[0], ahi[0], alo[0]);
          split_tf32(cr[8 * LDN], ahi[1], alo[1]);
          split_tf32(cr[4], ahi[2], alo[2]);
          split_tf32(cr[8 * LDN + 4], ahi[3], alo[3]);
#pragma unroll
          for (int nt = 0; nt < KN; ++nt) {
            uint32_t bhi[2], blo[2];
            frag_b(bh_s, bl_s, (nt * 8 + g) * LDN + kk + t, 4, bhi, blo);
            mma_3xtf32(sfr[nt], ahi, alo, bhi, blo);
          }
        }
        // W = S exp(seg), masked in log space (W is exactly 0 above the
        // diagonal and past q), then y += W X. The accumulator holds keys
        // 2t and 2t + 1 of each 8-key tile; as the A fragment those sit in
        // columns t and t + 4, so X's rows are read in the same order
        // (k-step column t is key 2t, column t + 4 key 2t + 1).
        const float ar0 = as[r0], ar1 = as[r1];
        const bool q0 = r0 < q, q1 = r1 < q;
#pragma unroll
        for (int nt = 0; nt < KN; ++nt) {
          const int k0 = j0 + nt * 8 + 2 * t;
          const float ak0 = as[k0], ak1 = as[k0 + 1];
          const float w00 = sfr[nt][0] * expf(k0 <= r0 && q0 ? ar0 - ak0 : NEG_INF_F);
          const float w01 = sfr[nt][1] * expf(k0 + 1 <= r0 && q0 ? ar0 - ak1 : NEG_INF_F);
          const float w10 = sfr[nt][2] * expf(k0 <= r1 && q1 ? ar1 - ak0 : NEG_INF_F);
          const float w11 = sfr[nt][3] * expf(k0 + 1 <= r1 && q1 ? ar1 - ak1 : NEG_INF_F);
          uint32_t whi[4], wlo[4];
          split_tf32(w00, whi[0], wlo[0]);   // (row g,     key 2t)
          split_tf32(w10, whi[1], wlo[1]);   // (row g + 8, key 2t)
          split_tf32(w01, whi[2], wlo[2]);   // (row g,     key 2t + 1)
          split_tf32(w11, whi[3], wlo[3]);   // (row g + 8, key 2t + 1)
#pragma unroll
          for (int pn = 0; pn < PN; ++pn) {
            uint32_t bhi[2], blo[2];
            frag_b(xh_s, xl_s, (nt * 8 + 2 * t) * LDP + pn * 8 + g, LDP, bhi, blo);
            mma_3xtf32(yacc[pn], whi, wlo, bhi, blo);
          }
        }
      }

      if (last_qt) {
        // s^T += X^T (B dte) over this tile's keys (zero past q), k-steps of
        // 8 in the same key order as above (column t is key 2t, t + 4 is
        // key 2t + 1). The scaled operand is split here: B dte where a warp
        // has at most two column tiles (N 16), else X dte, which then serves
        // the SN column tiles (rebuilt from X's planes: hi + lo is X to
        // 2^-22).
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          const int kr = ks * 8 + 2 * t;                 // row in the tile
          const float d0 = dte[j0 + kr], d1 = dte[j0 + kr + 1];
          const int xi = kr * LDP + sp0 + g;
          uint32_t ahi[4], alo[4];
          if constexpr (SN <= 2) {
            // (p g, 2t), (p g + 8, 2t), (p g, 2t + 1), (p g + 8, 2t + 1)
            const int xo[4] = {xi, xi + 8, xi + LDP, xi + LDP + 8};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ahi[e] = __float_as_uint(xh_s[xo[e]]);
              alo[e] = __float_as_uint(xl_s[xo[e]]);
            }
#pragma unroll
            for (int sn = 0; sn < SN; ++sn) {
              const int bi = kr * LDN + sn0 + sn * 8 + g;
              uint32_t bhi[2], blo[2];
              split_tf32((bh_s[bi] + bl_s[bi]) * d0, bhi[0], blo[0]);
              split_tf32((bh_s[bi + LDN] + bl_s[bi + LDN]) * d1, bhi[1], blo[1]);
              mma_3xtf32(sacc[sn], ahi, alo, bhi, blo);
            }
          } else {
            split_tf32((xh_s[xi] + xl_s[xi]) * d0, ahi[0], alo[0]);               // (p g, 2t)
            split_tf32((xh_s[xi + 8] + xl_s[xi + 8]) * d0, ahi[1], alo[1]);       // (p g + 8, 2t)
            split_tf32((xh_s[xi + LDP] + xl_s[xi + LDP]) * d1, ahi[2], alo[2]);   // (p g, 2t + 1)
            split_tf32((xh_s[xi + LDP + 8] + xl_s[xi + LDP + 8]) * d1, ahi[3], alo[3]);
#pragma unroll
            for (int sn = 0; sn < SN; ++sn) {
              uint32_t bhi[2], blo[2];
              frag_b(bh_s, bl_s, kr * LDN + sn0 + sn * 8 + g, LDN, bhi, blo);
              mma_3xtf32(sacc[sn], ahi, alo, bhi, blo);
            }
          }
        }
      }
      __syncthreads();   // the planes and C are free for the next split
    }

    // y rows r0 and r1, columns 2t and 2t + 1 of each 8-column tile.
#pragma unroll
    for (int pn = 0; pn < PN; ++pn) {
      const int col = pn * 8 + 2 * t;
      if (r0 < q)
        *reinterpret_cast<float2*>(yg + (long long)r0 * a.sy[2] + col) =
            make_float2(yacc[pn][0], yacc[pn][1]);
      if (r1 < q)
        *reinterpret_cast<float2*>(yg + (long long)r1 * a.sy[2] + col) =
            make_float2(yacc[pn][2], yacc[pn][3]);
    }
  }

  // s (B, nc, H, P, N): rows p, N contiguous.
  float* sg = a.s + b * a.ss[0] + c * a.ss[1] + h * a.ss[2];
#pragma unroll
  for (int sn = 0; sn < SN; ++sn) {
    const int col = sn0 + sn * 8 + 2 * t;
    *reinterpret_cast<float2*>(sg + (long long)(sp0 + g) * a.ss[3] + col) =
        make_float2(sacc[sn][0], sacc[sn][1]);
    *reinterpret_cast<float2*>(sg + (long long)(sp0 + g + 8) * a.ss[3] + col) =
        make_float2(sacc[sn][2], sacc[sn][3]);
  }
}

template <int N, int P>
int launch_ssd(const SsdArgs& args, int B, cudaStream_t stream) {
  const int qpad = (args.q + SSD_BM - 1) / SSD_BM * SSD_BM;
  const size_t smem = SsdTile<N, P>::bytes(qpad);
  if (smem > 232448) return -1;   // a chunk too long for acum in shared memory
  cudaError_t err = allow_smem(ssd_chunk_tc<N, P>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * args.nc * args.H;
  ssd_chunk_tc<N, P><<<(unsigned)blocks, SSD_THREADS, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 24 int64, the leading four strides of xdt, bh, ch, acum, y and s
// in that order (see SsdArgs). Returns a cudaError_t (0 = success), or -1
// for an (N, P) this build does not instantiate or a chunk too long.
extern "C" int ssd_intra_chunk_tc(const float* xdt, const float* bh, const float* ch,
                                  const float* acum, float* y, float* s,
                                  const long long* strides, int B, int nc, int H, int G,
                                  int q, int P, int N, void* stream) {
  if (B <= 0 || nc <= 0 || H <= 0 || q <= 0) return 0;
  if (G <= 0 || H % G != 0) return -1;
  SsdArgs args;
  args.xdt = xdt;
  args.bh = bh;
  args.ch = ch;
  args.acum = acum;
  args.y = y;
  args.s = s;
  long long* dst[6] = {args.sx, args.sb, args.sc, args.sa, args.sy, args.ss};
  for (int i = 0; i < 6; ++i)
    for (int d = 0; d < 4; ++d) dst[i][d] = strides[4 * i + d];
  args.H = H;
  args.nc = nc;
  args.q = q;
  args.rep = H / G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 16 && P == 64) return launch_ssd<16, 64>(args, B, st);
  if (N == 128 && P == 64) return launch_ssd<128, 64>(args, B, st);
  if (N == 16 && P == 128) return launch_ssd<16, 128>(args, B, st);
  if (N == 128 && P == 128) return launch_ssd<128, 128>(args, B, st);
  return -1;
}
