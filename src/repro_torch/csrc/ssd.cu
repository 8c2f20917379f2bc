// K9: the Mamba-2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces the Pallas body _ssd_chunk_kernel (:36) of the JAX package's
// src/repro/kernels/ssd.py, launched by ssd_intra_chunk (:83). Per
// (b, chunk, head), with q the chunk length:
//   y = ((C B^T) * exp(masked segsum)) . (dt x)          (q x P)
//   s = (B * exp(acum_last - acum))^T . (dt x)            (N x P)
// where segsum[i, j] = acum[i] - acum[j] for j <= i and -1e30 above the
// diagonal: the mask is applied in log space before exp, because above the
// diagonal the sum is positive and exp overflows. Inputs and outputs are
// float32: xdt (B, nc, H, q, P), bh / ch (B, nc, H, q, N), acum
// (B, nc, H, q); y (B, nc, H, q, P), s (B, nc, H, N, P). The inter-chunk
// recurrence stays in PyTorch (kernels/ssd.py), as it stays in jnp.
//
// What bounds it on an H100: three products per cell, q (q + 1) (N + P)
// + 2 q N P operations (the causal half of the two q x q products) against
// 4 (2 q P + 2 q N + q + N P) bytes in and out: at q 256 some 34 operations
// per byte for hymba (N 16) and 39 for mamba2 (N 128), above float32's
// balance point of 20 (67 TFLOP/s over 3.35 TB/s), so it is bound by
// operations.
//
// What the design does about it: the (q x q) float32 score tile of a 256-row
// chunk is 256 KB, more than an SM's 227 KB of shared memory, so a block
// tiles it: 64 query rows at a time against 64-key tiles up to the
// diagonal (the causal half only), with C's rows, B's and (dt x)'s key rows
// and the weighted scores in shared memory and each thread's 4 x (P/16)
// outputs in registers. The chunk state is a second sweep over the chunk's
// key tiles in the same block. Blocks are numbered head-first, (b, h,
// chunk) with chunk fastest: the paper's order, all chunks of one head in
// consecutive blocks. Float32 FMAs on the CUDA cores, like K1 in this port.
#include "common.cuh"

namespace {

using namespace rt;

constexpr int SSD_THREADS = 256;
constexpr int SSD_BM = 64;  // query rows per tile
constexpr int SSD_BK = 64;  // key rows per tile

template <int N, int P>
struct SsdSmem {
  static size_t bytes(int q) {
    return sizeof(float) * ((size_t)SSD_BM * (N + 1) + (size_t)SSD_BK * (N + 1) +
                            (size_t)SSD_BK * P + (size_t)SSD_BM * (SSD_BK + 1) + SSD_BK +
                            (size_t)q);
  }
};

// rows [r0, r0 + ROWS) of a (q x W) row-major matrix into dst with row
// stride LD; rows at or past q are zero.
template <int W, int ROWS, int LD>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int r0,
                                          int q) {
  for (int idx = threadIdx.x; idx < ROWS * (W / 4); idx += SSD_THREADS) {
    const int r = idx / (W / 4);
    const int c4 = (idx - r * (W / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < q) x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * W + c4);
    float* d = dst + r * LD + c4;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <int N, int P>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ bh,
                 const float* __restrict__ ch, const float* __restrict__ acum,
                 float* __restrict__ y, float* __restrict__ s_out, int H, int nc, int q) {
  constexpr int NP = N + 1;
  constexpr int WP = SSD_BK + 1;
  constexpr int PC = P / 16;   // output columns per thread
  constexpr int NR = N / 16;   // state rows per thread
  extern __shared__ float smem[];
  float* cs = smem;                    // SSD_BM x NP: C rows of the query tile
  float* bs = cs + SSD_BM * NP;        // SSD_BK x NP: B rows of the key tile
  float* xs = bs + SSD_BK * NP;        // SSD_BK x P: (dt x) rows of the key tile
  float* ws = xs + SSD_BK * P;         // SSD_BM x WP: weighted scores
  float* dte = ws + SSD_BM * WP;       // SSD_BK: decay to the chunk end
  float* as = dte + SSD_BK;            // q: acum of the chunk

  // Head-first block order: chunk fastest, then head, then batch.
  const int c = blockIdx.x % nc;
  const int h = (blockIdx.x / nc) % H;
  const int b = blockIdx.x / (nc * H);
  const size_t cell = ((size_t)b * nc + c) * H + h;
  const float* x_c = xdt + cell * q * P;
  const float* b_c = bh + cell * q * N;
  const float* c_c = ch + cell * q * N;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

  for (int i = tid; i < q; i += SSD_THREADS) as[i] = acum[cell * q + i];

  for (int i0 = 0; i0 < q; i0 += SSD_BM) {
    float yacc[4][PC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int p = 0; p < PC; ++p) yacc[a][p] = 0.f;
    __syncthreads();
    load_rows<N, SSD_BM, NP>(c_c, cs, i0, q);
    // Causal: keys up to the last row of this query tile.
    for (int j0 = 0; j0 < min(i0 + SSD_BM, q); j0 += SSD_BK) {
      __syncthreads();
      load_rows<N, SSD_BK, NP>(b_c, bs, j0, q);
      load_rows<P, SSD_BK, P>(x_c, xs, j0, q);
      __syncthreads();
      // Scores of rows tr + 16 a against keys tc + 16 e, weighted by the
      // decay, masked in log space before exp.
      float sc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[a][e] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = cs[(tr + 16 * a) * NP + n];
#pragma unroll
        for (int e = 0; e < 4; ++e) bv[e] = bs[(tc + 16 * e) * NP + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[a][e] = fmaf(cv[a], bv[e], sc[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + tr + 16 * a;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + tc + 16 * e;
          const bool ok = j <= i && i < q && j < q;
          const float seg = ok ? as[i] - as[j] : NEG_INF_F;
          ws[(tr + 16 * a) * WP + tc + 16 * e] = sc[a][e] * expf(seg);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < SSD_BK; ++j) {
        float wv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) wv[a] = ws[(tr + 16 * a) * WP + j];
#pragma unroll
        for (int p = 0; p < PC; ++p) {
          const float xv = xs[j * P + tc + 16 * p];
#pragma unroll
          for (int a = 0; a < 4; ++a) yacc[a][p] = fmaf(wv[a], xv, yacc[a][p]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + tr + 16 * a;
      if (i >= q) continue;
#pragma unroll
      for (int p = 0; p < PC; ++p) y[(cell * q + i) * P + tc + 16 * p] = yacc[a][p];
    }
  }

  // Chunk state: s[n, p] = sum_j B[j, n] exp(acum_last - acum_j) xdt[j, p].
  float sacc[NR][PC];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int p = 0; p < PC; ++p) sacc[r][p] = 0.f;
  const float last = as[q - 1];
  for (int j0 = 0; j0 < q; j0 += SSD_BK) {
    __syncthreads();
    load_rows<N, SSD_BK, NP>(b_c, bs, j0, q);
    load_rows<P, SSD_BK, P>(x_c, xs, j0, q);
    for (int j = tid; j < SSD_BK; j += SSD_THREADS)
      dte[j] = j0 + j < q ? expf(last - as[j0 + j]) : 0.f;
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < SSD_BK; ++j) {
      const float dj = dte[j];
      float bv[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) bv[r] = bs[j * NP + tr + 16 * r] * dj;
#pragma unroll
      for (int p = 0; p < PC; ++p) {
        const float xv = xs[j * P + tc + 16 * p];
#pragma unroll
        for (int r = 0; r < NR; ++r) sacc[r][p] = fmaf(bv[r], xv, sacc[r][p]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int p = 0; p < PC; ++p)
      s_out[(cell * N + tr + 16 * r) * P + tc + 16 * p] = sacc[r][p];
}

template <int N, int P>
int launch_ssd(const float* xdt, const float* bh, const float* ch, const float* acum, float* y,
               float* s, int B, int nc, int H, int q, cudaStream_t stream) {
  const size_t smem = SsdSmem<N, P>::bytes(q);
  cudaError_t err = allow_smem(ssd_chunk_kernel<N, P>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * nc * H;
  ssd_chunk_kernel<N, P><<<(unsigned)blocks, SSD_THREADS, smem, stream>>>(xdt, bh, ch, acum, y,
                                                                          s, H, nc, q);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = success), or -1 for an (N, P) this build does
// not instantiate.
extern "C" int ssd_intra_chunk(const float* xdt, const float* bh, const float* ch,
                               const float* acum, float* y, float* s, int B, int nc, int H,
                               int q, int P, int N, void* stream) {
  if (B <= 0 || nc <= 0 || H <= 0 || q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 16 && P == 64) return launch_ssd<16, 64>(xdt, bh, ch, acum, y, s, B, nc, H, q, st);
  if (N == 128 && P == 64) return launch_ssd<128, 64>(xdt, bh, ch, acum, y, s, B, nc, H, q, st);
  if (N == 16 && P == 128) return launch_ssd<16, 128>(xdt, bh, ch, acum, y, s, B, nc, H, q, st);
  if (N == 128 && P == 128)
    return launch_ssd<128, 128>(xdt, bh, ch, acum, y, s, B, nc, H, q, st);
  return -1;
}
