// The tensor-core decode consumer, shared by the decode kernels on the
// tensor cores: K7/K8 (dense_decode.cu, a stripe's rows by one 4-D
// tensor-map box per column chunk), K3/K4 (paged_decode.cu, one 3-D box per
// page) and K3q/K4q (paged_decode.cu, one box of 1-byte codes per page).
// Each kernel keeps its own producer; the rings, the barriers and
// everything the consumer warps do live here once.
//
// A block of THREADS threads serves one (b, kv head[, split]) cell with the
// whole GQA group inside, so each K/V byte is read once for all G heads. A
// producer warp fills a ring of 64-row bf16 K and V tiles (128-byte
// swizzled: D / 64 column chunks of BT rows of 128 bytes, each chunk
// 1024-byte aligned) on mbarriers; tile t sits in stage t % STAGES, its
// first key at position first + t * BT. Four consumer warps hold q's G
// rows, zero-padded to 16 (two m16 tiles for G > 16, each taken by two of
// the warps), as mma.sync m16n8k16 A fragments for the whole walk. The
// warps of one m16 tile take whole tiles in turn. Per tile: S = q K^T with
// K fed by ldmatrix, an online softmax in S's registers (exp2, scale *
// log2(e) folded into one multiply, a softcap first; positions outside
// [lo, hi) masked to P exactly
// 0, so stale or repeated rows never count), then O += P V with P rounded
// to bf16 as the A fragment and V by ldmatrix.trans. A warp releases a
// stage by one mbarrier arrival after a proxy fence. The warps' states merge
// once, through shared memory; one pass writes the normalised row, a
// split writes float32 (acc, m ln 2, l) for decode_common.cuh's combine.
// At head_dim 64 and 128 (consume_tiles) a softcap is softcap * tanhf(y *
// scale / softcap): with hopper.cuh's ex2 + rcp form instead, ptxas laid
// the loop out so that a group of 32 at D 128 ran 7% slower with no softcap
// at all (tools/decode_ab.py against tanhf on an H100; no served config has
// a softcap at these widths). consume_d256 takes the ex2 + rcp form.
//
// At head_dim 256 q's fragments (64 registers), O (128) and S (32) pass the
// 255 a thread may have, so one warp cannot take a whole tile. There
// (consume_d256) all four warps take every tile, each on one 64-column
// chunk of D: warp w holds q's columns 64 w .. + 63 (16 registers an m16
// tile), computes S's partial sum over them for all 64 keys, and keeps O's
// columns 64 w .. + 63 (32 registers). The partial S's meet in shared
// memory (Xchg); warp w sums keys 16 w .. + 15 of the four, in warp order,
// and applies the scale, softcap and mask: each score is computed once. The
// row maxima of the four key slices meet in shared memory, each warp turns
// its slice into P (the A fragment of P V's k16 step w) and publishes it,
// and every warp runs P V over all 64 keys for its columns. Three named
// barriers a tile (an m16 tile beyond the first adds one); one online
// softmax state per row, its sums kept per key slice and added in warp
// order at the end. With 16 registers of q a warp, the ring holds three
// 64 KB stages (192 KB, plus 23 KB for the exchange), not two.
//
// A quantized pool's ring (QRing) holds 1-byte int8 or e4m3 codes, one row
// of D bytes per key, swizzled by TMA over the row (128 bytes at D 128, 64
// at D 64), and each stage's page scales. At head_dim 64 and 128 (CodeTiles)
// the warp that takes a tile widens
// its K codes into a bf16 tile of its own, in the layout above, computes S
// from it, then widens the V codes into the same tile and releases the
// stage before P V. Widening is exact for both codes (an int8 code or an
// e4m3 value is a bf16 value), and positions outside [lo, hi) are written
// as 0 by select: a frozen row's null page may hold e4m3 NaN bits, and
// 0 * NaN is NaN in an mma. The scales are folded, never applied to a stage: S's column j is
// multiplied by the K scale of its page before the softmax (before the
// softcap), and P's column j by the V scale of its page, by select, in
// float32; the row sum takes P unscaled. The scaled P goes to P V as two
// bf16 A fragments, its rounding and the remainder, each multiplied by the
// same widened V: one bf16 rounding of the scale alone (2^-9 of it) put a
// one-key row, whose output is its V row, 2 bf16 ulps off the unquantized
// kernel, and the second product costs less than scaling each page's P V
// after its mma did.
//
// At head_dim 256 the code kernel (paged_decode.cu's
// paged_decode_q_tc256_kernel) has a block of 384 threads: warps 0-3 run
// consume_d256 as over the bf16 ring, warps 4-7, the widening warpgroup,
// take the codes off their walk, and warp 8 loads the codes (warps 9-11
// only fill its warpgroup, whose registers setmaxnreg gives the consumers:
// at 288 threads ptxas held every thread to 168 and two m16 tiles spilled). A code row of
// 256 bytes is two TMA boxes of 128 columns, each 128-byte swizzled, so a
// code stage is two halves of BT rows of 128 bytes. The producer warp
// loads each code stage (a box a lane, with its page's scale, as at
// head_dim 64 and 128); the four widening warps widen it, K and V, into
// bf16 K and V stages in the bf16 ring's tile layout (widening warp v:
// column chunk v, bytes 64 v .. + 63 of each row, in half v / 2), rows
// outside [lo, hi) zeroed by select, and copy the stage's scales into the K
// stage's slots. The consumers read those stages as they read the bf16 ring
// (WideChunks) and fold the scales as above: the K scales into S's columns
// where warp w sums its 16 keys (before the softcap), the V scales into its
// slice of P in float32, published as two bf16 fragments, the rounding and
// the remainder (QXchg), both taken by every warp's P V; the row sums take
// P unscaled. The consumers so see the same bf16 values, scales and
// fragments in the same order as when each widened its own chunk: the same
// bits. (The producer has a warp of its own because its reads of the page
// table and the scales wait on device memory: on a widening warp they held
// the other three at each meeting, and the consumers waited for V.)
//
// The rings of QRing<256> and their barriers (220.3 KB of the 227 KB a
// block may have). Three code stages (96 KB): a code stage is full after one
// expect-tx arrival a box and the boxes' bytes. Each widening thread reads
// its share of a code stage, K and V, into registers (so that no read waits
// behind a store), fences the proxy (it read TMA-written bytes with
// ordinary loads, and TMA rewrites the stage next) and arrives on the
// stage's empty barrier (128 arrivals) before it widens; the producer waits
// there before it loads the stage STAGES tiles ahead. Two bf16 K stages (64
// KB): the consumers read K only for the scores, and release it (an arrival
// of each consumer warp) before they wait on V; so the K of tile t + 1 is
// widened while they still score tile t. One bf16 V stage (32 KB), released
// after P V: the V of tile t + 1 is widened while they score tile t + 1,
// before which they do not wait for it. (Measured against one K stage and
// two V stages with the same bits: 7% faster at gemma2-2b; tools/decode_ab.py
// --variants.) A bf16 stage is full after each
// widening thread's arrival, after its own stores: the four warps never
// wait for one another. The stores and the consumers' ldmatrix are
// ordinary accesses on both sides, so no bf16 release needs a proxy fence.
// Each side waits on every barrier in tile order: tile t waits on phase t
// / 3 of its code stage, t / 2 of its K stage and t / 1 of the V stage,
// each ring's parity from its own depth, and no parity can match a phase
// two behind.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace rt {
namespace dtc {

constexpr int BT = 64;               // rows (keys) of a K / V tile
constexpr int CONSUMER_WARPS = 4;

constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);   // + one producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The head_dim 256 consumer's exchange (the header comment): each warp's
// partial S of an m16 tile (rows of 72 floats: the four row groups of a
// float2 store fall on distinct banks), P's A fragments (one uint4 a lane,
// k16 step, m16 tile), the row maxima and the row sums of each key slice.
struct Xchg {
  static constexpr int SROW = 72;
  static constexpr int MAX_MT = 2;
  static constexpr int S = 0;                                    // float [4][16][SROW]
  static constexpr int P = S + CONSUMER_WARPS * 16 * SROW * 4;   // uint4 [MAX_MT][4][32]
  static constexpr int MX = P + MAX_MT * 4 * 32 * 16;           // float [4][MAX_MT][16]
  static constexpr int L = MX + CONSUMER_WARPS * MAX_MT * 16 * 4;
  static constexpr int BYTES = L + CONSUMER_WARPS * MAX_MT * 16 * 4;
};

// The exchange of consume_d256 over a quantized ring: Xchg, then the
// remainder fragments of the scaled P (uint4 [MAX_MT][4][32], as Xchg::P),
// P V's second A operand.
struct QXchg {
  static constexpr int PL = Xchg::BYTES;
  static constexpr int BYTES = PL + Xchg::MAX_MT * 4 * 32 * 16;
};

// Dynamic shared memory, in bytes from a 1024-byte aligned base: the ring's
// K and V stages (each tile D / 64 swizzled column chunks of BT rows), then
// its full and empty mbarriers, then at head_dim 256 the exchange. After
// the walk the ring holds the warps' states for the merge (D 64, 128).
template <int D>
struct Ring {
  static_assert(D == 64 || D == 128 || D == 256, "head_dim 64, 128 or 256");
  // 128 KB in flight at D 64 and 128; 192 KB at 256 (the header comment).
  static constexpr int STAGES = D == 256 ? 3 : 8 * 64 / D;
  static constexpr int TILE = BT * D * 2;
  static constexpr int K = 0;
  static constexpr int V = STAGES * TILE;
  static constexpr int BAR = 2 * STAGES * TILE;
  static constexpr int XCHG = BAR + 8 * 2 * STAGES;
  static constexpr size_t bytes = XCHG + (D == 256 ? Xchg::BYTES : 0) + 1024;   // + alignment
};
static_assert(Ring<256>::bytes <= 232448, "the head_dim 256 ring exceeds a block's 227 KB");
static_assert(Ring<256>::XCHG % 16 == 0, "the exchange takes 16-byte accesses");

// A quantized pool's ring: STAGES stages of K and V codes (BT rows of D
// bytes each), each stage's K and V scales by 8-key group (BT / 8 floats
// each), one bf16 tile (BT x D, the Ring's layout) for each consumer warp,
// then the full and empty mbarriers. Twice the stages of the bf16 ring in
// the same bytes.
template <int D>
struct QRing {
  static constexpr int STAGES = 2 * Ring<D>::STAGES;
  static constexpr int TILE = BT * D;
  static constexpr int OWN_TILE = BT * D * 2;
  static constexpr int K = 0;
  static constexpr int V = STAGES * TILE;
  static constexpr int OWN = 2 * STAGES * TILE;
  static constexpr int SCALES = OWN + 4 * OWN_TILE;   // [STAGES][K, V][BT / 8]
  static constexpr int BAR = SCALES + STAGES * 2 * (BT / 8) * 4;
  static constexpr size_t bytes = BAR + 8 * 2 * STAGES + 1024;   // + base alignment
};

// The head_dim 256 code kernel's block: the consumer warps, the widening
// warpgroup and the producer's warpgroup (the header comment).
constexpr int WIDE_THREADS = 3 * 32 * CONSUMER_WARPS;

// At head_dim 256 (the header comment): STAGES stages of K and V codes, each
// two halves of BT rows of 128 bytes (half c at c * BT * 128), KSTAGES bf16
// stages of K and VSTAGES of V (Ring<256>'s tiles: four column chunks of BT
// rows of 128 bytes), the exchange (QXchg), each code stage's and each bf16
// K stage's K and V scales by 8-key group, then the code stages' full and
// empty barriers and the bf16 stages' full and empty barriers (wide_bars).
// 220.3 KB (225,632 bytes) of the 227 KB a block may have.
template <>
struct QRing<256> {
  static constexpr int STAGES = 3;                 // code stages
  static constexpr int KSTAGES = 2;                // bf16 K stages
  static constexpr int VSTAGES = 1;                // bf16 V stages
  // setmaxnreg's registers for each consumer thread and each thread of the
  // producer's warpgroup (the wideners keep the launch's share).
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int TILE = BT * 256;            // a code stage's K (or V)
  static constexpr int WTILE = Ring<256>::TILE;    // a bf16 stage's K (or V)
  static constexpr int K = 0;
  static constexpr int V = STAGES * TILE;
  static constexpr int WK = 2 * STAGES * TILE;
  static constexpr int WV = WK + KSTAGES * WTILE;
  static constexpr int XCHG = WV + VSTAGES * WTILE;
  static constexpr int SCALES = XCHG + QXchg::BYTES;                  // [STAGES][K, V][BT / 8]
  static constexpr int WSCALES = SCALES + STAGES * 2 * (BT / 8) * 4;  // [KSTAGES][K, V][BT / 8]
  static constexpr int BAR = WSCALES + KSTAGES * 2 * (BT / 8) * 4;
  static constexpr size_t bytes =
      BAR + 8 * 2 * (STAGES + KSTAGES + VSTAGES) + 1024;   // + base alignment
};
static_assert(QRing<256>::bytes <= 232448, "the head_dim 256 code ring exceeds a block's 227 KB");
static_assert(QRing<256>::XCHG % 16 == 0, "the exchange takes 16-byte accesses");
static_assert(QRing<256>::WK % 1024 == 0, "bf16 stages sit on the swizzle's 1024-byte period");

__device__ __forceinline__ uint8_t* ring_base(uint8_t* smem_raw) {
  return smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
}

// The full and empty mbarriers of ring R (Ring<D> or QRing<D>).
template <class R>
__device__ __forceinline__ uint64_t* full_bars(uint8_t* smem) {
  return reinterpret_cast<uint64_t*>(smem + R::BAR);
}

template <class R>
__device__ __forceinline__ uint64_t* empty_bars(uint8_t* smem) {
  return full_bars<R>(smem) + R::STAGES;
}

template <int D>
__device__ __forceinline__ float* q_scales(uint8_t* smem) {
  return reinterpret_cast<float*>(smem + QRing<D>::SCALES);
}

// QRing<256>'s bf16 stages' barriers, after the code stages' full and
// empty barriers: K full, K empty, V full, V empty.
struct WideBars {
  uint64_t* kfull;
  uint64_t* kempty;
  uint64_t* vfull;
  uint64_t* vempty;
};

__device__ __forceinline__ WideBars wide_bars(uint8_t* smem) {
  using R = QRing<256>;
  uint64_t* k = empty_bars<R>(smem) + R::STAGES;
  uint64_t* v = k + 2 * R::KSTAGES;
  return {k, k + R::KSTAGES, v, v + R::VSTAGES};
}

// The K and V scales of QRing<256>'s bf16 K stages.
__device__ __forceinline__ float* wide_scales(uint8_t* smem) {
  return reinterpret_cast<float*>(smem + QRing<256>::WSCALES);
}

// Thread 0 sets up `stages` full and empty barriers: a stage is full after
// `arrivals` arrivals (each with its expect-tx) and their bytes, empty
// after `readers` arrivals (one from each warp that reads the stage). Every
// thread of the block calls this (it ends in a block-wide barrier).
__device__ __forceinline__ void bars_init(uint64_t* full, uint64_t* empty, int stages,
                                          int arrivals, int readers) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      hopper::mbar_init(&full[st], arrivals);
      hopper::mbar_init(&empty[st], readers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// The bf16 ring's barriers: a stage is full after the producer's one
// expect-tx arrival and its bytes, empty after the arrivals of the warps
// that read it: one of each of the MT m16 tiles, or at head_dim 256 all
// four.
template <int D, int MT>
__device__ __forceinline__ void ring_init(uint8_t* smem) {
  bars_init(full_bars<Ring<D>>(smem), empty_bars<Ring<D>>(smem), Ring<D>::STAGES, 1,
            D == 256 ? CONSUMER_WARPS : MT);
}

// d = a * b + c on bf16 pairs, rounded to nearest.
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Four int8 codes (byte i of w) as bf16 pairs, exactly: lo holds codes 0
// and 1, hi codes 2 and 3 (the lower code in the lower half). A code b in
// the low byte of a half under 0x43 is bf16 0x43bb; with b's sign bit
// cleared that is 128 + (b & 0x7f), with only its sign bit kept 128 or 256
// (b < 0), and their difference is b, exact in bf16.
struct Int8Codes {
  __device__ static __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
    const uint32_t a = __byte_perm(w, 0x43434343u, 0x4140);   // halves 0x43b0, 0x43b1
    const uint32_t c = __byte_perm(w, 0x43434343u, 0x4342);   // halves 0x43b2, 0x43b3
    constexpr uint32_t MINUS_ONE = 0xbf80bf80u;
    lo = bf16x2_fma(a & 0xff80ff80u, MINUS_ONE, a & 0xff7fff7fu);
    hi = bf16x2_fma(c & 0xff80ff80u, MINUS_ONE, c & 0xff7fff7fu);
  }
};

// Four float8_e4m3fn codes as bf16 pairs, exactly. The code's sign to bit
// 15 and its exponent and mantissa bits to bits 10..4 make the bf16 of the
// code's value times 2^-120 (a subnormal code a subnormal bf16), and one
// multiply by 2^120 (bf16 0x7b80; bf16 arithmetic keeps subnormals) gives
// the value. The NaN code widens to a finite value: only masked positions
// hold it, and they are written as zeros.
struct E4m3Codes {
  __device__ static __forceinline__ uint32_t widen2(uint32_t a) {   // halves b << 8
    return bf16x2_fma(((a >> 4) & 0x07f007f0u) | (a & 0x80008000u), 0x7b807b80u,
                      0x80008000u);
  }
  __device__ static __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
    lo = widen2(__byte_perm(w, 0u, 0x1404));   // halves b0 << 8, b1 << 8
    hi = widen2(__byte_perm(w, 0u, 0x3424));
  }
};

// One stage's code tile (BT rows of D bytes, TMA-swizzled) widened by one
// warp into the bf16 tile `own` (the Ring's layout); rows whose position,
// less lo, is not below `live` (rel0: the tile's first row's) are zeros.
template <int D, class Code>
__device__ __forceinline__ void widen_tile(const uint8_t* codes, uint8_t* own, int rel0,
                                           unsigned live, int lane) {
  constexpr int CH = D / 16;   // 16-byte code chunks a row
#pragma unroll
  for (int j = 0; j < BT * CH / 32; ++j) {
    const int u = j * 32 + lane;
    const int row = u / CH;
    const int m = u - row * CH;
    const uint4 c = *reinterpret_cast<const uint4*>(codes + hopper::code_offset<D>(row, m));
    uint4 lo, hi;
    Code::widen4(c.x, lo.x, lo.y);
    Code::widen4(c.y, lo.z, lo.w);
    Code::widen4(c.z, hi.x, hi.y);
    Code::widen4(c.w, hi.z, hi.w);
    if ((unsigned)(rel0 + row) >= live) lo = hi = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(own + hopper::sw128_offset(row, 2 * m, BT)) = lo;
    *reinterpret_cast<uint4*>(own + hopper::sw128_offset(row, 2 * m + 1, BT)) = hi;
  }
}

// One widening warp's share of a head_dim 256 code stage's K (or V):
// column chunk w, bytes 64 w .. + 63 of each row (QRing<256>: in half w /
// 2). Lane l holds 16-byte chunk l / 8 of the chunk's four in rows l % 8 +
// 8 j, so eight consecutive lanes read, and write, eight distinct bank
// groups. load() reads all eight units into registers first, so that no
// load waits behind a store the compiler cannot tell apart from it; widen()
// writes them as bf16 into column chunk w of a bf16 stage (BT rows of 128
// bytes, 128-byte swizzled, as the Ring's tiles), rows whose position, less
// lo, is not below `live` as zeros, unless WHOLE says that every row is
// inside.
struct CodeChunk {
  uint4 c[BT / 8];

  __device__ __forceinline__ void load(const uint8_t* codes, int w, int lane) {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
      c[j] = *reinterpret_cast<const uint4*>(
          codes + hopper::sw128_offset((lane & 7) + 8 * j, 4 * w + (lane >> 3), BT));
  }
  template <class Code, bool WHOLE>
  __device__ __forceinline__ void widen(uint8_t* own, int rel0, unsigned live, int lane) const {
    const int mm = lane >> 3;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const int row = (lane & 7) + 8 * j;
      uint4 lo, hi;
      Code::widen4(c[j].x, lo.x, lo.y);
      Code::widen4(c[j].y, lo.z, lo.w);
      Code::widen4(c[j].z, hi.x, hi.y);
      Code::widen4(c[j].w, hi.z, hi.w);
      if (!WHOLE && (unsigned)(rel0 + row) >= live) lo = hi = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(own + hopper::sw128_offset(row, 2 * mm, BT)) = lo;
      *reinterpret_cast<uint4*>(own + hopper::sw128_offset(row, 2 * mm + 1, BT)) = hi;
    }
  }
};

// Where a consumer warp finds tile t's bf16 K and V. The ring's tiles are
// read in place, and the stage is released after P V.
template <int D>
struct RingTiles {
  static constexpr bool SCALED = false;
  static constexpr int STAGES = Ring<D>::STAGES;
  uint8_t* smem;

  __device__ __forceinline__ uint64_t* full() const { return full_bars<Ring<D>>(smem); }
  __device__ __forceinline__ uint32_t k_tile(int t, int, unsigned, int) {
    return hopper::smem_u32(smem + Ring<D>::K + (t % STAGES) * Ring<D>::TILE);
  }
  __device__ __forceinline__ uint32_t v_tile(int t, int, unsigned, int) {
    return hopper::smem_u32(smem + Ring<D>::V + (t % STAGES) * Ring<D>::TILE);
  }
  // The warp read the stage through the generic proxy (ldmatrix); the next
  // TMA load writes it through the async proxy. Without this fence a
  // release can let that write land under the reads (measured: 14 of 100
  // runs wrong at three blocks an SM).
  __device__ __forceinline__ void done(int t, int lane) {
    hopper::fence_async_smem();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty_bars<Ring<D>>(smem)[t % STAGES]);
  }
};

// A quantized ring's tiles: the warp widens the K codes into its own bf16
// tile, with the stage's scales into registers (ks / vs by n8 tile of
// keys), then the V codes into the same tile, and releases the stage
// before P V.
template <int D, class Code>
struct CodeTiles {
  static constexpr bool SCALED = true;
  static constexpr int STAGES = QRing<D>::STAGES;
  uint8_t* smem;
  uint8_t* own;
  float ks[BT / 8], vs[BT / 8];

  __device__ __forceinline__ uint64_t* full() const { return full_bars<QRing<D>>(smem); }
  __device__ __forceinline__ uint32_t k_tile(int t, int rel0, unsigned live, int lane) {
    const int st = t % STAGES;
    const float* sc = q_scales<D>(smem) + st * 2 * (BT / 8);
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      ks[n] = sc[n];
      vs[n] = sc[BT / 8 + n];
    }
    widen_tile<D, Code>(smem + QRing<D>::K + st * QRing<D>::TILE, own, rel0, live, lane);
    __syncwarp();
    return hopper::smem_u32(own);
  }
  __device__ __forceinline__ uint32_t v_tile(int t, int rel0, unsigned live, int lane) {
    const int st = t % STAGES;
    __syncwarp();   // every lane's ldmatrix of the K tile is done
    widen_tile<D, Code>(smem + QRing<D>::V + st * QRing<D>::TILE, own, rel0, live, lane);
    hopper::fence_async_smem();   // as RingTiles::done: TMA rewrites the codes next
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty_bars<QRing<D>>(smem)[st]);
    return hopper::smem_u32(own);
  }
  __device__ __forceinline__ void done(int, int) {}
};

// Where consume_d256's warp w finds its 64-column chunk of tile t's K and V
// in the bf16 ring: read in place, and the stage released after P V.
struct RingChunks {
  using R = Ring<256>;
  static constexpr bool SCALED = false;
  static constexpr int STAGES = R::STAGES;
  uint8_t* smem;
  float ks[2], vs[2];   // unused: no scales

  __device__ __forceinline__ uint64_t* full() const { return full_bars<R>(smem); }
  __device__ __forceinline__ uint8_t* xchg() const { return smem + R::XCHG; }
  __device__ __forceinline__ uint32_t k_chunk(int t, int w, int, unsigned, int) {
    return hopper::smem_u32(smem + R::K + (t % STAGES) * R::TILE + w * BT * 128);
  }
  __device__ __forceinline__ uint32_t v_chunk(int t, int w, int, unsigned, int) {
    return hopper::smem_u32(smem + R::V + (t % STAGES) * R::TILE + w * BT * 128);
  }
  // As RingTiles::done: the proxy fence before the release.
  __device__ __forceinline__ void done(int t, int lane) {
    hopper::fence_async_smem();
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty_bars<R>(smem)[t % STAGES]);
  }
};

// The same over a head_dim 256 code ring: warp w's chunk of the bf16 K and
// V stages that the widening warpgroup filled for tile t, with the K and V
// scales of its two 8-key groups (keys 16 w .. + 15, the slice of S it sums
// and of P it forms) from the K stage's slots into registers. The K stage
// goes back to the wideners once the scores are read (v_chunk), where the
// warp then waits for the V stage; the V stage goes back after P V. The
// wideners write both with ordinary stores, so a release needs no proxy
// fence.
struct WideChunks {
  using R = QRing<256>;
  static constexpr bool SCALED = true;
  static constexpr int STAGES = R::KSTAGES;   // the walk's full barriers: K's
  uint8_t* smem;
  WideBars bars;
  float ks[2], vs[2];

  __device__ __forceinline__ uint64_t* full() const { return bars.kfull; }
  __device__ __forceinline__ uint8_t* xchg() const { return smem + R::XCHG; }
  __device__ __forceinline__ uint32_t k_chunk(int t, int w, int, unsigned, int) {
    const int st = t % R::KSTAGES;
    const float* sc = wide_scales(smem) + st * 2 * (BT / 8);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      ks[u] = sc[2 * w + u];
      vs[u] = sc[BT / 8 + 2 * w + u];
    }
    return hopper::smem_u32(smem + R::WK + st * R::WTILE + w * BT * 128);
  }
  __device__ __forceinline__ uint32_t v_chunk(int t, int w, int, unsigned, int lane) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&bars.kempty[t % R::KSTAGES]);
    hopper::mbar_wait(&bars.vfull[t % R::VSTAGES], (t / R::VSTAGES) & 1);
    return hopper::smem_u32(smem + R::WV + (t % R::VSTAGES) * R::WTILE + w * BT * 128);
  }
  __device__ __forceinline__ void done(int t, int lane) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&bars.vempty[t % R::VSTAGES]);
  }
};

// The consumer warps' whole part for the cell (s, h, b) = blockIdx at head
// dim 64 or 128: walk `ntiles` tiles whose first key is at position
// `first`, keeping positions in [lo, hi), then merge and write. MT m16
// tiles of group rows (G <= 16 * MT). SPLIT = false writes the normalised row to `out`;
// SPLIT = true writes (acc, m, l) of split s (of gridDim.x). `tiles`
// (RingTiles or CodeTiles) gives each tile's bf16 K and V in shared memory
// and, when SCALED, the K and V scales of its 8-key groups; `smem` is the
// ring's base, which holds the warps' states for the merge after the walk.
template <int D, int MT, bool SPLIT, class Tiles>
__device__ __forceinline__ void consume_tiles(Tiles& tiles, uint8_t* smem,
                                              const __nv_bfloat16* __restrict__ q,
                                              __nv_bfloat16* __restrict__ out,
                                              float* __restrict__ acc_out,
                                              float* __restrict__ m_out,
                                              float* __restrict__ l_out, int Hkv, int G,
                                              int first, int lo, int hi, int ntiles,
                                              float scale, float softcap) {
  using namespace hopper;
  static_assert(D == 64 || D == 128, "consume_d256 takes head_dim 256");
  constexpr int STAGES = Tiles::STAGES;
  constexpr int KS = CONSUMER_WARPS / MT;   // tiles in the products at once
  constexpr int ROWS = 16 * MT;             // group rows, padded
  // Each stage then feeds one warp of each m16 tile, which waits on every
  // phase of it in turn: a parity wait never meets a phase two ahead.
  static_assert(STAGES % KS == 0, "a stage must belong to one warp per m16 tile");
  uint64_t* full = tiles.full();
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Consumer warp (mt, ks): group rows 16 mt .. + 15 over tiles ks, ks +
  // KS, ks + 2 KS, ...: KS tiles are in the products at once. This thread
  // holds rows r0 = 16 mt + lane / 4 and r0 + 8, and of every 8 keys (or
  // columns) the two at 2 (lane % 4).
  const int mt = warp % MT;
  const int ks = warp / MT;
  const int Hq = Hkv * G;
  const int r0 = 16 * mt + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)h * G) * D;
  uint32_t qa[D / 16][4];   // A fragments of q, k16 step kc
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1);
      const int col = kc * 16 + c2 + 8 * (i >> 1);
      qa[kc][i] = row < G ? *reinterpret_cast<const uint32_t*>(qh + (size_t)row * D + col) : 0u;
    }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F};
  float l[2] = {0.f, 0.f};   // this thread's part of each row's sum
  const float scale2 = scale * LOG2E;
  // lo <= pos < hi in one unsigned compare: pos - lo wraps past hi - lo
  // below lo (the walk runs only when hi > lo).
  const unsigned live = (unsigned)(hi - lo);

  for (int t = ks; t < ntiles; t += KS) {
    const int rel0 = first + t * BT - lo;   // the tile's first key, from lo
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    const uint32_t kbase = tiles.k_tile(t, rel0, live, lane);

    // S = q K^T: n8 tile n holds keys lo + rel0 + 8 n ...; one ldmatrix.x4
    // gives the B fragments of two n8 tiles at one k16 step.
    float sc[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int np = 0; np < BT / 16; ++np) {
        const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t kb[4];
        ldmatrix_x4(kb, kbase + sw128_offset(row, 2 * kc + ((lane >> 3) & 1), BT));
        mma_bf16_16816(sc[2 * np], qa[kc], kb[0], kb[1]);
        mma_bf16_16816(sc[2 * np + 1], qa[kc], kb[2], kb[3]);
      }

    // Scores in log2 units; a position outside [lo, hi) is masked to
    // exactly NEG_INF_F (no live score comes near it) and gets p = 0. The
    // softcap stays tanhf here (the header comment says why).
    float mx[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float y = sc[n][i];
        if constexpr (Tiles::SCALED) y *= tiles.ks[n];
        float x = softcap > 0.f ? softcap * tanhf(y * scale / softcap) * LOG2E : y * scale2;
        x = (unsigned)(rel0 + 8 * n + c2 + (i & 1)) < live ? x : NEG_INF_F;
        sc[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }

    // P in bf16 as the A fragments of P V: k16 step kk is n8 tiles 2 kk and
    // 2 kk + 1 of S. The row sum takes P unrounded. SCALED: P times the V
    // scales (0 where masked, by select), whose bf16 remainder goes to pl.
    uint32_t pa[BT / 16][4];
    [[maybe_unused]] uint32_t pl[BT / 16][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      float e[2][4];
      [[maybe_unused]] float r[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = sc[2 * kk + u][i];
          const float pv = x == NEG_INF_F ? 0.f : fast_exp2(x - m[i >> 1]);
          sum[i >> 1] += pv;
          if constexpr (Tiles::SCALED) {
            e[u][i] = x == NEG_INF_F ? 0.f : pv * tiles.vs[2 * kk + u];
            r[u][i] = e[u][i] - __bfloat162float(__float2bfloat16(e[u][i]));
          } else {
            e[u][i] = pv;
          }
        }
      pa[kk][0] = pack_bf16(e[0][0], e[0][1]);
      pa[kk][1] = pack_bf16(e[0][2], e[0][3]);
      pa[kk][2] = pack_bf16(e[1][0], e[1][1]);
      pa[kk][3] = pack_bf16(e[1][2], e[1][3]);
      if constexpr (Tiles::SCALED) {
        pl[kk][0] = pack_bf16(r[0][0], r[0][1]);
        pl[kk][1] = pack_bf16(r[0][2], r[0][3]);
        pl[kk][2] = pack_bf16(r[1][0], r[1][1]);
        pl[kk][3] = pack_bf16(r[1][2], r[1][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];

    // O += P V: one ldmatrix.x4.trans gives the B fragments of two n8
    // column tiles (16 columns) over 16 keys.
    const uint32_t vbase = tiles.v_tile(t, rel0, live, lane);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int row = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int seg = 2 * dp + (lane >> 4);
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vbase + sw128_offset(row, seg, BT));
        mma_bf16_16816(o[2 * dp], pa[kk], vb[0], vb[1]);
        mma_bf16_16816(o[2 * dp + 1], pa[kk], vb[2], vb[3]);
        if constexpr (Tiles::SCALED) {
          mma_bf16_16816(o[2 * dp], pl[kk], vb[0], vb[1]);
          mma_bf16_16816(o[2 * dp + 1], pl[kk], vb[2], vb[3]);
        }
      }
    tiles.done(t, lane);
  }

  // Merge the KS warps' states of each group row through shared memory (the
  // ring is idle once every consumer is past its last tile).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* part = reinterpret_cast<float*>(smem);   // [KS][ROWS][D]
  float* pm = part + KS * ROWS * D;               // [KS][ROWS]
  float* pl = pm + KS * ROWS;
  named_barrier_sync(1, 32 * CONSUMER_WARPS);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(part + ((size_t)ks * ROWS + r0 + 8 * r) * D + 8 * n + c2) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pm[ks * ROWS + r0 + 8 * r] = m[r];
      pl[ks * ROWS + r0 + 8 * r] = l[r];
    }
  }
  named_barrier_sync(1, 32 * CONSUMER_WARPS);
  for (int idx = threadIdx.x; idx < G * D; idx += 32 * CONSUMER_WARPS) {
    const int g = idx / D;
    const int d = idx - g * D;
    float m_star = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < KS; ++j) m_star = fmaxf(m_star, pm[j * ROWS + g]);
    float l_star = 0.f, a_star = 0.f;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const float w = fast_exp2(pm[j * ROWS + g] - m_star);
      l_star += pl[j * ROWS + g] * w;
      a_star += part[((size_t)j * ROWS + g) * D + d] * w;
    }
    if (SPLIT) {
      const size_t cell = (((size_t)b * Hkv + h) * gridDim.x + s) * G + g;
      acc_out[cell * D + d] = a_star;
      if (d == 0) {
        m_out[cell] = l_star == 0.f ? NEG_INF_F : m_star * LN2;
        l_out[cell] = l_star;
      }
    } else {
      out[((size_t)b * Hq + (size_t)h * G + g) * D + d] =
          __float2bfloat16(a_star / (l_star == 0.f ? 1.f : l_star));
    }
  }
}

// The head_dim 256 consumer (the header comment): the cell (s, h, b) =
// blockIdx, `ntiles` tiles from position `first`, positions in [lo, hi)
// kept, MT m16 tiles of group rows; writes as consume_tiles does. `tiles`
// (RingChunks or WideChunks) gives each warp its 64-column chunk of each
// tile's bf16 K and V in shared memory and, when SCALED, the K and V scales
// of its 16 keys' two 8-key groups.
template <int MT, bool SPLIT, class Chunks>
__device__ __forceinline__ void consume_d256(Chunks& tiles, const __nv_bfloat16* __restrict__ q,
                                             __nv_bfloat16* __restrict__ out,
                                             float* __restrict__ acc_out,
                                             float* __restrict__ m_out,
                                             float* __restrict__ l_out, int Hkv, int G,
                                             int first, int lo, int hi, int ntiles,
                                             float scale, float softcap) {
  using namespace hopper;
  constexpr int D = 256;
  constexpr int DW = D / CONSUMER_WARPS;   // D's columns of a warp: 64, one chunk
  constexpr int STAGES = Chunks::STAGES;
  static_assert(MT <= Xchg::MAX_MT, "the exchange holds two m16 tiles");
  uint64_t* full = tiles.full();
  uint8_t* xchg = tiles.xchg();
  float* xs = reinterpret_cast<float*>(xchg + Xchg::S);     // [warp][row][key]
  uint4* xp = reinterpret_cast<uint4*>(xchg + Xchg::P);     // [mt][kk][lane]
  float* xm = reinterpret_cast<float*>(xchg + Xchg::MX);    // [warp][mt][row]
  float* xl = reinterpret_cast<float*>(xchg + Xchg::L);     // [warp][mt][row]
  [[maybe_unused]] uint4* xpl = reinterpret_cast<uint4*>(xchg + QXchg::PL);   // as xp
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = lane >> 2;        // this thread's rows r0 and r0 + 8 of each m16 tile
  const int c2 = 2 * (lane & 3);   // and of every 8 keys (or columns) the two at c2
  const int Hq = Hkv * G;
  const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)h * G) * D;

  uint32_t qa[MT][DW / 16][4];   // A fragments of q's columns 64 w .. + 63
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kc = 0; kc < DW / 16; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * mt + r0 + 8 * (i & 1);
        const int col = DW * w + kc * 16 + c2 + 8 * (i >> 1);
        qa[mt][kc][i] =
            row < G ? *reinterpret_cast<const uint32_t*>(qh + (size_t)row * D + col) : 0u;
      }
  float o[MT][DW / 8][4];   // O's columns 64 w .. + 63
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < DW / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][n][i] = 0.f;
  float m[MT][2], l[MT][2];   // l: this thread's part of its key slice's row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      m[mt][k] = NEG_INF_F;
      l[mt][k] = 0.f;
    }
  const float scale2 = scale * LOG2E;
  const Softcap cap(scale, softcap);
  const unsigned live = (unsigned)(hi - lo);   // as consume_tiles

  for (int t = 0; t < ntiles; ++t) {
    const int rel0 = first + t * BT - lo;   // the tile's first key, from lo
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    const uint32_t kbase = tiles.k_chunk(t, w, rel0, live, lane);   // column chunk w

    // x: this warp's key slice 16 w .. + 15 of S (n8 tiles u = 0, 1), in
    // log2 units and masked; mx its row maxima.
    float x[MT][2][4], mx[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt > 0) named_barrier_sync(1, 32 * CONSUMER_WARPS);   // the last sums are read
      // The partial S over q's columns 64 w .. + 63 for all 64 keys: n8
      // tile n holds keys 8 n ..; one ldmatrix.x4 gives the B fragments of
      // two n8 tiles at one k16 step of column chunk w.
      float sc[BT / 8][4];
#pragma unroll
      for (int n = 0; n < BT / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DW / 16; ++kc)
#pragma unroll
        for (int np = 0; np < BT / 16; ++np) {
          const int row = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          uint32_t kb[4];
          ldmatrix_x4(kb, kbase + sw128_offset(row, 2 * kc + ((lane >> 3) & 1), BT));
          mma_bf16_16816(sc[2 * np], qa[mt][kc], kb[0], kb[1]);
          mma_bf16_16816(sc[2 * np + 1], qa[mt][kc], kb[2], kb[3]);
        }
#pragma unroll
      for (int n = 0; n < BT / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(xs + (w * 16 + r0 + 8 * r) * Xchg::SROW + 8 * n + c2) =
              make_float2(sc[n][2 * r], sc[n][2 * r + 1]);
      named_barrier_sync(1, 32 * CONSUMER_WARPS);
      // This warp's keys: the four partial sums added in warp order, then
      // (SCALED) times their pages' K scales, in log2 units and masked, the
      // loop with a softcap written apart (as K1's SOFTCAP is) so that rows
      // without one run none of it.
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int at = (r0 + 8 * r) * Xchg::SROW + 16 * w + 8 * u + c2;
          float2 v = *reinterpret_cast<const float2*>(xs + at);
#pragma unroll
          for (int j = 1; j < CONSUMER_WARPS; ++j) {
            const float2 pj = *reinterpret_cast<const float2*>(xs + j * 16 * Xchg::SROW + at);
            v.x += pj.x;
            v.y += pj.y;
          }
          x[mt][u][2 * r] = v.x;
          x[mt][u][2 * r + 1] = v.y;
        }
      mx[mt][0] = mx[mt][1] = NEG_INF_F;
      auto scores = [&](auto capped) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float y = x[mt][u][i];
            if constexpr (Chunks::SCALED) y *= tiles.ks[u];
            float sx = log2_score<decltype(capped)::value>(y, scale2, cap);
            sx = (unsigned)(rel0 + 16 * w + 8 * u + c2 + (i & 1)) < live ? sx : NEG_INF_F;
            x[mt][u][i] = sx;
            mx[mt][i >> 1] = fmaxf(mx[mt][i >> 1], sx);
          }
      };
      if (softcap > 0.f)
        scores(std::true_type{});
      else
        scores(std::false_type{});
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[mt][r] = fmaxf(mx[mt][r], __shfl_xor_sync(0xffffffffu, mx[mt][r], 1));
        mx[mt][r] = fmaxf(mx[mt][r], __shfl_xor_sync(0xffffffffu, mx[mt][r], 2));
        if ((lane & 3) == 0) xm[(w * Xchg::MAX_MT + mt) * 16 + r0 + 8 * r] = mx[mt][r];
      }
    }
    const uint32_t vbase = tiles.v_chunk(t, w, rel0, live, lane);   // column chunk w
    named_barrier_sync(1, 32 * CONSUMER_WARPS);

    // The tile's row maxima, the new m, and this warp's slice of P (the A
    // fragment of P V's k16 step w; the row sums take P unrounded and, when
    // SCALED, unscaled: P V takes P times the V scales, by select, as its
    // bf16 rounding and the remainder's).
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float e[2][4], sum[2] = {0.f, 0.f};
      [[maybe_unused]] float rem[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tm = m[mt][r];
#pragma unroll
        for (int j = 0; j < CONSUMER_WARPS; ++j)
          tm = fmaxf(tm, xm[(j * Xchg::MAX_MT + mt) * 16 + r0 + 8 * r]);
        alpha[mt][r] = fast_exp2(m[mt][r] - tm);
        m[mt][r] = tm;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xi = x[mt][u][i];
          const float pv = xi == NEG_INF_F ? 0.f : fast_exp2(xi - m[mt][i >> 1]);
          sum[i >> 1] += pv;
          if constexpr (Chunks::SCALED) {
            e[u][i] = xi == NEG_INF_F ? 0.f : pv * tiles.vs[u];
            rem[u][i] = e[u][i] - __bfloat162float(__float2bfloat16(e[u][i]));
          } else {
            e[u][i] = pv;
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[mt][r] + sum[r];
      xp[(mt * 4 + w) * 32 + lane] =
          make_uint4(pack_bf16(e[0][0], e[0][1]), pack_bf16(e[0][2], e[0][3]),
                     pack_bf16(e[1][0], e[1][1]), pack_bf16(e[1][2], e[1][3]));
      if constexpr (Chunks::SCALED)
        xpl[(mt * 4 + w) * 32 + lane] =
            make_uint4(pack_bf16(rem[0][0], rem[0][1]), pack_bf16(rem[0][2], rem[0][3]),
                       pack_bf16(rem[1][0], rem[1][1]), pack_bf16(rem[1][2], rem[1][3]));
    }
    named_barrier_sync(1, 32 * CONSUMER_WARPS);

    // O = alpha O + P V over this warp's columns: one ldmatrix.x4.trans
    // gives the B fragments of two n8 column tiles (16 columns) over 16
    // keys.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < DW / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[mt][n][i] *= alpha[mt][i >> 1];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t pa[MT][4];
      [[maybe_unused]] uint32_t pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 pk = xp[(mt * 4 + kk) * 32 + lane];
        pa[mt][0] = pk.x;
        pa[mt][1] = pk.y;
        pa[mt][2] = pk.z;
        pa[mt][3] = pk.w;
        if constexpr (Chunks::SCALED) {
          const uint4 pr = xpl[(mt * 4 + kk) * 32 + lane];
          pl[mt][0] = pr.x;
          pl[mt][1] = pr.y;
          pl[mt][2] = pr.z;
          pl[mt][3] = pr.w;
        }
      }
#pragma unroll
      for (int dp = 0; dp < DW / 16; ++dp) {
        const int row = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int seg = 2 * dp + (lane >> 4);
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vbase + sw128_offset(row, seg, BT));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(o[mt][2 * dp], pa[mt], vb[0], vb[1]);
          mma_bf16_16816(o[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
          if constexpr (Chunks::SCALED) {
            mma_bf16_16816(o[mt][2 * dp], pl[mt], vb[0], vb[1]);
            mma_bf16_16816(o[mt][2 * dp + 1], pl[mt], vb[2], vb[3]);
          }
        }
      }
    }
    tiles.done(t, lane);
  }

  // Each warp's key slices' row sums, added in warp order.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      if ((lane & 3) == 0) xl[(w * Xchg::MAX_MT + mt) * 16 + r0 + 8 * r] = lr;
    }
  named_barrier_sync(1, 32 * CONSUMER_WARPS);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = 16 * mt + r0 + 8 * r;
      float l_star = xl[mt * 16 + r0 + 8 * r];
#pragma unroll
      for (int j = 1; j < CONSUMER_WARPS; ++j)
        l_star += xl[(j * Xchg::MAX_MT + mt) * 16 + r0 + 8 * r];
      if (g >= G) continue;
      if (SPLIT) {
        const size_t cell = (((size_t)b * Hkv + h) * gridDim.x + s) * G + g;
#pragma unroll
        for (int n = 0; n < DW / 8; ++n)
          *reinterpret_cast<float2*>(acc_out + cell * D + DW * w + 8 * n + c2) =
              make_float2(o[mt][n][2 * r], o[mt][n][2 * r + 1]);
        if (w == 0 && (lane & 3) == 0) {
          m_out[cell] = l_star == 0.f ? NEG_INF_F : m[mt][r] * LN2;
          l_out[cell] = l_star;
        }
      } else {
        const float den = l_star == 0.f ? 1.f : l_star;
        __nv_bfloat16* orow = out + ((size_t)b * Hq + (size_t)h * G + g) * D + DW * w + c2;
#pragma unroll
        for (int n = 0; n < DW / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
              __floats2bfloat162_rn(o[mt][n][2 * r] / den, o[mt][n][2 * r + 1] / den);
      }
    }
}

// The consumer over the bf16 ring (K7/K8, K3/K4).
template <int D, int MT, bool SPLIT>
__device__ __forceinline__ void consume(uint8_t* smem, const __nv_bfloat16* __restrict__ q,
                                        __nv_bfloat16* __restrict__ out,
                                        float* __restrict__ acc_out, float* __restrict__ m_out,
                                        float* __restrict__ l_out, int Hkv, int G, int first,
                                        int lo, int hi, int ntiles, float scale,
                                        float softcap) {
  if constexpr (D == 256) {
    RingChunks tiles{smem};
    consume_d256<MT, SPLIT>(tiles, q, out, acc_out, m_out, l_out, Hkv, G, first, lo, hi, ntiles,
                            scale, softcap);
  } else {
    RingTiles<D> tiles{smem};
    consume_tiles<D, MT, SPLIT>(tiles, smem, q, out, acc_out, m_out, l_out, Hkv, G, first, lo,
                                hi, ntiles, scale, softcap);
  }
}

}  // namespace dtc
}  // namespace rt
