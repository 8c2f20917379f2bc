// Hopper (sm_90a) building blocks of the tensor-core kernels: TMA tensor
// maps (contiguous bf16 or 1-byte codes, and strided views), tile loads
// and stores, mbarriers and named barriers, wgmma shared-memory
// descriptors and instructions, the warp-level mma.sync with ldmatrix from
// swizzled tiles, and register reallocation between warpgroups.
//
// Shared-memory tiles are written by TMA with 128-byte swizzling: a tile of
// R rows by C bf16 columns is stored as C / 64 column chunks of R rows of
// 128 bytes, chunk c at byte c * R * 128, each chunk 1024-byte aligned (the
// swizzle repeats every 8 rows). wgmma reads such a chunk through a
// descriptor with layout "128-byte swizzle": K-major (rows contiguous along
// the reduction axis) with the 8-row stride 1024 bytes, or MN-major (rows
// along the reduction axis, the transpose bit set) with the 8-row stride
// 1024 bytes and the column-chunk stride R * 128 bytes.
#pragma once

#include <cuda.h>          // CUtensorMap and the CUDA driver API enums; types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {
namespace hopper {

// -- host: tensor maps ----------------------------------------------------------

// cuTensorMapEncodeTiled is a CUDA driver API function; it is looked up through the
// runtime (cudaGetDriverEntryPoint), so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Status of a failed tensor-map encoding, beside the cudaError_t codes.
constexpr int MAP_ENCODE_FAILED = -2;

// A contiguous bf16 tensor (planes, rows, cols) as a 3-D map whose box is
// 64 columns (128 bytes) by box_rows rows of one plane, 128-byte swizzled.
// A box past `rows` is zero-filled and never reads the next plane.
inline int make_map_3d(CUtensorMap* map, const void* base, int cols, int rows, int planes,
                       int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return MAP_ENCODE_FAILED;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * 2 * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ENCODE_FAILED;
}

// A contiguous tensor of 1-byte elements (planes, rows, cols), cols 64, 128
// or 256, as a 3-D map whose box is a whole row of `cols` bytes (at 256 a
// half row of 128: the 128-byte swizzle takes a box at most 128 bytes wide)
// by box_rows rows of one plane, swizzled over the box's row: 128-byte
// swizzle at 128 and 256 columns, 64-byte at 64 (the 16-byte chunk index
// XOR address bits 7 and up, so a tile must start at a multiple of 8 rows).
inline int make_map_3d_u8(CUtensorMap* map, const void* base, int cols, int rows, int planes,
                          int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr || (cols != 64 && cols != 128 && cols != 256)) return MAP_ENCODE_FAILED;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols, (cuuint64_t)cols * rows};
  const cuuint32_t box[3] = {(cuuint32_t)(cols > 128 ? 128 : cols), (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         cols >= 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ENCODE_FAILED;
}

// A bf16 tensor (batch, heads, rows, cols) with free head and batch strides
// (in elements; rows contiguous, `cols` elements apart) as a 4-D map whose
// box is 64 columns by box_rows rows of one (batch, head), 128-byte
// swizzled: a strided view, such as a stripe cut to its live width. A box
// past `rows` is zero-filled and never reads the next head's rows. The
// strides must be multiples of 8 elements (16 bytes).
inline int make_map_4d(CUtensorMap* map, const void* base, int cols, int rows, int heads,
                       int batch, long long head_stride, long long batch_stride,
                       int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return MAP_ENCODE_FAILED;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2, (cuuint64_t)head_stride * 2,
                                 (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ENCODE_FAILED;
}

// -- device: mbarriers and TMA ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the TMA unit; follow with a
// block-wide barrier before any thread uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Adds `bytes` to the transactions the phase waits for, without arriving.
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed. A phase that has
// not completed after ~10 s of clock (far beyond any tile's load) traps, so
// a barrier fault fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// One box of a 3-D map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 4-D map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 16 bytes from / to shared address `addr` (16-byte aligned).
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds32f(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to TMA (the
// async proxy); follow with a barrier over the threads that wrote.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier `id` (1 .. 15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Arrives at barrier `id` over `threads` threads without waiting: this
// thread's earlier shared-memory writes are visible to the threads that
// wait there (bar.sync) once the barrier completes.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One box of shared memory out to a 3-D map; rows past the map's extent
// are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Commits this thread's TMA stores and waits until they have read their
// shared memory (which may then be reused or released).
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// -- device: register reallocation --------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// -- device: wgmma --------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`
// (inside a 1024-byte aligned chunk): `lbo` the column-chunk stride of an
// MN-major operand (unused for K-major), `sbo` the 8-row stride.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma's issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for the bf16 A fragments of a register-A wgmma: kept intact in
// their registers until the wgmma_wait that follows the fence.
template <int M, int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define RT_D8(i)                                                                       \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),              \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define RT_D32 RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)
#define RT_D64 RT_D32, RT_D8(32), RT_D8(40), RT_D8(48), RT_D8(56)

// d (64 x 128, f32) (+)= A (64 x 16, bf16, K-major, shared) . B (16 x 128,
// bf16, K-major, shared). scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : RT_D64
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16, K-major, shared) . B (16 x 64,
// bf16, K-major, shared). scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_D32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, bf16, four registers a thread) . B (16 x N,
// bf16, MN-major in shared memory: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

#define RT_D128                                                                        \
  RT_D64, RT_D8(64), RT_D8(72), RT_D8(80), RT_D8(88), RT_D8(96), RT_D8(104), RT_D8(112),  \
      RT_D8(120)

// d (64 x 256, f32) += A (64 x 16, bf16, four registers a thread) . B (16 x
// 256, bf16, MN-major in shared memory: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n256_tb(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : RT_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

#undef RT_D128
#undef RT_D64
#undef RT_D32
#undef RT_D8

// The register-A wgmma of P V over a D-column accumulator (D / 2 floats a
// thread): m64nDk16.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_n256_tb(d, a, db);
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_n128_tb(d, a, db);
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_n64_tb(d, a, db);
}

// The shared-memory wgmma of S = Q K^T over a BN-key tile (BN / 2 floats a
// thread): m64nBNk16.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  wgmma_ss_n128(d, da, db, scale_d);
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  wgmma_ss_n64(d, da, db, scale_d);
}

// -- device: warp-level mma ----------------------------------------------------------

// Byte offset of 16-byte unit `seg` (8 bf16 columns) of row `row` in a tile
// of `rows` rows written by TMA with 128-byte swizzling (column chunks of 64
// bf16, each rows * 128 bytes, 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128_offset(int row, int seg, int rows) {
  return (uint32_t)((seg >> 3) * rows * 128 + row * 128 + (((seg & 7) ^ (row & 7)) << 4));
}

// Byte offset of 16-byte chunk m (codes 16 m .. 16 m + 15) of row `row` in
// a tile of D-byte code rows written by TMA with the row's swizzle
// (make_map_3d_u8: 128 bytes at D 128, 64 at D 64, the chunk index XOR
// address bits 7 and up). At D 256 a code row is two 128-byte boxes, laid
// out as sw128_offset's column chunks.
template <int D>
__device__ __forceinline__ uint32_t code_offset(int row, int m) {
  static_assert(D == 64 || D == 128, "head_dim 256 codes: sw128_offset");
  return (uint32_t)(row * D + ((m ^ ((row * D >> 7) & (D / 16 - 1))) << 4));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register i holds this lane's pair of matrix i
// (row lane / 4, columns 2 (lane % 4) and + 1), or with .trans of its
// transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, f32) += A (16 x 16, bf16, row-major fragment) . B (16 x 8, bf16,
// column-major fragment b0, b1) on one warp's tensor cores.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one register of two bf16, the first in the low half: the
// element order of a wgmma A fragment (and of an mma.sync one).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit: ex2.approx.ftz (about 2 ulp, subnormal
// results flushed to 0, 2^-inf = 0), what exp2f becomes under
// --use_fast_math.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x on the special-function unit: rcp.approx.ftz (about 1 ulp, 1 / inf
// = 0).
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The two constants of softcap_log2, once per launch: k = 2 log2(e) scale /
// softcap and c = softcap log2(e). The quotient is a multiply by rcp.approx,
// so no kernel carries an IEEE division's slow path for it.
struct Softcap {
  float k, c;
  __device__ __forceinline__ Softcap(float scale, float softcap)
      : k(softcap > 0.f ? 2.f * 1.4426950408889634f * scale * fast_rcp(softcap) : 0.f),
        c(softcap * 1.4426950408889634f) {}
};

// softcap * tanh(s * scale / softcap) in log2 units, from one ex2 and one
// rcp: tanh(y) = 1 - 2 / (2^(2 y log2 e) + 1), within a few float32 ulps
// of 1 of tanh. Past |y| ~ 44 the power is inf (or flushed to 0), which
// gives exactly +-1 and no NaN. (tanh.approx.f32's 2^-11 absolute error,
// times a cap of 50, would move a score by ~0.025.)
__device__ __forceinline__ float softcap_log2(float s, const Softcap& cap) {
  return cap.c * (1.f - 2.f * fast_rcp(fast_exp2(s * cap.k) + 1.f));
}

// A score s in log2 units: softcapped (CAP) or times scale2 = scale log2(e).
template <bool CAP>
__device__ __forceinline__ float log2_score(float s, float scale2, const Softcap& cap) {
  return CAP ? softcap_log2(s, cap) : s * scale2;
}

// This thread's part of a warpgroup's 64 x D float32 accumulator (rows
// tile_row and tile_row + 8 of the warpgroup's 64, scaled by mul[0] and
// mul[1]) rounded to bf16 into a 128-byte-swizzled tile at `tile` (the
// warpgroup's first row, column chunks `chunk` bytes apart): the layout a
// TMA store reads.
template <int D>
__device__ __forceinline__ void stage_tile_bf16(uint8_t* tile, int chunk,
                                                const float (&acc)[D / 2],
                                                const float (&mul)[2], int tile_row,
                                                int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = tile_row + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(tile + (j / 8) * chunk + rr * 128 +
                                         (((j % 8) ^ (rr % 8)) * 16) + 4 * (lane & 3)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul[r], acc[4 * j + 2 * r + 1] * mul[r]);
  }
}

}  // namespace hopper
}  // namespace rt
