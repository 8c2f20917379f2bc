// 3xTF32 products on Hopper's tensor cores and the cp.async copies that feed
// them: shared by K9 (csrc/ssd.cu) and the float32 K5 / K6
// (csrc/flash_attention_bwd.cu).
//
// TF32 keeps 10 mantissa bits, so each float32 operand is split into hi =
// tf32(x) and lo = tf32(x - hi) (cvt.rna both times: the tensor core ignores
// the low 13 bits of a raw float32, so the hi it would use is not the one lo
// was taken from), and each product is lo hi' + hi lo' + hi hi', accumulated
// in float32 by mma.sync m16n8k8: about 22 bits a product, at a third of the
// TF32 rate. mma.sync and not wgmma: wgmma takes tf32 operands K-major only,
// and a product that contracts over the rows of an operand would need that
// operand transposed in staging; mma.sync fragments load from either layout
// with ld.shared.
#pragma once

#include "common.cuh"

namespace rt {

// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest (ties away).
// The mask keeps hi exactly the value the tensor core reads, whatever the
// conversion leaves in the low 13 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
  hi = h & 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small cross terms first, then hi hi'.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// 16 bytes from global to shared memory, or 16 zero bytes where !live (the
// source is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;"); }

}  // namespace rt
