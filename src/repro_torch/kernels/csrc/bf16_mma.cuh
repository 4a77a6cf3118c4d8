// Tensor-core helpers shared by the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): `ldmatrix` loads from
// shared memory and the `mma.sync` m16n8k16 bf16 product with fp32
// accumulation.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 (row-major): a[0] (g, 2t..2t+1), a[1] (g+8, 2t..), a[2] (g, 2t+8..),
//                        a[3] (g+8, 2t+8..)
//   B 16x8 (col-major):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C 16x8:              c[0..1] (g, 2t..2t+1), c[2..3] (g+8, 2t..2t+1)
// so the accumulators of two neighbouring 8-column n-tiles are exactly the
// A fragment of one 16-deep k-step of the next product.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_mma {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major bf16
// matrix in shared memory with row pitch `ld` elements.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* m, int r0, int c0,
                                       int ld, int lane) {
  ldmatrix_x4(a, m + (r0 + lane % 16) * ld + c0 + (lane / 16) * 8);
}

// B fragments of X Y^T with Y row-major (n, k) in shared memory: rows
// n0..n0+7 of Y, k-steps at c0 and c0 + 16 -> r[0..1], r[2..3].
__device__ __forceinline__ void load_b_nt(uint32_t (&r)[4],
                                          const __nv_bfloat16* m, int n0,
                                          int c0, int ld, int lane) {
  ldmatrix_x4(r, m + (n0 + lane % 8) * ld + c0 + (lane / 8) * 8);
}

// B fragments of X Y with Y row-major (k, n) in shared memory: k rows
// k0..k0+15, n-tiles at c0 and c0 + 8 -> r[0..1], r[2..3].
__device__ __forceinline__ void load_b_nn(uint32_t (&r)[4],
                                          const __nv_bfloat16* m, int k0,
                                          int c0, int ld, int lane) {
  ldmatrix_x4_trans(r, m + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + c0 +
                           (lane / 16) * 8);
}

}  // namespace repro_mma
