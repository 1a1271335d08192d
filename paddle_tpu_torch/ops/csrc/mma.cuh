// Tensor-core and asynchronous-copy building blocks shared by the
// hand-written kernels (sm_80+ instructions, compiled for sm_90a):
// 16- and 4-byte cp.async with zero fill, ldmatrix (plain and
// transposed) and mma.sync m16n8k16 bf16 -> f32.
//
// Fragment layout of mma.m16n8k16 (lane = 4g + t):
//   A (16 x 16, row-major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
//     2t+8..), a3 = (g+8, 2t+8..);
//   B (16 x 8) b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
//   C (16 x 8) c0, c1 = (g, 2t), (g, 2t+1); c2, c3 = (g+8, 2t), (g+8, 2t+1).
// The C fragments of two neighbouring 8-column tiles, packed to bf16
// pairs, are the A fragment of the next product over those 16 columns.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace ptt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; the bytes past `src_bytes`
// (0 or 16) are written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared (through L1); `src_bytes` 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and r[i] receives row g, columns 2t..2t+1 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, transposed: r[i] receives rows 2t..2t+1, column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo in the low half, hi in the high half, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane address offsets for ldmatrix_x4 over a 16 x 16 block of a
// row-major tile: (row, column) of the 8-element row this lane points at.
//   a_order: matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
//     (8-15, 8-15) -> the A fragment; with .trans over a [k][n] tile, the
//     B fragments (b0, b1) of n-tile 0 then of n-tile 1;
//   b_order: (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) -> over an
//     [n][k] tile without .trans, (b0, b1) of n-tile 0 then of n-tile 1.
__device__ __forceinline__ int ldm_row_a(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int ldm_col_a(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int ldm_row_b(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int ldm_col_b(int lane) {
  return ((lane >> 3) & 1) * 8;
}

}  // namespace ptt
