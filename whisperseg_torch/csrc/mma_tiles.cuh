// Tile helpers for bf16 products on the tensor cores with mma.sync
// (m16n8k16, float32 accumulators), fed by ldmatrix from shared memory and
// by cp.async 16-byte copies from device memory.
//
// Fragment layouts of mma.m16n8k16 for one warp, lane = 4 * gr + tg
// (gr = lane / 4, tg = lane % 4), each 32-bit register two bf16 of
// neighbouring columns, the lower column in the low half:
//   A (16 x 16, row major): a0 (row gr, cols 2tg, 2tg+1), a1 (row gr + 8,
//     the same cols), a2 (row gr, cols 8 + 2tg, +1), a3 (row gr + 8, those);
//   B (16 x 8, k x n): b0 (k 2tg, 2tg+1; n gr), b1 (k 8 + 2tg, +1; n gr);
//   C (16 x 8, float32): c0, c1 (row gr, cols 2tg, 2tg+1), c2, c3 (row
//     gr + 8, the same cols).
// So the C fragments of two neighbouring n tiles, rounded and packed, are
// the A fragment of a product whose k runs over those 16 columns: c0c1 and
// c2c3 of the first tile give a0, a1, those of the second a2, a3.
//
// ldmatrix x4 loads four 8 x 8 bf16 matrices; lane l gives the address of
// row l % 8 of matrix l / 8, and register j receives matrix j's (row gr,
// cols 2tg, 2tg+1), or with .trans its (rows 2tg, 2tg+1; col gr). The
// ldsm_* functions below pick those row addresses for one 16 x 16 tile of
// a row-major shared array with row stride ld (bf16 elements):
//   ldsm_a:       the tile is an A operand as stored;
//   ldsm_a_trans: the array holds A^T (A's rows are its columns);
//   ldsm_b:       the array holds B^T: n rows of k, two n tiles (regs 0-1
//                 and 2-3 are b0, b1 of n tiles 0-7 and 8-15);
//   ldsm_b_trans: the array holds B as k rows of n, two n tiles.
// A row stride of 16 bytes more than a multiple of 128 puts the eight rows
// of each 8 x 8 matrix in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tiles {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, bypassing L1.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The 16 x 16 tile at (row0, col0) of an array with row stride ld.
__device__ __forceinline__ void ldsm_a(uint32_t r[4], const __nv_bfloat16* base,
                                       int ld, int row0, int col0, int lane) {
  const int i = lane % 8, m = lane / 8;
  ldmatrix_x4(r, base + (row0 + i + (m % 2) * 8) * ld + col0 + (m / 2) * 8);
}
__device__ __forceinline__ void ldsm_a_trans(uint32_t r[4],
                                             const __nv_bfloat16* base, int ld,
                                             int row0, int col0, int lane) {
  const int i = lane % 8, m = lane / 8;
  ldmatrix_x4_trans(r, base + (row0 + i + (m / 2) * 8) * ld + col0 + (m % 2) * 8);
}
__device__ __forceinline__ void ldsm_b(uint32_t r[4], const __nv_bfloat16* base,
                                       int ld, int row0, int col0, int lane) {
  const int i = lane % 8, m = lane / 8;
  ldmatrix_x4(r, base + (row0 + i + (m / 2) * 8) * ld + col0 + (m % 2) * 8);
}
__device__ __forceinline__ void ldsm_b_trans(uint32_t r[4],
                                             const __nv_bfloat16* base, int ld,
                                             int row0, int col0, int lane) {
  const int i = lane % 8, m = lane / 8;
  ldmatrix_x4_trans(r, base + (row0 + i + (m % 2) * 8) * ld + col0 + (m / 2) * 8);
}

// c += a b on the tensor cores: bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tiles
