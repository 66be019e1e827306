// Warp-level tensor-core building blocks for the relative_key flash kernels
// (flash_rel_fwd.cu, flash_rel_bwd.cu): cp.async tile copies, ldmatrix
// fragment loads and the bf16 mma.sync.m16n8k16 with fp32 accumulators.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16×16, row major)  a0 (g, 2c..2c+1)   a1 (g+8, 2c..)
//                         a2 (g, 2c+8..)     a3 (g+8, 2c+8..)
//   B (16×8)              b0 (k 2c..2c+1, n g)   b1 (k 2c+8.., n g)
//   C (16×8, fp32)        c0, c1 (g, 2c..2c+1)   c2, c3 (g+8, 2c..2c+1)
// so the C fragments of two neighbouring n-tiles, rounded to bf16, are the A
// fragment of one k-step (acc_to_a): the FlashAttention-2 register hand-off
// from a score tile to the next product.
//
// Shared-memory tiles are row major with a row stride of (cols + 8) bf16
// elements: 16 bytes of padding put the eight 16-byte rows that one ldmatrix
// phase reads in eight different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ste_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global → shared copy; bytes past `src_bytes` (0 or 16) are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8×8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a·b, bf16 operands, fp32 accumulate
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A fragment (16 rows × 16 k) of a row-major [m][k] bf16 tile at `base`
// (pointing at row 0, column k0), row stride `ld` elements
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* base,
                                       int ld, int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = (lane >> 4) * 8;
  ldsm_x4(a, base + row * ld + col);
}

// B fragments of two n-tiles (16 n × 16 k) from an [n][k] row-major tile
// (the transposed operand, e.g. K for q·kᵀ): b[0..1] n-tile 0, b[2..3] 1
__device__ __forceinline__ void load_b_nk(uint32_t* b,
                                          const __nv_bfloat16* base, int ld,
                                          int lane) {
  const int row = (lane & 7) + (lane >> 4) * 8;
  const int col = ((lane >> 3) & 1) * 8;
  ldsm_x4(b, base + row * ld + col);
}

// B fragments of two n-tiles (16 k × 16 n) from a [k][n] row-major tile
// (e.g. V for p·v): b[0..1] n-tile 0, b[2..3] n-tile 1
__device__ __forceinline__ void load_b_kn(uint32_t* b,
                                          const __nv_bfloat16* base, int ld,
                                          int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = (lane >> 4) * 8;
  ldsm_x4_t(b, base + row * ld + col);
}

// the A fragment of k-step kk from the fp32 C fragments c[n-tile][4],
// each value rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// copy a [ROWS][COLS] bf16 tile (global row stride COLS) into shared memory
// with row stride COLS + 8, 16 bytes per cp.async, by THREADS threads; rows
// at or past `valid_rows` are zero-filled
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void tile_to_smem(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int valid_rows, int tid) {
  constexpr int kChunks = COLS / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "whole passes only");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
    const int idx = it * THREADS + tid;
    const int r = idx / kChunks, ch = idx % kChunks;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * (COLS + 8) + ch * 8,
               src + (ok ? r : 0) * COLS + ch * 8, ok);
  }
}

}  // namespace ste_mma
