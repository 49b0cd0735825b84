// Warp-level tensor-core building blocks shared by the bf16 kernels
// (flash_fwd.cu, flash_bwd.cu through attn_mma.cuh, and conv1x1_bwd.cu):
// inline PTX for sm_80+ mma.sync, ldmatrix and cp.async, and the
// fragment loaders of a row-major shared-memory tile of any row stride.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
// the f32 accumulator holds (row g, cols 2t, 2t+1) in c[0], c[1] and
// (row g + 8, the same cols) in c[2], c[3]; the bf16 A operand holds
// (row g | g + 8, k 2t..2t+1 | 2t+8..2t+9) in a[0..3] as
// (g, lo k), (g + 8, lo k), (g, hi k), (g + 8, hi k); the B operand
// holds (k 2t..2t+1 | 2t+8..2t+9, col g) in b[0], b[1].
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace mx_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; with valid false no
// byte is read and the 16 bytes are zero-filled (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte copy, zero-filled when not valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives (row g, cols 2t, 2t+1) of it
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed: r[i] receives (rows 2t, 2t+1, col g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b over a 16x16 bf16 A tile and a 16x8 bf16 B tile, f32 sums
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment loaders over a row-major bf16 tile with a row stride of ld
// elements (ld * 2 bytes a multiple of 16; a stride of 8 mod 64 elements
// puts the 8 rows an ldmatrix phase reads in 8 distinct bank groups).

// A of rows (m) [r0, r0 + 16), cols (k) [c0, c0 + 16): the tile is M x K
__device__ __forceinline__ void ldsm_a(uint32_t a[4], const __nv_bfloat16* t,
                                       int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, t + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// A of m = cols [m0, m0 + 16), k = rows [k0, k0 + 16): the tile is K x M
// (the product's A operand stored transposed)
__device__ __forceinline__ void ldsm_a_trans(uint32_t a[4],
                                             const __nv_bfloat16* t, int ld,
                                             int k0, int m0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(a, t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                           m0 + ((lane >> 3) & 1) * 8);
}

// B of two 8-wide n-tiles, n = rows [n0, n0 + 16), k = cols [c0, c0 +
// 16): the tile is N x K.  b[0..1] are n-tile n0, b[2..3] n-tile n0 + 8
__device__ __forceinline__ void ldsm_b(uint32_t b[4], const __nv_bfloat16* t,
                                       int ld, int n0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
                     ((lane >> 3) & 1) * 8);
}

// B of two 8-wide n-tiles, k = rows [k0, k0 + 16), n = cols [n0, n0 +
// 16): the tile is K x N.  b[0..1] are n-tile n0, b[2..3] n-tile n0 + 8
__device__ __forceinline__ void ldsm_b_trans(uint32_t b[4],
                                             const __nv_bfloat16* t, int ld,
                                             int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n0 + (lane >> 4) * 8);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace mx_mma
