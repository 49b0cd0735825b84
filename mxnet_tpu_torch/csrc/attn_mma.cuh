// Tensor-core building blocks shared by the bf16 flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): inline PTX for sm_80+ warp-level
// mma.sync, ldmatrix and cp.async, and the padded shared-memory tiles
// they work on.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
// the f32 accumulator holds (row g, cols 2t, 2t+1) in c[0], c[1] and
// (row g + 8, the same cols) in c[2], c[3]; the bf16 A operand holds
// (row g | g + 8, k 2t..2t+1 | 2t+8..2t+9) in a[0..3] as
// (g, lo k), (g + 8, lo k), (g, hi k), (g + 8, hi k).  So the
// accumulators of two neighbouring n-tiles are, element for element, one
// A operand of a 16-deep product: a probability tile goes from the S
// product into the P.V product in registers, never through memory.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace mx_attn {

constexpr int kTileRows = 64;   // rows of every streamed tile
constexpr int kWarps = 4;       // each warp owns 16 rows of a 64-row tile
constexpr int kThreads = 32 * kWarps;

// shared-memory row stride in bf16 of a tile whose rows hold DP values:
// 16 bytes of pad put the 8 rows an ldmatrix phase reads in 8 distinct
// 16-byte bank groups
template <int DP>
__host__ __device__ constexpr int stride() { return DP + 8; }

template <int DP>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)kTileRows * stride<DP>();
}

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

// 4-byte copy (lse and delta rows), zero-filled when not valid
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

// (x0, x1) as a bf16 pair hi = bf16(x) and lo = bf16(x - hi): hi + lo
// keeps about 16 bits of each f32 mantissa, so two products (hi, then
// lo, into one f32 accumulator) stand in for an f32 operand
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// the A operands (hi and lo) of keys or rows [16 kk, 16 kk + 16) from the
// f32 accumulators of n-tiles 2 kk and 2 kk + 1
__device__ __forceinline__ void acc_to_a(const float c0[4],
                                         const float c1[4], uint32_t hi[4],
                                         uint32_t lo[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// rows [r0, r0 + 64) of a contiguous (n, D) bf16 matrix into a
// [64][stride<DP>] tile by 16-byte cp.async (D is a multiple of 8);
// rows past n and columns past D are zero-filled
template <int DP>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int r0, int n, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kTileRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n && c * 8 < D;
    cp_async16(dst + r * stride<DP>() + c * 8,
               ok ? src + (size_t)(r0 + r) * D + c * 8 : src, ok);
  }
}

// A fragment of rows [r0, r0 + 16), cols [c0, c0 + 16) of a tile
template <int DP>
__device__ __forceinline__ void ldmatrix_a(uint32_t a[4],
                                           const __nv_bfloat16* tile,
                                           int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * stride<DP>() + c0 +
                     (lane >> 4) * 8);
}

// B fragments of two 8-wide n-tiles, n = rows [n0, n0 + 16) of a
// row-major tile, k = cols [c0, c0 + 16): for the products q.k^T-like,
// where the tile's rows are the product's columns.  b[0..1] are n-tile
// n0, b[2..3] n-tile n0 + 8
template <int DP>
__device__ __forceinline__ void ldmatrix_b(uint32_t b[4],
                                           const __nv_bfloat16* tile,
                                           int n0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) *
                            stride<DP>() +
                     c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-wide n-tiles, k = rows [k0, k0 + 16), n = cols
// [n0, n0 + 16) of a row-major tile: for the products p.v-like, where
// the tile's rows are the product's depth.  b[0..1] are n-tile n0,
// b[2..3] n-tile n0 + 8
template <int DP>
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t b[4],
                                                 const __nv_bfloat16* tile,
                                                 int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  stride<DP>() +
                           n0 + (lane >> 4) * 8);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace mx_attn
