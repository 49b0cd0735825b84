// Tensor-core building blocks of the 16-bit flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu), for bf16 and fp16 inputs alike (T is
// __nv_bfloat16 or __half): the padded shared-memory tiles they work on,
// their fragment loaders, the product of the element type, and the hi/lo
// split of an f32 accumulator into A operands of that type, over the
// generic PTX wrappers of mma_sm80.cuh (which documents the mma.sync
// m16n8k16 fragment layout; bf16 and fp16 share it).
//
// The accumulators of two neighbouring n-tiles are, element for element,
// one A operand of a 16-deep product: a probability tile goes from the S
// product into the P.V product in registers, never through memory.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm80.cuh"

namespace mx_attn {

using namespace mx_mma;

constexpr int kTileRows = 64;   // rows of every streamed tile
constexpr int kWarps = 4;       // each warp owns 16 rows of a 64-row tile
constexpr int kThreads = 32 * kWarps;

// shared-memory row stride in 16-bit elements of a tile whose rows hold DP values:
// 16 bytes of pad put the 8 rows an ldmatrix phase reads in 8 distinct
// 16-byte bank groups
template <int DP>
__host__ __device__ constexpr int stride() { return DP + 8; }

template <int DP>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)kTileRows * stride<DP>();
}

// whether T is fp16 (a variable template: usable in device code)
template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

// c += a . b with A and B of element type T, f32 sums
template <typename T>
__device__ __forceinline__ void mma_t(float c[4], const uint32_t a[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (is_f16<T>) mma_f16(c, a, b0, b1);
  else mma(c, a, b0, b1);
}

// (x0, x1) rounded to a T pair, as the 32 bits of the pair
template <typename T>
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  if constexpr (is_f16<T>) {
    __half2 h = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    return bits(__floats2bfloat162_rn(x0, x1));
  }
}

// the f32 values of a T pair held in 32 bits
template <typename T>
__device__ __forceinline__ float2 unpack(uint32_t v) {
  if constexpr (is_f16<T>)
    return __half22float2(*reinterpret_cast<__half2*>(&v));
  else
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (x0, x1) as a T pair hi = T(x) and lo = T(x - hi), so two products (hi,
// then lo, into one f32 accumulator) stand in for an f32 operand.  bf16:
// hi + lo keeps about 16 bits of each f32 mantissa.  fp16: about 22 bits
// for |x| in fp16's normal range [2^-14, 65504]; below it the pair's error
// is at most fp16's subnormal half-step 2^-25 absolute, and an |x| past
// 65504 overflows to inf (a loss scaler's overflow)
template <typename T>
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack<T>(x0, x1);
  const float2 hf = unpack<T>(hi);
  lo = pack<T>(x0 - hf.x, x1 - hf.y);
}

// the A operands (hi and lo) of keys or rows [16 kk, 16 kk + 16) from the
// f32 accumulators of n-tiles 2 kk and 2 kk + 1
template <typename T>
__device__ __forceinline__ void acc_to_a(const float c0[4],
                                         const float c1[4], uint32_t hi[4],
                                         uint32_t lo[4]) {
  split<T>(c0[0], c0[1], hi[0], lo[0]);
  split<T>(c0[2], c0[3], hi[1], lo[1]);
  split<T>(c1[0], c1[1], hi[2], lo[2]);
  split<T>(c1[2], c1[3], hi[3], lo[3]);
}

// rows [r0, r0 + 64) of a contiguous (n, D) 16-bit matrix into a
// [64][stride<DP>] tile by 16-byte cp.async (D is a multiple of 8);
// rows past n and columns past D are zero-filled
template <int DP, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
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
template <int DP, typename T>
__device__ __forceinline__ void ldmatrix_a(uint32_t a[4], const T* tile,
                                           int r0, int c0) {
  ldsm_a(a, reinterpret_cast<const __nv_bfloat16*>(tile), stride<DP>(), r0,
         c0);
}

// B fragments of two 8-wide n-tiles, n = rows [n0, n0 + 16) of a
// row-major tile, k = cols [c0, c0 + 16): for the products q.k^T-like,
// where the tile's rows are the product's columns.  b[0..1] are n-tile
// n0, b[2..3] n-tile n0 + 8
template <int DP, typename T>
__device__ __forceinline__ void ldmatrix_b(uint32_t b[4], const T* tile,
                                           int n0, int c0) {
  ldsm_b(b, reinterpret_cast<const __nv_bfloat16*>(tile), stride<DP>(), n0,
         c0);
}

// B fragments of two 8-wide n-tiles, k = rows [k0, k0 + 16), n = cols
// [n0, n0 + 16) of a row-major tile: for the products p.v-like, where
// the tile's rows are the product's depth.  b[0..1] are n-tile n0,
// b[2..3] n-tile n0 + 8
template <int DP, typename T>
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t b[4],
                                                 const T* tile, int k0,
                                                 int n0) {
  ldsm_b_trans(b, reinterpret_cast<const __nv_bfloat16*>(tile),
               stride<DP>(), k0, n0);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mx_attn
