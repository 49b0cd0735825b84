// Weight-only int8 matvec for decode: out = (x @ wt) * s + bias.
//
// Replaces the TPU kernel mxnet_tpu/ops/q8_matvec.py::q8_matvec (Pallas
// body _kernel).  x is (B, K) bf16 or f32 with a small decode batch B;
// wt is (K, O) int8 codes, pre-transposed at quantization time; s is the
// (O,) f32 per-output-channel scale and bias an optional (O,) f32 row.
// The output is (B, O) f32, exactly as the JAX function returns it: the
// caller casts it to the compute dtype and applies the activation after
// that cast.
//
// What bounds it on the H100: bytes.  A decode step streams every weight
// once and does 2 operations per weight byte at B = 1 (16 at B = 8), far
// below the ~295 operations per byte where bf16 tensor cores would be the
// limit, so the floor is the int8 codes over 3.35 TB/s.
//
// What the design does about it: the codes are read once, as int8, and
// converted to f32 in registers; nothing dequantized ever goes back to
// memory.  One thread owns one output column, so the row-major (K, O)
// codes load coalesced across a warp.  The x rows of the block (up to 8)
// are staged in shared memory as f32, one K slice at a time, and every
// thread keeps its 8 row sums in registers, so one pass over the codes
// serves the whole decode batch.  This is the simple first version: each
// thread loads one byte per row of codes and small O leaves SMs idle;
// wider loads and a split over K are for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // output columns per block, one per thread
constexpr int kRows = 8;       // x rows held in registers per block
constexpr int kTileK = 256;    // K slice staged in shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    q8_matvec_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                     const float* __restrict__ s,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int B, int K, int O) {
  __shared__ float xs[kRows][kTileK];
  const int o = blockIdx.x * kThreads + threadIdx.x;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);  // never read past the rows given
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int kt = min(kTileK, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kTileK; i += kThreads) {
      const int r = i / kTileK, c = i % kTileK;
      xs[r][c] = (r < nb && c < kt)
                     ? to_f32(x[(size_t)(b0 + r) * K + k0 + c])
                     : 0.f;
    }
    __syncthreads();
    if (o < O) {
      const int8_t* w = wt + (size_t)k0 * O + o;
#pragma unroll 4
      for (int c = 0; c < kt; ++c) {
        const float wv = (float)w[(size_t)c * O];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(xs[r][c], wv, acc[r]);
      }
    }
  }
  if (o < O) {
    const float so = s[o];
    for (int r = 0; r < nb; ++r) {
      // two roundings, as the reference: (acc * s) then + bias
      float y = __fmul_rn(acc[r], so);
      if (bias) y = __fadd_rn(y, bias[o]);
      out[(size_t)(b0 + r) * O + o] = y;
    }
  }
}

}  // namespace

extern "C" int q8_matvec_launch(const void* x, int x_is_bf16, const void* wt,
                                const void* s, const void* bias, void* out,
                                int B, int K, int O, void* stream) {
  const dim3 grid((O + kThreads - 1) / kThreads, (B + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* sc = static_cast<const float*>(s);
  const float* bi = static_cast<const float*>(bias);
  float* y = static_cast<float*>(out);
  if (x_is_bf16) {
    q8_matvec_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, sc, bi, y, B, K, O);
  } else {
    q8_matvec_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), w, sc, bi, y, B, K, O);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
