// Flash-attention forward with online softmax, returning out and the
// per-row log-sum-exp.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py::_pallas_fwd.  It
// keeps that kernel's semantics exactly: scores in f32, scaled, plus an
// optional (Nb, 1, Lk) additive key mask (Nb = 1 or B), then the causal
// mask (qpos >= kpos) with -1e30 rather than -inf; running max, sum and
// output accumulate in f32; a probability whose score is <= -0.5e30 is
// forced to 0 (fully masked rows would otherwise take exp(0) = 1); the sum
// is clamped to 1e-30 before the division and the log; attention dropout
// keeps a probability iff hash(seed, b*H + h, qpos, kpos) >= rate * 2^32
// (the reference's position hash, bit for bit) and scales it by
// 1/(1 - rate), after the row sum took it.  q/k/v are (B, H, L|Lk, D)
// bf16 or f32, contiguous, D <= 128 a multiple of 8; out has q's type;
// lse is (B, H, L) f32.  Ragged L and Lk are masked inside: rows past L
// are neither computed into memory nor written, keys past Lk score -1e30.
//
// What bounds it on the H100: at prefill lengths, operations.  A 64-row q
// tile meets every k/v tile once, 4*L*Lk*D operations per head against
// 2*(L + 2*Lk)*D bytes, well above the card's ops-per-byte ridge.
//
// What the design does about it: one block per (b*H + h, 64-row q tile)
// keeps the q tile, one 64-key k/v tile and the probability tile in shared
// memory as f32, so the (L, Lk) score matrix never reaches device memory
// and k/v are read once per q tile.  Under the causal mask the k loop
// stops at the diagonal tile (the reference's causal block skip).  Four
// threads share a q row: each computes 16 of the tile's 64 scores and a
// quarter of the row's output columns (interleaved, so shared-memory
// reads of v hit distinct banks), and the row max and sum combine with
// warp shuffles.  This first version multiplies with plain f32 FMAs on
// CUDA cores, far from the tensor-core peak; mma/wgmma tiles and TMA
// loads are for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per k/v tile
constexpr int kThreads = 256;  // 4 threads per q row
constexpr int kCols = kBK / 4; // scores per thread per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the reference's dropout hash (mxnet_tpu/ops/attention.py::_hash_bits):
// uint32 arithmetic wraps exactly as jnp.uint32 does
__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t bh,
                                              uint32_t q, uint32_t k) {
  uint32_t h = seed ^ (bh * 0x9E3779B1u);
  h ^= q * 0x85EBCA77u;
  h ^= k * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBQ * (DP + 1) + 2 * kBK * (DP + 1) + kBQ * (kBK + 1));
}

// DP: head dim padded up to a multiple of 32 (zeros in shared memory)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ kmask,
                     T* __restrict__ out, float* __restrict__ lse, int H,
                     int L, int Lk, int D, int nb_mask, float scale,
                     int causal, uint32_t seed, uint32_t thresh,
                     float inv_keep, int dropout) {
  constexpr int S = DP + 1;  // odd row stride: rows land in distinct banks
  constexpr int DT = DP / 4; // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][S]
  float* Ks = Qs + kBQ * S;         // [kBK][S]
  float* Vs = Ks + kBK * S;         // [kBK][S]
  float* Ps = Vs + kBK * S;         // [kBQ][kBK + 1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;         // q row of this thread in the tile
  const int quarter = tid & 3;
  const int qpos = q0 + row;
  const size_t qbase = (size_t)bh * L * D;
  const size_t kbase = (size_t)bh * Lk * D;
  const float* km =
      kmask ? kmask + (size_t)(nb_mask == 1 ? 0 : bh / H) * Lk : nullptr;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    Qs[r * S + d] =
        (q0 + r < L && d < D) ? to_f32(q[qbase + (size_t)(q0 + r) * D + d])
                              : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j] = 0.f;

  // causal block skip: tiles wholly above the diagonal are never visited
  const int kend = causal ? min(Lk, q0 + kBQ) : Lk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      const bool ok = k0 + r < Lk && d < D;
      const size_t off = kbase + (size_t)(k0 + r) * D + d;
      Ks[r * S + d] = ok ? to_f32(k[off]) : 0.f;
      Vs[r * S + d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[kCols];
    float tmax = kNegInf;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = quarter + 4 * c;
      const int kpos = k0 + j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) dot = fmaf(Qs[row * S + d], Ks[j * S + d], dot);
      float s = __fmul_rn(dot, scale);  // rounded before the mask add
      if (kpos >= Lk) {
        s = kNegInf;            // ragged tail: the reference's -1e30 pad
      } else {
        if (km) s += km[kpos];
        if (causal && qpos < kpos) s = kNegInf;
      }
      sc[c] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = quarter + 4 * c;
      float p = sc[c] <= 0.5f * kNegInf ? 0.f : expf(sc[c] - m_new);
      psum += p;
      if (dropout) {
        const uint32_t bits = hash_bits(seed, (uint32_t)bh, (uint32_t)qpos,
                                        (uint32_t)(k0 + j));
        p = bits >= thresh ? p * inv_keep : 0.f;
      }
      Ps[row * (kBK + 1) + j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    m = m_new;
    l = l * alpha + psum;
    __syncwarp();  // a row's 4 threads share one warp
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[j] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = Ps[row * (kBK + 1) + j];
#pragma unroll
      for (int t = 0; t < DT; ++t)
        acc[t] = fmaf(p, Vs[j * S + quarter + 4 * t], acc[t]);
    }
  }

  if (qpos < L) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int d = quarter + 4 * t;
      if (d < D) store(out + qbase + (size_t)qpos * D + d, acc[t] / lc);
    }
    if (quarter == 0) lse[(size_t)bh * L + qpos] = m + logf(lc);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const float* kmask,
           void* out, float* lse, int B, int H, int L, int Lk, int D,
           int nb_mask, float scale, int causal, uint32_t seed,
           uint32_t thresh, float inv_keep, int dropout, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<DP>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((L + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kmask, static_cast<T*>(out), lse, H, L, Lk,
      D, nb_mask, scale, causal, seed, thresh, inv_keep, dropout);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const float* kmask, void* out, float* lse, int B, int H, int L,
             int Lk, int nb_mask, float scale, int causal, uint32_t seed,
             uint32_t thresh, float inv_keep, int dropout, cudaStream_t st) {
#define MX_FLASH_CASE(DP)                                                   \
  return launch<T, DP>(q, k, v, kmask, out, lse, B, H, L, Lk, D, nb_mask,   \
                       scale, causal, seed, thresh, inv_keep, dropout, st)
  if (D <= 32) MX_FLASH_CASE(32);
  if (D <= 64) MX_FLASH_CASE(64);
  if (D <= 96) MX_FLASH_CASE(96);
  MX_FLASH_CASE(128);
#undef MX_FLASH_CASE
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* kmask, void* out, void* lse,
                                int is_bf16, int B, int H, int L, int Lk,
                                int D, int nb_mask, float scale, int causal,
                                unsigned seed, unsigned thresh,
                                float inv_keep, int dropout, void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(kmask);
  float* ls = static_cast<float*>(lse);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, km, out, ls, B, H, L, Lk,
                                   nb_mask, scale, causal, seed, thresh,
                                   inv_keep, dropout, st);
  return dispatch<float>(D, q, k, v, km, out, ls, B, H, L, Lk, nb_mask,
                         scale, causal, seed, thresh, inv_keep, dropout, st);
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
