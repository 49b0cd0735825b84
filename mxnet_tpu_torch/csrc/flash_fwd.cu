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
// 1/(1 - rate), after the row sum took it.  The seed is a device word
// (the low half of a one-element int64 tensor), read once by each block
// before its tiles, so a CUDA graph's replay drops what the word holds at
// that replay.  q/k/v are (B, H, L|Lk, D)
// bf16 or f32, contiguous, D <= 128 a multiple of 8; out has q's type;
// lse is (B, H, L) f32.  Ragged L and Lk are masked inside: rows past L
// are neither computed into memory nor written, keys past Lk score -1e30.
//
// What bounds it on the H100: at prefill lengths, operations.  A 64-row q
// tile meets every k/v tile once, 4*L*Lk*D operations per head against
// 2*(L + 2*Lk)*D bytes, well above the card's ops-per-byte ridge, so the
// products belong on the tensor cores.
//
// bf16 (flash_fwd_mma_kernel, the path of every bf16 caller): one block of
// four warps per (b*H + h, 64-row q tile), each warp owning 16 q rows.
// The q tile comes in once by cp.async and stays in registers as mma A
// fragments (ldmatrix).  64-key k and v tiles stream through a two-stage
// cp.async ring in shared memory (16-byte copies, rows padded by 16 bytes
// so ldmatrix hits distinct banks; keys past Lk and head-dim columns past
// D are zero-filled).  S = q.k^T is mma.sync m16n8k16 (bf16 in, f32
// sums); scale, masks, the dropout hash, the row max and the online
// rescale all run in registers on the accumulator fragment, in its own
// (row, key) coordinates, the row max and sum combining over the quad of
// lanes that share a row.  P goes from the S accumulators straight into
// the A fragments of O += P.v (v's B fragments by ldmatrix.trans), never
// through memory.  P is f32 and the mma takes bf16, so it goes in as a
// pair hi = bf16(p), lo = bf16(p - hi): two products into one f32
// accumulator keep ~16 bits of p, and the kernel stays within the f32
// plain version's tolerances; the cost is one product in three.  Under
// the causal mask
// the k loop stops at the diagonal tile (the reference's causal block
// skip) and the heaviest q tiles launch first (reversed blockIdx.x), so
// the diagonal's long rows do not finish last.  No atomics: each output
// is written by one thread after a fixed-order loop, so launches repeat
// bit for bit.
//
// f32 (flash_fwd_kernel): the CUDA-core kernel, four threads a q row with
// scalar f32 FMAs over f32 tiles in shared memory.  It stays off the
// tensor cores on purpose: the f32 callers (the f32 training step held
// against the CPU, the f32 card tests) need 1e-4 agreement, which a bf16
// or TF32 product cannot give.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // keys per k/v tile
constexpr int kThreads = 256;  // 4 threads per q row
constexpr int kCols = kBK / 4; // scores per thread per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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
                     int causal, const uint32_t* __restrict__ seed_word,
                     uint32_t thresh, float inv_keep, int dropout) {
  const uint32_t seed = dropout ? __ldg(seed_word) : 0u;
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

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------

constexpr int kStages = 2;  // k/v tiles in flight

template <int DP>
constexpr size_t mma_smem_bytes() {
  return mx_attn::tile_bytes<DP>() * (1 + 2 * kStages);
}

// DP: head dim padded up to 32, 64, 96 or 128 (zeros in shared memory)
template <int DP>
__global__ void __launch_bounds__(mx_attn::kThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ kmask,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int H, int L, int Lk,
                         int D, int nb_mask, float scale, int causal,
                         const uint32_t* __restrict__ seed_word,
                         uint32_t thresh, float inv_keep,
                         int dropout) {
  const uint32_t seed = dropout ? __ldg(seed_word) : 0u;
  using namespace mx_attn;
  static_assert(kBQ == kTileRows && kBK == kTileRows, "64-row tiles");
  constexpr int SR = stride<DP>();
  constexpr int KS = DP / 16;  // 16-deep steps over the head dim
  constexpr int NO = DP / 8;   // 8-wide output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * SR;           // [kStages][kBK][SR]
  __nv_bfloat16* Vs = Ks + kStages * kBK * SR;  // [kStages][kBK][SR]

  const int bh = blockIdx.y;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kBQ;
  const int lane = threadIdx.x & 31;
  const int rw = (threadIdx.x >> 5) * 16;  // this warp's rows in the tile
  const int g = lane >> 2, t4 = lane & 3;
  const int qpos[2] = {q0 + rw + g, q0 + rw + g + 8};
  const __nv_bfloat16* qb = q + (size_t)bh * L * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;
  const float* km =
      kmask ? kmask + (size_t)(nb_mask == 1 ? 0 : bh / H) * Lk : nullptr;

  // causal block skip: tiles wholly above the diagonal are never visited
  const int kend = causal ? min(Lk, q0 + kBQ) : Lk;
  const int ntiles = (kend + kBK - 1) / kBK;
  load_tile_async<DP>(Qs, qb, q0, L, D);
  load_tile_async<DP>(Ks, kb, 0, Lk, D);
  load_tile_async<DP>(Vs, vb, 0, Lk, D);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  uint32_t qf[KS][4];

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_a<DP>(qf[ks], Qs, rw, ks * 16);
    }
    if (j + 1 < ntiles) {  // the next tile streams in behind this one
      const int nb = (j + 1) % kStages;
      load_tile_async<DP>(Ks + nb * kBK * SR, kb, (j + 1) * kBK, Lk, D);
      load_tile_async<DP>(Vs + nb * kBK * SR, vb, (j + 1) * kBK, Lk, D);
      cp_async_commit();
    }
    const __nv_bfloat16* Kt = Ks + (j % kStages) * kBK * SR;
    const __nv_bfloat16* Vt = Vs + (j % kStages) * kBK * SR;
    const int k0 = j * kBK;

    // S = q . k^T: 16 rows x 64 keys a warp, eight 8-key n-tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_b<DP>(b, Kt, np * 16, ks * 16);
        mma(s[2 * np], qf[ks], b[0], b[1]);
        mma(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // scale, masks and the tile's row max, on the fragment
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
        float x = __fmul_rn(s[n][e], scale);  // rounded before the mask add
        if (kpos >= Lk) {
          x = kNegInf;            // ragged tail: the reference's -1e30 pad
        } else {
          if (km) x += km[kpos];
          if (causal && qpos[r] < kpos) x = kNegInf;
        }
        s[n][e] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(tmax[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // probabilities: the row sum takes p before dropout
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = s[n][e] <= 0.5f * kNegInf ? 0.f : expf(s[n][e] - m[r]);
        l[r] += p;
        if (dropout) {
          const uint32_t bits = hash_bits(
              seed, (uint32_t)bh, (uint32_t)qpos[r],
              (uint32_t)(k0 + n * 8 + 2 * t4 + (e & 1)));
          p = bits >= thresh ? p * inv_keep : 0.f;
        }
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P . v, P as hi + lo bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_b_trans<DP>(b, Vt, kk * 16, dp * 16);
        mma(o[2 * dp], ph, b[0], b[1]);
        mma(o[2 * dp], pl, b[0], b[1]);
        mma(o[2 * dp + 1], ph, b[2], b[3]);
        mma(o[2 * dp + 1], pl, b[2], b[3]);
      }
    }
  }

  cp_async_wait<0>();  // nothing in flight at exit (an empty k range)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lc = fmaxf(quad_sum(l[r]), 1e-30f);  // every lane shuffles
    if (qpos[r] >= L) continue;
    __nv_bfloat16* orow = out + ((size_t)bh * L + qpos[r]) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            o[n][2 * r] / lc, o[n][2 * r + 1] / lc);
    }
    if (t4 == 0) lse[(size_t)bh * L + qpos[r]] = m[r] + logf(lc);
  }
}

// ------------------------------------------------------------------------
// launches
// ------------------------------------------------------------------------

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const float* kmask,
           void* out, float* lse, int B, int H, int L, int Lk, int D,
           int nb_mask, float scale, int causal, const uint32_t* seed,
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
             int Lk, int nb_mask, float scale, int causal, const uint32_t* seed,
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

template <int DP>
int launch_mma(const void* q, const void* k, const void* v,
               const float* kmask, void* out, float* lse, int B, int H,
               int L, int Lk, int D, int nb_mask, float scale, int causal,
               const uint32_t* seed, uint32_t thresh, float inv_keep,
               int dropout,
               cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<DP>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((L + kBQ - 1) / kBQ, B * H);
  flash_fwd_mma_kernel<DP><<<grid, mx_attn::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kmask,
      static_cast<__nv_bfloat16*>(out), lse, H, L, Lk, D, nb_mask, scale,
      causal, seed, thresh, inv_keep, dropout);
  return (int)cudaGetLastError();
}

int dispatch_mma(int D, const void* q, const void* k, const void* v,
                 const float* kmask, void* out, float* lse, int B, int H,
                 int L, int Lk, int nb_mask, float scale, int causal,
                 const uint32_t* seed, uint32_t thresh, float inv_keep,
                 int dropout,
                 cudaStream_t st) {
  // q, k and v are read by 16-byte copies
  if (!mx_attn::aligned16(q) || !mx_attn::aligned16(k) ||
      !mx_attn::aligned16(v))
    return (int)cudaErrorMisalignedAddress;
#define MX_FLASH_CASE(DP)                                                   \
  return launch_mma<DP>(q, k, v, kmask, out, lse, B, H, L, Lk, D, nb_mask,  \
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
                                const void* seed, unsigned thresh,
                                float inv_keep, int dropout, void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(kmask);
  float* ls = static_cast<float*>(lse);
  const uint32_t* sd = static_cast<const uint32_t*>(seed);
  if (is_bf16)
    return dispatch_mma(D, q, k, v, km, out, ls, B, H, L, Lk, nb_mask, scale,
                        causal, sd, thresh, inv_keep, dropout, st);
  return dispatch<float>(D, q, k, v, km, out, ls, B, H, L, Lk, nb_mask,
                         scale, causal, sd, thresh, inv_keep, dropout, st);
}

// the design the bf16 path runs, for reports
extern "C" const char* flash_fwd_design() {
  return "bf16: mma.sync m16n8k16 bf16->f32, 64 q rows x 64-key tiles, "
         "4 warps x 16 rows, 2-stage cp.async k/v ring, q in registers, "
         "P as bf16 hi+lo pair, heaviest causal tiles first; "
         "f32: CUDA-core FMAs";
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
