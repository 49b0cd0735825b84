// Flash-attention backward (flash-attention-2: recompute from lse).
//
// K2, flash_bwd_dq_kernel, replaces the TPU kernel
// mxnet_tpu/ops/attention.py::_pallas_bwd_dq; K3, flash_bwd_dkv_kernel,
// replaces mxnet_tpu/ops/attention.py::_pallas_bwd_dkv.  Both keep those
// kernels' semantics exactly, as flash_fwd.cu (K1) does for the forward:
// scores in f32, scaled, plus the optional (Nb, 1, Lk) additive key mask
// (Nb = 1 or B), then the causal mask (qpos >= kpos) with -1e30;
// p = exp(s - lse), forced to 0 where s <= -0.5e30; the attention-dropout
// keep bit is the reference's position hash of (seed, b*H + h, qpos,
// kpos), bit for bit, so forward and backward drop the same entries; it
// zeroes dp and scales it by 1/(1 - rate) (and p for dv the same way);
// ds = p * (dp - delta) with delta = rowsum(o * do), computed by the
// caller.  K2 writes dq = scale * ds @ k in f32; K3 writes dk = scale *
// ds^T @ q, dv = p_drop^T @ do, both f32, and, when asked, the key-mask
// gradient dbias[bh, k] = sum_q ds, f32 (BH, Lk).  q/k/v/do are (B, H,
// L|Lk, D) bf16 or f32, contiguous, D <= 128 a multiple of 8; lse and
// delta are (B, H, L) f32.  Ragged L and Lk are masked inside: rows past
// L and keys past Lk contribute nothing and are never written; nothing
// is padded to 128 (the TPU kernels' block, lane and head-dim padding is
// a TPU artefact).
//
// Determinism: every output element is owned by exactly one block and
// summed in a fixed order, so there are no atomics and a gradient is the
// same bit for bit from run to run (the usual flash-2 dq atomicAdd is
// not used: K2 recomputes the scores instead of sharing K3's).
//
// What bounds them on the H100: at training lengths, operations.  Per
// head K2 does 6*L*Lk*D and K3 8*L*Lk*D operations (fewer under the
// causal skip) against about 4*(L + Lk)*D input bytes and 4*L*D (K2) or
// 8*Lk*D (K3) bytes of f32 output, far above the card's ops-per-byte
// ridge for tensor cores, but these kernels run on CUDA cores.
//
// What the design does about it: K2 is one block per (b*H + h, 64-row q
// tile) that loops over 64-key k/v tiles up to the diagonal (the TPU
// grid's sequential k axis becomes the loop); K3 is one block per (b*H +
// h, 64-key tile) that loops over 64-row q tiles from the diagonal on.
// Each keeps its own tile and the streamed tile in shared memory as f32,
// so the (L, Lk) score matrix never reaches device memory.  Four threads
// share one row (K2) or one key (K3): each computes 16 of the tile's 64
// scores and dp values, and a quarter of the output columns
// (interleaved, so shared-memory reads hit distinct banks).  This first
// version multiplies with plain f32 FMAs on CUDA cores, far from the
// tensor-core peak; mma/wgmma tiles and TMA loads are for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // q rows per q tile and keys per k tile
constexpr int kThreads = 256;  // 4 threads per row (K2) or key (K3)
constexpr int kCols = kB / 4;  // scores per thread per tile
constexpr int kP = kB + 1;     // odd stride of the 64x64 tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// rows [r0, r0 + kB) of a (n, D) matrix into a [kB][DP + 1] f32 tile,
// zeros past n and past D
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, int D) {
  constexpr int S = DP + 1;
  for (int i = threadIdx.x; i < kB * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    dst[r * S + d] =
        (r0 + r < n && d < D) ? to_f32(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kB * (DP + 1) + kB * kP);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kB * (DP + 1) + 2 * kB * kP + 2 * kB);
}

// K2.  DP: head dim padded up to a multiple of 32 (zeros in shared memory)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ kmask,
                        float* __restrict__ dq, int H, int L, int Lk, int D,
                        int nb_mask, float scale, int causal, uint32_t seed,
                        uint32_t thresh, float inv_keep, int dropout) {
  constexpr int S = DP + 1;
  constexpr int DT = DP / 4;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // [kB][S]
  float* Gs = Qs + kB * S;     // [kB][S]
  float* Ks = Gs + kB * S;     // [kB][S]
  float* Vs = Ks + kB * S;     // [kB][S]
  float* DSs = Vs + kB * S;    // [kB rows][kP]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int row = threadIdx.x >> 2;
  const int quarter = threadIdx.x & 3;
  const int qpos = q0 + row;
  const bool row_ok = qpos < L;
  const T* qb = q + (size_t)bh * L * D;
  const T* gb = g + (size_t)bh * L * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  const float* km =
      kmask ? kmask + (size_t)(nb_mask == 1 ? 0 : bh / H) * Lk : nullptr;
  const float lse_r = row_ok ? lse[(size_t)bh * L + qpos] : 0.f;
  const float dlt_r = row_ok ? delta[(size_t)bh * L + qpos] : 0.f;

  load_tile<T, DP>(Qs, qb, q0, L, D);
  load_tile<T, DP>(Gs, gb, q0, L, D);

  float acc[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) acc[t] = 0.f;

  // causal block skip: k tiles wholly above the diagonal are never visited
  const int kend = causal ? min(Lk, q0 + kB) : Lk;
  for (int k0 = 0; k0 < kend; k0 += kB) {
    __syncthreads();  // previous tile's readers are done
    load_tile<T, DP>(Ks, kb, k0, Lk, D);
    load_tile<T, DP>(Vs, vb, k0, Lk, D);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      const int j = quarter + 4 * c;
      const int kpos = k0 + j;
      float dot_s = 0.f, dot_p = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        dot_s = fmaf(Qs[row * S + d], Ks[j * S + d], dot_s);
        dot_p = fmaf(Gs[row * S + d], Vs[j * S + d], dot_p);
      }
      float s = __fmul_rn(dot_s, scale);  // rounded before the mask add
      if (kpos >= Lk) {
        s = kNegInf;
      } else {
        if (km) s += km[kpos];
        if (causal && qpos < kpos) s = kNegInf;
      }
      const float p =
          (!row_ok || s <= 0.5f * kNegInf) ? 0.f : expf(s - lse_r);
      if (dropout) {
        const uint32_t bits = hash_bits(seed, (uint32_t)bh, (uint32_t)qpos,
                                        (uint32_t)kpos);
        dot_p = bits >= thresh ? dot_p * inv_keep : 0.f;
      }
      DSs[row * kP + j] = p * (dot_p - dlt_r);
    }
    __syncwarp();  // a row's 4 threads share one warp
    for (int j = 0; j < kB; ++j) {
      const float ds = DSs[row * kP + j];
#pragma unroll
      for (int t = 0; t < DT; ++t)
        acc[t] = fmaf(ds, Ks[j * S + quarter + 4 * t], acc[t]);
    }
  }

  if (row_ok) {
    float* out = dq + ((size_t)bh * L + qpos) * D;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int d = quarter + 4 * t;
      if (d < D) out[d] = scale * acc[t];
    }
  }
}

// K3
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ kmask,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dbias, int H, int L, int Lk,
                         int D, int nb_mask, float scale, int causal,
                         uint32_t seed, uint32_t thresh, float inv_keep,
                         int dropout) {
  constexpr int S = DP + 1;
  constexpr int DT = DP / 4;
  extern __shared__ float smem[];
  float* Ks = smem;            // [kB][S], this block's keys
  float* Vs = Ks + kB * S;     // [kB][S]
  float* Qs = Vs + kB * S;     // [kB][S], the streamed q tile
  float* Gs = Qs + kB * S;     // [kB][S]
  float* Ps = Gs + kB * S;     // [kB keys][kP]: dropped p
  float* DSs = Ps + kB * kP;   // [kB keys][kP]: ds
  float* Ls = DSs + kB * kP;   // [kB]: lse of the q tile
  float* Dl = Ls + kB;         // [kB]: delta of the q tile

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const int key = threadIdx.x >> 2;
  const int quarter = threadIdx.x & 3;
  const int kpos = k0 + key;
  const bool key_ok = kpos < Lk;
  const T* qb = q + (size_t)bh * L * D;
  const T* gb = g + (size_t)bh * L * D;
  const float* lb = lse + (size_t)bh * L;
  const float* db = delta + (size_t)bh * L;
  const float* km =
      kmask ? kmask + (size_t)(nb_mask == 1 ? 0 : bh / H) * Lk : nullptr;
  const float kmv = (km && key_ok) ? km[kpos] : 0.f;

  load_tile<T, DP>(Ks, k + (size_t)bh * Lk * D, k0, Lk, D);
  load_tile<T, DP>(Vs, v + (size_t)bh * Lk * D, k0, Lk, D);

  float dk_acc[DT], dv_acc[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) dk_acc[t] = dv_acc[t] = 0.f;
  float dsum = 0.f;

  // causal block skip: q tiles wholly above the diagonal (every row
  // before this block's first key) are never visited
  const int qstart = causal ? (k0 / kB) * kB : 0;
  for (int q0 = qstart; q0 < L; q0 += kB) {
    __syncthreads();  // previous tile's readers are done
    load_tile<T, DP>(Qs, qb, q0, L, D);
    load_tile<T, DP>(Gs, gb, q0, L, D);
    if (threadIdx.x < kB) {
      const int r = q0 + threadIdx.x;
      Ls[threadIdx.x] = r < L ? lb[r] : 0.f;
      Dl[threadIdx.x] = r < L ? db[r] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      const int r = quarter + 4 * c;
      const int qpos = q0 + r;
      float dot_s = 0.f, dot_p = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        dot_s = fmaf(Qs[r * S + d], Ks[key * S + d], dot_s);
        dot_p = fmaf(Gs[r * S + d], Vs[key * S + d], dot_p);
      }
      float s = __fmul_rn(dot_s, scale);  // rounded before the mask add
      if (km) s += kmv;
      const bool valid = key_ok && qpos < L && !(causal && qpos < kpos);
      const float p =
          (!valid || s <= 0.5f * kNegInf) ? 0.f : expf(s - Ls[r]);
      float p_drop = p;
      if (dropout) {
        const bool keep = hash_bits(seed, (uint32_t)bh, (uint32_t)qpos,
                                    (uint32_t)kpos) >= thresh;
        dot_p = keep ? dot_p * inv_keep : 0.f;
        p_drop = keep ? p * inv_keep : 0.f;
      }
      const float ds = p * (dot_p - Dl[r]);
      Ps[key * kP + r] = p_drop;
      DSs[key * kP + r] = ds;
      dsum += ds;
    }
    __syncwarp();  // a key's 4 threads share one warp
    for (int r = 0; r < kB; ++r) {
      const float pd = Ps[key * kP + r];
      const float ds = DSs[key * kP + r];
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        dv_acc[t] = fmaf(pd, Gs[r * S + quarter + 4 * t], dv_acc[t]);
        dk_acc[t] = fmaf(ds, Qs[r * S + quarter + 4 * t], dk_acc[t]);
      }
    }
  }

  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  if (key_ok) {
    const size_t o = ((size_t)bh * Lk + kpos) * D;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int d = quarter + 4 * t;
      if (d < D) {
        dk[o + d] = scale * dk_acc[t];
        dv[o + d] = dv_acc[t];
      }
    }
    if (dbias && quarter == 0) dbias[(size_t)bh * Lk + kpos] = dsum;
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta, *kmask;
  int B, H, L, Lk, D, nb_mask;
  float scale;
  int causal;
  uint32_t seed, thresh;
  float inv_keep;
  int dropout;
  cudaStream_t st;
};

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

template <typename T, int DP>
int launch_dq(const Args& a, float* dq) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  static bool attr_set = false;
  const int e = set_smem(flash_bwd_dq_kernel<T, DP>, smem, &attr_set);
  if (e) return e;
  const dim3 grid((a.L + kB - 1) / kB, a.B * a.H);
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse,
      a.delta, a.kmask, dq, a.H, a.L, a.Lk, a.D, a.nb_mask, a.scale,
      a.causal, a.seed, a.thresh, a.inv_keep, a.dropout);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dkv(const Args& a, float* dk, float* dv, float* dbias) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  static bool attr_set = false;
  const int e = set_smem(flash_bwd_dkv_kernel<T, DP>, smem, &attr_set);
  if (e) return e;
  const dim3 grid((a.Lk + kB - 1) / kB, a.B * a.H);
  flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse,
      a.delta, a.kmask, dk, dv, dbias, a.H, a.L, a.Lk, a.D, a.nb_mask,
      a.scale, a.causal, a.seed, a.thresh, a.inv_keep, a.dropout);
  return (int)cudaGetLastError();
}

// DP: the head dim padded up to 32, 64, 96 or 128
template <typename T>
int dispatch_dq(const Args& a, float* dq) {
  if (a.D <= 32) return launch_dq<T, 32>(a, dq);
  if (a.D <= 64) return launch_dq<T, 64>(a, dq);
  if (a.D <= 96) return launch_dq<T, 96>(a, dq);
  return launch_dq<T, 128>(a, dq);
}

template <typename T>
int dispatch_dkv(const Args& a, float* dk, float* dv, float* dbias) {
  if (a.D <= 32) return launch_dkv<T, 32>(a, dk, dv, dbias);
  if (a.D <= 64) return launch_dkv<T, 64>(a, dk, dv, dbias);
  if (a.D <= 96) return launch_dkv<T, 96>(a, dk, dv, dbias);
  return launch_dkv<T, 128>(a, dk, dv, dbias);
}

Args make_args(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, const void* kmask, int B,
               int H, int L, int Lk, int D, int nb_mask, float scale,
               int causal, unsigned seed, unsigned thresh, float inv_keep,
               int dropout, void* stream) {
  return Args{q, k, v, g, static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<const float*>(kmask), B, H, L, Lk, D, nb_mask,
              scale, causal, seed, thresh, inv_keep, dropout,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse, const void* delta,
                                   const void* kmask, void* dq, int is_bf16,
                                   int B, int H, int L, int Lk, int D,
                                   int nb_mask, float scale, int causal,
                                   unsigned seed, unsigned thresh,
                                   float inv_keep, int dropout,
                                   void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, g, lse, delta, kmask, B, H, L, Lk, D,
                           nb_mask, scale, causal, seed, thresh, inv_keep,
                           dropout, stream);
  float* out = static_cast<float*>(dq);
  return is_bf16 ? dispatch_dq<__nv_bfloat16>(a, out)
                 : dispatch_dq<float>(a, out);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* g,
                                    const void* lse, const void* delta,
                                    const void* kmask, void* dk, void* dv,
                                    void* dbias, int is_bf16, int B, int H,
                                    int L, int Lk, int D, int nb_mask,
                                    float scale, int causal, unsigned seed,
                                    unsigned thresh, float inv_keep,
                                    int dropout, void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, g, lse, delta, kmask, B, H, L, Lk, D,
                           nb_mask, scale, causal, seed, thresh, inv_keep,
                           dropout, stream);
  float* k_out = static_cast<float*>(dk);
  float* v_out = static_cast<float*>(dv);
  float* b_out = static_cast<float*>(dbias);
  return is_bf16 ? dispatch_dkv<__nv_bfloat16>(a, k_out, v_out, b_out)
                 : dispatch_dkv<float>(a, k_out, v_out, b_out);
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
