// Flash-attention backward (flash-attention-2: recompute from lse).
//
// K2 (flash_bwd_dq_mma_kernel in bf16, flash_bwd_dq_kernel in f32)
// replaces the TPU kernel mxnet_tpu/ops/attention.py::_pallas_bwd_dq; K3
// (flash_bwd_dkv_mma_kernel, flash_bwd_dkv_kernel) replaces
// mxnet_tpu/ops/attention.py::_pallas_bwd_dkv.  Both keep those
// kernels' semantics exactly, as flash_fwd.cu (K1) does for the forward:
// scores in f32, scaled, plus the optional (Nb, 1, Lk) additive key mask
// (Nb = 1 or B), then the causal mask (qpos >= kpos) with -1e30;
// p = exp(s - lse), forced to 0 where s <= -0.5e30; the attention-dropout
// keep bit is the reference's position hash of (seed, b*H + h, qpos,
// kpos), bit for bit, so forward and backward drop the same entries (the
// seed is a device word, the low half of a one-element int64 tensor, read
// once by each block before its tiles, so a CUDA graph's replay drops what
// the word holds at that replay); it zeroes dp and scales it by 1/(1 - rate) (and p for dv the same way);
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
// ridge, so the products belong on the tensor cores.
//
// K3, bf16 (flash_bwd_dkv_mma_kernel, the path of every bf16 caller): one
// block of four warps per (b*H + h, 64-key tile), each warp owning 16
// keys; the key tiles with the most q tiles launch first (low
// blockIdx.x).  The block's k and v tiles sit in shared memory in bf16
// (with their mma A fragments in registers up to head dim 64); 64-row q
// and do tiles and their lse and delta stream through a two-stage
// cp.async ring, from the diagonal on under the causal mask.  S^T = k.q^T
// and dP^T = v.do^T are mma.sync m16n8k16 tiles (bf16 in, f32 sums; q's
// and do's B fragments by ldmatrix); masks, the dropout hash, p, dp and
// ds run in registers on the accumulator fragment, in its own (key, q)
// coordinates.  dV += P_drop^T.do and dK += dS^T.q take P_drop^T and dS^T
// straight from the accumulators as A fragments (do's and q's B
// fragments by ldmatrix.trans), each as a bf16 pair hi = bf16(x), lo =
// bf16(x - hi), two products into one f32 accumulator: ~16 bits of the
// f32 operand, so the kernel stays within the f32 plain version's
// tolerance (1e-4 of each output's magnitude) where one bf16 rounding of
// ds (2^-9) would not.  dbias is each key's sum of ds over q, kept per
// lane and combined over the quad of lanes that share the key by
// shuffles in a fixed order; dk is scaled once at the end.
//
// K2, bf16 (flash_bwd_dq_mma_kernel): K3's design turned around.  One
// block of four warps per (b*H + h, 64-row q tile), each warp owning 16
// rows; under the causal mask the q tiles with the most key tiles launch
// first.  The block's q and do tiles sit in shared memory (their A
// fragments in registers up to head dim 64) and each warp keeps lse and
// delta of its two rows (g, g + 8) in registers; 64-key k and v tiles
// stream through the two-stage cp.async ring, up to the diagonal under
// the causal mask.  S = q.k^T and dP = do.v^T are mma.sync tiles (k's
// and v's B fragments by ldmatrix); masks, the dropout hash, p and ds run
// in registers in the accumulator's (q, key) coordinates, and dQ += dS.k
// takes dS from the accumulators as a bf16 hi/lo A pair (k's B fragments
// by ldmatrix.trans), for the same 1e-4 tolerance.  dq is scaled once and
// written once in f32.  Three products and the lo half of a fourth
// against K3's four and two halves.
//
// f32 (K2 and K3): one block per (b*H + h, 64-row q tile) for K2,
// looping over 64-key k/v tiles up to the diagonal (the TPU grid's
// sequential k axis becomes the loop), and per (b*H + h, 64-key tile)
// for K3, looping over 64-row q tiles from the diagonal on.  Each keeps
// its own tile and the streamed tile in shared memory as f32, so the (L,
// Lk) score matrix never reaches device memory.  Four threads share one
// row (K2) or one key (K3): each computes 16 of the tile's 64 scores and
// dp values, and a quarter of the output columns (interleaved, so
// shared-memory reads hit distinct banks), with scalar f32 FMAs on CUDA
// cores.  They stay on CUDA cores on purpose: the f32 callers need 1e-4
// agreement, which a bf16 or TF32 product cannot give.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

constexpr int kB = 64;         // q rows per q tile and keys per k tile
constexpr int kThreads = 256;  // 4 threads per row (K2) or key (K3)
constexpr int kCols = kB / 4;  // scores per thread per tile
constexpr int kP = kB + 1;     // odd stride of the 64x64 tiles
constexpr float kNegInf = -1e30f;

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
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int n, int D) {
  constexpr int S = DP + 1;
  for (int i = threadIdx.x; i < kB * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    dst[r * S + d] =
        (r0 + r < n && d < D) ? src[(size_t)(r0 + r) * D + d] : 0.f;
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
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ kmask,
                        float* __restrict__ dq, int H, int L, int Lk, int D,
                        int nb_mask, float scale, int causal,
                        const uint32_t* __restrict__ seed_word,
                        uint32_t thresh, float inv_keep, int dropout) {
  const uint32_t seed = dropout ? __ldg(seed_word) : 0u;
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
  const float* qb = q + (size_t)bh * L * D;
  const float* gb = g + (size_t)bh * L * D;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;
  const float* km =
      kmask ? kmask + (size_t)(nb_mask == 1 ? 0 : bh / H) * Lk : nullptr;
  const float lse_r = row_ok ? lse[(size_t)bh * L + qpos] : 0.f;
  const float dlt_r = row_ok ? delta[(size_t)bh * L + qpos] : 0.f;

  load_tile<DP>(Qs, qb, q0, L, D);
  load_tile<DP>(Gs, gb, q0, L, D);

  float acc[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) acc[t] = 0.f;

  // causal block skip: k tiles wholly above the diagonal are never visited
  const int kend = causal ? min(Lk, q0 + kB) : Lk;
  for (int k0 = 0; k0 < kend; k0 += kB) {
    __syncthreads();  // previous tile's readers are done
    load_tile<DP>(Ks, kb, k0, Lk, D);
    load_tile<DP>(Vs, vb, k0, Lk, D);
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
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ kmask,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dbias, int H, int L, int Lk,
                         int D, int nb_mask, float scale, int causal,
                         const uint32_t* __restrict__ seed_word,
                         uint32_t thresh, float inv_keep,
                         int dropout) {
  const uint32_t seed = dropout ? __ldg(seed_word) : 0u;
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
  const float* qb = q + (size_t)bh * L * D;
  const float* gb = g + (size_t)bh * L * D;
  const float* lb = lse + (size_t)bh * L;
  const float* db = delta + (size_t)bh * L;
  const float* km =
      kmask ? kmask + (size_t)(nb_mask == 1 ? 0 : bh / H) * Lk : nullptr;
  const float kmv = (km && key_ok) ? km[kpos] : 0.f;

  load_tile<DP>(Ks, k + (size_t)bh * Lk * D, k0, Lk, D);
  load_tile<DP>(Vs, v + (size_t)bh * Lk * D, k0, Lk, D);

  float dk_acc[DT], dv_acc[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) dk_acc[t] = dv_acc[t] = 0.f;
  float dsum = 0.f;

  // causal block skip: q tiles wholly above the diagonal (every row
  // before this block's first key) are never visited
  const int qstart = causal ? (k0 / kB) * kB : 0;
  for (int q0 = qstart; q0 < L; q0 += kB) {
    __syncthreads();  // previous tile's readers are done
    load_tile<DP>(Qs, qb, q0, L, D);
    load_tile<DP>(Gs, gb, q0, L, D);
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

// K3 in bf16: tensor cores
constexpr int kStages = 2;  // q/do tiles in flight

template <int DP>
constexpr size_t dkv_mma_smem_bytes() {
  return mx_attn::tile_bytes<DP>() * (2 + 2 * kStages) +
         sizeof(float) * 2 * kStages * kB;
}

template <int DP>
__global__ void __launch_bounds__(mx_attn::kThreads)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ kmask,
                             float* __restrict__ dk, float* __restrict__ dv,
                             float* __restrict__ dbias, int H, int L,
                             int Lk, int D, int nb_mask, float scale,
                             int causal, const uint32_t* __restrict__ seed_word,
                             uint32_t thresh,
                             float inv_keep, int dropout) {
  const uint32_t seed = dropout ? __ldg(seed_word) : 0u;
  using namespace mx_attn;
  static_assert(kB == kTileRows, "64-row tiles");
  constexpr int SR = stride<DP>();
  constexpr int KS = DP / 16;  // 16-deep steps over the head dim
  constexpr int NO = DP / 8;   // 8-wide output n-tiles
  constexpr bool kRegs = DP <= 64;  // k/v A fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kB * SR;
  __nv_bfloat16* Qs = Vs + kB * SR;             // [kStages][kB][SR]
  __nv_bfloat16* Gs = Qs + kStages * kB * SR;   // [kStages][kB][SR]
  float* Ls = reinterpret_cast<float*>(Gs + kStages * kB * SR);  // [kStages][kB]
  float* Dl = Ls + kStages * kB;                                 // [kStages][kB]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const int lane = threadIdx.x & 31;
  const int rw = (threadIdx.x >> 5) * 16;  // this warp's keys in the tile
  const int gq = lane >> 2, t4 = lane & 3;
  const int kpos[2] = {k0 + rw + gq, k0 + rw + gq + 8};
  const bool key_ok[2] = {kpos[0] < Lk, kpos[1] < Lk};
  const __nv_bfloat16* qb = q + (size_t)bh * L * D;
  const __nv_bfloat16* gb = g + (size_t)bh * L * D;
  const float* lb = lse + (size_t)bh * L;
  const float* db = delta + (size_t)bh * L;
  const float* km =
      kmask ? kmask + (size_t)(nb_mask == 1 ? 0 : bh / H) * Lk : nullptr;
  float kmv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kmv[r] = (km && key_ok[r]) ? km[kpos[r]] : 0.f;

  // causal block skip: q tiles wholly above the diagonal (every row
  // before this block's first key) are never visited
  const int qstart = causal ? k0 : 0;
  const int nq = qstart < L ? (L - qstart + kB - 1) / kB : 0;
  auto load_q = [&](int it) {
    const int b = it % kStages, q0 = qstart + it * kB;
    load_tile_async<DP>(Qs + b * kB * SR, qb, q0, L, D);
    load_tile_async<DP>(Gs + b * kB * SR, gb, q0, L, D);
    if (threadIdx.x < kB) {
      const int r = q0 + threadIdx.x;
      cp_async4(Ls + b * kB + threadIdx.x, r < L ? lb + r : lb, r < L);
      cp_async4(Dl + b * kB + threadIdx.x, r < L ? db + r : db, r < L);
    }
  };
  load_tile_async<DP>(Ks, k + (size_t)bh * Lk * D, k0, Lk, D);
  load_tile_async<DP>(Vs, v + (size_t)bh * Lk * D, k0, Lk, D);
  if (nq > 0) load_q(0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }
  float dsum[2] = {0.f, 0.f};
  uint32_t kf[kRegs ? KS : 1][4], vf[kRegs ? KS : 1][4];

  for (int it = 0; it < nq; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (kRegs && it == 0) {
#pragma unroll
      for (int ks = 0; ks < (kRegs ? KS : 1); ++ks) {
        ldmatrix_a<DP>(kf[ks], Ks, rw, ks * 16);
        ldmatrix_a<DP>(vf[ks], Vs, rw, ks * 16);
      }
    }
    if (it + 1 < nq) {  // the next tile streams in behind this one
      load_q(it + 1);
      cp_async_commit();
    }
    const int b = it % kStages;
    const __nv_bfloat16* Qt = Qs + b * kB * SR;
    const __nv_bfloat16* Gt = Gs + b * kB * SR;
    const float* Lt = Ls + b * kB;
    const float* Dt = Dl + b * kB;
    const int q0 = qstart + it * kB;

    // S^T = k . q^T and dP^T = v . do^T: 16 keys x 64 q rows a warp
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      if (kRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = kf[kRegs ? ks : 0][i];
          va[i] = vf[kRegs ? ks : 0][i];
        }
      } else {
        ldmatrix_a<DP>(ka, Ks, rw, ks * 16);
        ldmatrix_a<DP>(va, Vs, rw, ks * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4], bg[4];
        ldmatrix_b<DP>(bq, Qt, np * 16, ks * 16);
        ldmatrix_b<DP>(bg, Gt, np * 16, ks * 16);
        mma(st[2 * np], ka, bq[0], bq[1]);
        mma(st[2 * np + 1], ka, bq[2], bq[3]);
        mma(dpt[2 * np], va, bg[0], bg[1]);
        mma(dpt[2 * np + 1], va, bg[2], bg[3]);
      }
    }

    // p, p_drop and ds on the fragment: st becomes p_drop, dpt ds
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = n * 8 + 2 * t4 + (e & 1);
        const int qpos = q0 + c;
        float x = __fmul_rn(st[n][e], scale);  // rounded before the mask add
        if (km) x += kmv[r];
        const bool valid =
            key_ok[r] && qpos < L && !(causal && qpos < kpos[r]);
        const float p =
            (!valid || x <= 0.5f * kNegInf) ? 0.f : expf(x - Lt[c]);
        float dp = dpt[n][e], p_drop = p;
        if (dropout) {
          const bool keep = hash_bits(seed, (uint32_t)bh, (uint32_t)qpos,
                                      (uint32_t)kpos[r]) >= thresh;
          dp = keep ? dp * inv_keep : 0.f;
          p_drop = keep ? p * inv_keep : 0.f;
        }
        const float ds = p * (dp - Dt[c]);
        st[n][e] = p_drop;
        dpt[n][e] = ds;
        dsum[r] += ds;
      }
    }

    // dV += P_drop^T . do and dK += dS^T . q, the A operands as hi + lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_to_a(st[2 * kk], st[2 * kk + 1], ph, pl);
      acc_to_a(dpt[2 * kk], dpt[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bg[4], bq[4];
        ldmatrix_b_trans<DP>(bg, Gt, kk * 16, dp * 16);
        ldmatrix_b_trans<DP>(bq, Qt, kk * 16, dp * 16);
        mma(dva[2 * dp], ph, bg[0], bg[1]);
        mma(dva[2 * dp], pl, bg[0], bg[1]);
        mma(dva[2 * dp + 1], ph, bg[2], bg[3]);
        mma(dva[2 * dp + 1], pl, bg[2], bg[3]);
        mma(dka[2 * dp], sh, bq[0], bq[1]);
        mma(dka[2 * dp], sl, bq[0], bq[1]);
        mma(dka[2 * dp + 1], sh, bq[2], bq[3]);
        mma(dka[2 * dp + 1], sl, bq[2], bq[3]);
      }
    }
  }

  cp_async_wait<0>();  // nothing in flight at exit (an empty q range)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ds_total = quad_sum(dsum[r]);  // every lane shuffles
    if (!key_ok[r]) continue;
    const size_t o = ((size_t)bh * Lk + kpos[r]) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d < D) {
        *reinterpret_cast<float2*>(dk + o + d) =
            make_float2(scale * dka[n][2 * r], scale * dka[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + o + d) =
            make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
    if (dbias && t4 == 0) dbias[(size_t)bh * Lk + kpos[r]] = ds_total;
  }
}

// K2 in bf16: tensor cores, K3's design turned around
template <int DP>
constexpr size_t dq_mma_smem_bytes() {
  return mx_attn::tile_bytes<DP>() * (2 + 2 * kStages);
}

template <int DP>
__global__ void __launch_bounds__(mx_attn::kThreads)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ g,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const float* __restrict__ kmask,
                            float* __restrict__ dq, int H, int L, int Lk,
                            int D, int nb_mask, float scale, int causal,
                            const uint32_t* __restrict__ seed_word,
                            uint32_t thresh, float inv_keep,
                            int dropout) {
  const uint32_t seed = dropout ? __ldg(seed_word) : 0u;
  using namespace mx_attn;
  static_assert(kB == kTileRows, "64-row tiles");
  constexpr int SR = stride<DP>();
  constexpr int KS = DP / 16;  // 16-deep steps over the head dim
  constexpr int NO = DP / 8;   // 8-wide output n-tiles
  constexpr bool kRegs = DP <= 64;  // q/do A fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + kB * SR;
  __nv_bfloat16* Ks = Gs + kB * SR;            // [kStages][kB][SR]
  __nv_bfloat16* Vs = Ks + kStages * kB * SR;  // [kStages][kB][SR]

  const int bh = blockIdx.y;
  // under the causal mask the q tiles with the most key tiles go first
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kB;
  const int lane = threadIdx.x & 31;
  const int rw = (threadIdx.x >> 5) * 16;  // this warp's rows in the tile
  const int gq = lane >> 2, t4 = lane & 3;
  const int qpos[2] = {q0 + rw + gq, q0 + rw + gq + 8};
  const bool row_ok[2] = {qpos[0] < L, qpos[1] < L};
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;
  const float* km =
      kmask ? kmask + (size_t)(nb_mask == 1 ? 0 : bh / H) * Lk : nullptr;
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = row_ok[r] ? lse[(size_t)bh * L + qpos[r]] : 0.f;
    dlt_r[r] = row_ok[r] ? delta[(size_t)bh * L + qpos[r]] : 0.f;
  }

  // causal block skip: k tiles wholly above the diagonal are never visited
  const int kend = causal ? min(Lk, q0 + kB) : Lk;
  const int nk = (kend + kB - 1) / kB;
  load_tile_async<DP>(Qs, q + (size_t)bh * L * D, q0, L, D);
  load_tile_async<DP>(Gs, g + (size_t)bh * L * D, q0, L, D);
  if (nk > 0) {
    load_tile_async<DP>(Ks, kb, 0, Lk, D);
    load_tile_async<DP>(Vs, vb, 0, Lk, D);
  }
  cp_async_commit();

  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  uint32_t qf[kRegs ? KS : 1][4], gf[kRegs ? KS : 1][4];

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (kRegs && it == 0) {
#pragma unroll
      for (int ks = 0; ks < (kRegs ? KS : 1); ++ks) {
        ldmatrix_a<DP>(qf[ks], Qs, rw, ks * 16);
        ldmatrix_a<DP>(gf[ks], Gs, rw, ks * 16);
      }
    }
    if (it + 1 < nk) {  // the next tile streams in behind this one
      const int nb = (it + 1) % kStages;
      load_tile_async<DP>(Ks + nb * kB * SR, kb, (it + 1) * kB, Lk, D);
      load_tile_async<DP>(Vs + nb * kB * SR, vb, (it + 1) * kB, Lk, D);
      cp_async_commit();
    }
    const __nv_bfloat16* Kt = Ks + (it % kStages) * kB * SR;
    const __nv_bfloat16* Vt = Vs + (it % kStages) * kB * SR;
    const int k0 = it * kB;

    // S = q . k^T and dP = do . v^T: 16 rows x 64 keys a warp
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], ga[4];
      if (kRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = qf[kRegs ? ks : 0][i];
          ga[i] = gf[kRegs ? ks : 0][i];
        }
      } else {
        ldmatrix_a<DP>(qa, Qs, rw, ks * 16);
        ldmatrix_a<DP>(ga, Gs, rw, ks * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ldmatrix_b<DP>(bk, Kt, np * 16, ks * 16);
        ldmatrix_b<DP>(bv, Vt, np * 16, ks * 16);
        mma(st[2 * np], qa, bk[0], bk[1]);
        mma(st[2 * np + 1], qa, bk[2], bk[3]);
        mma(dpt[2 * np], ga, bv[0], bv[1]);
        mma(dpt[2 * np + 1], ga, bv[2], bv[3]);
      }
    }

    // p and ds on the fragment: dpt becomes ds
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
        float x = __fmul_rn(st[n][e], scale);  // rounded before the mask add
        if (kpos >= Lk) {
          x = kNegInf;
        } else {
          if (km) x += km[kpos];
          if (causal && qpos[r] < kpos) x = kNegInf;
        }
        const float p =
            (!row_ok[r] || x <= 0.5f * kNegInf) ? 0.f : expf(x - lse_r[r]);
        float dp = dpt[n][e];
        if (dropout) {
          const bool keep = hash_bits(seed, (uint32_t)bh, (uint32_t)qpos[r],
                                      (uint32_t)kpos) >= thresh;
          dp = keep ? dp * inv_keep : 0.f;
        }
        dpt[n][e] = p * (dp - dlt_r[r]);
      }
    }

    // dQ += dS . k, the A operand as hi + lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sh[4], sl[4];
      acc_to_a(dpt[2 * kk], dpt[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bk[4];
        ldmatrix_b_trans<DP>(bk, Kt, kk * 16, dp * 16);
        mma(dqa[2 * dp], sh, bk[0], bk[1]);
        mma(dqa[2 * dp], sl, bk[0], bk[1]);
        mma(dqa[2 * dp + 1], sh, bk[2], bk[3]);
        mma(dqa[2 * dp + 1], sl, bk[2], bk[3]);
      }
    }
  }

  cp_async_wait<0>();  // nothing in flight at exit (an empty key range)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    float* out = dq + ((size_t)bh * L + qpos[r]) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<float2*>(out + d) =
            make_float2(scale * dqa[n][2 * r], scale * dqa[n][2 * r + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta, *kmask;
  int B, H, L, Lk, D, nb_mask;
  float scale;
  int causal;
  const uint32_t* seed;
  uint32_t thresh;
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

template <int DP>
int launch_dq(const Args& a, float* dq) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  static bool attr_set = false;
  const int e = set_smem(flash_bwd_dq_kernel<DP>, smem, &attr_set);
  if (e) return e;
  const dim3 grid((a.L + kB - 1) / kB, a.B * a.H);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.lse,
      a.delta, a.kmask, dq, a.H, a.L, a.Lk, a.D, a.nb_mask, a.scale,
      a.causal, a.seed, a.thresh, a.inv_keep, a.dropout);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const Args& a, float* dk, float* dv, float* dbias) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  static bool attr_set = false;
  const int e = set_smem(flash_bwd_dkv_kernel<DP>, smem, &attr_set);
  if (e) return e;
  const dim3 grid((a.Lk + kB - 1) / kB, a.B * a.H);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.lse,
      a.delta, a.kmask, dk, dv, dbias, a.H, a.L, a.Lk, a.D, a.nb_mask,
      a.scale, a.causal, a.seed, a.thresh, a.inv_keep, a.dropout);
  return (int)cudaGetLastError();
}

// DP: the head dim padded up to 32, 64, 96 or 128
int dispatch_dq(const Args& a, float* dq) {
  if (a.D <= 32) return launch_dq<32>(a, dq);
  if (a.D <= 64) return launch_dq<64>(a, dq);
  if (a.D <= 96) return launch_dq<96>(a, dq);
  return launch_dq<128>(a, dq);
}

// q, k, v and do are read by 16-byte copies
bool aligned_mma(const Args& a) {
  return mx_attn::aligned16(a.q) && mx_attn::aligned16(a.k) &&
         mx_attn::aligned16(a.v) && mx_attn::aligned16(a.g);
}

template <int DP>
int launch_dkv_mma(const Args& a, float* dk, float* dv, float* dbias) {
  constexpr size_t smem = dkv_mma_smem_bytes<DP>();
  static bool attr_set = false;
  const int e = set_smem(flash_bwd_dkv_mma_kernel<DP>, smem, &attr_set);
  if (e) return e;
  const dim3 grid((a.Lk + kB - 1) / kB, a.B * a.H);
  flash_bwd_dkv_mma_kernel<DP><<<grid, mx_attn::kThreads, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.g), a.lse, a.delta, a.kmask, dk,
      dv, dbias, a.H, a.L, a.Lk, a.D, a.nb_mask, a.scale, a.causal, a.seed,
      a.thresh, a.inv_keep, a.dropout);
  return (int)cudaGetLastError();
}

int dispatch_dkv_mma(const Args& a, float* dk, float* dv, float* dbias) {
  if (!aligned_mma(a)) return (int)cudaErrorMisalignedAddress;
  if (a.D <= 32) return launch_dkv_mma<32>(a, dk, dv, dbias);
  if (a.D <= 64) return launch_dkv_mma<64>(a, dk, dv, dbias);
  if (a.D <= 96) return launch_dkv_mma<96>(a, dk, dv, dbias);
  return launch_dkv_mma<128>(a, dk, dv, dbias);
}

template <int DP>
int launch_dq_mma(const Args& a, float* dq) {
  constexpr size_t smem = dq_mma_smem_bytes<DP>();
  static bool attr_set = false;
  const int e = set_smem(flash_bwd_dq_mma_kernel<DP>, smem, &attr_set);
  if (e) return e;
  const dim3 grid((a.L + kB - 1) / kB, a.B * a.H);
  flash_bwd_dq_mma_kernel<DP><<<grid, mx_attn::kThreads, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.g), a.lse, a.delta, a.kmask, dq,
      a.H, a.L, a.Lk, a.D, a.nb_mask, a.scale, a.causal, a.seed, a.thresh,
      a.inv_keep, a.dropout);
  return (int)cudaGetLastError();
}

int dispatch_dq_mma(const Args& a, float* dq) {
  if (!aligned_mma(a)) return (int)cudaErrorMisalignedAddress;
  if (a.D <= 32) return launch_dq_mma<32>(a, dq);
  if (a.D <= 64) return launch_dq_mma<64>(a, dq);
  if (a.D <= 96) return launch_dq_mma<96>(a, dq);
  return launch_dq_mma<128>(a, dq);
}

int dispatch_dkv(const Args& a, float* dk, float* dv, float* dbias) {
  if (a.D <= 32) return launch_dkv<32>(a, dk, dv, dbias);
  if (a.D <= 64) return launch_dkv<64>(a, dk, dv, dbias);
  if (a.D <= 96) return launch_dkv<96>(a, dk, dv, dbias);
  return launch_dkv<128>(a, dk, dv, dbias);
}

Args make_args(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, const void* kmask, int B,
               int H, int L, int Lk, int D, int nb_mask, float scale,
               int causal, const void* seed, unsigned thresh, float inv_keep,
               int dropout, void* stream) {
  return Args{q, k, v, g, static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              static_cast<const float*>(kmask), B, H, L, Lk, D, nb_mask,
              scale, causal, static_cast<const uint32_t*>(seed), thresh,
              inv_keep, dropout, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* lse, const void* delta,
                                   const void* kmask, void* dq, int is_bf16,
                                   int B, int H, int L, int Lk, int D,
                                   int nb_mask, float scale, int causal,
                                   const void* seed, unsigned thresh,
                                   float inv_keep, int dropout,
                                   void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, g, lse, delta, kmask, B, H, L, Lk, D,
                           nb_mask, scale, causal, seed, thresh, inv_keep,
                           dropout, stream);
  float* out = static_cast<float*>(dq);
  return is_bf16 ? dispatch_dq_mma(a, out) : dispatch_dq(a, out);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* g,
                                    const void* lse, const void* delta,
                                    const void* kmask, void* dk, void* dv,
                                    void* dbias, int is_bf16, int B, int H,
                                    int L, int Lk, int D, int nb_mask,
                                    float scale, int causal, const void* seed,
                                    unsigned thresh, float inv_keep,
                                    int dropout, void* stream) {
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, g, lse, delta, kmask, B, H, L, Lk, D,
                           nb_mask, scale, causal, seed, thresh, inv_keep,
                           dropout, stream);
  float* k_out = static_cast<float*>(dk);
  float* v_out = static_cast<float*>(dv);
  float* b_out = static_cast<float*>(dbias);
  return is_bf16 ? dispatch_dkv_mma(a, k_out, v_out, b_out)
                 : dispatch_dkv(a, k_out, v_out, b_out);
}

// the designs K2's and K3's bf16 paths run, for reports
extern "C" const char* flash_bwd_dq_design() {
  return "bf16: mma.sync m16n8k16 bf16->f32, 64-row q x 64-key tiles, "
         "4 warps x 16 rows, q tiles with the most key tiles first, "
         "2-stage cp.async k/v ring, q/do A fragments in registers (head "
         "dim <= 64), dS as a bf16 hi+lo pair, dq written once; f32: "
         "CUDA-core FMAs";
}

// the design K3's bf16 path runs, for reports
extern "C" const char* flash_bwd_dkv_design() {
  return "bf16: mma.sync m16n8k16 bf16->f32, 64-key x 64-q-row tiles, "
         "4 warps x 16 keys, 2-stage cp.async q/do/lse/delta ring, k/v A "
         "fragments in registers (head dim <= 64), P_drop and dS as bf16 "
         "hi+lo pairs, dbias by quad shuffles; f32: CUDA-core FMAs";
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
