// Fused decode step: every transformer layer of one decode token in ONE
// cooperative kernel launch (kernel K5).
//
// Replaces the TPU kernel mxnet_tpu/ops/decode_fused.py::_decode_layers
// (Pallas body _make_kernel).  Inputs are the reference's packed stream:
// w (NCtot, U, CW) bf16 or int8 chunks, per-chunk biases and scales,
// (NL, 4, U) f32 norm rows, the f32 fc2/down bias and scales, and the
// (NL, B, KV, T, D) bf16 K/V caches, updated in place at `pos`.  Both
// families: GPT (LayerNorm, fused qkv, gelu/relu FFN) and Llama (RMSNorm,
// split q/k/v with grouped-query attention, RoPE, SwiGLU).  The plain
// PyTorch version is ops/decode_fused.py::decode_step_plain; the
// roundings below are the reference kernel's, one for one.
//
// What bounds it on the H100: bytes.  At B <= 4 every weight byte is used
// for at most 8 operations, far below the ~295 operations per byte where
// the bf16 tensor cores would be the limit, so the floor is the packed
// stream plus the K/V read (positions <= pos) over 3.35 TB/s.
//
// What the design does about it.  The TPU kernel walks the layers as one
// sequential grid with VMEM scratch carried between steps; on the card
// blocks run in no order, so this is one persistent cooperative grid
// (sized by the occupancy calculator) whose phases are separated by
// grid-wide barriers (cooperative_groups grid sync), six per layer:
//   A  xn = norm1(x) in every block's shared memory; qkv = xn @ Wqkv
//   B  RoPE (Llama), the new k/v column into the caches, attention of
//      each (batch row, KV head) against positions <= pos
//   C  x2 = x + o @ Wproj
//   D  xn2 = norm2(x2); h = act(xn2 @ W1) (GPT) or silu(g) * u (Llama)
//   E  fc2/down partial sums, one per (F chunk, output row)
//   F  x = x2 + (sum of the partials in chunk order * s2 + b2)
// Every weight byte is read once per token, as 16-byte (bf16) or 8-byte
// (int8) loads coalesced along the chunk's contiguous axis.  A column
// phase gives each block tiles of 32 output columns, and the block's 64
// row lanes split the U (K) axis, reduced in shared memory in a fixed
// order; fc2/down gives one warp per output row over a chunk's CW lanes,
// and its partials are summed in a second pass after a barrier, so there
// are no atomics and the result repeats bit for bit.  Scratch vectors
// (qkv, o, x2, h, partials) live in one device buffer the wrapper
// allocates.  This is the simple first version: one pass of loads per
// thread, attention by one block per (row, KV head), six barriers per
// layer; TMA rings and split attention are for later.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kTN = 32;               // output columns per column tile
constexpr int kCG = kTN / 8;          // column groups of 8 per tile
constexpr int kRL = kThreads / kCG;   // row lanes per tile (64)
constexpr int kMaxB = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerItem = kWarps * kRowsPerWarp;   // fc2/down rows

struct Params {
  bf16* x;                 // (B, U) hidden state, in and out
  const void* w;           // (NCtot, U, CW) bf16 or int8
  const void* bstream;     // (NCtot, CW) bf16 (native) or f32 (int8)
  const float* sstream;    // (NCtot, CW) f32, int8 only
  const float* norms;      // (NL, 4, U)
  const float* bias2;      // (NL, U)
  const float* s2;         // (NL, U)
  const float* rope;       // (D,) inv_freq[d / 2], Llama only
  bf16* kh;                // (NL, B, KV, T, D)
  bf16* vh;
  bf16* qkv;               // (B, QS) scratch
  bf16* o;                 // (B, U)
  bf16* x2;                // (B, U)
  bf16* h;                 // (B, F)
  float* part;             // (n_row, B, U)
  int pos, NL, B, U, F, H, KV, D, T, CW, NC;
  int proj_lo, ffn_lo, up_lo, row_lo, n_row, llama, act;
  float eps, scale;
};

__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

// eight consecutive weights as f32 (codes convert exactly)
template <bool Q>
__device__ __forceinline__ void load8(const void* w, size_t idx, float* out);

template <>
__device__ __forceinline__ void load8<false>(const void* w, size_t idx,
                                             float* out) {
  const uint4 v =
      __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(w) + idx));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load8<true>(const void* w, size_t idx,
                                            float* out) {
  const uint2 v = __ldg(
      reinterpret_cast<const uint2*>(static_cast<const int8_t*>(w) + idx));
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

// block-wide sum / max, the same fixed tree in every call; every thread
// gets lane 0's per-warp values summed in warp order
__device__ float block_sum(float v, float* sred) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kWarps; ++i) t = __fadd_rn(t, sred[i]);
  return t;
}

__device__ float block_max(float v, float* sred) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = sred[0];
  for (int i = 1; i < kWarps; ++i) t = fmaxf(t, sred[i]);
  return t;
}

// xs[b][k] = norm(src[b][:])[k] rounded to bf16, f32 statistics:
// LayerNorm (biased variance) or RMSNorm, gamma row `grow`, beta `brow`
__device__ void norm_rows(const Params& p, const bf16* src, int layer,
                          int grow, int brow, float* xs, float* sred) {
  const int U = p.U;
  const float* g = p.norms + ((size_t)layer * 4 + grow) * U;
  const float* be = p.norms + ((size_t)layer * 4 + brow) * U;
  for (int b = 0; b < p.B; ++b) {
    const bf16* row = src + (size_t)b * U;
    float* xr = xs + (size_t)b * U;
    float acc = 0.f;
    for (int k = threadIdx.x; k < U; k += kThreads) {
      const float v = ld(row + k);
      xr[k] = v;
      acc = __fadd_rn(acc, p.llama ? __fmul_rn(v, v) : v);
    }
    const float sum = block_sum(acc, sred);
    if (p.llama) {
      const float ms = __fdiv_rn(sum, (float)U);
      const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, p.eps)));
      for (int k = threadIdx.x; k < U; k += kThreads)
        xr[k] = rb(__fmul_rn(__fmul_rn(xr[k], r), g[k]));
    } else {
      const float mean = __fdiv_rn(sum, (float)U);
      float a2 = 0.f;
      for (int k = threadIdx.x; k < U; k += kThreads) {
        const float d = __fsub_rn(xr[k], mean);
        a2 = __fadd_rn(a2, __fmul_rn(d, d));
      }
      const float var = __fdiv_rn(block_sum(a2, sred), (float)U);
      const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps)));
      for (int k = threadIdx.x; k < U; k += kThreads) {
        const float d = __fsub_rn(xr[k], mean);
        xr[k] = rb(__fadd_rn(__fmul_rn(__fmul_rn(d, r), g[k]), be[k]));
      }
    }
  }
  __syncthreads();
}

__device__ void load_rows(const Params& p, const bf16* src, float* xs) {
  for (int i = threadIdx.x; i < p.B * p.U; i += kThreads) xs[i] = ld(src + i);
  __syncthreads();
}

// One 32-column tile of chunk `chunk`, columns j0..j0+31: thread
// tid < B * 32 returns the f32 dot of row tid / 32 of xs with column
// j0 + tid % 32, the 64 row lanes summed in lane order.
template <bool Q>
__device__ float col_tile(const Params& p, int chunk, int j0, const float* xs,
                          float* red) {
  const int cgi = threadIdx.x % kCG, rl = threadIdx.x / kCG;
  const int B = p.B, U = p.U, CW = p.CW;
  float acc[kMaxB][8];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[b][j] = 0.f;
  const size_t base = (size_t)chunk * U * CW + j0 + cgi * 8;
#pragma unroll 4
  for (int k = rl; k < U; k += kRL) {
    float w[8];
    load8<Q>(p.w, base + (size_t)k * CW, w);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < B) {
        const float xv = xs[(size_t)b * U + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[b][j] = fmaf(xv, w[j], acc[b][j]);
      }
    }
  }
  __syncthreads();  // the previous tile's readers of red are done
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    if (b < B)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(rl * B + b) * kTN + cgi * 8 + j] = acc[b][j];
  __syncthreads();
  float r = 0.f;
  if (threadIdx.x < B * kTN) {
    const int b = threadIdx.x / kTN, j = threadIdx.x % kTN;
    for (int l = 0; l < kRL; ++l) r = __fadd_rn(r, red[(l * B + b) * kTN + j]);
  }
  return r;
}

// a column's output in the compute dtype: native casts then adds the
// bf16 bias; int8 computes acc * s + b in f32, then casts
template <bool Q>
__device__ __forceinline__ float col_out(const Params& p, int chunk, int j,
                                         float acc) {
  const size_t bi = (size_t)chunk * p.CW + j;
  if (Q)
    return rb(__fadd_rn(__fmul_rn(acc, p.sstream[bi]),
                        static_cast<const float*>(p.bstream)[bi]));
  return rb(__fadd_rn(rb(acc),
                      __bfloat162float(static_cast<const bf16*>(p.bstream)[bi])));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// A: xn = norm1(x); qkv = xn @ Wqkv (+ b)
template <bool Q>
__device__ void phase_qkv(const Params& p, int layer, float* smem,
                          float* sred) {
  const int QS = p.proj_lo * p.CW;
  const int ntiles = QS / kTN;
  if (blockIdx.x >= ntiles) return;
  float* xs = smem;
  float* red = smem + (size_t)p.B * p.U;
  norm_rows(p, p.x, layer, 0, 1, xs, sred);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * kTN;
    const int chunk = layer * p.NC + n0 / p.CW, j0 = n0 % p.CW;
    const float r = col_tile<Q>(p, chunk, j0, xs, red);
    if (threadIdx.x < p.B * kTN) {
      const int b = threadIdx.x / kTN, j = threadIdx.x % kTN;
      p.qkv[(size_t)b * QS + n0 + j] =
          __float2bfloat16(col_out<Q>(p, chunk, j0 + j, r));
    }
  }
}

// rotate the pair (a, b) at lanes (d, d + 1) by pos * inv_freq[d / 2]
__device__ __forceinline__ void rope_pair(float& a, float& b, int pos,
                                          float inv) {
  const float th = __fmul_rn((float)pos, inv);
  const float c = cosf(th), s = sinf(th);
  const float r1 = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
  const float r2 = __fadd_rn(__fmul_rn(a, s), __fmul_rn(b, c));
  a = rb(r1);
  b = rb(r2);
}

// B: new k/v column into the caches, attention per (row, KV head)
__device__ void phase_attn(const Params& p, int layer, float* smem,
                           float* sred) {
  const int G = p.H / p.KV, D = p.D, T = p.T, pos = p.pos, U = p.U;
  const int QS = p.proj_lo * p.CW, KVD = p.KV * D;
  float* sc = smem;                 // (G, T) scores, then probabilities
  float* qs = sc + (size_t)G * T;   // (G, D)
  float* pv = qs + (size_t)G * D;   // p.V partials
  const int outs = G * D;
  const int ts = outs <= kThreads ? kThreads / outs : 1;
  for (int item = blockIdx.x; item < p.B * p.KV; item += gridDim.x) {
    const int b = item / p.KV, kv = item % p.KV;
    const bf16* qrow = p.qkv + (size_t)b * QS + (size_t)kv * G * D;
    const bf16* krow = p.qkv + (size_t)b * QS + U + (size_t)kv * D;
    const bf16* vrow = p.qkv + (size_t)b * QS + U + KVD + (size_t)kv * D;
    const size_t cbase = (((size_t)layer * p.B + b) * p.KV + kv) * T * D;
    bf16* kc = p.kh + cbase;
    bf16* vc = p.vh + cbase;
    for (int i = threadIdx.x; i < outs / 2; i += kThreads) {
      const int g = i / (D / 2), d = 2 * (i % (D / 2));
      float a = ld(qrow + g * D + d), c = ld(qrow + g * D + d + 1);
      if (p.llama) rope_pair(a, c, pos, p.rope[d]);
      qs[g * D + d] = a;
      qs[g * D + d + 1] = c;
    }
    for (int i = threadIdx.x; i < D / 2; i += kThreads) {
      const int d = 2 * i;
      float a = ld(krow + d), c = ld(krow + d + 1);
      if (p.llama) rope_pair(a, c, pos, p.rope[d]);
      kc[(size_t)pos * D + d] = __float2bfloat16(a);
      kc[(size_t)pos * D + d + 1] = __float2bfloat16(c);
      vc[(size_t)pos * D + d] = vrow[d];
      vc[(size_t)pos * D + d + 1] = vrow[d + 1];
    }
    __syncthreads();
    for (int t = threadIdx.x; t <= pos; t += kThreads) {
      const __nv_bfloat162* kr =
          reinterpret_cast<const __nv_bfloat162*>(kc + (size_t)t * D);
      for (int g = 0; g < G; ++g) {
        const float* q = qs + g * D;
        float acc = 0.f;
        for (int d2 = 0; d2 < D / 2; ++d2) {
          const float2 kk = __bfloat1622float2(kr[d2]);
          acc = fmaf(q[2 * d2], kk.x, acc);
          acc = fmaf(q[2 * d2 + 1], kk.y, acc);
        }
        sc[(size_t)g * T + t] = __fmul_rn(acc, p.scale);
      }
    }
    __syncthreads();
    // softmax over t <= pos in f32 (later positions are masked at -1e30
    // in the reference, whose exp is exactly 0); p cast to bf16
    for (int g = 0; g < G; ++g) {
      float* s = sc + (size_t)g * T;
      float m = -3.0e38f;
      for (int t = threadIdx.x; t <= pos; t += kThreads) m = fmaxf(m, s[t]);
      m = block_max(m, sred);
      float sum = 0.f;
      for (int t = threadIdx.x; t <= pos; t += kThreads) {
        const float e = expf(__fsub_rn(s[t], m));
        s[t] = e;
        sum = __fadd_rn(sum, e);
      }
      sum = block_sum(sum, sred);
      for (int t = threadIdx.x; t <= pos; t += kThreads)
        s[t] = rb(__fdiv_rn(s[t], sum));
    }
    __syncthreads();
    bf16* orow = p.o + (size_t)b * U + (size_t)kv * G * D;
    if (outs <= kThreads) {
      const int oi = threadIdx.x % outs, sp = threadIdx.x / outs;
      if (sp < ts) {
        const int g = oi / D, d = oi % D;
        const float* s = sc + (size_t)g * T;
        float acc = 0.f;
        for (int t = sp; t <= pos; t += ts)
          acc = fmaf(s[t], ld(vc + (size_t)t * D + d), acc);
        pv[sp * outs + oi] = acc;
      }
      __syncthreads();
      if (threadIdx.x < outs) {
        float r = 0.f;
        for (int k = 0; k < ts; ++k) r = __fadd_rn(r, pv[k * outs + threadIdx.x]);
        orow[threadIdx.x] = __float2bfloat16(r);
      }
    } else {
      for (int oi = threadIdx.x; oi < outs; oi += kThreads) {
        const int g = oi / D, d = oi % D;
        const float* s = sc + (size_t)g * T;
        float acc = 0.f;
        for (int t = 0; t <= pos; ++t)
          acc = fmaf(s[t], ld(vc + (size_t)t * D + d), acc);
        orow[oi] = __float2bfloat16(acc);
      }
    }
    __syncthreads();
  }
}

// C: x2 = x + o @ Wproj (+ b)
template <bool Q>
__device__ void phase_proj(const Params& p, int layer, float* smem) {
  const int U = p.U, ntiles = U / kTN;
  if (blockIdx.x >= ntiles) return;
  float* xs = smem;
  float* red = smem + (size_t)p.B * U;
  load_rows(p, p.o, xs);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * kTN;
    const int chunk = layer * p.NC + p.proj_lo + n0 / p.CW, j0 = n0 % p.CW;
    const float r = col_tile<Q>(p, chunk, j0, xs, red);
    if (threadIdx.x < p.B * kTN) {
      const int b = threadIdx.x / kTN, j = threadIdx.x % kTN;
      const size_t i = (size_t)b * U + n0 + j;
      const float y = col_out<Q>(p, chunk, j0 + j, r);
      p.x2[i] = __float2bfloat16(__fadd_rn(ld(p.x + i), y));
    }
  }
}

// D: xn2 = norm2(x2); h = act(xn2 @ W1 + b) or silu(g) * u
template <bool Q>
__device__ void phase_ffn(const Params& p, int layer, float* smem,
                          float* sred) {
  const int F = p.F, ntiles = F / kTN;
  if (blockIdx.x >= ntiles) return;
  float* xs = smem;
  float* red = smem + (size_t)p.B * p.U;
  norm_rows(p, p.x2, layer, 2, 3, xs, sred);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * kTN, j0 = n0 % p.CW;
    const int chunk = layer * p.NC + p.ffn_lo + n0 / p.CW;
    const float r = col_tile<Q>(p, chunk, j0, xs, red);
    float hv = 0.f;
    if (p.llama) {
      const int uchunk = layer * p.NC + p.up_lo + n0 / p.CW;
      const float ru = col_tile<Q>(p, uchunk, j0, xs, red);
      if (threadIdx.x < p.B * kTN) {
        const int j = threadIdx.x % kTN;
        const float g = col_out<Q>(p, chunk, j0 + j, r);
        const float u = col_out<Q>(p, uchunk, j0 + j, ru);
        // g * sigmoid(g) * u, each product rounded to bf16
        const float sg = rb(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
        hv = rb(__fmul_rn(rb(__fmul_rn(g, sg)), u));
      }
    } else if (threadIdx.x < p.B * kTN) {
      const int j = threadIdx.x % kTN;
      const float z = col_out<Q>(p, chunk, j0 + j, r);
      hv = p.act == 1 ? rb(gelu_tanh(z)) : p.act == 2 ? fmaxf(z, 0.f) : z;
    }
    if (threadIdx.x < p.B * kTN) {
      const int b = threadIdx.x / kTN, j = threadIdx.x % kTN;
      p.h[(size_t)b * F + n0 + j] = __float2bfloat16(hv);
    }
  }
}

// E: part[c][b][u] = sum over chunk c's CW lanes of h[b] * W2[u]
template <bool Q>
__device__ void phase_row(const Params& p, int layer, float* smem) {
  const int U = p.U, CW = p.CW, B = p.B;
  const int rgroups = (U + kRowsPerItem - 1) / kRowsPerItem;
  const int items = p.n_row * rgroups;
  float* hs = smem;  // (B, CW)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c = item / rgroups, rg = item % rgroups;
    __syncthreads();
    for (int i = threadIdx.x; i < B * CW; i += kThreads)
      hs[i] = ld(p.h + (size_t)(i / CW) * p.F + (size_t)c * CW + i % CW);
    __syncthreads();
    const size_t cbase = (size_t)(layer * p.NC + p.row_lo + c) * U * CW;
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int u = rg * kRowsPerItem + warp * kRowsPerWarp + r;
      if (u >= U) break;
      float acc[kMaxB];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;
      for (int f0 = lane * 8; f0 < CW; f0 += 256) {
        float w[8];
        load8<Q>(p.w, cbase + (size_t)u * CW + f0, w);
#pragma unroll
        for (int b = 0; b < kMaxB; ++b)
          if (b < B)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[b] = fmaf(hs[b * CW + f0 + j], w[j], acc[b]);
      }
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b >= B) break;
        float v = acc[b];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) p.part[((size_t)c * B + b) * U + u] = v;
      }
    }
  }
}

// F: x = x2 + bf16(sum_c part[c] (* s2) + b2)
template <bool Q>
__device__ void phase_final(const Params& p, int layer) {
  const int U = p.U, n = p.B * U;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int b = i / U, u = i % U;
    float acc = 0.f;
    for (int c = 0; c < p.n_row; ++c)
      acc = __fadd_rn(acc, p.part[((size_t)c * p.B + b) * U + u]);
    if (Q) acc = __fmul_rn(acc, p.s2[(size_t)layer * U + u]);
    const float y = rb(__fadd_rn(acc, p.bias2[(size_t)layer * U + u]));
    p.x[i] = __float2bfloat16(__fadd_rn(ld(p.x2 + i), y));
  }
}

template <bool Q>
__global__ void __launch_bounds__(kThreads, 2)
    decode_fused_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ float sred[32];
  cg::grid_group grid = cg::this_grid();
  for (int layer = 0; layer < p.NL; ++layer) {
    phase_qkv<Q>(p, layer, smem, sred);
    grid.sync();
    phase_attn(p, layer, smem, sred);
    grid.sync();
    phase_proj<Q>(p, layer, smem);
    grid.sync();
    phase_ffn<Q>(p, layer, smem, sred);
    grid.sync();
    phase_row<Q>(p, layer, smem);
    grid.sync();
    phase_final<Q>(p, layer);
    if (layer + 1 < p.NL) grid.sync();
  }
}

}  // namespace

extern "C" int decode_fused_launch(
    void* x, const void* w, const void* bstream, const void* sstream,
    const void* norms, const void* bias2, const void* s2, const void* rope,
    void* kh, void* vh, void* qkv, void* o, void* x2, void* h, void* part,
    int* grid_out, int pos, int quant, int NL, int B, int U, int F, int H,
    int KV, int D, int T, int CW, int NC, int proj_lo, int ffn_lo, int up_lo,
    int row_lo, int n_row, int llama, int act, float eps, float scale,
    int smem, void* stream) {
  Params p;
  p.x = static_cast<bf16*>(x);
  p.w = w;
  p.bstream = bstream;
  p.sstream = static_cast<const float*>(sstream);
  p.norms = static_cast<const float*>(norms);
  p.bias2 = static_cast<const float*>(bias2);
  p.s2 = static_cast<const float*>(s2);
  p.rope = static_cast<const float*>(rope);
  p.kh = static_cast<bf16*>(kh);
  p.vh = static_cast<bf16*>(vh);
  p.qkv = static_cast<bf16*>(qkv);
  p.o = static_cast<bf16*>(o);
  p.x2 = static_cast<bf16*>(x2);
  p.h = static_cast<bf16*>(h);
  p.part = static_cast<float*>(part);
  p.pos = pos;
  p.NL = NL;
  p.B = B;
  p.U = U;
  p.F = F;
  p.H = H;
  p.KV = KV;
  p.D = D;
  p.T = T;
  p.CW = CW;
  p.NC = NC;
  p.proj_lo = proj_lo;
  p.ffn_lo = ffn_lo;
  p.up_lo = up_lo;
  p.row_lo = row_lo;
  p.n_row = n_row;
  p.llama = llama;
  p.act = act;
  p.eps = eps;
  p.scale = scale;

  const void* fn = quant ? reinterpret_cast<const void*>(&decode_fused_kernel<true>)
                         : reinterpret_cast<const void*>(&decode_fused_kernel<false>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  // every block must be resident at once for the grid barriers
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  per_sm = per_sm < 2 ? per_sm : 2;
  const int blocks = per_sm * sms;
  *grid_out = blocks;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
