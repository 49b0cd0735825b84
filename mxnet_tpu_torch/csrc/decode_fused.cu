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
// What the design does about it.  One persistent cooperative grid
// (sized once by the occupancy calculator, 2 blocks a SM) walks the layers
// in six phases a layer, separated by grid barriers:
//   A  x = x2 + fc2/down output of the previous layer (summed from its
//      slab partials), xn = norm1(x); qkv slab partials
//   B1 q, and (in the chunk holding pos) the new k/v column into the
//      caches; scores of one (batch row, KV head, position chunk), its
//      max and sum
//   B2 global max and sum (chunks in order), p = bf16(e / sum), the
//      chunk's p.V partial
//   C  o = bf16(sum of the chunk partials); proj slab partials
//   D  x2 = x + proj (summed), xn2 = norm2(x2); fc1 | gate+up partials
//   E  h = act(fc1) | silu(gate) * up on one F slab; fc2/down partials
// and a last phase for x after the last layer.  Every weight phase cuts
// its matrix into items of equal bytes (ops/decode_fused.py::plan): a
// column span into (128-byte column tile, one of 2 K slabs) items, the
// fc2/down span into (F slab of chunks, group of output rows) items, one
// a block; each item writes f32 partials, and the phase that consumes
// them sums them in slab order, so there are no atomics and the result
// repeats bit for bit.  Every weight load is 16 bytes (8 bf16 or 16 int8
// codes, which become exact floats in registers), 8 lanes across a
// 128-byte row run, a batch of loads in flight while the one before is
// multiplied; the registers hold the sums of 1, 2 or 4 batch rows as B
// asks.  The rows a phase's prelude needs beside the partials (norm
// gamma and beta, biases, scales, x) are staged into shared memory by
// cp.async while the partials load.  Attention is split over position
// chunks, the scores kept in the block's shared memory across the
// barrier between the two passes (the item -> block map is static); a
// warp reads one position's K or V row, 8 positions in flight.  Before
// each barrier a block asks L2 for the first weight rows of its next item
// (prefetch.global.L2): the addresses depend only on (layer, phase,
// block).
//
// The kernel fits itself into the shared memory of every configuration
// the gate admits (ops/decode_fused.py::layout): where the staged rows do
// not fit, the column phases read them where they lie; the fc2/down span
// takes more F slabs; p.V reduces its warps in rounds through fewer rows,
// or fewer heads a pass; and where a block has more attention items than
// it can hold the scores of (more (batch row, KV head) pairs than blocks),
// B2 computes each item's scores again from the same loads in the same
// order instead of keeping them.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 4;
constexpr int kGMax = 8;      // query heads of a KV group in one p.V pass
constexpr int kPos = 8;       // K or V rows a warp has in flight

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
  bf16* x2;                // (B, U) residual after attention
  float* pa;               // partials: qkv, then fc1 | gate+up
  float* pb;               // partials: proj, then fc2 | down
  float* po;               // (nc, B, U) chunk p.V partials
  float* pst;              // (B, KV, nc, G, 2) chunk max and sum
  int pos, NL, B, U, F, H, KV, D, T, CW, NC;
  int proj_lo, ffn_lo, row_lo, llama, act;
  int s_qkv, s_proj, s_ffn;  // K slabs of the column spans
  int s_row, g_row;          // F slabs and output-row groups of fc2/down
  int nc, lc;                // position chunks, positions a chunk
  int keep;    // attention: every item's scores stay in shared memory
               // across B1 -> B2 (else B2 computes its item's again)
  int gm, pv_rows;  // p.V: query heads a pass, rows of its warp reduction
  int stage;   // column phases stage their prelude rows in shared memory
  float eps, scale;
};

__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
// a bf16 another block wrote in this launch (L2, not a stale L1 line)
__device__ __forceinline__ float ldcg(const bf16* p) {
  return __bfloat162float(__ldcg(p));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// n bytes (a multiple of 16, both ends 16-byte aligned) from global src
// to shared dst by cp.async, without registers; the caller commits the
// group and waits for it before the first read
__device__ __forceinline__ void stage(void* dst, const void* src, int n) {
  for (int o = threadIdx.x * 16; o < n; o += kThreads * 16)
    mx_mma::cp_async16(static_cast<char*>(dst) + o,
                       static_cast<const char*>(src) + o, true);
}

__device__ __forceinline__ void staged() {
  mx_mma::cp_async_wait<0>();
  __syncthreads();
}

// E = 16 bytes of consecutive weights as f32: 8 bf16, or 16 int8 codes
// (each biased by 128 into the low mantissa byte of 2^23, less 2^23+128:
// exact, and no conversion unit)
template <bool Q>
struct Wt {
  static constexpr int E = Q ? 16 : 8;
  static constexpr int bytes = Q ? 1 : 2;
};

template <bool Q>
__device__ __forceinline__ uint4 raw16(const void* w, size_t idx) {
  return __ldg(reinterpret_cast<const uint4*>(
      static_cast<const char*>(w) + idx * Wt<Q>::bytes));
}

template <bool Q>
__device__ __forceinline__ void cvt16(const uint4 v, float* out) {
  if constexpr (Q) {
    const uint32_t ws[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                            v.z ^ 0x80808080u, v.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = __uint_as_float(__byte_perm(ws[i >> 2], 0x4B000000u,
                                           0x7540u | (i & 3))) -
               8388736.0f;
  } else {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// 16-byte loads a lane has in flight while it multiplies the batch
// before: as many as the registers left by BR batch rows of sums allow
template <bool Q, int BR>
constexpr int kBatch = Q ? (BR == 1 ? 8 : BR == 2 ? 4 : 2) : (BR <= 2 ? 8 : 4);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide sums of B values at once: each through the same fixed tree
// as block_sum; every thread gets the totals
__device__ void block_sums(float (&v)[kMaxB], int B, float* sred) {
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[b] += __shfl_xor_sync(0xffffffffu, v[b], o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0)
    for (int b = 0; b < B; ++b) sred[b * kWarps + (threadIdx.x >> 5)] = v[b];
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    float t = 0.f;
    if (b < B)
      for (int i = 0; i < kWarps; ++i) t = __fadd_rn(t, sred[b * kWarps + i]);
    v[b] = t;
  }
}

// column k of every row: (x - mean) * r * gamma (+ beta), rounded
__device__ __forceinline__ void norm_apply(const Params& p, float* xs, int k,
                                           float gk, float bk,
                                           const float (&mean)[kMaxB],
                                           const float (&r)[kMaxB]) {
  if (k >= p.U) return;
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    if (b < p.B) {
      float* x = xs + (size_t)b * p.U + k;
      *x = p.llama
               ? rb(__fmul_rn(__fmul_rn(*x, r[b]), gk))
               : rb(__fadd_rn(
                     __fmul_rn(__fmul_rn(__fsub_rn(*x, mean[b]), r[b]), gk),
                     bk));
    }
}

// xs[b][k] = norm(xs[b][:])[k] rounded to bf16, in place, f32 statistics:
// LayerNorm (biased variance) or RMSNorm; gb holds the gamma row, then
// (LayerNorm) the beta row, staged in shared memory; all B rows in each
// pass
__device__ void norm_rows(const Params& p, const float* gb, float* xs,
                          float* sred) {
  const int U = p.U, B = p.B;
  float acc[kMaxB] = {0.f, 0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < U; k += kThreads)
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < B) {
        const float v = xs[(size_t)b * U + k];
        acc[b] = __fadd_rn(acc[b], p.llama ? __fmul_rn(v, v) : v);
      }
  block_sums(acc, B, sred);
  float mean[kMaxB], r[kMaxB];
  if (p.llama) {
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      mean[b] = 0.f;
      const float ms = __fdiv_rn(acc[b], (float)U);
      r[b] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, p.eps)));
    }
  } else {
    float a2[kMaxB] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) mean[b] = __fdiv_rn(acc[b], (float)U);
    for (int k = threadIdx.x; k < U; k += kThreads)
#pragma unroll
      for (int b = 0; b < kMaxB; ++b)
        if (b < B) {
          const float d = __fsub_rn(xs[(size_t)b * U + k], mean[b]);
          a2[b] = __fadd_rn(a2[b], __fmul_rn(d, d));
        }
    block_sums(a2, B, sred);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      const float var = __fdiv_rn(a2[b], (float)U);
      r[b] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps)));
    }
  }
  for (int k = threadIdx.x; k < U; k += kThreads)
    norm_apply(p, xs, k, gb[k], p.llama ? 0.f : gb[U + k], mean, r);
  __syncthreads();
}

// a column's bias and (int8) scale, from its stream index
template <bool Q>
__device__ __forceinline__ float bias_of(const Params& p, size_t bi) {
  return Q ? static_cast<const float*>(p.bstream)[bi]
           : __bfloat162float(static_cast<const bf16*>(p.bstream)[bi]);
}
template <bool Q>
__device__ __forceinline__ float scale_of(const Params& p, size_t bi) {
  return Q ? p.sstream[bi] : 1.f;
}

// a column's output in the compute dtype: native casts then adds the
// bf16 bias; int8 computes acc * s + b in f32, then casts
template <bool Q>
__device__ __forceinline__ float out_val(float acc, float sc, float bi) {
  if (Q) return rb(__fadd_rn(__fmul_rn(acc, sc), bi));
  return rb(__fadd_rn(rb(acc), bi));
}

// the stream index of column n of the span starting at chunk ch
__device__ __forceinline__ size_t col_index(const Params& p, int ch, int n) {
  return (size_t)(ch + n / p.CW) * p.CW + n % p.CW;
}

constexpr int kMaxSlabs = 16;  // slab partials a thread loads at once

// the S slab partials of column n, row b, of a span of width W, summed in
// slab order; kMaxSlabs loads are in flight before their first add
__device__ __forceinline__ float slab_sum(const float* P, int S, int B, int W,
                                          int b, int n) {
  float a = 0.f;
  for (int s0 = 0; s0 < S; s0 += kMaxSlabs) {
    float v[kMaxSlabs];
#pragma unroll
    for (int s = 0; s < kMaxSlabs; ++s)
      v[s] = s0 + s < S ? __ldcg(P + ((size_t)(s0 + s) * B + b) * W + n) : 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSlabs; ++s)
      if (s0 + s < S) a = __fadd_rn(a, v[s]);
  }
  return a;
}

// dst[r * dld + i] = the S slab partials P[s * stride + r * pld + i]
// summed in slab order, for r < rows, i < n (n, pld, dld multiples of 4),
// 4 slabs of 4 float4 a thread in flight at a time; ends in a block
// barrier
__device__ void sum_slabs(const float* P, int S, size_t stride, int rows,
                          int pld, int n, float* dst, int dld) {
  const int n4 = n / 4, tot = rows * n4;
  for (int q0 = threadIdx.x; q0 < tot; q0 += 4 * kThreads) {
    float4 acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < S; s0 += 4) {
      float4 v[4][4];
#pragma unroll
      for (int ss = 0; ss < 4; ++ss)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = q0 + j * kThreads;
          v[ss][j] = s0 + ss < S && q < tot
                         ? __ldcg(reinterpret_cast<const float4*>(
                               P + (size_t)(s0 + ss) * stride +
                               (size_t)(q / n4) * pld) + q % n4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int ss = 0; ss < 4; ++ss)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s0 + ss < S) {
            acc[j].x = __fadd_rn(acc[j].x, v[ss][j].x);
            acc[j].y = __fadd_rn(acc[j].y, v[ss][j].y);
            acc[j].z = __fadd_rn(acc[j].z, v[ss][j].z);
            acc[j].w = __fadd_rn(acc[j].w, v[ss][j].w);
          }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + j * kThreads;
      if (q < tot)
        reinterpret_cast<float4*>(dst + (size_t)(q / n4) * dld)[q % n4] =
            acc[j];
    }
  }
  __syncthreads();  // dst is read by other threads' mapping next
}

// the first K row of slab `slab` of S over U rows, on 16-row steps
__device__ __forceinline__ int slab_lo(int slab, int S, int U) {
  return 16 * (slab * (U / 16) / S);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// ------------------------------------------------------------------------
// column spans: chunks chunk0.. of the layer, W output columns, cut into
// (tile of TN columns, slab of U / S rows) items, item = slab * T + tile

// columns of an item: 8 lanes of 16-byte loads, a 128-byte run of a
// chunk row (64 bf16 or 128 int8 weights), at most the chunk width
template <bool Q>
__device__ __forceinline__ int col_tile(const Params& p) {
  return min(8 * Wt<Q>::E, p.CW);
}

template <bool Q>
__device__ __forceinline__ int col_items(const Params& p, int W, int S) {
  return W / col_tile<Q>(p) * S;
}

// one item: the f32 sums over the slab's rows of xs (B <= BR rows of U,
// only the slab's part read) against TN columns, to
// out[(slab * B + b) * W + n]; row lanes of a warp summed by an xor tree,
// then the warps in order
template <bool Q, int BR>
__device__ void col_item_rows(const Params& p, int layer, int chunk0, int W,
                              int S, int item, const float* xs, float* red,
                              float* out) {
  constexpr int E = Wt<Q>::E, NB = kBatch<Q, BR>;
  const int TN = col_tile<Q>(p), CL = TN / E, RL = kThreads / CL;
  const int T = W / TN, tile = item % T, slab = item / T;
  const int U = p.U, B = p.B, CW = p.CW;
  const int k0 = slab_lo(slab, S, U), k1 = slab_lo(slab + 1, S, U);
  const int n0 = tile * TN;
  const int cl = threadIdx.x % CL, rl = threadIdx.x / CL;
  const size_t base =
      (size_t)(layer * p.NC + chunk0 + n0 / CW) * U * CW + n0 % CW + cl * E;
  float acc[BR][E];
#pragma unroll
  for (int b = 0; b < BR; ++b)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[b][e] = 0.f;
  // double-buffered: the next batch's loads are issued before this
  // batch is multiplied
  uint4 cur[NB], nxt[NB];
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int kk = k0 + rl + u * RL;
    cur[u] = kk < k1 ? raw16<Q>(p.w, base + (size_t)kk * CW)
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int k = k0 + rl; k < k1; k += NB * RL) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int kk = k + (NB + u) * RL;
      nxt[u] = kk < k1 ? raw16<Q>(p.w, base + (size_t)kk * CW)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int kk = k + u * RL;
      if (kk >= k1) break;
      float w[E];
      cvt16<Q>(cur[u], w);
#pragma unroll
      for (int b = 0; b < BR; ++b) {
        if (b < B) {
          const float xv = xs[(size_t)b * U + kk];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[b][e] = fmaf(xv, w[e], acc[b][e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) cur[u] = nxt[u];
  }
  for (int off = CL; off < 32; off <<= 1)
#pragma unroll
    for (int b = 0; b < BR; ++b)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], off);
  __syncthreads();  // the previous item's readers of red are done
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < CL) {
#pragma unroll
    for (int b = 0; b < BR; ++b)
      if (b < B)
#pragma unroll
        for (int e = 0; e < E; ++e)
          red[(warp * B + b) * TN + lane * E + e] = acc[b][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B * TN; i += kThreads) {
    const int b = i / TN, c = i % TN;
    float r = 0.f;
    for (int w = 0; w < kWarps; ++w) r += red[(w * B + b) * TN + c];
    out[((size_t)slab * B + b) * W + n0 + c] = r;
  }
}

// the item with registers for 1, 2 or 4 batch rows
template <bool Q>
__device__ void col_item(const Params& p, int layer, int chunk0, int W, int S,
                         int item, const float* xs, float* red, float* out) {
  if (p.B == 1)
    col_item_rows<Q, 1>(p, layer, chunk0, W, S, item, xs, red, out);
  else if (p.B == 2)
    col_item_rows<Q, 2>(p, layer, chunk0, W, S, item, xs, red, out);
  else
    col_item_rows<Q, 4>(p, layer, chunk0, W, S, item, xs, red, out);
}

// L2 prefetch of item's weight rows (one 128-byte run a row)
template <bool Q>
__device__ void prefetch_col(const Params& p, int layer, int chunk0, int W,
                             int S, int item) {
  if (layer >= p.NL || item >= col_items<Q>(p, W, S)) return;
  const int TN = col_tile<Q>(p), T = W / TN, tile = item % T;
  const int slab = item / T, U = p.U, CW = p.CW, n0 = tile * TN;
  const char* w = static_cast<const char*>(p.w) + Wt<Q>::bytes * (
      (size_t)(layer * p.NC + chunk0 + n0 / CW) * U * CW + n0 % CW);
  for (int k = slab_lo(slab, S, U) + threadIdx.x;
       k < slab_lo(slab + 1, S, U); k += kThreads)
    prefetch_l2(w + (size_t)k * CW * Wt<Q>::bytes);
}

// ------------------------------------------------------------------------
// the shared memory of the column phases: xs (B, U) f32 | red (warps, B,
// 128) f32 | and, where the plan stages (p.stage), gb: gamma (and beta but
// for RMSNorm) (2 or 1, U) f32 | ep: the prelude's staged rows (2 rows of
// U f32 words and B rows of U bf16); without staging they are read where
// they lie
struct ColSmem {
  float *xs, *red, *gb, *ep;
};

__device__ __forceinline__ ColSmem col_smem(const Params& p, float* smem) {
  ColSmem c;
  c.xs = smem;
  c.red = c.xs + (size_t)p.B * p.U;
  c.gb = c.red + kWarps * p.B * min(128, p.CW);
  c.ep = c.gb + (p.llama ? 1 : 2) * p.U;
  return c;
}

// norm rows grow (gamma) and grow + 1 (beta, LayerNorm only) of the
// layer: staged into gb, or where they lie
__device__ __forceinline__ const float* stage_norm(const Params& p, int layer,
                                                   int grow, float* gb) {
  const float* src = p.norms + ((size_t)layer * 4 + grow) * p.U;
  if (!p.stage) return src;
  stage(gb, src, (p.llama ? 4 : 8) * p.U);
  return gb;
}

// element i of a bf16 row another block wrote in this launch: staged, or
// from L2
__device__ __forceinline__ float staged_or_l2(const Params& p, const bf16* s,
                                              const bf16* g, int i) {
  return p.stage ? __bfloat162float(s[i]) : ldcg(g + i);
}

// ------------------------------------------------------------------------
// A: x (the previous layer's output), xn = norm1(x); qkv partials to pa

// xs = x for layer `layer`: the input at layer 0, else x2 + bf16(fc2 /
// down sum (* s2) + b2) of the layer before; `store` writes it to p.x
template <bool Q>
__device__ void residual(const Params& p, int layer, float* xs, float* ep,
                         bool store) {
  const int U = p.U, n = p.B * U;
  if (layer == 0) {
    for (int i = threadIdx.x; i < n; i += kThreads) xs[i] = ld(p.x + i);
    staged();
    return;
  }
  // s2 and b2 of the layer before and x2, staged while the partials load
  const float* s2 = p.s2 + (size_t)(layer - 1) * U;
  const float* b2 = p.bias2 + (size_t)(layer - 1) * U;
  if (p.stage) {
    stage(ep, s2, 4 * U);
    stage(ep + U, b2, 4 * U);
    stage(ep + 2 * U, p.x2, 2 * n);
    s2 = ep;
    b2 = ep + U;
  }
  mx_mma::cp_async_commit();
  sum_slabs(p.pb, p.s_row, (size_t)n, 1, 0, n, xs, 0);
  staged();
  const bf16* x2 = reinterpret_cast<const bf16*>(ep + 2 * U);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int u = i % U;
    float acc = xs[i];
    if (Q) acc = __fmul_rn(acc, s2[u]);
    const float y = rb(__fadd_rn(acc, b2[u]));
    const float v = rb(__fadd_rn(staged_or_l2(p, x2, p.x2, i), y));
    xs[i] = v;
    if (store) p.x[i] = __float2bfloat16(v);
  }
  __syncthreads();
}

template <bool Q>
__device__ void phase_qkv(const Params& p, int layer, float* smem,
                          float* sred) {
  const int QS = p.proj_lo * p.CW;
  const int items = col_items<Q>(p, QS, p.s_qkv);
  if (blockIdx.x >= items) return;
  const ColSmem c = col_smem(p, smem);
  const float* gb = stage_norm(p, layer, 0, c.gb);
  mx_mma::cp_async_commit();
  residual<Q>(p, layer, c.xs, c.ep, blockIdx.x == 0);
  norm_rows(p, gb, c.xs, sred);
  for (int it = blockIdx.x; it < items; it += gridDim.x)
    col_item<Q>(p, layer, 0, QS, p.s_qkv, it, c.xs, c.red, p.pa);
}

// ------------------------------------------------------------------------
// B1, B2: attention of item (b, kv, c), it = (b * KV + kv) * nc + c, over
// positions [c * lc, min(pos + 1, (c + 1) * lc))

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

// dst[e] = the compute-dtype qkv column col(e) of batch row b, for e <
// ne: a thread's two elements at a time, every slab partial, bias and
// scale load issued before the first add
template <bool Q, class Col>
__device__ void qkv_cols(const Params& p, int layer, int b, int ne, Col col,
                         float* dst) {
  const int QS = p.proj_lo * p.CW;
  for (int e0 = threadIdx.x; e0 < ne; e0 += 2 * kThreads) {
    float v[2][kMaxSlabs], sv[2], bv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = e0 + j * kThreads;
      const int n = e < ne ? col(e) : 0;
#pragma unroll
      for (int s = 0; s < kMaxSlabs; ++s)
        v[j][s] = e < ne && s < p.s_qkv
                      ? __ldcg(p.pa + ((size_t)s * p.B + b) * QS + n)
                      : 0.f;
      const size_t bi = col_index(p, layer * p.NC, n);
      sv[j] = scale_of<Q>(p, bi);
      bv[j] = bias_of<Q>(p, bi);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = e0 + j * kThreads;
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSlabs; ++s)
        if (s < p.s_qkv) a = __fadd_rn(a, v[j][s]);
      if (e < ne) dst[e] = out_val<Q>(a, sv[j], bv[j]);
    }
  }
  __syncthreads();
}

struct AttnItem {
  int b, kv, c, t0, t1;
  size_t cache;  // offset of (layer, b, kv) in the caches
};

__device__ __forceinline__ AttnItem attn_item(const Params& p, int layer,
                                              int it) {
  AttnItem a;
  a.b = it / (p.KV * p.nc);
  a.kv = it / p.nc % p.KV;
  a.c = it % p.nc;
  a.t0 = a.c * p.lc;
  a.t1 = min(p.pos + 1, a.t0 + p.lc);
  a.cache = (((size_t)layer * p.B + a.b) * p.KV + a.kv) * p.T * p.D;
  return a;
}

// the shared memory of attention: the scores (slot, G, lc) f32, a slot an
// item of the block where the plan keeps them across B1 -> B2 (p.keep),
// else one; then a work region of max(G + 2, pv_rows * gm) rows of D f32:
// the item's q heads, k and v (B1, and q again in a B2 that computes the
// scores anew), then the p.V warp partials (B2)
__device__ __forceinline__ float* attn_scores(const Params& p, float* smem,
                                              int slot) {
  return smem + (size_t)(p.keep ? slot : 0) * (p.H / p.KV) * p.lc;
}

__device__ __forceinline__ float* attn_work(const Params& p, float* smem) {
  const int items = p.B * p.KV * p.nc;
  const int slots = p.keep ? (items + gridDim.x - 1) / gridDim.x : 1;
  return smem + (size_t)slots * (p.H / p.KV) * p.lc;
}

// the item's G query heads into qv (G, D), rotated for Llama; with has_pos
// also its k (rotated) and v into the next two rows and into the caches
// at pos; ends in a block barrier
template <bool Q>
__device__ void item_queries(const Params& p, int layer, const AttnItem& a,
                             bool has_pos, float* qv) {
  const int G = p.H / p.KV, D = p.D, U = p.U, KVD = p.KV * D;
  const int kvc = a.kv * D, rows = has_pos ? G + 2 : G;
  qkv_cols<Q>(p, layer, a.b, rows * D,
              [&](int e) {
                const int r = e / D, d = e % D;
                return r < G ? kvc * G + r * D + d
                             : U + (r - G) * KVD + kvc + d;
              },
              qv);
  // a thread's own pairs, in place: RoPE on q and k, then k and v to pos
  for (int i = threadIdx.x; i < rows * D / 2; i += kThreads) {
    const int r = 2 * i / D, d = 2 * i % D;
    float* v = qv + 2 * i;
    if (p.llama && r <= G) rope_pair(v[0], v[1], p.pos, p.rope[d]);
    if (r >= G) {
      bf16* c = (r == G ? p.kh : p.vh) + a.cache + (size_t)p.pos * D + d;
      c[0] = __float2bfloat16(v[0]);
      c[1] = __float2bfloat16(v[1]);
    }
  }
  __syncthreads();
}

// the item's scores q.k * scale into sc (G, lc): a warp a position, lanes
// over the head dim's pairs, the K rows of kPos positions in flight at a
// time, read from L2 (the row at pos was written in this launch), so B2
// computing them anew gets the same bits; ends in a block barrier
__device__ void item_scores(const Params& p, const AttnItem& a,
                            const float* qs, float* sc) {
  const int G = p.H / p.KV, D = p.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kc = p.kh + a.cache;
  for (int t = a.t0 + warp; t < a.t1; t += kPos * kWarps) {
    float2 kk[kPos][2];
#pragma unroll
    for (int i = 0; i < kPos; ++i) {
      const int ti = t + i * kWarps;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d2 = lane + 32 * j;
        kk[i][j] = ti < a.t1 && d2 < D / 2
                       ? __bfloat1622float2(__ldcg(
                             reinterpret_cast<const __nv_bfloat162*>(
                                 kc + (size_t)ti * D) + d2))
                       : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kPos; ++i) {
      const int ti = t + i * kWarps;
      if (ti >= a.t1) break;
      for (int g = 0; g < G; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int d2 = lane + 32 * j;
          if (d2 < D / 2) {
            acc = fmaf(qs[g * D + 2 * d2], kk[i][j].x, acc);
            acc = fmaf(qs[g * D + 2 * d2 + 1], kk[i][j].y, acc);
          }
        }
        acc = warp_sum(acc);
        if (lane == 0) sc[g * p.lc + ti - a.t0] = __fmul_rn(acc, p.scale);
      }
    }
  }
  __syncthreads();
}

template <bool Q>
__device__ void phase_attn1(const Params& p, int layer, float* smem) {
  const int G = p.H / p.KV;
  const int items = p.B * p.KV * p.nc;
  float* qv = attn_work(p, smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int slot = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++slot) {
    const AttnItem a = attn_item(p, layer, it);
    float* sc = attn_scores(p, smem, slot);
    const bool has_pos = a.t0 <= p.pos && p.pos < a.t1;
    __syncthreads();  // the previous item's readers of qv and sc are done
    item_queries<Q>(p, layer, a, has_pos, qv);
    item_scores(p, a, qv, sc);
    // the chunk's max and sum of exp, per head (a warp a head)
    const int len = a.t1 - a.t0;
    for (int g = warp; g < G; g += kWarps) {
      const float* s = sc + g * p.lc;
      float m = -3.0e38f;
      for (int t = lane; t < len; t += 32) m = fmaxf(m, s[t]);
      m = warp_max(m);
      float l = 0.f;
      for (int t = lane; t < len; t += 32)
        l = __fadd_rn(l, expf(__fsub_rn(s[t], m)));
      l = warp_sum(l);
      if (lane == 0) {
        p.pst[((size_t)it * G + g) * 2] = m;
        p.pst[((size_t)it * G + g) * 2 + 1] = l;
      }
    }
  }
}

template <bool Q>
__device__ void phase_attn2(const Params& p, int layer, float* smem) {
  const int G = p.H / p.KV, D = p.D, U = p.U;
  const int items = p.B * p.KV * p.nc;
  const int gm = p.gm, R = p.pv_rows;
  float* work = attn_work(p, smem);  // q (G, D), then (R, gm, D) partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int slot = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++slot) {
    const AttnItem a = attn_item(p, layer, it);
    float* sc = attn_scores(p, smem, slot);
    if (!p.keep) {  // the scores B1 computed, once more
      __syncthreads();
      item_queries<Q>(p, layer, a, false, work);
      item_scores(p, a, work, sc);
    }
    const bf16* vc = p.vh + a.cache;
    const int len = a.t1 - a.t0;
    const int first = it - a.c;  // this (b, kv)'s chunk 0
    // softmax over all positions <= pos: the global max, the sum of the
    // chunks' sums rescaled to it, in chunk order; p cast to bf16
    for (int g = warp; g < G; g += kWarps) {
      float m = -3.0e38f;
      for (int c = lane; c < p.nc; c += 32)
        m = fmaxf(m, __ldcg(p.pst + ((size_t)(first + c) * G + g) * 2));
      m = warp_max(m);
      float l = 0.f;
      for (int c0 = 0; c0 < p.nc; c0 += 32) {
        float term = 0.f;
        if (c0 + lane < p.nc) {
          const float* st = p.pst + ((size_t)(first + c0 + lane) * G + g) * 2;
          term = __fmul_rn(__ldcg(st + 1), expf(__fsub_rn(__ldcg(st), m)));
        }
        for (int i = 0; i < min(32, p.nc - c0); ++i)
          l = __fadd_rn(l, __shfl_sync(0xffffffffu, term, i));
      }
      float* s = sc + g * p.lc;
      for (int t = lane; t < len; t += 32)
        s[t] = rb(__fdiv_rn(expf(__fsub_rn(s[t], m)), l));
    }
    __syncthreads();
    // the chunk's p.V in f32: a warp per position, lanes over D's pairs,
    // gm heads of the group at once; then the warps in a fixed order, R
    // at a time into R rows, and the rows in order
    for (int g0 = 0; g0 < G; g0 += gm) {
      const int gn = min(gm, G - g0);
      float acc[kGMax][4];
#pragma unroll
      for (int g = 0; g < kGMax; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
      for (int t = a.t0 + warp; t < a.t1; t += kPos * kWarps) {
        float2 vv[kPos][2];
#pragma unroll
        for (int i = 0; i < kPos; ++i) {
          const int ti = t + i * kWarps;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int d2 = lane + 32 * j;
            vv[i][j] = ti < a.t1 && d2 < D / 2
                           ? __bfloat1622float2(__ldcg(
                                 reinterpret_cast<const __nv_bfloat162*>(
                                     vc + (size_t)ti * D) + d2))
                           : make_float2(0.f, 0.f);
          }
        }
#pragma unroll
        for (int i = 0; i < kPos; ++i) {
          const int ti = t + i * kWarps;
          if (ti >= a.t1) break;
#pragma unroll
          for (int g = 0; g < kGMax; ++g) {
            if (g < gn) {
              const float pg = sc[(g0 + g) * p.lc + ti - a.t0];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                acc[g][2 * j] = fmaf(pg, vv[i][j].x, acc[g][2 * j]);
                acc[g][2 * j + 1] = fmaf(pg, vv[i][j].y, acc[g][2 * j + 1]);
              }
            }
          }
        }
      }
      for (int w0 = 0; w0 < kWarps; w0 += R) {
        if (warp >= w0 && warp < w0 + R) {
#pragma unroll
          for (int g = 0; g < kGMax; ++g) {
            if (g < gn) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int d2 = lane + 32 * j;
                if (d2 < D / 2) {
                  float* r = work + ((warp - w0) * gm + g) * D + 2 * d2;
                  r[0] = w0 ? __fadd_rn(r[0], acc[g][2 * j]) : acc[g][2 * j];
                  r[1] = w0 ? __fadd_rn(r[1], acc[g][2 * j + 1])
                            : acc[g][2 * j + 1];
                }
              }
            }
          }
        }
        __syncthreads();
      }
      for (int i = threadIdx.x; i < gn * D; i += kThreads) {
        const int g = i / D, d = i % D;
        float r = 0.f;
        for (int w = 0; w < R; ++w) r += work[(w * gm + g) * D + d];
        p.po[((size_t)a.c * p.B + a.b) * U + a.kv * G * D + (g0 + g) * D + d] =
            r;
      }
      __syncthreads();
    }
  }
}

// L2 prefetch of the K rows of the block's first attention item
__device__ void prefetch_keys(const Params& p, int layer) {
  if (blockIdx.x >= p.B * p.KV * p.nc) return;
  const AttnItem a = attn_item(p, layer, blockIdx.x);
  const char* k = reinterpret_cast<const char*>(p.kh + a.cache);
  const int bytes = (a.t1 - a.t0) * p.D * 2;
  for (int o = threadIdx.x * 128; o < bytes; o += kThreads * 128)
    prefetch_l2(k + (size_t)a.t0 * p.D * 2 + o);
}

// ------------------------------------------------------------------------
// C: o = bf16(sum of the chunk p.V partials, chunk order); proj partials

template <bool Q>
__device__ void phase_proj(const Params& p, int layer, float* smem) {
  const int U = p.U, B = p.B;
  const int items = col_items<Q>(p, U, p.s_proj);
  const int T = items / p.s_proj;
  const ColSmem c = col_smem(p, smem);
  float* xs = c.xs;
  float* red = c.red;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int slab = it / T;
    const int k0 = slab_lo(slab, p.s_proj, U);
    const int n = slab_lo(slab + 1, p.s_proj, U) - k0;
    __syncthreads();  // the previous item's readers of xs are done
    sum_slabs(p.po + k0, p.nc, (size_t)B * U, B, U, n, xs + k0, U);
    for (int i = threadIdx.x; i < B * n; i += kThreads) {
      float* o = xs + (size_t)(i / n) * U + k0 + i % n;
      *o = rb(*o);
    }
    __syncthreads();
    col_item<Q>(p, layer, p.proj_lo, U, p.s_proj, it, xs, red, p.pb);
  }
}

// ------------------------------------------------------------------------
// D: x2 = x + proj, xn2 = norm2(x2); fc1 | gate+up partials to pa

template <bool Q>
__device__ void phase_ffn(const Params& p, int layer, float* smem,
                          float* sred) {
  const int U = p.U, W = (p.row_lo - p.ffn_lo) * p.CW, n = p.B * U;
  const int items = col_items<Q>(p, W, p.s_ffn);
  if (blockIdx.x >= items) return;
  const ColSmem c = col_smem(p, smem);
  // norm2's rows, proj's bias (and int8 scale) and x, staged while the
  // proj partials load
  const size_t pc = (size_t)(layer * p.NC + p.proj_lo) * p.CW;
  const float* gb = stage_norm(p, layer, 2, c.gb);
  const void* bs = static_cast<const char*>(p.bstream) + pc * (Q ? 4 : 2);
  const float* ss = p.sstream + pc;
  if (p.stage) {
    stage(c.ep, bs, (Q ? 4 : 2) * U);
    if (Q) stage(c.ep + U, ss, 4 * U);
    stage(c.ep + 2 * U, p.x, 2 * n);
    bs = c.ep;
    ss = c.ep + U;
  }
  mx_mma::cp_async_commit();
  sum_slabs(p.pb, p.s_proj, (size_t)n, 1, 0, n, c.xs, 0);
  staged();
  const bf16* x = reinterpret_cast<const bf16*>(c.ep + 2 * U);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int u = i % U;
    const float bi =
        Q ? static_cast<const float*>(bs)[u]
          : __bfloat162float(static_cast<const bf16*>(bs)[u]);
    const float v = rb(__fadd_rn(staged_or_l2(p, x, p.x, i),
                                 out_val<Q>(c.xs[i], Q ? ss[u] : 1.f, bi)));
    c.xs[i] = v;
    if (blockIdx.x == 0) p.x2[i] = __float2bfloat16(v);
  }
  __syncthreads();
  norm_rows(p, gb, c.xs, sred);
  for (int it = blockIdx.x; it < items; it += gridDim.x)
    col_item<Q>(p, layer, p.ffn_lo, W, p.s_ffn, it, c.xs, c.red, p.pa);
}

// ------------------------------------------------------------------------
// E: fc2 / down, item = s * g_row + g: F slab s (chunks [s * n / S,
// (s + 1) * n / S) of the span's n), output rows of group g; partials
// pb[(s * B + b) * U + u]

struct RowItem {
  int c0, c1, u0, u1;
};

__device__ __forceinline__ RowItem row_item(const Params& p, int it) {
  const int n = p.NC - p.row_lo, s = it / p.g_row, g = it % p.g_row;
  return {s * n / p.s_row, (s + 1) * n / p.s_row, g * p.U / p.g_row,
          (g + 1) * p.U / p.g_row};
}

// v[b][i] = the compute-dtype output of the span's column i (i < len)
// from its f32 sum in v, with the columns' bias (bf16 packed, or f32) in
// bs and int8 scales in ss, staged in shared memory
template <bool Q>
__device__ void ffn_out(const Params& p, int len, float* v, const float* bs,
                        const float* ss) {
  for (int i = threadIdx.x; i < p.B * len; i += kThreads) {
    const int j = i % len;
    const float bi =
        Q ? bs[j] : __bfloat162float(reinterpret_cast<const bf16*>(bs)[j]);
    v[i] = out_val<Q>(v[i], Q ? ss[j] : 1.f, bi);
  }
  __syncthreads();
}

// the item's output rows, a warp a row: lanes over the slab's 16-byte
// segments (kBatch in flight), the warp's sums by an xor tree, to
// pb[(s * B + b) * U + u]
template <bool Q, int BR>
__device__ void row_dots(const Params& p, const RowItem& r, int s,
                         size_t wbase, int segs, int nseg, const float* hs,
                         int flen) {
  constexpr int E = Wt<Q>::E, NB = kBatch<Q, BR>;
  const int U = p.U, B = p.B, CW = p.CW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int u = r.u0 + warp; u < r.u1; u += kWarps) {
    float acc[BR];
#pragma unroll
    for (int b = 0; b < BR; ++b) acc[b] = 0.f;
    auto seg = [&](int qi) {
      return qi < nseg
                 ? raw16<Q>(p.w, wbase + ((size_t)(qi / segs) * U + u) * CW +
                                     (qi % segs) * E)
                 : make_uint4(0u, 0u, 0u, 0u);
    };
    // double-buffered, as in col_item_rows
    uint4 cur[NB], nxt[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) cur[i] = seg(lane + i * 32);
    for (int q = lane; q < nseg; q += NB * 32) {
#pragma unroll
      for (int i = 0; i < NB; ++i) nxt[i] = seg(q + (NB + i) * 32);
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int qi = q + i * 32;
        if (qi >= nseg) break;
        float w[E];
        cvt16<Q>(cur[i], w);
        const float* h = hs + qi * E;
#pragma unroll
        for (int b = 0; b < BR; ++b)
          if (b < B)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[b] = fmaf(h[(size_t)b * flen + e], w[e], acc[b]);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) cur[i] = nxt[i];
    }
#pragma unroll
    for (int b = 0; b < BR; ++b) {
      if (b >= B) break;
      const float v = warp_sum(acc[b]);
      if (lane == 0) p.pb[((size_t)s * B + b) * U + u] = v;
    }
  }
}

template <bool Q>
__device__ void phase_row(const Params& p, int layer, float* smem) {
  constexpr int E = Wt<Q>::E;
  const int U = p.U, B = p.B, CW = p.CW, F = p.F;
  const int items = p.s_row * p.g_row;
  const int W = (p.row_lo - p.ffn_lo) * CW;  // fc1 | gate+up width
  float* hs = smem;                           // (B, flen)
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const RowItem r = row_item(p, it);
    const int s = it / p.g_row;
    const int f0 = r.c0 * CW, flen = (r.c1 - r.c0) * CW;
    __syncthreads();  // the previous item's readers of hs are done
    // h = act(fc1) | silu(gate) * up on the slab, gate (or fc1) first;
    // the slab's bias (and scale) rows staged while its partials load
    float* us = hs + (size_t)B * flen;                // (B, flen) up
    float* st = us + (p.llama ? (size_t)B * flen : 0);  // (4, flen)
    const size_t bc = (size_t)(layer * p.NC + p.ffn_lo) * CW + f0;
    for (int part = 0; part < (p.llama ? 2 : 1); ++part) {
      const size_t bi = bc + (size_t)part * F;
      stage(st + 2 * part * flen,
            static_cast<const char*>(p.bstream) + bi * (Q ? 4 : 2),
            (Q ? 4 : 2) * flen);
      if (Q) stage(st + (2 * part + 1) * flen, p.sstream + bi, 4 * flen);
    }
    mx_mma::cp_async_commit();
    sum_slabs(p.pa + f0, p.s_ffn, (size_t)B * W, B, W, flen, hs, flen);
    staged();
    ffn_out<Q>(p, flen, hs, st, st + flen);
    if (p.llama) {
      sum_slabs(p.pa + F + f0, p.s_ffn, (size_t)B * W, B, W, flen, us,
                flen);
      ffn_out<Q>(p, flen, us, st + 2 * flen, st + 3 * flen);
      // g * sigmoid(g) * u, each product rounded to bf16
      for (int i = threadIdx.x; i < B * flen; i += kThreads) {
        const float z = hs[i];
        const float sg = rb(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z))));
        hs[i] = rb(__fmul_rn(rb(__fmul_rn(z, sg)), us[i]));
      }
    } else {
      for (int i = threadIdx.x; i < B * flen; i += kThreads) {
        const float z = hs[i];
        hs[i] = p.act == 1 ? rb(gelu_tanh(z)) : p.act == 2 ? fmaxf(z, 0.f) : z;
      }
    }
    __syncthreads();
    const int segs = CW / E, nseg = (r.c1 - r.c0) * segs;
    const size_t wbase = (size_t)(layer * p.NC + p.row_lo + r.c0) * U * CW;
    if (B == 1)
      row_dots<Q, 1>(p, r, s, wbase, segs, nseg, hs, flen);
    else if (B == 2)
      row_dots<Q, 2>(p, r, s, wbase, segs, nseg, hs, flen);
    else
      row_dots<Q, 4>(p, r, s, wbase, segs, nseg, hs, flen);
  }
}

template <bool Q>
__device__ void prefetch_row(const Params& p, int layer) {
  if (blockIdx.x >= p.s_row * p.g_row) return;
  const RowItem r = row_item(p, blockIdx.x);
  const int CW = p.CW, lines = CW * Wt<Q>::bytes / 128;
  const int rows = r.u1 - r.u0, n = (r.c1 - r.c0) * rows * max(lines, 1);
  const char* w = static_cast<const char*>(p.w);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = i / (rows * max(lines, 1)), rest = i % (rows * max(lines, 1));
    const int u = r.u0 + rest / max(lines, 1), l = rest % max(lines, 1);
    prefetch_l2(w + (((size_t)(layer * p.NC + p.row_lo + r.c0 + c) * p.U + u) *
                         CW) * Wt<Q>::bytes + (size_t)l * 128);
  }
}

// after the last layer: x = x2 + bf16(fc2 / down sum (* s2) + b2)
template <bool Q>
__device__ void phase_out(const Params& p) {
  const int U = p.U, n = p.B * U;
#pragma unroll 4
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int b = i / U, u = i % U;
    const size_t lu = (size_t)(p.NL - 1) * U + u;
    float acc = slab_sum(p.pb, p.s_row, p.B, U, b, u);
    if (Q) acc = __fmul_rn(acc, p.s2[lu]);
    const float y = rb(__fadd_rn(acc, p.bias2[lu]));
    p.x[i] = __float2bfloat16(__fadd_rn(ldcg(p.x2 + i), y));
  }
}

template <bool Q>
__global__ void __launch_bounds__(kThreads, 2)
    decode_fused_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ float sred[32];
  cg::grid_group grid = cg::this_grid();
  const int QS = p.proj_lo * p.CW, FW = (p.row_lo - p.ffn_lo) * p.CW;
  for (int layer = 0; layer < p.NL; ++layer) {
    phase_qkv<Q>(p, layer, smem, sred);
    prefetch_keys(p, layer);
    grid.sync();
    phase_attn1<Q>(p, layer, smem);
    grid.sync();
    phase_attn2<Q>(p, layer, smem);
    prefetch_col<Q>(p, layer, p.proj_lo, p.U, p.s_proj, blockIdx.x);
    grid.sync();
    phase_proj<Q>(p, layer, smem);
    prefetch_col<Q>(p, layer, p.ffn_lo, FW, p.s_ffn, blockIdx.x);
    grid.sync();
    phase_ffn<Q>(p, layer, smem, sred);
    prefetch_row<Q>(p, layer);
    grid.sync();
    phase_row<Q>(p, layer, smem);
    prefetch_col<Q>(p, layer + 1, 0, QS, p.s_qkv, blockIdx.x);
    grid.sync();
  }
  phase_out<Q>(p);
}

const void* kernel_of(int quant) {
  return quant ? reinterpret_cast<const void*>(&decode_fused_kernel<true>)
               : reinterpret_cast<const void*>(&decode_fused_kernel<false>);
}

}  // namespace

// The cooperative grid for this device, stream type and shared memory:
// sets the kernel's dynamic shared memory limit and asks the occupancy
// calculator (2 blocks a SM at most).  The wrapper caches the answer per
// (device, stream type, shared memory bytes) and launches with it.
extern "C" int decode_fused_grid(int quant, int smem, int* grid_out) {
  // the limit only ever rises, so a launch with a grid asked for before,
  // at fewer bytes, stays valid
  static int limit[2][64];
  const void* fn = kernel_of(quant);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > limit[quant ? 1 : 0][dev]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    limit[quant ? 1 : 0][dev] = smem;
  }
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(e);
  // every block must be resident at once for the grid barriers
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *grid_out = (per_sm < 2 ? per_sm : 2) * sms;
  return 0;
}

extern "C" int decode_fused_launch(
    void* x, const void* w, const void* bstream, const void* sstream,
    const void* norms, const void* bias2, const void* s2, const void* rope,
    void* kh, void* vh, void* x2, void* pa, void* pb, void* po, void* pst,
    int pos, int quant, int NL, int B, int U, int F, int H, int KV, int D,
    int T, int CW, int NC, int proj_lo, int ffn_lo, int row_lo, int llama,
    int act, int s_qkv, int s_proj, int s_ffn, int s_row, int g_row, int nc,
    int lc, int keep, int gm, int pv_rows, int stage, int grid, float eps,
    float scale, int smem, void* stream) {
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
  p.x2 = static_cast<bf16*>(x2);
  p.pa = static_cast<float*>(pa);
  p.pb = static_cast<float*>(pb);
  p.po = static_cast<float*>(po);
  p.pst = static_cast<float*>(pst);
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
  p.row_lo = row_lo;
  p.llama = llama;
  p.act = act;
  p.s_qkv = s_qkv;
  p.s_proj = s_proj;
  p.s_ffn = s_ffn;
  p.s_row = s_row;
  p.g_row = g_row;
  p.nc = nc;
  p.lc = lc;
  p.keep = keep;
  p.gm = gm;
  p.pv_rows = pv_rows;
  p.stage = stage;
  p.eps = eps;
  p.scale = scale;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_of(quant), dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_fused_design() {
  return "cooperative megakernel, six grid barriers a layer; weight phases "
         "cut into equal-byte items (128-byte column tile x 2 K slabs; F "
         "slab x row group, one a block), f32 slab partials summed in slab "
         "order by the consuming phase; 16-byte loads (int8 codes to f32 by "
         "byte_perm); attention split over position chunks, two passes "
         "with scores in shared memory (computed again in the second where "
         "a block's items do not fit), a warp per K/V row; L2 prefetch of "
         "the next phase's first weight rows before each barrier; shared "
         "memory fitted to every configuration the gate admits";
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
