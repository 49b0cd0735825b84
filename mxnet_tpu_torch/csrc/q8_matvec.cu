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
// limit, so the floor is the int8 codes over 3.35 TB/s.  At B = 8 the
// FMAs alone (8 a code) would take as long as the bytes, so wide batches
// multiply on the tensor cores instead.
//
// What the design does about it (ops/q8_matvec.py::plan sizes the grid):
// - a unit is (row group of R batch rows, 128 output columns); the K
//   axis of every unit is cut into as many slices as it takes to put a
//   block on every SM, even for GPT-2's 768-column projections; a slice
//   writes its (R, 128) partial to scratch, coalesced, and the last slice
//   of a unit to finish (an integer ticket taken with acquire-release
//   order, never an atomic on a value) sums the partials in slice order,
//   so the result repeats bit for bit;
// - every lane loads 16 codes at once (one 16-byte load) and has the next
//   batch of loads in flight while it multiplies the current one;
// - R (1, 2, 4, 8) is a template argument, so registers scale with B;
// - bf16 x with R >= 4 (the server's pools): mma.sync m16n8k16 with the
//   codes as the A operand (16 output columns by 16 K rows, exact as
//   bf16) and x as B (K rows by 8 batch rows), straight from registers:
//   a lane's four 16-byte row loads give it the A fragments of 8 tiles,
//   each tile taking columns (2q, 2q + 1) of the lane's 16, so no shared
//   memory transpose is needed; the 8 warps split the slice's K steps;
// - f32 x, and R <= 2: CUDA-core FMAs, 8 lanes across the 128 columns and
//   32 row lanes down the slice, x staged in shared memory as f32;
// - codes become floats in registers (a byte_perm into the mantissa of
//   2^23 and one subtraction, not the conversion unit); nothing
//   dequantized goes back to memory; the epilogue rounds twice as the
//   reference: (acc * s), then + bias.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kCols = 16;                         // codes a lane loads at once
constexpr int kColLanes = 8;                      // lanes across a tile
constexpr int kTN = kCols * kColLanes;            // 128 columns a unit
constexpr int kRowLanes = kThreads / kColLanes;   // FMA path: rows a pass
constexpr int kWarps = kThreads / 32;
constexpr int kSmemFloats = 8192;  // 32 KB: the FMA path's x slice
constexpr int kSlotLd = 33;        // a warp's sums: [i][lane], padded rows
constexpr int kSlots = 32 * kSlotLd;              // partial slots a warp

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// byte j of a code word already XORed with 0x80808080 -> the exact code
// as f32: the biased byte in the low mantissa byte of 2^23, less 2^23+128
__device__ __forceinline__ float code_f32(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | j)) -
         8388736.0f;
}

// 16 codes from p (columns col..col+15 of one row); the unaligned path
// reads bytes and gives 0 past column O
template <bool VEC>
__device__ __forceinline__ uint4 load16(const int8_t* p, int col, int O) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (col + j < O)
      w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + j)))
                   << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 bias80(uint4 v) {
  return make_uint4(v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                    v.z ^ 0x80808080u, v.w ^ 0x80808080u);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A unit is (row group, 128-column tile), u = group * ctiles + tile.
// Block b takes slice j = b / units of unit b % units (so the blocks that
// run together read the same K rows of neighbouring columns); slice j of
// n = blocks / units holds the 16-row steps [j * S / n, (j + 1) * S / n)
// of the S = ceil(K / 16) steps of K (the last one ragged).
struct Work {
  int unit, j, n;
};

__device__ __forceinline__ Work block_work(int units) {
  return {(int)(blockIdx.x % units), (int)(blockIdx.x / units),
          (int)(gridDim.x / units)};
}

// ------------------------------------------------------------------------
// FMA path: lane (cl = lane % 8, rl = tid / 8) owns columns 16 cl .. +15
// of rows rl, rl + 32, ...; acc[r][j] for batch row r, column 16 cl + j

template <int U, bool VEC>
__device__ __forceinline__ void load_rows(uint4 (&v)[U], const int8_t* wp,
                                          int k, int kt, int col, int O) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int kk = k + u * kRowLanes;
    v[u] = kk < kt ? load16<VEC>(wp + (size_t)kk * O, col, O)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int R>
__device__ __forceinline__ void fma_row(float (&acc)[R][kCols], uint4 v,
                                        const float* xk) {
  v = bias80(v);
  float w[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) w[j] = code_f32(word(v, j >> 2), j & 3);
  float xv[R];
  if constexpr (R >= 4) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const float4 q = *reinterpret_cast<const float4*>(xk + r);
      xv[r] = q.x;
      xv[r + 1] = q.y;
      xv[r + 2] = q.z;
      xv[r + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) xv[r] = xk[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(xv[r], w[j], acc[r][j]);
}

// the slice's sums of this lane: v[i] for i < 4R, element
// fma_elem(i, lane) after the warp's reduce-scatter
template <int R, typename T, bool VEC>
__device__ __forceinline__ void slice_fma(float (&v)[4 * R], const T* x,
                                          const int8_t* wt, float* sm,
                                          int K, int O, int b0, int nb,
                                          int k0, int kt, int tile) {
  constexpr int U = R <= 2 ? 8 : 4;  // 16-byte loads a batch a lane
  const int cl = threadIdx.x % kColLanes, rl = threadIdx.x / kColLanes;
  const int col = tile * kTN + cl * kCols;
  const bool live = col < O;
  const int8_t* wp = wt + (size_t)k0 * O + col;
  uint4 cur[U], nxt[U] = {};
  int k = rl;
  // the first batch is in flight before the x slice is staged
  if (live) load_rows<U, VEC>(cur, wp, k, kt, col, O);
  const T* xb = x + (size_t)b0 * K + k0;
#pragma unroll 2
  for (int kk = threadIdx.x; kk < kt; kk += kThreads) {
    float xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      xv[r] = r < nb ? to_f32(xb[(size_t)r * K + kk]) : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) sm[kk * R + r] = xv[r];
  }
  __syncthreads();
  float acc[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  if (live) {
    for (; k < kt; k += U * kRowLanes) {
      const int kn = k + U * kRowLanes;
      if (kn < kt) load_rows<U, VEC>(nxt, wp, kn, kt, col, O);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u * kRowLanes < kt)
          fma_row<R>(acc, cur[u], sm + (k + u * kRowLanes) * R);
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
  }
  // reduce-scatter over the warp's 4 row lanes (lane bits 4, 3): lane
  // bit 4 keeps the upper half of the 16R sums, then bit 3 the upper
  // half of that; a fixed pairing, so every launch adds alike
  constexpr int N = R * kCols;
  const int lane = threadIdx.x & 31;
  float h[N / 2];
  const bool up4 = lane & 16, up3 = lane & 8;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float lo = acc[i / kCols][i % kCols];
    const float hi = acc[(i + N / 2) / kCols][(i + N / 2) % kCols];
    h[i] = (up4 ? hi : lo) + __shfl_xor_sync(0xffffffffu, up4 ? lo : hi, 16);
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float lo = h[i], hi = h[i + N / 4];
    v[i] = (up3 ? hi : lo) + __shfl_xor_sync(0xffffffffu, up3 ? lo : hi, 8);
  }
}

// the (sum i, lane) of slice_fma holding batch row r, column c of the
// tile: f = 16 r + c % 16 is sum f % 4R of the lane of column group c / 16
// whose bits 4, 3 give the quarter f / 4R
template <int R>
__device__ __forceinline__ void fma_slot(int r, int c, int& i, int& lane) {
  const int f = r * kCols + c % kCols, hq = f / (4 * R);
  i = f % (4 * R);
  lane = (hq >> 1) * 16 + (hq & 1) * 8 + c / kCols;
}

// ------------------------------------------------------------------------
// tensor-core path (bf16 x, 16-byte loads, R = 4 or 8): per K step of 16
// rows, lane (g = lane / 4, t = lane % 4) loads rows 2t, 2t+1, 2t+8, 2t+9
// of columns 16g .. 16g+15; tile q (0..7) is the m16n8k16 product whose
// A row g is column 16g + 2q and row g + 8 column 16g + 2q + 1, and whose
// B column n is batch row n.  acc[q] = (col 16g+2q: batch 2t, 2t+1;
// col 16g+2q+1: batch 2t, 2t+1).

// bf16 pair (lo = code a, hi = code b) of byte j of words a and b: the
// f32 of a code up to 128 in magnitude is exact in its upper 16 bits
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b, int j) {
  return __byte_perm(__float_as_uint(code_f32(a, j)),
                     __float_as_uint(code_f32(b, j)), 0x7632u);
}

__device__ __forceinline__ void load_step(uint4 (&v)[4], const int8_t* wp,
                                          int kk, int kt, int O, bool live) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = kk + 2 * t + (i & 1) + (i >> 1) * 8;
    v[i] = live && k < kt
               ? __ldg(reinterpret_cast<const uint4*>(wp + (size_t)k * O))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the bf16 pair (k, k + 1) of an x row at p (element k of the slice), 0
// past kt; p is 4-byte aligned (K even, slices start on 16-row steps)
__device__ __forceinline__ uint32_t x_pair(const bf16* p, int k, int kt) {
  if (k + 1 < kt) return __ldg(reinterpret_cast<const unsigned int*>(p));
  if (k < kt) return __bfloat16_as_ushort(p[0]);
  return 0u;
}

template <int R>
__device__ __forceinline__ void slice_mma(float (&v)[32], const bf16* x,
                                          const int8_t* wt, int K, int O,
                                          int b0, int nb, int k0, int kt,
                                          int tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = tile * kTN + g * kCols;
  const bool live = col < O;
  const int8_t* wp = wt + (size_t)k0 * O + col;
  // B: batch row g of x (0 past the rows given), k pairs 2t and 2t + 8
  const bool xrow = g < nb;
  const bf16* xp = x + (size_t)(b0 + (xrow ? g : 0)) * K + k0 + 2 * t;
  const int steps = (kt + 15) / 16;
  uint4 cur[4] = {}, nxt[4] = {};
  uint32_t xc[2] = {0u, 0u}, xn[2] = {0u, 0u};
  int st = warp;
  if (st < steps) {
    load_step(cur, wp, st * 16, kt, O, live);
    if (xrow) {
      xc[0] = x_pair(xp + st * 16, st * 16 + 2 * t, kt);
      xc[1] = x_pair(xp + st * 16 + 8, st * 16 + 2 * t + 8, kt);
    }
  }
  float acc[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;
  for (; st < steps; st += kWarps) {
    const int sn = st + kWarps;
    if (sn < steps) {
      load_step(nxt, wp, sn * 16, kt, O, live);
      if (xrow) {
        xn[0] = x_pair(xp + sn * 16, sn * 16 + 2 * t, kt);
        xn[1] = x_pair(xp + sn * 16 + 8, sn * 16 + 2 * t + 8, kt);
      }
    }
    uint4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bias80(cur[i]);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int wi = q >> 1, j0 = (2 * q) & 3;
      uint32_t a[4];
      a[0] = pair(word(w[0], wi), word(w[1], wi), j0);
      a[1] = pair(word(w[0], wi), word(w[1], wi), j0 + 1);
      a[2] = pair(word(w[2], wi), word(w[3], wi), j0);
      a[3] = pair(word(w[2], wi), word(w[3], wi), j0 + 1);
      mx_mma::mma(acc[q], a, xc[0], xc[1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
    xc[0] = xn[0];
    xc[1] = xn[1];
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) v[q * 4 + c] = acc[q][c];
}

// the (sum i, lane) of slice_mma holding batch row r, column c of the
// tile: lane (g, t) = (c / 16, r / 2), tile q = c % 16 / 2, and within
// the tile's four sums (col parity, row parity)
__device__ __forceinline__ void mma_slot(int r, int c, int& i, int& lane) {
  const int cm = c % kCols;
  i = (cm >> 1) * 4 + (cm & 1) * 2 + (r & 1);
  lane = (c / kCols) * 4 + (r >> 1);
}

// ------------------------------------------------------------------------

__device__ __forceinline__ int ticket_take(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// MMA selects the tensor-core path (bf16 x, VEC, R >= 4)
template <int R, typename T, bool VEC, bool MMA>
__global__ void __launch_bounds__(kThreads, (R >= 8 && !MMA) ? 1 : 2)
    q8_matvec_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                     const float* __restrict__ s,
                     const float* __restrict__ bias, float* __restrict__ out,
                     float* __restrict__ part, int* __restrict__ ticket,
                     int B, int K, int O, int ctiles) {
  __shared__ __align__(16) float sm[kWarps * kSlots];
  __shared__ int last;
  const int units = ctiles * ((B + R - 1) / R);
  const Work wk = block_work(units);
  const int tile = wk.unit % ctiles;
  const int b0 = wk.unit / ctiles * R;
  const int nb = min(R, B - b0);  // never read or write past the rows given
  const int s16 = (K + 15) / 16;
  const int k0 = 16 * (int)((long long)wk.j * s16 / wk.n);
  const int kt =
      max(0, min(K, 16 * (int)((long long)(wk.j + 1) * s16 / wk.n)) - k0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // this thread's outputs: elements e = tid + 256 m of the unit's (R, 128)
  // block, row-major; their scale and bias are read while codes stream
  constexpr int EL = (R * kTN + kThreads - 1) / kThreads;
  int oe[EL];
  float so[EL], bo[EL];
#pragma unroll
  for (int m = 0; m < EL; ++m) {
    const int e = threadIdx.x + m * kThreads;
    const int r = e / kTN, o = tile * kTN + e % kTN;
    oe[m] = e < R * kTN && r < nb && o < O ? (b0 + r) * O + o : -1;
    so[m] = oe[m] >= 0 ? s[o] : 0.f;
    bo[m] = oe[m] >= 0 && bias ? bias[o] : 0.f;
  }

  constexpr int NV = MMA ? 32 : 4 * R;  // sums a lane holds
  float v[NV];
  if constexpr (MMA)
    slice_mma<R>(v, reinterpret_cast<const bf16*>(x), wt, K, O, b0, nb, k0,
                 kt, tile);
  else
    slice_fma<R, T, VEC>(v, x, wt, sm, K, O, b0, nb, k0, kt, tile);
  __syncthreads();  // every thread is done with the x slice
#pragma unroll
  for (int i = 0; i < NV; ++i) sm[warp * kSlots + i * kSlotLd + lane] = v[i];
  __syncthreads();

  // each element summed over the warps in warp order; one slice writes
  // out, more write their partials, (slice, unit, element) contiguous
  float y[EL];
  float* pu = part + ((size_t)wk.j * units + wk.unit) * (R * kTN);
#pragma unroll
  for (int m = 0; m < EL; ++m) {
    const int e = threadIdx.x + m * kThreads;
    y[m] = 0.f;
    if (e >= R * kTN) continue;
    int i, ln;
    if constexpr (MMA)
      mma_slot(e / kTN, e % kTN, i, ln);
    else
      fma_slot<R>(e / kTN, e % kTN, i, ln);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm[w * kSlots + i * kSlotLd + ln];
    y[m] = a;
    if (wk.n > 1)
      pu[e] = a;
    else if (oe[m] >= 0)
      out[oe[m]] = __fadd_rn(__fmul_rn(a, so[m]), bo[m]);
  }
  if (wk.n == 1) return;

  // the last slice of this unit to finish sums the partials in slice
  // order (release: the block's partial stores come before the ticket;
  // acquire: the other slices' partials are visible after it); the
  // ticket goes back to 0 for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    last = ticket_take(ticket + wk.unit) == wk.n - 1;
    if (last) ticket[wk.unit] = 0;
  }
  __syncthreads();
  if (!last) return;
  constexpr int kSp = 8;  // slices loaded at once
  const size_t stride = (size_t)units * R * kTN;
  const float* p0 = part + (size_t)wk.unit * R * kTN;
#pragma unroll
  for (int m = 0; m < EL; ++m) y[m] = 0.f;
  for (int sp = 0; sp < wk.n; sp += kSp) {
    float q[kSp][EL];
#pragma unroll
    for (int j = 0; j < kSp; ++j)
#pragma unroll
      for (int m = 0; m < EL; ++m) {
        const int e = threadIdx.x + m * kThreads;
        q[j][m] = oe[m] >= 0 && sp + j < wk.n
                      ? __ldcg(p0 + (sp + j) * stride + e)
                      : 0.f;
      }
#pragma unroll
    for (int j = 0; j < kSp; ++j)
#pragma unroll
      for (int m = 0; m < EL; ++m)
        if (sp + j < wk.n) y[m] = __fadd_rn(y[m], q[j][m]);
  }
  // two roundings, as the reference: (acc * s) then + bias
#pragma unroll
  for (int m = 0; m < EL; ++m)
    if (oe[m] >= 0) out[oe[m]] = __fadd_rn(__fmul_rn(y[m], so[m]), bo[m]);
}

template <int R, typename T>
cudaError_t launch_rows(const void* x, const int8_t* w, const float* s,
                        const float* b, float* y, float* part, int* ticket,
                        int B, int K, int O, int blocks, bool vec,
                        bool mma, cudaStream_t st) {
  const int ctiles = (O + kTN - 1) / kTN;
  const T* xt = static_cast<const T*>(x);
  constexpr bool kMma = R >= 4 && sizeof(T) == 2;
  if (kMma && mma)
    q8_matvec_kernel<R, T, true, kMma><<<blocks, kThreads, 0, st>>>(
        xt, w, s, b, y, part, ticket, B, K, O, ctiles);
  else if (vec)
    q8_matvec_kernel<R, T, true, false><<<blocks, kThreads, 0, st>>>(
        xt, w, s, b, y, part, ticket, B, K, O, ctiles);
  else
    q8_matvec_kernel<R, T, false, false><<<blocks, kThreads, 0, st>>>(
        xt, w, s, b, y, part, ticket, B, K, O, ctiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int rows, const void* x, const int8_t* w,
                         const float* s, const float* b, float* y,
                         float* part, int* ticket, int B, int K, int O,
                         int blocks, bool vec, bool mma, cudaStream_t st) {
  switch (rows) {
    case 1:
      return launch_rows<1, T>(x, w, s, b, y, part, ticket, B, K, O, blocks,
                               vec, mma, st);
    case 2:
      return launch_rows<2, T>(x, w, s, b, y, part, ticket, B, K, O, blocks,
                               vec, mma, st);
    case 4:
      return launch_rows<4, T>(x, w, s, b, y, part, ticket, B, K, O, blocks,
                               vec, mma, st);
    case 8:
      return launch_rows<8, T>(x, w, s, b, y, part, ticket, B, K, O, blocks,
                               vec, mma, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// rows, blocks: the plan of ops/q8_matvec.py::plan (the slices follow
// from them); part: (max slices, units, rows, 128) f32 scratch when a
// unit has more than one slice; ticket: one int a unit, zero before the launch and left
// zero after it.  Codes load 16 bytes at once when O is a multiple of 16
// and wt is 16-byte aligned, else byte by byte; bf16 x of 4 or more rows
// takes the tensor cores when, besides, K is even and x 4-byte aligned
// (its B operand is read as bf16 pairs).
extern "C" int q8_matvec_launch(const void* x, int x_is_bf16, const void* wt,
                                const void* s, const void* bias, void* out,
                                void* part, void* ticket, int B, int K,
                                int O, int rows, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* sc = static_cast<const float*>(s);
  const float* bi = static_cast<const float*>(bias);
  float* y = static_cast<float*>(out);
  float* pa = static_cast<float*>(part);
  int* tk = static_cast<int*>(ticket);
  const int units = (O + kTN - 1) / kTN * ((B + rows - 1) / rows);
  const int q = blocks / units, s16 = (K + 15) / 16;
  // whole slices of every unit; every slice's f32 x rows must fit the
  // shared slice of the FMA path
  if (q < 1 || blocks % units || 16 * ((s16 + q - 1) / q) * rows > kSmemFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = O % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool mma = vec && K % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const cudaError_t e =
      x_is_bf16 ? launch_typed<bf16>(rows, x, w, sc, bi, y, pa, tk, B, K, O,
                                     blocks, vec, mma, st)
                : launch_typed<float>(rows, x, w, sc, bi, y, pa, tk, B, K,
                                      O, blocks, vec, false, st);
  return static_cast<int>(e);
}

extern "C" const char* q8_matvec_design() {
  return "split-K matvec: (row group, 128-column) units, K sliced so "
         "every SM has a block, coalesced slice partials summed in slice "
         "order by the last slice (acq_rel ticket); bf16 x at 4-8 rows on "
         "mma.sync m16n8k16 (codes as A from registers, x as B), else "
         "CUDA-core FMAs; 16-byte code loads double-buffered; codes to f32 "
         "by byte_perm";
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
