// Fused backward of a 1x1 stride-1 NHWC convolution (kernel K6):
//
//     dx = dy @ W          (P, Co) x (Co, Ci), summed in f32, rounded once
//                          to x's dtype
//     dW = dy^T @ x        (Co, P) x (P, Ci), summed in f32, kept in f32
//
// Replaces the TPU kernel mxnet_tpu/ops/conv_fused.py::_conv1x1_bwd_pair
// (Pallas body _bwd_pair_kernel).  dy is (P, Co), x is (P, Ci) and W is
// (Co, Ci), all bf16 or all f32, contiguous; P is the flattened batch and
// spatial axis.  The TPU kernel's point is that dy, the largest of the
// three for an expanding convolution, is read from device memory once for
// both products; what the card's kernels do instead is below.
//
// What bounds it on the H100: at ResNet-50's shapes (batch 128) the early
// stages are bytes (stage 1, P = 401408, 64 -> 256: 308 MB to move against
// 26 GFLOP) and the late stages operations (stage 4, P = 6272, 512 ->
// 2048: 26 GFLOP against 40 MB).  The least time is the larger of the
// bytes (dy, x and W read once, dx and the f32 dW written once) over
// 3.35 TB/s and 4*P*Ci*Co operations over the bf16 tensor-core peak.
//
// bf16 (conv1x1_bwd_mma_kernel, the path of every bf16 caller).  The TPU
// kernel walks one sequential grid over P tiles and keeps all of W and the
// whole f32 dW in VMEM; on the card neither fits a block, and a dW
// partial resident in shared memory (the first version's design) forced
// 16-column tiles at Co = 2048.  So the two products are two tiled GEMMs
// of one launch, and each block owns one output tile of one of them:
//
// - dx tiles: 128 rows of P x BN columns of Ci (BN = 128, or 64 when Ci
//   <= 64), summed over all of Co in f32 and rounded once to bf16.  dy's
//   tile is M x K in shared memory (A fragments by ldmatrix), W's K x N
//   (B fragments by ldmatrix.trans).
// - dW tiles: 128 rows of Co x BN columns of Ci, summed over one split
//   of P (split-K: rows_per_split rows, a multiple of 64; ops/conv_fused
//   plan() takes about 2048 rows a split) into an f32 partial (nsplit,
//   Co, Ci).  dy's tile is K x M (A fragments by ldmatrix.trans), x's K x
//   N (ldmatrix.trans).  A second kernel sums the partials in split
//   order, so dW repeats bit for bit (no atomics); one split writes dW.
// - Eight warps of 64 x 32 (or 32 x 32) outputs each, mma.sync m16n8k16
//   (bf16 in, f32 sums); 64-deep operand slabs stream through a
//   three-stage cp.async ring, so two slabs are in flight while one is
//   multiplied (107.5 KB of shared memory, two blocks an SM).  Rows are padded by 16 bytes so ldmatrix hits distinct
//   banks; ragged P, Ci and Co are zero-filled by cp.async's src-size 0
//   and masked on store.  An operand whose rows are not 16-byte aligned
//   (Ci or Co not a multiple of 8) takes scalar loads into the same ring.
// - The dW blocks come first in the grid, ordered split-major so that
//   neighbouring blocks share dy and x rows in L2; then the dx blocks,
//   row-tile-major so that they share dy's rows.
//
// dy is read once per product (not once for both, as in the TPU kernel):
// 2*P*Co*2 bytes of dy, P*Ci*2 of x, Co*Ci*2 of W (from L2 after the
// first tiles), P*Ci*2 of dx written, and 2*nsplit*Co*Ci*4 of partials
// (written, then read by the summing pass).  Stages 2-4 hold dy in the
// 50 MB L2 (at most 25.7 MB), so only stage 1 (P = 401408, bytes-bound)
// pays the second read from device memory.
//
// f32 (conv1x1_bwd_kernel) stays on the CUDA cores: its callers need 1e-5
// agreement, which a bf16 or TF32 product cannot give.  A block owns one
// (P chunk, Ci tile of TC columns) and walks the 64-row P tiles of its
// chunk; for each it holds the x tile in shared memory and streams dy
// and W in slabs of 32 output channels.  Each slab feeds both products:
// the dx tile's sums stay in registers across the slabs, and the slab's
// rows of the chunk's dW partial (Co x TC, resident in shared memory for
// the whole chunk) take dy_slab^T @ x_tile.  TC is the widest of
// 64/32/16/8 whose partial fits 128 KB.  Each block writes its partial to
// (chunk, Co, Ci) scratch, summed in chunk order by the same second
// kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------------
// bf16: two tiled GEMMs on the tensor cores
// ------------------------------------------------------------------------

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // tile rows: P (dx) or Co (dW)
constexpr int kBK = 64;        // depth of a streamed slab: Co (dx) or P (dW)
constexpr int kStages = 3;     // slabs in the cp.async ring
constexpr int kPad = 8;        // shared-memory row padding (elements)
// a stage holds the A slab, M x K (dx: [kBM][kBK + kPad]) or K x M (dW:
// [kBK][kBM + kPad]), then the B slab K x N ([kBK][BN + kPad])
constexpr int kAElems = kBM * (kBK + kPad) > kBK * (kBM + kPad)
                            ? kBM * (kBK + kPad)
                            : kBK * (kBM + kPad);

template <int BN>
__host__ __device__ constexpr int stage_elems() {
  return kAElems + kBK * (BN + kPad);
}

template <int BN>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t)kStages * stage_elems<BN>();
}

// rows [r0, r0 + ROWS), cols [c0, c0 + COLS) of a row-major (ld) bf16
// matrix into s[ROWS][lds]; rows at or past rlim and cols at or past clim
// are zero.  With vec (ld a multiple of 8, a 16-byte aligned base) by
// cp.async, 16 bytes a thread; otherwise by scalar loads and stores into
// the same stage, which the ring's barrier publishes as it does the
// copies.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_slab(bf16* s, int lds,
                                          const bf16* __restrict__ g,
                                          long long ld, long long r0, int c0,
                                          long long rlim, int clim,
                                          bool vec) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const long long gr = r0 + r;
    const int gc = c0 + c;
    bf16* dst = s + r * lds + c;
    if (vec) {
      const bool ok = gr < rlim && gc < clim;
      mx_mma::cp_async16(dst, ok ? g + gr * ld + gc : g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gr < rlim && gc + e < clim) ? g[gr * ld + gc + e]
                                               : __float2bfloat16(0.f);
    }
  }
}

// One output tile: acc += A[m0:+kBM, kb:ke] . B[kb:ke, n0:+BN].
// kDW false: dx, A = dy (P x Co), B = W (Co x Ci); true: dW, A = dy^T
// (dy read as K x M), B = x (P x Ci).  Warp w owns rows wm0 + [0, WM) and
// cols wn0 + [0, 32) of the tile.
template <int BN, bool kDW>
__device__ __forceinline__ void gemm_tile(
    float (&acc)[(BN == 128 ? 64 : 32) / 16][4][4], bf16* smem,
    const bf16* __restrict__ a, const bf16* __restrict__ b, long long m0,
    int n0, long long kb, long long ke, long long M, int N, long long lda,
    int ldb, bool vec_a, bool vec_b) {
  using namespace mx_mma;
  constexpr int WM = BN == 128 ? 64 : 32;  // warp tile rows
  constexpr int MT = WM / 16;
  constexpr int WARPS_N = BN / 32;
  constexpr int LA = kDW ? kBM + kPad : kBK + kPad;
  constexpr int LB = BN + kPad;
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * 32;
  const int nk = (int)((ke - kb + kBK - 1) / kBK);

  auto load = [&](int kt) {
    bf16* As = smem + (kt % kStages) * stage_elems<BN>();
    bf16* Bs = As + kAElems;
    const long long k0 = kb + (long long)kt * kBK;
    if constexpr (kDW)  // dy rows k0.., cols m0..: K x M
      load_slab<kBK, kBM>(As, LA, a, lda, k0, (int)m0, ke, (int)M, vec_a);
    else                // dy rows m0.., cols k0..: M x K
      load_slab<kBM, kBK>(As, LA, a, lda, m0, (int)k0, M, (int)ke, vec_a);
    load_slab<kBK, BN>(Bs, LB, b, ldb, k0, n0, ke, N, vec_b);
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab kt landed; every warp is done with kt - 1
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const bf16* As = smem + (kt % kStages) * stage_elems<BN>();
    const bf16* Bs = As + kAElems;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t bf[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_b_trans(bf[np], Bs, LB, ks, wn0 + np * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        if constexpr (kDW)
          ldsm_a_trans(af, As, LA, ks, wm0 + mt * 16);
        else
          ldsm_a(af, As, LA, wm0 + mt * 16, ks);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma(acc[mt][2 * np], af, bf[np][0], bf[np][1]);
          mma(acc[mt][2 * np + 1], af, bf[np][2], bf[np][3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit
}

__device__ __forceinline__ void store1(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// two neighbouring outputs; as one 4- or 8-byte store when aligned
__device__ __forceinline__ void store2(bf16* p, float x, float y,
                                       bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    store1(p, x);
    store1(p + 1, y);
  }
}
__device__ __forceinline__ void store2(float* p, float x, float y,
                                       bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    store1(p, x);
    store1(p + 1, y);
  }
}

// the accumulators of a tile into out[M][N] (row-major), masked
template <int BN, typename T>
__device__ __forceinline__ void store_tile(
    const float (&acc)[(BN == 128 ? 64 : 32) / 16][4][4], T* out,
    long long m0, int n0, long long M, int N) {
  constexpr int WM = BN == 128 ? 64 : 32;
  constexpr int WARPS_N = BN / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long r0 = m0 + (warp / WARPS_N) * WM + g;
  const int c0 = n0 + (warp % WARPS_N) * 32 + 2 * t4;
  const bool even = (N & 1) == 0;  // pairs of columns are 2-element aligned
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = r0 + mt * 16 + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = c0 + nt * 8;
        const float x = acc[mt][nt][2 * h], y = acc[mt][nt][2 * h + 1];
        if (c + 1 < N)
          store2(out + r * N + c, x, y, even);
        else if (c < N)
          store1(out + r * N + c, x);
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
    conv1x1_bwd_mma_kernel(const bf16* __restrict__ dy,
                           const bf16* __restrict__ x,
                           const bf16* __restrict__ w, bf16* __restrict__ dx,
                           float* __restrict__ part, long long P, int Ci,
                           int Co, int rows_per_split, int nsplit, int vec) {
  constexpr int WM = BN == 128 ? 64 : 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int ntn = (Ci + BN - 1) / BN;          // column tiles (Ci)
  const int ntm = (Co + kBM - 1) / kBM;        // dW row tiles (Co)
  const long long n_dw = (long long)nsplit * ntm * ntn;
  float acc[WM / 16][4][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  const long long id = blockIdx.x;
  if (id < n_dw) {
    const int split = (int)(id / (ntm * ntn));
    const int rem = (int)(id % (ntm * ntn));
    const long long m0 = (long long)(rem / ntn) * kBM;
    const int n0 = (rem % ntn) * BN;
    const long long kb = (long long)split * rows_per_split;
    const long long ke = min(P, kb + rows_per_split);
    gemm_tile<BN, true>(acc, smem, dy, x, m0, n0, kb, ke, Co, Ci, Co, Ci,
                        vec & 2, vec & 1);
    store_tile<BN>(acc, part + (size_t)split * Co * Ci, m0, n0, Co, Ci);
  } else {
    const long long t = id - n_dw;
    const long long m0 = (t / ntn) * kBM;
    const int n0 = (int)(t % ntn) * BN;
    gemm_tile<BN, false>(acc, smem, dy, w, m0, n0, 0, Co, P, Ci, Co, Ci,
                         vec & 2, vec & 4);
    store_tile<BN>(acc, dx, m0, n0, P, Ci);
  }
}

// ------------------------------------------------------------------------
// f32: CUDA cores
// ------------------------------------------------------------------------

constexpr int kTP = 64;         // P rows per tile
constexpr int kTO = 32;         // output channels per dy / W slab

// s[r * lds + c] = g[r * ldg + c] for r < row_lim and c < col_lim, else 0,
// over a rows x cols tile (cols a multiple of 8).  With vec, g's rows are
// 16-byte aligned and 8 in-bounds elements move as 32 bytes.
__device__ __forceinline__ void load_tile(float* __restrict__ s, int lds,
                                          const float* __restrict__ g,
                                          long long ldg, int rows, int cols,
                                          int row_lim, int col_lim,
                                          bool vec) {
  const int vpr = cols / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * 8;
    float* dst = s + r * lds + c;
    const float* src = g + (long long)r * ldg + c;
    if (vec && r < row_lim && c + 8 <= col_lim) {
      reinterpret_cast<float4*>(dst)[0] =
          __ldg(reinterpret_cast<const float4*>(src));
      reinterpret_cast<float4*>(dst)[1] =
          __ldg(reinterpret_cast<const float4*>(src) + 1);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dst[k] = (r < row_lim && c + k < col_lim) ? src[k] : 0.f;
    }
  }
}

template <int TC>
__global__ void __launch_bounds__(kThreads)
    conv1x1_bwd_kernel(const float* __restrict__ dy,
                       const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ dx,
                       float* __restrict__ part_out, long long P, int Ci,
                       int Co, int rows_per_chunk, int vec) {
  constexpr int LX = TC + kPad;   // row stride of xs and ws
  constexpr int LD = kTO + kPad;  // row stride of dys
  // each thread owns one column c and rows r0 + kStep * j
  constexpr int kStep = kThreads / TC;
  constexpr int kEx = kTP * TC / kThreads;   // dx values per thread
  constexpr int kEw = kTO * TC / kThreads;   // dW slab values per thread

  extern __shared__ __align__(16) unsigned char smem[];
  const int co_pad = (Co + kTO - 1) / kTO * kTO;
  float* part = reinterpret_cast<float*>(smem);        // [co_pad][TC]
  float* xs = part + (size_t)co_pad * TC;              // [kTP][LX]
  float* dys = xs + kTP * LX;                          // [kTP][LD]
  float* ws = dys + kTP * LD;                          // [kTO][LX]

  const int tid = threadIdx.x;
  const int fc = tid % TC, fr = tid / TC;
  const int c0 = blockIdx.x * TC;
  const int ncol = Ci - c0;
  const long long pb = (long long)blockIdx.y * rows_per_chunk;
  const long long pe = min(P, pb + (long long)rows_per_chunk);

  for (int i = tid; i < co_pad * TC; i += kThreads) part[i] = 0.f;

  for (long long p0 = pb; p0 < pe; p0 += kTP) {
    const int rows = (int)min((long long)kTP, pe - p0);
    __syncthreads();  // the last tile's readers of xs are done
    load_tile(xs, LX, x + p0 * Ci + c0, Ci, kTP, TC, rows, ncol, vec & 1);
    float acc[kEx];
#pragma unroll
    for (int i = 0; i < kEx; ++i) acc[i] = 0.f;

    for (int o0 = 0; o0 < Co; o0 += kTO) {
      __syncthreads();  // the last slab's readers of dys and ws are done
      load_tile(dys, LD, dy + p0 * Co + o0, Co, kTP, kTO, rows, Co - o0,
                vec & 2);
      load_tile(ws, LX, w + (long long)o0 * Ci + c0, Ci, kTO, TC, Co - o0,
                ncol, vec & 4);
      __syncthreads();
      // thread owns column fc of the dx tile (rows fr + kStep j) and of
      // the dW slab (rows fr + kStep j)
#pragma unroll 4
      for (int o = 0; o < kTO; ++o) {
        const float wv = ws[o * LX + fc];
#pragma unroll
        for (int j = 0; j < kEx; ++j)
          acc[j] = fmaf(dys[(fr + kStep * j) * LD + o], wv, acc[j]);
      }
      float a2[kEw];
#pragma unroll
      for (int j = 0; j < kEw; ++j) a2[j] = 0.f;
#pragma unroll 4
      for (int p = 0; p < kTP; ++p) {
        const float xv = xs[p * LX + fc];
#pragma unroll
        for (int j = 0; j < kEw; ++j)
          a2[j] = fmaf(dys[p * LD + fr + kStep * j], xv, a2[j]);
      }
#pragma unroll
      for (int j = 0; j < kEw; ++j)
        part[(size_t)(o0 + fr + kStep * j) * TC + fc] += a2[j];
    }

#pragma unroll
    for (int j = 0; j < kEx; ++j) {
      const int r = fr + kStep * j;
      if (r < rows && fc < ncol) dx[(p0 + r) * Ci + c0 + fc] = acc[j];
    }
  }

  __syncthreads();
  float* dst = part_out + (size_t)blockIdx.y * Co * Ci + c0;
  for (int i = tid; i < Co * TC; i += kThreads) {
    const int o = i / TC, c = i % TC;
    if (c < ncol) dst[(size_t)o * Ci + c] = part[i];
  }
}

// dW[i] = sum over chunks (splits) k in order of part[k][i]
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ dw, int nchunks,
                                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nchunks; ++k) s = __fadd_rn(s, part[k * n + i]);
  dw[i] = s;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int BN>
cudaError_t launch_mma(const void* dy, const void* x, const void* w,
                       void* dx, void* part, long long P, int Ci, int Co,
                       int rows_per_split, int nsplit, int vec,
                       cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<BN>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = set_smem(conv1x1_bwd_mma_kernel<BN>, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long ntn = (Ci + BN - 1) / BN;
  const long long blocks = (long long)nsplit * ((Co + kBM - 1) / kBM) * ntn +
                           (P + kBM - 1) / kBM * ntn;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv1x1_bwd_mma_kernel<BN><<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(x),
      static_cast<const bf16*>(w), static_cast<bf16*>(dx),
      static_cast<float*>(part), P, Ci, Co, rows_per_split, nsplit, vec);
  return cudaGetLastError();
}

template <int TC>
cudaError_t launch_tc(const void* dy, const void* x, const void* w, void* dx,
                      void* part, long long P, int Ci, int Co,
                      int rows_per_chunk, int nchunks, int vec,
                      size_t smem, cudaStream_t st) {
  auto kern = conv1x1_bwd_kernel<TC>;
  const cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Ci + TC - 1) / TC, nchunks);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<float*>(dx),
      static_cast<float*>(part), P, Ci, Co, rows_per_chunk, vec);
  return cudaGetLastError();
}

cudaError_t launch_f32(int tc, const void* dy, const void* x, const void* w,
                       void* dx, void* part, long long P, int Ci, int Co,
                       int rows_per_chunk, int nchunks, int vec, size_t smem,
                       cudaStream_t st) {
  switch (tc) {
    case 64:
      return launch_tc<64>(dy, x, w, dx, part, P, Ci, Co, rows_per_chunk,
                           nchunks, vec, smem, st);
    case 32:
      return launch_tc<32>(dy, x, w, dx, part, P, Ci, Co, rows_per_chunk,
                           nchunks, vec, smem, st);
    case 16:
      return launch_tc<16>(dy, x, w, dx, part, P, Ci, Co, rows_per_chunk,
                           nchunks, vec, smem, st);
    case 8:
      return launch_tc<8>(dy, x, w, dx, part, P, Ci, Co, rows_per_chunk,
                          nchunks, vec, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Shared memory one block of the f32 kernel needs at Ci tile tc.
long long conv1x1_bwd_smem_bytes(int Co, int tc) {
  const long long co_pad = (Co + kTO - 1) / kTO * kTO;
  return 4 * (co_pad * tc + kTP * (tc + kPad) + kTP * (kTO + kPad) +
              kTO * (tc + kPad));
}

}  // namespace

// dx (P, Ci) in the inputs' dtype; dW (Co, Ci) f32; part is (nchunks, Co,
// Ci) f32 scratch (unused when nchunks == 1: the one partial is dW).
// bf16: tc is the column tile BN (64 or 128) and rows_per_chunk the rows
// of a split of P (a multiple of 64); f32: tc is the Ci tile (8..64) and
// rows_per_chunk a multiple of 64 (ops/conv_fused.py plan()).
// vec bits: 1 x, 2 dy, 4 w may move 16 bytes at a time.
extern "C" int conv1x1_bwd_launch(const void* dy, const void* x,
                                  const void* w, void* dx, void* part,
                                  void* dw, int is_bf16, long long P, int Ci,
                                  int Co, int tc, int rows_per_chunk,
                                  int nchunks, int vec, void* stream) {
  if (P < 1 || Ci < 1 || Co < 1 || nchunks < 1 || rows_per_chunk < 1 ||
      rows_per_chunk % (is_bf16 ? kBK : kTP) ||
      (long long)rows_per_chunk * nchunks < P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* first = nchunks == 1 ? dw : part;
  cudaError_t err;
  if (is_bf16) {
    if (tc == 128)
      err = launch_mma<128>(dy, x, w, dx, first, P, Ci, Co, rows_per_chunk,
                            nchunks, vec, st);
    else if (tc == 64)
      err = launch_mma<64>(dy, x, w, dx, first, P, Ci, Co, rows_per_chunk,
                           nchunks, vec, st);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    const size_t smem = (size_t)conv1x1_bwd_smem_bytes(Co, tc);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    err = launch_f32(tc, dy, x, w, dx, first, P, Ci, Co, rows_per_chunk,
                     nchunks, vec, smem, st);
  }
  if (err != cudaSuccess || nchunks == 1) return (int)err;
  const long long n = (long long)Co * Ci;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), nchunks, n);
  return (int)cudaGetLastError();
}

// the design the bf16 path runs, for reports
extern "C" const char* conv1x1_bwd_design() {
  return "bf16: dx and split-K dW as two tiled GEMMs in one launch, "
         "128 x BN tiles (BN 128, or 64 for Ci <= 64), 8 warps of 64 x 32 "
         "(32 x 32), mma.sync m16n8k16 bf16->f32, ldmatrix (.trans for "
         "W, dy^T and x), 3-stage cp.async ring of 64-deep slabs, ~2048 P "
         "rows a dW split summed in split order by a second kernel; f32: "
         "CUDA-core FMAs with a resident dW partial";
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
