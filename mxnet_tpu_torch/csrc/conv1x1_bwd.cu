// Fused backward of a 1x1 stride-1 NHWC convolution (kernel K6):
//
//     dx = dy @ W          (P, Co) x (Co, Ci), summed in f32, rounded once
//                          to x's dtype
//     dW = dy^T @ x        (Co, P) x (P, Ci), summed in f32, kept in f32
//
// Replaces the TPU kernel mxnet_tpu/ops/conv_fused.py::_conv1x1_bwd_pair
// (Pallas body _bwd_pair_kernel).  dy is (P, Co), x is (P, Ci) and W is
// (Co, Ci), all bf16 or all f32, contiguous; P is the flattened batch and
// spatial axis.  The point of the fusion is that dy, the largest of the
// three for an expanding convolution, is read from device memory once for
// both products instead of once for each.
//
// What bounds it on the H100: at ResNet-50's shapes (batch 128) the early
// stages are bytes (stage 1, P = 401408, 64 -> 256: 308 MB to move against
// 26 GFLOP) and the late stages operations (stage 4, P = 6272, 512 ->
// 2048: 26 GFLOP against 40 MB).  The least time is the larger of the
// bytes (dy, x and W read once, dx and the f32 dW written once) over
// 3.35 TB/s and 4*P*Ci*Co operations over the bf16 tensor-core peak.
//
// What the design does about it.  The TPU kernel walks one sequential grid
// over P tiles and keeps all of W and the whole f32 dW in VMEM.  On the
// card W (up to 2048 x 512 bf16) does not fit a block's shared memory and
// blocks run in no order, so:
//
// - A block owns one (P chunk, Ci tile of TC columns).  It walks the
//   64-row P tiles of its chunk; for each it holds the x tile in shared
//   memory and streams dy and W in slabs of 32 output channels.  Each slab
//   feeds both products: the dx tile's f32 sums stay in registers across
//   the slabs and are rounded once when the tile is done, and the slab's
//   rows of the chunk's f32 dW partial (Co x TC, resident in shared
//   memory for the whole chunk) take dy_slab^T @ x_tile.  TC is the
//   widest of 64/32/16/8 whose partial fits 128 KB, so dy is read once
//   when Ci <= TC and Ci/TC times (mostly from L2: the Ci tiles of one
//   chunk are neighbouring blocks) otherwise.
// - dW is a reduction across blocks.  Without atomics: each block writes
//   its partial to (chunk, Co, Ci) scratch, and a second kernel sums the
//   partials in chunk order, so dW repeats bit for bit from run to run.
//   The chunk count fills the 132 SMs about twice over while each chunk
//   keeps at least one 64-row tile.
// - bf16 multiplies on the tensor cores with mma.sync m16n8k16 (f32
//   sums); f32 uses plain FMAs on the CUDA cores (no TF32).  Fragments are
//   gathered from shared memory with scalar loads; ragged P, Ci and Co are
//   zero-filled in shared memory and masked on store.  This is the simple
//   first version: no double buffering, no TMA or wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kTP = 64;         // P rows per tile
constexpr int kTO = 32;         // output channels per dy / W slab
constexpr int kPad = 8;         // shared-memory row padding (elements)

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T zero_val() {
  if constexpr (std::is_same<T, float>::value) {
    return 0.f;
  } else {
    return __float2bfloat16(0.f);
  }
}

// s[r * lds + c] = g[r * ldg + c] for r < row_lim and c < col_lim, else 0,
// over a rows x cols tile (cols a multiple of 8).  With vec, g's rows are
// 16-byte aligned and 8 in-bounds elements move as 16 or 32 bytes.
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ s, int lds,
                                          const T* __restrict__ g,
                                          long long ldg, int rows, int cols,
                                          int row_lim, int col_lim,
                                          bool vec) {
  constexpr int kWords = (int)sizeof(T) * 8 / 16;  // uint4 per 8 elements
  const int vpr = cols / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * 8;
    T* dst = s + r * lds + c;
    const T* src = g + (long long)r * ldg + c;
    if (vec && r < row_lim && c + 8 <= col_lim) {
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        reinterpret_cast<uint4*>(dst)[k] =
            __ldg(reinterpret_cast<const uint4*>(src) + k);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dst[k] = (r < row_lim && c + k < col_lim) ? src[k] : zero_val<T>();
    }
  }
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a @ b on one m16n8k16 tile, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int TC>
__global__ void __launch_bounds__(kThreads)
    conv1x1_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                       const T* __restrict__ w, T* __restrict__ dx,
                       float* __restrict__ part_out, long long P, int Ci,
                       int Co, int rows_per_chunk, int vec) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int LX = TC + kPad;   // row stride of xs and ws
  constexpr int LD = kTO + kPad;  // row stride of dys
  // bf16: dx tiles (m16n8) of the 64 x TC tile and dW tiles of the
  // 32 x TC slab, dealt round-robin to the 8 warps
  constexpr int kDxTiles = (kTP / 16) * (TC / 8);
  constexpr int kDwTiles = (kTO / 16) * (TC / 8);
  constexpr int kDxPerWarp = (kDxTiles + 7) / 8;
  constexpr int kDwPerWarp = (kDwTiles + 7) / 8;
  // f32: each thread owns one column c and rows r0 + kStep * j
  constexpr int kStep = kThreads / TC;
  constexpr int kEx = kTP * TC / kThreads;   // dx values per thread
  constexpr int kEw = kTO * TC / kThreads;   // dW slab values per thread
  constexpr int kAcc = kMma ? kDxPerWarp * 4 : kEx;

  extern __shared__ __align__(16) unsigned char smem[];
  const int co_pad = (Co + kTO - 1) / kTO * kTO;
  float* part = reinterpret_cast<float*>(smem);        // [co_pad][TC]
  T* xs = reinterpret_cast<T*>(part + (size_t)co_pad * TC);  // [kTP][LX]
  T* dys = xs + kTP * LX;                                     // [kTP][LD]
  T* ws = dys + kTP * LD;                                     // [kTO][LX]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int fc = tid % TC, fr = tid / TC;   // f32 ownership
  const int c0 = blockIdx.x * TC;
  const int ncol = Ci - c0;
  const long long pb = (long long)blockIdx.y * rows_per_chunk;
  const long long pe = min(P, pb + (long long)rows_per_chunk);

  for (int i = tid; i < co_pad * TC; i += kThreads) part[i] = 0.f;

  for (long long p0 = pb; p0 < pe; p0 += kTP) {
    const int rows = (int)min((long long)kTP, pe - p0);
    __syncthreads();  // the last tile's readers of xs are done
    load_tile<T>(xs, LX, x + p0 * Ci + c0, Ci, kTP, TC, rows, ncol,
                 vec & 1);
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

    for (int o0 = 0; o0 < Co; o0 += kTO) {
      __syncthreads();  // the last slab's readers of dys and ws are done
      load_tile<T>(dys, LD, dy + p0 * Co + o0, Co, kTP, kTO, rows, Co - o0,
                   vec & 2);
      load_tile<T>(ws, LX, w + (long long)o0 * Ci + c0, Ci, kTO, TC,
                   Co - o0, ncol, vec & 4);
      __syncthreads();
      if constexpr (kMma) {
        // dx[p][c] += sum_o dys[p][o] ws[o][c]; A = dys (m = p, k = o),
        // B = ws (k = o, n = c).  Warp w's tiles share the row tile w % 4.
        const int mt = warp & 3;
#pragma unroll
        for (int ks = 0; ks < kTO; ks += 16) {
          uint32_t a[4];
          const bf16* ar = dys + (mt * 16 + g) * LD + ks + 2 * tig;
          a[0] = ld32(ar);
          a[1] = ld32(ar + 8 * LD);
          a[2] = ld32(ar + 8);
          a[3] = ld32(ar + 8 * LD + 8);
#pragma unroll
          for (int j = 0; j < kDxPerWarp; ++j) {
            const int t = warp + 8 * j;
            if (t < kDxTiles) {
              const bf16* br = ws + (ks + 2 * tig) * LX + (t >> 2) * 8 + g;
              const uint32_t b[2] = {pack2(br[0], br[LX]),
                                     pack2(br[8 * LX], br[9 * LX])};
              mma_bf16(acc + 4 * j, a, b);
            }
          }
        }
        // part[o0 + o][c] += sum_p dys[p][o] xs[p][c]; A = dys^T (m = o,
        // k = p), B = xs (k = p, n = c)
#pragma unroll
        for (int j = 0; j < kDwPerWarp; ++j) {
          const int t = warp + 8 * j;
          if (t < kDwTiles) {
            const int mt2 = t & 1, nt2 = t >> 1;
            float* cp = part + (size_t)(o0 + mt2 * 16 + g) * TC + nt2 * 8 +
                        2 * tig;
            float c[4] = {cp[0], cp[1], cp[8 * TC], cp[8 * TC + 1]};
#pragma unroll
            for (int ks = 0; ks < kTP; ks += 16) {
              const bf16* ac = dys + (ks + 2 * tig) * LD + mt2 * 16 + g;
              const uint32_t a[4] = {pack2(ac[0], ac[LD]),
                                     pack2(ac[8], ac[LD + 8]),
                                     pack2(ac[8 * LD], ac[9 * LD]),
                                     pack2(ac[8 * LD + 8], ac[9 * LD + 8])};
              const bf16* bx = xs + (ks + 2 * tig) * LX + nt2 * 8 + g;
              const uint32_t b[2] = {pack2(bx[0], bx[LX]),
                                     pack2(bx[8 * LX], bx[9 * LX])};
              mma_bf16(c, a, b);
            }
            cp[0] = c[0];
            cp[1] = c[1];
            cp[8 * TC] = c[2];
            cp[8 * TC + 1] = c[3];
          }
        }
      } else {
        // f32 on CUDA cores: thread owns column fc of the dx tile (rows
        // fr + kStep j) and of the dW slab (rows fr + kStep j)
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
    }

    // the dx tile, rounded once
    if constexpr (kMma) {
      const int mt = warp & 3;
#pragma unroll
      for (int j = 0; j < kDxPerWarp; ++j) {
        const int t = warp + 8 * j;
        if (t >= kDxTiles) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h;
          if (r >= rows) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = (t >> 2) * 8 + 2 * tig + e;
            if (c < ncol)
              store_out(dx + (p0 + r) * Ci + c0 + c, acc[4 * j + 2 * h + e]);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kEx; ++j) {
        const int r = fr + kStep * j;
        if (r < rows && fc < ncol)
          store_out(dx + (p0 + r) * Ci + c0 + fc, acc[j]);
      }
    }
  }

  __syncthreads();
  float* dst = part_out + (size_t)blockIdx.y * Co * Ci + c0;
  for (int i = tid; i < Co * TC; i += kThreads) {
    const int o = i / TC, c = i % TC;
    if (c < ncol) dst[(size_t)o * Ci + c] = part[i];
  }
}

// dW[i] = sum over chunks k in order of part[k][i]
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ dw, int nchunks,
                                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nchunks; ++k) s = __fadd_rn(s, part[k * n + i]);
  dw[i] = s;
}

template <typename T, int TC>
cudaError_t launch_tc(const void* dy, const void* x, const void* w, void* dx,
                      void* part, long long P, int Ci, int Co,
                      int rows_per_chunk, int nchunks, int vec,
                      size_t smem, cudaStream_t st) {
  auto kern = conv1x1_bwd_kernel<T, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Ci + TC - 1) / TC, nchunks);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<T*>(dx),
      static_cast<float*>(part), P, Ci, Co, rows_per_chunk, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int tc, const void* dy, const void* x, const void* w,
                     void* dx, void* part, long long P, int Ci, int Co,
                     int rows_per_chunk, int nchunks, int vec, size_t smem,
                     cudaStream_t st) {
  switch (tc) {
    case 64:
      return launch_tc<T, 64>(dy, x, w, dx, part, P, Ci, Co, rows_per_chunk,
                              nchunks, vec, smem, st);
    case 32:
      return launch_tc<T, 32>(dy, x, w, dx, part, P, Ci, Co, rows_per_chunk,
                              nchunks, vec, smem, st);
    case 16:
      return launch_tc<T, 16>(dy, x, w, dx, part, P, Ci, Co, rows_per_chunk,
                              nchunks, vec, smem, st);
    case 8:
      return launch_tc<T, 8>(dy, x, w, dx, part, P, Ci, Co, rows_per_chunk,
                             nchunks, vec, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one block of the main kernel needs at Ci tile tc.
extern "C" long long conv1x1_bwd_smem_bytes(int is_bf16, int Co, int tc) {
  const long long co_pad = (Co + kTO - 1) / kTO * kTO;
  const long long el = is_bf16 ? 2 : 4;
  return co_pad * tc * 4 +
         el * (kTP * (tc + kPad) + kTP * (kTO + kPad) + kTO * (tc + kPad));
}

// dx (P, Ci) in the inputs' dtype; dW (Co, Ci) f32; part is (nchunks, Co,
// Ci) f32 scratch (unused when nchunks == 1: the one partial is dW).
// vec bits: 1 x, 2 dy, 4 w may move 16 bytes at a time.
extern "C" int conv1x1_bwd_launch(const void* dy, const void* x,
                                  const void* w, void* dx, void* part,
                                  void* dw, int is_bf16, long long P, int Ci,
                                  int Co, int tc, int rows_per_chunk,
                                  int nchunks, int vec, void* stream) {
  if (P < 1 || Ci < 1 || Co < 1 || nchunks < 1 || rows_per_chunk < 1 ||
      rows_per_chunk % kTP || (long long)rows_per_chunk * nchunks < P)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)conv1x1_bwd_smem_bytes(is_bf16, Co, tc);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* first = nchunks == 1 ? dw : part;
  cudaError_t err =
      is_bf16 ? launch_t<bf16>(tc, dy, x, w, dx, first, P, Ci, Co,
                               rows_per_chunk, nchunks, vec, smem, st)
              : launch_t<float>(tc, dy, x, w, dx, first, P, Ci, Co,
                                rows_per_chunk, nchunks, vec, smem, st);
  if (err != cudaSuccess || nchunks == 1) return (int)err;
  const long long n = (long long)Co * Ci;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), nchunks, n);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
