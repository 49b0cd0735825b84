// Greedy non-maximum suppression over score-sorted boxes, one block a row.
//
// Replaces no Pallas kernel: the reference runs box_nms
// (mxnet_tpu/ops/nn.py::box_nms) as one on-device lax.fori_loop over every
// box, which is one dispatch on the TPU.  As a loop of PyTorch ops it would
// be about eight launches a box (some 49,000 a call at SSD-512's 6,132
// anchors), so the port computes the loop in this one launch.
//
// What it computes, for every row b of `n` boxes (ops/box_nms.py says how
// the wrapper prepares the inputs):
//   order    the row's boxes by descending score, ties in index order (a
//            stable argsort of -score, made by the wrapper);
//   for k in 0 .. keep_lim - 1, box i = order[k] is a suppressor when it is
//   not suppressed and score[i] >= valid_thresh; a suppressor marks every
//   later box order[p], p > k, whose IoU with it exceeds overlap_thresh
//   (and whose class id equals its own, when ids are given);
//   out[i] = -1 where i is suppressed, under valid_thresh or ranked at or
//   past keep_lim, else score[i].
// Rounds k >= keep_lim change nothing in the reference's loop (their
// suppressor is never valid), so the kernel stops at keep_lim.  The IoU is
// the reference's f32 expression in its order, every operation rounded on
// its own (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn: no FMA contraction), so
// an IoU at the threshold decides as the plain version's does.
//
// What bounds it on the H100: neither bytes nor operations but the chain of
// keep_lim dependent rounds.  A round's work is one IoU against each later
// box (about 15 f32 operations); every round ends in a block barrier, since
// the next suppressor's state depends on it.  The boxes (n x 4 f32, 96 KB
// at n = 6,132) stay in L2 after the first round; n is not limited by shared
// memory: the sorted copies and the flags live in the wrapper's scratch.
//
// What the design does about it: one block of 1024 threads a row walks the
// rounds; a round whose suppressor is already out (suppressed, under
// valid_thresh) costs only its barrier, so the rounds of SSD's
// below-threshold anchors (scores -1) are nearly free.  The first pass copies
// each row's boxes, areas, ids and scores into sorted order, so that a round
// reads consecutive addresses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  const float xx1 = fmaxf(a.x, b.x);
  const float yy1 = fmaxf(a.y, b.y);
  const float xx2 = fminf(a.z, b.z);
  const float yy2 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(xx2, xx1), 0.0f),
                                fmaxf(__fsub_rn(yy2, yy1), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f));
}

__global__ void __launch_bounds__(kThreads)
box_nms_kernel(const float* __restrict__ score, const float* __restrict__ box,
               const float* __restrict__ ids, const int64_t* __restrict__ order,
               float4* __restrict__ sbox, float* __restrict__ sarea,
               float* __restrict__ sid, float* __restrict__ sscore,
               uint8_t* __restrict__ sup, float* __restrict__ out, int n,
               int keep_lim, float overlap_thresh, float valid_thresh) {
  const int64_t row = blockIdx.x;
  const int64_t base = row * n;
  const int64_t* ord = order + base;
  float4* sb = sbox + base;
  float* sa = sarea + base;
  float* si = sid + base;
  float* ss = sscore + base;
  volatile uint8_t* sp = sup + base;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int64_t o = ord[p];
    const float* bx = box + (base + o) * 4;
    const float4 b = make_float4(bx[0], bx[1], bx[2], bx[3]);
    sb[p] = b;
    sa[p] = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                      fmaxf(__fsub_rn(b.w, b.y), 0.0f));
    si[p] = ids ? ids[base + o] : 0.0f;
    ss[p] = score[base + o];
    sp[p] = 0;
  }
  __syncthreads();
  for (int k = 0; k < keep_lim; ++k) {
    // every thread reads the same flag after the barrier that ended round
    // k - 1, so the branch is uniform over the block
    if (!sp[k] && ss[k] >= valid_thresh) {
      const float4 bk = sb[k];
      const float ak = sa[k];
      const float ik = si[k];
      for (int p = k + 1 + threadIdx.x; p < n; p += kThreads) {
        if (si[p] == ik && iou(bk, ak, sb[p], sa[p]) > overlap_thresh)
          sp[p] = 1;
      }
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float s = ss[p];
    out[base + ord[p]] =
        (sp[p] || s < valid_thresh || p >= keep_lim) ? -1.0f : s;
  }
}

}  // namespace

// score (B, n) f32; box (B, n, 4) f32 corners; ids (B, n) f32 or null (no
// class test); order (B, n) int64; scratch sbox (B, n, 4), sarea, sid,
// sscore (B, n) f32 and sup (B, n) uint8; out (B, n) f32.  All contiguous.
extern "C" int box_nms_launch(const void* score, const void* box,
                              const void* ids, const void* order, void* sbox,
                              void* sarea, void* sid, void* sscore, void* sup,
                              void* out, int rows, int n, int keep_lim,
                              float overlap_thresh, float valid_thresh,
                              void* stream) {
  if (rows < 1 || n < 1 || keep_lim < 0 || keep_lim > n ||
      reinterpret_cast<uintptr_t>(sbox) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  box_nms_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(score), static_cast<const float*>(box),
      static_cast<const float*>(ids), static_cast<const int64_t*>(order),
      static_cast<float4*>(sbox), static_cast<float*>(sarea),
      static_cast<float*>(sid), static_cast<float*>(sscore),
      static_cast<uint8_t*>(sup), static_cast<float*>(out), n, keep_lim,
      overlap_thresh, valid_thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* box_nms_design() {
  return "one block of 1024 threads a row; boxes, areas, ids and scores "
         "copied once into score order (scratch in device memory, no limit "
         "on n); keep_lim rounds, each a block barrier, a valid suppressor "
         "striking later boxes by the reference's f32 IoU without FMA "
         "contraction";
}

extern "C" const char* mx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
