"""User kernels for ``mxnet_tpu_torch.rtc.CudaModule`` and their plain
PyTorch versions, shared by ``chip_smoke.py`` and the tests.

Plain strings and functions, no imports: the plain versions use only
tensor methods, and ``RtcGelu`` takes the ``mxnet_tpu_torch`` module as
an argument.  One CUDA source holds every kernel, compiled at run time by
NVRTC for ``sm_90a``:

- ``addmul``: ``out = x * 2 + y`` (f32), the reference test's kernel
  (``tests/test_tools.py``, ``TestRTC``);
- ``gelu_fwd<T>``: the tanh approximation of GELU (``jax.nn.gelu``'s
  default, ``"gelu"`` in ``ops/nn.py``), and ``gelu_bwd<T>``: its
  derivative times the output gradient; each for ``float`` and
  ``__nv_bfloat16``, f32 math inside, reached through ``exports``.  Both
  are bound by bytes (one read and one write a value, two reads for the
  backward); each thread moves one 16-byte vector where the pointers are
  16-byte aligned, over a grid that covers the array;
- ``softmax_rows``: a row softmax of bf16 rows, ``rows_per_block`` rows
  staged in dynamic shared memory as f32 (96 KB for 8 rows of 3072, past
  the 48 KB that needs the opt-in), with an ``int`` scalar.
"""

SOURCE = r"""
#include <cuda_bf16.h>

extern "C" __global__ void addmul(const float* __restrict__ x,
                                  const float* __restrict__ y,
                                  float* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = x[i] * 2.0f + y[i];
}

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float in(float v) { return v; }
  static __device__ __forceinline__ float out(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) {
    return __float2bfloat16(v);
  }
};

#define GELU_K0 0.7978845608028654f  /* sqrt(2 / pi) */
#define GELU_K1 0.044715f

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(GELU_K0 * (x + GELU_K1 * x * x * x)));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float x2 = x * x;
  const float t = tanhf(GELU_K0 * (x + GELU_K1 * x2 * x));
  return 0.5f * (1.0f + t) +
         0.5f * x * (1.0f - t * t) * GELU_K0 * (1.0f + 3.0f * GELU_K1 * x2);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// y = gelu(x): one thread a 16-byte vector (8 bf16 or 4 floats), the grid
// covering the array (elementwise_grid), so no thread strides and no block
// waits on a last partial wave; the ragged tail (< one vector) goes to the
// first block's threads.  Where a pointer is not 16-byte aligned, the same
// grid takes the values one at a time, a vector's worth a thread.
template <typename T>
__global__ void gelu_fwd(const T* __restrict__ x, T* __restrict__ y, int n) {
  constexpr int V = 16 / sizeof(T);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (aligned16(x) && aligned16(y)) {
    const int nv = n / V;
    if (i < nv) {
      const uint4 a = reinterpret_cast<const uint4*>(x)[i];
      uint4 b;
      const T* av = reinterpret_cast<const T*>(&a);
      T* bv = reinterpret_cast<T*>(&b);
#pragma unroll
      for (int k = 0; k < V; ++k)
        bv[k] = Cvt<T>::out(gelu_tanh(Cvt<T>::in(av[k])));
      reinterpret_cast<uint4*>(y)[i] = b;
    }
    const int t = nv * V + threadIdx.x;
    if (blockIdx.x == 0 && t < n)
      y[t] = Cvt<T>::out(gelu_tanh(Cvt<T>::in(x[t])));
  } else {
    const long long base = (long long)blockIdx.x * blockDim.x * V;
    for (int k = 0; k < V; ++k) {
      const long long j = base + k * blockDim.x + threadIdx.x;
      if (j < n) y[j] = Cvt<T>::out(gelu_tanh(Cvt<T>::in(x[j])));
    }
  }
}

// dx = dy * gelu'(x), laid out as gelu_fwd
template <typename T>
__global__ void gelu_bwd(const T* __restrict__ x, const T* __restrict__ dy,
                         T* __restrict__ dx, int n) {
  constexpr int V = 16 / sizeof(T);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (aligned16(x) && aligned16(dy) && aligned16(dx)) {
    const int nv = n / V;
    if (i < nv) {
      const uint4 a = reinterpret_cast<const uint4*>(x)[i];
      const uint4 g = reinterpret_cast<const uint4*>(dy)[i];
      uint4 b;
      const T* av = reinterpret_cast<const T*>(&a);
      const T* gv = reinterpret_cast<const T*>(&g);
      T* bv = reinterpret_cast<T*>(&b);
#pragma unroll
      for (int k = 0; k < V; ++k)
        bv[k] = Cvt<T>::out(Cvt<T>::in(gv[k]) *
                            gelu_tanh_grad(Cvt<T>::in(av[k])));
      reinterpret_cast<uint4*>(dx)[i] = b;
    }
    const int t = nv * V + threadIdx.x;
    if (blockIdx.x == 0 && t < n)
      dx[t] = Cvt<T>::out(Cvt<T>::in(dy[t]) * gelu_tanh_grad(Cvt<T>::in(x[t])));
  } else {
    const long long base = (long long)blockIdx.x * blockDim.x * V;
    for (int k = 0; k < V; ++k) {
      const long long j = base + k * blockDim.x + threadIdx.x;
      if (j < n)
        dx[j] = Cvt<T>::out(Cvt<T>::in(dy[j]) *
                            gelu_tanh_grad(Cvt<T>::in(x[j])));
    }
  }
}

// the sum (or max) of v over the block, in every thread; blockDim.x is a
// multiple of 32
__device__ float block_reduce(float v, float* red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                 // red may still be read from last time
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const float none = is_max ? -__int_as_float(0x7f800000) : 0.0f;
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : none;
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  return v;
}

// y = softmax(x) over each row of cols values; each block stages its
// rows_per_block rows in dynamic shared memory as f32
extern "C" __global__ void softmax_rows(const __nv_bfloat16* __restrict__ x,
                                        __nv_bfloat16* __restrict__ y,
                                        int rows, int cols,
                                        int rows_per_block) {
  extern __shared__ float stage[];
  __shared__ float red[32];
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, rows - r0);
  if (nr <= 0) return;
  const long long base = (long long)r0 * cols;
  for (int i = threadIdx.x; i < nr * cols; i += blockDim.x)
    stage[i] = __bfloat162float(x[base + i]);
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    float* row = stage + (long long)r * cols;
    float m = -__int_as_float(0x7f800000);
    for (int c = threadIdx.x; c < cols; c += blockDim.x) m = fmaxf(m, row[c]);
    m = block_reduce(m, red, true);
    float s = 0.0f;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    s = block_reduce(s, red, false);
    const float inv = 1.0f / s;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      y[base + (long long)r * cols + c] = __float2bfloat16(row[c] * inv);
  }
}
"""

# the templated kernels NVRTC must instantiate and name
EXPORTS = ("gelu_fwd<float>", "gelu_fwd<__nv_bfloat16>",
           "gelu_bwd<float>", "gelu_bwd<__nv_bfloat16>")

SIGNATURES = {
    "addmul": "const float *x, const float *y, float *out, int n",
    "gelu_fwd": "const {T} *x, {T} *y, int n",
    "gelu_bwd": "const {T} *x, const {T} *dy, {T} *dx, int n",
    "softmax_rows": "const __nv_bfloat16 *x, __nv_bfloat16 *y, int rows, "
                    "int cols, int rows_per_block",
}

# the C type a kernel is instantiated for, by torch dtype name
CTYPES = {"torch.float32": "float", "torch.bfloat16": "__nv_bfloat16"}

THREADS = 256
SOFTMAX_ROWS_PER_BLOCK = 8


def elementwise_grid(n, itemsize):
    """Blocks of ``THREADS`` for an elementwise kernel moving 16 bytes a
    thread: as many as cover the array in one pass (the GELU kernels take
    one vector a thread; ``addmul``'s grid-stride loop takes the same
    grid)."""
    per_block = THREADS * (16 // itemsize)
    return (max(1, -(-n // per_block)), 1, 1)


# --------------------------------------------------------------------------- #
# plain versions (f32 math, the input's dtype out)
# --------------------------------------------------------------------------- #

GELU_K0 = 0.7978845608028654
GELU_K1 = 0.044715


def addmul_plain(x, y):
    return x * 2.0 + y


def gelu_fwd_plain(x):
    xf = x.float()
    y = 0.5 * xf * (1.0 + (GELU_K0 * (xf + GELU_K1 * xf * xf * xf)).tanh())
    return y.to(x.dtype)


def gelu_bwd_plain(x, dy):
    xf = x.float()
    x2 = xf * xf
    t = (GELU_K0 * (xf + GELU_K1 * x2 * xf)).tanh()
    g = 0.5 * (1.0 + t) + 0.5 * xf * (1.0 - t * t) * GELU_K0 * \
        (1.0 + 3.0 * GELU_K1 * x2)
    return (dy.float() * g).to(x.dtype)


def softmax_rows_plain(x):
    return x.float().softmax(-1).to(x.dtype)


def err_units(out, ref):
    """The largest difference of a kernel's ``out`` from its plain
    version ``ref``, element by element, in units of that element's
    tolerance.  Both compute in f32, which may differ by 1e-6 of the
    output's largest magnitude; a bf16 output then rounds once, which may
    move an element by one bf16 step (ulp) of its own magnitude (the
    larger of the two).  A kernel within its tolerance gives at most 1."""
    o, r = out.float(), ref.float()
    tol = 1e-6 * max(r.abs().max().item(), 1e-30)
    if str(out.dtype) == "torch.bfloat16":
        m = o.abs().maximum(r.abs())
        tol = tol + (m.frexp()[1] - 8).float().exp2() * (m > 0)
    return ((o - r).abs() / tol).max().item()


# --------------------------------------------------------------------------- #
# the rtc_gelu custom op
# --------------------------------------------------------------------------- #

class RtcGelu:
    """The ``rtc_gelu`` custom op: GELU whose forward and backward each
    launch one NVRTC-compiled kernel on a GPU context, and take the plain
    version on a CPU context (the choice is the user's op's, by the
    input's context; ``rtc`` itself has no host path).

    ``RtcGelu(mx).register()`` registers it with ``mx.operator``;
    ``kernel(name, ctype)`` compiles the module at first use and returns
    the ``CudaKernel``; ``launches()`` sums the kernels' counts."""

    def __init__(self, mx, op_type="rtc_gelu"):
        self.mx = mx
        self.op_type = op_type
        self.module = None
        self.kernels = {}

    def kernel(self, name, ctype):
        key = f"{name}<{ctype}>"
        if key not in self.kernels:
            if self.module is None:
                self.module = self.mx.rtc.CudaModule(SOURCE, exports=EXPORTS)
            self.kernels[key] = self.module.get_kernel(
                key, SIGNATURES[name].format(T=ctype))
        return self.kernels[key]

    def launches(self):
        return sum(k.launches for k in self.kernels.values())

    def register(self):
        mx, owner = self.mx, self

        def on_card(nd):
            return nd.context.device_type == "gpu"

        def launch(name, arrays):
            # the kernel reads contiguous inputs and writes the last array
            *ins, out = arrays
            ins = [a if a.astorch().is_contiguous()
                   else mx.nd.from_torch(a.astorch().contiguous())
                   for a in ins]
            x = ins[0]
            k = owner.kernel(name, CTYPES[str(x.astorch().dtype)])
            k.launch(ins + [out, x.size], x.context,
                     elementwise_grid(x.size, x.astorch().element_size()),
                     (THREADS, 1, 1))

        class GeluOp(mx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                x, y = in_data[0], out_data[0]
                if req[0] == "null":
                    return
                if on_card(x):
                    launch("gelu_fwd", [x, y])
                else:
                    self.assign(y, req[0], gelu_fwd_plain(x.astorch()))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                x, dy, dx = in_data[0], out_grad[0], in_grad[0]
                if req[0] == "null":
                    return
                if on_card(x):
                    launch("gelu_bwd", [x, dy, dx])
                else:
                    self.assign(dx, req[0],
                                gelu_bwd_plain(x.astorch(), dy.astorch()))

        class GeluProp(mx.operator.CustomOpProp):
            def create_operator(self, ctx, in_shapes, in_dtypes):
                return GeluOp()

        mx.operator.register(self.op_type)(GeluProp)
        return self
