// The launch of a runtime-compiled kernel (K7's launcher, host code only).
//
// Replaces the launch half of mxnet_tpu/rtc.py::_PallasKernel.launch (the
// jitted pl.pallas_call of a cached signature): mxnet_tpu_torch/rtc.py
// builds a LaunchPlan once per kernel, card, grid, block and shared memory,
// and on each thread a launch record below, whose argument slots the plan
// rewrites at every launch.  A launch from Python is then one call with two
// pointer arguments: through ctypes libcuda's cuLaunchKernel, with its
// eleven converted arguments, costs the host about as much as a whole
// PyTorch op.  What bounds a launch is the host: this file adds one
// indirect call to libcuda's.
//
// No CUDA header and no link to libcuda: the record carries libcuda's
// cuLaunchKernel, as ctypes found it, so the library loads wherever
// rtc.py's ctypes binding of libcuda does.

#include <stdint.h>

typedef int (*LaunchFn)(void* f, unsigned grid_x, unsigned grid_y,
                        unsigned grid_z, unsigned block_x, unsigned block_y,
                        unsigned block_z, unsigned shared_bytes, void* stream,
                        void** params, void** extra);

// mirrored by rtc.py's _LaunchRecord (ctypes.Structure, same field order)
struct RtcLaunch {
  LaunchFn launch;          // libcuda's cuLaunchKernel
  void* fn;                 // CUfunction
  unsigned dims[7];         // grid x, y, z; block x, y, z; shared bytes
  void** params;            // this thread's void* array into its slots
  uint64_t* count;          // the kernel's launch count
};

// cuLaunchKernel on `stream`; the kernel's count rises by one when
// cuLaunchKernel accepts the launch.  Returns the CUresult.
extern "C" int rtc_launch(const RtcLaunch* r, void* stream) {
  const int res = r->launch(r->fn, r->dims[0], r->dims[1], r->dims[2],
                            r->dims[3], r->dims[4], r->dims[5], r->dims[6],
                            stream, r->params, nullptr);
  if (res == 0) __atomic_fetch_add(r->count, 1ull, __ATOMIC_RELAXED);
  return res;
}
