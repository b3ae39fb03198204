// Helpers shared by the port's kernels. Each kernel source is built into its
// own shared library with a plain C interface (ops/kernels/_build.py), so
// every library carries one copy of these.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The masked-score value of the JAX kernels (_NEG_INF = -1e30).
#define MX_NEG_INF (-1e30f)

// Message for a cudaError_t returned by one of the C entry points.
extern "C" const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float mx_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float mx_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static inline bool mx_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The most devices whose shared-memory opt-in is remembered.
constexpr int kMxMaxDevices = 64;

// Opt `kernel` in to `bytes` of dynamic shared memory (above 48 KB only when
// asked for) once per device: cudaFuncSetAttribute applies to the current
// device, so the flag is kept per device index, in a `done` array that the
// caller keeps for this kernel. Two threads may both set it the first time,
// which is harmless. Returns a cudaError_t.
template <class Kernel>
static int mx_smem_opt_in(Kernel kernel, int bytes,
                          bool (&done)[kMxMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMxMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    done[dev] = true;
  }
  return 0;
}
