// Helpers shared by the port's kernels. Each kernel source is built into its
// own shared library with a plain C interface (ops/kernels/_build.py), so
// every library carries one copy of these.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The masked-score value of the JAX kernels (_NEG_INF = -1e30).
#define MX_NEG_INF (-1e30f)

// Message for a cudaError_t returned by one of the C entry points.
extern "C" const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Element conversions of the kernels that take bf16 as well as fp32: loads
// widen to fp32 (exact), stores round to nearest even, as PyTorch's and
// XLA's casts do.
__device__ __forceinline__ float mx_to_f32(float v) { return v; }
__device__ __forceinline__ float mx_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T mx_from_f32(float v);
template <>
__device__ __forceinline__ float mx_from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 mx_from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The two bf16 of a 32-bit word as fp32 (the element at the lower address
// is the low half), and two fp32 rounded into one such word.
__device__ __forceinline__ float mx_bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float mx_bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t mx_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
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
