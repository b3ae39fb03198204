// Row normalisation, RMS or LayerNorm under one flag, fp32.
//
// Replaces mxnet_tpu/ops/pallas/fused_norms.py:_ln_kernel (launched by
// _ln_pallas): y = x * rsqrt(mean(x^2) + eps) * gamma for RMS, and
// y = (x - mean) * rsqrt(var + eps) * gamma + beta for LayerNorm, with the
// statistics in fp32.
//
// Bound on the H100: bytes. The work is a few operations per element, so
// the card's memory rate decides: read x once, write y once.
//
// Design: one block of 256 threads per row. The threads stride over the row
// with 16-byte loads (when the row width is a multiple of 4 and the
// pointers are aligned), reduce their partial sums with warp shuffles and
// one shared-memory step, and write the scaled row. The statistics passes
// re-read the row, which at Llama widths (16 KB a row) comes from L1/L2,
// so device memory sees x about once. LayerNorm takes the centred second
// pass of the reference (mean first, then mean((x - mean)^2)).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Sum of v over the block; every thread gets the result. `red` is a
// shared array of 32 floats.
__device__ float block_sum(float v, float* red) {
  v = mx_warp_sum(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = (lane < (blockDim.x >> 5)) ? red[lane] : 0.f;
    v = mx_warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_norm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, float* __restrict__ y, int d,
                  float eps, int rms) {
  __shared__ float red[32];
  const float* xr = x + static_cast<size_t>(blockIdx.x) * d;
  float* yr = y + static_cast<size_t>(blockIdx.x) * d;
  const float fd = static_cast<float>(d);

  float s = 0.f;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < (d >> 2); i += kThreads) {
      const float4 v = x4[i];
      s += rms ? (v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w)
               : (v.x + v.y + v.z + v.w);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = xr[i];
      s += rms ? v * v : v;
    }
  }
  const float tot = block_sum(s, red);

  float mean = 0.f, rstd;
  if (rms) {
    rstd = rsqrtf(tot / fd + eps);
  } else {
    mean = tot / fd;
    float s2 = 0.f;
    if (VEC) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      for (int i = threadIdx.x; i < (d >> 2); i += kThreads) {
        const float4 v = x4[i];
        const float a = v.x - mean, b = v.y - mean, c = v.z - mean,
                    e = v.w - mean;
        s2 += a * a + b * b + c * c + e * e;
      }
    } else {
      for (int i = threadIdx.x; i < d; i += kThreads) {
        const float a = xr[i] - mean;
        s2 += a * a;
      }
    }
    rstd = rsqrtf(block_sum(s2, red) / fd + eps);
  }

  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* g4 = reinterpret_cast<const float4*>(gamma);
    const float4* b4 = reinterpret_cast<const float4*>(beta);
    float4* y4 = reinterpret_cast<float4*>(yr);
    for (int i = threadIdx.x; i < (d >> 2); i += kThreads) {
      const float4 v = x4[i], g = g4[i];
      float4 o;
      o.x = (v.x - mean) * rstd * g.x;
      o.y = (v.y - mean) * rstd * g.y;
      o.z = (v.z - mean) * rstd * g.z;
      o.w = (v.w - mean) * rstd * g.w;
      if (beta != nullptr) {
        const float4 bb = b4[i];
        o.x += bb.x;
        o.y += bb.y;
        o.z += bb.z;
        o.w += bb.w;
      }
      y4[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float o = (xr[i] - mean) * rstd * gamma[i];
      if (beta != nullptr) o += beta[i];
      yr[i] = o;
    }
  }
}

}  // namespace

// x, y: (n, d) row-major; gamma, beta: (d,); beta may be null (RMS mode
// passes null). Returns the cudaError_t of the launch.
extern "C" int fused_norm_f32(const float* x, const float* gamma,
                              const float* beta, float* y, int n, int d,
                              float eps, int rms, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (d % 4 == 0) && mx_aligned16(x) && mx_aligned16(gamma) &&
                   (beta == nullptr || mx_aligned16(beta)) && mx_aligned16(y);
  if (vec)
    fused_norm_kernel<true><<<n, kThreads, 0, st>>>(x, gamma, beta, y, d, eps,
                                                     rms);
  else
    fused_norm_kernel<false><<<n, kThreads, 0, st>>>(x, gamma, beta, y, d,
                                                      eps, rms);
  return static_cast<int>(cudaGetLastError());
}
