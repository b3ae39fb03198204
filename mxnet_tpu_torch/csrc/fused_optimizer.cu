// Fused optimizer updates, fp32, in place: Adam and SGD with momentum.
//
// Replaces mxnet_tpu/ops/pallas/fused_optimizer.py:_adam_kernel (launched by
// adam_step) and _sgd_mom_kernel (launched by sgd_mom_step). Each reads the
// weight, its gradient and the optimizer slots once and writes the weight
// and the slots back over themselves, as the TPU kernels alias them
// (input_output_aliases). The arithmetic is the TPU kernels', operation for
// operation and in the same order:
//   g'   = clip(g * rescale, -clip, clip) + wd * w
//   Adam: m' = beta1 * m + (1 - beta1) * g'
//         v' = beta2 * v + ((1 - beta2) * g') * g'
//         w' = w - (lr * (m' / bc1)) / (sqrt(v' / bc2) + eps)
//   SGD:  mom' = momentum * mom - lr * g';   w' = w + mom'
// Each step is one fp32 operation rounded to nearest: the __f*_rn
// intrinsics keep nvcc from contracting a multiply and an add into an FMA,
// which would round once where the reference rounds twice.
//
// The step-varying hyperparameters are read from device memory, as the TPU
// kernels read them from a small fp32 vector operand: Adam's from
// (lr, wd, bc1, bc2), SGD-momentum's from (lr, wd). bc1 = 1 - beta1^t and
// bc2 = 1 - beta2^t are Adam's bias corrections (1 when the caller turns the
// correction off: x / 1 is exact). A launch captured in a CUDA graph reads
// whatever the vector holds when the graph replays, so a learning-rate
// schedule or a new update count needs no new capture.
//
// Bound on the H100: bytes. Adam moves 28 bytes per element (4 reads, 3
// writes) for 18 operations, SGD-momentum 20 bytes for 7; the card does
// about 20 fp32 operations in the time it moves one byte.
//
// Design: one grid-stride loop over the flat tensor with 16-byte float4
// loads and stores when every pointer is 16-byte aligned, and a scalar loop
// over the last n % 4 elements (over all of them when a pointer is not
// aligned): the kernel masks its own tail, with no size gate. One wave of
// 256-thread blocks (8 per SM on 132 SMs) keeps up to 17 MB of loads in
// flight, far more than the memory system needs to run at its rate. Every
// thread loads the 8 or 16 bytes of the vector once before its loop; they
// come from L2 after the first block.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

// The launch's constants; lr, wd, bc1 and bc2 are filled in on the card
// from the hyperparameter vector.
struct AdamHyper {
  float lr, wd, bc1, bc2, beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
  float rescale, clip;
  int has_clip;
};

struct SgdHyper {
  float lr, wd, momentum, rescale, clip;
  int has_clip;
};

// g * rescale, clipped to [-clip, clip] (a NaN stays NaN, as in jnp.clip),
// plus wd * w.
__device__ __forceinline__ float prep_grad(float g, float w, float rescale,
                                           int has_clip, float clip,
                                           float wd) {
  g = __fmul_rn(g, rescale);
  if (has_clip) g = g < -clip ? -clip : (g > clip ? clip : g);
  return __fadd_rn(g, __fmul_rn(wd, w));
}

__device__ __forceinline__ void adam_one(float& w, float g, float& m,
                                         float& v, const AdamHyper& h) {
  g = prep_grad(g, w, h.rescale, h.has_clip, h.clip, h.wd);
  m = __fadd_rn(__fmul_rn(h.beta1, m), __fmul_rn(h.one_minus_beta1, g));
  v = __fadd_rn(__fmul_rn(h.beta2, v),
                __fmul_rn(__fmul_rn(h.one_minus_beta2, g), g));
  const float mhat = __fdiv_rn(m, h.bc1);
  const float vhat = __fdiv_rn(v, h.bc2);
  w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.lr, mhat),
                             __fadd_rn(__fsqrt_rn(vhat), h.eps)));
}

__device__ __forceinline__ void sgd_one(float& w, float g, float& mom,
                                        const SgdHyper& h) {
  g = prep_grad(g, w, h.rescale, h.has_clip, h.clip, h.wd);
  mom = __fsub_rn(__fmul_rn(h.momentum, mom), __fmul_rn(h.lr, g));
  w = __fadd_rn(w, mom);
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ w, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v, int64_t n, int vec,
            const float* __restrict__ hyper, AdamHyper h) {
  h.lr = hyper[0];
  h.wd = hyper[1];
  h.bc1 = hyper[2];
  h.bc2 = hyper[3];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  int64_t done = 0;
  if (vec) {
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const int64_t n4 = n >> 2;
    for (int64_t i = first; i < n4; i += stride) {
      float4 a = w4[i], c = m4[i], d = v4[i];
      const float4 b = g4[i];
      adam_one(a.x, b.x, c.x, d.x, h);
      adam_one(a.y, b.y, c.y, d.y, h);
      adam_one(a.z, b.z, c.z, d.z, h);
      adam_one(a.w, b.w, c.w, d.w, h);
      w4[i] = a;
      m4[i] = c;
      v4[i] = d;
    }
    done = n4 << 2;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    float a = w[i], c = m[i], d = v[i];
    adam_one(a, g[i], c, d, h);
    w[i] = a;
    m[i] = c;
    v[i] = d;
  }
}

__global__ void __launch_bounds__(kThreads)
sgd_mom_kernel(float* __restrict__ w, const float* __restrict__ g,
               float* __restrict__ mom, int64_t n, int vec,
               const float* __restrict__ hyper, SgdHyper h) {
  h.lr = hyper[0];
  h.wd = hyper[1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  int64_t done = 0;
  if (vec) {
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* p4 = reinterpret_cast<float4*>(mom);
    const int64_t n4 = n >> 2;
    for (int64_t i = first; i < n4; i += stride) {
      float4 a = w4[i], c = p4[i];
      const float4 b = g4[i];
      sgd_one(a.x, b.x, c.x, h);
      sgd_one(a.y, b.y, c.y, h);
      sgd_one(a.z, b.z, c.z, h);
      sgd_one(a.w, b.w, c.w, h);
      w4[i] = a;
      p4[i] = c;
    }
    done = n4 << 2;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    float a = w[i], c = mom[i];
    sgd_one(a, g[i], c, h);
    w[i] = a;
    mom[i] = c;
  }
}

// Blocks for n elements: enough to give each thread one float4 (or one
// element), at most one wave.
int blocks_for(int64_t n, bool vec) {
  const int64_t work = vec ? ((n >> 2) > (n & 3) ? (n >> 2) : (n & 3)) : n;
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// w, g, m, v: n contiguous floats each, four distinct buffers; w, m and v
// are updated in place. hyper: 4 floats on the card, (lr, wd, bc1, bc2),
// read when the kernel runs. one_minus_beta1/2 come from the host, where
// the reference computes 1 - beta in double before rounding it to fp32.
// Returns the cudaError_t of the launch.
extern "C" int adam_step_f32(float* w, const float* g, float* m, float* v,
                             long long n, const float* hyper, float beta1,
                             float one_minus_beta1, float beta2,
                             float one_minus_beta2, float eps, float rescale,
                             float clip, int has_clip, void* stream) {
  if (n <= 0 || hyper == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = mx_aligned16(w) && mx_aligned16(g) && mx_aligned16(m) &&
                   mx_aligned16(v);
  const AdamHyper h{0.f,   0.f,
                    1.f,   1.f,
                    beta1, one_minus_beta1,
                    beta2, one_minus_beta2,
                    eps,   rescale,
                    clip,  has_clip};
  adam_kernel<<<blocks_for(n, vec), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(w, g, m, v, n, vec,
                                                     hyper, h);
  return static_cast<int>(cudaGetLastError());
}

// w, g, mom: n contiguous floats each, three distinct buffers; w and mom
// are updated in place. hyper: 2 floats on the card, (lr, wd), read when
// the kernel runs. Returns the cudaError_t of the launch.
extern "C" int sgd_mom_step_f32(float* w, const float* g, float* mom,
                                long long n, const float* hyper,
                                float momentum, float rescale, float clip,
                                int has_clip, void* stream) {
  if (n <= 0 || hyper == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = mx_aligned16(w) && mx_aligned16(g) && mx_aligned16(mom);
  const SgdHyper h{0.f, 0.f, momentum, rescale, clip, has_clip};
  sgd_mom_kernel<<<blocks_for(n, vec), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(w, g, mom, n, vec,
                                                        hyper, h);
  return static_cast<int>(cudaGetLastError());
}
