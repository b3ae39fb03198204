// Int8 matrix product with the dequantize fused into its epilogue.
//
// Replaces mxnet_tpu/ops/pallas/int8_matmul.py:_kernel (launched by
// int8_matmul): out[m, n] = cast(float(sum_k x[m, k] * w[n, k]) * scale[n]
// (+ bias[n])), with x (M, K) int8 row-major, w (N, K) int8 (the Dense
// (out, in) layout), scale and bias (N,) fp32 and out (M, N) in fp32 or
// bf16. The sum is an exact int32 accumulator; the epilogue works on it in
// registers and writes each output once, as the TPU kernel applies it to its
// VMEM accumulator on the last K step. Each step of the epilogue is one
// rounded operation, as in the reference: __int2float_rn, then __fmul_rn and
// __fadd_rn (nvcc may not contract them into an FMA, which would round once
// where the reference rounds twice), then __float2bfloat16_rn for bf16.
//
// Bound on the H100: at decode (M of a few rows) bytes, the weight read:
// 2*M*N*K operations against N*K bytes of weights is far below the ~590
// int8 operations per byte where the tensor cores become the limit. At
// M = 512 the products are bound by operations.
//
// Design: tensor-core int8 MMA (mma.sync m16n8k32, s8 x s8 -> s32) on tiles
// staged through shared memory. A block owns a BM x BN tile of the output and
// walks all of K in steps of 64 bytes, with a ring of cp.async stages in
// flight; warps split the tile and each holds its accumulators in registers.
// Three tile shapes by M: 16 x 32 for M <= 16 (decode: the block's 16 rows
// cover every row, so each weight byte is read once per call, and narrow
// column tiles put hundreds of blocks on the 132 SMs to keep enough weight
// loads in flight), 64 x 64 for M <= 64 (a prefill chunk: again one pass over
// the weights), 128 x 128 above. Shared-memory rows are 64 + 16 bytes apart,
// so the fragment loads of a warp hit 32 distinct banks. Ragged edges are
// masked by the kernel: rows, columns and K past the end load as zeros and are
// never stored. The 16-byte cp.async path needs x and w 16-byte aligned and K
// a multiple of 16; otherwise the same kernel loads byte by byte. No
// wgmma/TMA yet: that is later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBK = 64;           // K bytes per stage: two k32 MMA steps
constexpr int kLd = kBK + 16;     // shared-memory row stride in bytes

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
struct Tile {
  static constexpr int kBM = BM, kBN = BN, kStages = STAGES;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kWM = BM / WARPS_M, kWN = BN / WARPS_N;
  static constexpr int kMT = kWM / 16, kNT = kWN / 8;  // MMA tiles per warp
  static constexpr int kSmem = STAGES * (BM + BN) * kLd;
  static_assert(kWM % 16 == 0 && kWN % 8 == 0, "warp tile");
};

using SmallTile = Tile<16, 32, 1, 4, 8>;
using MidTile = Tile<64, 64, 2, 2, 4>;
using LargeTile = Tile<128, 128, 2, 4, 3>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage the (rows x kBK) slab of a row-major int8 matrix with `ld` bytes a
// row, starting at row r0 and column k0, into shared memory; rows >= nrows
// and columns >= K become zeros.
template <int ROWS, int THREADS, bool VEC>
__device__ __forceinline__ void load_slab(int8_t* dst,
                                          const int8_t* __restrict__ src,
                                          int r0, int nrows, int k0, int K) {
  if (VEC) {
    constexpr int kChunks = ROWS * kBK / 16;
#pragma unroll
    for (int i = threadIdx.x; i < kChunks; i += THREADS) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool ok = r0 + r < nrows && k0 + c < K;
      const int8_t* g =
          ok ? src + static_cast<int64_t>(r0 + r) * K + k0 + c : src;
      cp_async16(dst + r * kLd + c, g, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * kBK; i += THREADS) {
      const int r = i / kBK, c = i % kBK;
      const bool ok = r0 + r < nrows && k0 + c < K;
      dst[r * kLd + c] =
          ok ? src[static_cast<int64_t>(r0 + r) * K + k0 + c] : int8_t(0);
    }
  }
}

template <class T, bool VEC>
__global__ void __launch_bounds__(T::kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, void* __restrict__ out,
                   int M, int N, int K, int out_bf16) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sa = smem;                                   // [STAGES][BM][kLd]
  int8_t* sb = smem + T::kStages * T::kBM * kLd;       // [STAGES][BN][kLd]

  const int m0 = blockIdx.y * T::kBM, n0 = blockIdx.x * T::kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / (T::kBN / T::kWN)) * T::kWM;
  const int wn = (warp % (T::kBN / T::kWN)) * T::kWN;
  const int g = lane / 4, t = lane % 4;   // MMA fragment row group, column

  int acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + kBK - 1) / kBK;
  auto load_stage = [&](int stage, int kt) {
    load_slab<T::kBM, T::kThreads, VEC>(sa + stage * T::kBM * kLd, x, m0, M,
                                        kt * kBK, K);
    load_slab<T::kBN, T::kThreads, VEC>(sb + stage * T::kBN * kLd, w, n0, N,
                                        kt * kBK, K);
  };
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is free to refill
    const int nxt = kt + T::kStages - 1;
    if (nxt < ktiles) load_stage(nxt % T::kStages, nxt);
    cp_async_commit();

    const int8_t* a = sa + (kt % T::kStages) * T::kBM * kLd;
    const int8_t* b = sb + (kt % T::kStages) * T::kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      int af[T::kMT][4], bf[T::kNT][2];
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        const int8_t* p = a + (wm + i * 16 + g) * kLd + kk + t * 4;
        af[i][0] = *reinterpret_cast<const int*>(p);
        af[i][1] = *reinterpret_cast<const int*>(p + 8 * kLd);
        af[i][2] = *reinterpret_cast<const int*>(p + 16);
        af[i][3] = *reinterpret_cast<const int*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
        const int8_t* p = b + (wn + j * 8 + g) * kLd + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const int*>(p);
        bf[j][1] = *reinterpret_cast<const int*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < T::kMT; ++i)
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue on the register accumulators: c[0], c[1] are row g, columns
  // 2t and 2t + 1 of the 16 x 8 tile; c[2], c[3] the same columns of row g+8
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < T::kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e / 2) * 8;
        const int n = n0 + wn + j * 8 + t * 2 + (e % 2);
        if (m >= M || n >= N) continue;
        float v = __fmul_rn(__int2float_rn(acc[i][j][e]), scale[n]);
        if (bias != nullptr) v = __fadd_rn(v, bias[n]);
        const int64_t o = static_cast<int64_t>(m) * N + n;
        if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
        else
          static_cast<float*>(out)[o] = v;
      }
    }
  }
}

template <class T, bool VEC>
int launch(const int8_t* x, const int8_t* w, const float* scale,
           const float* bias, void* out, int M, int N, int K, int out_bf16,
           cudaStream_t stream) {
  auto kernel = int8_matmul_kernel<T, VEC>;
  static bool configured = false;    // one opt-in per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((N + T::kBN - 1) / T::kBN, (M + T::kBM - 1) / T::kBM);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(x, w, scale, bias, out, M,
                                                  N, K, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_tile(const int8_t* x, const int8_t* w, const float* scale,
                const float* bias, void* out, int M, int N, int K,
                int out_bf16, cudaStream_t stream) {
  const bool vec = mx_aligned16(x) && mx_aligned16(w) && K % 16 == 0;
  return vec ? launch<T, true>(x, w, scale, bias, out, M, N, K, out_bf16,
                               stream)
             : launch<T, false>(x, w, scale, bias, out, M, N, K, out_bf16,
                                stream);
}

}  // namespace

// x (M, K) and w (N, K) int8 row-major, scale (N,) fp32, bias (N,) fp32 or
// null, out (M, N) fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1). K at most
// 131071, so that no int32 sum of int8 products can overflow; M at most
// 65535 tiles. Returns the cudaError_t of the launch.
extern "C" int int8_matmul_s8(const int8_t* x, const int8_t* w,
                              const float* scale, const float* bias, void* out,
                              int M, int N, int K, int out_bf16,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > 131071)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= SmallTile::kBM)
    return launch_tile<SmallTile>(x, w, scale, bias, out, M, N, K, out_bf16,
                                  st);
  if (M <= MidTile::kBM)
    return launch_tile<MidTile>(x, w, scale, bias, out, M, N, K, out_bf16,
                                st);
  if ((M + LargeTile::kBM - 1) / LargeTile::kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tile<LargeTile>(x, w, scale, bias, out, M, N, K, out_bf16,
                                st);
}
