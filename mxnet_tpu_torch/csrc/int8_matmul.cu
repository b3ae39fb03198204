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
// Bound on the H100: at decode and prefill chunks (M up to 64 rows) bytes,
// the weight read: 2*M*N*K operations against N*K bytes of weights is far
// below the ~590 int8 operations per byte where the tensor cores become the
// limit. At M = 512 the products are bound by operations.
//
// Three designs, chosen before the launch by the wrapper's plan
// (ops/kernels/int8_matmul.py:plan), which this entry checks:
//
// - tma_splitk (M <= 64, aligned): the product is computed transposed,
//   out^T = w x^T, on wgmma m64nNk32 s8 x s8 -> s32. A 64-row tile of w is
//   the A operand and x's M rows, rounded up to N = 8, 16, 32 or 64, the B
//   operand; both are K-major as stored. Both are staged by TMA
//   (cp.async.bulk.tensor.2d) in 128-byte rows of K, 128-byte swizzled, into
//   a ring of stages driven by full/empty mbarriers: one thread of a
//   producer warpgroup keeps the loads in flight, one consumer warpgroup
//   runs four k32 wgmmas a stage. TMA fills boxes past the ends of M, N
//   and K with zeros, which add nothing to an integer sum. K is split
//   into as many parts as one wave of two blocks an SM holds (two blocks
//   of about 100 KB of stages fit an SM): each split stores its
//   int32 partial tile in its own slice of a workspace, and the block that
//   arrives last at its tile's counter (atomicAdd after __threadfence) adds
//   the other slices, applies the epilogue and sets the counter back to 0.
//   Integer sums are exact in any order, so the result is bit-equal to one
//   pass. One launch a call.
// - tma (M > 64, aligned): the same pipeline, x as A and w as B, two
//   consumer warpgroups on wgmma m64n128k32 (a 128 x 128 output tile); K is
//   split only when fewer tiles than SMs would leave whole SMs idle.
// - sm80 (x or w off 16-byte alignment, or K % 16 != 0: TMA needs a
//   16-byte aligned base and row stride): the earlier kernel, mma.sync m16n8k32
//   tiles staged through a cp.async ring, or byte loads where the data is
//   misaligned. A block owns a BM x BN tile of the output and walks all of K
//   in steps of 64 bytes; three tile shapes by M: 16 x 32 for M <= 16,
//   64 x 64 for M <= 64, 128 x 128 above. Shared-memory rows are 64 + 16
//   bytes apart, so the fragment loads of a warp hit 32 distinct banks.
//   Ragged edges are masked by the kernel.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint so that the library links against the
// runtime alone, and passed as __grid_constant__ kernel parameters.
#include <cuda.h>
#include <cudaTypedefs.h>
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
  static bool configured[kMxMaxDevices] = {};   // per device index
  const int rc = mx_smem_opt_in(kernel, T::kSmem, configured);
  if (rc != 0) return rc;
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


// ------------------------------------------------ Hopper: TMA + wgmma path

constexpr int kTmaBK = 128;   // K bytes a stage: one 128-byte swizzled row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One 2-D TMA box (c0 along K in bytes, c1 along rows) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzled,
// 1024-byte aligned: start address >> 4, leading offset 1 (unused for a
// swizzled K-major operand), stride 1024 bytes between 8-row groups,
// layout type 1 (128B swizzle). A k32 step adds 32 bytes (2 in units of 16).
__device__ __forceinline__ uint64_t wg_desc(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmma's fence and wait.
template <int R>
__device__ __forceinline__ void wg_fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The consumer warpgroups' own barrier (the producer does not take part).
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// wgmma.mma_async m64nNk32, s8 x s8 -> s32, both operands from shared
// memory through descriptors, accumulating into d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(int (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(int (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
          "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
          "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]),
          "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
          "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
          "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]),
          "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// One output tile of (64 * WG) A rows x BN B rows. SWAP: A is w and B is x
// (out^T = w x^T, for M <= 64); otherwise A is x and B is w.
template <int BN, int WG, bool SWAP>
struct WgTile {
  static constexpr int kRowsA = 64 * WG;
  static constexpr int kBytesA = kRowsA * kTmaBK, kBytesB = BN * kTmaBK;
  static constexpr int kStageBytes = kBytesA + kBytesB;
  static constexpr int kStages = SWAP ? (BN == 64 ? 6 : 8) : 5;
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kThreads = kConsumers + 128;   // + the producer
  static constexpr int kRegs = BN / 2;     // accumulators a thread
  // stages, then 2 * kStages mbarriers; 1024 bytes to align the tiles
  static constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;
  static_assert(kBytesB % 1024 == 0, "tiles stay 1024-byte aligned");
};

// Two blocks an SM on the swap path (about 100 KB of stages each, 128
// registers a thread), one on the 128 x 128 path.
template <int BN, int WG, bool SWAP>
__global__ void __launch_bounds__(WgTile<BN, WG, SWAP>::kThreads, SWAP ? 2 : 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, void* __restrict__ out,
                  int M, int N, int K, int out_bf16, int splits,
                  int chunk, int* __restrict__ ws,
                  int* __restrict__ counters) {
  using T = WgTile<BN, WG, SWAP>;
  extern __shared__ __align__(1024) uint8_t wg_raw[];
  __shared__ int s_last;
  uint8_t* smem = wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kStages *
                                               T::kStageBytes);
  uint64_t* empty = full + T::kStages;

  const int ta = blockIdx.x, tb = blockIdx.y, split = blockIdx.z;
  // split s sums the 128-byte K tiles s * chunk .. (s + 1) * chunk - 1,
  // the last split up to the end of K (the plan's chunk, checked below)
  const int ktiles = (K + kTmaBK - 1) / kTmaBK;
  const int kt0 = split * chunk;
  const int n_kt = min(ktiles, kt0 + chunk) - kt0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG) {
    // producer warpgroup: one thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == T::kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % T::kStages;
        mbar_wait(&empty[s], ((i / T::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::kStageBytes);
        uint8_t* st = smem + s * T::kStageBytes;
        const int k = (kt0 + i) * kTmaBK;
        tma_load_2d(st, &map_a, &full[s], k, ta * T::kRowsA);
        tma_load_2d(st + T::kBytesA, &map_b, &full[s], k, tb * BN);
      }
    }
    return;
  }

  // consumer warpgroup wg: A rows wg*64 .. wg*64 + 63 of the tile
  int acc[T::kRegs];
#pragma unroll
  for (int i = 0; i < T::kRegs; ++i) acc[i] = 0;
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % T::kStages;
    mbar_wait(&full[s], (i / T::kStages) & 1);
    const uint8_t* st = smem + s * T::kStageBytes;
    const uint64_t da = wg_desc(st + wg * 64 * kTmaBK);
    const uint64_t db = wg_desc(st + T::kBytesA);
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTmaBK / 32; ++kk)
      Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wg_commit();
    wg_wait<1>();            // the previous stage's wgmmas are done
    wg_fence_acc(acc);
    if (i > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(i - 1) % T::kStages]);
  }
  wg_wait<0>();
  wg_fence_acc(acc);

  if (splits > 1) {
    // this split's partial tile into its slice, in fragment order; the
    // last block of the tile to arrive adds the others
    const int tile = tb * gridDim.x + ta;
    const int ct = threadIdx.x;
    const size_t slice = static_cast<size_t>(T::kRegs) * T::kConsumers;
    int* mine = ws + (static_cast<size_t>(tile) * splits + split) * slice;
#pragma unroll
    for (int r = 0; r < T::kRegs; ++r) __stcg(mine + r * T::kConsumers + ct,
                                              acc[r]);
    __threadfence();
    consumer_sync(T::kConsumers);
    if (ct == 0) s_last = atomicAdd(&counters[tile], 1) == splits - 1;
    consumer_sync(T::kConsumers);
    if (!s_last) return;
    __threadfence();
    for (int sp = 0; sp < splits; ++sp) {
      if (sp == split) continue;
      const int* other = ws + (static_cast<size_t>(tile) * splits + sp) *
                                  slice;
#pragma unroll
      for (int r = 0; r < T::kRegs; ++r)
        acc[r] += __ldcg(other + r * T::kConsumers + ct);
    }
    if (ct == 0) counters[tile] = 0;     // zero again for the next call
  }

  // epilogue: register d[4j + e] of a thread holds tile row
  // w*16 + g + 8*(e/2) of its warpgroup and column 8j + 2*t4 + e%2
  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = ta * T::kRowsA + wg * 64 + w * 16 + g + (e / 2) * 8;
      const int b = tb * BN + j * 8 + t4 * 2 + (e % 2);
      const int m = SWAP ? b : a, n = SWAP ? a : b;
      if (m >= M || n >= N) continue;
      float v = __fmul_rn(__int2float_rn(acc[j * 4 + e]), scale[n]);
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      const int64_t o = static_cast<int64_t>(m) * N + n;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime.
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The map of a row-major (rows, K) int8 matrix, boxes of 128 K-bytes by
// box_rows rows, 128-byte swizzled; boxes past the ends read as zeros.
int encode_map(CUtensorMap* map, const int8_t* p, int K, int rows,
               int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  cuuint32_t box[2] = {kTmaBK, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<int8_t*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int BN, int WG, bool SWAP>
int launch_wgmma(const int8_t* x, const int8_t* w, const float* scale,
                 const float* bias, void* out, int M, int N, int K,
                 int out_bf16, int splits, int chunk, int* ws,
                 int* counters, cudaStream_t stream) {
  using T = WgTile<BN, WG, SWAP>;
  const int rows_a = SWAP ? N : M, rows_b = SWAP ? M : N;
  const int ta = (rows_a + T::kRowsA - 1) / T::kRowsA;
  const int tb = (rows_b + BN - 1) / BN;
  // every split sums at least one K tile and together they sum each once
  const int ktiles = (K + kTmaBK - 1) / kTmaBK;
  if (splits < 1 || chunk < 1 || (splits - 1) * chunk >= ktiles ||
      splits * chunk < ktiles || splits > 65535 || tb > 65535 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  int rc = encode_map(&map_a, SWAP ? w : x, K, rows_a, T::kRowsA);
  if (rc == 0) rc = encode_map(&map_b, SWAP ? x : w, K, rows_b, BN);
  if (rc != 0) return rc;
  auto kernel = int8_wgmma_kernel<BN, WG, SWAP>;
  static bool configured[kMxMaxDevices] = {};   // per device index
  rc = mx_smem_opt_in(kernel, T::kSmem, configured);
  if (rc != 0) return rc;
  kernel<<<dim3(ta, tb, splits), T::kThreads, T::kSmem, stream>>>(
      map_a, map_b, scale, bias, out, M, N, K, out_bf16, splits, chunk, ws,
      counters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) and w (N, K) int8 row-major, scale (N,) fp32, bias (N,) fp32 or
// null, out (M, N) fp32 (out_bf16 = 0) or bf16 (out_bf16 = 1). K at most
// 131071, so that no int32 sum of int8 products can overflow. The design
// comes from the wrapper's plan: path 0 sm80; path 1 tma (tile_n 128);
// path 2 tma_splitk (tile_n 8, 16, 32 or 64, at least M). For paths 1 and
// 2, x and w must be 16-byte aligned and K a multiple of 16; split s of
// `splits` sums the 128-byte K tiles s * chunk .. (s + 1) * chunk - 1 (the
// last one to the end of K), and the entry refuses a chunk and split count
// that leave a split empty or a K tile unsummed; a split launch needs `ws`
// (splits * tiles * (64 or 128) * tile_n int32) and `counters` (one int32
// a tile, zero, and left zero by the kernel). Returns the cudaError_t of
// the launch.
extern "C" int int8_matmul_s8(const int8_t* x, const int8_t* w,
                              const float* scale, const float* bias, void* out,
                              int M, int N, int K, int out_bf16, int path,
                              int tile_n, int splits, int chunk, int* ws,
                              int* counters, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > 131071)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (M <= SmallTile::kBM)
      return launch_tile<SmallTile>(x, w, scale, bias, out, M, N, K,
                                    out_bf16, st);
    if (M <= MidTile::kBM)
      return launch_tile<MidTile>(x, w, scale, bias, out, M, N, K, out_bf16,
                                  st);
    if ((M + LargeTile::kBM - 1) / LargeTile::kBM > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_tile<LargeTile>(x, w, scale, bias, out, M, N, K, out_bf16,
                                  st);
  }
  if (!mx_aligned16(x) || !mx_aligned16(w) || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1 && tile_n == 128)
    return launch_wgmma<128, 2, false>(x, w, scale, bias, out, M, N, K,
                                       out_bf16, splits, chunk, ws,
                                       counters, st);
  if (path != 2 || M > tile_n) return static_cast<int>(cudaErrorInvalidValue);
  switch (tile_n) {
    case 8:
      return launch_wgmma<8, 1, true>(x, w, scale, bias, out, M, N, K,
                                      out_bf16, splits, chunk, ws,
                                      counters, st);
    case 16:
      return launch_wgmma<16, 1, true>(x, w, scale, bias, out, M, N, K,
                                       out_bf16, splits, chunk, ws,
                                       counters, st);
    case 32:
      return launch_wgmma<32, 1, true>(x, w, scale, bias, out, M, N, K,
                                       out_bf16, splits, chunk, ws,
                                       counters, st);
    case 64:
      return launch_wgmma<64, 1, true>(x, w, scale, bias, out, M, N, K,
                                       out_bf16, splits, chunk, ws,
                                       counters, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
