// Row normalisation, RMS or LayerNorm, fp32.
//
// Replaces mxnet_tpu/ops/pallas/fused_norms.py:_ln_kernel (launched by
// _ln_pallas): y = x * rsqrt(mean(x^2) + eps) * gamma for RMS, and
// y = (x - mean) * rsqrt(mean((x - mean)^2) + eps) * gamma + beta for
// LayerNorm (the reference's centred second pass), with the statistics in
// fp32.
//
// What bounds it on the H100. At many rows, bytes: x and gamma read once,
// y written once; (2048, 4096) moves 67 MB, 0.020 ms at 3.35 TB/s. At a
// decode step's shape, (4, 4096), or a prefill chunk's, (32, 4096), not
// bytes but launch and latency: 128 KB is 0.04 us at that rate, while an
// empty kernel in a CUDA graph takes about 1 us and a copy floor (a kernel
// of the regs grid and block that reads x and gamma and writes x * gamma,
// with no reduction: chip_smoke.py FLOOR_SOURCE) about 1.6 us. There a
// design can only cut what it adds to that floor (a second round trip of
// loads, barriers, a serial reduction) or shorten the round trip itself
// (PERF.md).
//
// Three designs; the Python plan (ops/kernels/fused_norms.py plan) picks
// one from the shapes and the pointers' alignment alone, and the C entry
// refuses a plan that does not fit.
//
// regs: one block a row, T threads of V 16-byte vectors each (template
//   parameters; T * V * 4 >= d, the tail masked; d a multiple of 4 up to
//   8192, every pointer 16-byte aligned). Each thread issues all its loads
//   of x, gamma and beta at kernel start, so the row and the weights arrive
//   in one round trip, and the row stays in registers: it is never read
//   again. gamma and beta are read with ld.relaxed.cta, which the compiler
//   keeps before the first barrier; as read-only loads (ld.global.nc) it
//   sank them past the reduction and paid a second round trip at the
//   decode step's shape (L1 still serves them). A sum takes one barrier:
//   warp shuffles, one partial a warp in shared memory, one __syncthreads,
//   then every thread adds the partials from shared memory in one order
//   (one round of loads where a second warp reduction would take five
//   dependent shuffles). LayerNorm takes its mean and then its centred
//   variance from the registers, one such sum each, in two arrays of
//   partials so that the second never waits for the first to be read.
// cluster: for an RMS batch of at most 32 rows, each row split over a
//   cluster of C = 2, 4 or 8 blocks (n * C blocks, one wave), each block
//   holding its slice in registers as above: a block pulls 1 / C of the
//   row through its SM, which shortens the round trip. Each warp's partial
//   sum goes to every block of its cluster, st.async into the others'
//   shared memory, counted on an mbarrier there, and a store and an arrive
//   into its own; a block then waits on its own mbarrier, never on a
//   cluster barrier, and adds the C * T / 32 partials in one order, so
//   every block holds the same total. The one cluster barrier only says
//   that every block's mbarriers are ready: its arrive is the first thing a
//   block does, its wait comes after the loads and the warp sums. The
//   cluster size is the kernel's own (__cluster_dims__). The kernel takes
//   LayerNorm too, but its two sums cross the cluster twice, which cost
//   more than the split saved, so the plan gives LayerNorm regs.
// general: the earlier design, for what the others do not take (d not a
//   multiple of 4, d above 8192, pointers off 16-byte alignment): one block
//   of 256 threads a row, strided loads (16-byte ones where it can), the
//   statistics passes re-reading the row.
#include "common.cuh"

namespace {

// ------------------------------------------------------------- general

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

// ------------------------------------------------------ regs and cluster

constexpr int kMaxWarps = 16;    // 512 threads
constexpr int kMaxCluster = 8;   // the largest portable cluster

// 16 bytes of x, which the kernel does not write.
__device__ __forceinline__ float4 ld_nc(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// 16 bytes of a weight, issued before the block's first barrier.
__device__ __forceinline__ float4 ld_cta(const float4* p) {
  float4 v;
  asm volatile("ld.relaxed.cta.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared-memory address of `p` in the cluster's block of rank `r`.
__device__ __forceinline__ unsigned mapa(const void* p, unsigned r) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(r));
  return a;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
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

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// 4 bytes into another block's shared memory (`dst`, `bar` from mapa),
// counted on the mbarrier there.
__device__ __forceinline__ void st_async(unsigned dst, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// What one sum of a row takes in shared memory: a partial for each warp
// of the row's C blocks, and for a cluster the mbarrier that counts them
// in.
template <int T, int C>
struct Sum {
  __align__(16) float part[C * (T / 32)];
  uint64_t bar;
};

// The sum of part[0, P) (P 2 or a multiple of 4) in one order for every
// thread: four running sums over float4s, then those.
template <int P>
__device__ __forceinline__ float parts_sum(const float* part) {
  if constexpr (P == 2) {
    return part[0] + part[1];
  } else {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    float4 a = p4[0];
#pragma unroll
    for (int i = 1; i < P / 4; ++i) {
      const float4 b = p4[i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    return (a.x + a.z) + (a.y + a.w);
  }
}

// The sum of v over the row, which every thread gets. One block a row
// (C = 1): warp shuffles, a partial a warp, one barrier. A cluster of C
// blocks a row, this one of rank `rank`: lane r of each warp puts the
// warp's partial into block r (st.async, or a store and an arrive into its
// own), and the block waits on its own mbarrier, no block barrier. Then
// every thread adds all the partials from shared memory in one order (one
// round of loads where a second warp reduction would take five dependent
// shuffles), so every block of a cluster holds the same total.
template <int T, int C>
__device__ __forceinline__ float row_sum(float v, Sum<T, C>& sm,
                                         unsigned rank) {
  constexpr int NW = T / 32;
  v = mx_warp_sum(v);
  const unsigned lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if constexpr (C == 1) {
    if (lane == 0) sm.part[wid] = v;
    __syncthreads();
  } else {
    const unsigned slot = rank * NW + wid;
    if (lane < C) {
      if (lane == rank) {
        sm.part[slot] = v;
        mbar_arrive(&sm.bar);
      } else {
        st_async(mapa(&sm.part[slot], lane), v, mapa(&sm.bar, lane));
      }
    }
    mbar_wait(&sm.bar);
  }
  return parts_sum<C * NW>(sm.part);
}

// One row (C = 1), or its slice in the block of rank `rank` of a cluster
// of C: the vectors j = rank * T * V + k * T + threadIdx.x, k < V, that
// are below nv = d / 4.
template <int T, int V, bool RMS, int C>
__device__ __forceinline__ void norm_row(const float4* __restrict__ x,
                                         const float4* __restrict__ gamma,
                                         const float4* __restrict__ beta,
                                         float4* __restrict__ y, int nv,
                                         float inv_d, float eps) {
  static_assert(T % 32 == 0 && T / 32 <= kMaxWarps, "1 to 16 warps");
  static_assert(C * (T / 32) >= 2 && C * (T / 32) <= 32, "2 to 32 parts");
  __shared__ Sum<T, C> sums[RMS ? 1 : 2];
  unsigned rank = 0;
  if constexpr (C > 1) {
    rank = cluster_rank();
    // ready this block's mbarriers for the cluster's partials: an arrive
    // from each of its own warps and one here, and the others' bytes;
    // then say so to the cluster, and wait for the others only before
    // the first put into them
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < (RMS ? 1 : 2); ++i) {
        mbar_init(&sums[i].bar, T / 32 + 1);
        mbar_arrive_expect(&sums[i].bar, (C - 1) * (T / 32) * 4);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  const size_t row = blockIdx.x / C;
  const float4* xr = x + row * nv;
  float4* yr = y + row * nv;
  const int j0 =
      static_cast<int>(rank) * T * V + static_cast<int>(threadIdx.x);

  // every load of the thread, before any arithmetic; a slot past the row
  // loads the row's last vector, and is masked below
  float4 xv[V], gv[V], bv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) xv[k] = ld_nc(xr + min(j0 + k * T, nv - 1));
#pragma unroll
  for (int k = 0; k < V; ++k) gv[k] = ld_cta(gamma + min(j0 + k * T, nv - 1));
  if (!RMS && beta != nullptr) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      bv[k] = ld_cta(beta + min(j0 + k * T, nv - 1));
  }

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (j0 + k * T < nv) {
      const float4 v = xv[k];
      s += RMS ? v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w
               : v.x + v.y + v.z + v.w;
    }
  }
  if constexpr (C > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const float tot = row_sum<T, C>(s, sums[0], rank);

  float mean = 0.f, rstd;
  if constexpr (RMS) {
    rstd = rsqrtf(tot * inv_d + eps);
  } else {
    mean = tot * inv_d;
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (j0 + k * T < nv) {
        const float a = xv[k].x - mean, b = xv[k].y - mean,
                    c = xv[k].z - mean, e = xv[k].w - mean;
        s2 += a * a + b * b + c * c + e * e;
      }
    }
    rstd = rsqrtf(row_sum<T, C>(s2, sums[RMS ? 0 : 1], rank) * inv_d + eps);
  }

#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = j0 + k * T;
    if (j < nv) {
      const float4 v = xv[k], g = gv[k];
      float4 o;
      o.x = (v.x - mean) * rstd * g.x;
      o.y = (v.y - mean) * rstd * g.y;
      o.z = (v.z - mean) * rstd * g.z;
      o.w = (v.w - mean) * rstd * g.w;
      if (!RMS && beta != nullptr) {
        o.x += bv[k].x;
        o.y += bv[k].y;
        o.z += bv[k].z;
        o.w += bv[k].w;
      }
      yr[j] = o;
    }
  }
}

template <int T, int V, bool RMS>
__global__ void __launch_bounds__(T)
fused_norm_regs_kernel(const float4* __restrict__ x,
                       const float4* __restrict__ gamma,
                       const float4* __restrict__ beta,
                       float4* __restrict__ y, int nv, float inv_d,
                       float eps) {
  norm_row<T, V, RMS, 1>(x, gamma, beta, y, nv, inv_d, eps);
}

// The cluster size is the kernel's own (__cluster_dims__): a plain launch
// of n * C blocks makes n clusters.
template <int T, int V, bool RMS, int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(T)
fused_norm_cluster_kernel(const float4* __restrict__ x,
                          const float4* __restrict__ gamma,
                          const float4* __restrict__ beta,
                          float4* __restrict__ y, int nv, float inv_d,
                          float eps) {
  norm_row<T, V, RMS, C>(x, gamma, beta, y, nv, inv_d, eps);
}

struct Args {
  const float4* x;
  const float4* gamma;
  const float4* beta;
  float4* y;
  int n, nv;
  float inv_d, eps;
  cudaStream_t st;
};

template <int T, int V, bool RMS, int C>
int launch(const Args& a) {
  if constexpr (C == 1)
    fused_norm_regs_kernel<T, V, RMS><<<a.n, T, 0, a.st>>>(
        a.x, a.gamma, a.beta, a.y, a.nv, a.inv_d, a.eps);
  else
    fused_norm_cluster_kernel<T, V, RMS, C><<<a.n * C, T, 0, a.st>>>(
        a.x, a.gamma, a.beta, a.y, a.nv, a.inv_d, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <int T, bool RMS, int C>
int launch_v(int vecs, const Args& a) {
  switch (vecs) {
    case 1: return launch<T, 1, RMS, C>(a);
    case 2: return launch<T, 2, RMS, C>(a);
    case 3: return launch<T, 3, RMS, C>(a);
    case 4: return launch<T, 4, RMS, C>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the blocks built: regs 64 to 512 threads, cluster 32 to 256, and at
// most 32 partials a sum
template <bool RMS, int C, int T>
int launch_t(int vecs, const Args& a) {
  constexpr int kParts = C * (T / 32);
  if constexpr ((C == 1 ? T >= 64 : T <= 256) && kParts <= 32)
    return launch_v<T, RMS, C>(vecs, a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <bool RMS, int C>
int launch_tv(int threads, int vecs, const Args& a) {
  switch (threads) {
    case 32: return launch_t<RMS, C, 32>(vecs, a);
    case 64: return launch_t<RMS, C, 64>(vecs, a);
    case 128: return launch_t<RMS, C, 128>(vecs, a);
    case 256: return launch_t<RMS, C, 256>(vecs, a);
    case 512: return launch_t<RMS, C, 512>(vecs, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool RMS>
int launch_c(int cluster, int threads, int vecs, const Args& a) {
  switch (cluster) {
    case 1: return launch_tv<RMS, 1>(threads, vecs, a);
    case 2: return launch_tv<RMS, 2>(threads, vecs, a);
    case 4: return launch_tv<RMS, 4>(threads, vecs, a);
    case 8: return launch_tv<RMS, 8>(threads, vecs, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y: (n, d) row-major; gamma, beta: (d,); beta may be null, and must be
// in RMS mode. The plan (ops/kernels/fused_norms.py plan): design 0
// (general; threads 256, vecs 0, cluster 1), 1 (regs: cluster 1, threads
// 64 to 512) or 2 (cluster: cluster 2, 4 or 8, threads 32 to 256), each
// block `threads` threads of `vecs` (1 to 4) 16-byte vectors. A plan that
// does not fit is refused: regs and cluster need d a multiple of 4, every
// pointer 16-byte aligned, blocks that cover the row with no vector column
// of the row's last block left empty (threads * vecs * cluster >= d / 4 >
// threads * (vecs * cluster - 1)) and at most 32 partials a sum. Returns
// the cudaError_t of the launch.
extern "C" int fused_norm_f32(const float* x, const float* gamma,
                              const float* beta, float* y, int n, int d,
                              float eps, int rms, int design, int threads,
                              int vecs, int cluster, void* stream) {
  if (n <= 0 || d <= 0 || (rms && beta != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    if (threads != kThreads || vecs != 0 || cluster != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = (d % 4 == 0) && mx_aligned16(x) && mx_aligned16(gamma) &&
                     (beta == nullptr || mx_aligned16(beta)) &&
                     mx_aligned16(y);
    if (vec)
      fused_norm_kernel<true><<<n, kThreads, 0, st>>>(x, gamma, beta, y, d,
                                                       eps, rms);
    else
      fused_norm_kernel<false><<<n, kThreads, 0, st>>>(x, gamma, beta, y, d,
                                                        eps, rms);
    return static_cast<int>(cudaGetLastError());
  }
  const long long nv = d / 4;
  const long long slots = static_cast<long long>(threads) * vecs * cluster;
  if ((design == 1) != (cluster == 1) || (design != 1 && design != 2) ||
      cluster > kMaxCluster || d % 4 != 0 || !mx_aligned16(x) ||
      !mx_aligned16(gamma) || (beta != nullptr && !mx_aligned16(beta)) ||
      !mx_aligned16(y) || threads <= 0 || vecs <= 0 || slots < nv ||
      slots - threads >= nv || cluster * (threads / 32) > 32 ||
      static_cast<long long>(n) * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{reinterpret_cast<const float4*>(x),
               reinterpret_cast<const float4*>(gamma),
               reinterpret_cast<const float4*>(beta),
               reinterpret_cast<float4*>(y),
               n,
               static_cast<int>(nv),
               1.0f / static_cast<float>(d),
               eps,
               st};
  return rms ? launch_c<true>(cluster, threads, vecs, a)
             : launch_c<false>(cluster, threads, vecs, a);
}
