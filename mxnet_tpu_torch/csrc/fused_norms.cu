// Row normalisation, RMS or LayerNorm, over fp32 or bf16 data.
//
// Replaces mxnet_tpu/ops/pallas/fused_norms.py:_ln_kernel (launched by
// _ln_pallas): y = x * rsqrt(mean(x^2) + eps) * gamma for RMS, and
// y = (x - mean) * rsqrt(mean((x - mean)^2) + eps) * gamma + beta for
// LayerNorm (the reference's centred second pass), with the statistics in
// fp32. As the Pallas kernel does, x and the weights (gamma, beta: one
// type for both) are each fp32 or bf16, loaded and widened to fp32, and y
// is stored in the reference's promotion of their types (_out_dtype): bf16
// only when x and the weights are bf16, fp32 otherwise (bf16 x with fp32
// weights, the mixed-precision case, gives fp32).
//
// What bounds it on the H100. At many rows, bytes: x and gamma read once,
// y written once; (2048, 4096) moves 67 MB in fp32, 0.020 ms at 3.35 TB/s,
// and half that in bf16 (2 bytes an element of x and y). At a
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
// A vector is the 16 bytes of x a thread loads at once: E = 4 elements in
// fp32, 8 in bf16. The weights and y of those E elements are loaded and
// stored in their own types beside it (32 bytes of fp32 weights beside
// bf16 x, 8 bytes of bf16 weights beside fp32 x), so the register designs
// take d a multiple of E up to 2048 * E, and the plan sizes them in
// vectors of E.
//
// regs: one block a row, T threads of V 16-byte vectors each (template
//   parameters; T * V * E >= d, the tail masked; d a multiple of E up to
//   2048 * E, every pointer 16-byte aligned). Each thread issues all its loads
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
//   multiple of E, d above 2048 * E, pointers off 16-byte alignment): one
//   block of 256 threads a row, strided loads (16-byte ones where it can in
//   fp32, one element at a time otherwise), the statistics passes
//   re-reading the row.
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

// VEC (fp32 only, d % 4 == 0, aligned): float4 loads and stores; else one
// element at a time, in the element types.
template <class TX, class TW, class TY, bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ gamma,
                  const TW* __restrict__ beta, TY* __restrict__ y, int d,
                  float eps, int rms) {
  __shared__ float red[32];
  const TX* xr = x + static_cast<size_t>(blockIdx.x) * d;
  TY* yr = y + static_cast<size_t>(blockIdx.x) * d;
  const float fd = static_cast<float>(d);

  float s = 0.f;
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < (d >> 2); i += kThreads) {
      const float4 v = x4[i];
      s += rms ? (v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w)
               : (v.x + v.y + v.z + v.w);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = mx_to_f32(xr[i]);
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
    if constexpr (VEC) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      for (int i = threadIdx.x; i < (d >> 2); i += kThreads) {
        const float4 v = x4[i];
        const float a = v.x - mean, b = v.y - mean, c = v.z - mean,
                    e = v.w - mean;
        s2 += a * a + b * b + c * c + e * e;
      }
    } else {
      for (int i = threadIdx.x; i < d; i += kThreads) {
        const float a = mx_to_f32(xr[i]) - mean;
        s2 += a * a;
      }
    }
    rstd = rsqrtf(block_sum(s2, red) / fd + eps);
  }

  if constexpr (VEC) {
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
      float o = (mx_to_f32(xr[i]) - mean) * rstd * mx_to_f32(gamma[i]);
      if (beta != nullptr) o += mx_to_f32(beta[i]);
      yr[i] = mx_from_f32<TY>(o);
    }
  }
}

// ------------------------------------------------------ regs and cluster

constexpr int kMaxWarps = 16;    // 512 threads
constexpr int kMaxCluster = 8;   // the largest portable cluster

// E elements of type T, as the 32-bit words they were loaded in (8, 16 or
// 32 bytes); element i widened to fp32 by v[i].
template <class T, int E>
struct Vec {
  static constexpr int kWords = E * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];
  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (sizeof(T) == 4)
      return __uint_as_float(w[i]);
    else
      return (i & 1) ? mx_bf16_hi(w[i >> 1]) : mx_bf16_lo(w[i >> 1]);
  }
};

// 16 bytes at p into w[0..3]: x with ld.global.nc (the kernel does not
// write it), a weight with ld.relaxed.cta, which is issued before the
// block's first barrier.
template <bool NC>
__device__ __forceinline__ void ld16(const void* p, uint32_t* w) {
  if constexpr (NC)
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "l"(p));
  else
    asm volatile("ld.relaxed.cta.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "l"(p));
}

template <bool NC>
__device__ __forceinline__ void ld8(const void* p, uint32_t* w) {
  if constexpr (NC)
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w[0]), "=r"(w[1])
                 : "l"(p));
  else
    asm volatile("ld.relaxed.cta.global.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w[0]), "=r"(w[1])
                 : "l"(p));
}

// Vector j (elements j * E .. j * E + E - 1) of p.
template <bool NC, class T, int E>
__device__ __forceinline__ Vec<T, E> load_vec(const T* p, int j) {
  Vec<T, E> v;
  const T* at = p + static_cast<size_t>(j) * E;
  if constexpr (Vec<T, E>::kWords == 2) {
    ld8<NC>(at, v.w);
  } else {
#pragma unroll
    for (int i = 0; i < Vec<T, E>::kWords; i += 4)
      ld16<NC>(reinterpret_cast<const char*>(at) + 4 * i, v.w + i);
  }
  return v;
}

// o[0..E) rounded to T into vector j of p.
template <class T, int E>
__device__ __forceinline__ void store_vec(T* p, int j, const float (&o)[E]) {
  T* at = p + static_cast<size_t>(j) * E;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < E; i += 4)
      *reinterpret_cast<float4*>(at + i) =
          make_float4(o[i], o[i + 1], o[i + 2], o[i + 3]);
  } else if constexpr (E == 4) {
    *reinterpret_cast<uint2*>(at) =
        make_uint2(mx_pack_bf16(o[0], o[1]), mx_pack_bf16(o[2], o[3]));
  } else {
    static_assert(E == 8, "8 bf16 a vector");
    *reinterpret_cast<uint4*>(at) =
        make_uint4(mx_pack_bf16(o[0], o[1]), mx_pack_bf16(o[2], o[3]),
                   mx_pack_bf16(o[4], o[5]), mx_pack_bf16(o[6], o[7]));
  }
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
// are below nv = d / E, E = 16 / sizeof(TX) elements each.
template <class TX, class TW, class TY, int T, int V, bool RMS, int C>
__device__ __forceinline__ void norm_row(const TX* __restrict__ x,
                                         const TW* __restrict__ gamma,
                                         const TW* __restrict__ beta,
                                         TY* __restrict__ y, int nv,
                                         float inv_d, float eps) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
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
  const TX* xr = x + row * nv * E;
  TY* yr = y + row * nv * E;
  const int j0 =
      static_cast<int>(rank) * T * V + static_cast<int>(threadIdx.x);

  // every load of the thread, before any arithmetic; a slot past the row
  // loads the row's last vector, and is masked below
  Vec<TX, E> xv[V];
  Vec<TW, E> gv[V], bv[V];
#pragma unroll
  for (int k = 0; k < V; ++k)
    xv[k] = load_vec<true, TX, E>(xr, min(j0 + k * T, nv - 1));
#pragma unroll
  for (int k = 0; k < V; ++k)
    gv[k] = load_vec<false, TW, E>(gamma, min(j0 + k * T, nv - 1));
  if (!RMS && beta != nullptr) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      bv[k] = load_vec<false, TW, E>(beta, min(j0 + k * T, nv - 1));
  }

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (j0 + k * T < nv) {
      float t = RMS ? xv[k][0] * xv[k][0] : xv[k][0];
#pragma unroll
      for (int e = 1; e < E; ++e) t += RMS ? xv[k][e] * xv[k][e] : xv[k][e];
      s += t;
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
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float a = xv[k][e] - mean;
          t += a * a;
        }
        s2 += t;
      }
    }
    rstd = rsqrtf(row_sum<T, C>(s2, sums[RMS ? 0 : 1], rank) * inv_d + eps);
  }

#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = j0 + k * T;
    if (j < nv) {
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        o[e] = (xv[k][e] - mean) * rstd * gv[k][e];
        if (!RMS && beta != nullptr) o[e] += bv[k][e];
      }
      store_vec<TY, E>(yr, j, o);
    }
  }
}

template <class TX, class TW, class TY, int T, int V, bool RMS>
__global__ void __launch_bounds__(T)
fused_norm_regs_kernel(const TX* __restrict__ x, const TW* __restrict__ gamma,
                       const TW* __restrict__ beta, TY* __restrict__ y,
                       int nv, float inv_d, float eps) {
  norm_row<TX, TW, TY, T, V, RMS, 1>(x, gamma, beta, y, nv, inv_d, eps);
}

// The cluster size is the kernel's own (__cluster_dims__): a plain launch
// of n * C blocks makes n clusters.
template <class TX, class TW, class TY, int T, int V, bool RMS, int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(T)
fused_norm_cluster_kernel(const TX* __restrict__ x,
                          const TW* __restrict__ gamma,
                          const TW* __restrict__ beta, TY* __restrict__ y,
                          int nv, float inv_d, float eps) {
  norm_row<TX, TW, TY, T, V, RMS, C>(x, gamma, beta, y, nv, inv_d, eps);
}

template <class TX, class TW, class TY>
struct Args {
  const TX* x;
  const TW* gamma;
  const TW* beta;
  TY* y;
  int n, nv;
  float inv_d, eps;
  cudaStream_t st;
};

template <class TX, class TW, class TY, int T, int V, bool RMS, int C>
int launch(const Args<TX, TW, TY>& a) {
  if constexpr (C == 1)
    fused_norm_regs_kernel<TX, TW, TY, T, V, RMS><<<a.n, T, 0, a.st>>>(
        a.x, a.gamma, a.beta, a.y, a.nv, a.inv_d, a.eps);
  else
    fused_norm_cluster_kernel<TX, TW, TY, T, V, RMS, C>
        <<<a.n * C, T, 0, a.st>>>(a.x, a.gamma, a.beta, a.y, a.nv, a.inv_d,
                                  a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <class TX, class TW, class TY, int T, bool RMS, int C>
int launch_v(int vecs, const Args<TX, TW, TY>& a) {
  switch (vecs) {
    case 1: return launch<TX, TW, TY, T, 1, RMS, C>(a);
    case 2: return launch<TX, TW, TY, T, 2, RMS, C>(a);
    case 3: return launch<TX, TW, TY, T, 3, RMS, C>(a);
    case 4: return launch<TX, TW, TY, T, 4, RMS, C>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the blocks built: regs 64 to 512 threads, cluster 32 to 256, and at
// most 32 partials a sum
template <class TX, class TW, class TY, bool RMS, int C, int T>
int launch_t(int vecs, const Args<TX, TW, TY>& a) {
  constexpr int kParts = C * (T / 32);
  if constexpr ((C == 1 ? T >= 64 : T <= 256) && kParts <= 32)
    return launch_v<TX, TW, TY, T, RMS, C>(vecs, a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <class TX, class TW, class TY, bool RMS, int C>
int launch_tv(int threads, int vecs, const Args<TX, TW, TY>& a) {
  switch (threads) {
    case 32: return launch_t<TX, TW, TY, RMS, C, 32>(vecs, a);
    case 64: return launch_t<TX, TW, TY, RMS, C, 64>(vecs, a);
    case 128: return launch_t<TX, TW, TY, RMS, C, 128>(vecs, a);
    case 256: return launch_t<TX, TW, TY, RMS, C, 256>(vecs, a);
    case 512: return launch_t<TX, TW, TY, RMS, C, 512>(vecs, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class TX, class TW, class TY, bool RMS>
int launch_c(int cluster, int threads, int vecs, const Args<TX, TW, TY>& a) {
  switch (cluster) {
    case 1: return launch_tv<TX, TW, TY, RMS, 1>(threads, vecs, a);
    case 2: return launch_tv<TX, TW, TY, RMS, 2>(threads, vecs, a);
    case 4: return launch_tv<TX, TW, TY, RMS, 4>(threads, vecs, a);
    case 8: return launch_tv<TX, TW, TY, RMS, 8>(threads, vecs, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One call in the element types TX (x), TW (gamma, beta) and TY (y).
template <class TX, class TW, class TY>
int run(const void* xp, const void* gp, const void* bp, void* yp, int n,
        int d, float eps, int rms, int design, int threads, int vecs,
        int cluster, cudaStream_t st) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  const TX* x = static_cast<const TX*>(xp);
  const TW* gamma = static_cast<const TW*>(gp);
  const TW* beta = static_cast<const TW*>(bp);
  TY* y = static_cast<TY*>(yp);
  if (design == 0) {
    if (threads != kThreads || vecs != 0 || cluster != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    constexpr bool kF32 = sizeof(TX) == 4 && sizeof(TW) == 4 &&
                          sizeof(TY) == 4;
    const bool vec = kF32 && (d % 4 == 0) && mx_aligned16(x) &&
                     mx_aligned16(gamma) &&
                     (beta == nullptr || mx_aligned16(beta)) &&
                     mx_aligned16(y);
    if (vec)
      fused_norm_kernel<TX, TW, TY, kF32><<<n, kThreads, 0, st>>>(
          x, gamma, beta, y, d, eps, rms);
    else
      fused_norm_kernel<TX, TW, TY, false><<<n, kThreads, 0, st>>>(
          x, gamma, beta, y, d, eps, rms);
    return static_cast<int>(cudaGetLastError());
  }
  const long long nv = d / E;
  const long long slots = static_cast<long long>(threads) * vecs * cluster;
  if ((design == 1) != (cluster == 1) || (design != 1 && design != 2) ||
      cluster > kMaxCluster || d % E != 0 || !mx_aligned16(x) ||
      !mx_aligned16(gamma) || (beta != nullptr && !mx_aligned16(beta)) ||
      !mx_aligned16(y) || threads <= 0 || vecs <= 0 || slots < nv ||
      slots - threads >= nv || cluster * (threads / 32) > 32 ||
      static_cast<long long>(n) * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<TX, TW, TY> a{x,  gamma, beta, y, n, static_cast<int>(nv),
                           1.0f / static_cast<float>(d), eps, st};
  return rms ? launch_c<TX, TW, TY, true>(cluster, threads, vecs, a)
             : launch_c<TX, TW, TY, false>(cluster, threads, vecs, a);
}

}  // namespace

// x, y: (n, d) row-major; gamma, beta: (d,); beta may be null, and must be
// in RMS mode. x_type and w_type give the element types of x and of the
// weights (gamma and beta): 0 fp32, 1 bf16; y is bf16 when both are bf16
// and fp32 otherwise (the reference's promotion). The plan
// (ops/kernels/fused_norms.py plan): design 0 (general; threads 256, vecs
// 0, cluster 1), 1 (regs: cluster 1, threads 64 to 512) or 2 (cluster:
// cluster 2, 4 or 8, threads 32 to 256), each block `threads` threads of
// `vecs` (1 to 4) 16-byte vectors of x, E = 4 (fp32) or 8 (bf16) elements
// each. A plan that does not fit is refused: regs and cluster need d a
// multiple of E, every pointer 16-byte aligned, blocks that cover the row
// with no vector column of the row's last block left empty (threads * vecs
// * cluster >= d / E > threads * (vecs * cluster - 1)) and at most 32
// partials a sum. Returns the cudaError_t of the launch.
extern "C" int fused_norm_run(const void* x, const void* gamma,
                              const void* beta, void* y, int n, int d,
                              float eps, int rms, int x_type, int w_type,
                              int design, int threads, int vecs, int cluster,
                              void* stream) {
  if (n <= 0 || d <= 0 || (rms && beta != nullptr) || x_type < 0 ||
      x_type > 1 || w_type < 0 || w_type > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_type == 0 && w_type == 0)
    return run<float, float, float>(x, gamma, beta, y, n, d, eps, rms,
                                    design, threads, vecs, cluster, st);
  if (x_type == 1 && w_type == 0)
    return run<bf16, float, float>(x, gamma, beta, y, n, d, eps, rms, design,
                                   threads, vecs, cluster, st);
  if (x_type == 0 && w_type == 1)
    return run<float, bf16, float>(x, gamma, beta, y, n, d, eps, rms, design,
                                   threads, vecs, cluster, st);
  return run<bf16, bf16, bf16>(x, gamma, beta, y, n, d, eps, rms, design,
                               threads, vecs, cluster, st);
}
