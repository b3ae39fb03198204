// Paged attention decode, fp32: one query token per row against a paged KV
// pool, read through the block table.
//
// Replaces mxnet_tpu/ops/pallas/paged_attention.py:_decode_kernel (launched
// by paged_attention_decode_pallas): for row b and KV head h, the G query
// heads of the group attend to positions 0..offset[b] of the row's logical
// cache, where position p lives at pool[pages[b, p / psz], p % psz, h].
//
// Bound on the H100: bytes. Each live position's K and V head (2 * dh * 4
// bytes) is read once for the G queries that share it; a few operations per
// byte, far below what the card needs to be bound by operations.
//
// Design: the TPU kernel walks a row's pages in order on one core; here the
// pages of a row are cut into splits of kPagesPerSplit pages, and one block
// of 8 warps takes one (row, KV head, split), so a decode step of a few
// rows still puts hundreds of blocks on the 132 SMs. The block walks the
// block table itself (no gather into device memory): warp w takes pages w
// and w + 8 of its split. Within a page lane j holds head dims [j*dh/32,
// (j+1)*dh/32) of K and V with one vector load, the G query heads of the
// group all use that load (GQA), and a warp shuffle sums each score. Each
// warp keeps an online softmax per query head in fp32; positions past
// offset[b] are never visited, which is the same as the reference's p = 0
// on masked lanes. The warps' (max, sum, acc) are merged in shared memory;
// with one split the block writes the output, otherwise it writes its
// partial (max, sum, acc) to scratch and a second small kernel merges the
// splits. l is clamped to 1e-30, so a row with no live position gives
// zeros, never NaN. Page ids out of range are clamped into the pool, as
// XLA clamps a gather index.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kPagesPerSplit = 2 * kWarps;  // pages one block walks

template <int N>
struct Vec;
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  const typename Vec<N>::T t = *reinterpret_cast<const typename Vec<N>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = f[i];
}

template <int DH, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int* __restrict__ pages, const int* __restrict__ offset,
                    float* __restrict__ out, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int kv, int num_pages,
                    int psz, int np, float sm_scale) {
  constexpr int EPL = DH / 32;  // head dims per lane
  __shared__ float s_m[kWarps][G], s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][DH];

  const int bh = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = bh / kv, h = bh % kv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int off = offset[b];
  const int n_live = off < 0 ? 0 : min(np, off / psz + 1);
  const int p_end = min(n_live, (split + 1) * kPagesPerSplit);

  const size_t qbase = static_cast<size_t>(bh) * G * DH;
  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<EPL>(q + qbase + g * DH + lane * EPL, qr[g]);
    m[g] = MX_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int i = split * kPagesPerSplit + warp; i < p_end; i += kWarps) {
    const int pid = min(max(pages[static_cast<size_t>(b) * np + i], 0), num_pages - 1);
    const int nt = min(psz, off - i * psz + 1);  // live positions on this page
    const float* kp = k_pool + ((static_cast<size_t>(pid) * psz) * kv + h) * DH + lane * EPL;
    const float* vp = v_pool + ((static_cast<size_t>(pid) * psz) * kv + h) * DH + lane * EPL;
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      float kr[EPL], vr[EPL];
      load_vec<EPL>(kp + static_cast<size_t>(t) * kv * DH, kr);
      load_vec<EPL>(vp + static_cast<size_t>(t) * kv * DH, vr);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kr[e], part);
        const float sc = mx_warp_sum(part) * sm_scale;
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();

  const size_t pbase = (static_cast<size_t>(bh) * nsplit + split) * G;
  for (int idx = threadIdx.x; idx < G * DH; idx += kWarps * 32) {
    const int g = idx / DH, d = idx % DH;
    float mm = MX_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][g] - mm);
      ll = fmaf(s_l[w][g], c, ll);
      aa = fmaf(s_acc[w][g][d], c, aa);
    }
    if (nsplit == 1) {
      out[qbase + idx] = aa / fmaxf(ll, 1e-30f);
    } else {
      part_acc[(pbase + g) * DH + d] = aa;
      if (d == 0) {
        part_ml[(pbase + g) * 2] = mm;
        part_ml[(pbase + g) * 2 + 1] = ll;
      }
    }
  }
}

// Merge the splits of one (row, KV head): one thread per (query head, dim).
__global__ void paged_merge_kernel(const float* __restrict__ part_ml,
                                   const float* __restrict__ part_acc,
                                   float* __restrict__ out, int g_heads,
                                   int dh, int nsplit) {
  const int bh = blockIdx.x, idx = threadIdx.x;
  const int g = idx / dh, d = idx % dh;
  const size_t base = static_cast<size_t>(bh) * nsplit;
  float mm = MX_NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    mm = fmaxf(mm, part_ml[((base + s) * g_heads + g) * 2]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t r = (base + s) * g_heads + g;
    const float c = expf(part_ml[r * 2] - mm);
    ll = fmaf(part_ml[r * 2 + 1], c, ll);
    aa = fmaf(part_acc[r * dh + d], c, aa);
  }
  out[static_cast<size_t>(bh) * g_heads * dh + idx] = aa / fmaxf(ll, 1e-30f);
}

int splits(int np) { return (np + kPagesPerSplit - 1) / kPagesPerSplit; }

template <int DH, int G>
int launch(const float* q, const float* k_pool, const float* v_pool,
           const int* pages, const int* offset, float* out, float* scratch,
           int b, int kv, int num_pages, int psz, int np, float sm_scale,
           cudaStream_t st) {
  const int nsplit = splits(np);
  const size_t n_ml = static_cast<size_t>(b) * kv * nsplit * G * 2;
  float* part_ml = scratch;
  float* part_acc = scratch + n_ml;
  paged_decode_kernel<DH, G><<<dim3(b * kv, nsplit), kWarps * 32, 0, st>>>(
      q, k_pool, v_pool, pages, offset, out, part_ml, part_acc, kv,
      num_pages, psz, np, sm_scale);
  if (nsplit > 1)
    paged_merge_kernel<<<b * kv, G * DH, 0, st>>>(part_ml, part_acc, out, G,
                                                  DH, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_g(int g, const float* q, const float* k_pool, const float* v_pool,
             const int* pages, const int* offset, float* out, float* scratch,
             int b, int kv, int num_pages, int psz, int np, float sm_scale,
             cudaStream_t st) {
  switch (g) {
    case 1: return launch<DH, 1>(q, k_pool, v_pool, pages, offset, out, scratch, b, kv, num_pages, psz, np, sm_scale, st);
    case 2: return launch<DH, 2>(q, k_pool, v_pool, pages, offset, out, scratch, b, kv, num_pages, psz, np, sm_scale, st);
    case 4: return launch<DH, 4>(q, k_pool, v_pool, pages, offset, out, scratch, b, kv, num_pages, psz, np, sm_scale, st);
    case 8: return launch<DH, 8>(q, k_pool, v_pool, pages, offset, out, scratch, b, kv, num_pages, psz, np, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Floats of scratch the entry below needs: the partial (max, sum) and acc of
// every (row, KV head, split, query head).
extern "C" long long paged_attention_scratch_floats(int b, int kv, int g,
                                                    int dh, int np) {
  return static_cast<long long>(b) * kv * splits(np) * g * (dh + 2);
}

// q, out: (b, kv, g, dh); k_pool, v_pool: (num_pages, psz, kv, dh);
// pages: (b, np) int32; offset: (b,) int32; scratch: fp32, as many floats
// as paged_attention_scratch_floats gives. All contiguous, q and the pools
// 16-byte aligned. dh must be 64 or 128 and g one of 1, 2, 4, 8. Returns
// the cudaError_t of the launches.
extern "C" int paged_attention_decode_f32(
    const float* q, const float* k_pool, const float* v_pool, const int* pages,
    const int* offset, float* out, float* scratch, int b, int kv, int g,
    int dh, int num_pages, int psz, int np, float sm_scale, void* stream) {
  if (b <= 0 || kv <= 0 || num_pages <= 0 || psz <= 0 || np <= 0 ||
      splits(np) > 65535 || !mx_aligned16(q) || !mx_aligned16(k_pool) ||
      !mx_aligned16(v_pool) || !mx_aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64: return launch_g<64>(g, q, k_pool, v_pool, pages, offset, out, scratch, b, kv, num_pages, psz, np, sm_scale, st);
    case 128: return launch_g<128>(g, q, k_pool, v_pool, pages, offset, out, scratch, b, kv, num_pages, psz, np, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
