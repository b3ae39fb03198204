// Flash-attention forward, fp32, in two forms from one kernel body.
//
// Normalised form: replaces mxnet_tpu/ops/pallas/flash_attention.py:
// _flash_fwd_kernel as _flash_fwd launches it (o = softmax(q k^T *
// sm_scale) v, normalised, bottom-right causal with q_offset = S - T).
//
// Stats form (Stats = true): replaces the same Pallas body in its stats
// form (flash_attention.py:38 with m_ref/l_ref given, as
// flash_attention_stats :168 launches it), the ring-attention block. It
// writes acc = sum_j exp(s_j - m) v_j unnormalised, and each row's max m
// (in the units of the scaled scores, q pre-scaled as the reference does)
// and sum l = sum_j exp(s_j - m). Its causal mask is the diagonal block:
// q_offset = 0, T == S, key j kept for query i when i >= j.
//
// Bound on the H100: operations. In fp32 on the CUDA cores the card does
// 67 TFLOP/s, so at T = S = 2048, d = 128 the 4*T*S*d products take far
// longer than reading q, k and v once (half as many under a causal mask).
// The stats form writes two more floats a row and changes nothing else.
//
// Design: one block of 4 warps per (batch*head, 64 query rows); each warp
// owns 16 query rows. A loop inside the block walks key tiles of 32 rows
// (the TPU kernel's fori_loop over key blocks): the tile of K and V is
// staged in shared memory, lane j computes the scores of key j against the
// warp's 16 queries, the warp keeps each row's running max and sum (online
// softmax in fp32, p set to 0 on masked lanes after exp), writes p to
// shared memory and accumulates p v with lane j owning head dims j, j+32,
// ... . Key tiles above the causal diagonal of the block are never loaded.
// Rows past T and keys past S are masked, so T and S may be any length.
// The products are scalar FMAs: no tensor cores, so the sums are true fp32
// like the reference's. The stats form is this design unchanged: a simple
// kernel that is right; making either form fast is later work.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // key rows per tile
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * D + kBK * (D + 4) + kBK * D + kBQ * kBK);
}

// Stats = false: o = acc / l. Stats = true: o = acc, m_out = m, l_out = l
// (both (bh, T)), and the causal mask is the diagonal block (q_offset 0).
template <int D, bool Stats>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int T,
                 int S, float sm_scale, int causal) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int KP = D + 4;    // padded K row: lane j reads row j
  constexpr int PER = D / 32;  // head dims per lane in the accumulator
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * D;
  float* sV = sK + kBK * KP;
  float* sP = sV + kBK * D;

  const int nq = (T + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x % nq) * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_offset = Stats ? 0 : S - T;

  const float* qb = q + static_cast<size_t>(bh) * T * D;
  const float* kb = k + static_cast<size_t>(bh) * S * D;
  const float* vb = v + static_cast<size_t>(bh) * S * D;

  // q tile, pre-scaled as the reference does (q * sm_scale, then dot)
  for (int i = tid; i < kBQ * D / 4; i += kWarps * 32) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) {
      val = *reinterpret_cast<const float4*>(qb + static_cast<size_t>(q0 + r) * D + c);
      val.x *= sm_scale;
      val.y *= sm_scale;
      val.z *= sm_scale;
      val.w *= sm_scale;
    }
    *reinterpret_cast<float4*>(sQ + r * D + c) = val;
  }

  float acc[kRows][PER];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = MX_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[r][i] = 0.f;
  }

  int n_tiles = (S + kBK - 1) / kBK;
  if (causal) {
    const int last_col = q_offset + min(q0 + kBQ, T) - 1;
    n_tiles = min(n_tiles, last_col / kBK + 1);
  }

  const int row0 = q0 + warp * kRows;
  float* sPw = sP + warp * kRows * kBK;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < kBK * D / 4; i += kWarps * 32) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const float4*>(kb + static_cast<size_t>(k0 + r) * D + c);
        vv = *reinterpret_cast<const float4*>(vb + static_cast<size_t>(k0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(sK + r * KP + c) = kv;
      *reinterpret_cast<float4*>(sV + r * D + c) = vv;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = sK + lane * KP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(sQ + (warp * kRows + r) * D + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = col < S && (!causal || q_offset + row0 + r >= col);
      const float sv = ok ? s[r] : MX_NEG_INF;
      const float m_new = fmaxf(m[r], mx_warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + mx_warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[r][i] *= alpha;
      sPw[r * kBK + lane] = p;
    }
    __syncwarp();

    // acc += p v over the tile's keys
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float vv[4][PER];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < PER; ++i) vv[t][i] = sV[(kk + t) * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(sPw + r * kBK + kk);
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          float a = acc[r][i];
          a = fmaf(p4.x, vv[0][i], a);
          a = fmaf(p4.y, vv[1][i], a);
          a = fmaf(p4.z, vv[2][i], a);
          a = fmaf(p4.w, vv[3][i], a);
          acc[r][i] = a;
        }
      }
    }
    __syncwarp();  // sPw is rewritten by the next tile
  }

  float* ob = o + static_cast<size_t>(bh) * T * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row < T) {
      if constexpr (Stats) {
#pragma unroll
        for (int i = 0; i < PER; ++i)
          ob[static_cast<size_t>(row) * D + lane + 32 * i] = acc[r][i];
        if (lane == 0) {
          m_out[static_cast<size_t>(bh) * T + row] = m[r];
          l_out[static_cast<size_t>(bh) * T + row] = l[r];
        }
      } else {
        const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int i = 0; i < PER; ++i)
          ob[static_cast<size_t>(row) * D + lane + 32 * i] = acc[r][i] / lr;
      }
    }
  }
}

template <int D, bool Stats>
int launch(const float* q, const float* k, const float* v, float* o,
           float* m, float* l, int bh, int T, int S, float sm_scale,
           int causal, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D>();
  // above 48 KB of dynamic shared memory only when asked for; the setting
  // belongs to the current device, so it is made on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, Stats>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = static_cast<long long>(bh) * ((T + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<D, Stats>
      <<<static_cast<unsigned>(blocks), kWarps * 32, bytes, st>>>(
          q, k, v, o, m, l, T, S, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <bool Stats>
int dispatch(const float* q, const float* k, const float* v, float* o,
             float* m, float* l, int bh, int T, int S, int d, float sm_scale,
             int causal, void* stream) {
  if (bh <= 0 || T <= 0 || S <= 0 || !mx_aligned16(q) || !mx_aligned16(k) ||
      !mx_aligned16(v) || !mx_aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32, Stats>(q, k, v, o, m, l, bh, T, S, sm_scale, causal, st);
    case 64:
      return launch<64, Stats>(q, k, v, o, m, l, bh, T, S, sm_scale, causal, st);
    case 128:
      return launch<128, Stats>(q, k, v, o, m, l, bh, T, S, sm_scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (bh, T, d); k, v: (bh, S, d); all contiguous fp32, 16-byte aligned.
// d must be 32, 64 or 128. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, float* o, int bh,
                                       int T, int S, int d, float sm_scale,
                                       int causal, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, bh, T, S, d, sm_scale,
                         causal, stream);
}

// The stats form: acc (bh, T, d) unnormalised, m and l (bh, T); causal is
// the diagonal block and needs T == S. Same layout rules as above.
extern "C" int flash_attention_stats_f32(const float* q, const float* k,
                                         const float* v, float* acc, float* m,
                                         float* l, int bh, int T, int S, int d,
                                         float sm_scale, int causal,
                                         void* stream) {
  if (m == nullptr || l == nullptr || (causal && T != S))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, acc, m, l, bh, T, S, d, sm_scale, causal,
                        stream);
}
