// Flash-attention forward over fp32 or bf16 q, k, v, in two forms from one
// kernel body.
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
// bf16 (as the Pallas kernel takes it: operands widened to fp32 on load,
// q * sm_scale formed in fp32, the output of the normalised form stored in
// q's dtype; the stats form's acc, m and l stay fp32, as the reference's
// out_shape gives them): q, k and v are converted into the same fp32 tiles
// in shared memory as they are loaded, with plain 16-byte loads in place
// of cp.async (the load of tile j + 1 is issued before tile j computes, but
// the thread waits for it). A bf16 value is exact in TF32, so the low
// halves of k and v in the 3xTF32 split are zero, and their two products
// are left out: each product takes two TF32 products, hi*hi + lo*hi of q
// against k and of p against v, at the accuracy of three.
//
// Bound on the H100: operations. At T = S = 2048, d = 128 the 4*T*S*d
// products take far longer than reading q, k and v once (half as many
// under a causal mask). Each product here is three TF32 tensor-core
// products (below), so the kernel's ceiling is 495 / 3 = 165 TFLOP/s of
// fp32-accurate work, against 67 on the CUDA cores.
//
// Design: one block of 4 warps per (batch*head, 64 query rows), each warp
// 16 query rows; a loop inside the block walks key tiles of BK rows (32 at
// d 128, 64 below; the TPU kernel's fori_loop over key blocks), each staged
// in shared memory through a two-stage cp.async ring so that the next tile
// loads while this one computes. Q k^T and p v run on mma.sync m16n8k8
// tf32 in 3xTF32: each fp32 operand is split as hi = cvt.rna.tf32(a), lo =
// a - hi (read by the tensor cores as TF32, which rounds it toward zero),
// and the product is accumulated in fp32 as hi*lo + lo*hi + hi*hi
// (CUTLASS's OpMultiplyAddFastF32), which keeps about fp32's
// accuracy; one TF32 pass keeps about three digits, too few for the 1e-4
// the kernel is held to. q, pre-scaled as the reference does, stays in
// shared memory and is split as its fragments are read (its fragments at d
// 128 would not fit in registers beside the 64 accumulators a thread, and
// a second copy would halve the blocks an SM holds). The online softmax
// works on the accumulator fragments in registers: each row's max through
// quad shuffles every tile, its sum in each lane's share until the end. The
// MMA's k index is permuted within each 8 (k-index t4 is 2*t4, t4 + 4 is
// 2*t4 + 1), head dims in q k^T and keys in p v alike: q's and k's
// fragment pairs are then single 8-byte loads, and p's accumulator
// fragment is its A fragment as it stands. The tensor cores truncate as
// they accumulate, at the scale of the running sum: a score's small
// products sum apart from its big ones, and each tile's p v sums in fresh
// registers and is added to the output accumulators in fp32. Masked scores
// are -1e30 and p is 0 on masked lanes; rows past T and keys past S are
// masked, so T and S may be any length. Key tiles above the causal
// diagonal of the block are never loaded, the heaviest query blocks are
// launched first, and a warp whose rows all lie past T skips the products.
//
// Split-KV: where (batch*head) x (query blocks) would leave SMs idle (a
// short T against a long S), the wrapper's plan splits the keys. Each split
// writes its (acc, m, l) partial to a workspace; the last block of its
// (batch*head, query block) to arrive (atomicAdd on a counter after
// __threadfence) merges the partials in split order with the isfinite-
// guarded merge of parallel/ring_attention.py:_merge_stats, writes o, or
// (acc, m, l) for the stats form, and sets the counter back to 0. One
// launch a call.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;   // exp(x) = 2^(x log2 e)

template <int D>
struct Cfg {
  static constexpr int kBK = D == 128 ? 32 : 64;  // key rows per tile
  static constexpr int kQS = D + 8;    // row strides in floats, chosen so
  static constexpr int kKS = D + 8;    // that a warp's fragment loads hit
  static constexpr int kVS = D + 4;    // 32 distinct banks
  static constexpr int kStageFloats = kBK * (kKS + kVS);
  static constexpr size_t kSmem =
      sizeof(float) * (kBQ * kQS + 2 * kStageFloats);
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// a = hi + lo as two TF32 operands, CUTLASS's OpMultiplyAddFastF32 split:
// hi = cvt.rna.tf32(a), and lo = a - hi (exact in fp32) passed as it is,
// since the tensor cores read a TF32 operand's top 19 bits and drop the
// rest, which rounds lo toward zero.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// Not volatile: a pure function of its operands, which the compiler may
// interleave with independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The merge of two (m, l, acc) partials, ring_attention._merge_stats.
__device__ __forceinline__ void merge(float& m, float& l, float& o, float mb,
                                      float lb, float ob) {
  const float mn = fmaxf(m, mb);
  const float ms = isfinite(mn) ? mn : 0.f;
  const float a = isfinite(m) ? expf(m - ms) : 0.f;
  const float b = isfinite(mb) ? expf(mb - ms) : 0.f;
  l = a * l + b * lb;
  o = a * o + b * ob;
  m = mn;
}

// 16 bytes of global memory, 8 bf16, widened into two float4 of shared
// memory (zeros when !ok).
__device__ __forceinline__ void ld_bf16x8(float* dst, const void* src,
                                          bool ok) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (ok) w = __ldg(reinterpret_cast<const uint4*>(src));
  reinterpret_cast<float4*>(dst)[0] = make_float4(
      mx_bf16_lo(w.x), mx_bf16_hi(w.x), mx_bf16_lo(w.y), mx_bf16_hi(w.y));
  reinterpret_cast<float4*>(dst)[1] = make_float4(
      mx_bf16_lo(w.z), mx_bf16_hi(w.z), mx_bf16_lo(w.w), mx_bf16_hi(w.w));
}

// Two fp32 values of a row of o stored in its type: 8 bytes of fp32 or 4
// of bf16.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = mx_pack_bf16(a, b);
}

// Stats = false: o = acc / l. Stats = true: o = acc, m_out = m, l_out = l
// (both (bh, T)), and the causal mask is the diagonal block (q_offset 0).
// Grid: (bh * query blocks, splits); split s takes the key tiles s * chunk
// .. (s + 1) * chunk - 1. With splits > 1, ws holds each split's (acc, m,
// l) and counters one int a (bh, query block).
// TI: the element type of q, k, v (float or bf16); the normalised form
// stores o in TI, the stats form in fp32.
template <class TI, int D, bool Stats>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                 const TI* __restrict__ v,
                 std::conditional_t<Stats, float, TI>* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int bh,
                 int T, int S, float sm_scale, int causal, int splits,
                 int chunk, float* __restrict__ ws,
                 int* __restrict__ counters) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK;
  // bf16 k and v are exact in TF32: their low halves are zero
  constexpr bool kExactKV = sizeof(TI) == 2;
  extern __shared__ float4 smem4[];
  __shared__ int s_last;
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBQ * C::kQS;   // [2][BK * kKS (K), BK * kVS (V)]

  const int nq = (T + kBQ - 1) / kBQ;
  const int blk = blockIdx.x, split = blockIdx.y;
  const int qb = nq - 1 - blk / bh;  // the longest causal rows go first
  const int b = blk % bh;
  const int q0 = qb * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_offset = Stats ? 0 : S - T;

  const TI* qb_ = q + static_cast<size_t>(b) * T * D;
  const TI* kb = k + static_cast<size_t>(b) * S * D;
  const TI* vb = v + static_cast<size_t>(b) * S * D;

  // q tile, pre-scaled as the reference does (q * sm_scale in fp32, then
  // dot)
  if constexpr (kExactKV) {
    for (int i = tid; i < kBQ * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      float* dst = sQ + r * C::kQS + c;
      ld_bf16x8(dst, qb_ + static_cast<size_t>(q0 + r) * D + c, q0 + r < T);
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] *= sm_scale;
    }
  } else for (int i = tid; i < kBQ * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) {
      val = *reinterpret_cast<const float4*>(
          qb_ + static_cast<size_t>(q0 + r) * D + c);
      val.x *= sm_scale;
      val.y *= sm_scale;
      val.z *= sm_scale;
      val.w *= sm_scale;
    }
    *reinterpret_cast<float4*>(sQ + r * C::kQS + c) = val;
  }

  // this split's key tiles, cut at the causal diagonal of the block
  const int nt = (S + BK - 1) / BK;
  const int j0 = split * chunk;
  int j1 = min(nt, j0 + chunk);
  if (causal) {
    const int last_col = q_offset + min(q0 + kBQ, T) - 1;
    j1 = min(j1, last_col / BK + 1);
  }

  auto load_kv = [&](int j, int buf) {
    float* sK = sKV + buf * C::kStageFloats;
    float* sV = sK + BK * C::kKS;
    if constexpr (kExactKV) {   // widened on the way, no cp.async
      for (int i = tid; i < BK * D / 8; i += kThreads) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        const int key = j * BK + r;
        const bool ok = key < S;
        const size_t off = ok ? static_cast<size_t>(key) * D + c : 0;
        ld_bf16x8(sK + r * C::kKS + c, kb + off, ok);
        ld_bf16x8(sV + r * C::kVS + c, vb + off, ok);
      }
      cp_async_commit();
      return;
    }
    for (int i = tid; i < BK * D / 4; i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const int key = j * BK + r;
      const bool ok = key < S;
      const size_t off = ok ? static_cast<size_t>(key) * D + c : 0;
      cp_async16(sK + r * C::kKS + c, kb + off, ok);
      cp_async16(sV + r * C::kVS + c, vb + off, ok);
    }
    cp_async_commit();
  };

  // accumulators: oacc[n][e] is row g + 8*(e/2) of the warp's 16, head dim
  // 8n + 2*t4 + e%2; m and l for rows g and g + 8
  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {MX_NEG_INF, MX_NEG_INF}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16;
  const bool active = q0 + r0 < T;
  const float* qw = sQ + r0 * C::kQS;

  if (j0 < j1) load_kv(j0, 0);
  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < j1) {
      load_kv(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile j (and, the first time, q) is in place
    const float* sK = sKV + buf * C::kStageFloats;
    const float* sV = sK + BK * C::kKS;
    if (active) {   // a warp whose rows all lie past T has nothing to do
      // scores: s[n] is the 16 x 8 tile of keys j*BK + 8n .. . The big
      // products hi*hi sum in s and the small ones hi*lo + lo*hi in their
      // own registers, added once at the end: the tensor cores truncate as
      // they accumulate, at the scale of the running sum
      float s[BK / 8][4], small[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = small[n][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 8) {   // k-steps of 8 head dims
        // the MMA's k index t4 is head dim kk + 2*t4 and t4 + 4 is kk +
        // 2*t4 + 1, in q and k alike, so each pair is one 8-byte load
        uint32_t ah[4], al[4];
        const float2 q0v = *reinterpret_cast<const float2*>(
            qw + g * C::kQS + kk + 2 * t4);
        const float2 q8v = *reinterpret_cast<const float2*>(
            qw + (g + 8) * C::kQS + kk + 2 * t4);
        split_tf32(q0v.x, ah[0], al[0]);
        split_tf32(q8v.x, ah[1], al[1]);
        split_tf32(q0v.y, ah[2], al[2]);
        split_tf32(q8v.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < BK / 8; n += 4) {   // four key blocks in turn
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 kv = *reinterpret_cast<const float2*>(
                sK + ((n + i) * 8 + g) * C::kKS + kk + 2 * t4);
            split_tf32(kv.x, bh[i][0], bl[i][0]);
            split_tf32(kv.y, bh[i][1], bl[i][1]);
          }
          if constexpr (!kExactKV) {
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_tf32(small[n + i], ah, bl[i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(small[n + i], al, bh[i]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(s[n + i], ah, bh[i]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += small[n][e];

      // online softmax on the fragments, rows g (h = 0) and g + 8 (h = 1);
      // only a tile that crosses S or the warp's causal diagonal is masked
      const bool masked =
          (j + 1) * BK > S || (causal && (j + 1) * BK - 1 > q_offset + q0 + r0);
      if (masked) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * BK + n * 8 + 2 * t4 + (e & 1);
            const int row = q0 + r0 + g + 8 * (e >> 1);
            if (col >= S || (causal && q_offset + row < col))
              s[n][e] = MX_NEG_INF;
          }
      }
      float mx[2] = {MX_NEG_INF, MX_NEG_INF};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        mx[h] = fmaxf(m[h], mx[h]);      // the new running max
        alpha[h] = exp2f((m[h] - mx[h]) * kLog2e);
        m[h] = mx[h];
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // p is 0 on a masked lane, also where the row's max is still -1e30
          const float p = masked && s[n][e] == MX_NEG_INF
                              ? 0.f
                              : exp2f((s[n][e] - m[e >> 1]) * kLog2e);
          s[n][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = alpha[h] * l[h] + sum[h];   // this lane's share of the row
      }
      // the running max of most rows stays put after the first tiles
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e >> 1];
      }

      // oacc += p v. The MMA's k index t4 is key 2*t4 and t4 + 4 is key
      // 2*t4 + 1 of each 8, so p's C fragment is its A fragment as it
      // stands: (c0, c2, c1, c3). Each 16 x 8 block of the tile's p v is
      // summed in fresh registers and then added to oacc in fp32: the tensor
      // cores truncate as they accumulate, so oacc is never their running sum.
      uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
      for (int n2 = 0; n2 < BK / 8; ++n2) {
        split_tf32(s[n2][0], ph[n2][0], pl[n2][0]);
        split_tf32(s[n2][2], ph[n2][1], pl[n2][1]);
        split_tf32(s[n2][1], ph[n2][2], pl[n2][2]);
        split_tf32(s[n2][3], ph[n2][3], pl[n2][3]);
      }
      // head dims in groups of kNG blocks of 8, whose products go to the
      // tensor cores in turn so that consecutive MMAs do not wait on each other
      constexpr int kNG = 4;
      const float* vr = sV + 2 * t4 * C::kVS + g;
#pragma unroll
      for (int n0 = 0; n0 < D / 8; n0 += kNG) {
        float acc[kNG][4];
#pragma unroll
        for (int i = 0; i < kNG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
        for (int n2 = 0; n2 < BK / 8; ++n2) {
          uint32_t bh[kNG][2], bl[kNG][2];
#pragma unroll
          for (int i = 0; i < kNG; ++i) {
            split_tf32(vr[n2 * 8 * C::kVS + (n0 + i) * 8], bh[i][0], bl[i][0]);
            split_tf32(vr[(n2 * 8 + 1) * C::kVS + (n0 + i) * 8], bh[i][1],
                       bl[i][1]);
          }
          if constexpr (!kExactKV) {
#pragma unroll
            for (int i = 0; i < kNG; ++i) mma_tf32(acc[i], ph[n2], bl[i]);
          }
#pragma unroll
          for (int i = 0; i < kNG; ++i) mma_tf32(acc[i], pl[n2], bh[i]);
#pragma unroll
          for (int i = 0; i < kNG; ++i) mma_tf32(acc[i], ph[n2], bh[i]);
        }
#pragma unroll
        for (int i = 0; i < kNG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[n0 + i][e] += acc[i][e];
      }
    }
    __syncthreads();   // the buffer is refilled two tiles on
  }

  // each row's sum l, from the shares of the quad's four lanes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // rows of this thread: q0 + r0 + g + 8h
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + g + 8 * h;
      if (row >= T) continue;
      auto* orow = o + (static_cast<size_t>(b) * T + row) * D;
      const float lr = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float2 val = make_float2(oacc[n][2 * h], oacc[n][2 * h + 1]);
        if (!Stats) {
          val.x = val.x / lr;
          val.y = val.y / lr;
        }
        store2(orow + n * 8 + 2 * t4, val.x, val.y);
      }
      if (Stats && t4 == 0) {
        m_out[static_cast<size_t>(b) * T + row] = m[h];
        l_out[static_cast<size_t>(b) * T + row] = l[h];
      }
    }
    return;
  }

  // split-KV: this split's partial, then the last block merges
  const size_t part = static_cast<size_t>(kBQ) * (D + 2);
  float* mine = ws + (static_cast<size_t>(blk) * splits + split) * part;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      __stcg(reinterpret_cast<float2*>(mine + r * D + n * 8 + 2 * t4),
             make_float2(oacc[n][2 * h], oacc[n][2 * h + 1]));
    if (t4 == 0) {
      __stcg(mine + kBQ * D + r, m[h]);
      __stcg(mine + kBQ * D + kBQ + r, l[h]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[blk], 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* base = ws + static_cast<size_t>(blk) * splits * part;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    if (row >= T) continue;
    float mm = __ldcg(base + kBQ * D + r);
    float ll = __ldcg(base + kBQ * D + kBQ + r);
    float oo = __ldcg(base + i);
    for (int sp = 1; sp < splits; ++sp) {
      const float* pp = base + sp * part;
      merge(mm, ll, oo, __ldcg(pp + kBQ * D + r),
            __ldcg(pp + kBQ * D + kBQ + r), __ldcg(pp + i));
    }
    const size_t at = static_cast<size_t>(b) * T + row;
    if constexpr (Stats) {
      o[at * D + c] = oo;
      if (c == 0) {
        m_out[at] = mm;
        l_out[at] = ll;
      }
    } else {
      o[at * D + c] = mx_from_f32<TI>(oo / fmaxf(ll, 1e-30f));
    }
  }
  if (tid == 0) counters[blk] = 0;     // zero again for the next call
}

template <class TI, int D, bool Stats>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* l, int bh, int T, int S, float sm_scale, int causal,
           int block_k, int splits, int chunk, float* ws, int* counters,
           cudaStream_t st) {
  using TO = std::conditional_t<Stats, float, TI>;
  constexpr int bytes = static_cast<int>(Cfg<D>::kSmem);
  auto kernel = flash_fwd_kernel<TI, D, Stats>;
  static bool configured[kMxMaxDevices] = {};   // per device index
  const int rc = mx_smem_opt_in(kernel, bytes, configured);
  if (rc != 0) return rc;
  const long long blocks = static_cast<long long>(bh) * ((T + kBQ - 1) / kBQ);
  // the plan's key tile is this instantiation's, every split takes at
  // least one key tile and together they take each once
  const int nt = (S + Cfg<D>::kBK - 1) / Cfg<D>::kBK;
  if (blocks > 0x7fffffffLL || block_k != Cfg<D>::kBK || splits < 1 ||
      chunk < 1 || (splits - 1) * chunk >= nt || splits * chunk < nt ||
      splits > 65535 || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(static_cast<unsigned>(blocks), splits), kThreads, bytes,
           st>>>(static_cast<const TI*>(q), static_cast<const TI*>(k),
                 static_cast<const TI*>(v), static_cast<TO*>(o), m, l, bh, T,
                 S, sm_scale, causal, splits, chunk, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

template <class TI, bool Stats>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* m, float* l, int bh, int T, int S, int d, float sm_scale,
             int causal, int block_k, int splits, int chunk, float* ws,
             int* counters, void* stream) {
  if (bh <= 0 || T <= 0 || S <= 0 || !mx_aligned16(q) || !mx_aligned16(k) ||
      !mx_aligned16(v) || !mx_aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<TI, 32, Stats>(q, k, v, o, m, l, bh, T, S, sm_scale, causal,
                               block_k, splits, chunk, ws, counters, st);
    case 64:
      return launch<TI, 64, Stats>(q, k, v, o, m, l, bh, T, S, sm_scale, causal,
                               block_k, splits, chunk, ws, counters, st);
    case 128:
      return launch<TI, 128, Stats>(q, k, v, o, m, l, bh, T, S, sm_scale, causal,
                                block_k, splits, chunk, ws, counters, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: (bh, T, d); k, v: (bh, S, d); all contiguous, 16-byte aligned, of
// one type: fp32 (the _f32 entries) or bf16 (_bf16), o of q's type.
// d must be 32, 64 or 128. From the wrapper's plan: `block_k`, the key
// rows of a tile (32 at d 128, 64 below, checked), and `splits` of the
// ceil(S / block_k) key tiles, split s taking tiles s * chunk .. (s + 1) *
// chunk - 1 (the last one to the end of S); the entry refuses a chunk and
// split count that leave a split empty or a tile untaken. With splits > 1,
// ws holds bh * ceil(T / 64) * splits * 64 * (d + 2) floats and counters
// bh * ceil(T / 64) ints, zero (the kernel leaves them zero). Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, int bh, int T,
                                       int S, int d, float sm_scale,
                                       int causal, int block_k, int splits,
                                       int chunk, float* ws, int* counters,
                                       void* stream) {
  return dispatch<float, false>(q, k, v, o, nullptr, nullptr, bh, T, S, d,
                                sm_scale, causal, block_k, splits, chunk, ws,
                                counters, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, int bh,
                                        int T, int S, int d, float sm_scale,
                                        int causal, int block_k, int splits,
                                        int chunk, float* ws, int* counters,
                                        void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k, v, o, nullptr, nullptr, bh, T,
                                        S, d, sm_scale, causal, block_k,
                                        splits, chunk, ws, counters, stream);
}

// The stats form: acc (bh, T, d) unnormalised, m and l (bh, T), all fp32
// whatever q's type; causal is the diagonal block and needs T == S. Same
// layout rules as above.
extern "C" int flash_attention_stats_f32(const void* q, const void* k,
                                         const void* v, float* acc, float* m,
                                         float* l, int bh, int T, int S, int d,
                                         float sm_scale, int causal,
                                         int block_k, int splits, int chunk,
                                         float* ws, int* counters,
                                         void* stream) {
  if (m == nullptr || l == nullptr || (causal && T != S))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<float, true>(q, k, v, acc, m, l, bh, T, S, d, sm_scale,
                               causal, block_k, splits, chunk, ws, counters,
                               stream);
}

extern "C" int flash_attention_stats_bf16(const void* q, const void* k,
                                          const void* v, float* acc, float* m,
                                          float* l, int bh, int T, int S,
                                          int d, float sm_scale, int causal,
                                          int block_k, int splits, int chunk,
                                          float* ws, int* counters,
                                          void* stream) {
  if (m == nullptr || l == nullptr || (causal && T != S))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<__nv_bfloat16, true>(q, k, v, acc, m, l, bh, T, S, d,
                                       sm_scale, causal, block_k, splits,
                                       chunk, ws, counters, stream);
}
