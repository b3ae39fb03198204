// Paged attention decode over fp32 or bf16: one query token per row against
// a paged KV pool, read through the block table.
//
// Replaces mxnet_tpu/ops/pallas/paged_attention.py:_decode_kernel (launched
// by paged_attention_decode_pallas at :120): for row b and KV head h, the G
// query heads of the group attend to positions 0..offset[b] of the row's
// logical cache, where position p lives at pool[pages[b, p / psz], p % psz,
// h].
//
// q, the pools and out share one type, fp32 or bf16 (the reference's gate
// asks that the pool have q's dtype); a bf16 kernel keeps the fp32 one's
// logic with 2-byte elements: a thread copies the same 4 elements of a row
// (8 bytes with cp.async.ca in place of 16 with .cg), the tiles stay bf16
// in shared memory, and every value is widened to fp32 as it is read; the
// sums, the softmax and the merge are fp32, and out is rounded to bf16.
//
// Bound on the H100: bytes. Each live position's K and V head (2 * dh *
// sizeof(element) bytes) is read once for the G queries that share it: a
// decode step of llama3_8b (4 rows at depth 1024, 8 KV heads of 128) reads
// 33.6 MB in fp32, 0.0101 ms at 3.35 TB/s, and half that in bf16. A few operations per byte, far below what the card needs
// to be bound by operations; the products are fp32 FMAs on the CUDA cores
// (TF32 would change the answer).
//
// The earlier design of this kernel reached 23-29 % of that bound, for four
// reasons; what this one does about each:
// 1. A warp took one cache position at a time, and ran a shuffle sum and
//    two expf for each query head before its next load: about 1 KB in
//    flight a warp. Here a block copies whole tiles of kTile = 16 positions
//    (a page at the serving page size of 16) of K and V into shared memory
//    with cp.async, 16 bytes a thread, a step of two tiles ahead of the one
//    it computes; the page ids of the step after are read from the block
//    table meanwhile, one read a tile when the page size is a multiple of
//    16. Warp g of a group takes query head g: lanes 2p and 2p + 1 sum the
//    score of position p, so a tile's 16 * G scores come at once from
//    shared memory (one shuffle), and the online softmax moves once a tile
//    and head: base 2, the max taken (4 shuffles, one exp2) only when a
//    score passes it, then one exp2 a position. Every warp then adds p * v
//    for all G heads over its share of the positions, so each V row is
//    read from shared memory once for the group.
// 2. The splits followed the table width, so a row at depth 1024 in a
//    128-page table left half its splits empty. Here the split count comes
//    from the shapes alone (the Python plan, passed in as the cluster
//    size), and each split takes an even share of its row's live tiles,
//    read from offset[b] on the card: tiles floor(n * s / nsplit) up to
//    floor(n * (s + 1) / nsplit) of the row's n. One launch, captured once
//    in a CUDA graph, is right at any depth.
// 3. The splits were merged by a second kernel. Here the nsplit blocks of
//    one (row, KV head) are one thread-block cluster (at most 8, portable):
//    each block but rank 0 puts its (acc, m, l) into rank 0's shared memory
//    with st.async, counted on an mbarrier there, and leaves; rank 0 merges
//    them in split order and writes the output. One launch, no scratch, no
//    counters, and one cluster barrier, whose arrival is made at the start
//    (a cluster barrier is dear where a block waits on it).
// 4. The wrapper asked the library for the scratch size and allocated
//    scratch on every call. There is no scratch, and no query.
// On the H100 the block's own instructions, not the bytes, set the pace
// (8 warps of 128 registers each, two blocks an SM), and the plan keeps
// all blocks in one wave of clusters (PERF.md).
//
// Positions past offset[b] are never used (p = 0, as the reference zeroes
// masked lanes after the exp; the tile's rows past it are loaded but
// masked); l is clamped to 1e-30, so a row with no live position gives
// zeros, never NaN. Page ids out of range are clamped into the pool, as
// XLA clamps a gather index.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 16;       // positions of a tile
constexpr int kMaxGroups = 2;   // most tile groups a block
constexpr int kMaxSplits = 8;   // the largest portable cluster
constexpr float kLog2e = 1.4426950408889634f;

// A block of kGroups groups of G warps. A step of the block is kGroups
// tiles, group k taking the k-th; within a group warp g is query head g.
// Loads: thread t copies 16-byte chunk t % kCpr of the rows
//   t / kCpr + i * kRowStep of each tile of a step, of K and of V.
// Scores and softmax: lanes 2p and 2p + 1 of warp g sum the two halves
//   (alternate float4s) of q_g . k for position p of the group's tile.
// Values: lane l of warp g keeps acc[h][4c .. 4c + 3] for every head h of
//   the group over positions slot, slot + kSlots, ... of each tile,
//   c = l % kCpr, slot = g * kVRows + l / kCpr.
// EB is the bytes of an element (4 fp32, 2 bf16); the ring holds elements,
// the rest of shared memory floats.
template <int DH, int G, int EB>
struct Cfg {
  static constexpr int kGroups = (8 / G) < kMaxGroups ? (8 / G) : kMaxGroups;
  // steps in the shared-memory ring: two of two tiles, or three of one
  static constexpr int kStages = kGroups > 1 ? 2 : 3;
  static constexpr int kWarps = G * kGroups;
  static constexpr int kThreads = 32 * kWarps;
  // blocks an SM must hold (launch bounds): 128 registers a thread, but
  // at G = 8 (8 query heads' accumulators) one block an SM, no spills
  static constexpr int kMinBlocks = G == 8 ? 1 : 512 / kThreads;
  static constexpr int kCpr = DH / 4;                 // 4-element chunks a row
  static constexpr int kRowStep = kThreads / kCpr;
  static constexpr int kRpt = kGroups * kTile / kRowStep;  // rows a thread
  static constexpr int kNq = kCpr / 2;                // float4 of q a lane
  static constexpr int kVRows = 32 / kCpr;            // rows a warp spans
  static constexpr int kSlots = G * kVRows;
  static constexpr int kPps = kTile / kSlots;         // positions a slot
  // K rows padded by 8 elements: in fp32 the 4 rows a quarter-warp reads
  // fall in distinct banks
  static constexpr int kKS = DH + 8;
  static constexpr int kTileE = kTile * (kKS + DH);   // elements a tile
  static constexpr int kRing = kStages * kGroups * kTileE * EB / 4;  // floats
  // after the loop, over the ring: each warp's acc [warp][h][DH], each
  // group's (m, l) [kGroups][G], then the block's (acc, m, l), which the
  // cluster reads
  static constexpr int kGm = kWarps * G * DH;
  static constexpr int kRes = (kGm + 2 * kGroups * G + 3) / 4 * 4;
  static constexpr int kPart = (G * DH + 2 * G + 3) / 4 * 4;  // floats a split
  // the ring, or the merge area where that is larger (a bf16 ring)
  static constexpr int kP =
      (kRing > kRes + kPart ? kRing : kRes + kPart + 3) / 4 * 4;
  // after that: p [kGroups][kTile][G], alpha [kGroups][G], then the box
  // where the cluster's other splits put their (acc, m, l), and its
  // mbarrier
  static constexpr int kAlpha = kP + kGroups * kTile * G;
  static constexpr int kBox = (kAlpha + kGroups * G + 3) / 4 * 4;
  static constexpr int kBoxBar = kBox + (kMaxSplits - 1) * kPart;
  static constexpr int kSmemBytes = kBoxBar * 4 + 16;
  static_assert(kRowStep <= kTile && kRpt >= 1 && kPps >= 1 && kNq >= 1,
                "layout");
  static_assert(kRing % 4 == 0 && (kTileE * EB) % 16 == 0, "ring alignment");
  static_assert(kRes % 4 == 0 && kRes + kPart <= kP, "merge area");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// NB (16 or 8) bytes from global to shared memory, or zeros when !ok.
template <int NB>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         bool ok) {
  if constexpr (NB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
}

// Four consecutive elements at p (16-byte aligned in fp32, 8 in bf16), as
// fp32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(mx_bf16_lo(w.x), mx_bf16_hi(w.x), mx_bf16_lo(w.y),
                     mx_bf16_hi(w.y));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The shared-memory address of `p` in the cluster's block of rank 0.
__device__ __forceinline__ unsigned mapa_rank0(const void* p) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
               : "=r"(r)
               : "r"(smem_u32(p)));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
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

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 16 bytes into another block's shared memory (`dst`, `bar` from
// mapa_rank0), counted on the mbarrier there.
__device__ __forceinline__ void st_async(unsigned dst, float4 v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// G floats from shared memory (16-byte aligned when G is a multiple of 4).
template <int G>
__device__ __forceinline__ void load_g(const float* p, float (&v)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) v[i] = p[i];
  }
}

template <class T, int DH, int G>
__global__ void __launch_bounds__(Cfg<DH, G, sizeof(T)>::kThreads,
                                  Cfg<DH, G, sizeof(T)>::kMinBlocks)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ pages,
                    const int* __restrict__ offset, T* __restrict__ out,
                    int kv, int num_pages, int psz, int psz_shift, int np,
                    float sm_scale) {
  constexpr int EB = sizeof(T);
  using C = Cfg<DH, G, EB>;
  extern __shared__ __align__(16) float smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / nsplit;
  const int b = bh / kv, h = bh % kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / G, g = warp % G;
  // The other splits of the cluster put their (acc, m, l) into rank 0's
  // box at the end. Rank 0 readies the box's mbarrier for their bytes
  // before the cluster barrier, at which every block arrives here and
  // which a block waits on only before it puts.
  float* box = smem + C::kBox;
  uint64_t* box_bar = reinterpret_cast<uint64_t*>(smem + C::kBoxBar);
  if (nsplit > 1) {
    if (split == 0 && tid == 0) {
      mbar_init(box_bar);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_arrive_expect(box_bar, (nsplit - 1) * C::kPart * 4);
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }

  // the row's live positions [0, end) and this split's tiles [t0, t1)
  const int L = np * psz;
  const int off = offset[b];
  const int end = off < 0 ? 0 : (off >= L ? L : off + 1);
  const int n_live = (end + kTile - 1) / kTile;
  const int t0 = static_cast<int>(static_cast<long long>(n_live) * split / nsplit);
  const int t1 = static_cast<int>(static_cast<long long>(n_live) * (split + 1) / nsplit);
  const int steps = (t1 - t0 + C::kGroups - 1) / C::kGroups;

  // ---- loads: the pool rows of a step, read from the table a step ahead.
  // This thread's rows of tile k of a step are lrow + i * kRowStep; at a
  // page size that is a multiple of kTile a tile lies in one page, so one
  // table read serves them all
  constexpr int kRpk = kTile / C::kRowStep;            // rows a tile
  const int lcol = 4 * (tid % C::kCpr), lrow = tid / C::kCpr;
  const int* table = pages + static_cast<size_t>(b) * np;
  const long long rs = static_cast<long long>(kv) * DH;  // elements a row
  const T* kb = k_pool + h * DH + lcol;
  const T* vb = v_pool + h * DH + lcol;
  const unsigned sk0 = smem_u32(smem) + EB * (lrow * C::kKS + lcol);
  const unsigned sv0 =
      smem_u32(smem) + EB * (kTile * C::kKS + lrow * DH + lcol);
  const bool page_tiles = psz_shift >= 4;
  long long src[C::kRpt];   // each row's offset in the pools
  bool live[C::kGroups];    // the step's tiles that hold live positions
  auto fetch = [&](int j) {
#pragma unroll
    for (int k = 0; k < C::kGroups; ++k) {
      const int t = t0 + j * C::kGroups + k;
      live[k] = t < t1;
      if (page_tiles) {
        long long base = 0;
        if (live[k]) {
          const int pos = t * kTile;
          const int pid = min(max(table[pos >> psz_shift], 0), num_pages - 1);
          base = (static_cast<long long>(pid) * psz + (pos & (psz - 1)) + lrow) * rs;
        }
#pragma unroll
        for (int i = 0; i < kRpk; ++i)
          src[k * kRpk + i] = base + i * C::kRowStep * rs;
      } else {
#pragma unroll
        for (int i = 0; i < kRpk; ++i) {
          long long o = 0;
          if (live[k]) {  // rows past the table's end read its last page
            const int pos = t * kTile + lrow + i * C::kRowStep;
            const int pg = min(pos / psz, np - 1);
            const int pid = min(max(table[pg], 0), num_pages - 1);
            const int slot = min(pos - pg * psz, psz - 1);
            o = (static_cast<long long>(pid) * psz + slot) * rs;
          }
          src[k * kRpk + i] = o;
        }
      }
    }
  };
  auto issue = [&](int stage) {
    const unsigned sbase = stage * C::kGroups * C::kTileE * EB;
#pragma unroll
    for (int k = 0; k < C::kGroups; ++k) {
#pragma unroll
      for (int i = 0; i < kRpk; ++i) {
        const unsigned d = sbase + k * C::kTileE * EB;
        const long long o = src[k * kRpk + i];
        cp_async<4 * EB>(sk0 + d + i * C::kRowStep * C::kKS * EB, kb + o,
                         live[k]);
        cp_async<4 * EB>(sv0 + d + i * C::kRowStep * DH * EB, vb + o, live[k]);
      }
    }
  };

  // ---- scores: this lane's half of q_g, scaled to base 2
  const int spos = lane >> 1, sj = lane & 1;
  const float scale2 = sm_scale * kLog2e;
  float4 qr[C::kNq];
  const T* qh = q + (static_cast<size_t>(bh) * G + g) * DH;
#pragma unroll
  for (int i = 0; i < C::kNq; ++i) qr[i] = ld4(qh + 4 * (sj + 2 * i));
  float m = MX_NEG_INF, l = 0.f;  // head g's running max (base 2); lane sum

  // ---- values: this lane's dims and position slot, every head
  const int vc = 4 * (lane % C::kCpr);
  const int slot = g * C::kVRows + lane / C::kCpr;
  float4 acc[G];
#pragma unroll
  for (int i = 0; i < G; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* s_p = smem + C::kP + grp * kTile * G;
  float* s_alpha = smem + C::kAlpha + grp * G;

  fetch(0);
#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {
    if (st < steps) issue(st);
    cp_async_commit();
    fetch(st + 1);
  }

  int rd = 0, wr = C::kStages - 1;  // the stages step j reads and refills
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // step j landed; every thread is done with step j - 1
    if (j + C::kStages - 1 < steps) issue(wr);
    cp_async_commit();
    fetch(j + C::kStages);
    wr = wr == C::kStages - 1 ? 0 : wr + 1;

    const int t = t0 + j * C::kGroups + grp;   // this group's tile
    const T* sK =
        reinterpret_cast<const T*>(smem) + (rd * C::kGroups + grp) * C::kTileE;
    rd = rd == C::kStages - 1 ? 0 : rd + 1;
    const T* sV = sK + kTile * C::kKS;
    const int nvalid = t < t1 ? min(kTile, end - t * kTile) : 0;
    if (nvalid > 0) {
      const T* kr = sK + spos * C::kKS + 4 * sj;
      float4 d4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int f = 0; f < C::kNq; ++f) {
        const float4 kk = ld4(kr + 8 * f);
        d4.x = fmaf(qr[f].x, kk.x, d4.x);
        d4.y = fmaf(qr[f].y, kk.y, d4.y);
        d4.z = fmaf(qr[f].z, kk.z, d4.z);
        d4.w = fmaf(qr[f].w, kk.w, d4.w);
      }
      float dot = (d4.x + d4.y) + (d4.z + d4.w);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const float sc = dot * scale2;
      const bool valid = spos < nvalid;
      // the max moves only when a score passes it: then take the tile's
      // max and rescale, else alpha is 1
      float alpha = 1.f;
      if (__any_sync(0xffffffffu, valid && sc > m)) {
        float mt = valid ? sc : MX_NEG_INF;
#pragma unroll
        for (int o = 2; o < 32; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m, mt);
        alpha = exp2f(m - m_new);
        m = m_new;
      }
      const float p = valid ? exp2f(sc - m) : 0.f;
      l = fmaf(l, alpha, sj == 0 ? p : 0.f);
      if (sj == 0) s_p[spos * G + g] = p;
      if (lane == 0) s_alpha[g] = alpha;
    }
    __syncthreads();

    if (nvalid > 0) {
      float a[G];
      load_g<G>(s_alpha, a);
#pragma unroll
      for (int hg = 0; hg < G; ++hg) {
        if (a[hg] != 1.f) {
          acc[hg].x *= a[hg];
          acc[hg].y *= a[hg];
          acc[hg].z *= a[hg];
          acc[hg].w *= a[hg];
        }
      }
#pragma unroll
      for (int k = 0; k < C::kPps; ++k) {
        const int pos = slot + k * C::kSlots;
        if (pos < nvalid) {
          const float4 vv = ld4(sV + pos * DH + vc);
          float pp[G];
          load_g<G>(s_p + pos * G, pp);
#pragma unroll
          for (int hg = 0; hg < G; ++hg) {
            acc[hg].x = fmaf(pp[hg], vv.x, acc[hg].x);
            acc[hg].y = fmaf(pp[hg], vv.y, acc[hg].y);
            acc[hg].z = fmaf(pp[hg], vv.z, acc[hg].z);
            acc[hg].w = fmaf(pp[hg], vv.w, acc[hg].w);
          }
        }
      }
    }
  }

  // ---- the block's (m, l, acc): sum each warp's lanes and slots, then
  // merge the groups (each has its own max)
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
  for (int o = C::kCpr; o < 32; o <<= 1) {
#pragma unroll
    for (int hg = 0; hg < G; ++hg) {
      acc[hg].x += __shfl_xor_sync(0xffffffffu, acc[hg].x, o);
      acc[hg].y += __shfl_xor_sync(0xffffffffu, acc[hg].y, o);
      acc[hg].z += __shfl_xor_sync(0xffffffffu, acc[hg].z, o);
      acc[hg].w += __shfl_xor_sync(0xffffffffu, acc[hg].w, o);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* part = smem;                  // [warp][h][DH]
  float* gm = smem + C::kGm;           // [kGroups][G], then gl
  float* gl = gm + C::kGroups * G;
  float* res = smem + C::kRes;         // [h][DH], then m [G], l [G]
  float* res_m = res + G * DH;
  float* res_l = res_m + G;
  if (lane < C::kCpr) {
#pragma unroll
    for (int hg = 0; hg < G; ++hg)
      *reinterpret_cast<float4*>(part + (warp * G + hg) * DH + vc) = acc[hg];
  }
  if (lane == 0) {
    gm[grp * G + g] = m;
    gl[grp * G + g] = l;
  }
  __syncthreads();
  for (int e = tid; e < G * DH; e += C::kThreads) {
    const int hg = e / DH;
    float mm = MX_NEG_INF;
#pragma unroll
    for (int k = 0; k < C::kGroups; ++k) mm = fmaxf(mm, gm[k * G + hg]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int k = 0; k < C::kGroups; ++k) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < G; ++w) s += part[((k * G + w) * G) * DH + e];
      const float c = exp2f(gm[k * G + hg] - mm);
      a = fmaf(s, c, a);
      ll = fmaf(gl[k * G + hg], c, ll);
    }
    res[e] = a;
    if (e % DH == 0) {
      res_m[hg] = mm;
      res_l[hg] = ll;
    }
  }

  // ---- merge the cluster's splits, in split order: the others put their
  // (acc, m, l) into rank 0's box and leave; rank 0 waits for the bytes
  __syncthreads();
  if (nsplit > 1) {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (split > 0) {
      const unsigned dst = mapa_rank0(box + (split - 1) * C::kPart);
      const unsigned bar = mapa_rank0(box_bar);
      for (int f = tid; f < C::kPart / 4; f += C::kThreads)
        st_async(dst + 16 * f, *reinterpret_cast<const float4*>(res + 4 * f),
                 bar);
      return;
    }
    mbar_wait(box_bar, 0);
  }
  const size_t obase = static_cast<size_t>(bh) * G * DH;
  for (int e = tid; e < G * DH; e += C::kThreads) {
    const int hg = e / DH;
    float mm = res_m[hg];
    for (int r = 1; r < nsplit; ++r)
      mm = fmaxf(mm, box[(r - 1) * C::kPart + G * DH + hg]);
    float c = exp2f(res_m[hg] - mm);
    float ll = res_l[hg] * c, aa = res[e] * c;
    for (int r = 1; r < nsplit; ++r) {
      const float* bx = box + (r - 1) * C::kPart;
      c = exp2f(bx[G * DH + hg] - mm);
      ll = fmaf(bx[G * DH + G + hg], c, ll);
      aa = fmaf(bx[e], c, aa);
    }
    out[obase + e] = mx_from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <class T, int DH, int G>
int launch(const T* q, const T* k_pool, const T* v_pool, const int* pages,
           const int* offset, T* out, int b, int kv, int num_pages, int psz,
           int np, int nsplit, float sm_scale, cudaStream_t st) {
  using C = Cfg<DH, G, sizeof(T)>;
  auto kernel = paged_decode_kernel<T, DH, G>;
  static bool smem_done[kMxMaxDevices] = {};
  int e = mx_smem_opt_in(kernel, C::kSmemBytes, smem_done);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * kv * nsplit));
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(nsplit);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int shift = (psz & (psz - 1)) == 0 ? __builtin_ctz(psz) : -1;
  const cudaError_t ce = cudaLaunchKernelEx(&cfg, kernel, q, k_pool, v_pool,
                                            pages, offset, out, kv,
                                            num_pages, psz, shift, np,
                                            sm_scale);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int DH>
int launch_g(int g, const T* q, const T* k_pool, const T* v_pool,
             const int* pages, const int* offset, T* out, int b, int kv,
             int num_pages, int psz, int np, int nsplit, float sm_scale,
             cudaStream_t st) {
  switch (g) {
    case 1: return launch<T, DH, 1>(q, k_pool, v_pool, pages, offset, out, b, kv, num_pages, psz, np, nsplit, sm_scale, st);
    case 2: return launch<T, DH, 2>(q, k_pool, v_pool, pages, offset, out, b, kv, num_pages, psz, np, nsplit, sm_scale, st);
    case 4: return launch<T, DH, 4>(q, k_pool, v_pool, pages, offset, out, b, kv, num_pages, psz, np, nsplit, sm_scale, st);
    case 8: return launch<T, DH, 8>(q, k_pool, v_pool, pages, offset, out, b, kv, num_pages, psz, np, nsplit, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DH, int EB>
int smem_bytes(int g) {
  switch (g) {
    case 1: return Cfg<DH, 1, EB>::kSmemBytes;
    case 2: return Cfg<DH, 2, EB>::kSmemBytes;
    case 4: return Cfg<DH, 4, EB>::kSmemBytes;
    case 8: return Cfg<DH, 8, EB>::kSmemBytes;
    default: return -1;
  }
}

template <class T>
int run(const void* qp, const void* kp, const void* vp, const int* pages,
        const int* offset, void* op, int b, int kv, int g, int dh,
        int num_pages, int psz, int np, int nsplit, float sm_scale,
        void* stream) {
  const T* q = static_cast<const T*>(qp);
  const T* k_pool = static_cast<const T*>(kp);
  const T* v_pool = static_cast<const T*>(vp);
  T* out = static_cast<T*>(op);
  if (b <= 0 || kv <= 0 || num_pages <= 0 || psz <= 0 || np <= 0 ||
      nsplit < 1 || nsplit > kMaxSplits ||
      static_cast<long long>(b) * kv * nsplit > 0x7fffffffLL ||
      static_cast<long long>(np) * psz > 0x7fffffffLL - kTile ||
      !mx_aligned16(q) || !mx_aligned16(k_pool) || !mx_aligned16(v_pool) ||
      !mx_aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64: return launch_g<T, 64>(g, q, k_pool, v_pool, pages, offset, out, b, kv, num_pages, psz, np, nsplit, sm_scale, st);
    case 128: return launch_g<T, 128>(g, q, k_pool, v_pool, pages, offset, out, b, kv, num_pages, psz, np, nsplit, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The dynamic shared memory of one block at head dim dh and group g, for
// fp32 (bf16 0) or bf16 (bf16 1) data, in bytes; -1 for a pair the kernel
// is not built for.
extern "C" int paged_attention_smem_bytes(int dh, int g, int bf16) {
  if (bf16)
    return dh == 64 ? smem_bytes<64, 2>(g) : dh == 128 ? smem_bytes<128, 2>(g) : -1;
  return dh == 64 ? smem_bytes<64, 4>(g) : dh == 128 ? smem_bytes<128, 4>(g) : -1;
}

// q, out: (b, kv, g, dh); k_pool, v_pool: (num_pages, psz, kv, dh);
// pages: (b, np) int32; offset: (b,) int32. q, the pools and out fp32
// (the _f32 entry) or bf16 (_bf16), all contiguous, q, out and the pools
// 16-byte aligned. dh must be 64 or 128, g one of 1, 2, 4, 8, and nsplit
// (the plan's split count, the cluster size) 1..8. Returns the cudaError_t
// of the launch.
extern "C" int paged_attention_decode_f32(
    const void* q, const void* k_pool, const void* v_pool, const int* pages,
    const int* offset, void* out, int b, int kv, int g, int dh,
    int num_pages, int psz, int np, int nsplit, float sm_scale,
    void* stream) {
  return run<float>(q, k_pool, v_pool, pages, offset, out, b, kv, g, dh,
                    num_pages, psz, np, nsplit, sm_scale, stream);
}

extern "C" int paged_attention_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool, const int* pages,
    const int* offset, void* out, int b, int kv, int g, int dh,
    int num_pages, int psz, int np, int nsplit, float sm_scale,
    void* stream) {
  return run<__nv_bfloat16>(q, k_pool, v_pool, pages, offset, out, b, kv, g,
                            dh, num_pages, psz, np, nsplit, sm_scale, stream);
}
