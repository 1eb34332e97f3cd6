// Single-token decode attention over the dense per-slot KV cache or a paged
// KV pool, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused.py::flash_attention_pallas (kernel body
// _flash_kernel): GQA decode attention of one query token per batch row
// over a (B, S, KV, hd) cache, masked by the per-row fill kv_len[b], in
// three phases -- the global max of the scaled logits, then exp(s - max)
// and exp(s - max) * v materialized and summed with pure adds -- divided by
// max(l, 1e-30).
//
// The same kernel, with the PagedRows addressing policy, also replaces
// src/repro/kernels/paged.py::paged_attention_pallas (kernel body
// _paged_kernel): the K/V of position t of row b live at
// pool[ptab[b, t / ps], t % ps] of a (P, ps, KV, hd) pool.  Only the
// address of a position changes (DenseRows vs PagedRows), never the
// arithmetic or its order, so a paged call equals the dense kernel on the
// gathered view pool[ptab] to the bit.  The pool is read in its own dtype:
// the reference's wrapper casts the whole pool to float32 first, a copy
// this kernel never makes.
//
// What bounds it on the H100: the K and V bytes of the valid positions,
// each read once (2 * kv_len * KV * hd elements per row); the arithmetic
// is a few flops per byte.  So the design is about bytes in flight:
//
// * Parallelism.  Each (row, KV head) is a thread-block cluster of up to 8
//   CTAs (the portable size), picked from the capacity (S or NP * ps).  The
//   valid positions are cut into chunks of kChunk; each CTA takes a
//   contiguous run of chunks.  One CTA carries the head's g = H / KV query
//   heads, so K and V are fetched once for the whole group.
// * Latency.  K and V rows stream through a ring of shared-memory stages
//   (3, or 6 where a CTA's span reaches kLongSpan positions), issued
//   ns - 1 stages ahead, one barrier a stage.  One thread issues a stage: a
//   tensor copy (TMA) of every run of consecutive rows (a dense stage, a
//   page; kBoxRows rows where the capacity is one chunk) and a bulk copy
//   for each other row, all landing on the slot's mbarrier, so no thread
//   spends issue slots on addresses.  The flattened stage sequence is the
//   CTA's K stages then its V stages, so the first V stages are in flight
//   while the CTA still reduces its logits and waits on the cluster's max.
//   A CTA loads its span's block table entries into shared memory once,
//   before its first copy, so no copy waits on a table load (past kTabMax
//   entries it reads the table in global memory), and a position's page is
//   a multiply and a shift (FastDiv), not a division.  The V pass loads 8
//   positions' p and v before it sums them, and the logits interleave two
//   positions a lane group, so no load's latency sits on the sums' chain.
// * Traffic.  K is read once: each valid position's logits are computed
//   once and kept (shared memory, or past kWorkSmemMax a scratch the
//   wrapper allocates, written before it is read).  The CTA's max, then
//   the cluster's through distributed shared memory (a max is exact, so
//   its order does not matter); then p = exp(s - m) against the global
//   max, materialized in place; then V is read once.  Each chunk's partial
//   goes to the scratch; after one more cluster barrier rank 0 folds them
//   and the other CTAs are done.
//
// Order.  Every sum's association is a function of kv_len[b] and the
// compile-time constants alone -- never of the capacity, the page size or
// table, the batch or the cluster size:
// * a logit is, in each lane, two FMA chains over the halves of kEpl
//   consecutive elements of hd (16 for g <= 2, else 8) and their sum, then
//   a fixed xor butterfly over the ceil(hd / kEpl) lanes (a power of two)
//   that hold one position;
// * each chunk's l = sum p and sum p * v are taken over its positions in
//   ascending order, a rounded multiply and a rounded add each;
// * rank 0 folds the chunk partials in ascending chunk order with pure
//   adds, then divides.
// This keeps the reference's max / materialize / pure-add-fold arrangement,
// which FMA contraction cannot change.  Partials are never rescaled by
// exp(m_chunk - m).
//
// Masked positions.  Positions at or beyond kv_len[b] are never read, and
// a page id outside [0, P) is clamped, so no table can make the kernel read
// outside the pool.  A row with kv_len[b] <= 0 is not masked to zero: in
// the plain version (and the reference) every logit of such a row is the
// mask value, so exp(s - max) is 1 at every position of the capacity and
// the result is the mean of v over it (the dense capacity padded to the
// plain version's 8-position blocks, whose zero pad counts in the
// denominator).  The kernel gives the same: it reads V at every position
// of the capacity (through the table, the sink page included) and divides
// by that count.
//
// K and V may be float32 or bfloat16 (the cache's dtype); they are widened
// to float32 in registers, as the reference widens them.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;           // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;           // CTAs an SM the registers leave room for (g <= 2)
constexpr int kChunk = 256;             // positions per ordered chunk sum
constexpr int kStagesShort = 3;         // ring stages for spans under kLongSpan
constexpr int kStagesLong = 6;          // ... and for longer ones
constexpr int kLongSpan = 2048;         // positions a CTA may take
constexpr int kStageBytes = 8192;       // bytes of K or V a stage holds
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kTabMax = 1024;           // table entries kept in shared memory
constexpr int kWorkSmemMax = 64 * 1024; // logits kept in shared memory
constexpr int kSmemAttr = 160 * 1024;   // the dynamic shared memory ceiling
constexpr int kBoxRows = 8;             // rows a tensor copy moves, short capacities
constexpr int kBarBytes = 64;           // the ring's mbarriers (<= 8 stages)
constexpr int kMaxDevices = 64;
constexpr int kFlashBlock = 8;          // the plain version's dense page length
constexpr int kVd = 2;                  // consecutive elements of hd a thread sums (hd <= 256)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// n / d for 0 <= n < 2^31 by a multiply and a shift, d fixed per launch
// (the "round-up" method: l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1)
struct FastDiv {
  uint32_t m;
  int l;
  __device__ __forceinline__ int operator()(int n) const {
    const uint32_t hi = __umulhi((uint32_t)n, m);
    return (int)(((uint64_t)hi + (uint32_t)n) >> l);
  }
};

inline FastDiv fast_div(int d) {
  if (d < 1) d = 1;
  int l = 0;
  while ((1 << l) < d) ++l;
  const uint64_t m = (((uint64_t)1 << 32) * ((1u << l) - (uint32_t)d)) / d + 1;
  return FastDiv{(uint32_t)m, l};
}

// One bulk copy of `bytes` (a multiple of 16) from global to this CTA's
// shared memory, counted on the stage's mbarrier when it lands.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One tensor copy (TMA) of the box at (0, head, row) of a (rows, KV, hd)
// tensor map -- box_rows consecutive rows of one head -- into shared
// memory (128-byte aligned), counted on the stage's mbarrier.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         int head, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
         "r"(head), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Elements e0 .. e0 + 7 of a shared-memory row (zero past hd); the row is
// 16-byte aligned and e0 a multiple of 8.
__device__ __forceinline__ void load8(const float* row, int e0, int hd,
                                      float* x) {
  if (e0 + 8 <= hd) {
    const float4 a = *reinterpret_cast<const float4*>(row + e0);
    const float4 c = *reinterpret_cast<const float4*>(row + e0 + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = e0 + e < hd ? row[e0 + e] : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int e0,
                                      int hd, float* x) {
  if (e0 + 8 <= hd) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + e0);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = e0 + e < hd ? __bfloat162float(row[e0 + e]) : 0.f;
  }
}

// Elements d and d + 1 of a shared-memory row (zero past hd); d is even.
__device__ __forceinline__ void load2(const float* row, int d, int hd,
                                      float (&x)[2]) {
  if (d + 1 < hd) {
    const float2 a = *reinterpret_cast<const float2*>(row + d);
    x[0] = a.x;
    x[1] = a.y;
  } else {
    x[0] = row[d];
    x[1] = 0.f;
  }
}

__device__ __forceinline__ void load2(const __nv_bfloat16* row, int d, int hd,
                                      float (&x)[2]) {
  if (d + 1 < hd) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + d));
    x[0] = a.x;
    x[1] = a.y;
  } else {
    x[0] = __bfloat162float(row[d]);
    x[1] = 0.f;
  }
}

// Where position t of batch row b lives: the index of its (KV, hd) row in
// the K/V array.  capacity() is the positions a row can hold; empty_count()
// the positions the plain version averages over for a row with no fill.
struct DenseRows {               // k, v: (B, S, KV, hd)
  int S;
  static constexpr bool kPaged = false;
  __host__ __device__ int capacity() const { return S; }
  __host__ __device__ int page_size() const { return 0; }
  uint64_t rows_total(int B) const { return (uint64_t)B * S; }
  __device__ int empty_count() const {
    return (S + kFlashBlock - 1) / kFlashBlock * kFlashBlock;
  }
};

struct PagedRows {               // k, v: (P, ps, KV, hd) pool
  const int* ptab;               // (B, NP) block table
  int NP, ps, P;
  FastDiv by_ps;                 // t / ps
  static constexpr bool kPaged = true;
  __host__ __device__ int capacity() const { return NP * ps; }
  __host__ __device__ int page_size() const { return ps; }
  uint64_t rows_total(int) const { return (uint64_t)P * ps; }
  __device__ int empty_count() const { return NP * ps; }
};

// The launch's shape, a function of the capacity (never of kv_len): the
// cluster size, the ring's stage, and where each CTA keeps its logits and
// table entries.  The chunk partials of a (row, head) always go to the
// scratch the wrapper allocates, where rank 0 folds them.
struct Geom {
  int C;            // CTAs per (row, KV head)
  int ns;           // stages in the ring
  int sp;           // positions per ring stage (a power of two <= 64)
  int rb;           // bytes of one position's K (or V) row of a head
  int rbs;          // its stride in shared memory (16-byte aligned)
  int nch_cap;      // most chunks one CTA takes
  int tab_cap;      // table entries in shared memory (0: read in global)
  int lg_floats;    // one CTA's logits, (nch_cap * kChunk, G)
  int lg_in_smem;   // kept in shared memory (else in the scratch)
  int pt_floats;    // the chunk partials of one (row, head), in the scratch
  size_t smem;      // dynamic shared memory bytes
  size_t scratch;   // global scratch bytes: partials, then spilled logits
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// floats of one chunk partial: sum p * v (G, hd), then l (G), padded so
// the regions of the scratch stay 16-byte aligned
__host__ __device__ inline int part_floats(int G, int hd) {
  return round_up(G * hd + G, 4);
}

inline int group_of(int g) {     // the compile-time group: a power of two
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
}

inline Geom geometry(int B, int KV, int cap, int g, int hd, int elem,
                     int ps) {
  Geom gm = {};
  const int G = group_of(g);
  const int n_ch = cap > 0 ? (cap + kChunk - 1) / kChunk : 1;
  gm.C = n_ch < kMaxCluster ? n_ch : kMaxCluster;
  gm.nch_cap = (n_ch + gm.C - 1) / gm.C;
  gm.rb = hd * elem;
  gm.rbs = round_up(gm.rb, 16);
  int sp = 64;
  while (sp > 8 && sp * gm.rbs > kStageBytes) sp >>= 1;
  gm.sp = sp;
  const int span_cap = gm.nch_cap * kChunk;
  // a short span wants every CTA resident at once; a long one, more bytes
  // in flight per CTA
  gm.ns = span_cap >= kLongSpan ? kStagesLong : kStagesShort;
  gm.tab_cap = ps > 0 ? (span_cap - 1) / ps + 2 : 0;
  if (gm.tab_cap > kTabMax) gm.tab_cap = 0;
  gm.lg_floats = span_cap * G;
  gm.pt_floats = gm.C * gm.nch_cap * part_floats(G, hd);
  const size_t base = kBarBytes + 128 + (size_t)gm.ns * sp * gm.rbs +
                      round_up(gm.tab_cap * 4, 16) +
                      sizeof(float) * round_up((kWarps + 2) * G, 4);
  gm.lg_in_smem = (size_t)gm.lg_floats * 4 <= (size_t)kWorkSmemMax &&
                  base + (size_t)gm.lg_floats * 4 <= (size_t)kSmemAttr;
  gm.smem = base + (gm.lg_in_smem ? (size_t)gm.lg_floats * 4 : 0);
  gm.scratch = sizeof(float) * (size_t)B * KV *
               (gm.pt_floats + (gm.lg_in_smem ? 0 : (size_t)gm.C * gm.lg_floats));
  return gm;
}

template <typename T, int G, typename Rows>
__global__ void __launch_bounds__(kThreads, G <= 2 ? kMinBlocks : 1)
decode_attn_kernel(const float* __restrict__ q,     // (B, H, hd)
                   const T* __restrict__ k,         // rows of (KV, hd)
                   const T* __restrict__ v,         // rows of (KV, hd)
                   const int* __restrict__ kv_len,  // (B,)
                   float* __restrict__ out,         // (B, H, hd)
                   float* __restrict__ scratch,     // partials, spilled logits
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   Rows rows, Geom gm, int H, int KV, int hd, float scale,
                   int vec, int box_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = gm.C;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int g = H / KV;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ns = gm.ns, sp = gm.sp, rb = gm.rb, rbs = gm.rbs;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // one a ring slot
  const uint32_t sbase = smem_addr(smem);
  unsigned char* ring =                                  // 128-byte aligned
      smem + (((sbase + kBarBytes + 127) & ~127u) - sbase);
  int* tab_s = reinterpret_cast<int*>(ring + (size_t)ns * sp * rbs);
  float* wmax = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(tab_s) + round_up(gm.tab_cap * 4, 16));
  float* cmax = wmax + kWarps * G;     // this CTA's max per query head
  float* gmax = cmax + G;              // the cluster's
  const size_t head = (size_t)b * KV + kh;   // this (row, head)
  float* parts = scratch + head * gm.pt_floats;  // (chunks, pf)
  float* lg = gm.lg_in_smem                      // logits, then p, (positions, G)
      ? wmax + round_up((kWarps + 2) * G, 4)
      : scratch + (size_t)gridDim.z * KV * gm.pt_floats +
            (head * C + rank) * gm.lg_floats;
  const int pf = part_floats(G, hd);

  // this CTA's run of chunks, and its positions [t_lo, t_hi)
  const int cap = rows.capacity();
  const int fill = kv_len[b];
  const bool empty = fill <= 0;
  const int len = empty ? cap : min(fill, cap);
  const int n_ch = (len + kChunk - 1) / kChunk;
  const int per = n_ch / C, rem = n_ch % C;
  const int c_lo = rank * per + min(rank, rem);
  const int n_mine = per + (rank < rem ? 1 : 0);
  const int t_lo = c_lo * kChunk;
  const int t_hi = min((c_lo + n_mine) * kChunk, len);
  const int n_st = t_hi > t_lo ? (t_hi - t_lo + sp - 1) / sp : 0;
  const int nK = empty ? 0 : n_st;     // an empty row reads no K
  const int total = nK + n_st;
  // a barrier across the cluster (one CTA: across the CTA)
  auto cluster_sync = [&]() {
    if (C > 1) cluster.sync(); else __syncthreads();
  };

  // the span's table entries, clamped into the pool
  int page0 = 0;
  const int* tab_g = nullptr;
  if constexpr (Rows::kPaged) {
    page0 = t_lo / rows.ps;
    tab_g = rows.ptab + (size_t)b * rows.NP;
    if (gm.tab_cap > 0 && t_hi > t_lo) {
      const int n_tab = (t_hi - 1) / rows.ps - page0 + 1;
      for (int i = tid; i < n_tab; i += kThreads)
        tab_s[i] = min(max(tab_g[page0 + i], 0), rows.P - 1);
    }
  }
  auto row_of = [&](int t) -> size_t {
    if constexpr (Rows::kPaged) {
      const int pi = rows.by_ps(t);
      const int page = gm.tab_cap > 0
          ? tab_s[pi - page0] : min(max(tab_g[pi], 0), rows.P - 1);
      return (size_t)page * rows.ps + (t - pi * rows.ps);
    } else {
      return (size_t)b * rows.S + t;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < ns; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // copy flattened stage j (K stages, then V stages) into its ring slot.
  // Thread 0 issues one tensor copy (TMA) for every box_rows rows that are
  // consecutive in memory (in a dense stage, in a page) and one bulk copy
  // for each other row; all land on the slot's mbarrier.  Rows not 16-byte
  // aligned are copied by every thread with plain loads.
  auto issue = [&](int j, int slot) {
    if (j >= total) return;
    const bool is_k = j < nK;
    const int t0 = t_lo + (is_k ? j : j - nK) * sp;
    const int n_rows = min(sp, t_hi - t0);
    unsigned char* dst = ring + (size_t)slot * sp * rbs;
    const T* src = is_k ? k : v;
    if (vec) {
      if (tid != 0) return;
      uint64_t* bar = &bars[slot];
      mbar_expect(bar, (uint32_t)(n_rows * rb));
      for (int r = 0; r < n_rows;) {
        const int t = t0 + r;
        int run = n_rows - r;          // rows consecutive in memory from t
        if constexpr (Rows::kPaged)
          run = min(run, rows.ps - (t - rows.by_ps(t) * rows.ps));
        unsigned char* d = dst + r * rbs;
        const size_t row = row_of(t);
        if (run >= box_rows && (smem_addr(d) & 127u) == 0) {
          tma_rows(d, is_k ? &map_k : &map_v, kh, (int)row, bar);
          r += box_rows;
        } else {
          bulk_copy(d, src + (row * KV + kh) * hd, (uint32_t)rb, bar);
          r += 1;
        }
      }
    } else {
      for (int i = tid; i < n_rows * hd; i += kThreads) {
        const int r = i / hd, e = i - r * hd;
        reinterpret_cast<T*>(dst + r * rbs)[e] =
            src[(row_of(t0 + r) * KV + kh) * hd + e];
      }
    }
  };

  float mx[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) mx[gi] = kNegInf;

  // the cluster's max per query head, then p = exp(s - max) in place
  auto max_phase = [&]() {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx[gi] = fmaxf(mx[gi], __shfl_xor_sync(0xffffffffu, mx[gi], off));
    if (lane == 0)
#pragma unroll
      for (int gi = 0; gi < G; ++gi) wmax[warp * G + gi] = mx[gi];
    __syncthreads();
    if (tid < G) {
      float m = kNegInf;
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wmax[w * G + tid]);
      cmax[tid] = m;
    }
    cluster_sync();                    // every CTA's max
    if (tid < G) {
      float m = kNegInf;
      for (int r = 0; r < C; ++r)
        m = fmaxf(m, cluster.map_shared_rank(cmax, r)[tid]);
      gmax[tid] = m;
    }
    __syncthreads();
    const int n = (t_hi > t_lo ? t_hi - t_lo : 0) * G;
    for (int i = tid; i < n; i += kThreads)
      lg[i] = empty ? 1.f : expf(__fsub_rn(lg[i], gmax[i & (G - 1)]));
    __syncthreads();
  };

  float acc[G][kVd], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    l[gi] = 0.f;
#pragma unroll
    for (int nd = 0; nd < kVd; ++nd) acc[gi][nd] = 0.f;
  }

  for (int j = 0; j < ns - 1; ++j) issue(j, j);

  // the scaled query elements this lane multiplies: kEpl consecutive of
  // hd, for each head of the group (lp lanes hold one position)
  constexpr int kEpl = G <= 2 ? 16 : 8;
  int lp = 1;
  while (lp * kEpl < hd) lp <<= 1;
  const int gl = tid & (lp - 1), grp = tid / lp, per_step = kThreads / lp;
  float qr[G][kEpl];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      const int d = gl * kEpl + e;
      qr[gi][e] = gi < g && d < hd
          ? __fmul_rn(q[((size_t)b * H + kh * g + gi) * hd + d], scale) : 0.f;
    }

  bool maxed = false;
  int cs = 0, phase = 0;               // stage j's ring slot, its parity
  for (int j = 0; j < total; ++j) {
    if (vec) mbar_wait(&bars[cs], phase);   // stage j is in; and stage
    __syncthreads();                        // j - 1's slot is free again
    issue(j + ns - 1, cs == 0 ? ns - 1 : cs - 1);
    if (j == nK) {
      max_phase();
      maxed = true;
    }
    const unsigned char* slot = ring + (size_t)cs * sp * rbs;
    if (++cs == ns) {                  // the next stage's slot and parity
      cs = 0;
      phase ^= 1;
    }
    if (j < nK) {
      // logits of this stage's positions, lp lanes a position, two
      // positions a lane group at once (independent chains)
      const int t0 = t_lo + j * sp;
      const int n_rows = min(sp, t_hi - t0);
      for (int r0 = 0; r0 < sp; r0 += 2 * per_step) {
        float kx[2][kEpl];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + h * per_step + grp;
          if (r < n_rows) {
#pragma unroll
            for (int e = 0; e < kEpl; e += 8)
              load8(reinterpret_cast<const T*>(slot + r * rbs),
                    gl * kEpl + e, hd, kx[h] + e);
          } else {
#pragma unroll
            for (int e = 0; e < kEpl; ++e) kx[h][e] = 0.f;
          }
        }
        float s[2][G];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            // the lane's elements as two FMA chains, then their sum
            float lo = 0.f, hi = 0.f;
#pragma unroll
            for (int e = 0; e < kEpl / 2; ++e) {
              lo = __fmaf_rn(qr[gi][e], kx[h][e], lo);
              hi = __fmaf_rn(qr[gi][kEpl / 2 + e], kx[h][kEpl / 2 + e], hi);
            }
            s[h][gi] = __fadd_rn(lo, hi);
          }
        for (int off = lp >> 1; off > 0; off >>= 1)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
              s[h][gi] = __fadd_rn(s[h][gi],
                                   __shfl_xor_sync(0xffffffffu, s[h][gi], off));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + h * per_step + grp;
          if (r < n_rows) {
            const int lt = t0 - t_lo + r;
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
              if (gl == 0) lg[lt * G + gi] = s[h][gi];
              mx[gi] = fmaxf(mx[gi], s[h][gi]);
            }
          }
        }
      }
    } else {
      // p * v of this stage's positions in ascending order: the thread's
      // two elements of hd, 8 positions a step with every load issued
      // first, then the rest one at a time; a chunk's partial is written
      // when its last position is in
      const int t0 = t_lo + (j - nK) * sp;
      const int n_rows = min(sp, t_hi - t0);
      const T* vs = reinterpret_cast<const T*>(slot);
      const int rs = rbs / (int)sizeof(T);
      const float* pl = lg + (t0 - t_lo) * G;
      if (2 * tid < hd) {
        int r = 0;
        for (; r + 8 <= n_rows; r += 8) {
          float p[8][G], x[8][kVd];
#pragma unroll
          for (int i = 0; i < 2 * G; ++i) {    // 8 * G floats, 16-byte aligned
            const float4 w = reinterpret_cast<const float4*>(pl + r * G)[i];
            const float f[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) p[(4 * i + c) / G][(4 * i + c) % G] = f[c];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) load2(vs + (r + u) * rs, 2 * tid, hd, x[u]);
#pragma unroll
          for (int u = 0; u < 8; ++u)
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
#pragma unroll
              for (int nd = 0; nd < kVd; ++nd)
                acc[gi][nd] = __fadd_rn(acc[gi][nd],
                                        __fmul_rn(p[u][gi], x[u][nd]));
              if (tid == 0) l[gi] = __fadd_rn(l[gi], p[u][gi]);
            }
        }
        for (; r < n_rows; ++r) {
          float x[kVd];
          load2(vs + r * rs, 2 * tid, hd, x);
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            const float pv = pl[r * G + gi];
#pragma unroll
            for (int nd = 0; nd < kVd; ++nd)
              acc[gi][nd] = __fadd_rn(acc[gi][nd], __fmul_rn(pv, x[nd]));
            if (tid == 0) l[gi] = __fadd_rn(l[gi], pv);
          }
        }
      }
      const int done = t0 + n_rows - t_lo;
      if (done % kChunk == 0 || t0 + n_rows == t_hi) {
        float* pc = parts + (size_t)(c_lo + (done - 1) / kChunk) * pf;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
#pragma unroll
          for (int nd = 0; nd < kVd; ++nd) {
            const int d = 2 * tid + nd;
            if (d < hd) pc[gi * hd + d] = acc[gi][nd];
            acc[gi][nd] = 0.f;
          }
          if (tid == 0) pc[G * hd + gi] = l[gi];
          l[gi] = 0.f;
        }
      }
    }
  }
  if (!maxed) max_phase();             // a CTA with no positions
  cluster_sync();                      // every chunk partial is written

  // rank 0 folds the partials in ascending chunk order, then divides
  if (rank == 0) {
    float tot[G][kVd], lt[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      lt[gi] = 0.f;
#pragma unroll
      for (int nd = 0; nd < kVd; ++nd) tot[gi][nd] = 0.f;
    }
    constexpr int kFold = G <= 2 ? 8 : 1;
    for (int c0 = 0; c0 < n_ch; c0 += kFold) {
      float va[kFold][G][kVd], vl[kFold][G];
#pragma unroll
      for (int i = 0; i < kFold; ++i) {
        if (c0 + i < n_ch) {
          const float* pc = parts + (size_t)(c0 + i) * pf;
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
#pragma unroll
            for (int nd = 0; nd < kVd; ++nd) {
              const int d = 2 * tid + nd;
              va[i][gi][nd] = d < hd ? pc[gi * hd + d] : 0.f;
            }
            vl[i][gi] = pc[G * hd + gi];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kFold; ++i) {
        if (c0 + i < n_ch) {
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
#pragma unroll
            for (int nd = 0; nd < kVd; ++nd)
              tot[gi][nd] = __fadd_rn(tot[gi][nd], va[i][gi][nd]);
            lt[gi] = __fadd_rn(lt[gi], vl[i][gi]);
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= g) continue;
      const float den = empty ? (float)rows.empty_count() : lt[gi];
#pragma unroll
      for (int nd = 0; nd < kVd; ++nd) {
        const int d = 2 * tid + nd;
        if (d < hd)
          out[((size_t)b * H + kh * g + gi) * hd + d] =
              __fdiv_rn(tot[gi][nd], fmaxf(den, 1e-30f));
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to the
// driver library)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// A (rows, KV, hd) tensor map of K or V whose box is box_rows rows of one
// head; rows are 16-byte aligned (the caller checked).
template <typename T>
int rows_map(CUtensorMap* map, const void* base, uint64_t n_rows, int KV,
             int hd, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)KV, n_rows};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * sizeof(T),
                                 (cuuint64_t)KV * hd * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)hd, 1, (cuuint32_t)box_rows};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// rows_map through a small per-thread cache of recent maps: a map depends
// on its arguments alone, so each KV cache of a decode step is encoded once
// rather than on every call.
template <typename T>
int cached_rows_map(CUtensorMap* map, const void* base, uint64_t n_rows,
                    int KV, int hd, int box_rows) {
  struct Key {
    const void* base;
    uint64_t n_rows;
    int KV, hd, box_rows;
  };
  constexpr int kSlots = 32;
  thread_local Key keys[kSlots] = {};
  thread_local CUtensorMap maps[kSlots];
  thread_local int next = 0;
  for (int i = 0; i < kSlots; ++i) {
    const Key& key = keys[i];
    if (key.base == base && key.n_rows == n_rows && key.KV == KV &&
        key.hd == hd && key.box_rows == box_rows) {
      *map = maps[i];
      return 0;
    }
  }
  const int e = rows_map<T>(&maps[next], base, n_rows, KV, hd, box_rows);
  if (e != 0) return e;
  keys[next] = Key{base, n_rows, KV, hd, box_rows};
  *map = maps[next];
  next = (next + 1) % kSlots;
  return 0;
}

template <typename T, int G, typename Rows>
int launch_g(const float* q, const void* k, const void* v, const int* kv_len,
             float* out, float* scratch, Rows rows, const Geom& gm, int B,
             int H, int KV, int hd, float scale, cudaStream_t stream) {
  auto kernel = decode_attn_kernel<T, G, Rows>;
  static bool configured[kMaxDevices];   // the attribute is per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !configured[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemAttr);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const int vec = gm.rb % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  // a box is a stage (a page, where shorter); where the capacity is one
  // chunk (the served shapes), whose rows rarely fill a stage, kBoxRows
  const int ps = rows.page_size();
  int box_rows = rows.capacity() <= kChunk && kBoxRows < gm.sp ? kBoxRows
                                                               : gm.sp;
  if (ps > 0 && ps < box_rows) box_rows = ps;
  CUtensorMap map_k = {}, map_v = {};
  if (vec) {
    const uint64_t n = rows.rows_total(B);
    int e = cached_rows_map<T>(&map_k, k, n, KV, hd, box_rows);
    if (e == 0) e = cached_rows_map<T>(&map_v, v, n, KV, hd, box_rows);
    if (e != 0) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gm.C, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = gm.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = gm.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, q, static_cast<const T*>(k), static_cast<const T*>(v),
      kv_len, out, scratch, map_k, map_v, rows, gm, H, KV, hd, scale, vec,
      box_rows);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <typename T, typename Rows>
int launch(const float* q, const void* k, const void* v, const int* kv_len,
           float* out, void* scratch, Rows rows, int B, int H, int KV,
           int hd, float scale, void* stream) {
  const int g = H / KV;
  if (g < 1 || g > 8 || hd < 1 || hd > kVd * kThreads)
    return (int)cudaErrorInvalidValue;
  const Geom gm = geometry(B, KV, rows.capacity(), g, hd, (int)sizeof(T),
                           rows.page_size());
  if (gm.smem > (size_t)kSmemAttr || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group_of(g)) {
    case 1: return launch_g<T, 1>(q, k, v, kv_len, out, sc, rows, gm, B, H, KV, hd, scale, st);
    case 2: return launch_g<T, 2>(q, k, v, kv_len, out, sc, rows, gm, B, H, KV, hd, scale, st);
    case 4: return launch_g<T, 4>(q, k, v, kv_len, out, sc, rows, gm, B, H, KV, hd, scale, st);
    default: return launch_g<T, 8>(q, k, v, kv_len, out, sc, rows, gm, B, H, KV, hd, scale, st);
  }
}

}  // namespace

// Bytes of global scratch a call needs: the chunk partials, and the logits
// of CTAs whose span does not fit their shared memory; ps is 0 for the
// dense cache.  The wrapper allocates it and passes it as `scratch`.
extern "C" long long repro_decode_scratch_bytes(int B, int cap, int KV, int g,
                                                int hd, int elem, int ps) {
  return (long long)geometry(B, KV, cap, g, hd, elem, ps).scratch;
}

// Every entry returns the launch's error, else cudaGetLastError().
extern "C" int repro_flash_decode_f32(const float* q, const void* k,
                                      const void* v, const int* kv_len,
                                      float* out, void* scratch, int B, int S,
                                      int H, int KV, int hd, float scale,
                                      void* stream) {
  return launch<float>(q, k, v, kv_len, out, scratch, DenseRows{S}, B, H, KV,
                       hd, scale, stream);
}

extern "C" int repro_flash_decode_bf16(const float* q, const void* k,
                                       const void* v, const int* kv_len,
                                       float* out, void* scratch, int B, int S,
                                       int H, int KV, int hd, float scale,
                                       void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, scratch, DenseRows{S}, B,
                               H, KV, hd, scale, stream);
}

// k_pages, v_pages: (P, ps, KV, hd) pools; ptab: (B, NP) int32.
extern "C" int repro_paged_decode_f32(const float* q, const void* k_pages,
                                      const void* v_pages, const int* ptab,
                                      const int* kv_len, float* out,
                                      void* scratch, int B, int NP, int ps,
                                      int P, int H, int KV, int hd,
                                      float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, kv_len, out, scratch,
                       PagedRows{ptab, NP, ps, P, fast_div(ps)}, B, H, KV, hd, scale,
                       stream);
}

extern "C" int repro_paged_decode_bf16(const float* q, const void* k_pages,
                                       const void* v_pages, const int* ptab,
                                       const int* kv_len, float* out,
                                       void* scratch, int B, int NP, int ps,
                                       int P, int H, int KV, int hd,
                                       float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, kv_len, out, scratch,
                               PagedRows{ptab, NP, ps, P, fast_div(ps)}, B, H, KV, hd,
                               scale, stream);
}
