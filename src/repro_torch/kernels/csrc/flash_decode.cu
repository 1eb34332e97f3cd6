// Single-token decode attention over the dense per-slot KV cache or a paged
// KV pool, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused.py::flash_attention_pallas (kernel body
// _flash_kernel): GQA decode attention of one query token per batch row
// over a (B, S, KV, hd) cache, masked by the per-row fill kv_len[b], in two
// passes -- the global max of the scaled logits, then exp(s - max) and
// exp(s - max) * v accumulated with pure adds -- divided by max(l, 1e-30).
//
// What bounds it on the H100: the K and V bytes of the valid positions,
// each read once per pass of the logits (2 * kv_len * KV * hd elements per
// row); the arithmetic is a few flops per byte.
//
// Design:
// * One block per (batch row, KV head) carries that head's g = H / KV query
//   heads, so K and V are fetched once for the whole group.  Four warps
//   walk the positions below kv_len[b] (warp w takes t = w, w + 4, ...);
//   the lanes of a warp span hd, each lane holding hd / 32 elements.
//   Positions at or beyond kv_len[b] are never read: in the reference they
//   contribute exact zeros, so skipping them changes nothing.
// * Each logit is a lane-ordered FMA chain plus a fixed xor-butterfly warp
//   reduction, so both passes see bit-identical logits for a position.
//   Each warp sums its own positions in ascending order and the four
//   partial sums are combined in warp order: the result depends on kv_len
//   only, never on the cache capacity S or on the other rows of the batch.
// * The TPU kernel kept its running max, denominator and per-chunk terms in
//   VMEM scratch across sequential grid steps; here they live in
//   registers and one shared-memory exchange, inside one block.
// * K and V may be float32 or bfloat16 (the cache's dtype); they are
//   widened to float32 in registers, as the reference widens them.
//
// The same kernel, with the PagedRows addressing policy, also replaces
// src/repro/kernels/paged.py::paged_attention_pallas (kernel body
// _paged_kernel): the K/V of position t of row b live at
// pool[ptab[b, t / ps], t % ps] of a (P, ps, KV, hd) pool, read through the
// (B, NP) block table in global memory.  Only the address of a position
// changes (DenseRows vs PagedRows), never the arithmetic or its order, so a
// paged call equals the dense kernel on the gathered view pool[ptab] to the
// bit.  What bounds it is the same: the valid positions' K and V bytes.
// The pool is read in its own dtype: the reference's wrapper casts the
// whole pool to float32 before its kernel, a copy of every page in every
// layer of every step, which this kernel never makes.  Table entries past
// a row's fill, and so the sink page 0 that pads them, are never read (a
// position at or beyond kv_len[b] is never visited), and a page id outside
// [0, P) is clamped, so no table can make the kernel read outside the pool.
// page_size == 1 needs no special case here (the reference canonicalizes
// it for its compiler; the plain version keeps that).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;        // query heads per KV head
constexpr int kMaxDl = 8;       // hd / 32 elements per lane (hd <= 256)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Where position t of batch row b lives: the index of its (KV, hd) row in
// the K/V array, and the number of positions a row can hold.
struct DenseRows {               // k, v: (B, S, KV, hd)
  int S;
  __device__ __forceinline__ int capacity() const { return S; }
  __device__ __forceinline__ size_t row(int b, int t) const {
    return (size_t)b * S + t;
  }
};

struct PagedRows {               // k, v: (P, ps, KV, hd) pool
  const int* ptab;               // (B, NP) block table
  int NP, ps, P;
  __device__ __forceinline__ int capacity() const { return NP * ps; }
  __device__ __forceinline__ size_t row(int b, int t) const {
    const int page = min(max(ptab[(size_t)b * NP + t / ps], 0), P - 1);
    return (size_t)page * ps + t % ps;
  }
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const float* __restrict__ q,     // (B, H, hd)
                    const T* __restrict__ k,         // rows of (KV, hd)
                    const T* __restrict__ v,         // rows of (KV, hd)
                    const int* __restrict__ kv_len,  // (B,)
                    float* __restrict__ out,         // (B, H, hd)
                    Rows rows, int H, int KV, int hd, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kh = blockIdx.y;
  const int g = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = smem;                        // (g, hd) scaled queries
  float* m_part = qs + g * hd;             // (kWarps, g)
  float* l_part = m_part + kWarps * g;     // (kWarps, g)
  float* a_part = l_part + kWarps * g;     // (kWarps, g, hd)

  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    const int gi = i / hd, d = i % hd;
    qs[i] = __fmul_rn(q[((size_t)b * H + kh * g + gi) * hd + d], scale);
  }
  __syncthreads();

  const int len = min(kv_len[b], rows.capacity());
  const size_t row_stride = (size_t)KV * hd;
  // offset of this KV head's hd elements at position t
  auto at = [&](int t) { return rows.row(b, t) * row_stride + (size_t)kh * hd; };

  // logits of the group's heads at the position whose K starts at kt,
  // identical in both passes
  auto logits = [&](const T* kt, float (&s)[kMaxG]) {
    float kr[kMaxDl];
#pragma unroll
    for (int j = 0; j < kMaxDl; ++j) {
      const int d = lane + 32 * j;
      kr[j] = d < hd ? widen(kt[d]) : 0.f;
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      float part = 0.f;
      if (gi < g) {
#pragma unroll
        for (int j = 0; j < kMaxDl; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) part = __fmaf_rn(qs[gi * hd + d], kr[j], part);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      s[gi] = part;
    }
  };

  // pass 1: the global max per query head
  float mw[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) mw[gi] = kNegInf;
  for (int t = warp; t < len; t += kWarps) {
    float s[kMaxG];
    logits(k + at(t), s);
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
      if (gi < g) mw[gi] = fmaxf(mw[gi], s[gi]);
  }
  if (lane == 0)
    for (int gi = 0; gi < g; ++gi) m_part[warp * g + gi] = mw[gi];
  __syncthreads();
  float m[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    m[gi] = kNegInf;
    if (gi < g)
      for (int w = 0; w < kWarps; ++w) m[gi] = fmaxf(m[gi], m_part[w * g + gi]);
  }

  // pass 2: exp(s - max) and its weighted values, pure adds
  float lw[kMaxG], aw[kMaxG][kMaxDl];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    lw[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDl; ++j) aw[gi][j] = 0.f;
  }
  for (int t = warp; t < len; t += kWarps) {
    const size_t off = at(t);
    float s[kMaxG];
    logits(k + off, s);
    float vr[kMaxDl];
#pragma unroll
    for (int j = 0; j < kMaxDl; ++j) {
      const int d = lane + 32 * j;
      vr[j] = d < hd ? widen(v[off + d]) : 0.f;
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        const float p = expf(__fsub_rn(s[gi], m[gi]));
        lw[gi] = __fadd_rn(lw[gi], p);
#pragma unroll
        for (int j = 0; j < kMaxDl; ++j)
          aw[gi][j] = __fadd_rn(aw[gi][j], __fmul_rn(p, vr[j]));
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi < g) {
      if (lane == 0) l_part[warp * g + gi] = lw[gi];
#pragma unroll
      for (int j = 0; j < kMaxDl; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) a_part[((size_t)warp * g + gi) * hd + d] = aw[gi][j];
      }
    }
  }
  __syncthreads();

  // combine the warps' partial sums in warp order, then divide
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    const int gi = i / hd, d = i % hd;
    float l = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      l = __fadd_rn(l, l_part[w * g + gi]);
      a = __fadd_rn(a, a_part[((size_t)w * g + gi) * hd + d]);
    }
    out[((size_t)b * H + kh * g + gi) * hd + d] = __fdiv_rn(a, fmaxf(l, 1e-30f));
  }
}

template <typename T, typename Rows>
int launch(const float* q, const void* k, const void* v, const int* kv_len,
           float* out, Rows rows, int B, int H, int KV, int hd, float scale,
           void* stream) {
  const int g = H / KV;
  const size_t smem = sizeof(float) * ((size_t)g * hd + 2 * kWarps * g +
                                       (size_t)kWarps * g * hd);
  dim3 grid(B, KV);
  flash_decode_kernel<T, Rows><<<grid, kWarps * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), kv_len, out,
      rows, H, KV, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry returns cudaGetLastError() after the launch.
extern "C" int repro_flash_decode_f32(const float* q, const void* k,
                                      const void* v, const int* kv_len,
                                      float* out, int B, int S, int H, int KV,
                                      int hd, float scale, void* stream) {
  return launch<float>(q, k, v, kv_len, out, DenseRows{S}, B, H, KV, hd,
                       scale, stream);
}

extern "C" int repro_flash_decode_bf16(const float* q, const void* k,
                                       const void* v, const int* kv_len,
                                       float* out, int B, int S, int H, int KV,
                                       int hd, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, DenseRows{S}, B, H, KV,
                               hd, scale, stream);
}

// k_pages, v_pages: (P, ps, KV, hd) pools; ptab: (B, NP) int32.
extern "C" int repro_paged_decode_f32(const float* q, const void* k_pages,
                                      const void* v_pages, const int* ptab,
                                      const int* kv_len, float* out, int B,
                                      int NP, int ps, int P, int H, int KV,
                                      int hd, float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, kv_len, out,
                       PagedRows{ptab, NP, ps, P}, B, H, KV, hd, scale,
                       stream);
}

extern "C" int repro_paged_decode_bf16(const float* q, const void* k_pages,
                                       const void* v_pages, const int* ptab,
                                       const int* kv_len, float* out, int B,
                                       int NP, int ps, int P, int H, int KV,
                                       int hd, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, kv_len, out,
                               PagedRows{ptab, NP, ps, P}, B, H, KV, hd,
                               scale, stream);
}
