// Fused analog MVM chain for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused.py::fused_mvm_pallas (kernel body
// _fused_diff_kernel), the whole differential analog chain of one matmul
// site in one launch: per (K-partition p, slice s, input bit b or the single
// analog-accumulation term) a dot of the integer activations (or their
// signed bit plane) with g = g_pos - g_neg, the calibrated ADC in code
// units, the power-of-two shift-and-add, the sum over partitions and the
// final dequant multiply (repro_fused_mvm).
//
// With the legacy epilogue it also replaces
// src/repro/kernels/analog_mvm.py::analog_mvm_diff_pallas (kernel body
// _diff_kernel), the unsliced differential chain of the legacy use_pallas
// route (repro_analog_mvm_diff): S == 1 and analog accumulation, but per
// partition a value-unit ADC (lo + code * lsb, no degenerate-range guard)
// times gain, summed over partitions in code units with no final scale.
// The TPU kernel's dot ran at the TPU's default precision; its oracle pins
// HIGHEST, and this is fp32.  gain is a runtime argument.
//
// What fixes the arithmetic: every pre-ADC value is a float32 sum over the
// partition's rows in ascending order, one rounded multiply and one
// rounded add per row (__fmul_rn/__fadd_rn, never contracted into an FMA),
// which is what the plain versions (kernels/ref.py::fused_mvm_diff and
// ::analog_mvm_diff) do in the same order, so kernel and plain version
// agree to the bit, and every output is the same whatever rows share the
// launch (ServeRuntime == decode_lm).  Another summation order flips ADC
// codes far from a rounding edge.  So the row sum of one output is never
// split, and tensor cores (their own order, TF32 inputs) are out.
//
// What bounds it on the H100: at decode (M <= 16 rows) each conductance is
// used for M multiply-adds, 2 flops per 8 bytes read, so the kernel is
// bound by the 2 * S * P * rows * N * 4 bytes of g_pos and g_neg (52 MB at
// qwen1.5-4b's K = N = 2560 sites, 15.7 us at 3.35 TB/s; 3.1 GB at its
// lm_head).  At a prefill bucket (M = 128) it is bound by the fp32 issue
// rate: a multiply and an add that may not fuse issue as two instructions.
//
// Design (mvm_stream_kernel):
// * The parallelism comes from the independent chains, one per (m, n,
//   partition, slice, bit), and from decoupling loads from sums.  A block
//   owns kTileN output columns, a tile of BM rows of x and one K-partition
//   p; its 256 threads own the tile's (m, n) chains, TM x TN of them each
//   (bit-serial mode: NB accumulators per chain).  Each chain walks rows
//   r = 0, 1, ... of its partition in ascending order, slice by slice.
// * Conductances reach the block through a kStages-deep ring in dynamic
//   shared memory, kTileR rows of both lines per stage, filled by cp.async
//   (16-byte copies when N % 4 == 0 and the lines are 16-byte aligned,
//   4-byte ones otherwise), so the bytes in flight (three stages, 48 KB a
//   block) no longer depend on how many chains there are.  Each thread
//   copies the same positions of g_pos and g_neg and, once its own copies
//   have landed, forms g = g_pos - g_neg there once per element into a
//   double-buffered g tile that every chain then reads.  The x rows of a
//   stage land in the same ring, transposed so a thread reads its TM rows
//   as one broadcast.  One __syncthreads per stage orders it all.
// * Ragged shapes stay in the kernel: rows past R and columns past N are
//   zero-filled by the copies and never stored; conductance lines that are
//   not 16-byte aligned, and the x rows (R is rarely a multiple of 4),
//   take 4-byte copies.
// * Partitions run in parallel: the blocks of one (column, row) tile form
//   a thread-block cluster along the partition axis (C = min(P, 8) blocks).
//   Each leaves its partition's epilogue result in its shared memory;
//   after cluster.sync() rank 0 reads them through distributed shared
//   memory and adds them in ascending p, ((acc_0 + acc_1) + acc_2) + ...,
//   before the final * out_scale (or the code-unit store).  With P > 8 a
//   block takes partitions rank, rank + C, ... in rounds, and rank 0 adds
//   each round's results in order, so the order never changes.  No atomics.
// * BM is 4, 16 or 128 (bit-serial: 4 or 16) by M, so a decode call reads
//   each conductance once and a prefill bucket of 128 rows does too.
// * The epilogue is written with __fadd_rn/__fmul_rn/__fdiv_rn so nvcc
//   cannot contract it into FMAs: the ADC stays in code units, bit and
//   slice weights are exact powers of two, and the one inexact * lsb per
//   slice sits outside the bit fold (the S == 1 case defers it to the
//   final multiply) -- the discipline of src/repro/kernels/fused.py.
//
// Design D (repro_analog_mvm_bitserial) is the same kernel with the
// bit-serial accumulators and the legacy epilogue (NB = 8, LEGACY), the
// row tiles of the bit-serial mode (BM 4 or 16 by M), S == 1.  It replaces
// src/repro/kernels/analog_mvm.py::analog_mvm_bitserial_pallas (kernel
// body _bitserial_kernel): per partition the dot of each signed bit plane
// of the integer activations with g_pos - g_neg (bits past nbits masked),
// a value-unit ADC per bit, the 2**b shift-add (bits ascending, from
// zero), times gain, summed over partitions in code units in ascending p,
// equal to kernels/ref.py::analog_mvm_bitserial to the bit.  It is bound
// like the rest by the conductance bytes, read once per row tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "analog.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// mvm_stream_kernel: repro_fused_mvm (both modes), repro_analog_mvm_diff and
// repro_analog_mvm_bitserial
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;    // threads per block
constexpr int kTileN = 64;       // output columns per block
constexpr int kTileR = 32;       // array rows per pipeline stage
constexpr int kStages = 4;       // stages in the shared-memory ring
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies; src_bytes == 0 zero-fills dst.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Shared-memory layout of one block, in floats: the ring (per stage the
// g_pos tile, the g_neg tile, then x transposed to [row][m] with row stride
// kXStride), the double-buffered g tile, and the partition result tile.
template <int BM>
struct StreamLayout {
  static constexpr int kXStride = BM >= 16 ? BM + 4 : BM;
  static constexpr int kG = kTileR * kTileN;
  static constexpr int kStage = 2 * kG + kTileR * kXStride;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kFloats = kRing + 2 * kG + BM * kTileN;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int K>
__device__ __forceinline__ void load_run(float (&dst)[K],
                                         const float* __restrict__ src) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + i);
      dst[i] = q.x; dst[i + 1] = q.y; dst[i + 2] = q.z; dst[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) dst[i] = src[i];
  }
}

template <int BM, int TM, int TN, int NB, bool LEGACY>
__global__ void __launch_bounds__(kThreads)
mvm_stream_kernel(const float* __restrict__ x,      // (M, P, R)
                  const float* __restrict__ gp,     // (S, P, R, N)
                  const float* __restrict__ gm,     // (S, P, R, N)
                  const float* __restrict__ lo_s,   // (S,)
                  const float* __restrict__ hi_s,   // (S,)
                  const float* __restrict__ scale,  // (1,), unused if LEGACY
                  float* __restrict__ y,            // (M, N)
                  int M, int P, int R, int N, int S, int nbits, int adc_bits,
                  int cell_bits, float gain, int vec) {
  using L = StreamLayout<BM>;
  constexpr int kGroupsN = kTileN / TN;
  static_assert((BM / TM) * kGroupsN == kThreads, "one thread per chain tile");
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const gbuf = ring + L::kRing;
  float* const part = gbuf + 2 * L::kG;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;                 // the cluster spans the grid's x
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * kTileN;
  const int m0 = blockIdx.z * BM;
  const int mrows = min(BM, M - m0);
  const int tid = threadIdx.x;
  const int cn = (tid % kGroupsN) * TN;    // this thread's chains, in-tile
  const int cm = (tid / kGroupsN) * TM;
  const int nb = NB == 1 ? 1 : nbits;
  const float top = (float)((1 << adc_bits) - 1);
  const int nst = max(1, (R + kTileR - 1) / kTileR);   // stages per slice
  const int T = S * nst;                               // stages per partition

  // Copy stage t of partition p into its ring slot.  Each thread copies
  // the same positions of g_pos and g_neg as convert() reads back.
  auto issue = [&](int t, int p) {
    float* st = ring + (t % kStages) * L::kStage;
    const int s = t / nst, r0 = (t - s * nst) * kTileR;
    const int rc = min(kTileR, R - r0);
    const size_t row0 = ((size_t)s * P + p) * R + r0;
    if (vec) {
      for (int i = tid; i < kTileR * (kTileN / 4); i += kThreads) {
        const int r = i / (kTileN / 4), c = (i % (kTileN / 4)) * 4;
        const bool in = r < rc && n0 + c < N;
        const size_t off = in ? (row0 + r) * N + n0 + c : 0;
        cp_async16(st + 4 * i, gp + off, in ? 16 : 0);
        cp_async16(st + L::kG + 4 * i, gm + off, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kTileR * kTileN; i += kThreads) {
        const int r = i / kTileN, c = i % kTileN;
        const bool in = r < rc && n0 + c < N;
        const size_t off = in ? (row0 + r) * N + n0 + c : 0;
        cp_async4(st + i, gp + off, in ? 4 : 0);
        cp_async4(st + L::kG + i, gm + off, in ? 4 : 0);
      }
    }
    float* xs = st + 2 * L::kG;
    for (int i = tid; i < BM * kTileR; i += kThreads) {
      const int mm = i / kTileR, r = i % kTileR;
      const bool in = mm < mrows && r < rc;
      const size_t off = in ? ((size_t)(m0 + mm) * P + p) * R + r0 + r : 0;
      cp_async4(xs + r * L::kXStride + mm, x + off, in ? 4 : 0);
    }
  };

  // g = g_pos - g_neg of this thread's own copies of stage t, once per
  // element, into the g tile (t & 1).
  auto convert = [&](int t) {
    const float* st = ring + (t % kStages) * L::kStage;
    float* g = gbuf + (t & 1) * L::kG;
    if (vec) {
      for (int i = 4 * tid; i < L::kG; i += 4 * kThreads) {
        const float4 a = *reinterpret_cast<const float4*>(st + i);
        const float4 b = *reinterpret_cast<const float4*>(st + L::kG + i);
        *reinterpret_cast<float4*>(g + i) = make_float4(
            __fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z),
            __fsub_rn(a.w, b.w));
      }
    } else {
      for (int i = tid; i < L::kG; i += kThreads)
        g[i] = __fsub_rn(st[i], st[L::kG + i]);
    }
  };

  float tot[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) tot[a][c] = 0.f;

  for (int p0 = 0; p0 < P; p0 += C) {
    const int p = p0 + rank;
    if (p < P) {
      float acc[TM][TN], v[NB][TM][TN];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          acc[a][c] = 0.f;
#pragma unroll
          for (int b = 0; b < NB; ++b) v[b][a][c] = 0.f;
        }
      for (int t = 0; t < kStages - 1; ++t) {
        if (t < T) issue(t, p);
        cp_async_commit();
      }
      for (int t = 0; t < T; ++t) {
        cp_async_wait<kStages - 2>();       // this thread's stage t landed
        convert(t);
        __syncthreads();                    // stage t's g and x visible;
        if (t + kStages - 1 < T)            // slot t - 1 free again
          issue(t + kStages - 1, p);
        cp_async_commit();

        const int s = t / nst, r0 = (t - s * nst) * kTileR;
        const int rc = min(kTileR, R - r0);
        const float* g = gbuf + (t & 1) * L::kG + cn;
        const float* xs = ring + (t % kStages) * L::kStage + 2 * L::kG + cm;
#pragma unroll 4
        for (int j = 0; j < rc; ++j) {
          float gv[TN], xv[TM];
          load_run(gv, g + j * kTileN);
          load_run(xv, xs + j * L::kXStride);
#pragma unroll
          for (int a = 0; a < TM; ++a) {
            if (NB == 1) {
#pragma unroll
              for (int c = 0; c < TN; ++c)
                v[0][a][c] = __fadd_rn(v[0][a][c], __fmul_rn(xv[a], gv[c]));
            } else {
              const int xi = (int)xv[a];
              const int mag = abs(xi);
              const float sg = (float)((xi > 0) - (xi < 0));
#pragma unroll
              for (int b = 0; b < NB; ++b) {
                if (b < nb && ((mag >> b) & 1)) {
#pragma unroll
                  for (int c = 0; c < TN; ++c)
                    v[b][a][c] = __fadd_rn(v[b][a][c], __fmul_rn(sg, gv[c]));
                }
              }
            }
          }
        }
        if (t - s * nst != nst - 1) continue;

        // the last stage of slice s: its ADC and shift-add
        const float lo = lo_s[s];
        const float lsb = repro::adc_lsb(lo, hi_s[s], adc_bits);
        const float w_s = ldexpf(1.f, cell_bits * s);   // 2**(cb*s)
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            float a_s = 0.f;
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              if (b < nb) {
                const float q = LEGACY
                    ? repro::adc_value_units(v[b][a][c], lo, hi_s[s], top)
                    : repro::adc_code_units(v[b][a][c], lo, lsb, top);
                a_s = __fadd_rn(a_s, __fmul_rn(q, ldexpf(1.f, NB == 1 ? 0 : b)));
              }
              v[b][a][c] = 0.f;
            }
            if (LEGACY)
              acc[a][c] = __fmul_rn(a_s, gain);
            else
              acc[a][c] = (S == 1) ? a_s
                  : __fadd_rn(acc[a][c], __fmul_rn(__fmul_rn(a_s, lsb), w_s));
          }
      }
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TN; ++c)
          part[(cm + a) * kTileN + cn + c] = acc[a][c];
    }
    cluster.sync();                 // every partition result of the round
    if (rank == 0) {
      const int cnt = min(C, P - p0);
      for (int q = 0; q < cnt; ++q) {       // p ascending
        const float* rp = cluster.map_shared_rank(part, q);
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            tot[a][c] = __fadd_rn(tot[a][c], rp[(cm + a) * kTileN + cn + c]);
      }
    }
    cluster.sync();                 // rank 0 has read them
  }

  if (rank != 0) return;
  float out_scale = 1.f;
  if (!LEGACY) {
    out_scale = scale[0];
    if (S == 1)
      out_scale = __fmul_rn(out_scale,
                            repro::adc_lsb(lo_s[0], hi_s[0], adc_bits));
  }
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int n = n0 + cn + c;
      if (cm + a < mrows && n < N)
        y[(size_t)(m0 + cm + a) * N + n] =
            LEGACY ? tot[a][c] : __fmul_rn(tot[a][c], out_scale);
    }
}

// Launch mvm_stream_kernel as clusters of C = min(P, 8) blocks along the
// partition axis.  Returns the launch's error, else cudaGetLastError().
template <int BM, int TM, int TN, int NB, bool LEGACY>
int launch_stream(const float* x, const float* gp, const float* gm,
                  const float* lo, const float* hi, const float* scale,
                  float* y, int M, int P, int R, int N, int S, int nbits,
                  int adc_bits, int cell_bits, float gain,
                  cudaStream_t stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  auto kernel = mvm_stream_kernel<BM, TM, TN, NB, LEGACY>;
  constexpr size_t kSmem = StreamLayout<BM>::kBytes;
  static bool configured[kMaxDevices];   // the attribute is per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !configured[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const int C = min(P, kMaxCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (N + kTileN - 1) / kTileN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(gp) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(gm) % 16 == 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, x, gp, gm, lo, hi, scale, y, M, P, R, N, S, nbits,
      adc_bits, cell_bits, gain, vec);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// nbits == 0 selects analog input accumulation (one ADC term per slice);
// 1 <= nbits <= 8 digitizes each signed input bit plane separately.  The
// row tile follows M (each conductance is read once per tile); every tile
// gives the same bits.  Returns the launch's CUDA error, 0 on success.
extern "C" int repro_fused_mvm(const float* x, const float* gp, const float* gm,
                               const float* lo, const float* hi,
                               const float* scale, float* y, int M, int P,
                               int R, int N, int S, int nbits, int adc_bits,
                               int cell_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nbits == 0) {
    if (M <= 4)
      return launch_stream<4, 1, 1, 1, false>(x, gp, gm, lo, hi, scale, y, M,
                                              P, R, N, S, 0, adc_bits,
                                              cell_bits, 0.f, st);
    if (M <= 16)
      return launch_stream<16, 4, 1, 1, false>(x, gp, gm, lo, hi, scale, y,
                                               M, P, R, N, S, 0, adc_bits,
                                               cell_bits, 0.f, st);
    return launch_stream<128, 8, 4, 1, false>(x, gp, gm, lo, hi, scale, y, M,
                                              P, R, N, S, 0, adc_bits,
                                              cell_bits, 0.f, st);
  }
  if (M <= 4)
    return launch_stream<4, 1, 1, 8, false>(x, gp, gm, lo, hi, scale, y, M, P,
                                            R, N, S, nbits, adc_bits,
                                            cell_bits, 0.f, st);
  return launch_stream<16, 4, 1, 8, false>(x, gp, gm, lo, hi, scale, y, M, P,
                                           R, N, S, nbits, adc_bits,
                                           cell_bits, 0.f, st);
}

// The legacy Design-A chain: x (M, P, R), g_pos/g_neg (P, R, N), scalar
// lo/hi; returns code units.  Returns the launch's CUDA error, 0 on
// success.
extern "C" int repro_analog_mvm_diff(const float* x, const float* gp,
                                     const float* gm, const float* lo,
                                     const float* hi, float* y, int M, int P,
                                     int R, int N, int adc_bits, float gain,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4)
    return launch_stream<4, 1, 1, 1, true>(x, gp, gm, lo, hi, nullptr, y, M,
                                           P, R, N, 1, 0, adc_bits, 0, gain,
                                           st);
  if (M <= 16)
    return launch_stream<16, 4, 1, 1, true>(x, gp, gm, lo, hi, nullptr, y, M,
                                            P, R, N, 1, 0, adc_bits, 0, gain,
                                            st);
  return launch_stream<128, 8, 4, 1, true>(x, gp, gm, lo, hi, nullptr, y, M,
                                           P, R, N, 1, 0, adc_bits, 0, gain,
                                           st);
}

// Design D: x (M, P, R) integers of at most nbits (1..8) magnitude bits,
// g_pos/g_neg (P, R, N), scalar lo/hi; returns code units.  Returns the
// launch's CUDA error, 0 on success.
extern "C" int repro_analog_mvm_bitserial(const float* x, const float* gp,
                                          const float* gm, const float* lo,
                                          const float* hi, float* y, int M,
                                          int P, int R, int N, int nbits,
                                          int adc_bits, float gain,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4)
    return launch_stream<4, 1, 1, 8, true>(x, gp, gm, lo, hi, nullptr, y, M,
                                           P, R, N, 1, nbits, adc_bits, 0,
                                           gain, st);
  return launch_stream<16, 4, 1, 8, true>(x, gp, gm, lo, hi, nullptr, y, M,
                                          P, R, N, 1, nbits, adc_bits, 0,
                                          gain, st);
}
