// Fused analog MVM chain for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused.py::fused_mvm_pallas (kernel body
// _fused_diff_kernel), the whole differential analog chain of one matmul
// site in one launch: per (K-partition p, slice s, input bit b or the single
// analog-accumulation term) a dot of the integer activations (or their
// signed bit plane) with g = g_pos - g_neg, the calibrated ADC in code
// units, the power-of-two shift-and-add, the sum over partitions and the
// final dequant multiply.
//
// What bounds it on the H100: at decode (M <= 16 rows) every conductance is
// read once and used for M multiply-adds, so the kernel is memory-bound on
// the 2 * S * P * rows * N * 4 bytes of g_pos and g_neg (about 3.1 GB for
// qwen1.5-4b's lm_head under Design A).
//
// Design:
// * One block owns kCols consecutive output columns (one per thread) and up
//   to BM output rows.  Consecutive threads read consecutive columns of
//   g_pos and g_neg, so every row of a conductance tile is one coalesced
//   load per warp, and each conductance is read from device memory once
//   per block row-tile (once in total at decode, where M <= BM).
// * The activation rows are staged in shared memory kRowChunk array rows at
//   a time (rows reaches 1152 for w_down); every thread reads them as a
//   broadcast.
// * Each thread sums its own (m, n) outputs over the partition's rows in
//   ascending order, whatever M, the tile or the batch row: that is what
//   keeps ServeRuntime == decode_lm at 1.0 under different batchings.  The
//   sum is float32, one rounded multiply and one rounded add per row
//   (__fmul_rn/__fadd_rn, never contracted into an FMA), which is exactly
//   what the plain PyTorch version (kernels/ref.py::fused_mvm_diff) does in
//   the same order, so the two agree to the bit on any device (the
//   reference's oracle walks its kernel's tile order for the same reason).
// * The TPU grid walked partitions sequentially and accumulated into the
//   output block; here the partition loop runs inside the block and the
//   final * scale follows it, so no sum crosses blocks.
// * The epilogue is written with __fadd_rn/__fmul_rn/__fdiv_rn so nvcc
//   cannot contract it into FMAs: the ADC stays in code units, bit and
//   slice weights are exact powers of two, and the one inexact * lsb per
//   slice sits outside the bit fold (the S == 1 case defers it to the
//   final multiply) -- the discipline of src/repro/kernels/fused.py.
// * Each thread loads kBatch array rows of both conductance lines into
//   registers before it uses any of them, so 2 * kBatch loads are in
//   flight per thread: at decode a call has only N threads, and without
//   the batch every one of them waited out a memory round trip per row.
// * Bit-serial mode (n_bits > 0) keeps one accumulator per bit plane, so
//   its row tile is smaller (BM = 2) to stay in registers.
//
// The same kernel, with LEGACY set, also replaces
// src/repro/kernels/analog_mvm.py::analog_mvm_diff_pallas (kernel body
// _diff_kernel), the unsliced differential chain of the legacy use_pallas
// route (repro_analog_mvm_diff): S == 1 and analog accumulation, but per
// partition a value-unit ADC (lo + code * lsb, no degenerate-range guard)
// times gain, summed over partitions in code units with no final scale,
// equal to kernels/ref.py::analog_mvm_diff to the bit.  The TPU kernel's
// dot ran at the TPU's default precision; its oracle pins HIGHEST, and this
// is fp32.  gain is a runtime argument, never compiled in.
//
// With LEGACY set and bit-serial accumulation (repro_analog_mvm_bitserial)
// it replaces src/repro/kernels/analog_mvm.py::analog_mvm_bitserial_pallas
// (kernel body _bitserial_kernel), Design D: the signed bit planes of the
// integer activations formed in registers as in bit-serial mode, per
// partition a dot and a value-unit ADC per bit, the 2**b shift-add (bits
// ascending, from zero), times gain, summed over partitions in code units,
// equal to kernels/ref.py::analog_mvm_bitserial to the bit.  It is bound
// like the rest by the conductance bytes, read once per BM = 2 row tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "analog.cuh"

namespace {

constexpr int kCols = 64;        // output columns per block (= threads)
constexpr int kRowChunk = 128;   // array rows of x staged per pass
constexpr int kBatch = 16;       // array rows of g loaded per batch

template <int BM, int NB, bool LEGACY>
__global__ void __launch_bounds__(kCols)
fused_mvm_kernel(const float* __restrict__ x,      // (M, P, R)
                 const float* __restrict__ gp,     // (S, P, R, N)
                 const float* __restrict__ gm,     // (S, P, R, N)
                 const float* __restrict__ lo_s,   // (S,)
                 const float* __restrict__ hi_s,   // (S,)
                 const float* __restrict__ scale,  // (1,), unused if LEGACY
                 float* __restrict__ y,            // (M, N)
                 int M, int P, int R, int N, int S,
                 int nbits, int adc_bits, int cell_bits, float gain) {
  __shared__ float xs[BM][kRowChunk];
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int mrows = min(BM, M - m0);
  const bool col_ok = n < N;
  const int nb = NB == 1 ? 1 : nbits;
  const float top = (float)((1 << adc_bits) - 1);

  float tot[BM];
#pragma unroll
  for (int mm = 0; mm < BM; ++mm) tot[mm] = 0.f;

  for (int p = 0; p < P; ++p) {
    float acc[BM];
#pragma unroll
    for (int mm = 0; mm < BM; ++mm) acc[mm] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float lo = lo_s[s];
      const float lsb = repro::adc_lsb(lo, hi_s[s], adc_bits);
      const size_t base = ((size_t)s * P + p) * (size_t)R * N + n;
      float v[NB][BM];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int mm = 0; mm < BM; ++mm) v[b][mm] = 0.f;

      for (int r0 = 0; r0 < R; r0 += kRowChunk) {
        const int rc = min(kRowChunk, R - r0);
        __syncthreads();
        for (int i = threadIdx.x; i < BM * kRowChunk; i += kCols) {
          const int mm = i / kRowChunk, rr = i % kRowChunk;
          xs[mm][rr] = (mm < mrows && rr < rc)
              ? x[((size_t)(m0 + mm) * P + p) * R + r0 + rr] : 0.f;
        }
        __syncthreads();
        if (!col_ok) continue;
        const float* gpr = gp + base + (size_t)r0 * N;
        const float* gmr = gm + base + (size_t)r0 * N;
        for (int r = 0; r < rc; r += kBatch) {
          // issue the batch's loads before any use, so kBatch rows of
          // both lines are in flight at once
          float a[kBatch], c[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const bool in = r + j < rc;
            a[j] = in ? __ldg(gpr + (size_t)(r + j) * N) : 0.f;
            c[j] = in ? __ldg(gmr + (size_t)(r + j) * N) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (r + j >= rc) break;
            // g = g_pos - g_neg per element, before the product
            const float g = __fsub_rn(a[j], c[j]);
#pragma unroll
            for (int mm = 0; mm < BM; ++mm) {
              if (mm >= mrows) continue;
              const float xv = xs[mm][r + j];
              if (NB == 1) {
                v[0][mm] = __fadd_rn(v[0][mm], __fmul_rn(xv, g));
              } else {
                const int xi = (int)xv;
                const int mag = abs(xi);
                const float sg = (float)((xi > 0) - (xi < 0));
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                  if (b < nb && ((mag >> b) & 1))
                    v[b][mm] = __fadd_rn(v[b][mm], __fmul_rn(sg, g));
                }
              }
            }
          }
        }
      }
      if (!col_ok) continue;
      if (LEGACY) {
        // value-unit ADC of each term, the 2**b shift-add (bits ascending,
        // from zero), times gain: code units, summed over partitions
#pragma unroll
        for (int mm = 0; mm < BM; ++mm) {
          float a = 0.f;
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            if (b < nb) {
              const float q = repro::adc_value_units(v[b][mm], lo, hi_s[s], top);
              a = __fadd_rn(a, __fmul_rn(q, ldexpf(1.f, NB == 1 ? 0 : b)));
            }
          }
          acc[mm] = __fmul_rn(a, gain);
        }
        continue;
      }
      const float w_s = ldexpf(1.f, cell_bits * s);   // slice weight 2**(cb*s)
#pragma unroll
      for (int mm = 0; mm < BM; ++mm) {
        float a_s = 0.f;                               // slice accum, code units
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b < nb) {
            const float q = repro::adc_code_units(v[b][mm], lo, lsb, top);
            a_s = __fadd_rn(a_s, __fmul_rn(q, ldexpf(1.f, NB == 1 ? 0 : b)));
          }
        }
        acc[mm] = (S == 1) ? a_s
                           : __fadd_rn(acc[mm], __fmul_rn(__fmul_rn(a_s, lsb), w_s));
      }
    }
#pragma unroll
    for (int mm = 0; mm < BM; ++mm) tot[mm] = __fadd_rn(tot[mm], acc[mm]);
  }

  if (!col_ok) return;
  if (LEGACY) {
#pragma unroll
    for (int mm = 0; mm < BM; ++mm) {
      if (mm < mrows) y[(size_t)(m0 + mm) * N + n] = tot[mm];
    }
    return;
  }
  float out_scale = scale[0];
  if (S == 1)
    out_scale = __fmul_rn(out_scale,
                          repro::adc_lsb(lo_s[0], hi_s[0], adc_bits));
#pragma unroll
  for (int mm = 0; mm < BM; ++mm) {
    if (mm < mrows) y[(size_t)(m0 + mm) * N + n] = __fmul_rn(tot[mm], out_scale);
  }
}

template <int BM, int NB, bool LEGACY = false>
void launch(const float* x, const float* gp, const float* gm, const float* lo,
            const float* hi, const float* scale, float* y, int M, int P, int R,
            int N, int S, int nbits, int adc_bits, int cell_bits,
            cudaStream_t stream, float gain = 0.f) {
  dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
  fused_mvm_kernel<BM, NB, LEGACY><<<grid, kCols, 0, stream>>>(
      x, gp, gm, lo, hi, scale, y, M, P, R, N, S, nbits, adc_bits, cell_bits,
      gain);
}

}  // namespace

// nbits == 0 selects analog input accumulation (one ADC term per slice);
// 1 <= nbits <= 8 digitizes each signed input bit plane separately.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_fused_mvm(const float* x, const float* gp, const float* gm,
                               const float* lo, const float* hi,
                               const float* scale, float* y, int M, int P,
                               int R, int N, int S, int nbits, int adc_bits,
                               int cell_bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nbits == 0) {
    launch<16, 1>(x, gp, gm, lo, hi, scale, y, M, P, R, N, S, nbits, adc_bits,
                  cell_bits, st);
  } else {
    launch<2, 8>(x, gp, gm, lo, hi, scale, y, M, P, R, N, S, nbits, adc_bits,
                 cell_bits, st);
  }
  return (int)cudaGetLastError();
}

// The legacy Design-A chain: x (M, P, R), g_pos/g_neg (P, R, N), scalar
// lo/hi; returns code units.  Returns cudaGetLastError() after the launch.
extern "C" int repro_analog_mvm_diff(const float* x, const float* gp,
                                     const float* gm, const float* lo,
                                     const float* hi, float* y, int M, int P,
                                     int R, int N, int adc_bits, float gain,
                                     void* stream) {
  launch<16, 1, true>(x, gp, gm, lo, hi, nullptr, y, M, P, R, N, 1, 0,
                      adc_bits, 0, static_cast<cudaStream_t>(stream), gain);
  return (int)cudaGetLastError();
}

// Design D: x (M, P, R) integers of at most nbits (1..8) magnitude bits,
// g_pos/g_neg (P, R, N), scalar lo/hi; returns code units.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_analog_mvm_bitserial(const float* x, const float* gp,
                                          const float* gm, const float* lo,
                                          const float* hi, float* y, int M,
                                          int P, int R, int N, int nbits,
                                          int adc_bits, float gain,
                                          void* stream) {
  launch<2, 8, true>(x, gp, gm, lo, hi, nullptr, y, M, P, R, N, 1, nbits,
                     adc_bits, 0, static_cast<cudaStream_t>(stream), gain);
  return (int)cudaGetLastError();
}
