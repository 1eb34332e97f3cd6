// Fused analog MVM chain under bit-line parasitics, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused.py::fused_mvm_parasitic_pallas (kernel
// body _fused_parasitic_kernel), Design A under the paper's Sec. 8
// parasitics in one launch: per (K-partition p, slice s) and input bit b,
// the Thomas forward sweep of the bit plane down every column of both
// differential lines to the bottom-node current; the analog bit fold
// sum_b (I_pos - I_neg) * 2^b; one calibrated ADC per slice in code units;
// the power-of-two shift-and-add over slices; the sum over partitions; the
// final dequant multiply.
//
// What bounds it on the H100: the divisions.  Every (row m, column n, bit,
// line) is a tridiagonal system walked row by row, two IEEE divisions per
// row (c' = -1/denom, d' = (rhs + d')/denom), and a division is a
// multi-instruction sequence around one SFU reciprocal; the conductances
// (2 * S * P * rows * N floats) are read far faster than the sweep uses
// them.  chip_smoke.py states how its bound counts a division.
//
// Design:
// * Every system gets its own thread: a block is one warp of 32 columns
//   wide and 2 * n_bits warps tall (line x bit), for one activation row m
//   (grid (ceil(N / 32), M)).  At decode M = 4 and N = 2560 that is 320
//   blocks of 448 threads, where one thread per column would leave most
//   SMs idle and walk rows * bits * 2 dependent divisions in series.
// * The activation row is staged in shared memory a chunk at a time and
//   each thread derives its signed bit plane from it; each conductance
//   row is one coalesced 128-byte load per warp, and the 2 * n_bits warps
//   reading the same line share it through L1.  Each thread loads 16 rows
//   of its column before it sweeps them: a sweep row depends on the one
//   before, so a load issued in its own row is waited out row after row.
// * The currents of a (p, s) meet in shared memory and one warp folds them
//   in a fixed order: bits ascending, (i_pos - i_neg) * 2^b, from zero; then
//   the ADC, slices and partitions ascending from zero, as the reference's
//   kernel does with its sequential grid.  With n_slices == 1 the lsb folds
//   into the final scale (ref fused.py:173-216).
// * r_hat is a runtime argument, never compiled in (the reference's traced
//   r_hat rule): a sweep over r_hat does not rebuild.
// * No --use_fast_math: every operation is rounded as written
//   (analog.cuh), so the kernel equals kernels/ref.py::fused_mvm_parasitic
//   to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "analog.cuh"

using namespace repro;

namespace {

__global__ void __launch_bounds__(kCols * 2 * kMaxBits)
fused_mvm_parasitic_kernel(const float* __restrict__ x,      // (M, P, R)
                           const float* __restrict__ gp,     // (S, P, R, N)
                           const float* __restrict__ gm,     // (S, P, R, N)
                           const float* __restrict__ r_p,    // (1,)
                           const float* __restrict__ lo_s,   // (S,)
                           const float* __restrict__ hi_s,   // (S,)
                           const float* __restrict__ scale,  // (1,)
                           float* __restrict__ y,            // (M, N)
                           int M, int P, int R, int N, int S, int nbits,
                           int adc_bits, int cell_bits) {
  __shared__ float xs[kRowChunk];
  __shared__ float cur[2 * kMaxBits][kCols];
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int m = blockIdx.y;
  const float r = r_p[0];
  const float top = (float)((1 << adc_bits) - 1);

  float tot = 0.f;
  for (int p = 0; p < P; ++p) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t off = ((size_t)s * P + p) * (size_t)R * N;
      const float accb = bit_fold(x + ((size_t)m * P + p) * R, gp + off,
                                  gm + off, R, N, n, r, nbits, xs, cur);
      if (threadIdx.y == 0) {
        const float lo = lo_s[s];
        const float lsb = adc_lsb(lo, hi_s[s], adc_bits);
        const float a_s = adc_code_units(accb, lo, lsb, top);
        // the outer multiply is the exact power-of-two slice weight
        acc = (S == 1) ? a_s
                       : __fadd_rn(acc, __fmul_rn(__fmul_rn(a_s, lsb),
                                                  ldexpf(1.f, cell_bits * s)));
      }
    }
    tot = __fadd_rn(tot, acc);
  }
  if (threadIdx.y != 0 || n >= N) return;
  float out_scale = scale[0];
  if (S == 1)
    out_scale = __fmul_rn(out_scale, adc_lsb(lo_s[0], hi_s[0], adc_bits));
  y[(size_t)m * N + n] = __fmul_rn(tot, out_scale);
}

}  // namespace

// 1 <= nbits <= 8 input bit planes.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_fused_mvm_parasitic(const float* x, const float* gp,
                                         const float* gm, const float* r,
                                         const float* lo, const float* hi,
                                         const float* scale, float* y, int M,
                                         int P, int R, int N, int S, int nbits,
                                         int adc_bits, int cell_bits,
                                         void* stream) {
  dim3 grid((N + kCols - 1) / kCols, M);
  dim3 block(kCols, 2 * nbits);
  fused_mvm_parasitic_kernel<<<grid, block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, gp, gm, r, lo, hi, scale, y, M, P, R, N, S, nbits, adc_bits,
      cell_bits);
  return (int)cudaGetLastError();
}
