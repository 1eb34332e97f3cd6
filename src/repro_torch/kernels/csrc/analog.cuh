// Device helpers shared by the analog MVM kernels (fused_mvm.cu,
// fused_mvm_parasitic.cu, bitline.cu).
//
// Every add, multiply and divide is written with __fadd_rn/__fmul_rn/
// __fdiv_rn, so nvcc cannot contract a product into an FMA and every
// division is IEEE round-to-nearest: the kernels then compute exactly what
// their plain PyTorch versions (kernels/ref.py, core/parasitics.py) compute
// op by op, to the bit.

#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kCols = 32;        // output columns per block (one warp wide)
constexpr int kMaxBits = 8;      // input bit planes a fold kernel takes
constexpr int kRowChunk = 256;   // array rows of x staged in shared memory
constexpr int kSweepBatch = 16;  // conductance rows loaded ahead of a sweep

// ADC step size with the core.adc degenerate-range guard (fused chains).
__device__ __forceinline__ float adc_lsb(float lo, float hi, int bits) {
  float lsb = __fdiv_rn(__fsub_rn(hi, lo), (float)((1 << bits) - 1));
  return lsb <= 0.f ? 1.f : lsb;
}

// fused_adc_code_units: clip/round to top + 1 levels, the value in code
// units (lo / lsb + code).  rintf rounds half to even, like torch.round.
__device__ __forceinline__ float adc_code_units(float v, float lo, float lsb,
                                                float top) {
  float code = rintf(__fdiv_rn(__fsub_rn(v, lo), lsb));
  code = fminf(fmaxf(code, 0.f), top);
  return __fadd_rn(__fdiv_rn(lo, lsb), code);
}

// The legacy kernels' epilogue (src/repro/kernels/analog_mvm.py
// _adc_epilogue): value units lo + code * lsb, lsb = (hi - lo) / top, with
// no degenerate-range guard.
__device__ __forceinline__ float adc_value_units(float v, float lo, float hi,
                                                 float top) {
  const float lsb = __fdiv_rn(__fsub_rn(hi, lo), top);
  float code = rintf(__fdiv_rn(__fsub_rn(v, lo), lsb));
  code = fminf(fmaxf(code, 0.f), top);
  return __fadd_rn(lo, __fmul_rn(code, lsb));
}

// One row of the Thomas forward sweep down a bit line (the reference's
// src/repro/kernels/bitline.py::_thomas_bottom_current): the row's cell has
// conductance g, gate bit a in {0, 1} and signed source xs in {-1, 0, +1};
// base is 1 for the top row and 2 below it.  gr = a * (g * r) and
// rhs = xs * (g * r) are exact products, so the sweep is FMA-invariant.
__device__ __forceinline__ void thomas_row(float& c, float& d, float g,
                                           float r, float a, float xs,
                                           float base) {
  const float grr = __fmul_rn(g, r);
  const float denom = __fadd_rn(__fadd_rn(__fmul_rn(a, grr), base), c);
  c = __fdiv_rn(-1.f, denom);
  d = __fdiv_rn(__fadd_rn(__fmul_rn(xs, grr), d), denom);
}

// Load rows i .. i + kSweepBatch - 1 (those below rc) of one column of a
// conductance array, row stride N, before any of them is used: a sweep
// row depends on the one before, so a load issued in its own row would
// be waited out row after row.
__device__ __forceinline__ void load_rows(float (&gb)[kSweepBatch],
                                          const float* __restrict__ g,
                                          int i, int rc, int N) {
#pragma unroll
  for (int j = 0; j < kSweepBatch; ++j)
    gb[j] = i + j < rc ? __ldg(g + (size_t)(i + j) * N) : 0.f;
}

// Both lines of one array, every input bit of one activation row, for the
// block's kCols columns.  Block layout: threadIdx.x is the column within
// the tile, threadIdx.y = line * nbits + bit (blockDim.y == 2 * nbits), so
// every (column, bit, line) is its own tridiagonal system on its own
// thread.  The activation row is staged kRowChunk rows at a time in xs;
// each thread derives its signed bit plane from it (bit b of |x| carrying
// sign(x)) and sweeps its line's column n of gp / gm (R rows, row stride N,
// loaded kSweepBatch rows ahead) down to the bottom node, I = d' / r.  The
// currents meet in cur (2 * kMaxBits x kCols), and the threads of row
// y == 0 return the analog (switched-capacitor) bit fold
//     accb = sum_b (I_pos,b - I_neg,b) * 2^b,  b ascending, from 0;
// the other threads return 0.  Every thread of the block must call it.
__device__ __forceinline__ float bit_fold(const float* __restrict__ x_row,
                                          const float* __restrict__ gp,
                                          const float* __restrict__ gm,
                                          int R, int N, int n, float r,
                                          int nbits, float* xs,
                                          float (*cur)[kCols]) {
  const int line = threadIdx.y / nbits;
  const int b = threadIdx.y % nbits;
  const bool col_ok = n < N;
  const float* g = (line == 0 ? gp : gm) + n;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float c = 0.f, d = 0.f;
  for (int r0 = 0; r0 < R; r0 += kRowChunk) {
    const int rc = min(kRowChunk, R - r0);
    __syncthreads();
    for (int i = tid; i < rc; i += nthreads) xs[i] = x_row[r0 + i];
    __syncthreads();
    if (!col_ok) continue;
    for (int i = 0; i < rc; i += kSweepBatch) {
      float gb[kSweepBatch];
      load_rows(gb, g + (size_t)r0 * N, i, rc, N);
#pragma unroll
      for (int j = 0; j < kSweepBatch; ++j) {
        if (i + j >= rc) break;
        const int xi = (int)xs[i + j];
        const int bit = (abs(xi) >> b) & 1;
        const float sv = bit ? (float)((xi > 0) - (xi < 0)) : 0.f;
        thomas_row(c, d, gb[j], r, (float)bit, sv,
                   (r0 + i + j == 0) ? 1.f : 2.f);
      }
    }
  }
  cur[threadIdx.y][threadIdx.x] = col_ok ? __fdiv_rn(d, r) : 0.f;
  __syncthreads();
  float accb = 0.f;
  if (threadIdx.y == 0) {
    for (int bb = 0; bb < nbits; ++bb) {
      const float diff = __fsub_rn(cur[bb][threadIdx.x],
                                   cur[nbits + bb][threadIdx.x]);
      accb = __fadd_rn(accb, __fmul_rn(diff, ldexpf(1.f, bb)));
    }
  }
  return accb;
}

}  // namespace repro
