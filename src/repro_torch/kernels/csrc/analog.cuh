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
constexpr int kXRows = 128;      // array rows of a plane staged per pass
constexpr int kRowBatch = 8;     // conductance rows loaded before a sweep

// ADC step size with the core.adc degenerate-range guard (fused chains).
__device__ __forceinline__ float adc_lsb(float lo, float hi, int bits) {
  float lsb = __fdiv_rn(__fsub_rn(hi, lo), (float)((1 << bits) - 1));
  return lsb <= 0.f ? 1.f : lsb;
}

// An ADC code clipped to [0, top] as torch.clamp and jnp.clip clip it: a
// NaN stays NaN (fminf/fmaxf alone would return the bound).
__device__ __forceinline__ float clip_code(float code, float top) {
  return code != code ? code : fminf(fmaxf(code, 0.f), top);
}

// fused_adc_code_units: clip/round to top + 1 levels, the value in code
// units (lo / lsb + code).  rintf rounds half to even, like torch.round.
__device__ __forceinline__ float adc_code_units(float v, float lo, float lsb,
                                                float top) {
  const float code = clip_code(rintf(__fdiv_rn(__fsub_rn(v, lo), lsb)), top);
  return __fadd_rn(__fdiv_rn(lo, lsb), code);
}

// The legacy kernels' epilogue (src/repro/kernels/analog_mvm.py
// _adc_epilogue): value units lo + code * lsb, lsb = (hi - lo) / top, with
// no degenerate-range guard: with lo == hi a value v == lo gives 0 / 0,
// NaN, as in the reference.
__device__ __forceinline__ float adc_value_units(float v, float lo, float hi,
                                                 float top) {
  const float lsb = __fdiv_rn(__fsub_rn(hi, lo), top);
  const float code = clip_code(rintf(__fdiv_rn(__fsub_rn(v, lo), lsb)), top);
  return __fadd_rn(lo, __fmul_rn(code, lsb));
}

// One row of the Thomas forward sweep down a bit line (the reference's
// src/repro/kernels/bitline.py::_thomas_bottom_current): the row's cell
// has g * r = grr and signed source xv in {-1, 0, +1} (gate bit |xv|);
// base is 1 for the top row and 2 below it.  |xv| * grr and xv * grr are
// exact products, so the sweep is FMA-invariant.  c = -1 / denom is
// -__frcp_rn(denom): round-to-nearest is symmetric, so the negated
// correctly rounded reciprocal is the correctly rounded quotient of -1.
// d's division stays __fdiv_rn, since multiplying by a reciprocal would
// change the bits.
__device__ __forceinline__ void sweep_row(float& c, float& d, float grr,
                                          float xv, float base) {
  const float denom =
      __fadd_rn(__fadd_rn(__fmul_rn(fabsf(xv), grr), base), c);
  c = -__frcp_rn(denom);
  d = __fdiv_rn(__fadd_rn(__fmul_rn(xv, grr), d), denom);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Sweep rc (<= kXRows) rows of one column for kSys systems that share its
// conductances: row i's conductance is g[i * N], system t's signed plane
// is xs[t * kXRows + i] (shared memory, 16-byte aligned).  The
// conductances of a batch of kRowBatch rows are loaded before any is
// used, since a sweep row depends on the one before and a load issued in
// its own row would be waited out row after row; each load, its address
// and its g * r serve kSys systems, and a thread reads four rows of a
// plane in one 16-byte load.  Full batches run unrolled with no bounds
// test, the ragged tail row by row.  base is the next row's (1 on the top
// row, 2 below it), carried across calls.
template <int kSys>
__device__ __forceinline__ void sweep_stage(float (&c)[kSys],
                                            float (&d)[kSys], float& base,
                                            const float* __restrict__ g,
                                            int N, const float* xs, int rc,
                                            float r) {
  int i = 0;
  for (; i + kRowBatch <= rc; i += kRowBatch) {
    float gv[kRowBatch];
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j)
      gv[j] = __ldg(g + (size_t)(i + j) * N);
#pragma unroll
    for (int j = 0; j < kRowBatch; j += 4) {
      float4 xq[kSys];
#pragma unroll
      for (int t = 0; t < kSys; ++t)
        xq[t] = *reinterpret_cast<const float4*>(xs + t * kXRows + i + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float grr = __fmul_rn(gv[j + q], r);
#pragma unroll
        for (int t = 0; t < kSys; ++t)
          sweep_row(c[t], d[t], grr, lane(xq[t], q), base);
        base = 2.f;
      }
    }
  }
  for (; i < rc; ++i) {                    // the ragged tail
    const float grr = __fmul_rn(__ldg(g + (size_t)i * N), r);
#pragma unroll
    for (int t = 0; t < kSys; ++t)
      sweep_row(c[t], d[t], grr, xs[t * kXRows + i], base);
    base = 2.f;
  }
}

}  // namespace repro
