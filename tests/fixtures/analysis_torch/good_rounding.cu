// Known-good: every float op spelled __f*_rn; index math and pointers
// are free.
#include "analog.cuh"

__device__ float chain(float v, float lo, float lsb, const float* g, int n) {
  float code = __fdiv_rn(__fsub_rn(v, lo), lsb);
  const float* row = g + n * 4;
  int k = n * 2 + 1;
  code = __fadd_rn(code, row[k]);
  float y = __fadd_rn(__fmul_rn(code, lsb), lo);
  return __fadd_rn(y, __fmul_rn(0.5f, code));
}
