// Known-bad: float arithmetic outside the __f*_rn spelling.
#include "analog.cuh"

__device__ float chain(float v, float lo, float lsb, const float* g, int n) {
  float code = (v - lo) / lsb;
  const float* row = g + n * 4;
  int k = n * 2 + 1;
  code += row[k];
  float y = fmaf(code, lsb, lo);
  return __fadd_rn(y, 0.5f * code);
}
