// Out of scope: does not include analog.cuh (its contract is a bound).
__device__ float scale(float a, float b) { return a * b + 1.f; }
