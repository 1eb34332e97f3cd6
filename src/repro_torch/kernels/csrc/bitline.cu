// Parasitic bit-line kernels for Hopper (sm_90a).
//
// Replaces two kernels of src/repro/kernels/bitline.py:
// * bitline_mvm_pallas (_bitline_kernel): signed input planes through the
//   parasitic circuit of conductance arrays, the Thomas forward sweep down
//   each column to the bottom-node current.  The reference vmaps it over
//   (slice, partition) (src/repro/core/analog.py:336-351); here one launch
//   covers every (array, plane row, column): g is (G, K, N), x is
//   (X, M, K) and array i reads plane batch i % X, so G = S * P arrays
//   take the P partitions' planes, broadcast over slices.
// * analog_bitline_diff_pallas (_parasitic_diff_kernel): the legacy
//   unsliced Design A under parasitics: per partition, both lines solved
//   for every input bit, the analog bit fold, one value-unit ADC per
//   partition, * gain, and the sum over partitions in code units.
//
// What bounds them on the H100: the divisions, two IEEE divisions per row
// of every system (see fused_mvm_parasitic.cu); chip_smoke.py states how
// its bound counts one.
//
// Design:
// * One thread per system.  bitline_mvm: a block is 32 columns x 8 plane
//   rows; the plane rows' x tile is staged in shared memory a chunk of
//   array rows at a time, each conductance row is one coalesced load per
//   warp and is shared by the block's 8 warps through L1; each thread
//   loads 16 rows of its column before it sweeps them (analog.cuh
//   load_rows), so the sweep does not wait out a load per row.
//   analog_bitline_diff: the block layout and bit fold of
//   fused_mvm_parasitic.cu (analog.cuh bit_fold), one activation row per
//   block, partitions walked inside the block.
// * r_hat and gain are runtime arguments, never compiled in.
// * Every operation is rounded as written (analog.cuh), so each kernel
//   equals its plain version in kernels/ref.py to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "analog.cuh"

using namespace repro;

namespace {

constexpr int kPlaneRows = 8;    // plane rows per bitline_mvm block

__global__ void __launch_bounds__(kCols * kPlaneRows)
bitline_mvm_kernel(const float* __restrict__ x,    // (X, M, K) signed planes
                   const float* __restrict__ g,    // (G, K, N)
                   const float* __restrict__ r_p,  // (1,)
                   float* __restrict__ out,        // (G, M, N)
                   int X, int M, int K, int N) {
  __shared__ float xs[kPlaneRows][kRowChunk];
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int m0 = blockIdx.y * kPlaneRows;
  const int m = m0 + threadIdx.y;
  const int gi = blockIdx.z;
  const float* xb = x + (size_t)(gi % X) * M * K;
  const float* gb = g + (size_t)gi * K * N + n;
  const bool ok = n < N && m < M;
  const float r = r_p[0];
  const int tid = threadIdx.y * kCols + threadIdx.x;

  float c = 0.f, d = 0.f;
  for (int r0 = 0; r0 < K; r0 += kRowChunk) {
    const int rc = min(kRowChunk, K - r0);
    __syncthreads();
    for (int i = tid; i < kPlaneRows * kRowChunk; i += kCols * kPlaneRows) {
      const int mm = i / kRowChunk, rr = i % kRowChunk;
      xs[mm][rr] = (m0 + mm < M && rr < rc)
          ? xb[(size_t)(m0 + mm) * K + r0 + rr] : 0.f;
    }
    __syncthreads();
    if (!ok) continue;
    for (int i = 0; i < rc; i += kSweepBatch) {
      float grow[kSweepBatch];
      load_rows(grow, gb + (size_t)r0 * N, i, rc, N);
#pragma unroll
      for (int j = 0; j < kSweepBatch; ++j) {
        if (i + j >= rc) break;
        const float xv = xs[threadIdx.y][i + j];
        thomas_row(c, d, grow[j], r, fabsf(xv), xv,
                   (r0 + i + j == 0) ? 1.f : 2.f);
      }
    }
  }
  if (ok) out[((size_t)gi * M + m) * N + n] = __fdiv_rn(d, r);
}

__global__ void __launch_bounds__(kCols * 2 * kMaxBits)
analog_bitline_diff_kernel(const float* __restrict__ x,     // (M, P, R)
                           const float* __restrict__ gp,    // (P, R, N)
                           const float* __restrict__ gm,    // (P, R, N)
                           const float* __restrict__ r_p,   // (1,)
                           const float* __restrict__ lo_p,  // (1,)
                           const float* __restrict__ hi_p,  // (1,)
                           float* __restrict__ y,           // (M, N)
                           int M, int P, int R, int N, int nbits,
                           int adc_bits, float gain) {
  __shared__ float xs[kRowChunk];
  __shared__ float cur[2 * kMaxBits][kCols];
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int m = blockIdx.y;
  const float r = r_p[0];
  const float lo = lo_p[0], hi = hi_p[0];
  const float top = (float)((1 << adc_bits) - 1);

  float tot = 0.f;
  for (int p = 0; p < P; ++p) {
    const size_t off = (size_t)p * R * N;
    const float accb = bit_fold(x + ((size_t)m * P + p) * R, gp + off,
                                gm + off, R, N, n, r, nbits, xs, cur);
    if (threadIdx.y == 0)
      tot = __fadd_rn(tot, __fmul_rn(adc_value_units(accb, lo, hi, top),
                                     gain));
  }
  if (threadIdx.y == 0 && n < N) y[(size_t)m * N + n] = tot;
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int repro_bitline_mvm(const float* x, const float* g,
                                 const float* r, float* out, int X, int G,
                                 int M, int K, int N, void* stream) {
  dim3 grid((N + kCols - 1) / kCols, (M + kPlaneRows - 1) / kPlaneRows, G);
  bitline_mvm_kernel<<<grid, dim3(kCols, kPlaneRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(x, g, r, out, X,
                                                            M, K, N);
  return (int)cudaGetLastError();
}

// 1 <= nbits <= 8 input bit planes.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_analog_bitline_diff(const float* x, const float* gp,
                                         const float* gm, const float* r,
                                         const float* lo, const float* hi,
                                         float* y, int M, int P, int R, int N,
                                         int nbits, int adc_bits, float gain,
                                         void* stream) {
  dim3 grid((N + kCols - 1) / kCols, M);
  analog_bitline_diff_kernel<<<grid, dim3(kCols, 2 * nbits), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, gp, gm, r, lo, hi, y, M, P, R, N, nbits, adc_bits, gain);
  return (int)cudaGetLastError();
}
