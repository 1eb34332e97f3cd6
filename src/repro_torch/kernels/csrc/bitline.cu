// Parasitic bit-line kernel for Hopper (sm_90a).
//
// Replaces src/repro/kernels/bitline.py::bitline_mvm_pallas (kernel body
// _bitline_kernel): signed input planes through the parasitic circuit of
// conductance arrays, the Thomas forward sweep down each column to the
// bottom-node current.  The reference vmaps it over (slice, partition)
// (src/repro/core/analog.py:336-351); here one launch covers every (array,
// plane row, column): g is (G, K, N), x is (X, M, K) and array i reads
// plane batch i % X, so G = S * P arrays take the P partitions' planes,
// broadcast over slices.  (The legacy parasitic Design-A kernel,
// analog_bitline_diff_pallas, is fused_mvm_parasitic.cu's kernel with the
// legacy epilogue.)
//
// What bounds bitline_mvm on the H100: instruction issue.  A row of a
// sweep is three products, three adds and two IEEE divisions, each
// rounded as written (analog.cuh), and it waits on the row before, so a
// system's rows run one after another and the parallelism is across
// systems.  nvcc expands each __fdiv_rn into a reciprocal on the
// special-function unit (MUFU.RCP), five FFMAs, a range check (FCHK) and
// a branch around a slow-path call fenced by a convergence barrier
// (BSSY/BSYNC): 10 instructions.  One system per thread, with its
// predicated loads and their 64-bit addresses, issued 49 instructions a
// row step, where the bound (chip_smoke.sweep_ops, a division counted as
// 16 flops) allows 19.
//
// Design of bitline_mvm:
// * A thread sweeps kSys = 4 plane rows of one column together, row by
//   row: each conductance it loads, its address and its g * r serve four
//   systems.  A block is 32 columns x 8 threads x 4 plane rows.
// * c = -1 / denom is -__frcp_rn(denom) (analog.cuh sweep_row).  Its
//   expansion trades FCHK and three FFMAs for an FADD and an integer range
//   check, and spares the register moves the division's slow-path call
//   adds.  A row step issues 26.5 instructions (tools/bitline_bench.py
//   --sass).
// * ptxas does not move one system's division across another's
//   slow-path branch, so each division's latency is hidden by other
//   warps, not by the thread's other systems: kRowBatch = 8 conductance
//   rows in registers and __launch_bounds__(256, 4) keep the kernel at
//   64 registers, 4 blocks (32 warps) per SM.  What that spills is the x
//   staging's addresses, reloaded once per x stage, never in the sweep.
// * The plane rows' x tile is staged in shared memory kXRows array rows
//   at a time; a thread reads four rows of one plane row in one 16-byte
//   load.  The conductance rows of a batch are loaded before any is
//   used; full batches run unrolled with no bounds test, the ragged tail
//   of K row by row, the top row's base (1, not 2) as a loop-carried
//   value (analog.cuh sweep_stage, shared with fused_mvm_parasitic.cu).
//   Plane rows past M are zero-filled and columns past N never swept;
//   neither is stored.
// * Each system still runs its rows in ascending order with every
//   operation rounded as written, so the kernel equals its plain version
//   in kernels/ref.py to the bit; only the interleaving of independent
//   systems changed.
// * r_hat is a runtime argument, never compiled in.

#include <cuda_runtime.h>
#include <stdint.h>

#include "analog.cuh"

using namespace repro;

namespace {

constexpr int kSys = 4;          // plane rows one bitline_mvm thread sweeps
constexpr int kThreadRows = 8;   // threads along plane rows per block
constexpr int kTileM = kSys * kThreadRows;   // plane rows per block
constexpr int kMinBlocks = 4;    // resident blocks per SM (64 registers)

__global__ void __launch_bounds__(kCols * kThreadRows, kMinBlocks)
bitline_mvm_kernel(const float* __restrict__ x,    // (X, M, K) signed planes
                   const float* __restrict__ g,    // (G, K, N)
                   const float* __restrict__ r_p,  // (1,)
                   float* __restrict__ out,        // (G, M, N)
                   int X, int M, int K, int N) {
  __shared__ __align__(16) float xs[kTileM][kXRows];
  const int n = blockIdx.x * kCols + threadIdx.x;
  const int m0 = blockIdx.y * kTileM;
  const int ms = threadIdx.y * kSys;       // this thread's rows in the tile
  const int gi = blockIdx.z;
  const float* xb = x + (size_t)(gi % X) * M * K;
  const float* gb = g + (size_t)gi * K * N + n;
  const bool ok = n < N;
  const float r = r_p[0];
  const int tid = threadIdx.y * kCols + threadIdx.x;

  float c[kSys], d[kSys];
#pragma unroll
  for (int t = 0; t < kSys; ++t) c[t] = d[t] = 0.f;
  float base = 1.f;                        // the top row's; 2 below it
  for (int r0 = 0; r0 < K; r0 += kXRows) {
    const int rc = min(kXRows, K - r0);
    __syncthreads();
    for (int i = tid; i < kTileM * kXRows; i += kCols * kThreadRows) {
      const int mm = i / kXRows, rr = i % kXRows;
      xs[mm][rr] = (m0 + mm < M && rr < rc)
          ? xb[(size_t)(m0 + mm) * K + r0 + rr] : 0.f;
    }
    __syncthreads();
    if (!ok) continue;
    sweep_stage(c, d, base, gb + (size_t)r0 * N, N, &xs[ms][0], rc, r);
  }
  if (!ok) return;
#pragma unroll
  for (int t = 0; t < kSys; ++t) {
    const int m = m0 + ms + t;
    if (m < M) out[((size_t)gi * M + m) * N + n] = __fdiv_rn(d[t], r);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int repro_bitline_mvm(const float* x, const float* g,
                                 const float* r, float* out, int X, int G,
                                 int M, int K, int N, void* stream) {
  dim3 grid((N + kCols - 1) / kCols, (M + kTileM - 1) / kTileM, G);
  bitline_mvm_kernel<<<grid, dim3(kCols, kThreadRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(x, g, r, out, X,
                                                            M, K, N);
  return (int)cudaGetLastError();
}
