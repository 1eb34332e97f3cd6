// Analog MVM chains under bit-line parasitics, for Hopper (sm_90a).
//
// Replaces two kernels of the reference:
// * src/repro/kernels/fused.py::fused_mvm_parasitic_pallas (kernel body
//   _fused_parasitic_kernel), Design A under the paper's Sec. 8 parasitics
//   in one launch (repro_fused_mvm_parasitic): per (K-partition p, slice
//   s) and input bit b, the Thomas forward sweep of the bit plane down
//   every column of both differential lines to the bottom-node current;
//   the analog bit fold sum_b (I_pos - I_neg) * 2^b; one calibrated ADC
//   per slice in code units; the power-of-two shift-and-add over slices;
//   the sum over partitions; the final dequant multiply.
// * src/repro/kernels/bitline.py::analog_bitline_diff_pallas (kernel body
//   _parasitic_diff_kernel), the legacy unsliced Design A under parasitics
//   (repro_analog_bitline_diff): the same sweeps and bit fold with the
//   legacy epilogue, one value-unit ADC per partition (lo + code * lsb, no
//   degenerate-range guard) * gain, summed over partitions in code units
//   with no final scale.
// Both are parasitic_fold_kernel; LEGACY picks the epilogue, as
// mvm_stream_kernel's does in fused_mvm.cu.
//
// What bounds it on the H100: instruction issue.  Every (row m, column n,
// partition, slice, bit, line) is a tridiagonal system walked row by row,
// and a row is three products, three adds and two IEEE divisions, each
// rounded as written (analog.cuh sweep_row), waiting on the row before; a
// division is ten instructions around one SFU reciprocal.  The
// conductances (2 * S * P * rows * N floats) are read far faster than the
// sweeps use them.  chip_smoke.py states how its bound counts a division.
//
// Design:
// * The signed bit planes of a block's activation rows are derived once
//   per x stage (kXRows array rows) into shared memory, sv[m * nbits + b]
//   [i] = sign(x) * ((|x| >> b) & 1), so the sweep row is bitline.cu's,
//   with no bit arithmetic, top-row or break test in it.
// * A thread sweeps kSys = 2 systems of one column and line that share
//   its conductances (analog.cuh sweep_stage): the systems of a (column,
//   line) are the block's kTileM = 2 activation rows times n_bits bits,
//   numbered m * nbits + b and dealt out two to a thread.  Each
//   conductance load, its address and its g * r serve two systems, and
//   the block reads each conductance column once for both its rows.  A
//   block is 32 columns x 2 lines x ceil(rows * nbits / 2) threads (448
//   at 2 rows and 7 bits).  ptxas does not move one system's division
//   across another's slow-path branch, so a division's latency is hidden
//   by other warps, not by the thread's other systems: the budget is 40
//   registers and three blocks (42 warps) an SM.  Four systems a thread
//   at 64 registers (two blocks of four rows, 28 warps) issue 5% fewer
//   instructions per row step but run 1.14x slower on an H100 at
//   qwen1.5-4b's decode sites (tools/parasitic_bench.py); one system a thread, one-row tiles
//   and 48 registers (which still leave two blocks an SM) are slower too.
//   What 40 registers spill is one reload per 16 row steps in the sweep
//   and the staging's addresses.
// * The currents meet in shared memory, cur[line][m * nbits + b][col],
//   and one thread per (row, column) folds them in the reference's order:
//   bits ascending, (I_pos - I_neg) * 2^b from zero; then the ADC, and
//   slices ascending from zero (with n_slices == 1 the lsb folds into the
//   final scale; ref fused.py:173-216).
// * Partitions run in parallel: the blocks of one (column, row) tile form
//   a thread-block cluster along the partition axis (C = min(P, 8)
//   blocks), as in fused_mvm.cu.  Each leaves its partition result in its
//   shared memory; after cluster.sync() rank 0 reads them through
//   distributed shared memory and adds them in ascending p, before the
//   final * out_scale (or the code-unit store).  With P > 8 a block takes
//   partitions rank, rank + C, ... in rounds, and rank 0 adds each round's
//   results in order.  Row tiles of kTileM rows are the grid's y axis, so
//   a prefill bucket runs its tiles in parallel too.
// * Each system runs its rows in ascending order with every operation
//   rounded as written, and no sum depends on which rows share a launch,
//   so the kernel equals kernels/ref.py::fused_mvm_parasitic and
//   ::analog_mvm_parasitic_diff to the bit.  No --use_fast_math.
// * r_hat and gain are runtime arguments, never compiled in (the
//   reference's traced r_hat rule): a sweep over them does not rebuild.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "analog.cuh"

namespace cg = cooperative_groups;
using namespace repro;

namespace {

constexpr int kMaxBits = 8;      // input bit planes the kernel takes
constexpr int kSys = 2;          // systems one thread sweeps
constexpr int kTileM = 2;        // activation rows per block
constexpr int kMaxSys = kTileM * kMaxBits;   // systems per (column, line)
constexpr int kMaxThreads = kCols * 2 * (kMaxSys / kSys);
constexpr int kMinBlocks = 3;    // resident blocks per SM (40 registers)
constexpr int kMaxCluster = 8;   // the portable cluster size

template <bool LEGACY>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
parasitic_fold_kernel(const float* __restrict__ x,      // (M, P, R)
                      const float* __restrict__ gp,     // (S, P, R, N)
                      const float* __restrict__ gm,     // (S, P, R, N)
                      const float* __restrict__ r_p,    // (1,)
                      const float* __restrict__ lo_s,   // (S,)
                      const float* __restrict__ hi_s,   // (S,)
                      const float* __restrict__ scale,  // (1,); unused if LEGACY
                      float* __restrict__ y,            // (M, N)
                      int M, int P, int R, int N, int S, int nbits, int mt,
                      int adc_bits, int cell_bits, float gain) {
  __shared__ __align__(16) float sv[kMaxSys][kXRows];   // signed bit planes
  __shared__ float cur[2][kMaxSys][kCols];              // bottom currents
  __shared__ float part[kTileM * kCols];   // this block's partition result
  __shared__ float tot[kTileM * kCols];    // rank 0: the partition sum

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / C) * kCols;
  const int m0 = blockIdx.y * mt;
  const int tl = blockDim.y / 2;           // threads per line
  const int line = threadIdx.y / tl;
  const int q0 = (threadIdx.y % tl) * kSys;   // this thread's systems
  const int ns = mt * nbits;               // systems per (column, line)
  const int n = n0 + threadIdx.x;
  const bool ok = n < N;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int nthreads = kCols * blockDim.y;
  const int nout = mt * kCols;             // (row, column) results
  const float r = r_p[0];
  const float top = (float)((1 << adc_bits) - 1);

  // the planes of the padding systems (ns .. tl * kSys) stay zero
  for (int i = tid; i < (tl * kSys - ns) * kXRows; i += nthreads)
    sv[ns + i / kXRows][i % kXRows] = 0.f;
  for (int f = tid; f < nout; f += nthreads) tot[f] = 0.f;

  for (int p0 = 0; p0 < P; p0 += C) {
    const int p = p0 + rank;
    if (p < P) {
      for (int s = 0; s < S; ++s) {
        const float* g = (line == 0 ? gp : gm)
                         + ((size_t)s * P + p) * (size_t)R * N + n;
        float c[kSys], d[kSys];
#pragma unroll
        for (int t = 0; t < kSys; ++t) c[t] = d[t] = 0.f;
        float base = 1.f;                  // the top row's; 2 below it
        for (int r0 = 0; r0 < R; r0 += kXRows) {
          const int rc = min(kXRows, R - r0);
          __syncthreads();                 // the last stage's planes swept
          for (int i = tid; i < mt * kXRows; i += nthreads) {
            const int mm = i / kXRows, rr = i % kXRows;
            const int m = m0 + mm;
            const int xi = (m < M && rr < rc)
                ? (int)x[((size_t)m * P + p) * R + r0 + rr] : 0;
            const int mag = abs(xi);
            const float sg = (float)((xi > 0) - (xi < 0));
            float* plane = &sv[mm * nbits][rr];
            for (int b = 0; b < nbits; ++b)
              plane[b * kXRows] = ((mag >> b) & 1) ? sg : 0.f;
          }
          __syncthreads();
          if (!ok) continue;
          sweep_stage(c, d, base, g + (size_t)r0 * N, N, &sv[q0][0], rc, r);
        }
#pragma unroll
        for (int t = 0; t < kSys; ++t)
          cur[line][q0 + t][threadIdx.x] = __fdiv_rn(d[t], r);
        __syncthreads();
        // the fold, ADC and slice sum of each (row, column); the next
        // slice's first barrier orders these reads before its cur writes
        for (int f = tid; f < nout; f += nthreads) {
          const int mm = f / kCols, col = f % kCols;
          float accb = 0.f;
          for (int b = 0; b < nbits; ++b) {
            const float diff = __fsub_rn(cur[0][mm * nbits + b][col],
                                         cur[1][mm * nbits + b][col]);
            accb = __fadd_rn(accb, __fmul_rn(diff, ldexpf(1.f, b)));
          }
          if (LEGACY) {
            part[f] = __fmul_rn(adc_value_units(accb, lo_s[0], hi_s[0], top),
                                gain);
          } else {
            const float lo = lo_s[s];
            const float lsb = adc_lsb(lo, hi_s[s], adc_bits);
            const float a_s = adc_code_units(accb, lo, lsb, top);
            // the outer multiply is the exact power-of-two slice weight
            part[f] = (S == 1) ? a_s
                : __fadd_rn(s == 0 ? 0.f : part[f],
                            __fmul_rn(__fmul_rn(a_s, lsb),
                                      ldexpf(1.f, cell_bits * s)));
          }
        }
      }
    }
    cluster.sync();                 // every partition result of the round
    if (rank == 0) {
      const int cnt = min(C, P - p0);
      for (int q = 0; q < cnt; ++q) {       // p ascending
        const float* rp = cluster.map_shared_rank(part, q);
        for (int f = tid; f < nout; f += nthreads)
          tot[f] = __fadd_rn(tot[f], rp[f]);
      }
    }
    cluster.sync();                 // rank 0 has read them
  }

  if (rank != 0) return;
  float out_scale = 1.f;
  if (!LEGACY) {
    out_scale = scale[0];
    if (S == 1) out_scale = __fmul_rn(out_scale,
                                      adc_lsb(lo_s[0], hi_s[0], adc_bits));
  }
  for (int f = tid; f < nout; f += nthreads) {
    const int m = m0 + f / kCols, nn = n0 + f % kCols;
    if (m < M && nn < N)
      y[(size_t)m * N + nn] = LEGACY ? tot[f] : __fmul_rn(tot[f], out_scale);
  }
}

// Launch parasitic_fold_kernel as clusters of C = min(P, 8) blocks along
// the partition axis: grid x is C x the column tiles, y the row tiles.
// Returns the launch's error, else cudaGetLastError().
template <bool LEGACY>
int launch_fold(const float* x, const float* gp, const float* gm,
                const float* r, const float* lo, const float* hi,
                const float* scale, float* y, int M, int P, int R, int N,
                int S, int nbits, int adc_bits, int cell_bits, float gain,
                void* stream) {
  if (M < 1 || P < 1 || R < 1 || N < 1 || nbits < 1 || nbits > kMaxBits)
    return (int)cudaErrorInvalidValue;
  const int mt = min(M, kTileM);
  const int tl = (mt * nbits + kSys - 1) / kSys;
  const int C = min(P, kMaxCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((N + kCols - 1) / kCols), (M + mt - 1) / mt);
  cfg.blockDim = dim3(kCols, 2 * tl);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, parasitic_fold_kernel<LEGACY>, x, gp, gm, r, lo, hi, scale, y, M,
      P, R, N, S, nbits, mt, adc_bits, cell_bits, gain);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// The fused chain: x (M, P, R), g_pos/g_neg (S, P, R, N), lo/hi (S,),
// scale (1,); 1 <= nbits <= 8 input bit planes.  Returns the launch's
// CUDA error, 0 on success.
extern "C" int repro_fused_mvm_parasitic(const float* x, const float* gp,
                                         const float* gm, const float* r,
                                         const float* lo, const float* hi,
                                         const float* scale, float* y, int M,
                                         int P, int R, int N, int S, int nbits,
                                         int adc_bits, int cell_bits,
                                         void* stream) {
  return launch_fold<false>(x, gp, gm, r, lo, hi, scale, y, M, P, R, N, S,
                            nbits, adc_bits, cell_bits, 0.f, stream);
}

// The legacy Design-A chain: x (M, P, R), g_pos/g_neg (P, R, N), lo/hi
// (1,); returns code units.  Returns the launch's CUDA error, 0 on
// success.
extern "C" int repro_analog_bitline_diff(const float* x, const float* gp,
                                         const float* gm, const float* r,
                                         const float* lo, const float* hi,
                                         float* y, int M, int P, int R, int N,
                                         int nbits, int adc_bits, float gain,
                                         void* stream) {
  return launch_fold<true>(x, gp, gm, r, lo, hi, nullptr, y, M, P, R, N, 1,
                           nbits, adc_bits, 0, gain, stream);
}
