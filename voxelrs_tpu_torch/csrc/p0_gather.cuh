// P0: the gather probe — gathers from a table, one dependent gather a step.
//
// Replaces scripts/probes/pallas_probe.py::make_kernel (:32; run :68 ->
// pl.pallas_call :73), the JAX package's only Pallas kernel: it measured
// how fast a TPU kernel gathers from a table held in on-chip memory, for
// the access patterns a traversal would use. Inputs: a (rows, 128) u32
// table and (sub, 128) u32 seeds; over `steps` steps every lane (i, j)
// XORs one gathered word into its accumulator and advances its index by
// the LCG idx * 1664525 + 1013904223 (u32 wrap); the output is the
// (sub, 128) accumulators. The kinds, as the probe defines them:
//   flat      tbl[idx % (rows * 128)]             (a general gather)
//   axis0     tbl[idx % rows][j]                  (a row per lane, own column)
//   axis1     tbl[i][idx % 128]                   (a column within row i)
//   two_step  rowv[i][j] = tbl[r[i][j]][j] with r = (idx % total) >> 7, then
//             rowv[i][c] with c = (idx % total) & 127: tbl[r[i][c]][c], the
//             row index of the lane at column c of the same seed row — not
//             the flat gather.
//
// Design: one block of 128 threads per seed row, one thread per lane, the
// 512 steps in registers (u32 arithmetic as the probe's: modulo, the LCG's
// wrap). two_step exchanges the row indices of its seed row through shared
// memory each step (128 words, two barriers). The tables are 256 KB, 2 MB
// and 8 MB: none fits the 227 KB of shared memory a block can have, and
// all fit the 50 MB L2, so the kernel reads them in place from global
// memory through the read-only path (__ldg) and lets L2 hold them.
//
// What bounds it on an H100: neither bytes nor operations. At sub 8 the
// launch is 1,024 threads on 8 of the 132 SMs, each a chain of 512
// dependent L2 loads, so it measures gather latency, not the card's
// gather throughput. Its bound counts the bytes gathered (4 a lane a step)
// over 3.35 TB/s.

#pragma once
#include <cstdint>

namespace vx {

constexpr int P0_FLAT = 0, P0_AXIS0 = 1, P0_AXIS1 = 2, P0_TWO_STEP = 3;
constexpr int P0_LANES = 128;  // lanes of a seed row: one block

template <int KIND>
__global__ void __launch_bounds__(P0_LANES)
p0_gather_kernel(const uint32_t* __restrict__ tbl, uint32_t rows,
                 const uint32_t* __restrict__ seeds, int steps,
                 uint32_t* __restrict__ out) {
  __shared__ uint32_t row_of[P0_LANES];
  const int i = blockIdx.x, j = threadIdx.x;
  const uint32_t total = rows * 128u;
  uint32_t idx = seeds[i * P0_LANES + j], acc = 0u;
  for (int s = 0; s < steps; ++s) {
    uint32_t v;
    if constexpr (KIND == P0_FLAT) {
      v = __ldg(tbl + idx % total);
    } else if constexpr (KIND == P0_AXIS0) {
      v = __ldg(tbl + (size_t)(idx % rows) * 128u + j);
    } else if constexpr (KIND == P0_AXIS1) {
      v = __ldg(tbl + (size_t)i * 128u + idx % 128u);
    } else {
      const uint32_t addr = idx % total;
      row_of[j] = addr >> 7;
      __syncthreads();
      const uint32_t c = addr & 127u;
      v = __ldg(tbl + (size_t)row_of[c] * 128u + c);
      __syncthreads();  // row_of is rewritten next step
    }
    acc ^= v;
    idx = idx * 1664525u + 1013904223u;
  }
  out[i * P0_LANES + j] = acc;
}

}  // namespace vx
