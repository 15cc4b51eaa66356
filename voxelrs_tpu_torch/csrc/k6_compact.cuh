// K6: stream compaction — the ascending indices of a mask's set lanes,
// truncated at `size` and padded with 0 to `size`, and the number of set
// lanes in device memory.
//
// Replaces voxelrs_tpu/ops/shading.py::compact_indices (:313), i.e.
// jnp.nonzero(mask, size=size, fill_value=0)[0]. The TPU version packs the
// mask into words and resolves each output slot's owner block with a
// scatter-max and a cummax, because a TPU has no cheap per-lane atomics or
// ballots; here a warp ballot and __popc rank the lanes directly.
//
// Design: three launches on the caller's stream. (1) one thread per lane,
// 1024-lane blocks: each warp ballots its lanes, and the block's count is
// the sum of its 32 warp popcounts; (2) one block scans the block counts in
// place (exclusive) and writes the total to *count; (3) the lanes ballot
// again, and each set lane writes its own index at block offset + warp
// offset + its rank among the warp's set lanes, and the output slots at or
// past the count get the 0 padding. Consumers read *count and exit past it,
// so a frame compacts without a host round trip. A pose batch (K10)
// compacts the lanes of all its poses in one call; with `starts` the write
// pass also hands out the rank of every seg-th lane, i.e. where each pose's
// set lanes begin in the output, so the consumers read each pose's count
// without a round trip or another launch.
//
// What bounds it on an H100: bytes — the mask is read twice (1 byte a
// lane) and each set lane's index written once; at 2,073,600 lanes that is
// about 4 MB plus 4 bytes a set lane, a few microseconds at 3.35 TB/s,
// below the cost of the three launches themselves.

#pragma once
#include <cstdint>

namespace vx {

constexpr int K6_BLOCK = 1024;  // mask lanes per block, one a thread

__device__ __forceinline__ unsigned k6_ballot(const uint8_t* __restrict__ mask,
                                              int n, int i) {
  return __ballot_sync(0xffffffffu, i < n && mask[i] != 0);
}

__global__ void __launch_bounds__(K6_BLOCK)
k6_count_kernel(const uint8_t* __restrict__ mask, int n,
                int* __restrict__ block_counts) {
  __shared__ int warp_counts[K6_BLOCK / 32];
  const int i = blockIdx.x * K6_BLOCK + threadIdx.x;
  const unsigned ballot = k6_ballot(mask, n, i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int c = warp_counts[lane];
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0) block_counts[blockIdx.x] = c;
  }
}

// One block: block counts -> exclusive block offsets (in place), the total
// to *count.
__global__ void __launch_bounds__(K6_BLOCK)
k6_scan_kernel(int* __restrict__ block_counts, int nb,
               int* __restrict__ count) {
  __shared__ int sums[K6_BLOCK];
  const int per = (nb + K6_BLOCK - 1) / K6_BLOCK;
  const int b0 = threadIdx.x * per;
  const int b1 = b0 + per < nb ? b0 + per : nb;
  int s = 0;
  for (int b = b0; b < b1; ++b) s += block_counts[b];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < K6_BLOCK; off <<= 1) {  // inclusive scan
    const int v = threadIdx.x >= off ? sums[threadIdx.x - off] : 0;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  int run = threadIdx.x ? sums[threadIdx.x - 1] : 0;
  for (int b = b0; b < b1; ++b) {
    const int c = block_counts[b];
    block_counts[b] = run;
    run += c;
  }
  if (threadIdx.x == K6_BLOCK - 1) *count = sums[K6_BLOCK - 1];
}

__global__ void __launch_bounds__(K6_BLOCK)
k6_write_kernel(const uint8_t* __restrict__ mask, int n,
                const int* __restrict__ block_offsets, int size,
                const int* __restrict__ count, int* __restrict__ out,
                int seg, int* __restrict__ starts) {
  __shared__ int warp_offs[K6_BLOCK / 32];
  const int i = blockIdx.x * K6_BLOCK + threadIdx.x;
  const unsigned ballot = k6_ballot(mask, n, i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_offs[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 32 warp counts
    const int v = warp_offs[lane];
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    warp_offs[lane] = incl - v;
  }
  __syncthreads();
  if (i < n) {
    // the set lanes before lane i: its rank, if it is set
    const int rank = block_offsets[blockIdx.x] + warp_offs[warp] +
                     __popc(ballot & ((1u << lane) - 1u));
    if (((ballot >> lane) & 1u) && rank < size) out[rank] = i;
    if (starts && i % seg == 0) starts[i / seg] = rank;
  }
  if (i < size && i >= *count) out[i] = 0;  // the padding
}

}  // namespace vx
