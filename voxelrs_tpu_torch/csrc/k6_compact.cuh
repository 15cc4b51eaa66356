// K6: stream compaction — the ascending indices of a mask's set lanes,
// truncated at `size` and padded with 0 to `size`, and the number of set
// lanes in device memory.
//
// Replaces voxelrs_tpu/ops/shading.py::compact_indices (:313), i.e.
// jnp.nonzero(mask, size=size, fill_value=0)[0]. The TPU version packs the
// mask into words and resolves each output slot's owner block with a
// scatter-max and a cummax, because a TPU has no cheap per-lane atomics or
// ballots; here one pass over the mask ranks the lanes directly.
//
// Design: one launch, a single-pass scan with decoupled look-back (Merrill
// & Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016). The mask is cut into tiles of K6_TILE lanes; a block takes tile
// after tile from an atomic counter (not blockIdx, so that a tile's
// predecessors are always held by running blocks: forward progress). A
// thread reads its 32 lanes with two 16-byte loads (bytes before the
// mask's first or past its last lane with scalar loads: a mask may start
// at any byte), keeps them as one 32-bit word and counts them with
// __popc; the block scans the counts, publishes the tile's count, looks
// back over its predecessors' status words (a warp reads 128 of them at a
// time) for its exclusive prefix, publishes its inclusive prefix, and
// writes each set lane's index: round r of a warp takes thread r's word
// by shuffle, so the 32 stores of a round go to consecutive slots. The
// holder of the last tile writes *count. The 0 padding past the count
// needs no count: a tile first sets its own slots (those of its lanes'
// indices; the last tile's run on to `size`) to 0 with 16-byte stores,
// then publishes its status. A set lane's rank is at most its index, so
// only this tile and later ones write indices into those slots, and a
// later one writes only after its look-back has read, directly or through
// a prefix, this tile's status (fences on both sides). With `starts` a
// pose batch (K10) also gets the rank of every seg-th lane, i.e. where
// each pose's set lanes begin in the output.
//
// Reuse of the scratch across calls on one stream: a status word is
// (epoch << 2 | flag) << 32 | value, with the call's epoch from the host
// (never 0), so a word left by an earlier call reads as not ready; the
// last block to take from the tile counter sets it back to 0 for the next
// call. The scratch is zeroed once when it is allocated.
//
// What bounds it on an H100: bytes — the mask read once (1 byte a lane)
// and every output slot written once (4 bytes); at 2,073,600 lanes that
// is about 10.4 MB, ~3.1 us at 3.35 TB/s (the kernel writes the set
// lanes' slots twice, 0 then the index). Above it: the launch, one load
// latency, and the look-back's chain of L2 reads.

#pragma once
#include <cstdint>

namespace vx {

constexpr int K6_THREADS = 256;              // threads of a block
constexpr int K6_LANES = 32;                 // mask lanes of a thread
constexpr int K6_TILE = K6_THREADS * K6_LANES;  // lanes of a tile: 8192
constexpr int K6_LOOKBACK = 4;               // status words a lane reads
constexpr unsigned K6_AGG = 1u, K6_PREFIX = 2u;  // status flags

// The scratch: [0] the tile counter, [1] unused, then from the first
// 8-byte boundary at or after int 2 the status words.
__device__ __forceinline__ unsigned long long* k6_status(int* scratch) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(scratch + 2);
  return reinterpret_cast<unsigned long long*>((p + 7) & ~(uintptr_t)7);
}

__device__ __forceinline__ unsigned long long k6_word(unsigned epoch,
                                                      unsigned flag, int v) {
  return ((unsigned long long)((epoch << 2) | flag) << 32) | (unsigned)v;
}

__device__ __forceinline__ void k6_publish(unsigned long long* s, int tile,
                                           unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(s + tile) = w;
}

__device__ __forceinline__ unsigned long long k6_read(
    const unsigned long long* s, int tile) {
  return *reinterpret_cast<const volatile unsigned long long*>(s + tile);
}

// The 32 lanes [v0 - off, v0 - off + 32) of the mask as bits (lane j of
// the thread = bit j); v0 counts from the 16-byte boundary at or before
// the mask (`off` bytes before it), so the two vector loads are aligned.
__device__ __forceinline__ unsigned k6_bits(const uint8_t* __restrict__ mask,
                                            long long n, int off,
                                            long long v0) {
  const long long i0 = v0 - off;
  unsigned bits = 0u;
  if (i0 >= 0 && i0 + K6_LANES <= n) {
    const uint4* p = reinterpret_cast<const uint4*>(mask + i0);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bits |= (unsigned)(((w[k] >> (8 * j)) & 0xffu) != 0u) << (4 * k + j);
    }
  } else {
    for (int j = 0; j < K6_LANES; ++j) {
      const long long i = i0 + j;
      if (i >= 0 && i < n && mask[i] != 0) bits |= 1u << j;
    }
  }
  return bits;
}

// Slots [lo, hi) of `out` set to 0 by the `nt` threads of a block: a
// scalar head to the first 16-byte boundary, int4 stores, a scalar tail.
__device__ __forceinline__ void k6_zero(int* __restrict__ out, long long lo,
                                        long long hi, int t, int nt) {
  if (lo >= hi) return;
  const uintptr_t a = reinterpret_cast<uintptr_t>(out + lo);
  long long head = (long long)(((16 - (a & 15)) & 15) / 4);
  if (head > hi - lo) head = hi - lo;
  if (t < head) out[lo + t] = 0;
  const long long v0 = lo + head, nvec = (hi - v0) / 4;
  int4* v = reinterpret_cast<int4*>(out + v0);
  for (long long k = t; k < nvec; k += nt) v[k] = make_int4(0, 0, 0, 0);
  const long long tail = v0 + nvec * 4;
  if (t < hi - tail) out[tail + t] = 0;
}

// out: size ints; count: 1 int; scratch: k6 scratch ints (zeroed at
// allocation; see _build.k6_blocks); epoch: this call's, 1..2^30-1;
// starts: null, or n / seg ints.
__global__ void __launch_bounds__(K6_THREADS)
k6_compact_kernel(const uint8_t* __restrict__ mask, int n, int off,
                  int ntiles, int size, int* __restrict__ out,
                  int* __restrict__ count, int* __restrict__ scratch,
                  unsigned epoch, int seg, int* __restrict__ starts) {
  __shared__ int s_tile, s_prefix, s_warp[K6_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long* status = k6_status(scratch);
  for (;;) {
    if (threadIdx.x == 0) {
      const int t = atomicAdd(scratch, 1);
      // the last claim of the launch (ntiles tiles + one empty claim a
      // block) puts the counter back for the next call
      if (t == ntiles + (int)gridDim.x - 1) atomicExch(scratch, 0);
      s_tile = t;
    }
    __syncthreads();
    const int tile = s_tile;
    if (tile >= ntiles) break;
    const long long v0 =
        (long long)tile * K6_TILE + (long long)threadIdx.x * K6_LANES;
    const unsigned bits = k6_bits(mask, n, off, v0);
    // the padding first: the tile's own slots (the last tile's run on to
    // `size`), which only this tile and later ones write indices into
    {
      const long long first = (long long)tile * K6_TILE - off;
      const long long lo = first > 0 ? first : 0;
      long long hi = tile == ntiles - 1 ? size : first + K6_TILE;
      if (hi > size) hi = size;
      k6_zero(out, lo, hi, threadIdx.x, K6_THREADS);
    }
    // the block's exclusive scan of its threads' counts
    const int c = __popc(bits);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, agg = 0;
#pragma unroll
    for (int w = 0; w < K6_THREADS / 32; ++w) {
      const int sw = s_warp[w];
      before += w < warp ? sw : 0;
      agg += sw;
    }
    // look back: warp 0 sums its predecessors' counts back to the nearest
    // inclusive prefix, K6_LOOKBACK * 32 status words a round
    if (warp == 0) {
      if (lane == 0) {
        __threadfence();  // the block's padding before its status
        k6_publish(status, tile,
                   k6_word(epoch, tile == 0 ? K6_PREFIX : K6_AGG, agg));
      }
      int prefix = 0;
      int top = tile - 1;  // the nearest predecessor not yet summed
      while (top >= 0) {
        int sum = 0;
        bool found = false, missing = false;
#pragma unroll
        for (int q = 0; q < K6_LOOKBACK; ++q) {
          const int j = top - lane * K6_LOOKBACK - q;
          if (found || missing || j < 0) continue;
          const unsigned long long w = k6_read(status, j);
          const unsigned hi = (unsigned)(w >> 32);
          if ((hi >> 2) != epoch || (hi & 3u) == 0u) {
            missing = true;
            continue;
          }
          sum += (int)(unsigned)w;
          found = (hi & 3u) == K6_PREFIX;
        }
        // the lanes up to the first one that found a prefix count; all of
        // them must have read ready words, or the round is read again
        const unsigned pref = __ballot_sync(0xffffffffu, found);
        const unsigned need =
            pref ? ((pref & (0u - pref)) << 1) - 1u : 0xffffffffu;
        const unsigned miss = __ballot_sync(0xffffffffu, missing);
        if (miss & need) {
          __nanosleep(32);
          continue;
        }
        int s = (need >> lane) & 1u ? sum : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        prefix += s;
        if (pref) break;
        top -= 32 * K6_LOOKBACK;
      }
      // the predecessors' padding (published before their status words)
      // before this block's indices
      __threadfence();
      if (lane == 0) {
        if (tile > 0)
          k6_publish(status, tile, k6_word(epoch, K6_PREFIX, prefix + agg));
        if (tile == ntiles - 1) *count = prefix + agg;
        s_prefix = prefix;
      }
    }
    __syncthreads();
    // round r: thread r's 32 lanes, each set one to its rank (b and run
    // are the same in every thread of the warp)
    int run = s_prefix + before;  // the rank of the warp's first set lane
    const long long wv = v0 - (long long)lane * K6_LANES - off;
    for (int r = 0; r < 32; ++r) {
      const unsigned b = __shfl_sync(0xffffffffu, bits, r);
      if (b == 0u && !starts) continue;
      const long long i = wv + (long long)r * K6_LANES + lane;
      const int rank = run + __popc(b & ((1u << lane) - 1u));
      if (starts && i >= 0 && i < n && i % seg == 0)
        starts[i / seg] = rank;
      if (((b >> lane) & 1u) && rank < size) out[rank] = (int)i;
      run += __popc(b);
    }
    __syncthreads();  // s_tile, s_prefix and s_warp are reused
  }
}

}  // namespace vx
