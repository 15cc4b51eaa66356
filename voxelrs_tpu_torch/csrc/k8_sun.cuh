// K8: sun certificates — per shadow ray, one row of the per-voxel sun map
// proves the ray lit (it clears every column it can reach) or blocked (it
// pierces an opaque run), so the ray needs no trace.
//
// Replaces voxelrs_tpu/ops/beams.py::sun_verdict_masks (:379) and
// ::sun_lit_floors (:473). The table is world/heightfield.py's sun map:
// (n1*n1, 76+2K) u16 words, quarter-voxel fixed point (value = raw * 0.25
// - 1): [S_far, 25 near voxel tops, 25 near run tops, 25 near run bottoms,
// K band lows, K band highs]. It is uploaded as an int16 tensor and read
// here as 32-bit words. The TPU version gathers the row once per lane and
// runs the 25 window tests vectorized over the lane batch; here one thread
// runs them on its ray's row (two or four threads a ray, the windows
// split between them, took longer on an H100: PERF.md).
//
// The float operations, their order and their rounding are those of the
// plain PyTorch version (voxelrs_tpu_torch/ops/beams.py); build with
// -fmad=false.
//
// What bounds it on an H100: bytes. A ray reads its 12-byte origin and
// one (152 + 4K)-byte row (scattered by origin) and writes its flags;
// ~25 x 20 float operations are far below the card's rate. At the counts
// a frame leaves of the list's 2,073,600 lanes at 1080p, a grid of the
// list's capacity costs more than the rays (0.012 ms with no work on an
// H100, PERF.md), so the grid is at most the blocks the card holds at
// once, each block looping over the rays up to the count on the card,
// then over the pads as 16-byte zero words. A row is read as 16-, 8- or
// 4-byte words, the widest that its byte width and the table's start
// allow (the launch picks the instantiation; on an H100 16-byte words took
// 14% less time than 4-byte ones on the bench's map, 8-byte ones 1.6% less
// on the game's: PERF.md), and its 76 fixed fields are unpacked in
// registers. The 25 windows share their planes: the x0 + 1 of
// one window is the x0 of the next (integer-valued floats), so 6 + 6
// planes serve the overlap tests and 10 + 10 the lit claim's widened
// footprints, each the same operations on the same operands as the window
// computing it.

#pragma once
#include <cstdint>

#include "k7_beams.cuh"

namespace vx {

// Per-call inputs of K8 (mirrored by _build.SunParams).
struct SunParams {
  int n1;       // window columns per axis
  int width;    // row width, 76 + 2K
  float d_len;  // distance bound of a band-claimed blocker
  float margin;  // the lit claim's footprint margin in voxels (0 = JAX's)
  float d[3];   // unit direction toward the sun
  float origin[2];  // the window's (x, z) voxel offset
};

// Threads of a K8 block, and the output lanes a pad item zeroes: a
// 16-byte word of each flag array, or, where floors are written, a 16-byte
// word of floors and a 4-byte word of each flag array (so that a warp's
// stores are contiguous in every output).
constexpr int K8_THREADS = 128;
constexpr int K8_PAD_LANES = 16;
constexpr int K8_FLOOR_PAD_LANES = 4;
constexpr int K8_ROW_WORDS = 38;  // the 76 fixed fields as 32-bit words

__device__ __forceinline__ float sun_dec(uint32_t raw) {
  return (float)raw * 0.25f - 1.f;
}

// Field c (a u16 of the row; little-endian halves) of the row's words.
__device__ __forceinline__ uint32_t sun_field(const uint32_t* w, int c) {
  return (c & 1) ? w[c >> 1] >> 16 : w[c >> 1] & 0xFFFFu;
}

// The row's 76 fixed fields as 38 words, read WB bytes at a time (the row
// starts on a WB-byte word).
template <int WB>
__device__ __forceinline__ void sun_row_words(const uint16_t* __restrict__ row,
                                              uint32_t (&w)[K8_ROW_WORDS]) {
  if constexpr (WB == 16) {
    const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const uint4 v = __ldg(p + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row) + 18);
    w[36] = v.x;
    w[37] = v.y;
  } else if constexpr (WB == 8) {
    const uint2* p = reinterpret_cast<const uint2*>(row);
#pragma unroll
    for (int q = 0; q < 19; ++q) {
      const uint2 v = __ldg(p + q);
      w[2 * q] = v.x;
      w[2 * q + 1] = v.y;
    }
  } else {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int q = 0; q < K8_ROW_WORDS; ++q) w[q] = __ldg(p + q);
  }
}

// (lit, blocked) of a shadow ray from (rx, ry, rz) with distance limit md
// (< 0: unbounded).
template <int WB>
__device__ void sun_verdict(const uint16_t* __restrict__ sb,
                            const SunParams& sp, float rx, float ry, float rz,
                            float md, bool& lit_out, bool& blk_out) {
  const int K = (sp.width - 76) / 2;
  const float rox = rx - sp.origin[0];
  const float roz = rz - sp.origin[1];
  const float cx = floorf(rox), cz = floorf(roz);
  const float edge = (float)sp.n1 + 0.125f;
  const bool inw = rox >= -0.125f && rox < edge && roz >= -0.125f && roz < edge;
  lit_out = blk_out = false;
  if (!inw) return;  // no claim
  const float ccx = fminf(fmaxf(cx, 0.f), (float)(sp.n1 - 1));
  const float ccz = fminf(fmaxf(cz, 0.f), (float)(sp.n1 - 1));
  const size_t ci = (size_t)(int)ccx * (size_t)sp.n1 + (size_t)(int)ccz;
  const uint16_t* row = sb + ci * (size_t)sp.width;
  uint32_t w[K8_ROW_WORDS];
  sun_row_words<WB>(row, w);
  const float y = ry;
  const float dx = eps_dir(sp.d[0]), dy = sp.d[1], dz = eps_dir(sp.d[2]);
  const float inv_x = 1.f / dx, inv_z = 1.f / dz;
  const bool unbounded = md < 0.f;

  // the windows around the CLAMPED cell: x0 = ccx + ddx (ddx = -2..2)
  // and x0 + 1, as planes a = 0..5 (x0 + 1 of window ddx is plane ddx + 3)
  float px[6], pz[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    px[a] = (ccx + (float)(a - 2) - rox) * inv_x;
    pz[a] = (ccz + (float)(a - 2) - roz) * inv_z;
  }
  // the lit claim's footprints, widened by the margin (a ray within float
  // error of a higher neighbour's corner traces)
  float lxa[5], lxb[5], lza[5], lzb[5];
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    const float x0 = ccx + (float)(a - 2), z0 = ccz + (float)(a - 2);
    lxa[a] = (x0 - sp.margin - rox) * inv_x;
    lxb[a] = (x0 + 1.f + sp.margin - rox) * inv_x;
    lza[a] = (z0 - sp.margin - roz) * inv_z;
    lzb[a] = (z0 + 1.f + sp.margin - roz) * inv_z;
  }

  bool lit = y + 1e-4f >= sun_dec(sun_field(w, 0));
  bool kill = false, blk = false;
#pragma unroll
  for (int i = 0; i < 25; ++i) {
    const int a = i / 5, b = i % 5;
    const float h = sun_dec(sun_field(w, 1 + i));
    const float bt = sun_dec(sun_field(w, 26 + i));
    const float bb = sun_dec(sun_field(w, 51 + i));
    const float t_in = fmaxf(fminf(px[a], px[a + 1]), fminf(pz[b], pz[b + 1]));
    const float t_out =
        fminf(fmaxf(px[a], px[a + 1]), fmaxf(pz[b], pz[b + 1]));
    const float t_lo = fmaxf(t_in, 0.f);
    const bool over = t_out > t_lo;
    const float l_in = fmaxf(fminf(lxa[a], lxb[a]), fminf(lza[b], lzb[b]));
    const float l_out = fminf(fmaxf(lxa[a], lxb[a]), fmaxf(lza[b], lzb[b]));
    const float l_lo = fmaxf(l_in, 0.f);
    const float h_at = y + l_lo * dy;
    if (l_out > l_lo && h_at < h + 5e-4f + 1e-3f * l_lo) kill = true;
    // a hit is certain once the ray is >= bb + 1 inside the window and
    // still <= bt - 1 there (the division only where its claim can count)
    if (!blk && over && bt > 0.5f) {
      const float t_c = fmaxf(t_lo, (bb + 1.f - y) / dy);
      const float h_c = y + t_c * dy;
      if (t_c < t_out - 1e-2f && h_c <= bt - 1.f &&
          (unbounded || t_c <= md - 1.f))
        blk = true;
    }
  }
  if (!blk && (unbounded || md >= sp.d_len)) {
    // band j's low is field 76 + j, its high 76 + K + j: each word read once
    const uint32_t* row32 = reinterpret_cast<const uint32_t*>(row);
    int li = -1, hi = -1;
    uint32_t lw = 0, hw = 0;
    for (int j = 0; j < K && !blk; ++j) {
      const int cl = 76 + j, ch = 76 + K + j;
      if ((cl >> 1) != li) lw = __ldg(row32 + (li = cl >> 1));
      if ((ch >> 1) != hi) hw = __ldg(row32 + (hi = ch >> 1));
      const float lo = sun_dec((cl & 1) ? lw >> 16 : lw & 0xFFFFu);
      const float up = sun_dec((ch & 1) ? hw >> 16 : hw & 0xFFFFu);
      if (y >= lo + 1e-4f && y <= up - 1e-4f) blk = true;
    }
  }
  lit = lit && !kill;
  lit_out = lit;
  blk_out = blk && !lit;
}

// k output lanes: lane i < *count (count null: all k) reads ray idx[i]
// (or i); the lanes at or past it are pads (lit = blocked = todo = false,
// floor 0). max_dst null = all unbounded. Each output pointer may be
// null: lit / blk the verdicts, todo = valid && !lit && !blocked (the lanes
// left to trace), floors the lit-only view (+inf lit, else 0;
// sun_lit_floors). Every output starts on a 16-byte word
// (_build.check_k8). A grid of at most the blocks the card holds at once:
// each block loops over the rays, a thread a ray, then over the pads,
// K8_PAD_LANES (K8_FLOOR_PAD_LANES with floors) lanes an item as zero
// words, scalar stores where a word holds a ray or runs past k.
template <int WB>
__global__ void __launch_bounds__(K8_THREADS)
k8_sun_kernel(const uint16_t* __restrict__ sb, SunParams sp,
              const float* __restrict__ ro, const float* __restrict__ max_dst,
              const int* __restrict__ idx, const int* __restrict__ count,
              int k, uint8_t* __restrict__ lit_out,
              uint8_t* __restrict__ blk_out, uint8_t* __restrict__ todo_out,
              float* __restrict__ floors_out) {
  const int c = count ? *count : k;
  const int rays = c < 0 ? 0 : (c < k ? c : k);
  const int pl = floors_out ? K8_FLOOR_PAD_LANES : K8_PAD_LANES;
  const int w0 = rays / pl;  // the word of the first pad
  const int items = rays + (rays < k ? (k + pl - 1) / pl - w0 : 0);
  for (int i = blockIdx.x * K8_THREADS + threadIdx.x; i < items;
       i += gridDim.x * K8_THREADS) {
    if (i < rays) {
      const size_t r = idx ? (size_t)idx[i] : (size_t)i;
      bool lit, blk;
      sun_verdict<WB>(sb, sp, ro[3 * r], ro[3 * r + 1], ro[3 * r + 2],
                      max_dst ? max_dst[i] : -1.f, lit, blk);
      if (lit_out) lit_out[i] = lit ? 1 : 0;
      if (blk_out) blk_out[i] = blk ? 1 : 0;
      if (todo_out) todo_out[i] = (!lit && !blk) ? 1 : 0;
      if (floors_out) floors_out[i] = lit ? INFINITY : 0.f;
      continue;
    }
    const int t0 = (w0 + (i - rays)) * pl;
    const int lo = t0 < rays ? rays : t0;
    const int hi = t0 + pl < k ? t0 + pl : k;
    const bool whole = lo == t0 && hi == t0 + pl;
    uint8_t* flags[3] = {lit_out, blk_out, todo_out};
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      if (!flags[f]) continue;
      if (whole && pl == K8_PAD_LANES) {
        *reinterpret_cast<uint4*>(flags[f] + t0) = make_uint4(0u, 0u, 0u, 0u);
      } else if (whole) {
        *reinterpret_cast<uint32_t*>(flags[f] + t0) = 0u;
      } else {
        for (int t = lo; t < hi; ++t) flags[f][t] = 0;
      }
    }
    if (floors_out) {
      if (whole) {
        *reinterpret_cast<float4*>(floors_out + t0) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int t = lo; t < hi; ++t) floors_out[t] = 0.f;
      }
    }
  }
}

}  // namespace vx
