// K8: sun certificates — per shadow ray, one row of the per-voxel sun map
// proves the ray lit (it clears every column it can reach) or blocked (it
// pierces an opaque run), so the ray needs no trace.
//
// Replaces voxelrs_tpu/ops/beams.py::sun_verdict_masks (:379) and
// ::sun_lit_floors (:473). The table is world/heightfield.py's sun map:
// (n1*n1, 76+2K) u16 words, quarter-voxel fixed point (value = raw * 0.25
// - 1): [S_far, 25 near voxel tops, 25 near run tops, 25 near run bottoms,
// K band lows, K band highs]. It is uploaded as an int16 tensor and read
// here as uint16_t. The TPU version gathers the row once per lane and runs
// the 25 window tests vectorized over the lane batch; here one thread runs
// them on its own row.
//
// The float operations, their order and their rounding are those of the
// plain PyTorch version (voxelrs_tpu_torch/ops/beams.py); build with
// -fmad=false.
//
// What bounds it on an H100: bytes. A thread reads its 12-byte origin and
// one 2*(76+2K)-byte row (~150-200 bytes, scattered by origin) and writes
// two flags; ~25 x 20 float operations are far below the card's rate.

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

__device__ __forceinline__ float sun_dec(const uint16_t* __restrict__ row,
                                         int c) {
  return (float)__ldg(row + c) * 0.25f - 1.f;
}

// (lit, blocked) of a shadow ray from (rx, ry, rz) with distance limit md
// (< 0: unbounded).
__device__ void sun_verdict(const uint16_t* __restrict__ sb,
                            const SunParams& sp, float rx, float ry, float rz,
                            float md, bool& lit_out, bool& blk_out) {
  const int K = (sp.width - 76) / 2;
  const float rox = rx - sp.origin[0];
  const float roz = rz - sp.origin[1];
  const float cx = floorf(rox), cz = floorf(roz);
  const float edge = (float)sp.n1 + 0.125f;
  const bool inw = rox >= -0.125f && rox < edge && roz >= -0.125f && roz < edge;
  const float ccx = fminf(fmaxf(cx, 0.f), (float)(sp.n1 - 1));
  const float ccz = fminf(fmaxf(cz, 0.f), (float)(sp.n1 - 1));
  const size_t ci = (size_t)(int)ccx * (size_t)sp.n1 + (size_t)(int)ccz;
  const uint16_t* row = sb + ci * (size_t)sp.width;
  const float y = ry;
  const float dx = eps_dir(sp.d[0]), dy = sp.d[1], dz = eps_dir(sp.d[2]);
  const float inv_x = 1.f / dx, inv_z = 1.f / dz;
  const bool unbounded = md < 0.f;

  bool lit = y + 1e-4f >= sun_dec(row, 0);
  bool blk = false;
  int i = 0;
  for (int ddx = -2; ddx <= 2; ++ddx)
    for (int ddz = -2; ddz <= 2; ++ddz, ++i) {
      const float h = sun_dec(row, 1 + i);
      const float bt = sun_dec(row, 26 + i);
      const float bb = sun_dec(row, 51 + i);
      const float x0 = ccx + (float)ddx;  // windows around the CLAMPED cell
      const float z0 = ccz + (float)ddz;
      const float txa = (x0 - rox) * inv_x;
      const float txb = (x0 + 1.f - rox) * inv_x;
      const float tza = (z0 - roz) * inv_z;
      const float tzb = (z0 + 1.f - roz) * inv_z;
      const float t_in = fmaxf(fminf(txa, txb), fminf(tza, tzb));
      const float t_out = fminf(fmaxf(txa, txb), fmaxf(tza, tzb));
      const float t_lo = fmaxf(t_in, 0.f);
      const bool over = t_out > t_lo;
      // the lit claim's test, on the footprint widened by the margin (a
      // ray within float error of a higher neighbour's corner traces)
      const float lxa = (x0 - sp.margin - rox) * inv_x;
      const float lxb = (x0 + 1.f + sp.margin - rox) * inv_x;
      const float lza = (z0 - sp.margin - roz) * inv_z;
      const float lzb = (z0 + 1.f + sp.margin - roz) * inv_z;
      const float l_in = fmaxf(fminf(lxa, lxb), fminf(lza, lzb));
      const float l_out = fminf(fmaxf(lxa, lxb), fmaxf(lza, lzb));
      const float l_lo = fmaxf(l_in, 0.f);
      const float h_at = y + l_lo * dy;
      if (l_out > l_lo && h_at < h + 5e-4f + 1e-3f * l_lo) lit = false;
      // a hit is certain once the ray is >= bb + 1 inside the window and
      // still <= bt - 1 there
      const float t_c = fmaxf(t_lo, (bb + 1.f - y) / dy);
      const float h_c = y + t_c * dy;
      if (over && bt > 0.5f && t_c < t_out - 1e-2f && h_c <= bt - 1.f &&
          (unbounded || t_c <= md - 1.f))
        blk = true;
    }
  for (int j = 0; j < K; ++j) {
    const bool band = y >= sun_dec(row, 76 + j) + 1e-4f &&
                      y <= sun_dec(row, 76 + K + j) - 1e-4f;
    if (band && (unbounded || md >= sp.d_len)) blk = true;
  }
  lit_out = lit && inw;
  blk_out = blk && inw && !lit;
}

// One thread per output lane: lane i reads ray idx[i] (or i); lanes at or
// past *count are pads (lit = blocked = false, floor 0); max_dst null =
// all unbounded. Each output
// pointer may be null: lit / blk the verdicts, todo = valid && !lit &&
// !blocked (the lanes left to trace), floors the lit-only view (+inf lit,
// else 0; sun_lit_floors).
__global__ void __launch_bounds__(128)
k8_sun_kernel(const uint16_t* __restrict__ sb, SunParams sp,
              const float* __restrict__ ro, const float* __restrict__ max_dst,
              const int* __restrict__ idx, const int* __restrict__ count,
              int k, uint8_t* __restrict__ lit_out,
              uint8_t* __restrict__ blk_out, uint8_t* __restrict__ todo_out,
              float* __restrict__ floors_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const bool valid = !count || i < *count;
  bool lit = false, blk = false;
  if (valid) {
    const size_t r = idx ? (size_t)idx[i] : (size_t)i;
    sun_verdict(sb, sp, ro[3 * r], ro[3 * r + 1], ro[3 * r + 2],
                max_dst ? max_dst[i] : -1.f, lit, blk);  // null: unbounded
  }
  if (lit_out) lit_out[i] = lit ? 1 : 0;
  if (blk_out) blk_out[i] = blk ? 1 : 0;
  if (todo_out) todo_out[i] = (valid && !lit && !blk) ? 1 : 0;
  if (floors_out) floors_out[i] = lit ? INFINITY : 0.f;
}

}  // namespace vx
