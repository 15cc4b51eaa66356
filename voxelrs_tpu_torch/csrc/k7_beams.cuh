// K7: conservative ray-entry floors from the terrain envelope — a group of
// K7_GROUP lanes per 8x8 pixel tile for the primary rays, one thread per
// ray for the shadow rays, both marching the max-pyramid of the
// column-top envelope.
//
// Replaces voxelrs_tpu/ops/beams.py::tile_floors (:137) with its
// _envelope_march (:52) and _dir_for, and ::shadow_ray_floors (:309);
// ::pixel_floors (:289) is not materialized: the deferred primary kernel
// reads tf[py / 8][px / 8] in its place. The TPU version runs the march as
// a lock-step while_loop over all lanes with one-hot level-offset lookups
// (ops/smalltab.py); here each tile's group (each shadow thread) runs its
// own loop and exits when its beam stops.
//
// The float operations, their order and their rounding are those of the
// plain PyTorch version (voxelrs_tpu_torch/ops/beams.py), so the two agree
// bit for bit (build with -fmad=false).
//
// What bounds it on an H100: neither bytes nor operations. 32,400 tiles at
// 1080p run a set-up of ~1,000 float operations (5 directions, 16 corner
// distances, 25 near boxes; ~80 IEEE divisions) and up to 96 dependent
// march iterations, each one load from the pyramid (5.3 KB for the bench,
// 341 KB for the game) and ~30 float operations; one thread a tile is
// under a quarter of one wave of the card's 132 SMs, and its time is the
// longest beam's chain. So a group of lanes takes a tile: the set-up's
// parts run on its lanes at once, and the march evaluates the current
// level and the levels below it on its lanes at the same t, so the chain
// is the beam's advances (envelope_march_group), not its advances and
// descents; a pyramid that fits is read from shared memory. The shadow
// kernel marches one candidate ray a thread (up to 48 iterations), on a
// grid of at most the blocks the card holds at once (k7_shadow_kernel).

#pragma once
#include <cuda_pipeline.h>

#include <cstdint>

namespace vx {

constexpr int MAX_BEAM_LEVELS = 16;
constexpr float BEAM_CELL = 8.f;  // envelope column footprint in voxels
constexpr float EPS_DIR = 0x1p-23f;

// Per-call inputs of K7 (mirrored by _build.BeamParams). The tile kernel
// reads the camera fields; the shadow kernel reads `fwd` as the direction
// toward the light.
struct BeamParams {
  int offsets[MAX_BEAM_LEVELS];  // level start offsets into the pyramid
  int n_levels;
  int n;  // level-0 columns per axis
  float hmax;
  int max_iters;
  int width, height;
  float cam_pos[3], right[3], up[3], fwd[3];
  float tan_half, aspect, max_dst;
  float near_h[25];    // (5, 5) exact envelope window around the camera
  float near_base[2];  // column coords (x, z) of near_h[0][0]
};

__device__ __forceinline__ float eps_dir(float d) {
  return fabsf(d) < EPS_DIR ? (d < 0.f ? -EPS_DIR : EPS_DIR) : d;
}

__device__ __forceinline__ float floor_finish(float beam) {
  return isfinite(beam) ? fmaxf(beam * (1.f - 0x1p-18f) - 0.01f, 0.f) : beam;
}

__device__ __forceinline__ void slab_box(float txa, float txb, float tya,
                                         float tyb, float tza, float tzb,
                                         float& t_in, float& t_out) {
  t_in = fmaxf(fmaxf(fminf(txa, txb), fminf(tya, tyb)), fminf(tza, tzb));
  t_out = fminf(fminf(fmaxf(txa, txb), fmaxf(tya, tyb)), fmaxf(tza, tzb));
}

// The max-pyramid 2D march (JAX _envelope_march): y_lo(t) = roy +
// t*(dy - sin_t) - m0 against the pyramid's cell maxima, descending near
// threats. +inf = no threat up to t_hard; the march's t when its
// iterations ran out.
__device__ float envelope_march(const int* __restrict__ levels,
                                const BeamParams& bp, float rox, float roy,
                                float roz, float dx, float dy, float dz,
                                float inv_x, float inv_z, float sin_t,
                                float m0, float t_start, float t_hard) {
  const int max_lvl = bp.n_levels - 1;
  const float slope = dy - sin_t;
  float t = t_start;
  int lvl = max_lvl;
  float stop_t = INFINITY;
  bool done = (t >= t_hard) || ((slope > 0.f) && (roy + t * slope - m0 > bp.hmax));
  for (int it = 0; it < bp.max_iters && !done; ++it) {
    const float s = (float)(8 << lvl);  // cell size in voxels
    const float px = rox + t * dx;
    const float pz = roz + t * dz;
    const float cx = floorf(px / s);
    const float cz = floorf(pz / s);
    const int nl = bp.n >> lvl;
    const float top = (float)(nl - 1);
    const int cxi = (int)fminf(fmaxf(cx, 0.f), top);
    const int czi = (int)fminf(fmaxf(cz, 0.f), top);
    const float hv = (float)__ldg(levels + bp.offsets[lvl] + cxi * nl + czi);
    // exit of the (virtual, unclamped) cell in xz
    const float bx = (cx + (dx > 0.f ? 1.f : 0.f)) * s;
    const float bz = (cz + (dz > 0.f ? 1.f : 0.f)) * s;
    float t_exit = fminf((bx - rox) * inv_x, (bz - roz) * inv_z);
    t_exit = fminf(fmaxf(t_exit, t), t_hard);
    const float y_lo = roy + (slope >= 0.f ? t : t_exit) * slope - m0;
    if (y_lo <= hv) {
      if (lvl == 0) {  // stop; the threat starts where y_lo crosses hv
        const float t_y = (roy - m0 - hv) / fmaxf(-slope, EPS_DIR);
        stop_t = slope >= 0.f ? t : fmaxf(t, t_y);
        done = true;
      } else {
        lvl -= 1;
      }
    } else {  // advance past the cell
      t = t_exit * (1.f + 0x1p-21f) + 0x1p-16f;
      lvl = lvl + 1 < max_lvl ? lvl + 1 : max_lvl;
      const bool rising = (slope > 0.f) && (roy + t * slope - m0 > bp.hmax);
      if (t >= t_hard || rising) done = true;
    }
  }
  if (isfinite(stop_t)) return stop_t;
  return done ? INFINITY : t;
}

// Pixel-grid direction as generate_rays maps pixel coordinates.
__device__ void beam_dir(const BeamParams& bp, float px, float py, float* d) {
  const float u = (px / (float)bp.width * 2.f - 1.f) * bp.aspect * bp.tan_half;
  const float v =
      (((float)bp.height - 1.f - py) / (float)bp.height * 2.f - 1.f) * bp.tan_half;
  for (int k = 0; k < 3; ++k) d[k] = u * bp.right[k] + v * bp.up[k] + bp.fwd[k];
  const float n = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  for (int k = 0; k < 3; ++k) d[k] = d[k] / n;
}

__device__ __forceinline__ float corner_dist(const float* ro, float x, float y,
                                             float z) {
  const float a = x - ro[0], b = y - ro[1], c = z - ro[2];
  return sqrtf(a * a + b * b + c * c);
}

// Threads of a tile-floor block (64 and 256 took longer on an H100), and
// the lanes of one tile's group (a power of two dividing 32; 4 took the
// least time of 2-32, see PERF.md: more lanes shorten the chain of a
// tile's descents but every lane issues the set-up's shared divisions
// and roots).
constexpr int K7_TILE_THREADS = 128;
constexpr int K7_GROUP = 4;
static_assert(K7_GROUP >= 2 && K7_GROUP <= 32 && 32 % K7_GROUP == 0,
              "a tile's group: 2, 4, 8, 16 or 32 lanes of one warp");
// the set-up's directions a lane: the centre (q = 0) and the 4 corner
// pixel rays (q = 1-4, corner (x0|x1, y0|y1) = bits 1, 0 of q - 1), q =
// lane, lane + K7_GROUP, ...
constexpr int K7_DIRS = (5 + K7_GROUP - 1) / K7_GROUP;
// the largest pyramid a tile block stages in shared memory (ints): the
// bench's 32 x 32 columns (1,365) fit, the game's 256 x 256 (87,381) do
// not and are read from global memory. A march step waits on its
// pyramid load; from shared memory the bench's tiles took 0.0110 ms
// against 0.0124 on an H100 (PERF.md)
constexpr int K7_STAGE_INTS = 4096;

// The pyramid's ints: the last level's offset and its cells.
__host__ __device__ __forceinline__ int k7_pyramid_ints(const BeamParams& bp) {
  const int nl = bp.n >> (bp.n_levels - 1);
  return bp.offsets[bp.n_levels - 1] + nl * nl;
}

// The group's values joined by fminf over xor shuffles: exact and
// order-free on these values (no NaN; a zero's sign cannot reach a floor,
// since floor_finish maps either zero to +0).
__device__ __forceinline__ float group_min(float v, unsigned gmask) {
#pragma unroll
  for (int o = 1; o < K7_GROUP; o <<= 1)
    v = fminf(v, __shfl_xor_sync(gmask, v, o));
  return v;
}

// envelope_march for one beam on a group of K7_GROUP lanes (lane `lane`,
// the group's first lane `base` of the warp; `live`: the group has a
// tile), with the descents in parallel: at the march's t, lane j
// evaluates level lvl - j with the loop's operations (its cell, hv,
// t_exit, y_lo); a ballot finds the first level from lvl down that is not
// threatened, where the loop advances after j descents, each spending one
// iteration of max_iters (a budget that runs out mid-descent returns t, as
// the loop does). If every level down to 0 is threatened the beam stops
// there with the loop's t_y. The cell size's reciprocal is exact (a power
// of two), so p * (1 / s) rounds the real quotient p / s does; the level
// offsets are read from shared memory (s_off). The whole warp runs the
// loop until its last group is done, every ballot and shuffle over all 32
// lanes, so the warp's groups step together and the warp takes its
// longest beam's chain (groups of a warp that diverged would take turns).
// Every lane of the group returns envelope_march's value.
template <bool STAGED>
__device__ float envelope_march_group(const int* __restrict__ levels,
                                      const int* s_off, const BeamParams& bp,
                                      float rox, float roy, float roz,
                                      float dx, float dy, float dz,
                                      float inv_x, float inv_z, float sin_t,
                                      float m0, float t_start, float t_hard,
                                      int lane, int base, bool live) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  const int max_lvl = bp.n_levels - 1;
  const float slope = dy - sin_t;
  float t = t_start;
  int lvl = max_lvl;
  float stop_t = INFINITY;
  bool done = (t >= t_hard) || ((slope > 0.f) && (roy + t * slope - m0 > bp.hmax));
  bool spent = false;  // the budget ran out
  int it = 0;
  bool active = live && !done && it < bp.max_iters;
  while (__any_sync(FULL, active)) {
    const int l = lvl - lane;  // this lane's level
    bool calm = false;         // level l is not threatened at t
    float hv = 0.f, t_exit = 0.f;
    if (active && l >= 0) {
      const float s = (float)(8 << l);  // cell size in voxels
      const float inv_s = __int_as_float((124 - l) << 23);  // 2^-(3+l)
      const float px = rox + t * dx;
      const float pz = roz + t * dz;
      const float cx = floorf(px * inv_s);
      const float cz = floorf(pz * inv_s);
      const int nl = bp.n >> l;
      const float top = (float)(nl - 1);
      const int cxi = (int)fminf(fmaxf(cx, 0.f), top);
      const int czi = (int)fminf(fmaxf(cz, 0.f), top);
      const int at = s_off[l] + cxi * nl + czi;
      hv = (float)(STAGED ? levels[at] : __ldg(levels + at));
      // exit of the (virtual, unclamped) cell in xz
      const float bx = (cx + (dx > 0.f ? 1.f : 0.f)) * s;
      const float bz = (cz + (dz > 0.f ? 1.f : 0.f)) * s;
      t_exit = fminf((bx - rox) * inv_x, (bz - roz) * inv_z);
      t_exit = fminf(fmaxf(t_exit, t), t_hard);
      const float y_lo = roy + (slope >= 0.f ? t : t_exit) * slope - m0;
      calm = !(y_lo <= hv);
    }
    unsigned calm_bits = __ballot_sync(FULL, calm) >> base;
    if (K7_GROUP < 32) calm_bits &= (1u << K7_GROUP) - 1u;
    const int j = calm_bits ? __ffs(calm_bits) - 1 : 0;
    // the advance's t_exit (lane j, calm) or level 0's hv (lane lvl)
    const float pub = __shfl_sync(
        FULL, calm ? t_exit : hv,
        base + (calm_bits ? j : (lvl < K7_GROUP ? lvl : 0)));
    if (active) {
      const int left = bp.max_iters - it;
      if (calm_bits) {  // j descents, then the advance past level lvl - j
        if (j >= left) {
          spent = true;  // the budget ran out mid-descent
        } else {
          t = pub * (1.f + 0x1p-21f) + 0x1p-16f;
          lvl = lvl - j + 1 < max_lvl ? lvl - j + 1 : max_lvl;
          it += j + 1;
          const bool rising =
              (slope > 0.f) && (roy + t * slope - m0 > bp.hmax);
          if (t >= t_hard || rising) done = true;
        }
      } else if (lvl < K7_GROUP) {  // lvl descents, the stop at level 0
        if (lvl >= left) {
          spent = true;
        } else {
          // the threat starts where y_lo crosses hv
          const float t_y = (roy - m0 - pub) / fmaxf(-slope, EPS_DIR);
          stop_t = slope >= 0.f ? t : fmaxf(t, t_y);
          done = true;
        }
      } else if (K7_GROUP >= left) {  // K7_GROUP descents
        spent = true;
      } else {
        lvl -= K7_GROUP;
        it += K7_GROUP;
      }
      active = !done && !spent && it < bp.max_iters;
    }
  }
  if (isfinite(stop_t)) return stop_t;
  return done ? INFINITY : t;
}

// A group of K7_GROUP lanes a tile: the (nty, ntx) floors, +inf = the tile
// misses. The set-up's parts that hold for every tile (the 8 + 8 corner
// distances of the occupied and the near box) run once a block, on warp
// 0; a tile's independent parts are spread across its group and joined by
// group_min: the centre and 4 corner directions and the 25 near boxes
// (part q on lane q mod K7_GROUP), each with the operations of the
// one-thread loop; the march is envelope_march_group, reading the
// pyramid from shared memory where STAGED (copied while the set-up runs).
// Lane 0 stores the floor. The rest of the set-up (a few divisions and
// roots) runs on every lane of the group: its issue slots grow with
// K7_GROUP, its chain does not.
template <bool STAGED>
__global__ void __launch_bounds__(K7_TILE_THREADS)
k7_tile_kernel(const int* __restrict__ levels,
               const float* __restrict__ bounds, BeamParams bp,
               float* __restrict__ out) {
  extern __shared__ int s_pyr[];  // STAGED: the whole pyramid
  if constexpr (STAGED) {  // copied while the set-up runs
    const int total = k7_pyramid_ints(bp);
    for (int q = threadIdx.x; q < total; q += K7_TILE_THREADS)
      __pipeline_memcpy_async(s_pyr + q, levels + q, sizeof(int));
    __pipeline_commit();
  }
  __shared__ int s_off[MAX_BEAM_LEVELS];
  __shared__ float s_near[25];
  __shared__ float s_far[2];  // far, d_far: the same for every tile
  const float* ro = bp.cam_pos;
  const float b0 = bounds[0], b1 = bounds[1], b2 = bounds[2], b3 = bounds[3];
  const float ccx = bp.near_base[0], ccz = bp.near_base[1];
  const float nbx0 = ccx * BEAM_CELL, nbz0 = ccz * BEAM_CELL;
  if (threadIdx.x < 32) {  // warp 0: the block's tile-independent set-up
    const int t = threadIdx.x;
    if (t < MAX_BEAM_LEVELS) s_off[t] = bp.offsets[t];
    if (t < 25) s_near[t] = bp.near_h[t];
    __syncwarp();
    // the farthest corner of the occupied box (t < 8) and of the near
    // box (8 <= t < 16), corner (a, b, c) = bits 2, 1, 0 of t
    const int a = (t >> 2) & 1, b = (t >> 1) & 1, c = t & 1;
    float v = 0.f;
    if (t < 8) {
      v = corner_dist(ro, a ? b1 : b0, b ? bp.hmax + 1.f : 0.f, c ? b3 : b2);
    } else if (t < 16) {
      float h_top = s_near[0];
      for (int q = 1; q < 25; ++q) h_top = fmaxf(h_top, s_near[q]);
      h_top = h_top + 1.f;
      v = corner_dist(ro, a ? nbx0 + 5.f * BEAM_CELL : nbx0, b ? h_top : 0.f,
                      c ? nbz0 + 5.f * BEAM_CELL : nbz0);
    }
    for (int o = 1; o < 8; o <<= 1)
      v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
    if (t == 0 || t == 8) s_far[t / 8] = v;
  }
  __syncthreads();
  const int ntx = (bp.width + 7) / 8, nty = (bp.height + 7) / 8;
  const int lane = threadIdx.x % K7_GROUP;
  const int base = threadIdx.x % 32 / K7_GROUP * K7_GROUP;
  const unsigned gmask =
      K7_GROUP >= 32 ? 0xFFFFFFFFu : ((1u << K7_GROUP) - 1u) << base;
  const int i =
      blockIdx.x * (K7_TILE_THREADS / K7_GROUP) + threadIdx.x / K7_GROUP;
  const bool live = i < ntx * nty;  // a group past the last tile marches
                                    // nothing and stores nothing
  const float x0 = (float)(i % ntx) * 8.f;
  const float x1 = fminf(x0 + 7.f, (float)(bp.width - 1));
  const float y0 = (float)(i / ntx) * 8.f;
  const float y1 = fminf(y0 + 7.f, (float)(bp.height - 1));
  float dq[K7_DIRS][3] = {};
#pragma unroll
  for (int m = 0; m < K7_DIRS; ++m) {
    const int q = lane + m * K7_GROUP;
    if (q < 5)
      beam_dir(bp, q == 0 ? (x0 + x1) * 0.5f : (q <= 2 ? x0 : x1),
               q == 0 ? (y0 + y1) * 0.5f : (q % 2 ? y0 : y1), dq[m]);
  }
  float dc[3];
  for (int k = 0; k < 3; ++k) dc[k] = __shfl_sync(gmask, dq[0][k], base);
  // cone half-angle: min cosine against the 4 corner pixel rays
  float cos_q = 1.f;
#pragma unroll
  for (int m = 0; m < K7_DIRS; ++m) {
    const int q = lane + m * K7_GROUP;
    if (q >= 1 && q < 5)
      cos_q = fminf(cos_q, dq[m][0] * dc[0] + dq[m][1] * dc[1] +
                               dq[m][2] * dc[2]);
  }
  const float cos_t = group_min(cos_q, gmask);
  const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f)) + 1e-4f;
  const float dx = eps_dir(dc[0]), dy = dc[1], dz = eps_dir(dc[2]);
  const float inv_x = 1.f / dx, inv_z = 1.f / dz;
  const float far = s_far[0], d_far = s_far[1];

  // hard stop: exit of the deviation-padded occupied box
  const float dy_safe = fabsf(dy) < EPS_DIR ? EPS_DIR : dy;
  const float pad_box = sin_t * far + 2.f;
  float t_entry, t_exit;
  slab_box((b0 - pad_box - ro[0]) * inv_x, (b1 + pad_box - ro[0]) * inv_x,
           (-pad_box - ro[1]) / dy_safe, (bp.hmax + pad_box - ro[1]) / dy_safe,
           (b2 - pad_box - ro[2]) * inv_z, (b3 + pad_box - ro[2]) * inv_z,
           t_entry, t_exit);
  float t_hard = t_exit >= fmaxf(t_entry, 0.f) ? fmaxf(t_exit, 0.f) : 0.f;
  if (bp.max_dst >= 0.f) t_hard = fminf(t_hard, bp.max_dst);

  // near field: 5x5 exact column boxes, slab-tested per tile (their
  // common lower y plane once)
  const float pad = sin_t * d_far + 1.f;
  const float ty_lo = (-pad - ro[1]) / dy_safe;
  float t_near = INFINITY;
  for (int q = lane; q < 25; q += K7_GROUP) {
    const float h = s_near[q];
    if (!(h > 0.f)) continue;
    const float bx0 = (ccx + (float)(q / 5)) * BEAM_CELL;
    const float bz0 = (ccz + (float)(q % 5)) * BEAM_CELL;
    float t_in, t_out;
    slab_box((bx0 - pad - ro[0]) * inv_x,
             (bx0 + BEAM_CELL + pad - ro[0]) * inv_x, ty_lo,
             (h + pad - ro[1]) / dy_safe, (bz0 - pad - ro[2]) * inv_z,
             (bz0 + BEAM_CELL + pad - ro[2]) * inv_z, t_in, t_out);
    const float lo = fmaxf(t_in, 0.f);
    if (t_out >= lo) t_near = fminf(t_near, lo);
  }
  t_near = group_min(t_near, gmask);

  // DDA start: the near box's exit, backed up by the deviation
  const float tx_far = ((dx > 0.f ? nbx0 + 5.f * BEAM_CELL : nbx0) - ro[0]) * inv_x;
  const float tz_far = ((dz > 0.f ? nbz0 + 5.f * BEAM_CELL : nbz0) - ro[2]) * inv_z;
  const float t_box = fmaxf(fminf(tx_far, tz_far), 0.f);
  const float d_xz = sqrtf(dx * dx + dz * dz);
  const float backup = (sin_t * t_box + 2.f) / fmaxf(d_xz, EPS_DIR);
  const float t_start = fmaxf(t_box - backup, 0.f);

  if constexpr (STAGED) {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  float beam = envelope_march_group<STAGED>(
      STAGED ? s_pyr : levels, s_off, bp, ro[0], ro[1], ro[2], dx, dy, dz,
      inv_x, inv_z, sin_t, 0.75f, t_start, t_hard, lane, base, live);
  // the 1-column dilation covers t*sin(theta) <= CELL - slack
  const float t8 = (BEAM_CELL - 1.f) / sin_t;
  if (!(isinf(beam) && t_hard <= t8)) beam = fminf(beam, t8);
  if (live && lane == 0) out[i] = floor_finish(fminf(beam, t_near));
}

// Threads of a shadow-floor block (k7_shadow_kernel).
constexpr int K7_SHADOW_THREADS = 128;

// The floor of output lane i's shadow ray (ray r = idx[i], or i): +inf =
// certainly reaches the light, 0 = no claim.
__device__ __forceinline__ float k7_shadow_floor(
    const int* __restrict__ levels_e, const int* __restrict__ h3d0,
    const float* __restrict__ bounds, const BeamParams& bp,
    const float* __restrict__ ro, const float* __restrict__ max_dst,
    const int* __restrict__ idx, int i) {
  const size_t r = idx ? (size_t)idx[i] : (size_t)i;
  const float rox = ro[3 * r], roy = ro[3 * r + 1], roz = ro[3 * r + 2];
  const float dx = eps_dir(bp.fwd[0]), dy = bp.fwd[1], dz = eps_dir(bp.fwd[2]);
  const float inv_x = 1.f / dx, inv_z = 1.f / dz;
  const float top = (float)(bp.n - 1);
  const int ccx = (int)fminf(fmaxf(floorf(rox / BEAM_CELL), 0.f), top);
  const int ccz = (int)fminf(fmaxf(floorf(roz / BEAM_CELL), 0.f), top);
  const float near = (float)__ldg(h3d0 + ccx * bp.n + ccz);
  // 1e-4 < the 1e-3 surface offset: a top-face origin reads exactly its
  // column top after rounding, and nothing can be hit within the offset
  const bool gate = (dy >= 0.2f) && (roy >= near - 1e-4f);
  const float d_xz = sqrtf(dx * dx + dz * dz);
  const float t_ring = BEAM_CELL / fmaxf(d_xz, EPS_DIR);

  // hard stop: exit of the (lightly padded) occupied box
  const float dy_safe = fabsf(dy) < EPS_DIR ? EPS_DIR : dy;
  float t_entry, t_exit;
  slab_box((bounds[0] - 1.f - rox) * inv_x, (bounds[1] + 1.f - rox) * inv_x,
           (-1.f - roy) / dy_safe, (bp.hmax + 1.f - roy) / dy_safe,
           (bounds[2] - 1.f - roz) * inv_z, (bounds[3] + 1.f - roz) * inv_z,
           t_entry, t_exit);
  float t_hard = t_exit >= fmaxf(t_entry, 0.f) ? fmaxf(t_exit, 0.f) : 0.f;
  const float md = max_dst ? max_dst[i] : -1.f;  // null: unbounded
  if (md >= 0.f) t_hard = fminf(t_hard, md + 1.f);

  const float beam = envelope_march(levels_e, bp, rox, roy, roz, dx, dy, dz,
                                    inv_x, inv_z, 0.f, 0.05f, t_ring, t_hard);
  return gate ? floor_finish(beam) : 0.f;
}

// The k output lanes' shadow floors: lanes below *count (count null: all
// k) get their ray's floor, the lanes at or past it are pads (0).
//
// What bounds it on an H100: the longest ray's chain of dependent pyramid
// loads (up to bp.max_iters = 48 iterations of the march), and, at the
// counts a frame leaves of the list's 2,073,600 lanes at 1080p, the blocks
// that find no ray and the pads' bytes (up to 8.3 MB). So the grid is at
// most the blocks the card holds at once (vx_k7_shadow), each block
// looping over the rays up to the count on the card, one ray a thread at a
// time (a march is long and its length varies), then over the pads in
// 4-lane words: a 16-byte zero store each, scalar stores where a word
// holds a ray or runs past k. out starts on a 16-byte word
// (_build.launch_k7_shadow checks).
__global__ void __launch_bounds__(K7_SHADOW_THREADS)
k7_shadow_kernel(const int* __restrict__ levels_e,
                 const int* __restrict__ h3d0,
                 const float* __restrict__ bounds, BeamParams bp,
                 const float* __restrict__ ro, const float* __restrict__ max_dst,
                 const int* __restrict__ idx, const int* __restrict__ count,
                 int k, float* __restrict__ out) {
  const int c = count ? *count : k;
  const int rays = c < 0 ? 0 : (c < k ? c : k);
  const int w0 = rays / 4;  // the word of the first pad
  const int items = rays + (rays < k ? (k + 3) / 4 - w0 : 0);
  for (int i = blockIdx.x * K7_SHADOW_THREADS + threadIdx.x; i < items;
       i += gridDim.x * K7_SHADOW_THREADS) {
    if (i < rays) {
      out[i] = k7_shadow_floor(levels_e, h3d0, bounds, bp, ro, max_dst, idx,
                               i);
      continue;
    }
    const int t0 = (w0 + (i - rays)) * 4;
    if (t0 >= rays && t0 + 4 <= k) {
      *reinterpret_cast<float4*>(out + t0) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int t = t0 < rays ? rays : t0; t < t0 + 4 && t < k; ++t)
        out[t] = 0.f;
    }
  }
}

}  // namespace vx
