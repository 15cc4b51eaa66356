// K9, the adaptive thick-ray opaque frame: its four kernels. Included by
// kernels.cu after the deferred stages (it uses FrameParams, HitRec,
// gen_ray, write_sky and composite from there).
//
// Replaces (JAX package, voxelrs_tpu/ops/shading.py): the adaptive block
// of _opaque_frame_body (:3773-3895) and its two-pass shadow (:4019-4034):
//   k9_trace        the coarse trace of a grid level and the re-trace of a
//                   refine list (trace in _opaque_pipeline :1677 through
//                   coarse_rays*, coarse_sub_ids :2133, pix_rays_jit), each
//                   lane floored at its own pixel's tile floor (_fl :3805);
//                   a refine lane's record goes straight into its slot of
//                   the merged grid (merge_refined :2157);
//   k9_merge        _make_frozen_merge (:1966-2119), one level: lo grid ->
//                   hi grid, with the exact fill of interior lanes whose
//                   four corners hit one flat surface;
//   k9_finalize     _finalize_lanes (:1894) with the carried values
//                   (refine_values :1918): record -> HitRec, hit flag, sky;
//   k9_shadow_cells shadow_mask1 (:2170) and the dense-frame decision
//                   (step 1), _shadow_cell_merge (:2172) with
//                   shadow_combine (:2192) applied to the frame (step 2).
//
// A grid level k has (w_k, h_k) lanes, w_{k+1} = w_k / 2 + 1 (level 0 = the
// pixels); lane (y, x) of level k samples lane (min(2y, h_{k-1} - 1),
// min(2x, w_{k-1} - 1)) of level k - 1, down to its pixel
// (_coarse_grid_for :1161-1206). A record (K9Rec) is the frozen state of
// an opaque trace: t_min, the leaf's slot and scale, its base in the
// mirrored [1, 2) space, its value and the face axis and ray octant the
// merge compares. The JAX record holds node pointers instead of the value
// and refetches it; here the traversal hands the value out at its hit.
//
// Design: one thread per lane; counts stay in device memory (K6's), and
// every kernel reads its count and exits past it, so a frame makes no host
// round trip. The arithmetic is the plain version's
// operation for operation (-fmad=false): the fill's t_int == tcmin and
// plane equalities decide which pixels are filled, and the mantissa
// quantization of the leaf base is done on the bits.
//
// K10 (voxelrs_tpu/ops/shading.py::render_frames_opaque_batch :3580, a
// lax.map of the frame over N poses) is these kernels with a pose
// dimension: one launch covers the lanes of every pose, pose-major (lane =
// pose * n_k + lane of the pose for a level of n_k lanes), each pose's
// camera read from `cams` (kernels.cu pose_params) and its tile floors
// from its block of `tf`. A merge reads the corners of its own pose only:
// a level's grid holds its last row and column, so the poses cannot be
// stacked as one tall frame. The shadow cells decide each pose's dense
// flag from that pose's own hit count (K6's segment starts `hstart`).
// One frame is the case n_poses = 1 with cams and hstart null.
//
// What bounds them on an H100: k9_trace is the traversal (K1 / K4,
// dependent loads). A launch lasts as long as its slowest warp's chain of
// steps (the longest rays take ~140 steps, a warp's lanes ~0.7 of its
// longest on average), so its shape shortens each step's wait: the stack
// in shared memory instead of local memory, the ESVO cursor's child
// pointer loaded beside the descriptor, 4x8 pixel tiles a warp on the
// whole grid (its rays leave from one patch), 64-thread blocks, and a grid
// no larger than the card holds at once (kernels.cu k9_trace_launch), so a
// refine list's launch schedules no empty blocks past its count. The merge reads four 32-byte records and writes one, with
// some seventy float operations where a lane's corners agree (bytes
// bound); finalize and the shadow cells are bytes bound.

#pragma once

namespace vx {

struct K9Rec {
  float t;            // t_min in octree units
  uint32_t idxscale;  // child slot | scale << 8
  float pos[3];       // leaf base, mirrored [1, 2) space
  uint32_t value;     // leaf value
  uint32_t flags;     // hit | face axis << 1 | ray octant << 3
  uint32_t pad;
};

// (w, h) of grid level `level` of a width x height frame.
__device__ __forceinline__ void k9_dims(int width, int height, int level,
                                        int& w, int& h) {
  w = width;
  h = height;
  for (int k = 0; k < level; ++k) {
    w = w > 1 ? w / 2 + 1 : 1;
    h = h > 1 ? h / 2 + 1 : 1;
  }
}

// The pixel (flat, row-major) of lane `lane` of grid level `level`.
__device__ __forceinline__ int k9_pixel(const FrameParams& fp, int level,
                                        int lane) {
  int wl, hl;
  k9_dims(fp.width, fp.height, level, wl, hl);
  int y = lane / wl, x = lane % wl;
  for (int k = level; k > 0; --k) {
    int wk, hk;
    k9_dims(fp.width, fp.height, k - 1, wk, hk);
    y = min(2 * y, hk - 1);
    x = min(2 * x, wk - 1);
  }
  return y * fp.width + x;
}

__device__ __forceinline__ int k9_octant(const float* rd) {
  return (int)(copysign_epsilon(rd[0]) > 0.f) |
         ((int)(copysign_epsilon(rd[1]) > 0.f) << 1) |
         ((int)(copysign_epsilon(rd[2]) > 0.f) << 2);
}

// Lane (y, x) of a w x h grid is a sample of the grid above it: even, or
// the last row / column (sample_masks).
__device__ __forceinline__ bool k9_is_sample(int y, int x, int w, int h) {
  return ((y & 1) == 0 || y == h - 1) && ((x & 1) == 0 || x == w - 1);
}

// _bucket_size (:1208) and _margin_bucket (:458): the JAX package's
// first-frame hit bucket; the frame is dense when it covers a third of the
// pixels (:3912).
__device__ __forceinline__ long long k9_bucket(long long c) {
  if (c <= 256) return 256;
  const long long p = 1LL << (64 - __clzll(c - 1));
  return c <= (p * 3) / 4 ? (p * 3) / 4 : p;
}

__device__ __forceinline__ bool k9_dense(long long hits, long long B) {
  long long k = k9_bucket(hits + hits / 2 + 256);
  if (k < 8192) k = 8192;
  return k >= B / 3;
}

// Threads of a K9 trace block (kernels.cu k9_trace_launch).
constexpr int K9_TRACE_THREADS = 64;

// Work item m of a trace launch -> its lane, or -1. A refine list: lane
// idx[m]. The whole grid: item m is lane (l >> 3, l & 7) of 4x8 tile
// m / 32 (row-major tiles of each pose's (wl, hl) grid, poses one after
// another), so a warp's rays leave from a compact patch of pixels.
__device__ __forceinline__ int k9_trace_lane(int m, const int* __restrict__ idx,
                                             int wl, int hl) {
  if (idx) return idx[m];
  const int tx = (wl + 7) >> 3, ty = (hl + 3) >> 2;
  const int t = m >> 5, l = m & 31;
  const int pose = t / (tx * ty), tp = t - pose * tx * ty;
  const int y = (tp / tx) * 4 + (l >> 3), x = (tp % tx) * 8 + (l & 7);
  return y < hl && x < wl ? pose * wl * hl + y * wl + x : -1;
}

// One thread per work item of grid level `level` (k9_trace_lane: idx null,
// items m < size; else the refine list's entries m < *count), a block
// looping over items gridDim.x * K9_TRACE_THREADS apart: the opaque trace
// of the lane's pixel ray from the pixel's tile floor (tf null =
// unfloored), its record into out[lane]. A lane's pose is lane / (the
// level's lane count). The traversal stack lives in the block's shared
// memory (World::trace_shared).
template <class World>
__global__ void __launch_bounds__(K9_TRACE_THREADS)
k9_trace_kernel(World world, float octree_scale, FrameParams fp,
                const float* __restrict__ cams, const float* __restrict__ tf,
                int ntx, int level, const int* __restrict__ idx,
                const int* __restrict__ count, int size,
                K9Rec* __restrict__ out) {
  __shared__ uint32_t s_node[STACK_HEIGHT * K9_TRACE_THREADS];
  __shared__ float s_tmax[STACK_HEIGHT * K9_TRACE_THREADS];
  int wl, hl;
  k9_dims(fp.width, fp.height, level, wl, hl);
  const int items = idx ? count_of(count, size) : size;
  for (int m = blockIdx.x * K9_TRACE_THREADS + threadIdx.x; m < items;
       m += gridDim.x * K9_TRACE_THREADS) {
    const int lane = k9_trace_lane(m, idx, wl, hl);
    if (lane < 0) continue;
    const int pose = lane / (wl * hl);
    const FrameParams f = pose_params(fp, cams, pose);
    const int px = k9_pixel(fp, level, lane - pose * wl * hl);
    float rd[3];
    gen_ray(f, px, rd);
    const float* tfp = pose_floors(fp, tf, ntx, pose);
    const float t_floor =
        tfp ? tfp[((px / fp.width) >> 3) * ntx + ((px % fp.width) >> 3)]
            : 0.f;
    const TexTables no_tables = {};  // the opaque cast reads no texture
    Hit p;
    world.trace_shared(
        octree_scale, f.cam_pos[0], f.cam_pos[1], f.cam_pos[2], rd[0], rd[1],
        rd[2], -1.f, fp.primary_budget, 0, no_tables, p, tf != nullptr,
        t_floor,
        SharedStack::Source{s_node + threadIdx.x, s_tmax + threadIdx.x,
                            K9_TRACE_THREADS});
    K9Rec r = {};
    if (p.t != -1.f) {
      r.t = p.t_oct;
      r.idxscale = (uint32_t)p.idx | ((uint32_t)p.scale << 8);
      r.pos[0] = p.leaf[0];
      r.pos[1] = p.leaf[1];
      r.pos[2] = p.leaf[2];
      r.value = p.value;
      r.flags = 1u | ((uint32_t)(p.face >> 1) << 1) |
                ((uint32_t)k9_octant(rd) << 3);
    }
    out[lane] = r;
  }
}

// The entry plane of a record's leaf on its face axis.
__device__ __forceinline__ float k9_plane(const K9Rec& r) {
  const int axis = (int)((r.flags >> 1) & 3u);
  const float se = exp2_scale((int)(r.idxscale >> 8));
  return axis == 0 ? r.pos[0] + se
                   : (axis == 1 ? r.pos[1] + se : r.pos[2] + se);
}

__device__ __forceinline__ float k9_quant(float m, uint32_t sc) {
  return __uint_as_float((__float_as_uint(m) >> sc) << sc);
}

// One thread per lane i of grid level `level` (the hi grid) from the
// records `lo` of level + 1: a sample lane takes its corner's record; an
// interior lane whose four corners hit the same value, face axis, entry
// plane, leaf scale and ray octant, and whose own ray enters that plane's
// leaf there (its own entry face, t_int == tcmin, inside the cube), gets
// the synthesized record of that leaf (the fill); the others get an empty
// record and, unless all four corners missed, refine[i] = 1. Lane g of
// the n lanes is lane i of pose g / (wh * hh), whose corners are its own
// pose's records.
__global__ void __launch_bounds__(BLOCK)
k9_merge_kernel(float octree_scale, FrameParams fp,
                const float* __restrict__ cams, int level,
                const K9Rec* __restrict__ lo, K9Rec* __restrict__ hi,
                uint8_t* __restrict__ refine, int n) {
  int wh, hh, wl, hl;
  k9_dims(fp.width, fp.height, level, wh, hh);
  k9_dims(fp.width, fp.height, level + 1, wl, hl);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int pose = g / (wh * hh), i = g - pose * wh * hh;
  lo += (size_t)pose * wl * hl;
  const int y = i / wh, x = i % wh;
  const int cy = y >> 1, cx = x >> 1;
  const int cy1 = min(cy + 1, hl - 1), cx1 = min(cx + 1, wl - 1);
  const K9Rec a00 = lo[cy * wl + cx], a01 = lo[cy * wl + cx1];
  const K9Rec a10 = lo[cy1 * wl + cx], a11 = lo[cy1 * wl + cx1];
  const bool ylast = y == hh - 1, xlast = x == wh - 1;
  if (k9_is_sample(y, x, wh, hh)) {
    hi[g] = ylast && xlast ? a11 : (ylast ? a10 : (xlast ? a01 : a00));
    refine[g] = 0;
    return;
  }
  const bool h00 = a00.flags & 1u, h01 = a01.flags & 1u;
  const bool h10 = a10.flags & 1u, h11 = a11.flags & 1u;
  const bool miss4 = !(h00 || h01 || h10 || h11);
  K9Rec r = {};
  bool smooth = false;
  const uint32_t surf = a00.flags >> 1;  // face axis and ray octant
  const float plane00 = k9_plane(a00);
  if (h00 && h01 && h10 && h11 && a01.value == a00.value &&
      a10.value == a00.value && a11.value == a00.value &&
      (a01.flags >> 1) == surf && (a10.flags >> 1) == surf &&
      (a11.flags >> 1) == surf && k9_plane(a01) == plane00 &&
      k9_plane(a10) == plane00 && k9_plane(a11) == plane00 &&
      (a01.idxscale >> 8) == (a00.idxscale >> 8) &&
      (a10.idxscale >> 8) == (a00.idxscale >> 8) &&
      (a11.idxscale >> 8) == (a00.idxscale >> 8)) {
    const int axis00 = (int)(surf & 3u);
    const int scale00 = (int)(a00.idxscale >> 8);
    const FrameParams f = pose_params(fp, cams, pose);
    float rd[3];
    gen_ray(f, k9_pixel(fp, level, i), rd);
    const RayConsts c = ray_consts(octree_scale, f.cam_pos[0], f.cam_pos[1],
                                   f.cam_pos[2], rd[0], rd[1], rd[2]);
    // the pixel's own ray meets the shared plane at t_int
    const float se = exp2_scale(scale00);
    const float tc_ax = axis00 == 0 ? c.tcx : (axis00 == 1 ? c.tcy : c.tcz);
    const float tb_ax = axis00 == 0 ? c.tbx : (axis00 == 1 ? c.tby : c.tbz);
    const float t_int = plane00 * tc_ax - tb_ax;
    // hit point in mirrored [1, 2) space -> leaf base by mantissa
    // quantization; the face axis takes the plane itself
    float hx = c.rox + t_int * c.rdx;
    float hy = c.roy + t_int * c.rdy;
    float hz = c.roz + t_int * c.rdz;
    if (c.mx) hx = 3.f - hx;
    if (c.my) hy = 3.f - hy;
    if (c.mz) hz = 3.f - hz;
    const uint32_t sc = (uint32_t)clampi(scale00, 0, 31);
    const float base_ax = plane00 - se;
    const float posx = axis00 == 0 ? base_ax : k9_quant(hx, sc);
    const float posy = axis00 == 1 ? base_ax : k9_quant(hy, sc);
    const float posz = axis00 == 2 ? base_ax : k9_quant(hz, sc);
    // the plane must be the pixel's own entry face of that leaf
    const float t2x = (posx + se) * c.tcx - c.tbx;
    const float t2y = (posy + se) * c.tcy - c.tby;
    const float t2z = (posz + se) * c.tcz - c.tbz;
    const float tcmin = fmaxf(fmaxf(t2x, t2y), t2z);
    const bool on_x = tcmin == t2x;
    const bool on_y = !on_x && tcmin == t2y;
    const int axis_own = on_x ? 0 : (on_y ? 1 : 2);
    const float t_cube_exit =
        fminf(fminf(c.tcx - c.tbx, c.tcy - c.tby), c.tcz - c.tbz);
    smooth = c.octant_mask == (int)(surf >> 2) && axis_own == axis00 &&
             t_int == tcmin && t_int > 0.f && t_int <= t_cube_exit;
    if (smooth) {
      r.t = t_int;
      r.idxscale = (uint32_t)scale00 << 8;
      r.pos[0] = posx;
      r.pos[1] = posy;
      r.pos[2] = posz;
      r.value = a00.value;
      r.flags = 1u | (surf << 1);
    }
  }
  hi[g] = r;
  refine[g] = (!smooth && !miss4) ? 1 : 0;
}

// One thread per pixel of each pose: the record's hit (its ray's
// finalize, through the traversal's own device functions) as the deferred
// frame's HitRec and hit flag, or a miss and its sky; clears the
// pixel-space shadow masks (needp, blkp) the shadow cells read.
__global__ void __launch_bounds__(BLOCK)
k9_finalize_kernel(float octree_scale, FrameParams fp,
                   const float* __restrict__ cams, int n_poses,
                   const K9Rec* __restrict__ frec, HitRec* __restrict__ rec,
                   uint8_t* __restrict__ hit, float* __restrict__ img,
                   uint8_t* __restrict__ needp, uint8_t* __restrict__ blkp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = fp.width * fp.height;
  if (i >= B * n_poses) return;
  const int pose = i / B;
  const FrameParams f = pose_params(fp, cams, pose);
  const K9Rec r = frec[i];
  float rd[3];
  gen_ray(f, i - pose * B, rd);
  needp[i] = 0;
  blkp[i] = 0;
  HitRec o = {};
  o.t = -1.f;
  if (r.flags & 1u) {
    const RayConsts c = ray_consts(octree_scale, f.cam_pos[0], f.cam_pos[1],
                                   f.cam_pos[2], rd[0], rd[1], rd[2]);
    const HitGeom g = hit_geometry(c, octree_scale, (int)(r.idxscale >> 8),
                                   r.pos[0], r.pos[1], r.pos[2], r.t);
    Hit h;
    finalize_hit(c, octree_scale, g, r.t, r.value, h);
    o.t = h.t;
    o.value = h.value;
    o.face = h.face;
    for (int k = 0; k < 3; ++k) o.pos[k] = h.pos[k];
    o.u = h.u;
    o.v = h.v;
    o.lod = h.lod;
    hit[i] = 1;
  } else {
    hit[i] = 0;
    write_sky(f, rd, img + 4 * (size_t)i);
  }
  rec[i] = o;
}

// One thread per compacted hit lane j < size (pixel hidx[j], j < *hcount).
// Step 1: the pixel-space need (needp), the dense flag of each pose's hit
// count (dense[pose]), and the pass-1 shadow candidates (mask): on a dense
// frame those on the half grid's sample pixels, else all of them (the
// single pass). Step 2 (after pass 1 left its verdicts in blkp): on a
// dense frame, an interior pixel whose four cell corners agree on need and
// verdict and need a shadow reuses the corners' verdict (a blocked one is
// composited here, with kd_finish's colour); the rest of its candidates
// are the pass-2 mask. A batch's hit lanes are pose-major (the pose of
// lane hidx[j] is hidx[j] / (W * H)); pose q's hits run from hstart[q] to
// the next pose's start (hstart null: one frame, all the hits).
__device__ __forceinline__ int k9_pose_hits(const int* __restrict__ hstart,
                                            int n_poses, int n, int q) {
  if (!hstart) return n;
  return (q + 1 < n_poses ? hstart[q + 1] : n) - hstart[q];
}

__global__ void __launch_bounds__(BLOCK)
k9_shadow_cells_kernel(int step, FrameParams fp, const int* __restrict__ hidx,
                       const int* __restrict__ hcount,
                       const int* __restrict__ hstart, int n_poses, int size,
                       const uint8_t* __restrict__ need,
                       uint8_t* __restrict__ needp,
                       const uint8_t* __restrict__ blkp,
                       uint8_t* __restrict__ mask, int* __restrict__ dense_out,
                       const float4* __restrict__ color,
                       const float* __restrict__ ds, float* __restrict__ img) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= size) return;
  const int W = fp.width, H = fp.height, B = W * H;
  const int n = count_of(hcount, size);
  if (step == 1 && j < n_poses)
    dense_out[j] = k9_dense(k9_pose_hits(hstart, n_poses, n, j), B) ? 1 : 0;
  if (j >= n) {
    mask[j] = 0;
    return;
  }
  const int g = hidx[j];  // the lane: pose * B + pixel
  const int pose = g / B, base = pose * B, p = g - base;
  const bool dense = k9_dense(k9_pose_hits(hstart, n_poses, n, pose), B);
  const bool nd = need[j] != 0;
  const int y = p / W, x = p % W;
  const bool sample = k9_is_sample(y, x, W, H);
  if (step == 1) {
    needp[g] = nd ? 1 : 0;
    mask[j] = (nd && (!dense || sample)) ? 1 : 0;
    return;
  }
  if (!dense || sample) {
    mask[j] = 0;
    return;
  }
  // the cell corners: half-grid lanes and their pixels, in the same pose
  const int hc = H / 2 + 1, wc = W / 2 + 1;
  const int cy = y >> 1, cx = x >> 1;
  const int cy1 = min(cy + 1, hc - 1), cx1 = min(cx + 1, wc - 1);
  const int r0 = base + min(2 * cy, H - 1) * W;
  const int r1 = base + min(2 * cy1, H - 1) * W;
  const int c0 = min(2 * cx, W - 1), c1 = min(2 * cx1, W - 1);
  const int q00 = r0 + c0, q01 = r0 + c1, q10 = r1 + c0, q11 = r1 + c1;
  const uint8_t n00 = needp[q00], b00 = blkp[q00];
  const bool reuse = n00 && needp[q01] == n00 && needp[q10] == n00 &&
                     needp[q11] == n00 && blkp[q01] == b00 &&
                     blkp[q10] == b00 && blkp[q11] == b00;
  if (reuse) {
    if (nd && b00) composite(fp, color[j], ds[j], 0.f, img + 4 * (size_t)g);
    mask[j] = 0;
  } else {
    mask[j] = nd ? 1 : 0;
  }
}

}  // namespace vx
