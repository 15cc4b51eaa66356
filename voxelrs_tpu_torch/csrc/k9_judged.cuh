// K9-judged, the adaptive thick-ray frame of a translucent world: its three
// kernels. Included by kernels.cu after k9_adaptive.cuh (it uses
// FrameParams, HitRec, gen_ray, write_sky, tile_lane and TILE_THREADS from
// kernels.cu, and K9's grid geometry k9_dims, k9_pixel, k9_is_sample,
// k9_octant and k9_quant).
//
// Replaces (JAX package, voxelrs_tpu/ops/shading.py):
// _render_frame_judged_adaptive (:3183) -> _judged_frame_body (:3259):
//   k9j_trace     the judged trace of a grid level (the quarter grid
//                 :3318-3322, or the half grid :3348-3351) and of a refine
//                 list (:3332-3337, :3369-3374), each lane floored at its own
//                 pixel's tile floor; the trace's result tuple plus the
//                 accepted surface's identity (round_body :2282-2308); the
//                 scatter of merge_refined_res / merge_refined_res_full
//                 (:3023, :3033) folded in: a refine lane's record goes
//                 straight into its slot;
//   k9j_merge     one level of _make_res_merge (:2807-3002): lo grid -> hi
//                 grid, the result-level coplanar fill with the translucency
//                 guards (no corner passed a translucent texel; the per-mip
//                 hole table; with VOXELRS_HOLE_FILL=1 the pixel's own texel
//                 judged by K2);
//   k9j_finalize  the pixel records as the deferred frame's hit records,
//                 hit flags and sky, the shadow cells' masks cleared (kd_shade
//                 reads 9-word HitRecs; these records are 16 words).
// The shading, the two-pass shadow cells and the shadow stages are K9's and
// the deferred frame's (k9_shadow_cells, kd_shade, kd_shadow, kd_finish);
// the shadow rays are judged and certified by K8 where a sun map is attached
// (:3424-3449).
//
// A record (K9JRec, 16 words) is the lane's hit as kd_primary stores it
// (HitRec: t = -1 for a miss) and the accepted surface's identity that the
// merge compares: the leaf's scale, its entry plane in un-mirrored [1, 2]
// space (the JAX "h-space"; exact, a multiple of the leaf size), whether the
// ray passed a translucent texel (rejected a candidate leaf) before its
// accept, and whether it started inside a voxel. Unlike the opaque record
// (k9_adaptive.cuh), the surface is compared by its signed face and the
// un-mirrored plane, so corners of other ray octants can agree, and a fill
// carries the finalized hit itself: the merge finalizes the synthesized leaf
// through the traversal's finalize_hit.
//
// Design: the merge takes one thread a lane, the finalize is K9's
// (k9_finalize_block: a block's records, HitRecs and flags as 16-byte words
// through shared memory, only the first three 16-byte words of a record
// read); the trace has
// K9's trace's shape (k9_adaptive.cuh): 4x8 pixel tiles a warp on the
// whole grid, 64-thread blocks, the traversal stack in shared memory, the
// ESVO child pointer loaded beside its descriptor, a grid no larger than
// the card holds at once (kernels.cu k9j_trace_launch), each block looping
// up to the refine list's count, and a record stored as four 16-byte
// words. Counts stay in device memory (K6's), so the frame makes no host
// round trip. The arithmetic is the plain version's operation for
// operation (-fmad=false): the fill's t_int == tcmin and the equalities of
// plane and scale decide which pixels fill, the leaf base is quantized on
// the bits, and dl_cell rounds half to even (rintf, as jnp.round and
// torch.round do).
//
// What bounds them on an H100: k9j_trace is the traversal with its alpha
// judge (K1 / K4, dependent loads: a launch lasts as long as its slowest
// warp's chain of steps); the merge reads four 64-byte records and writes
// one (bytes bound; a fill adds some hundred float operations and a texel
// fetch); the finalize moves a record's two 32-byte sectors in and 38
// bytes out a pixel (bytes bound). The merge keeps its first shape: the
// records are twice the opaque frame's.

#pragma once

namespace vx {

// The judge of the judged frame's traces: make_alpha_fn's nearest texel at
// the nearest mip (JAX round_body :2275).
constexpr int K9J_ALPHA_MODE = 1;

// 16-byte aligned, so a record moves as four 16-byte words
struct __align__(16) K9JRec {
  HitRec h;         // the hit (t = -1: a miss, all other words 0)
  uint32_t inside;  // the ray started inside a voxel
  int scale;        // the accepted leaf's scale (0 on a miss)
  float plane;      // its entry plane, un-mirrored (0 on a miss)
  uint32_t passed;  // a candidate leaf was rejected on the way
  uint32_t pad[3];
};

// The entry plane of an accepted leaf (frozen at the accept: leaf base and
// scale in the mirrored [1, 2) space) on the face axis, un-mirrored with the
// ray's octant (round_body :2285-2295).
__device__ __forceinline__ float k9j_plane(const Hit& p, int octant) {
  const int axis = p.face >> 1;
  const float pm =
      (axis == 0 ? p.leaf[0] : (axis == 1 ? p.leaf[1] : p.leaf[2])) +
      exp2_scale(p.scale);
  return ((octant >> axis) & 1) ? 3.f - pm : pm;
}

// Threads of a K9-judged trace block (kernels.cu k9j_trace_launch).
constexpr int K9J_TRACE_THREADS = TILE_THREADS;

union K9JWords {
  K9JRec r;
  uint4 q[4];
};

// A record stored as four 16-byte words (p starts on one).
__device__ __forceinline__ void k9j_store(K9JRec* __restrict__ p,
                                          const K9JRec& r) {
  K9JWords u;
  u.r = r;
  uint4* w = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = u.q[k];
}

// One thread per work item of grid level `level` (kernels.cu tile_lane:
// idx null, the grid's lanes in 4x8 tiles a warp, items m < size; else the
// refine list's entries m < *count), a block looping over items gridDim.x
// * K9J_TRACE_THREADS apart: the judged trace of the lane's pixel ray from
// the pixel's tile floor (tf null = unfloored), its record into out[lane]
// as four 16-byte words. The traversal stack lives in the block's shared
// memory (World::trace_shared), as K9's trace keeps it.
template <class World>
__global__ void __launch_bounds__(K9J_TRACE_THREADS)
k9j_trace_kernel(World world, float octree_scale, TexTables tx,
                 FrameParams fp, const float* __restrict__ tf, int ntx,
                 int level, const int* __restrict__ idx,
                 const int* __restrict__ count, int size,
                 K9JRec* __restrict__ out) {
  __shared__ uint32_t s_node[STACK_HEIGHT * K9J_TRACE_THREADS];
  __shared__ float s_tmax[STACK_HEIGHT * K9J_TRACE_THREADS];
  const SharedStack::Source stack{s_node + threadIdx.x, s_tmax + threadIdx.x,
                                  K9J_TRACE_THREADS};
  int wl, hl;
  k9_dims(fp.width, fp.height, level, wl, hl);
  const int items = idx ? count_of(count, size) : size;
  for (int m = blockIdx.x * K9J_TRACE_THREADS + threadIdx.x; m < items;
       m += gridDim.x * K9J_TRACE_THREADS) {
    const int lane = tile_lane(m, idx, wl, hl);
    if (lane < 0) continue;
    const int px = k9_pixel(fp, level, lane);
    float rd[3];
    gen_ray(fp, px, rd);
    const float t_floor =
        tf ? tf[((px / fp.width) >> 3) * ntx + ((px % fp.width) >> 3)] : 0.f;
    Hit p;
    world.trace_shared(octree_scale, fp.cam_pos[0], fp.cam_pos[1],
                       fp.cam_pos[2], rd[0], rd[1], rd[2], -1.f,
                       fp.primary_budget, K9J_ALPHA_MODE, tx, p,
                       tf != nullptr, t_floor, stack);
    const bool hit = p.t != -1.f;
    K9JRec r = {};
    r.h.t = p.t;
    r.h.value = p.value;
    r.h.face = p.face;
    for (int k = 0; k < 3; ++k) r.h.pos[k] = p.pos[k];
    r.h.u = p.u;
    r.h.v = p.v;
    r.h.lod = p.lod;
    r.inside = p.inside ? 1u : 0u;
    r.scale = hit ? p.scale : 0;
    r.plane = hit ? k9j_plane(p, k9_octant(rd)) : 0.f;
    r.passed = p.passed ? 1u : 0u;
    k9j_store(out + lane, r);
  }
}

// One thread per lane i of grid level `level` (the hi grid) from the
// records `lo` of level + 1: a sample lane takes its corner's record. An
// interior lane whose four corners hit the same value, signed face, leaf
// scale and entry plane, none of them having passed a translucent texel, is
// filled when its own ray enters that plane's leaf there (the ray's sign on
// the face axis, its own entry face, t_int == tcmin, inside the cube) and
// the surface has no alpha-0 texel at the mip its tex_lod rounds to
// (hole[value][level], the (V, L) table of ops.adaptive_judged.hole_table)
// or, with hole_fill, the pixel's own texel there has alpha > 0. The others
// get a miss record and, unless all four corners missed, refine[i] = 1.
__global__ void __launch_bounds__(BLOCK)
k9j_merge_kernel(float octree_scale, TexTables tx, FrameParams fp, int level,
                 int hole_fill, const uint8_t* __restrict__ hole,
                 const K9JRec* __restrict__ lo, K9JRec* __restrict__ hi,
                 uint8_t* __restrict__ refine) {
  int wh, hh, wl, hl;
  k9_dims(fp.width, fp.height, level, wh, hh);
  k9_dims(fp.width, fp.height, level + 1, wl, hl);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wh * hh) return;
  const int y = i / wh, x = i % wh;
  const int cy = y >> 1, cx = x >> 1;
  const int cy1 = min(cy + 1, hl - 1), cx1 = min(cx + 1, wl - 1);
  const K9JRec* a00 = lo + cy * wl + cx;
  const K9JRec* a01 = lo + cy * wl + cx1;
  const K9JRec* a10 = lo + cy1 * wl + cx;
  const K9JRec* a11 = lo + cy1 * wl + cx1;
  const bool ylast = y == hh - 1, xlast = x == wh - 1;
  if (k9_is_sample(y, x, wh, hh)) {
    hi[i] = ylast && xlast ? *a11 : (ylast ? *a10 : (xlast ? *a01 : *a00));
    refine[i] = 0;
    return;
  }
  const bool h00 = a00->h.t != -1.f, h01 = a01->h.t != -1.f;
  const bool h10 = a10->h.t != -1.f, h11 = a11->h.t != -1.f;
  const bool miss4 = !(h00 || h01 || h10 || h11);
  const uint32_t value00 = a00->h.value;
  const int face00 = a00->h.face, scale00 = a00->scale;
  const float plane00 = a00->plane;
  K9JRec r = {};
  r.h.t = -1.f;
  bool smooth = false;
  if (h00 && h01 && h10 && h11 && a01->h.value == value00 &&
      a10->h.value == value00 && a11->h.value == value00 &&
      a01->h.face == face00 && a10->h.face == face00 &&
      a11->h.face == face00 && a01->scale == scale00 &&
      a10->scale == scale00 && a11->scale == scale00 &&
      a01->plane == plane00 && a10->plane == plane00 &&
      a11->plane == plane00 &&
      !(a00->passed || a01->passed || a10->passed || a11->passed)) {
    float rd[3];
    gen_ray(fp, k9_pixel(fp, level, i), rd);
    const RayConsts c = ray_consts(octree_scale, fp.cam_pos[0], fp.cam_pos[1],
                                   fp.cam_pos[2], rd[0], rd[1], rd[2]);
    const int axis00 = face00 >> 1;
    const float se = exp2_scale(scale00);
    const int sx = (int)(__float_as_uint(c.rdx) >> 31);
    const int sy = (int)(__float_as_uint(c.rdy) >> 31);
    const int sz = (int)(__float_as_uint(c.rdz) >> 31);
    const int own_sign = axis00 == 0 ? sx : (axis00 == 1 ? sy : sz);
    const bool mirror_ax = axis00 == 0 ? c.mx : (axis00 == 1 ? c.my : c.mz);
    // the pixel's own ray meets the shared plane at t_int
    const float plane_m = mirror_ax ? 3.f - plane00 : plane00;
    const float tc_ax = axis00 == 0 ? c.tcx : (axis00 == 1 ? c.tcy : c.tcz);
    const float tb_ax = axis00 == 0 ? c.tbx : (axis00 == 1 ? c.tby : c.tbz);
    const float t_int = plane_m * tc_ax - tb_ax;
    // hit point in mirrored [1, 2) space -> leaf base by mantissa
    // quantization; the face axis takes the plane itself
    float hx = c.rox + t_int * c.rdx;
    float hy = c.roy + t_int * c.rdy;
    float hz = c.roz + t_int * c.rdz;
    if (c.mx) hx = 3.f - hx;
    if (c.my) hy = 3.f - hy;
    if (c.mz) hz = 3.f - hz;
    const uint32_t sc = (uint32_t)clampi(scale00, 0, 31);
    const float base_ax = plane_m - se;
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
    const int face_own = on_x ? sx : (on_y ? (2 | sy) : (4 | sz));
    const float t_cube_exit =
        fminf(fminf(c.tcx - c.tbx, c.tcy - c.tby), c.tcz - c.tbz);
    if (own_sign == (face00 & 1) && face_own == face00 && t_int == tcmin &&
        t_int > 0.f && t_int <= t_cube_exit) {
      const HitGeom g =
          hit_geometry(c, octree_scale, scale00, posx, posy, posz, t_int);
      // the surface's hole table at the mip the pixel's lod rounds to
      const int L = tx.n_levels;
      const int dl = (int)rintf(clampf(g.lod, 0.f, (float)(L - 1)));
      const int vid = (int)value00;
      const bool value_opaque =
          vid < tx.mat_rows && !hole[clampi(vid, 0, tx.mat_rows - 1) * L + dl];
      smooth = value_opaque ||
               (hole_fill && texel_alpha(tx, K9J_ALPHA_MODE, value00, face00,
                                         g.u, g.v, g.lod) > 0.f);
      if (smooth) {
        Hit f;
        finalize_hit(c, octree_scale, g, t_int, value00, f);
        r.h.t = f.t;
        r.h.value = value00;
        r.h.face = face00;
        for (int k = 0; k < 3; ++k) r.h.pos[k] = f.pos[k];
        r.h.u = f.u;
        r.h.v = f.v;
        r.h.lod = f.lod;
        r.scale = scale00;
        r.plane = plane00;
      }
    }
  }
  hi[i] = r;
  refine[i] = (!smooth && !miss4) ? 1 : 0;
}

// K9-judged's record as a HitRec: its words 0-8, hit or miss (a miss
// record holds t = -1); the hit flag is t != -1.
struct K9JFinalize {
  static constexpr int RW = 4, QW = 3;  // the HitRec: words 0-8 of 16
  static constexpr bool NEEDS_RAY = false;

  __device__ __forceinline__ bool operator()(const uint4* q,
                                             const FrameParams&,
                                             const float*, uint32_t* w) const {
    w[0] = q[0].x;
    w[1] = q[0].y;
    w[2] = q[0].z;
    w[3] = q[0].w;
    w[4] = q[1].x;
    w[5] = q[1].y;
    w[6] = q[1].z;
    w[7] = q[1].w;
    w[8] = q[2].x;
    return __uint_as_float(q[0].x) != -1.f;
  }
};

// One thread per pixel: the record's hit as the deferred frame's HitRec and
// hit flag, or a miss and its sky; clears the pixel-space shadow masks
// (needp, blkp) the shadow cells read. K9's finalize body on one pose
// (k9_finalize_block): records, HitRecs and flags as 16-byte words
// through shared memory.
__global__ void __launch_bounds__(K9F_THREADS)
k9j_finalize_kernel(FrameParams fp, const K9JRec* __restrict__ frec,
                    HitRec* __restrict__ rec, uint8_t* __restrict__ hit,
                    float* __restrict__ img, uint8_t* __restrict__ needp,
                    uint8_t* __restrict__ blkp) {
  k9_finalize_block(K9JFinalize{}, fp, nullptr, 1,
                    reinterpret_cast<const uint4*>(frec), rec, hit, img,
                    needp, blkp);
}

}  // namespace vx
