// K9-judged, the adaptive thick-ray frame of a translucent world: its three
// kernels. Included by kernels.cu after k9_adaptive.cuh (it uses
// FrameParams, HitRec, gen_ray, sky_color, tile_lane and TILE_THREADS from
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
// Design: the merge has K9's merge tile (k9_adaptive.cuh): a block's lo
// patch loaded once and its hi rows stored as 16-byte words through shared
// memory, the fills from a packed list (k9j_merge_kernel); the finalize is
// K9's (k9_finalize_block: a block's records, HitRecs and flags as 16-byte
// words through shared memory, only the first three 16-byte words of a
// record read); the trace has
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
// warp's chain of steps); the merge reads a quarter record and writes one
// a lane (bytes bound; a fill adds some hundred float operations and a
// texel fetch); the finalize moves a record's two 32-byte sectors in and
// 38 bytes out a pixel (bytes bound).

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

// The fill of interior lane i of grid level `level` whose four corners
// agree on value, signed face face00, scale scale00 and plane plane00:
// whether the pixel's own ray enters that plane's leaf there and the
// surface has no hole at its mip (or, with hole_fill, its own texel is
// not transparent); if so, the finalized hit's record in r (left as it is
// otherwise).
__device__ __forceinline__ bool k9j_fill(float octree_scale,
                                         const TexTables& tx,
                                         const FrameParams& fp, int level,
                                         int hole_fill,
                                         const uint8_t* __restrict__ hole,
                                         int i, uint32_t value00, int face00,
                                         int scale00, float plane00,
                                         K9JRec& r) {
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
  if (!(own_sign == (face00 & 1) && face_own == face00 && t_int == tcmin &&
        t_int > 0.f && t_int <= t_cube_exit))
    return false;
  const HitGeom g =
      hit_geometry(c, octree_scale, scale00, posx, posy, posz, t_int);
  // the surface's hole table at the mip the pixel's lod rounds to
  const int L = tx.n_levels;
  const int dl = (int)rintf(clampf(g.lod, 0.f, (float)(L - 1)));
  const int vid = (int)value00;
  const bool value_opaque =
      vid < tx.mat_rows && !hole[clampi(vid, 0, tx.mat_rows - 1) * L + dl];
  if (!(value_opaque ||
        (hole_fill && texel_alpha(tx, K9J_ALPHA_MODE, value00, face00, g.u,
                                  g.v, g.lod) > 0.f)))
    return false;
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
  return true;
}

// K9-judged's merge tile: K9JM_TW x K9JM_TH hi lanes a block of
// K9JM_THREADS, one lane a thread (warp w row w), whose corners are a
// K9JM_PW x K9JM_PH patch of lo records. A block stages 22.6 KB; its
// registers are capped (48 a thread, no spill) so that an SM holds
// K9JM_BLOCKS_PER_SM blocks: more blocks wait out their patch loads at
// once. Of the other shapes measured on an H100 (chip_smoke.py
// --kernels-only; PERF.md §6), 32 x 16 tiles (4 or 5 blocks an SM) were
// 0.4-4% slower, 6 or 8 blocks of 32 x 8 (spilling) 1-8% slower, and hi
// records stored straight from a 32 x 16 tile (four 16-byte stores a
// lane) 1.78x this shape's time.
constexpr int K9JM_TW = 32, K9JM_TH = 8, K9JM_THREADS = 256;
constexpr int K9JM_BLOCKS_PER_SM = 5;
constexpr int K9JM_LANES = K9JM_TW * K9JM_TH;
constexpr int K9JM_PW = K9JM_TW / 2 + 1, K9JM_PH = K9JM_TH / 2 + 1;

// The shared-memory position of 16-byte word p of a staged span of judged
// records (4 words a record): the low two bits XORed with bits 3-4, so
// that the 8 threads of a quarter warp, reading or writing word k of 4
// consecutive records (two threads a record) or of 8 records, or 8
// consecutive words, meet 8 distinct groups of 4 banks.
__device__ __forceinline__ int k9jm_swz(int p) { return p ^ ((p >> 3) & 3); }

// The merge of the records `lo` of grid level + 1 onto the hi grid (wh x
// hh) of level `level`, one block per K9JM_TW x K9JM_TH tile (row-major):
// a sample lane takes its corner's record. An interior lane whose four
// corners hit the same value, signed face, leaf scale and entry plane,
// none of them having passed a translucent texel, is filled when its own
// ray enters that plane's leaf there (the ray's sign on the face axis, its
// own entry face, t_int == tcmin, inside the cube) and the surface has no
// alpha-0 texel at the mip its tex_lod rounds to (hole[value][level], the
// (V, L) table of ops.adaptive_judged.hole_table) or, with hole_fill, the
// pixel's own texel there has alpha > 0. The others get a miss record
// and, unless all four corners missed, refine = 1.
//
// Shape (K9's merge tile, k9_adaptive.cuh k9_merge_kernel): the patch of
// lo records (row r, column c: lo lane (min(cy0 + r, hl - 1), min(cx0 + c,
// wl - 1)), so a lane's clamped corners are patch entries) is loaded once
// into shared memory as coalesced 16-byte words; a lane compares its
// corners' words 0, 2 and 3 (t, value, face; scale, plane; passed) as
// 16-byte loads, and a sample lane copies its corner's four. The lanes
// whose corners agree are packed into a list that the block's first
// threads fill, so the fill's arithmetic runs in full warps. The hi
// records are staged so that each warp stores its rows as contiguous
// 16-byte words. Lanes past the grid's last row or column load and wait
// with the others and store nothing.
__global__ void __launch_bounds__(K9JM_THREADS, K9JM_BLOCKS_PER_SM)
k9j_merge_kernel(float octree_scale, TexTables tx, FrameParams fp, int level,
                 int hole_fill, const uint8_t* __restrict__ hole,
                 const K9JRec* __restrict__ lo, K9JRec* __restrict__ hi,
                 uint8_t* __restrict__ refine) {
  __shared__ uint4 s_lo[4 * K9JM_PH * K9JM_PW];
  __shared__ uint4 s_hi[K9JM_TH][4 * K9JM_TW];
  __shared__ uint8_t s_refine[K9JM_LANES];
  __shared__ int s_fill[K9JM_LANES];
  __shared__ int s_nfill;
  int wh, hh, wl, hl;
  k9_dims(fp.width, fp.height, level, wh, hh);
  k9_dims(fp.width, fp.height, level + 1, wl, hl);
  const int ntx = (wh + K9JM_TW - 1) / K9JM_TW;
  const int x0 = (blockIdx.x % ntx) * K9JM_TW;
  const int y0 = (blockIdx.x / ntx) * K9JM_TH;
  const int cx0 = x0 >> 1, cy0 = y0 >> 1;
  if (threadIdx.x == 0) s_nfill = 0;
  for (int q = threadIdx.x; q < 4 * K9JM_PH * K9JM_PW; q += K9JM_THREADS) {
    const int r = q / (4 * K9JM_PW), c = (q >> 2) - r * K9JM_PW;
    const int ly = min(cy0 + r, hl - 1), lx = min(cx0 + c, wl - 1);
    s_lo[k9jm_swz(q)] = __ldg(reinterpret_cast<const uint4*>(
                                  lo + (size_t)ly * wl + lx) + (q & 3));
  }
  __syncthreads();
  const int col = threadIdx.x % K9JM_TW, x = x0 + col;
  const uint4 miss = make_uint4(__float_as_uint(-1.f), 0u, 0u, 0u);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int l = threadIdx.x; l < K9JM_LANES; l += K9JM_THREADS) {
    const int ty = l / K9JM_TW, y = y0 + ty;
    if (y >= hh || x >= wh) continue;
    // the patch records of the lane's corners a00, a01, a10, a11
    const int c00 = ((y >> 1) - cy0) * K9JM_PW + ((x >> 1) - cx0);
    const int cs[4] = {c00, c00 + 1, c00 + K9JM_PW, c00 + K9JM_PW + 1};
    uint4 u[4] = {miss, zero, zero, zero};
    bool rf = false;
    if (k9_is_sample(y, x, wh, hh)) {
      const bool ylast = y == hh - 1, xlast = x == wh - 1;
      const int c = c00 + (ylast ? K9JM_PW : 0) + (xlast ? 1 : 0);
#pragma unroll
      for (int k = 0; k < 4; ++k) u[k] = s_lo[k9jm_swz(4 * c + k)];
    } else {
      // words 0 (t, value, face), 2 (scale, plane), 3 (passed)
      const uint4 w0 = s_lo[k9jm_swz(4 * c00)];
      const uint4 w2 = s_lo[k9jm_swz(4 * c00 + 2)];
      bool hit4 = true, any = false, agree = true;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 a0 = s_lo[k9jm_swz(4 * cs[k])];
        const uint4 a2 = s_lo[k9jm_swz(4 * cs[k] + 2)];
        const uint4 a3 = s_lo[k9jm_swz(4 * cs[k] + 3)];
        const bool h = __uint_as_float(a0.x) != -1.f;
        hit4 &= h;
        any |= h;
        agree &= a0.y == w0.y && a0.z == w0.z && a2.z == w2.z &&
                 __uint_as_float(a2.w) == __uint_as_float(w2.w) && !a3.x;
      }
      if (hit4 && agree)
        s_fill[atomicAdd(&s_nfill, 1)] = l;  // filled below
      else
        rf = any;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) s_hi[ty][k9jm_swz(4 * col + k)] = u[k];
    s_refine[l] = rf ? 1 : 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < s_nfill; j += K9JM_THREADS) {
    const int l = s_fill[j], lx = l % K9JM_TW, ly = l / K9JM_TW;
    const int y = y0 + ly, xx = x0 + lx;
    const int c00 = ((y >> 1) - cy0) * K9JM_PW + ((xx >> 1) - cx0);
    const uint4 w0 = s_lo[k9jm_swz(4 * c00)];
    const uint4 w2 = s_lo[k9jm_swz(4 * c00 + 2)];
    K9JWords u;
    u.q[0] = miss;
    u.q[1] = u.q[2] = u.q[3] = zero;
    const bool smooth =
        k9j_fill(octree_scale, tx, fp, level, hole_fill, hole,
                 y * wh + xx, w0.y, (int)w0.z, (int)w2.z,
                 __uint_as_float(w2.w), u.r);
#pragma unroll
    for (int k = 0; k < 4; ++k) s_hi[ly][k9jm_swz(4 * lx + k)] = u.q[k];
    s_refine[l] = smooth ? 0 : 1;
  }
  __syncthreads();
  // each warp's rows of records as contiguous 16-byte words
  const int words = 4 * min(K9JM_TW, wh - x0);
  for (int l = threadIdx.x; l < K9JM_LANES; l += K9JM_THREADS) {
    const int ty = l / K9JM_TW, y = y0 + ty;
    if (y >= hh) continue;
    const size_t row = (size_t)y * wh + x0;
    uint4* out = reinterpret_cast<uint4*>(hi + row);
    for (int j = col; j < words; j += K9JM_TW)
      out[j] = s_hi[ty][k9jm_swz(j)];
    if (x < wh) refine[row + col] = s_refine[l];
  }
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
