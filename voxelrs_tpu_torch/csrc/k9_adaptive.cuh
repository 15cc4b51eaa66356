// K9, the adaptive thick-ray opaque frame: its four kernels. Included by
// kernels.cu after the deferred stages (it uses FrameParams, HitRec,
// gen_ray, sky_color and composite from there).
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
// Design: one thread per lane (the shadow cells: a word of four); counts
// stay in device memory (K6's), and every kernel reads its count and exits
// or stops its loop past it, so a frame makes no host round trip. The arithmetic is the plain version's
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
// stacked as one tall frame, and no merge tile crosses a pose. The shadow
// cells decide each pose's dense flag from that pose's own hit count (K6's
// segment starts `hstart`). One frame is the case n_poses = 1 with cams
// and hstart null.
//
// What bounds them on an H100: k9_trace is the traversal (K1 / K4,
// dependent loads). A launch lasts as long as its slowest warp's chain of
// steps (the longest rays take ~140 steps, a warp's lanes ~0.7 of its
// longest on average), so its shape shortens each step's wait: the stack
// in shared memory instead of local memory, the ESVO cursor's child
// pointer loaded beside the descriptor, 4x8 pixel tiles a warp on the
// whole grid (its rays leave from one patch), 64-thread blocks, and a grid
// no larger than the card holds at once (kernels.cu k9_trace_launch), so a
// refine list's launch schedules no empty blocks past its count.
// The merge and the finalize are bytes bound, so they move records as
// 16-byte words (K9Rec is 16-byte aligned: two words a record, as the
// trace stores it). A merge block covers a 32 x 16 tile of one pose's hi
// grid (two rows a thread), loads the 17 x 9 patch of lo records its
// corners need into shared memory once, coalesced, takes each lane's four
// corners from there, fills the lanes whose corners agree from a packed
// list (the fill's divisions in full warps), and stages its hi records so
// that each warp stores its rows as contiguous 16-byte words; its
// registers are capped so that 8 blocks share an SM. On records that all
// miss, where no lane fills, the merge takes most of its time still
// (chip_smoke.py times both): the blocks' waits for their patches and
// their stores hold it, not the fill. A finalize block
// loads its 128 records (one 4,096-byte span) coalesced, stages its 128
// HitRecs (4,608 bytes) and stores them as coalesced 16-byte words, its
// byte flags as 16-byte words and a miss's sky as one. Shared words are
// read and written at positions k9_swz, so a quarter warp's 16-byte
// accesses hit distinct banks. K9-judged's finalize runs the same body
// (k9_finalize_block) on its 64-byte records, of which it loads the
// first three 16-byte words (the HitRec's 9 words).

#pragma once

namespace vx {

// 16-byte aligned, so a record moves as two 16-byte words
struct __align__(16) K9Rec {
  float t;            // t_min in octree units
  uint32_t idxscale;  // child slot | scale << 8
  float pos[3];       // leaf base, mirrored [1, 2) space
  uint32_t value;     // leaf value
  uint32_t flags;     // hit | face axis << 1 | ray octant << 3
  uint32_t pad;
};

union K9Words {
  K9Rec r;
  uint4 q[2];
};

__device__ __forceinline__ K9Rec k9_load(const K9Rec* __restrict__ p) {
  const uint4* w = reinterpret_cast<const uint4*>(p);
  K9Words u;
  u.q[0] = __ldg(w);
  u.q[1] = __ldg(w + 1);
  return u.r;
}

__device__ __forceinline__ void k9_store(K9Rec* __restrict__ p,
                                         const K9Rec& r) {
  K9Words u;
  u.r = r;
  uint4* w = reinterpret_cast<uint4*>(p);
  w[0] = u.q[0];
  w[1] = u.q[1];
}

// The shared-memory position of 16-byte word p of a staged span: the low
// bit flipped in every second group of 8, so that the 8 threads of a
// quarter warp, reading or writing word 2l or 2l + 1 of their record l,
// meet 8 distinct groups of 4 banks, as do 8 threads on 8 consecutive
// words.
__device__ __forceinline__ int k9_swz(int p) { return p ^ ((p >> 3) & 1); }

// (w, h) of grid level `level` of a width x height frame (the launchers'
// too).
__host__ __device__ __forceinline__ void k9_dims(int width, int height,
                                                 int level, int& w, int& h) {
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
constexpr int K9_TRACE_THREADS = TILE_THREADS;

// One thread per work item of grid level `level` (kernels.cu tile_lane:
// idx null, items m < size; else the refine list's entries m < *count), a
// block looping over items gridDim.x * K9_TRACE_THREADS apart: the opaque
// trace of the lane's pixel ray from the pixel's tile floor (tf null =
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
    const int lane = tile_lane(m, idx, wl, hl);
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
    k9_store(out + lane, r);
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

// The pixel (y, x) of lane (y, x) of grid level `level` (k9_pixel from
// the lane's row and column).
__device__ __forceinline__ void k9_pixel_yx(const FrameParams& fp, int level,
                                            int& y, int& x) {
  for (int k = level; k > 0; --k) {
    int wk, hk;
    k9_dims(fp.width, fp.height, k - 1, wk, hk);
    y = min(2 * y, hk - 1);
    x = min(2 * x, wk - 1);
  }
}

// Whether an interior lane's four corners hit the same value, face axis,
// entry plane, leaf scale and ray octant: the fill's precondition.
__device__ __forceinline__ bool k9_corners_agree(const K9Rec& a00,
                                                 const K9Rec& a01,
                                                 const K9Rec& a10,
                                                 const K9Rec& a11) {
  const uint32_t surf = a00.flags >> 1;  // face axis and ray octant
  const float plane00 = k9_plane(a00);
  return (a00.flags & 1u) && (a01.flags & 1u) && (a10.flags & 1u) &&
         (a11.flags & 1u) && a01.value == a00.value &&
         a10.value == a00.value && a11.value == a00.value &&
         (a01.flags >> 1) == surf && (a10.flags >> 1) == surf &&
         (a11.flags >> 1) == surf && k9_plane(a01) == plane00 &&
         k9_plane(a10) == plane00 && k9_plane(a11) == plane00 &&
         (a01.idxscale >> 8) == (a00.idxscale >> 8) &&
         (a10.idxscale >> 8) == (a00.idxscale >> 8) &&
         (a11.idxscale >> 8) == (a00.idxscale >> 8);
}

// The fill of interior lane (y, x) of pose `pose` of grid level `level`
// whose corners agree (a00 one of them): whether the pixel's own ray
// enters the corners' leaf there (its own entry face, t_int == tcmin,
// inside the cube), and if so that leaf's synthesized record in r.
__device__ __forceinline__ bool k9_fill(float octree_scale,
                                        const FrameParams& fp,
                                        const float* __restrict__ cams,
                                        int pose, int level, int y, int x,
                                        const K9Rec& a00, K9Rec& r) {
  const uint32_t surf = a00.flags >> 1;
  const float plane00 = k9_plane(a00);
  const int axis00 = (int)(surf & 3u);
  const int scale00 = (int)(a00.idxscale >> 8);
  const FrameParams f = pose_params(fp, cams, pose);
  k9_pixel_yx(fp, level, y, x);
  float rd[3];
  gen_ray_yx(f, y, x, rd);
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
  const bool smooth = c.octant_mask == (int)(surf >> 2) &&
                      axis_own == axis00 && t_int == tcmin && t_int > 0.f &&
                      t_int <= t_cube_exit;
  if (smooth) {
    r.t = t_int;
    r.idxscale = (uint32_t)scale00 << 8;
    r.pos[0] = posx;
    r.pos[1] = posy;
    r.pos[2] = posz;
    r.value = a00.value;
    r.flags = 1u | (surf << 1);
  }
  return smooth;
}

// K9's merge tile: K9M_TW x K9M_TH hi lanes a block of K9M_THREADS, warp w
// rows w and w + 8 (each thread two lanes of one column); their corners
// are a K9M_PW x K9M_PH patch of lo records. Registers are capped (32 a
// thread, a few bytes spilled) so that an SM holds K9M_BLOCKS_PER_SM
// blocks: more blocks wait out their patch loads at once.
constexpr int K9M_TW = 32, K9M_THREADS = 256, K9M_BLOCKS_PER_SM = 8;
constexpr int K9M_TH = 2 * K9M_THREADS / K9M_TW;
constexpr int K9M_LANES = K9M_TW * K9M_TH;
constexpr int K9M_PW = K9M_TW / 2 + 1, K9M_PH = K9M_TH / 2 + 1;

// The merge of the records `lo` of grid level + 1 onto the hi grid (wh x
// hh) of level `level`, one block per tile of one pose's hi grid (the
// tiles of pose 0 row-major, then pose 1's, ...): a sample lane takes its
// corner's record; an interior lane whose corners agree
// (k9_corners_agree) gets the fill's record (k9_fill) if the fill holds,
// else an empty record and refine = 1; the other interior lanes get an
// empty record and, unless all four corners missed, refine = 1. Patch row
// r, column c holds lo lane (min(cy0 + r, hl - 1), min(cx0 + c, wl - 1))
// of the pose, so a lane's clamped corners (min(cy + 1, hl - 1), ...) are
// patch entries. The lanes whose corners agree are packed into a list
// and filled by the block's first threads, so the fill's divisions run in
// full warps. Lanes past the grid's last row or column load and wait with
// the others and store nothing.
__global__ void __launch_bounds__(K9M_THREADS, K9M_BLOCKS_PER_SM)
k9_merge_kernel(float octree_scale, FrameParams fp,
                const float* __restrict__ cams, int level,
                const K9Rec* __restrict__ lo, K9Rec* __restrict__ hi,
                uint8_t* __restrict__ refine) {
  __shared__ K9Rec s_lo[K9M_PH * K9M_PW];
  __shared__ uint4 s_hi[K9M_TH][2 * K9M_TW];
  __shared__ uint8_t s_refine[K9M_LANES];
  __shared__ int s_fill[K9M_LANES];
  __shared__ int s_nfill;
  int wh, hh, wl, hl;
  k9_dims(fp.width, fp.height, level, wh, hh);
  k9_dims(fp.width, fp.height, level + 1, wl, hl);
  const int ntx = (wh + K9M_TW - 1) / K9M_TW;
  const int per_pose = ntx * ((hh + K9M_TH - 1) / K9M_TH);
  const int pose = blockIdx.x / per_pose, tile = blockIdx.x % per_pose;
  const int x0 = (tile % ntx) * K9M_TW, y0 = (tile / ntx) * K9M_TH;
  const int cx0 = x0 >> 1, cy0 = y0 >> 1;
  lo += (size_t)pose * wl * hl;
  if (threadIdx.x == 0) s_nfill = 0;
  // the patch, row by row as 16-byte words (a row of records is
  // contiguous but where its last column clamps)
  uint4* s_low = reinterpret_cast<uint4*>(s_lo);
  for (int q = threadIdx.x; q < 2 * K9M_PH * K9M_PW; q += K9M_THREADS) {
    const int r = q / (2 * K9M_PW), c = (q >> 1) - r * K9M_PW;
    const int ly = min(cy0 + r, hl - 1), lx = min(cx0 + c, wl - 1);
    s_low[q] = __ldg(reinterpret_cast<const uint4*>(lo + (size_t)ly * wl +
                                                    lx) + (q & 1));
  }
  __syncthreads();
  const int tx = threadIdx.x % K9M_TW, x = x0 + tx;
  for (int l = threadIdx.x; l < K9M_LANES; l += K9M_THREADS) {
    const int ty = l / K9M_TW, y = y0 + ty;
    if (y >= hh || x >= wh) continue;
    const K9Rec* p = s_lo + ((y >> 1) - cy0) * K9M_PW + ((x >> 1) - cx0);
    const K9Rec &a00 = p[0], &a01 = p[1];
    const K9Rec &a10 = p[K9M_PW], &a11 = p[K9M_PW + 1];
    K9Words u;
    u.r = K9Rec{};
    bool rf = false;
    if (k9_is_sample(y, x, wh, hh)) {
      const bool ylast = y == hh - 1, xlast = x == wh - 1;
      u.r = ylast && xlast ? a11 : (ylast ? a10 : (xlast ? a01 : a00));
    } else if (k9_corners_agree(a00, a01, a10, a11)) {
      s_fill[atomicAdd(&s_nfill, 1)] = l;  // filled below
    } else {
      rf = ((a00.flags | a01.flags | a10.flags | a11.flags) & 1u) != 0;
    }
    s_hi[ty][k9_swz(2 * tx)] = u.q[0];
    s_hi[ty][k9_swz(2 * tx + 1)] = u.q[1];
    s_refine[l] = rf ? 1 : 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < s_nfill; j += K9M_THREADS) {
    const int l = s_fill[j], lx = l % K9M_TW, ly = l / K9M_TW;
    const K9Rec* p = s_lo + (((y0 + ly) >> 1) - cy0) * K9M_PW +
                     (((x0 + lx) >> 1) - cx0);
    K9Words u;
    u.r = K9Rec{};
    const bool smooth =
        k9_fill(octree_scale, fp, cams, pose, level, y0 + ly, x0 + lx, p[0],
                u.r);
    s_hi[ly][k9_swz(2 * lx)] = u.q[0];
    s_hi[ly][k9_swz(2 * lx + 1)] = u.q[1];
    s_refine[l] = smooth ? 0 : 1;
  }
  __syncthreads();
  // each warp's rows of records as contiguous 16-byte words
  const int words = 2 * min(K9M_TW, wh - x0);
  for (int l = threadIdx.x; l < K9M_LANES; l += K9M_THREADS) {
    const int ty = l / K9M_TW, y = y0 + ty;
    if (y >= hh) continue;
    const size_t row = ((size_t)pose * hh + y) * wh + x0;
    uint4* out = reinterpret_cast<uint4*>(hi + row);
    for (int j = tx; j < words; j += K9M_TW) out[j] = s_hi[ty][k9_swz(j)];
    if (x < wh) refine[row + tx] = s_refine[l];
  }
}

// Threads of a K9 finalize block, one pixel each.
constexpr int K9F_THREADS = 128;

// The shared-memory position of staged 16-byte word p of a finalize block
// whose records are staged QW words each: k9_swz for an even QW (the
// opaque record's 2); an odd QW (K9-judged's 3) already puts the 8
// threads of a quarter warp, reading word QW * l + k of their record l,
// on 8 distinct groups of 4 banks.
template <int QW>
__device__ __forceinline__ int k9f_swz(int p) {
  return (QW & 1) ? p : k9_swz(p);
}

// The body of K9's and K9-judged's finalize, one thread per pixel of each
// pose (block b: pixels 128b ...): the record's hit as the deferred frame's
// HitRec and hit flag, or a miss and its sky; clears the pixel-space shadow
// masks (needp, blkp) the shadow cells read. `Fin` is how a record becomes
// a HitRec, the one thing the two differ in: a record is Fin::RW 16-byte
// words, of which the first Fin::QW hold what fin reads; fin(q, f, rd, w)
// writes the HitRec's 9 words to w from the record's staged words q and
// returns the hit flag (rd is the pixel's ray where Fin::NEEDS_RAY, and
// is made here only for a miss's sky otherwise). The block's records
// (their first QW words), HitRecs and flags move through shared memory as
// 16-byte words; a last block of fewer than 128 pixels stores its tail
// words and its flags one by one.
template <class Fin>
__device__ __forceinline__ void k9_finalize_block(
    const Fin& fin, const FrameParams& fp, const float* __restrict__ cams,
    int n_poses, const uint4* __restrict__ frec, HitRec* __restrict__ rec,
    uint8_t* __restrict__ hit, float* __restrict__ img,
    uint8_t* __restrict__ needp, uint8_t* __restrict__ blkp) {
  constexpr int HW = sizeof(HitRec) / 4;  // 9 words
  static_assert(sizeof(HitRec) == 36, "HitRec: t, value, face, pos, u, v, lod");
  constexpr int RW = Fin::RW, QW = Fin::QW;
  __shared__ uint4 s_rec[QW * K9F_THREADS];
  __shared__ uint4 s_out[HW * K9F_THREADS / 4];
  __shared__ uint4 s_hit[K9F_THREADS / 16];
  const int B = fp.width * fp.height;
  const long long total = (long long)B * n_poses;
  const long long base = (long long)blockIdx.x * K9F_THREADS;
  const int cnt = (int)min((long long)K9F_THREADS, total - base);
  const uint4* src = frec + base * RW;
  for (int q = threadIdx.x; q < QW * cnt; q += K9F_THREADS)
    s_rec[k9f_swz<QW>(q)] =
        __ldg(src + (RW == QW ? q : q / QW * RW + q % QW));
  __syncthreads();
  const int t = threadIdx.x;
  uint8_t* s_hitb = reinterpret_cast<uint8_t*>(s_hit);
  if (t < cnt) {
    const int i = (int)(base + t);
    const int pose = i / B;
    const FrameParams f = pose_params(fp, cams, pose);
    uint4 q[QW];
#pragma unroll
    for (int k = 0; k < QW; ++k) q[k] = s_rec[k9f_swz<QW>(QW * t + k)];
    float rd[3];
    if (Fin::NEEDS_RAY) gen_ray(f, i - pose * B, rd);
    // the HitRec, word by word, at word HW * t of the staged span (an odd
    // stride: the 32 lanes of a warp meet 32 banks)
    const bool h = fin(q, f, rd, reinterpret_cast<uint32_t*>(s_out) + HW * t);
    if (!h) {
      if (!Fin::NEEDS_RAY) gen_ray(f, i - pose * B, rd);
      float rgb[3];
      sky_color(f, rd[0], rd[2], rgb);
      reinterpret_cast<float4*>(img)[i] =
          make_float4(rgb[0], rgb[1], rgb[2], 1.f);
    }
    s_hitb[t] = h ? 1 : 0;
  }
  __syncthreads();
  const int words = HW * cnt;  // of the block's HitRec span
  uint4* dst = reinterpret_cast<uint4*>(rec + base);
  for (int q = t; q < words / 4; q += K9F_THREADS) dst[q] = s_out[q];
  if (cnt == K9F_THREADS) {
    if (t < K9F_THREADS / 16) {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<uint4*>(hit + base)[t] = s_hit[t];
      reinterpret_cast<uint4*>(needp + base)[t] = zero;
      reinterpret_cast<uint4*>(blkp + base)[t] = zero;
    }
  } else {
    const uint32_t* s_outw = reinterpret_cast<const uint32_t*>(s_out);
    uint32_t* dstw = reinterpret_cast<uint32_t*>(rec + base);
    const int q = (words & ~3) + t;
    if (q < words) dstw[q] = s_outw[q];
    if (t < cnt) {
      hit[base + t] = s_hitb[t];
      needp[base + t] = 0;
      blkp[base + t] = 0;
    }
  }
}

// K9's record as a HitRec: a hit is its ray's finalize from the frozen
// state, through the traversal's own device functions; a miss is t = -1,
// the other words 0.
struct K9FinalizeOpaque {
  static constexpr int RW = 2, QW = 2;
  static constexpr bool NEEDS_RAY = true;
  float octree_scale;

  __device__ __forceinline__ bool operator()(const uint4* q,
                                             const FrameParams& f,
                                             const float* rd,
                                             uint32_t* w) const {
    K9Words u;
    u.q[0] = q[0];
    u.q[1] = q[1];
    const K9Rec& r = u.r;
    if (!(r.flags & 1u)) {
      w[0] = __float_as_uint(-1.f);
      for (int k = 1; k < 9; ++k) w[k] = 0u;
      return false;
    }
    const RayConsts c = ray_consts(octree_scale, f.cam_pos[0], f.cam_pos[1],
                                   f.cam_pos[2], rd[0], rd[1], rd[2]);
    const HitGeom g = hit_geometry(c, octree_scale, (int)(r.idxscale >> 8),
                                   r.pos[0], r.pos[1], r.pos[2], r.t);
    Hit h;
    finalize_hit(c, octree_scale, g, r.t, r.value, h);
    w[0] = __float_as_uint(h.t);
    w[1] = h.value;
    w[2] = (uint32_t)h.face;
    for (int k = 0; k < 3; ++k) w[3 + k] = __float_as_uint(h.pos[k]);
    w[6] = __float_as_uint(h.u);
    w[7] = __float_as_uint(h.v);
    w[8] = __float_as_uint(h.lod);
    return true;
  }
};

// One thread per pixel of each pose: K9's finalize (k9_finalize_block).
__global__ void __launch_bounds__(K9F_THREADS)
k9_finalize_kernel(float octree_scale, FrameParams fp,
                   const float* __restrict__ cams, int n_poses,
                   const K9Rec* __restrict__ frec, HitRec* __restrict__ rec,
                   uint8_t* __restrict__ hit, float* __restrict__ img,
                   uint8_t* __restrict__ needp, uint8_t* __restrict__ blkp) {
  k9_finalize_block(K9FinalizeOpaque{octree_scale}, fp, cams, n_poses,
                    reinterpret_cast<const uint4*>(frec), rec, hit, img,
                    needp, blkp);
}

// K9's shadow cells over the compacted hit lanes j < size (pixel
// hidx[j], j < *hcount). Step 1: the pixel-space need (needp), the dense
// flag of each pose's hit count (dense[pose]), and the pass-1 shadow
// candidates (mask): on a dense frame those on the half grid's sample
// pixels, else all of them (the single pass). Step 2 (after pass 1 left
// its verdicts in blkp): on a dense frame, an interior pixel whose four
// cell corners agree on need and verdict and need a shadow reuses the
// corners' verdict (a blocked one is composited here, with kd_finish's
// colour); the rest of its candidates are the pass-2 mask. A batch's hit
// lanes are pose-major (the pose of lane hidx[j] is hidx[j] / (W * H));
// pose q's hits run from hstart[q] to the next pose's start (hstart null:
// one frame, all the hits).
//
// What bounds it on an H100: bytes (a lane's index and need in, its mask
// byte out, in step 1 a scattered need byte, in step 2 eight corner bytes
// where the lane needs a shadow) and, at a frame's ~700,000 hits of
// 2,073,600 slots, the slots past the count. So a thread takes a word of
// K9S_LANES consecutive lanes (their indices as one 16-byte load, need and
// mask as 4-byte words) up to the count rounded up to K9S_TAIL lanes, and
// the mask's tail past that as 16-byte zero stores; the grid is at most
// the blocks the card holds at once (vx_k9_shadow_cells), each looping
// over the words and tail words up to the count on the card; a block
// decides each pose's dense flag once (for the first K9S_POSES poses; a
// later pose's lanes decide their own). A lane that needs no shadow reads
// no corner. need, mask and hidx start on a 16-byte word
// (ops/adaptive.py checks).
constexpr int K9S_THREADS = 128;
constexpr int K9S_LANES = 4;
constexpr int K9S_TAIL = 16;
constexpr int K9S_POSES = 256;

__device__ __forceinline__ int k9_pose_hits(const int* __restrict__ hstart,
                                            int n_poses, int n, int q) {
  if (!hstart) return n;
  return (q + 1 < n_poses ? hstart[q + 1] : n) - hstart[q];
}

__device__ __forceinline__ bool k9_pose_dense(const int* __restrict__ hstart,
                                              int n_poses, int n, int q,
                                              int B) {
  return k9_dense(k9_pose_hits(hstart, n_poses, n, q), B);
}

// Hit lane j (batch lane g = pose * B + pixel, need nd) of step 1 or 2:
// its mask byte; step 1 also stores its need at its pixel, step 2
// composites a reused blocked verdict.
__device__ __forceinline__ uint32_t k9_cell_lane(
    int step, const FrameParams& fp, int g, bool nd, bool dense,
    uint8_t* __restrict__ needp, const uint8_t* __restrict__ blkp,
    const float4* __restrict__ color, const float* __restrict__ ds,
    float* __restrict__ img, int j) {
  const int W = fp.width, H = fp.height, B = W * H;
  const int base = g / B * B, p = g - base;
  const int y = p / W, x = p - y * W;
  const bool sample = k9_is_sample(y, x, W, H);
  if (step == 1) {
    needp[g] = nd ? 1 : 0;
    return (nd && (!dense || sample)) ? 1u : 0u;
  }
  if (!nd || !dense || sample) return 0u;
  // the cell corners: half-grid lanes and their pixels, in the same pose
  const int hc = H / 2 + 1, wc = W / 2 + 1;
  const int cy = y >> 1, cx = x >> 1;
  const int cy1 = min(cy + 1, hc - 1), cx1 = min(cx + 1, wc - 1);
  const int r0 = base + min(2 * cy, H - 1) * W;
  const int r1 = base + min(2 * cy1, H - 1) * W;
  const int c0 = min(2 * cx, W - 1), c1 = min(2 * cx1, W - 1);
  const int q00 = r0 + c0, q01 = r0 + c1, q10 = r1 + c0, q11 = r1 + c1;
  const uint8_t n00 = __ldg(needp + q00), b00 = __ldg(blkp + q00);
  const bool reuse =
      n00 && __ldg(needp + q01) == n00 && __ldg(needp + q10) == n00 &&
      __ldg(needp + q11) == n00 && __ldg(blkp + q01) == b00 &&
      __ldg(blkp + q10) == b00 && __ldg(blkp + q11) == b00;
  if (!reuse) return 1u;
  if (b00) composite(fp, color[j], ds[j], 0.f, img + 4 * (size_t)g);
  return 0u;
}

__global__ void __launch_bounds__(K9S_THREADS)
k9_shadow_cells_kernel(int step, FrameParams fp, const int* __restrict__ hidx,
                       const int* __restrict__ hcount,
                       const int* __restrict__ hstart, int n_poses, int size,
                       const uint8_t* __restrict__ need,
                       uint8_t* __restrict__ needp,
                       const uint8_t* __restrict__ blkp,
                       uint8_t* __restrict__ mask, int* __restrict__ dense_out,
                       const float4* __restrict__ color,
                       const float* __restrict__ ds, float* __restrict__ img) {
  __shared__ uint8_t s_dense[K9S_POSES];
  const int B = fp.width * fp.height;
  const int n = count_of(hcount, size);
  const int cached = min(n_poses, K9S_POSES);
  for (int q = threadIdx.x; q < cached; q += K9S_THREADS)
    s_dense[q] = k9_pose_dense(hstart, n_poses, n, q, B) ? 1 : 0;
  const int stride = gridDim.x * K9S_THREADS;
  if (step == 1)
    for (int q = blockIdx.x * K9S_THREADS + threadIdx.x; q < n_poses;
         q += stride)
      dense_out[q] = k9_pose_dense(hstart, n_poses, n, q, B) ? 1 : 0;
  __syncthreads();
  // words of the lanes below `live` (the count rounded up to K9S_TAIL
  // lanes), then K9S_TAIL-lane tail words of zeros up to `size`
  const int live = (int)min(((long long)n + K9S_TAIL - 1) / K9S_TAIL *
                                K9S_TAIL,
                            (long long)size);
  const int words = (live + K9S_LANES - 1) / K9S_LANES;
  const int items = words + (size - live + K9S_TAIL - 1) / K9S_TAIL;
  for (int i = blockIdx.x * K9S_THREADS + threadIdx.x; i < items;
       i += stride) {
    if (i >= words) {
      const int t0 = live + (i - words) * K9S_TAIL;
      if (t0 + K9S_TAIL <= size) {
        *reinterpret_cast<uint4*>(mask + t0) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int t = t0; t < size; ++t) mask[t] = 0;
      }
      continue;
    }
    const int j0 = i * K9S_LANES;
    const bool whole = j0 + K9S_LANES <= size;
    int g[K9S_LANES];
    uint32_t nw = 0u;
    if (whole) {
      const int4 h = *reinterpret_cast<const int4*>(hidx + j0);
      g[0] = h.x;
      g[1] = h.y;
      g[2] = h.z;
      g[3] = h.w;
      nw = *reinterpret_cast<const uint32_t*>(need + j0);
    } else {
      for (int l = 0; l < K9S_LANES; ++l) {
        g[l] = j0 + l < size ? hidx[j0 + l] : 0;
        nw |= (j0 + l < size ? (uint32_t)need[j0 + l] : 0u) << (8 * l);
      }
    }
    uint32_t mw = 0u;
#pragma unroll
    for (int l = 0; l < K9S_LANES; ++l) {
      const int j = j0 + l;
      if (j >= n) break;
      const int pose = g[l] / B;
      const bool dense = pose < K9S_POSES
                             ? s_dense[pose] != 0
                             : k9_pose_dense(hstart, n_poses, n, pose, B);
      mw |= k9_cell_lane(step, fp, g[l], ((nw >> (8 * l)) & 0xffu) != 0u,
                         dense, needp, blkp, color, ds, img, j)
            << (8 * l);
    }
    if (whole) {
      *reinterpret_cast<uint32_t*>(mask + j0) = mw;
    } else {
      for (int l = 0; j0 + l < size; ++l) mask[j0 + l] = (mw >> (8 * l)) & 1u;
    }
  }
}

}  // namespace vx
