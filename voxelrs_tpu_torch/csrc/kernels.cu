// Kernels K1 (ESVO ray-batch traversal), K3 (the fused per-pixel frame),
// K4 (CSVO ray-batch traversal), K5 (the picker), K6 (compaction,
// k6_compact.cuh), K7 (beam floors, k7_beams.cuh), K8 (sun certificates,
// k8_sun.cuh), the stages of the deferred frame and K9 (the adaptive
// thick-ray frame: of an opaque world, k9_adaptive.cuh, and of a
// translucent one, k9_judged.cuh; with a pose dimension, K10), P0 (the
// gather probe, p0_gather.cuh), with a plain C interface for ctypes
// (see voxelrs_tpu_torch/_build.py). K3, K5 and the deferred stages that
// trace are templates on the world format: an ESVO buffer (K1's traversal)
// or a CSVO byte stream (K4's), each instantiated once.
//
// K1 replaces voxelrs_tpu/ops/traversal.py::intersect_octree (:1087), the
// translucent classic loop and its finalize: one thread per ray, the
// traversal in k1_traversal.cuh. K4 replaces
// voxelrs_tpu/ops/traversal_csvo.py::intersect_octree_csvo (:151) the same
// way, with the CSVO cursor of k4_csvo_traversal.cuh.
//
// K3 replaces voxelrs_tpu/ops/shading.py::render_frame (:4067) with
// generate_rays :119, the primary intersect_octree, surface_shading :153
// (with texture.py::sample_texture_lod :23 and the paired-atlas branch
// :199-214), shade_hits :259 (shadow ray) and sky_color :142: one thread per
// pixel (4x8 pixel tiles a warp, which the warps of a resident grid of
// 64-thread blocks take from a counter) runs raygen, the primary trace,
// shading, the shadow trace and the composite through one shared-memory
// stack, writing the (H, W, 4) frame once, a pixel a 16-byte store; its
// CSVO instantiation is the JAX Svo.render of a CSVO buffer
// (graphics/svo.py:292-331), whose shadow rays get the frame's step
// budget. The small-table lookups that
// the TPU version turns into one-hot reductions (ops/smalltab.py) are plain
// indexed loads here.
//
// K5 replaces voxelrs_tpu/graphics/svo.py::_raycast_fn (:526-557), the
// picker: each task of an (n, 7) [max_dst, pos.xyz, dir.xyz] batch is cast
// opaque (no alpha judge) and its hit packed into one (n, 8) float32 row
// [dst, inside, pos.xyz, normal.xyz] (the CSVO instantiation replaces the
// CSVO branch :535-541). A batch holds 8 or 32 tasks (the look ray, or
// one player AABB sweep) of at most 30 blocks each: the longest task's
// chain of dependent loads sets the kernel's time, so a task gets a warp
// of its own (k5_picker_kernel). Around it, the caller's upload and copy
// back cost more than the kernel: vx_k5_pick does the whole pick in one
// call from pinned host memory and waits for its rows.
//
// The deferred frame replaces voxelrs_tpu/ops/shading.py::
// render_frame_deferred (:3058) in its non-adaptive configuration: the
// opaque branch (_render_frame_opaque :3495 -> _opaque_frame_body :3722)
// and the judged one (:3122-3176). Its stages are kernels built from K3's
// own device functions (gen_ray, shade_surface, composite, sky) and the
// one traversal: kd_primary (raygen, the trace from the tile floor of K7,
// the hit record, the sky), kd_shade (one thread per compacted hit lane:
// surface shading, the lit colour, the shadow candidate flag and origin),
// kd_shadow (the compacted candidates, a resident grid looping up to
// their count: the shadow trace, floored by K7/K8 where the branch floors)
// and kd_finish (the shadowed colour of the blocked candidates). Between them K6 compacts on the card, and each
// stage reads the count K6 left in device memory. The adaptive frame
// (k9_adaptive.cuh) replaces kd_primary with K9's grid traces, merges and
// finalize, and runs the shadow stages twice around K9's shadow cells; its
// judged variant (k9_judged.cuh) does the same with judged traces and a
// result-level merge.
//
// K10 replaces voxelrs_tpu/ops/shading.py::render_frames_opaque_batch
// (:3580), a lax.map of the opaque frame over N poses in one XLA program,
// whose point is to pay the per-dispatch floor once per batch. Here it is
// the opaque frame's stages with a pose dimension, each launched once for
// all N poses (kd_primary, kd_shade, K9's four kernels, K6 with segment
// starts; kd_shadow, kd_finish, K7's shadow floors and K8 over the
// concatenated lanes, which need no camera): pose-major lanes, each pose's
// camera from a (N, 12) device array (pose_params), its tile floors from
// its block of the stacked floors. There is no second copy of a kernel:
// one frame is the case N = 1.
//
// What bounds them on an H100: the traversal's dependent loads and branch
// divergence (see k1_traversal.cuh); the bytes each kernel must move (rays
// in, hit records or the frame out) are a small share. A launch that
// traces lasts as long as its slowest warp's chain of steps, so K3 and
// K9's and K9-judged's traces give a warp a 4x8 pixel tile (its rays leave
// from one patch and take like paths; kd_primary's warps too) and keep
// the stack in shared memory (World::trace_shared; kd_primary and
// kd_shadow too). Where a launch's work is a count only the card
// knows (K6's), a grid sized by the list's capacity is mostly empty
// blocks: K6, K9's and K9-judged's traces, kd_shadow, kd_finish, K7's
// shadow floors, K8 and K9's shadow cells launch at most the blocks the
// card holds at once (resident_grid), each looping up to the count; K3's
// warps take the frame's tiles from a counter on such a grid. K7's tile
// floors give a tile's beam a group of lanes (k7_beams.cuh).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (-fmad=false keeps the
//        separate multiplies and adds of the reference, which the mantissa
//        PUSH/POP depend on).

#include <cuda_runtime.h>

#include <cstdint>

#include "k1_traversal.cuh"
#include "k4_csvo_traversal.cuh"
#include "k6_compact.cuh"
#include "k7_beams.cuh"
#include "k8_sun.cuh"
#include "p0_gather.cuh"

namespace vx {

constexpr int BLOCK = 128;

// Per-frame inputs of K3 (mirrored by _build.FrameParams).
struct FrameParams {
  int width, height;
  int render_shadows;
  int primary_budget;  // step budget of the primary rays
  int shadow_budget;   // K3 ESVO: MAX_STEPS (1000); CSVO and the deferred
                       // frame: the primary budget
  int trilinear;       // 1 = LINEAR_MIPMAP_LINEAR shading (VOXELRS_TRILINEAR)
  float cam_pos[3], right[3], up[3], fwd[3];
  float aspect, tan_half, ambient, shadow_distance;
  float light_dir[3];
  float highlight[3];  // NaN = no highlighted block
  float sky[3], horizon[3];
};

__constant__ float FACE_N[6][3] = {{-1, 0, 0}, {1, 0, 0}, {0, -1, 0},
                                   {0, 1, 0},  {0, 0, -1}, {0, 0, 1}};
__constant__ float FACE_T[6][3] = {{0, 0, 1}, {0, 0, -1}, {1, 0, 0},
                                   {1, 0, 0}, {-1, 0, 0}, {1, 0, 0}};
__constant__ float FACE_B[6][3] = {{0, 1, 0}, {0, 1, 0}, {0, 0, 1},
                                   {0, 0, 1}, {0, 1, 0}, {0, 1, 0}};

// The world formats K3 and K5 are instantiated on: each traces one ray
// with its own traversal.
struct EsvoWorld {
  const uint32_t* __restrict__ desc;
  uint32_t n_rows;

  // trace with the stack in shared memory and the cursor's pointer
  // prefetch (EsvoCursorT<true>): K3, K5, kd_primary, K9's and
  // K9-judged's traces and the shadow stage
  __device__ __forceinline__ void trace_shared(
      float octree_scale, float ox, float oy, float oz, float dx, float dy,
      float dz, float max_dst, int budget, int alpha_mode,
      const TexTables& tx, Hit& out, bool floored, float t_floor,
      SharedStack::Source src) const {
    traverse_with<EsvoCursorT<true>, SharedStack>(
        EsvoCursorT<true>(desc, n_rows), octree_scale, ox, oy, oz, dx, dy, dz,
        max_dst, budget, alpha_mode, tx, out, floored, t_floor, src);
  }
};

struct CsvoWorld {
  const uint32_t* __restrict__ words;
  uint32_t n_words;
  uint32_t root_ptr;
  int total_depth;

  __device__ __forceinline__ void trace(float octree_scale, float ox,
                                        float oy, float oz, float dx,
                                        float dy, float dz, float max_dst,
                                        int budget, int alpha_mode,
                                        const TexTables& tx, Hit& out,
                                        bool floored = false,
                                        float t_floor = 0.f) const {
    traverse_csvo(words, n_words, root_ptr, total_depth, octree_scale, ox, oy,
                  oz, dx, dy, dz, max_dst, budget, alpha_mode, tx, out,
                  floored, t_floor);
  }

  // trace with the stack in shared memory (as EsvoWorld's; the CSVO
  // cursor's pointer follows its header, so it has no prefetch)
  __device__ __forceinline__ void trace_shared(
      float octree_scale, float ox, float oy, float oz, float dx, float dy,
      float dz, float max_dst, int budget, int alpha_mode,
      const TexTables& tx, Hit& out, bool floored, float t_floor,
      SharedStack::Source src) const {
    traverse_with<CsvoCursor, SharedStack>(
        CsvoCursor(words, n_words, root_ptr, total_depth), octree_scale, ox,
        oy, oz, dx, dy, dz, max_dst, budget, alpha_mode, tx, out, floored,
        t_floor, src);
  }
};

// K1: one thread per ray of a batch in 128-thread blocks, the stack in
// local memory, the ESVO cursor without the pointer prefetch. Of the
// shapes measured on pose 0's rays (PERF.md §6), the frame kernels'
// forms (64-thread blocks, the stack in shared memory, the outputs staged
// through shared memory and stored as 16-byte words) were 4-8% slower,
// the staging alone 4%, and the prefetching cursor 1.2%.
__global__ void __launch_bounds__(BLOCK)
k1_traverse_kernel(const uint32_t* __restrict__ desc, uint32_t n_rows,
                   float octree_scale, const float* __restrict__ ro,
                   const float* __restrict__ rd, const float* __restrict__ max_dst,
                   int n, int budget, int alpha_mode, TexTables tx,
                   float* __restrict__ t, uint32_t* __restrict__ value,
                   int* __restrict__ face, float* __restrict__ pos,
                   float* __restrict__ uv, float* __restrict__ lod,
                   uint8_t* __restrict__ inside, int* __restrict__ steps,
                   const float* __restrict__ t_floor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Hit hit;
  traverse(desc, n_rows, octree_scale, ro[3 * i], ro[3 * i + 1], ro[3 * i + 2],
           rd[3 * i], rd[3 * i + 1], rd[3 * i + 2], max_dst[i], budget,
           alpha_mode, tx, hit, t_floor != nullptr,
           t_floor ? t_floor[i] : 0.f);
  t[i] = hit.t;
  value[i] = hit.value;
  face[i] = hit.face;
  pos[3 * i] = hit.pos[0];
  pos[3 * i + 1] = hit.pos[1];
  pos[3 * i + 2] = hit.pos[2];
  uv[2 * i] = hit.u;
  uv[2 * i + 1] = hit.v;
  lod[i] = hit.lod;
  inside[i] = hit.inside ? 1 : 0;
  steps[i] = hit.steps;
}

__global__ void __launch_bounds__(BLOCK)
k4_traverse_kernel(CsvoWorld world, float octree_scale,
                   const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ max_dst, int n, int budget,
                   int alpha_mode, TexTables tx, float* __restrict__ t,
                   uint32_t* __restrict__ value, int* __restrict__ face,
                   float* __restrict__ pos, float* __restrict__ uv,
                   float* __restrict__ lod, uint8_t* __restrict__ inside,
                   int* __restrict__ steps, const float* __restrict__ t_floor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Hit hit;
  world.trace(octree_scale, ro[3 * i], ro[3 * i + 1], ro[3 * i + 2], rd[3 * i],
              rd[3 * i + 1], rd[3 * i + 2], max_dst[i], budget, alpha_mode, tx,
              hit, t_floor != nullptr, t_floor ? t_floor[i] : 0.f);
  t[i] = hit.t;
  value[i] = hit.value;
  face[i] = hit.face;
  pos[3 * i] = hit.pos[0];
  pos[3 * i + 1] = hit.pos[1];
  pos[3 * i + 2] = hit.pos[2];
  uv[2 * i] = hit.u;
  uv[2 * i + 1] = hit.v;
  lod[i] = hit.lod;
  inside[i] = hit.inside ? 1 : 0;
  steps[i] = hit.steps;
}

__device__ void sky_color(const FrameParams& fp, float rdx, float rdz,
                          float* rgb) {
  const float horiz = sqrtf(rdx * rdx + rdz * rdz);
  const float a = acosf(clampf(horiz, 0.f, 1.f));
  float grad = a / 1.57079637050628662109375f;  // float(pi / 2)
  const float g1 = 1.f - grad;
  grad = 1.f - g1 * g1 * g1;
  for (int k = 0; k < 3; ++k)
    rgb[k] = fp.horizon[k] * (1.f - grad) + fp.sky[k] * grad;
}

// generate_rays: the direction of pixel (y, x) (row 0 = top of the image).
__device__ __forceinline__ void gen_ray_yx(const FrameParams& fp, int y,
                                           int x, float* rd) {
  const float px = (float)x;
  const float py = (float)y;
  float u = px / (float)fp.width * 2.f - 1.f;
  float v = ((float)(fp.height - 1) - py) / (float)fp.height * 2.f - 1.f;
  u = u * fp.aspect * fp.tan_half;
  v = v * fp.tan_half;
  for (int k = 0; k < 3; ++k) rd[k] = u * fp.right[k] + v * fp.up[k] + fp.fwd[k];
  const float rn = sqrtf(rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2]);
  for (int k = 0; k < 3; ++k) rd[k] = rd[k] / rn;
}

// generate_rays: the direction of pixel i (row-major).
__device__ __forceinline__ void gen_ray(const FrameParams& fp, int i,
                                        float* rd) {
  gen_ray_yx(fp, i / fp.width, i % fp.width, rd);
}

// K10, a batch of poses: the lanes of a batched launch are pose-major
// (lane = pose * n + i for the n lanes of one pose), and `cams` holds each
// pose's camera as one row of a (n_poses, 12) float32 array [cam_pos,
// right, up, fwd]; null is one frame, whose camera is fp's own. Every
// other field of fp is shared by the poses (the JAX batch takes pose 0's,
// graphics/svo.py:458-470). A launch's lane count stays under 2^31
// (ops/shading.py::check_batch), so lanes are ints.
__device__ __forceinline__ FrameParams pose_params(
    const FrameParams& fp, const float* __restrict__ cams, int pose) {
  FrameParams f = fp;
  if (cams) {
    const float* c = cams + 12 * (size_t)pose;
    for (int k = 0; k < 3; ++k) {
      f.cam_pos[k] = c[k];
      f.right[k] = c[3 + k];
      f.up[k] = c[6 + k];
      f.fwd[k] = c[9 + k];
    }
  }
  return f;
}

// The tile floors of pose `pose`: (n_poses, ceil(H/8), ntx) float32, one
// pose's (ceil(H/8), ntx) block after another; null stays null.
__device__ __forceinline__ const float* pose_floors(const FrameParams& fp,
                                                    const float* tf, int ntx,
                                                    int pose) {
  return tf ? tf + (size_t)pose * ((fp.height + 7) >> 3) * ntx : nullptr;
}

// surface_shading of a hit: its colour, mapped normal n and the light
// terms ds = diffuse + specular.
__device__ void shade_surface(const TexTables& tx, const FrameParams& fp,
                              const Hit& p, float4& color, float* n,
                              float& ds) {
  const int vi = clampi((int)p.value, 0, tx.mat_rows - 1);
  const int slot = p.face == 3 ? 0 : (p.face == 2 ? 2 : 1);
  const int* mrow = tx.mat_tex + vi * tx.mat_cols;
  const float spec_pow = fmaxf(tx.mat_params[2 * vi], 1e-6f);
  const float spec_strength = tx.mat_params[2 * vi + 1];
  const int nlayer = mrow[3 + slot];
  const bool linear = fp.trilinear != 0;
  float4 ntex;
  if (tx.mat_cols >= 9) {  // paired colour+normal atlas
    const int pid = clampi(mrow[6 + slot], 0, tx.pair_cap - 1);
    color = sample_lod(tx, tx.pair_color[pid], p.u, p.v, p.lod, linear);
    ntex = sample_lod(tx, tx.pair_normal[pid], p.u, p.v, p.lod, linear);
  } else {
    color = sample_lod(tx, mrow[slot], p.u, p.v, p.lod, linear);
    ntex = sample_lod(tx, nlayer, p.u, p.v, p.lod, linear);
  }

  // block highlight outline
  const bool same_block = floorf(p.pos[0]) == floorf(fp.highlight[0]) &&
                          floorf(p.pos[1]) == floorf(fp.highlight[1]) &&
                          floorf(p.pos[2]) == floorf(fp.highlight[2]);
  const float lmax = fmaxf(fabsf(p.u - 0.5f) * 2.f, fabsf(p.v - 0.5f) * 2.f);
  if (same_block && lmax > 0.9375f) color = make_float4(1.f, 1.f, 1.f, 1.f);

  // normal mapping (.xzy swizzle: blue = up)
  const int f = clampi(p.face, 0, 5);
  if (nlayer != -1) {
    float s0 = ntex.x * 2.f - 1.f, s1 = ntex.z * 2.f - 1.f, s2 = ntex.y * 2.f - 1.f;
    const float sn = sqrtf(s0 * s0 + s1 * s1 + s2 * s2);
    s0 = s0 / sn;
    s1 = s1 / sn;
    s2 = s2 / sn;
    for (int k = 0; k < 3; ++k)
      n[k] = s0 * FACE_T[f][k] + s1 * FACE_N[f][k] + s2 * FACE_B[f][k];
  } else {
    for (int k = 0; k < 3; ++k) n[k] = FACE_N[f][k];
  }
  float inc[3];
  for (int k = 0; k < 3; ++k) inc[k] = -fp.light_dir[k];
  const float diffuse = fmaxf(n[0] * inc[0] + n[1] * inc[1] + n[2] * inc[2], 0.f);
  float vd[3];
  for (int k = 0; k < 3; ++k) vd[k] = p.pos[k] - fp.cam_pos[k];
  const float vn = fmaxf(sqrtf(vd[0] * vd[0] + vd[1] * vd[1] + vd[2] * vd[2]), 1e-12f);
  for (int k = 0; k < 3; ++k) vd[k] = vd[k] / vn;
  const float ndi2 = 2.f * (n[0] * inc[0] + n[1] * inc[1] + n[2] * inc[2]);
  float refl[3];
  for (int k = 0; k < 3; ++k) refl[k] = inc[k] - ndi2 * n[k];
  const float spec_dot =
      fmaxf(vd[0] * refl[0] + vd[1] * refl[1] + vd[2] * refl[2], 0.f);
  const float specular = powf(spec_dot, spec_pow) * spec_strength;
  ds = diffuse + specular;
}

// The shaded pixel: colour times the clamped light.
__device__ __forceinline__ float4 shaded(const FrameParams& fp, float4 color,
                                         float ds, float shadow) {
  const float light = clampf(fp.ambient + ds * shadow, 0.f, 1.f);
  return make_float4(color.x * light, color.y * light, color.z * light,
                     color.w);
}

__device__ __forceinline__ void composite(const FrameParams& fp, float4 color,
                                          float ds, float shadow, float* out) {
  const float4 c = shaded(fp, color, ds, shadow);
  out[0] = c.x;
  out[1] = c.y;
  out[2] = c.z;
  out[3] = c.w;
}

// Threads of a block of the kernels that trace pixel rays in 4x8 tiles
// (K3, K9's and K9-judged's traces): two warps, so that a block's shared
// stacks (STACK_HEIGHT x 8 bytes a thread) take 6 KB.
constexpr int TILE_THREADS = 64;

// Work item m of a launch over grids of wl x hl lanes -> its lane, or -1.
// A list: lane idx[m]. The whole grid (idx null): item m is lane (l >> 3,
// l & 7) of 4x8 tile m / 32 (row-major tiles of each pose's grid, poses
// one after another; lanes pose-major), so a warp's rays leave from a
// compact patch of pixels. Items past a grid's last row or column are -1.
// _build.tile_lanes mirrors it.
__device__ __forceinline__ int tile_lane(int m, const int* __restrict__ idx,
                                         int wl, int hl) {
  if (idx) return idx[m];
  const int tx = (wl + 7) >> 3, ty = (hl + 3) >> 2;
  const int t = m >> 5, l = m & 31;
  const int pose = t / (tx * ty), tp = t - pose * tx * ty;
  const int y = (tp / tx) * 4 + (l >> 3), x = (tp % tx) * 8 + (l & 7);
  return y < hl && x < wl ? pose * wl * hl + y * wl + x : -1;
}

// K3: a warp takes the frame's 4x8 pixel tiles one at a time from the
// launch's tile counter (tiles[0]; a tile is the 32 items m of tile_lane,
// items m < items); a lane runs its pixel's raygen, primary trace,
// shading, shadow trace and composite, and writes the pixel once as one
// 16-byte word (img starts on one: _build.check_k3). Both rays trace
// through the block's shared stacks (World::trace_shared), one column a
// thread. The grid is at most the blocks the card holds at once
// (k3_frame_launch); taking tiles from a counter keeps its warps busy to
// the end, where a fixed share of the tiles a warp (a block looping over
// every gridDim-th tile) left the warps whose tiles trace short idle while
// the others ran on (13-16% slower on an H100 on the bench poses,
// chip_smoke.py --renderer-only). tiles[1] counts the warps that found no
// tile left; the last one sets both back to 0, so the counters are 0 at
// every launch's start (zeroed when allocated; one launch at a time uses
// them). steps_out null, or each pixel's steps, primary plus shadow.
template <class World>
__global__ void __launch_bounds__(TILE_THREADS)
k3_frame_kernel(World world, float octree_scale, TexTables tx, FrameParams fp,
                int items, int* __restrict__ tiles, float4* __restrict__ img,
                int* __restrict__ steps_out) {
  __shared__ uint32_t s_node[STACK_HEIGHT * TILE_THREADS];
  __shared__ float s_tmax[STACK_HEIGHT * TILE_THREADS];
  const SharedStack::Source stack{s_node + threadIdx.x, s_tmax + threadIdx.x,
                                  TILE_THREADS};
  const int lane = threadIdx.x & 31;
  const int ntiles = items >> 5;
  for (;;) {
    int t = lane == 0 ? atomicAdd(tiles, 1) : 0;
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= ntiles) break;
    const int i = tile_lane(t * 32 + lane, nullptr, fp.width, fp.height);
    if (i >= 0) {
      float rd[3];
      gen_ray(fp, i, rd);

      Hit p;
      world.trace_shared(octree_scale, fp.cam_pos[0], fp.cam_pos[1],
                         fp.cam_pos[2], rd[0], rd[1], rd[2], -1.f,
                         fp.primary_budget, 1, tx, p, false, 0.f, stack);
      int steps = p.steps;
      float4 c;
      if (p.t == -1.f) {
        float rgb[3];
        sky_color(fp, rd[0], rd[2], rgb);
        c = make_float4(rgb[0], rgb[1], rgb[2], 1.f);
      } else {
        float4 color;
        float n[3], ds;
        shade_surface(tx, fp, p, color, n, ds);

        // ---- shade_hits: shadow ray -------------------------------------
        float shadow = 1.f;
        if (fp.render_shadows && p.t < fp.shadow_distance) {
          Hit s;
          world.trace_shared(octree_scale, p.pos[0] + n[0] * 0.001f,
                             p.pos[1] + n[1] * 0.001f,
                             p.pos[2] + n[2] * 0.001f, -fp.light_dir[0],
                             -fp.light_dir[1], -fp.light_dir[2], -1.f,
                             fp.shadow_budget, 1, tx, s, false, 0.f, stack);
          steps += s.steps;
          shadow = s.t < 0.f ? 1.f : 0.f;
        }
        c = shaded(fp, color, ds, shadow);
      }
      img[i] = c;
      if (steps_out) steps_out[i] = steps;
    }
  }
  if (lane == 0) {
    __threadfence();  // this warp's takes before its count
    if (atomicAdd(tiles + 1, 1) == (int)(gridDim.x * (TILE_THREADS / 32)) - 1) {
      tiles[0] = 0;
      tiles[1] = 0;
    }
  }
}

// ---- the deferred frame's stages ---------------------------------------

// A primary hit as kd_primary stores it (9 words a pixel).
struct HitRec {
  float t;  // -1 = miss
  uint32_t value;
  int face;
  float pos[3];
  float u, v, lod;
};
constexpr int HIT_WORDS = sizeof(HitRec) / 4;
static_assert(HIT_WORDS == 9, "HitRec: t, value, face, pos, u, v, lod");

__device__ __forceinline__ int count_of(const int* __restrict__ count,
                                        int size) {
  const int c = *count;
  return c < size ? c : size;
}

// The HitRec of a trace's hit (or miss: t = -1 and the trace's other
// fields) as its 9 words at w.
__device__ __forceinline__ void put_hitrec(const Hit& p, uint32_t* w) {
  w[0] = __float_as_uint(p.t);
  w[1] = p.value;
  w[2] = (uint32_t)p.face;
  for (int k = 0; k < 3; ++k) w[3 + k] = __float_as_uint(p.pos[k]);
  w[6] = __float_as_uint(p.u);
  w[7] = __float_as_uint(p.v);
  w[8] = __float_as_uint(p.lod);
}

// Threads of a kd_primary block (kd_primary_launch): two warps, so that a
// block's shared stacks take 6 KB, on a 16 x 4 patch of one pose's pixels.
// Registers are capped at 72 a thread, so that an SM holds
// KD_PRIMARY_BLOCKS_PER_SM blocks: left to itself the compiler gave the
// kernel 80-94 and it ran 1.5-6% slower on ESVO; a cap of 64 spilled and
// was 1-3% slower (chip_smoke.py --kernels-only; PERF.md §6).
constexpr int KD_PRIMARY_THREADS = 64, KD_PRIMARY_BLOCKS_PER_SM = 14;

// Raygen, the primary trace from the pixel's tile floor (tf[py/8][px/8] of
// K7; tf null = unfloored), the hit record and flag, the sky of a miss:
// one thread per pixel of each of the n_poses poses (K10: lane = pose *
// W * H + pixel, the pose's camera from cams and its floors from tf).
//
// What bounds it on an H100: the traversal's chain of dependent loads (a
// block lasts as long as its slowest warp's steps), then its stores: 37
// bytes a pixel out, and 16 more for a miss's sky. So a block takes a
// 16 x 4 patch of one pose's pixels, warp w its 8 x 4 tile at column 8w,
// which lies inside one 8 x 8 floor tile of K7 (its rays leave from one
// floor); the trace keeps its stack in the block's shared memory with
// ESVO's child pointer loaded beside its descriptor (World::trace_shared);
// the block's HitRecs and flags are staged in shared memory (pixel (r, c)
// of the patch at slot 16r + c, HitRecs at an odd word stride, so the 32
// lanes of a warp write 32 banks) and each row of the patch goes out as
// 16-byte words where its first lane is a multiple of 4 (its span starts
// on one), else as words, its flags as one 16-byte word where the row is
// whole and starts on one, else byte by byte; a miss's sky is one 16-byte
// store. rec, hit and img start on a 16-byte word
// (_build.launch_kd_primary checks). Of the shapes measured
// (chip_smoke.py --kernels-only; PERF.md §6), blocks of 64 consecutive
// lanes (a warp 32 pixels of a row) were 4% slower on CSVO and within 1%
// on ESVO.
template <class World>
__global__ void __launch_bounds__(KD_PRIMARY_THREADS,
                                  KD_PRIMARY_BLOCKS_PER_SM)
kd_primary_kernel(World world, float octree_scale, TexTables tx,
                  FrameParams fp, const float* __restrict__ cams,
                  int alpha_mode, const float* __restrict__ tf, int ntx,
                  HitRec* __restrict__ rec, uint8_t* __restrict__ hit,
                  float4* __restrict__ img) {
  constexpr int P = KD_PRIMARY_THREADS;
  __shared__ uint32_t s_node[STACK_HEIGHT * P];
  __shared__ float s_tmax[STACK_HEIGHT * P];
  __shared__ uint4 s_rec[HIT_WORDS * P / 4];
  __shared__ uint4 s_hit[P / 16];
  const SharedStack::Source stack{s_node + threadIdx.x, s_tmax + threadIdx.x,
                                  P};
  const int t = threadIdx.x;
  const int B = fp.width * fp.height;
  const int nbx = (fp.width + 15) >> 4, nby = (fp.height + 3) >> 2;
  const int pose = blockIdx.x / (nbx * nby), b = blockIdx.x % (nbx * nby);
  const int x0 = (b % nbx) * 16, y0 = (b / nbx) * 4;
  const int r = (t & 31) >> 3, c = ((t >> 5) << 3) | (t & 7);
  const int slot = r * 16 + c;
  if (y0 + r < fp.height && x0 + c < fp.width) {
    const int px = (y0 + r) * fp.width + x0 + c;
    const FrameParams f = pose_params(fp, cams, pose);
    float rd[3];
    gen_ray(f, px, rd);
    const float* tfp = pose_floors(fp, tf, ntx, pose);
    const float t_floor =
        tfp ? tfp[((px / fp.width) >> 3) * ntx + ((px % fp.width) >> 3)]
            : 0.f;
    Hit p;
    world.trace_shared(octree_scale, f.cam_pos[0], f.cam_pos[1],
                       f.cam_pos[2], rd[0], rd[1], rd[2], -1.f,
                       fp.primary_budget, alpha_mode, tx, p, tf != nullptr,
                       t_floor, stack);
    put_hitrec(p, reinterpret_cast<uint32_t*>(s_rec) + HIT_WORDS * slot);
    reinterpret_cast<uint8_t*>(s_hit)[slot] = p.t != -1.f ? 1 : 0;
    if (p.t == -1.f) {
      float rgb[3];
      sky_color(f, rd[0], rd[2], rgb);
      img[(long long)pose * B + px] = make_float4(rgb[0], rgb[1], rgb[2], 1.f);
    }
  }
  __syncthreads();
  const int n = min(16, fp.width - x0);
  const int words = HIT_WORDS * n;
  for (int rr = 0; rr < 4 && y0 + rr < fp.height; ++rr) {
    const long long l0 = (long long)pose * B + (long long)(y0 + rr) * fp.width
                         + x0;
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(s_rec) +
                         HIT_WORDS * 16 * rr;
    int q = t;
    if ((l0 & 3) == 0) {
      uint4* dst = reinterpret_cast<uint4*>(rec + l0);
      for (; q < words / 4; q += P)
        dst[q] = reinterpret_cast<const uint4*>(sw)[q];
      q = (words & ~3) + t;
    }
    for (; q < words; q += P) reinterpret_cast<uint32_t*>(rec + l0)[q] = sw[q];
    if (n == 16 && (l0 & 15) == 0) {
      if (t == 0) reinterpret_cast<uint4*>(hit + l0)[0] = s_hit[rr];
    } else if (t < n) {
      hit[l0 + t] = reinterpret_cast<const uint8_t*>(s_hit)[16 * rr + t];
    }
  }
}

// One thread per compacted hit lane j < *hcount (pixel hidx[j]): surface
// shading; the pixel gets its lit colour (shadow 1), and the lane its
// colour, light terms, shadow-candidate flag (lanes past the count: 0) and
// shadow origin. K10: hidx holds batch lanes, whose pose (hidx[j] / (W *
// H)) gives the camera the specular term views from.
__global__ void __launch_bounds__(BLOCK)
kd_shade_kernel(TexTables tx, FrameParams fp, const float* __restrict__ cams,
                const int* __restrict__ hidx,
                const int* __restrict__ hcount, int size,
                const HitRec* __restrict__ rec, float4* __restrict__ color,
                float* __restrict__ ds_out, uint8_t* __restrict__ need,
                float* __restrict__ sro, float* __restrict__ img) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= size) return;
  if (j >= count_of(hcount, size)) {
    need[j] = 0;
    return;
  }
  const int px = hidx[j];
  const FrameParams f = pose_params(fp, cams, px / (fp.width * fp.height));
  const HitRec r = rec[px];
  Hit p;
  p.t = r.t;
  p.value = r.value;
  p.face = r.face;
  for (int k = 0; k < 3; ++k) p.pos[k] = r.pos[k];
  p.u = r.u;
  p.v = r.v;
  p.lod = r.lod;
  float4 c;
  float n[3], ds;
  shade_surface(tx, f, p, c, n, ds);
  color[j] = c;
  ds_out[j] = ds;
  // a shadow only matters where it can darken something
  need[j] = (fp.render_shadows && p.t < fp.shadow_distance && ds > 0.f) ? 1 : 0;
  for (int k = 0; k < 3; ++k) sro[3 * (size_t)j + k] = p.pos[k] + n[k] * 0.001f;
  composite(fp, c, ds, 1.f, img + 4 * (size_t)px);
}

// Threads of a kd_shadow block (kd_shadow_launch): two warps, as K9's
// trace, so that a block's shared stacks take 6 KB.
constexpr int KD_SHADOW_THREADS = 64;

// The shadow trace of slot m < count of the candidate list (sidx,
// *scount) or, with tidx, of its uncertified sub-list (tidx, *tcount);
// floors (per candidate) null = unfloored; alpha_mode 0 casts opaque rays,
// 1 judges texel alpha (the judged frames). traced[c] = the candidate's
// ray hit something. A shadow ray needs no camera, so a batch (K10) runs
// the candidates of all its poses in one launch unchanged.
//
// Replaces the shadow trace of voxelrs_tpu/ops/shading.py's opaque
// two-pass shadow (:3912-4037: the uncertified candidates of each pass
// after the sun map's verdicts, or every candidate from its floor) and
// the judged frame's shadow rays (:3384-3474, certified :3424-3449).
//
// What bounds it on an H100: the traversal's chain of dependent loads (a
// launch lasts as long as its slowest warp's steps), not its bytes (an
// index, an origin and a floor in, a byte out), and, at the counts a frame
// leaves (~25,600 uncertified rays of 2,073,600 slots), the blocks that
// find no work. So the grid is at most the blocks the card holds at once
// (kd_shadow_launch), each block looping over slots up to the count K6
// left on the card, and the trace is K9's: the stack in shared memory and
// ESVO's child pointer loaded beside its descriptor (World::trace_shared),
// 64-thread blocks.
template <class World>
__global__ void __launch_bounds__(KD_SHADOW_THREADS)
kd_shadow_kernel(World world, float octree_scale, TexTables tx,
                 FrameParams fp, int alpha_mode, const float* __restrict__ sro,
                 const int* __restrict__ sidx, const int* __restrict__ scount,
                 const int* __restrict__ tidx, const int* __restrict__ tcount,
                 const float* __restrict__ floors, int size,
                 uint8_t* __restrict__ traced) {
  __shared__ uint32_t s_node[STACK_HEIGHT * KD_SHADOW_THREADS];
  __shared__ float s_tmax[STACK_HEIGHT * KD_SHADOW_THREADS];
  const SharedStack::Source stack{s_node + threadIdx.x, s_tmax + threadIdx.x,
                                  KD_SHADOW_THREADS};
  const int n = count_of(tidx ? tcount : scount, size);
  for (int m = blockIdx.x * KD_SHADOW_THREADS + threadIdx.x; m < n;
       m += gridDim.x * KD_SHADOW_THREADS) {
    const int c = tidx ? tidx[m] : m;
    const size_t j = (size_t)sidx[c];
    Hit s;
    world.trace_shared(octree_scale, sro[3 * j], sro[3 * j + 1],
                       sro[3 * j + 2], -fp.light_dir[0], -fp.light_dir[1],
                       -fp.light_dir[2], -1.f, fp.shadow_budget, alpha_mode,
                       tx, s, floors != nullptr, floors ? floors[c] : 0.f,
                       stack);
    traced[c] = s.t < 0.f ? 0 : 1;
  }
}

// Threads of a kd_finish block, and the consecutive candidate slots a
// thread takes at a time (kd_finish_kernel).
constexpr int KD_FINISH_THREADS = 128;
constexpr int KD_FINISH_SLOTS = 4;

// Each candidate c < *scount whose shadow ray is blocked gets its shadowed
// colour. Without certificates (blk null) every candidate was traced; with
// them, a candidate is blocked when K8 certified it so or it was left to
// trace (todo) and its trace hit. blkp (K9's first shadow pass) null, or
// the pixel-space verdicts, written at each candidate's pixel. Nothing at
// or past the count is written. A candidate needs no camera, so a batch
// (K10) runs the candidates of all its poses in one launch unchanged.
//
// Replaces, for the blocked lanes, voxelrs_tpu/ops/shading.py::
// finish_light (:2781; called at :3166, :3483, :4042) with the verdicts'
// _or_scatter of the certificates and the traces (:3466-3473,
// :4024-4036): the shadow factor 0 in the composite's light.
//
// What bounds it on an H100: bytes (a candidate's index and flags in, its
// hit lane's pixel index, colour and light gathered, a blocked pixel
// written) and, at the counts a frame leaves (~200,000 candidates of
// 2,073,600 slots at 1080p), the blocks that find no work. So the grid is
// at most the blocks the card holds at once (vx_kd_finish), each looping
// over words of KD_FINISH_SLOTS consecutive slots up to the count K6 left
// on the card: a word's indices as one 16-byte load, each of its flag
// arrays as one 4-byte load, a blocked pixel as one 16-byte store. sidx
// and img start on a 16-byte word, the flags on a 4-byte word
// (_build.launch_kd_finish checks).
__global__ void __launch_bounds__(KD_FINISH_THREADS)
kd_finish_kernel(FrameParams fp, const int* __restrict__ hidx,
                 const int* __restrict__ sidx, const int* __restrict__ scount,
                 int size, const float4* __restrict__ color,
                 const float* __restrict__ ds, const uint8_t* __restrict__ blk,
                 const uint8_t* __restrict__ todo,
                 const uint8_t* __restrict__ traced, float4* __restrict__ img,
                 uint8_t* __restrict__ blkp) {
  const int n = count_of(scount, size);
  const int words = (n + KD_FINISH_SLOTS - 1) / KD_FINISH_SLOTS;
  for (int i = blockIdx.x * KD_FINISH_THREADS + threadIdx.x; i < words;
       i += gridDim.x * KD_FINISH_THREADS) {
    const int c0 = i * KD_FINISH_SLOTS;
    int j[KD_FINISH_SLOTS];
    uint32_t tw = 0u, bw = 0u, dw = 0u;  // a flag byte a slot
    if (c0 + KD_FINISH_SLOTS <= size) {  // slots past the count unused
      const int4 s = *reinterpret_cast<const int4*>(sidx + c0);
      j[0] = s.x;
      j[1] = s.y;
      j[2] = s.z;
      j[3] = s.w;
      tw = *reinterpret_cast<const uint32_t*>(traced + c0);
      if (blk) {
        bw = *reinterpret_cast<const uint32_t*>(blk + c0);
        dw = *reinterpret_cast<const uint32_t*>(todo + c0);
      }
    } else {  // the list's last, partial word
      for (int l = 0; l < KD_FINISH_SLOTS; ++l) {
        const int c = c0 + l;
        j[l] = c < n ? sidx[c] : 0;
        if (c >= n) continue;
        tw |= (uint32_t)traced[c] << (8 * l);
        if (blk) {
          bw |= (uint32_t)blk[c] << (8 * l);
          dw |= (uint32_t)todo[c] << (8 * l);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < KD_FINISH_SLOTS; ++l) {
      if (c0 + l >= n) break;
      const bool hit = ((tw >> (8 * l)) & 0xffu) != 0u;
      const bool blocked =
          blk ? (((bw >> (8 * l)) & 0xffu) != 0u
                 || (((dw >> (8 * l)) & 0xffu) != 0u && hit))
              : hit;
      if (!blocked && !blkp) continue;
      const int px = hidx[j[l]];
      if (blkp) blkp[px] = blocked ? 1 : 0;
      if (blocked) img[px] = shaded(fp, color[j[l]], ds[j[l]], 0.f);
    }
  }
}

// K5, the picker: a warp a task [max_dst, pos.xyz, dir.xyz] of the
// batch, one block a warp, its row [dst, inside, pos.xyz, normal.xyz] out.
// A picker batch holds 8 or 32 tasks, so a launch's time is its longest
// task's chain of dependent steps: each task gets a warp of its own (no
// task waits on another's branches) and the stack in shared memory.
//
// `segments` S (1-32) lanes cast the task: K5_SEGMENTS in a pick (the other
// counts are timed and tested only). With S = 1, or max_dst at most
// K5_FIRST, lane 0 casts the ray (the classic loop with the budget). Else
// lane 0 casts [0, K5_FIRST] (a block's height or two: a ray that starts
// on or in a voxel passes through it there) and lanes k = 1 .. S - 1 the
// segments of [K5_FIRST, max_dst] at fractions (k - 1) / (S - 1) and k /
// (S - 1) (the last ending at max_dst), from that floor (traverse_with's
// floored start); the nearest hit wins, the lower lane on a tie (a warp
// reduction on the distance's bits, then the ballot's first lane). A lane
// that starts inside a leaf reports its floor, not the leaf's entry: the
// ray entered that leaf in an earlier segment, whose lane hits it or an
// earlier leaf first, unless the ray starts inside a voxel (`inside`,
// which only steps at t = 0 set: lane 0's), which the classic loop passes
// through. So lane 0 casts the whole ray after all where the winner hit
// at its floor, and where the budget could cut the classic loop: past lane
// 0's segment a ray probes each octree cell it crosses at most once, and
// a cast of length m (world units) with direction d in an octree of depth
// D (octree_scale = 2^-D; D = -ilogb(octree_scale), at least 0, rounds
// another scale's depth up) crosses at most 4 D + 2 m |d|_1 cells, so lane
// 0's steps plus 4 D + 3 + 2 m (|d|_1 + 1e-6) under the budget leaves the
// budget nothing to cut. ops.picker.raycast_split_plain is this split in
// plain PyTorch.
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr float K5_FIRST = 2.f;  // world units cast by lane 0 of a split
// lanes casting a task in a pick (_build.K5_SEGMENTS): 32 beat 1 and 8 on
// the games' sweeps and longest chains (PERF.md section 6)
constexpr int K5_SEGMENTS = 32;

template <class World>
__global__ void __launch_bounds__(32)
k5_picker_kernel(World world, float octree_scale,
                 const float* __restrict__ tasks, int budget, int segments,
                 float* __restrict__ out, int* __restrict__ steps) {
  __shared__ uint32_t s_node[STACK_HEIGHT * 32];
  __shared__ float s_tmax[STACK_HEIGHT * 32];
  const int lane = threadIdx.x;
  const SharedStack::Source stack{s_node + lane, s_tmax + lane, 32};
  const float* task = tasks + 7 * (size_t)blockIdx.x;
  const float md = task[0];
  const float o[3] = {task[1], task[2], task[3]};
  const float d[3] = {task[4], task[5], task[6]};
  const TexTables no_tables = {};  // the opaque cast reads no texture
  const bool split = segments > 1 && md > K5_FIRST;
  Hit hit;  // a lane that casts nothing: a miss of 0 steps
  hit.t = -1.f;
  hit.steps = 0;
  hit.inside = false;
  float floor_t = 0.f;
  if (lane < (split ? segments : 1)) {
    float end = md;
    if (split) {
      const float span = md - K5_FIRST, s = (float)(segments - 1);
      floor_t = lane == 0 ? 0.f : K5_FIRST + span * ((float)(lane - 1) / s);
      end = lane == 0 ? K5_FIRST
            : lane == segments - 1 ? md
            : K5_FIRST + span * ((float)lane / s);
    }
    world.trace_shared(octree_scale, o[0], o[1], o[2], d[0], d[1], d[2], end,
                       budget, 0, no_tables, hit, lane > 0, floor_t, stack);
  }
  int src = 0, chain = hit.steps;
  bool inside = hit.inside;
  if (split) {
    const uint32_t key = hit.t > 0.f ? __float_as_uint(hit.t) : FULL_MASK;
    const uint32_t best = __reduce_min_sync(FULL_MASK, key);
    src = __ffs(__ballot_sync(FULL_MASK, key == best)) - 1;
    const bool floor_hit =
        lane > 0 && hit.t == (floor_t * octree_scale) / octree_scale;
    const int depth = max(0, -ilogbf(octree_scale));
    const float cells =
        4.f * (float)depth + 3.f
        + 2.f * md * (((fabsf(d[0]) + fabsf(d[1])) + fabsf(d[2])) + 1e-6f);
    const int steps0 = __shfl_sync(FULL_MASK, hit.steps, 0);
    const bool redo =
        (float)steps0 + cells > (float)budget
        || (best != FULL_MASK && __shfl_sync(FULL_MASK, floor_hit, src));
    inside = __shfl_sync(FULL_MASK, hit.inside, 0);
    chain = (int)__reduce_max_sync(FULL_MASK, (unsigned)hit.steps);
    if (redo) {
      src = 0;
      if (lane == 0) {
        world.trace_shared(octree_scale, o[0], o[1], o[2], d[0], d[1], d[2],
                           md, budget, 0, no_tables, hit, false, 0.f, stack);
        inside = hit.inside;
        chain += hit.steps;
      }
    }
  }
  if (lane != src) return;
  const bool h = hit.t > 0.f;
  const int f = clampi(hit.face, 0, 5);
  float* row = out + 8 * (size_t)blockIdx.x;
  row[0] = h ? hit.t : -1.f;
  row[1] = (h && inside) ? 1.f : 0.f;
  for (int k = 0; k < 3; ++k) {
    row[2 + k] = h ? hit.pos[k] : 0.f;
    row[5 + k] = h ? FACE_N[f][k] : 0.f;
  }
  if (steps) steps[blockIdx.x] = chain;
}

inline int grid_for(long long n) { return (int)((n + BLOCK - 1) / BLOCK); }

// K5 on `n` tasks (n >= 1): a block of one warp a task.
template <class World>
int k5_launch(const World& world, float octree_scale, const float* tasks,
              int n, int budget, int segments, float* out, int* steps,
              cudaStream_t stream) {
  k5_picker_kernel<<<n, 32, 0, stream>>>(world, octree_scale, tasks, budget,
                                         segments, out, steps);
  return (int)cudaGetLastError();
}

// A whole pick on `stream`: the n padded tasks from pinned host memory
// onto the card, K5 (K5_SEGMENTS lanes a task), the rows back into pinned host memory, and a wait on
// an event recorded after that copy. The caller holds the interpreter lock
// throughout (a ctypes.PyDLL call), so the calls are never concurrent and
// one event serves them (one card a process, as resident_blocks).
template <class World>
int k5_pick(const World& world, float octree_scale, const float* host_tasks,
            float* dev_tasks, int n, int budget, float* dev_rows,
            float* host_rows, cudaStream_t stream) {
  static cudaEvent_t done = nullptr;
  int err = 0;
  if (done == nullptr)
    err = (int)cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
  if (!err)
    err = (int)cudaMemcpyAsync(dev_tasks, host_tasks, sizeof(float) * 7 * n,
                               cudaMemcpyHostToDevice, stream);
  if (!err)
    err = k5_launch(world, octree_scale, dev_tasks, n, budget, K5_SEGMENTS,
                    dev_rows, nullptr, stream);
  if (!err)
    err = (int)cudaMemcpyAsync(host_rows, dev_rows, sizeof(float) * 8 * n,
                               cudaMemcpyDeviceToHost, stream);
  if (!err) err = (int)cudaEventRecord(done, stream);
  if (!err) err = (int)cudaEventSynchronize(done);
  return err;
}

// The blocks of `threads` threads of `kernel` that the card holds at once
// (at least 1), asked at the first call and kept in `cache` (a launcher's
// own static: one card a process).
template <class Kernel>
int resident_blocks(Kernel kernel, int threads, int& cache) {
  if (cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    cache = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return cache;
}

// A grid for `items` work items, `per_block` to a block at a time, whose
// blocks loop over them: at most `cap` blocks, at least 1.
inline unsigned resident_grid(long long items, int per_block, long long cap) {
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1u : (unsigned)blocks;
}

// The items of a launch over a wl x hl grid in 4x8 tiles a warp
// (tile_lane with idx null): 32 a tile.
inline long long tile_items(int wl, int hl) {
  return (long long)((wl + 7) / 8) * ((hl + 3) / 4) * 32;
}

}  // namespace vx

#include "k9_adaptive.cuh"
#include "k9_judged.cuh"

// K9's trace launch (k9_adaptive.cuh k9_trace_kernel): the whole grid in
// 4x8 tiles a warp (items past a pose's last row or column are skipped),
// or the refine list's entries; a grid of at most the blocks the card
// holds at once for each of the n_poses poses, each block looping over
// its items, so a refine list's launch schedules few blocks past its
// count, which only the card knows.
template <class World>
static int k9_trace_launch(const World& world, float octree_scale,
                           const vx::FrameParams* fp, const float* cams,
                           const float* tf, int ntx, int level, const int* idx,
                           const int* count, int size, int n_poses, void* out,
                           void* stream) {
  const auto kernel = vx::k9_trace_kernel<World>;
  constexpr int threads = vx::K9_TRACE_THREADS;
  int wl, hl;
  vx::k9_dims(fp->width, fp->height, level, wl, hl);
  const long long items = idx ? size : n_poses * vx::tile_items(wl, hl);
  static int resident = 0;
  const unsigned blocks = vx::resident_grid(
      items, threads,
      (long long)vx::resident_blocks(kernel, threads, resident) *
          (n_poses > 0 ? n_poses : 1));
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      world, octree_scale, *fp, cams, tf, ntx, level, idx, count, (int)items,
      (vx::K9Rec*)out);
  return (int)cudaGetLastError();
}

// K3's launch (k3_frame_kernel): the frame's pixels in 4x8 tiles a warp, a
// grid of at most the blocks the card holds at once, whose warps take the
// tiles from the counters `tiles` (2 ints, 0 between launches). img starts
// on a 16-byte word (_build.check_k3).
template <class World>
static int k3_frame_launch(const World& world, float octree_scale,
                           const vx::TexTables* tex, const vx::FrameParams* fp,
                           int* tiles, float* img, int* steps, void* stream) {
  const auto kernel = vx::k3_frame_kernel<World>;
  constexpr int threads = vx::TILE_THREADS;
  const long long items = vx::tile_items(fp->width, fp->height);
  static int resident = 0;
  kernel<<<vx::resident_grid(items, threads,
                             vx::resident_blocks(kernel, threads, resident)),
           threads, 0, (cudaStream_t)stream>>>(
      world, octree_scale, *tex, *fp, (int)items, tiles, (float4*)img, steps);
  return (int)cudaGetLastError();
}

// K9-judged's trace launch (k9_judged.cuh k9j_trace_kernel), K9's shape
// for one pose: the whole grid in 4x8 tiles a warp, or the refine list's
// entries up to the count on the card; a grid of at most the blocks the
// card holds at once, each block looping over its items. out starts on a
// 16-byte word (_build.launch_k9j_trace checks).
template <class World>
static int k9j_trace_launch(const World& world, float octree_scale,
                            const vx::TexTables* tex,
                            const vx::FrameParams* fp, const float* tf,
                            int ntx, int level, const int* idx,
                            const int* count, int size, void* out,
                            void* stream) {
  const auto kernel = vx::k9j_trace_kernel<World>;
  constexpr int threads = vx::K9J_TRACE_THREADS;
  int wl, hl;
  vx::k9_dims(fp->width, fp->height, level, wl, hl);
  const long long items = idx ? size : vx::tile_items(wl, hl);
  static int resident = 0;
  kernel<<<vx::resident_grid(items, threads,
                             vx::resident_blocks(kernel, threads, resident)),
           threads, 0, (cudaStream_t)stream>>>(
      world, octree_scale, *tex, *fp, tf, ntx, level, idx, count, (int)items,
      (vx::K9JRec*)out);
  return (int)cudaGetLastError();
}

// The primary stage's launch (kd_primary_kernel): a block a 16 x 4 patch
// of each pose's pixels (every pixel traces). rec, hit and img start on a
// 16-byte word.
template <class World>
static int kd_primary_launch(const World& world, float octree_scale,
                             const vx::TexTables* tex,
                             const vx::FrameParams* fp, const float* cams,
                             int n_poses, int alpha_mode, const float* tf,
                             int ntx, void* rec, uint8_t* hit, float* img,
                             void* stream) {
  const long long blocks = (long long)n_poses * ((fp->width + 15) / 16) *
                           ((fp->height + 3) / 4);
  vx::kd_primary_kernel<World><<<(unsigned)blocks, vx::KD_PRIMARY_THREADS, 0,
                                 (cudaStream_t)stream>>>(
      world, octree_scale, *tex, *fp, cams, alpha_mode, tf, ntx,
      (vx::HitRec*)rec, hit, (float4*)img);
  return (int)cudaGetLastError();
}

// The shadow stage's launch (kd_shadow_kernel): a grid of at most the
// blocks the card holds at once, each looping over the slots up to the
// count on the card, so a launch schedules few blocks past that count,
// which only the card knows; `size` (the list's capacity) caps it.
template <class World>
static int kd_shadow_launch(const World& world, float octree_scale,
                            const vx::TexTables* tex, const vx::FrameParams* fp,
                            int alpha_mode, const float* sro, const int* sidx,
                            const int* scount, const int* tidx,
                            const int* tcount, const float* floors, int size,
                            uint8_t* traced, void* stream) {
  const auto kernel = vx::kd_shadow_kernel<World>;
  constexpr int threads = vx::KD_SHADOW_THREADS;
  static int resident = 0;
  kernel<<<vx::resident_grid(size, threads,
                             vx::resident_blocks(kernel, threads, resident)),
           threads, 0, (cudaStream_t)stream>>>(
      world, octree_scale, *tex, *fp, alpha_mode, sro, sidx, scount, tidx,
      tcount, floors, size, traced);
  return (int)cudaGetLastError();
}

// K8 reading rows in WB-byte words: a grid of at most the blocks the card
// holds at once, capped by the k lanes' items.
template <int WB>
static int k8_launch(const uint16_t* sb, const vx::SunParams* sp,
                     const float* ro, const float* max_dst, const int* idx,
                     const int* count, int k, uint8_t* lit, uint8_t* blk,
                     uint8_t* todo, float* floors, void* stream) {
  const auto kernel = vx::k8_sun_kernel<WB>;
  const long long items =
      (long long)k + (k + vx::K8_PAD_LANES - 1) / vx::K8_PAD_LANES;
  static int resident = 0;
  kernel<<<vx::resident_grid(items, vx::K8_THREADS,
                             vx::resident_blocks(kernel, vx::K8_THREADS,
                                                 resident)),
           vx::K8_THREADS, 0, (cudaStream_t)stream>>>(
      sb, *sp, ro, max_dst, idx, count, k, lit, blk, todo, floors);
  return (int)cudaGetLastError();
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int vx_k1_traverse(const uint32_t* desc, long long n_words, float octree_scale,
                   const float* ro, const float* rd, const float* max_dst,
                   int n_rays, int budget, int alpha_mode,
                   const vx::TexTables* tex, float* t, uint32_t* value,
                   int* face, float* pos, float* uv, float* lod,
                   uint8_t* inside, int* steps, const float* t_floor,
                   void* stream) {
  vx::TexTables tx = {};
  if (tex) tx = *tex;
  vx::k1_traverse_kernel<<<vx::grid_for(n_rays), vx::BLOCK, 0,
                           (cudaStream_t)stream>>>(
      desc, (uint32_t)(n_words / 12), octree_scale, ro, rd, max_dst, n_rays,
      budget, alpha_mode, tx, t, value, face, pos, uv, lod, inside, steps,
      t_floor);
  return (int)cudaGetLastError();
}

// tiles: K3's 2 tile counters of the stream, 0 (zeroed when allocated;
// each launch leaves them 0).
int vx_k3_frame(const uint32_t* desc, long long n_words, float octree_scale,
                const vx::TexTables* tex, const vx::FrameParams* fp,
                int* tiles, float* img, int* steps, void* stream) {
  const vx::EsvoWorld world = {desc, (uint32_t)(n_words / 12)};
  return k3_frame_launch(world, octree_scale, tex, fp, tiles, img, steps,
                         stream);
}

int vx_k5_picker(const uint32_t* desc, long long n_words, float octree_scale,
                 const float* tasks, int n_tasks, int budget, int segments,
                 float* out, int* steps, void* stream) {
  const vx::EsvoWorld world = {desc, (uint32_t)(n_words / 12)};
  return vx::k5_launch(world, octree_scale, tasks, n_tasks, budget, segments,
                       out, steps, (cudaStream_t)stream);
}

// Returns the first CUDA error of the pick (0 = the rows are in host_rows).
int vx_k5_pick(const uint32_t* desc, long long n_words, float octree_scale,
               const float* host_tasks, float* dev_tasks, int n_tasks,
               int budget, float* dev_rows, float* host_rows, void* stream) {
  const vx::EsvoWorld world = {desc, (uint32_t)(n_words / 12)};
  return vx::k5_pick(world, octree_scale, host_tasks, dev_tasks, n_tasks,
                     budget, dev_rows, host_rows, (cudaStream_t)stream);
}

// words: the CSVO node stream after its 4-byte prefix, n_words >= 1,
// starting on a 16-byte word (every CSVO entry; _build refuses another
// view).
int vx_k4_traverse(const uint32_t* words, long long n_words,
                   float octree_scale, unsigned root_ptr, int total_depth,
                   const float* ro, const float* rd, const float* max_dst,
                   int n_rays, int budget, int alpha_mode,
                   const vx::TexTables* tex, float* t, uint32_t* value,
                   int* face, float* pos, float* uv, float* lod,
                   uint8_t* inside, int* steps, const float* t_floor,
                   void* stream) {
  vx::TexTables tx = {};
  if (tex) tx = *tex;
  const vx::CsvoWorld world = {words, (uint32_t)n_words, root_ptr,
                               total_depth};
  vx::k4_traverse_kernel<<<vx::grid_for(n_rays), vx::BLOCK, 0,
                           (cudaStream_t)stream>>>(
      world, octree_scale, ro, rd, max_dst, n_rays, budget, alpha_mode, tx, t,
      value, face, pos, uv, lod, inside, steps, t_floor);
  return (int)cudaGetLastError();
}

int vx_k3_frame_csvo(const uint32_t* words, long long n_words,
                     float octree_scale, unsigned root_ptr, int total_depth,
                     const vx::TexTables* tex, const vx::FrameParams* fp,
                     int* tiles, float* img, int* steps, void* stream) {
  const vx::CsvoWorld world = {words, (uint32_t)n_words, root_ptr,
                               total_depth};
  return k3_frame_launch(world, octree_scale, tex, fp, tiles, img, steps,
                         stream);
}

int vx_k5_picker_csvo(const uint32_t* words, long long n_words,
                      float octree_scale, unsigned root_ptr, int total_depth,
                      const float* tasks, int n_tasks, int budget,
                      int segments, float* out, int* steps, void* stream) {
  const vx::CsvoWorld world = {words, (uint32_t)n_words, root_ptr,
                               total_depth};
  return vx::k5_launch(world, octree_scale, tasks, n_tasks, budget, segments,
                       out, steps, (cudaStream_t)stream);
}

int vx_k5_pick_csvo(const uint32_t* words, long long n_words,
                    float octree_scale, unsigned root_ptr, int total_depth,
                    const float* host_tasks, float* dev_tasks, int n_tasks,
                    int budget, float* dev_rows, float* host_rows,
                    void* stream) {
  const vx::CsvoWorld world = {words, (uint32_t)n_words, root_ptr,
                               total_depth};
  return vx::k5_pick(world, octree_scale, host_tasks, dev_tasks, n_tasks,
                     budget, dev_rows, host_rows, (cudaStream_t)stream);
}

// ---- K6, K7, K8 -----------------------------------------------------------

// mask: n >= 0 bytes at any address; out: size ints; scratch:
// _build.k6_blocks(n) ints, zeroed when allocated and used by K6 alone;
// epoch: 1..2^30-1, a new one each call; starts: null, or n / seg ints that
// receive the rank of every seg-th lane (the first output slot of each
// segment). One launch; its grid is at most the blocks the card holds at
// once (a block takes tiles until none is left).
int vx_k6_compact(const uint8_t* mask, int n, int size, int* out, int* count,
                  int* scratch, unsigned epoch, int seg, int* starts,
                  void* stream) {
  static int resident = 0;
  const int off = n > 0 ? (int)(reinterpret_cast<uintptr_t>(mask) & 15) : 0;
  const long long lanes = (long long)n + off;
  const int ntiles =
      lanes > 0 ? (int)((lanes + vx::K6_TILE - 1) / vx::K6_TILE) : 1;
  vx::k6_compact_kernel<<<vx::resident_grid(ntiles, 1,
                                            vx::resident_blocks(
                                                vx::k6_compact_kernel,
                                                vx::K6_THREADS, resident)),
                          vx::K6_THREADS, 0, (cudaStream_t)stream>>>(
      mask, n, off, ntiles, size, out, count, scratch, epoch, seg, starts);
  return (int)cudaGetLastError();
}

// A group of K7_GROUP lanes a tile, K7_TILE_THREADS / K7_GROUP tiles a
// block.
int vx_k7_tiles(const int* levels, const float* bounds,
                const vx::BeamParams* bp, float* out, void* stream) {
  const long long n = (long long)((bp->width + 7) / 8) * ((bp->height + 7) / 8);
  constexpr int per_block = vx::K7_TILE_THREADS / vx::K7_GROUP;
  const unsigned grid = (unsigned)((n + per_block - 1) / per_block);
  const int ints = vx::k7_pyramid_ints(*bp);
  if (ints <= vx::K7_STAGE_INTS) {  // the pyramid staged in shared memory
    vx::k7_tile_kernel<true><<<grid, vx::K7_TILE_THREADS, ints * sizeof(int),
                               (cudaStream_t)stream>>>(levels, bounds, *bp,
                                                       out);
  } else {
    vx::k7_tile_kernel<false><<<grid, vx::K7_TILE_THREADS, 0,
                                (cudaStream_t)stream>>>(levels, bounds, *bp,
                                                        out);
  }
  return (int)cudaGetLastError();
}

// out starts on a 16-byte word. A grid of at most the blocks the card
// holds at once, capped by the k lanes, each block looping over the rays
// up to the count on the card, then over the pads.
int vx_k7_shadow(const int* levels_e, const int* h3d0, const float* bounds,
                 const vx::BeamParams* bp, const float* ro,
                 const float* max_dst, const int* idx, const int* count, int k,
                 float* out, void* stream) {
  static int resident = 0;
  vx::k7_shadow_kernel<<<
      vx::resident_grid(k, vx::K7_SHADOW_THREADS,
                        vx::resident_blocks(vx::k7_shadow_kernel,
                                            vx::K7_SHADOW_THREADS, resident)),
      vx::K7_SHADOW_THREADS, 0, (cudaStream_t)stream>>>(
      levels_e, h3d0, bounds, *bp, ro, max_dst, idx, count, k, out);
  return (int)cudaGetLastError();
}

// sb starts on a 4-byte word, each output on a 16-byte word
// (_build.check_k8). A row of sp->width u16 fields is read in the widest
// words (16, 8 or 4 bytes) on which every row starts.
int vx_k8_sun(const uint16_t* sb, const vx::SunParams* sp, const float* ro,
              const float* max_dst, const int* idx, const int* count, int k,
              uint8_t* lit, uint8_t* blk, uint8_t* todo, float* floors,
              void* stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(sb);
  const int row_bytes = sp->width * 2;
  if (row_bytes % 16 == 0 && at % 16 == 0)
    return k8_launch<16>(sb, sp, ro, max_dst, idx, count, k, lit, blk, todo,
                         floors, stream);
  if (row_bytes % 8 == 0 && at % 8 == 0)
    return k8_launch<8>(sb, sp, ro, max_dst, idx, count, k, lit, blk, todo,
                        floors, stream);
  return k8_launch<4>(sb, sp, ro, max_dst, idx, count, k, lit, blk, todo,
                      floors, stream);
}

// ---- the deferred frame's stages ------------------------------------------

// cams: null (one frame) or the (n_poses, 12) cameras of a batch (K10);
// tf: null or the (n_poses, ceil(H/8), ntx) tile floors; rec, hit, img:
// n_poses * W * H lanes.
int vx_kd_primary(const uint32_t* desc, long long n_words, float octree_scale,
                  const vx::TexTables* tex, const vx::FrameParams* fp,
                  const float* cams, int n_poses, int alpha_mode,
                  const float* tf, int ntx, void* rec, uint8_t* hit,
                  float* img, void* stream) {
  const vx::EsvoWorld world = {desc, (uint32_t)(n_words / 12)};
  return kd_primary_launch(world, octree_scale, tex, fp, cams, n_poses,
                           alpha_mode, tf, ntx, rec, hit, img, stream);
}

int vx_kd_primary_csvo(const uint32_t* words, long long n_words,
                       float octree_scale, unsigned root_ptr, int total_depth,
                       const vx::TexTables* tex, const vx::FrameParams* fp,
                       const float* cams, int n_poses, int alpha_mode,
                       const float* tf, int ntx, void* rec, uint8_t* hit,
                       float* img, void* stream) {
  const vx::CsvoWorld world = {words, (uint32_t)n_words, root_ptr,
                               total_depth};
  return kd_primary_launch(world, octree_scale, tex, fp, cams, n_poses,
                           alpha_mode, tf, ntx, rec, hit, img, stream);
}

int vx_kd_shade(const vx::TexTables* tex, const vx::FrameParams* fp,
                const float* cams, const int* hidx, const int* hcount,
                int size, const void* rec, float* color, float* ds,
                uint8_t* need, float* sro, float* img, void* stream) {
  vx::kd_shade_kernel<<<vx::grid_for(size), vx::BLOCK, 0,
                        (cudaStream_t)stream>>>(
      *tex, *fp, cams, hidx, hcount, size, (const vx::HitRec*)rec,
      (float4*)color, ds, need, sro, img);
  return (int)cudaGetLastError();
}

int vx_kd_shadow(const uint32_t* desc, long long n_words, float octree_scale,
                 const vx::TexTables* tex, const vx::FrameParams* fp,
                 int alpha_mode, const float* sro, const int* sidx,
                 const int* scount, const int* tidx, const int* tcount,
                 const float* floors, int size, uint8_t* traced,
                 void* stream) {
  const vx::EsvoWorld world = {desc, (uint32_t)(n_words / 12)};
  return kd_shadow_launch(world, octree_scale, tex, fp, alpha_mode, sro,
                          sidx, scount, tidx, tcount, floors, size, traced,
                          stream);
}

int vx_kd_shadow_csvo(const uint32_t* words, long long n_words,
                      float octree_scale, unsigned root_ptr, int total_depth,
                      const vx::TexTables* tex, const vx::FrameParams* fp,
                      int alpha_mode, const float* sro, const int* sidx,
                      const int* scount, const int* tidx, const int* tcount,
                      const float* floors, int size, uint8_t* traced,
                      void* stream) {
  const vx::CsvoWorld world = {words, (uint32_t)n_words, root_ptr,
                               total_depth};
  return kd_shadow_launch(world, octree_scale, tex, fp, alpha_mode, sro,
                          sidx, scount, tidx, tcount, floors, size, traced,
                          stream);
}

// img (the frame's pixels, 4 floats each) and sidx start on a 16-byte
// word, traced, blk and todo on a 4-byte word. A grid of at most the
// blocks the card holds at once, capped by the words of `size` slots,
// each block looping over the words up to the count on the card.
int vx_kd_finish(const vx::FrameParams* fp, const int* hidx, const int* sidx,
                 const int* scount, int size, const float* color,
                 const float* ds, const uint8_t* blk, const uint8_t* todo,
                 const uint8_t* traced, float* img, uint8_t* blkp,
                 void* stream) {
  static int resident = 0;
  vx::kd_finish_kernel<<<
      vx::resident_grid(
          ((long long)size + vx::KD_FINISH_SLOTS - 1) / vx::KD_FINISH_SLOTS,
          vx::KD_FINISH_THREADS,
          vx::resident_blocks(vx::kd_finish_kernel, vx::KD_FINISH_THREADS,
                              resident)),
      vx::KD_FINISH_THREADS, 0, (cudaStream_t)stream>>>(
      *fp, hidx, sidx, scount, size, (const float4*)color, ds, blk, todo,
      traced, (float4*)img, blkp);
  return (int)cudaGetLastError();
}

// ---- K9: the adaptive frame ------------------------------------------------

// Each K9 entry takes cams (null, or the (n_poses, 12) cameras of a batch,
// K10) and n_poses: the lanes of every pose, pose-major.
// out: the records of grid level `level` (n_poses times its lane count
// when idx is null, else at least the largest index); idx/count: a refine
// list of `size` entries and its count on the card, or null; tf: null or
// the (n_poses, ceil(H/8), ntx) tile floors; n_poses: the rows of cams
// (1 with cams null).
int vx_k9_trace(const uint32_t* desc, long long n_words, float octree_scale,
                const vx::FrameParams* fp, const float* cams, const float* tf,
                int ntx, int level, const int* idx, const int* count, int size,
                int n_poses, void* out, void* stream) {
  const vx::EsvoWorld world = {desc, (uint32_t)(n_words / 12)};
  return k9_trace_launch(world, octree_scale, fp, cams, tf, ntx, level, idx,
                         count, size, n_poses, out, stream);
}

int vx_k9_trace_csvo(const uint32_t* words, long long n_words,
                     float octree_scale, unsigned root_ptr, int total_depth,
                     const vx::FrameParams* fp, const float* cams,
                     const float* tf, int ntx, int level, const int* idx,
                     const int* count, int size, int n_poses, void* out,
                     void* stream) {
  const vx::CsvoWorld world = {words, (uint32_t)n_words, root_ptr,
                               total_depth};
  return k9_trace_launch(world, octree_scale, fp, cams, tf, ntx, level, idx,
                         count, size, n_poses, out, stream);
}

// lo: the records of level + 1; hi, refine: the lanes of level `level`
// (n_poses times its lane count); one block a K9M_TW x K9M_TH tile of each
// pose's grid. Every record pointer (lo, hi, frec) is 16-byte aligned, and
// so are rec, hit, img, needp and blkp (ops/adaptive.py checks).
int vx_k9_merge(float octree_scale, const vx::FrameParams* fp,
                const float* cams, int n_poses, int level, const void* lo,
                void* hi, uint8_t* refine, void* stream) {
  int wh, hh;
  vx::k9_dims(fp->width, fp->height, level, wh, hh);
  const long long blocks = (long long)n_poses *
                           ((wh + vx::K9M_TW - 1) / vx::K9M_TW) *
                           ((hh + vx::K9M_TH - 1) / vx::K9M_TH);
  vx::k9_merge_kernel<<<(unsigned)blocks, vx::K9M_THREADS, 0,
                        (cudaStream_t)stream>>>(
      octree_scale, *fp, cams, level, (const vx::K9Rec*)lo, (vx::K9Rec*)hi,
      refine);
  return (int)cudaGetLastError();
}

int vx_k9_finalize(float octree_scale, const vx::FrameParams* fp,
                   const float* cams, int n_poses, const void* frec, void* rec,
                   uint8_t* hit, float* img, uint8_t* needp, uint8_t* blkp,
                   void* stream) {
  const long long n = (long long)fp->width * fp->height * n_poses;
  vx::k9_finalize_kernel<<<(unsigned)((n + vx::K9F_THREADS - 1) /
                                      vx::K9F_THREADS),
                           vx::K9F_THREADS, 0, (cudaStream_t)stream>>>(
      octree_scale, *fp, cams, n_poses, (const vx::K9Rec*)frec,
      (vx::HitRec*)rec, hit, img, needp, blkp);
  return (int)cudaGetLastError();
}

// hstart: null (one frame) or the n_poses first hit lanes of each pose in
// hidx (K6's segment starts); hidx, need and mask start on a 16-byte word.
// A grid of at most the blocks the card holds at once, capped by the
// words of `size` lanes (every lane a hit), each block looping over the
// words and tail words up to the count on the card.
int vx_k9_shadow_cells(int step, const vx::FrameParams* fp, const int* hidx,
                       const int* hcount, const int* hstart, int n_poses,
                       int size, const uint8_t* need, uint8_t* needp,
                       const uint8_t* blkp, uint8_t* mask, int* dense,
                       const float* color, const float* ds, float* img,
                       void* stream) {
  static int resident = 0;
  vx::k9_shadow_cells_kernel<<<
      vx::resident_grid(((long long)size + vx::K9S_LANES - 1) / vx::K9S_LANES,
                        vx::K9S_THREADS,
                        vx::resident_blocks(vx::k9_shadow_cells_kernel,
                                            vx::K9S_THREADS, resident)),
      vx::K9S_THREADS, 0, (cudaStream_t)stream>>>(
      step, *fp, hidx, hcount, hstart, n_poses, size, need, needp, blkp, mask,
      dense, (const float4*)color, ds, img);
  return (int)cudaGetLastError();
}

// ---- K9-judged: the adaptive frame of a translucent world -------------------

// out: the 16-word records of grid level `level` (its lane count when idx
// is null, else at least the largest index); idx/count: a refine list of
// `size` entries and its count on the card, or null.
int vx_k9j_trace(const uint32_t* desc, long long n_words, float octree_scale,
                 const vx::TexTables* tex, const vx::FrameParams* fp,
                 const float* tf, int ntx, int level, const int* idx,
                 const int* count, int size, void* out, void* stream) {
  const vx::EsvoWorld world = {desc, (uint32_t)(n_words / 12)};
  return k9j_trace_launch(world, octree_scale, tex, fp, tf, ntx, level, idx,
                          count, size, out, stream);
}

int vx_k9j_trace_csvo(const uint32_t* words, long long n_words,
                      float octree_scale, unsigned root_ptr, int total_depth,
                      const vx::TexTables* tex, const vx::FrameParams* fp,
                      const float* tf, int ntx, int level, const int* idx,
                      const int* count, int size, void* out, void* stream) {
  const vx::CsvoWorld world = {words, (uint32_t)n_words, root_ptr,
                               total_depth};
  return k9j_trace_launch(world, octree_scale, tex, fp, tf, ntx, level, idx,
                          count, size, out, stream);
}

// lo: the records of level + 1; hi, refine: the lanes of level `level`
// (lo and hi start on a 16-byte word); hole: the (mat_rows, n_levels) hole
// table of the texture tables. One block a K9JM_TW x K9JM_TH tile of the
// hi grid.
int vx_k9j_merge(float octree_scale, const vx::TexTables* tex,
                 const vx::FrameParams* fp, int level, int hole_fill,
                 const uint8_t* hole, const void* lo, void* hi,
                 uint8_t* refine, void* stream) {
  int wh, hh;
  vx::k9_dims(fp->width, fp->height, level, wh, hh);
  const long long blocks = (long long)((wh + vx::K9JM_TW - 1) / vx::K9JM_TW) *
                           ((hh + vx::K9JM_TH - 1) / vx::K9JM_TH);
  vx::k9j_merge_kernel<<<(unsigned)blocks, vx::K9JM_THREADS, 0,
                         (cudaStream_t)stream>>>(
      octree_scale, *tex, *fp, level, hole_fill, hole, (const vx::K9JRec*)lo,
      (vx::K9JRec*)hi, refine);
  return (int)cudaGetLastError();
}

// frec, rec, hit, img, needp and blkp start on a 16-byte word
// (ops/adaptive_judged.py and _build.launch_k9j_finalize check).
int vx_k9j_finalize(const vx::FrameParams* fp, const void* frec, void* rec,
                    uint8_t* hit, float* img, uint8_t* needp, uint8_t* blkp,
                    void* stream) {
  const long long n = (long long)fp->width * fp->height;
  vx::k9j_finalize_kernel<<<(unsigned)((n + vx::K9F_THREADS - 1) /
                                       vx::K9F_THREADS),
                            vx::K9F_THREADS, 0, (cudaStream_t)stream>>>(
      *fp, (const vx::K9JRec*)frec, (vx::HitRec*)rec, hit, img, needp, blkp);
  return (int)cudaGetLastError();
}

// ---- P0: the gather probe ------------------------------------------------

// kind: 0 flat, 1 axis0, 2 axis1, 3 two_step; tbl: rows * 128 words;
// seeds, out: sub * 128 words (axis1 reads rows 0..sub-1: sub <= rows).
int vx_p0_gather(int kind, const uint32_t* tbl, int rows,
                 const uint32_t* seeds, int sub, int steps, uint32_t* out,
                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case vx::P0_FLAT:
      vx::p0_gather_kernel<vx::P0_FLAT><<<sub, vx::P0_LANES, 0, st>>>(
          tbl, (uint32_t)rows, seeds, steps, out);
      break;
    case vx::P0_AXIS0:
      vx::p0_gather_kernel<vx::P0_AXIS0><<<sub, vx::P0_LANES, 0, st>>>(
          tbl, (uint32_t)rows, seeds, steps, out);
      break;
    case vx::P0_AXIS1:
      vx::p0_gather_kernel<vx::P0_AXIS1><<<sub, vx::P0_LANES, 0, st>>>(
          tbl, (uint32_t)rows, seeds, steps, out);
      break;
    case vx::P0_TWO_STEP:
      vx::p0_gather_kernel<vx::P0_TWO_STEP><<<sub, vx::P0_LANES, 0, st>>>(
          tbl, (uint32_t)rows, seeds, steps, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
