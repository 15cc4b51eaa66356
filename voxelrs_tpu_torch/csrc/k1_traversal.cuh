// ESVO traversal (K1) and the texel samplers (K2 and the shading sampler)
// as __device__ functions, shared by the kernels in kernels.cu. The
// traversal loop (traverse_with) is a template on a node cursor: the ESVO
// cursor here, the CSVO cursor in k4_csvo_traversal.cuh (K4).
//
// Replaces (JAX package): voxelrs_tpu/ops/traversal.py::intersect_octree
// (classic loop: make_ray_consts :124, init_state :162, traversal_step :311,
// run_loop :1038, finalize :1053), voxelrs_tpu/ops/shading.py::make_alpha_fn
// :69 (K2) and voxelrs_tpu/ops/texture.py::sample_texture_lod :23.
//
// Design: one thread per ray, as in the reference GLSL
// (assets/shaders/svo.esvo.glsl). The 12-entry (node, t_max) stack lives
// in local memory (K3, K5, the primary stage, K9's and K9-judged's traces
// and the shadow stage: shared memory, see SharedStack); each step reads
// one word of one 12-word block (two with the pointer prefetch). The JAX
// version's TPU structure (lock-step batch, one-hot stacks, fat rows) is not
// carried over. The arithmetic follows the JAX classic loop operation by
// operation — separate multiplies and subtracts (build with -fmad=false),
// IEEE division — so hits agree bit for bit with the plain PyTorch version.
//
// What bounds it on an H100: the chain of dependent steps, not instruction
// issue. A step issues some 80 instructions around its dependent load
// from the 6.5 MB buffer (L2-resident); a cursor that loads a node's words
// once, when the traversal enters it, issues 9 fewer a step and ran 5-12%
// slower on every ESVO kernel (PERF.md §6). Warps diverge once their rays
// take different paths; the frame kernels give a warp a 4x8 pixel tile.

#pragma once
#include <cstdint>

namespace vx {

constexpr int MAX_SCALE = 23;
constexpr int STACK_HEIGHT = 12;
constexpr int STACK_BASE = MAX_SCALE - STACK_HEIGHT;
constexpr uint32_t PTR_BITS = 28;
constexpr uint32_t PTR_MASK = (1u << PTR_BITS) - 1u;
constexpr uint32_t RELATIVE_BIT = 1u << 31;
constexpr uint32_t NO_VALUE = 0x00FFFFFFu;
constexpr uint32_t EPS_BITS = 0x34000000u;  // float 2^-23
constexpr float EPSILON = 1.1920928955078125e-07f;
constexpr int MAX_LEVELS = 8;

// Texture and material tables (host struct filled by _build.py; the field
// order and types are mirrored there by ctypes).
struct TexTables {
  const float* atlas;        // all mip levels, each (T, h, w, 4), flat
  int level_h[MAX_LEVELS];
  int level_w[MAX_LEVELS];
  int level_off[MAX_LEVELS];  // level start, in texels
  int n_levels;
  int n_layers;
  const int* mat_tex;        // (mat_rows, mat_cols) texture layers
  int mat_rows;
  int mat_cols;
  const float* mat_params;   // (mat_rows, 2) specular pow, strength
  const int* pair_color;     // (pair_cap,) colour layer of each pair id
  const int* pair_normal;    // (pair_cap,) normal layer of each pair id
  int pair_cap;
};

struct Hit {
  float t;          // -1 = miss
  uint32_t value;
  int face;
  float pos[3];
  float u, v;
  float lod;
  bool inside;
  int steps;
  // a judged cast rejected a candidate leaf on its way (its texel alpha 0,
  // or the adjacency rule): JAX's acc_passed | resume
  bool passed;
  // the frozen state at an accepted hit (K9's record): t_min in octree
  // units, the leaf's child slot and scale, its base in the mirrored
  // [1, 2) space
  float t_oct;
  int idx, scale;
  float leaf[3];
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float copysign_epsilon(float r) {
  return fabsf(r) < EPSILON
             ? __uint_as_float((__float_as_uint(r) & 0x80000000u) | EPS_BITS)
             : r;
}

__device__ __forceinline__ float exp2_scale(int scale) {
  return __int_as_float((scale - MAX_SCALE + 127) << 23);
}

__device__ __forceinline__ float smoothstep(float e0, float e1, float x) {
  float t = clampf((x - e0) / (e1 - e0), 0.f, 1.f);
  return t * t * (3.f - 2.f * t);
}

// Word `widx` of the 12-word block at `ptr`; the block index is clamped
// into the buffer as the JAX row gather clamps it.
__device__ __forceinline__ uint32_t block_word(const uint32_t* __restrict__ desc,
                                               uint32_t n_rows, uint32_t ptr,
                                               uint32_t widx) {
  uint32_t blk = ptr / 12u;
  if (blk > n_rows - 1u) blk = n_rows - 1u;
  return __ldg(desc + (size_t)blk * 12u + widx);
}

__device__ __forceinline__ uint32_t resolve_ptr(uint32_t raw, uint32_t ptr,
                                                uint32_t pidx) {
  return (raw & RELATIVE_BIT) ? ptr + 4u + pidx + (raw & 0x7FFFFFFFu) : raw;
}

// Texture layer of the hit face: side unless top (face 3) / bottom (face 2);
// +3 columns for normal maps (shading.py::face_texture_layer).
__device__ __forceinline__ int face_layer(const TexTables& tx, uint32_t value,
                                          int face, int base) {
  int row = clampi((int)value, 0, tx.mat_rows - 1);
  int col = face == 3 ? 0 : (face == 2 ? 2 : 1);
  return tx.mat_tex[row * tx.mat_cols + base + col];
}

__device__ __forceinline__ float4 texel(const TexTables& tx, int idx) {
  return reinterpret_cast<const float4*>(tx.atlas)[idx];
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  float g = 1.f - f;
  return make_float4(a.x * g + b.x * f, a.y * g + b.y * f, a.z * g + b.z * f,
                     a.w * g + b.w * f);
}

__device__ float4 bilinear_at(const TexTables& tx, int layer, int dl, float ux,
                              float uy) {
  dl = clampi(dl, 0, tx.n_levels - 1);
  int h = tx.level_h[dl], w = tx.level_w[dl];
  float cx = ux * (float)w - 0.5f;
  float cy = uy * (float)h - 0.5f;
  float x0 = floorf(cx), y0 = floorf(cy);
  float fx = cx - x0, fy = cy - y0;
  int xi = (int)x0, yi = (int)y0;
  int x0i = clampi(xi, 0, w - 1), x1i = clampi(xi + 1, 0, w - 1);
  int y0i = clampi(yi, 0, h - 1), y1i = clampi(yi + 1, 0, h - 1);
  int base = tx.level_off[dl] + layer * h * w;
  float4 c00 = texel(tx, base + y0i * w + x0i);
  float4 c10 = texel(tx, base + y0i * w + x1i);
  float4 c01 = texel(tx, base + y1i * w + x0i);
  float4 c11 = texel(tx, base + y1i * w + x1i);
  return lerp4(lerp4(c00, c10, fx), lerp4(c01, c11, fx), fy);
}

// textureLod with CLAMP_TO_EDGE, NEAREST magnification and LINEAR (or,
// `linear` false, NEAREST) mip selection (texture.py::sample_texture_lod).
__device__ float4 sample_lod(const TexTables& tx, int layer, float u, float v,
                             float lod, bool linear) {
  int L = tx.n_levels;
  layer = clampi(layer, 0, tx.n_layers - 1);
  lod = clampf(lod, 0.f, (float)(L - 1));
  if (!linear) lod = rintf(lod);
  int d0 = (int)floorf(lod);
  float frac = lod - (float)d0;
  bool mag = lod <= 0.f;
  int dm = clampi(d0, 0, L - 1);
  float w0 = (float)tx.level_w[dm], h0 = (float)tx.level_h[dm];
  float ux = mag ? (floorf(u * w0) + 0.5f) / w0 : u;
  float uy = mag ? (floorf(v * h0) + 0.5f) / h0 : v;
  ux = clampf(ux, 0.f, 1.f);
  uy = clampf(uy, 0.f, 1.f);
  float4 out = bilinear_at(tx, layer, d0, ux, uy);
  if (linear) out = lerp4(out, bilinear_at(tx, layer, d0 + 1, ux, uy), frac);
  return out;
}

// K2: texel alpha of a candidate leaf hit. mode 1 = nearest texel at the
// nearest mip (make_alpha_fn), mode 2 = the trilinear sampler (exact=True).
__device__ float texel_alpha(const TexTables& tx, int mode, uint32_t value,
                             int face, float u, float v, float lod) {
  int layer = face_layer(tx, value, face, 0);
  if (mode == 2) return sample_lod(tx, layer, u, v, lod, true).w;
  layer = clampi(layer, 0, tx.n_layers - 1);
  int dl = (int)rintf(clampf(lod, 0.f, (float)(tx.n_levels - 1)));
  int h = tx.level_h[dl], w = tx.level_w[dl];
  int x = clampi((int)floorf(u * (float)w), 0, w - 1);
  int y = clampi((int)floorf(v * (float)h), 0, h - 1);
  return texel(tx, tx.level_off[dl] + layer * h * w + y * w + x).w;
}

// Ray constants of one ray (make_ray_consts): the origin moved into the
// [1, 2) cube, the epsilon-substituted direction, the plane coefficients
// and the mirroring.
struct RayConsts {
  float rox, roy, roz, rdx, rdy, rdz, tcx, tcy, tcz, tbx, tby, tbz;
  bool mx, my, mz;
  int octant_mask;
};

__device__ __forceinline__ RayConsts ray_consts(float octree_scale,
                                                float ro_x, float ro_y,
                                                float ro_z, float rd_x,
                                                float rd_y, float rd_z) {
  RayConsts c;
  c.rox = ro_x * octree_scale + 1.f;
  c.roy = ro_y * octree_scale + 1.f;
  c.roz = ro_z * octree_scale + 1.f;
  c.rdx = copysign_epsilon(rd_x);
  c.rdy = copysign_epsilon(rd_y);
  c.rdz = copysign_epsilon(rd_z);
  c.tcx = 1.f / -fabsf(c.rdx);
  c.tcy = 1.f / -fabsf(c.rdy);
  c.tcz = 1.f / -fabsf(c.rdz);
  c.tbx = c.tcx * c.rox;
  c.tby = c.tcy * c.roy;
  c.tbz = c.tcz * c.roz;
  c.mx = c.rdx > 0.f;
  c.my = c.rdy > 0.f;
  c.mz = c.rdz > 0.f;
  c.octant_mask = (int)c.mx | ((int)c.my << 1) | ((int)c.mz << 2);
  if (c.mx) c.tbx = 3.f * c.tcx - c.tbx;
  if (c.my) c.tby = 3.f * c.tcy - c.tby;
  if (c.mz) c.tbz = 3.f * c.tcz - c.tbz;
  return c;
}

// Face, uv, distance and texture lod of a candidate hit at the leaf of
// `scale` based at `pos` (mirrored space) entered at `t_min` (_hit_geometry).
struct HitGeom {
  int face;
  float u, v, dst, lod;
  float se, upx, upy, upz;
};

__device__ __forceinline__ HitGeom hit_geometry(const RayConsts& c,
                                                float octree_scale, int scale,
                                                float posx, float posy,
                                                float posz, float t_min) {
  HitGeom g;
  const float se = exp2_scale(scale);
  const float t2x = (posx + se) * c.tcx - c.tbx;
  const float t2y = (posy + se) * c.tcy - c.tby;
  const float t2z = (posz + se) * c.tcz - c.tbz;
  const float tc_min = fmaxf(fmaxf(t2x, t2y), t2z);
  g.se = se;
  g.upx = c.mx ? (3.f - se) - posx : posx;
  g.upy = c.my ? (3.f - se) - posy : posy;
  g.upz = c.mz ? (3.f - se) - posz : posz;
  const bool on_x = tc_min == t2x;
  const bool on_y = !on_x && tc_min == t2y;
  const int sgx = (int)(__float_as_uint(c.rdx) >> 31);
  const int sgy = (int)(__float_as_uint(c.rdy) >> 31);
  const int sgz = (int)(__float_as_uint(c.rdz) >> 31);
  g.face = on_x ? sgx : (on_y ? (2 | sgy) : (4 | sgz));
  float ux = on_x ? (c.roz + c.rdz * t2x) - g.upz
                  : (on_y ? (c.rox + c.rdx * t2y) - g.upx
                          : (c.rox + c.rdx * t2z) - g.upx);
  float uy = on_x ? (c.roy + c.rdy * t2x) - g.upy
                  : (on_y ? (c.roz + c.rdz * t2y) - g.upz
                          : (c.roy + c.rdy * t2z) - g.upy);
  ux = ux / se;
  uy = uy / se;
  if (on_x && c.mx) ux = 1.f - ux;
  if (on_y && c.my) uy = 1.f - uy;
  if (!on_x && !on_y && !c.mz) ux = 1.f - ux;
  g.u = ux;
  g.v = uy;
  g.dst = t_min / octree_scale;
  g.lod = smoothstep(15.f, 25.f, g.dst) * (g.dst - 15.f) * 0.05f;
  return g;
}

// The hit record of an accepted leaf (the JAX classic loop's finalize):
// the traversal's loop calls it at its hit, K9's finalize on a frozen
// record, so a traced lane finalizes to the bits K1 returns.
__device__ __forceinline__ void finalize_hit(const RayConsts& c,
                                             float octree_scale,
                                             const HitGeom& g, float t_min,
                                             uint32_t value, Hit& out) {
  const float hx = clampf(c.rox + t_min * c.rdx, g.upx + EPSILON,
                          (g.upx + g.se) - EPSILON);
  const float hy = clampf(c.roy + t_min * c.rdy, g.upy + EPSILON,
                          (g.upy + g.se) - EPSILON);
  const float hz = clampf(c.roz + t_min * c.rdz, g.upz + EPSILON,
                          (g.upz + g.se) - EPSILON);
  out.t = g.dst;
  out.value = value;
  out.face = g.face;
  out.pos[0] = (hx - 1.f) / octree_scale;
  out.pos[1] = (hy - 1.f) / octree_scale;
  out.pos[2] = (hz - 1.f) / octree_scale;
  out.u = g.u;
  out.v = g.v;
  out.lod = g.lod;
}

// The ESVO node cursor of one ray: the packed stack word ``node`` =
// ptr | parent_idx << 28 and the reads of the ESVO buffer. ``traverse_with``
// drives the traversal through it; the CSVO cursor (k4_csvo_traversal.cuh)
// has the same four methods over the CSVO byte stream. PREFETCH: the probe
// also loads the node's child-pointer word (same block), beside its
// descriptor word, so a push or a leaf's value waits for one load fewer;
// the words read, and so the result, are the same. The frame kernels
// trace with it, K1 without it (1.2% faster there); forms that read a
// node's words once, when the traversal enters it, or keep its block
// index were slower on every ESVO kernel (PERF.md §6).
template <bool PREFETCH>
struct EsvoCursorT {
  const uint32_t* __restrict__ desc;
  uint32_t n_rows;
  uint32_t node;
  uint32_t pword;  // PREFETCH: the current node's child-pointer word

  __device__ EsvoCursorT(const uint32_t* __restrict__ d, uint32_t rows)
      : desc(d), n_rows(rows), node(0u), pword(0u) {}

  // child / leaf bits of child `oct` of the current node (the step's
  // descriptor fetch)
  __device__ __forceinline__ void probe(int oct, bool& is_child,
                                        bool& is_leaf) {
    const uint32_t ptr = node & PTR_MASK;
    const uint32_t pidx = node >> PTR_BITS;
    const uint32_t bit = 1u << oct;
    uint32_t d = block_word(desc, n_rows, ptr, pidx >> 1);
    if (PREFETCH) pword = block_word(desc, n_rows, ptr, 4u + pidx);
    if (pidx & 1u) d >>= 16;
    is_child = (d & (bit << 8)) != 0u;
    is_leaf = (d & bit) != 0u;
  }

  __device__ __forceinline__ uint32_t child_block(uint32_t& ptr) const {
    ptr = node & PTR_MASK;
    const uint32_t pidx = node >> PTR_BITS;
    return resolve_ptr(PREFETCH ? pword
                                : block_word(desc, n_rows, ptr, 4u + pidx),
                       ptr, pidx);
  }

  // value of leaf child `oct` of the current node
  __device__ __forceinline__ uint32_t leaf_value(int oct) const {
    uint32_t ptr;
    const uint32_t next = child_block(ptr);
    return block_word(desc, n_rows, next, 4u + (uint32_t)oct);
  }

  // descend into child `oct`
  __device__ __forceinline__ void push(int oct) {
    uint32_t ptr;
    const uint32_t next = child_block(ptr);
    node = (next & PTR_MASK) | ((uint32_t)oct << PTR_BITS);
  }
};
using EsvoCursor = EsvoCursorT<false>;

// Where traverse_with keeps its 12-entry (node, t_max) stack, made inside
// it from a Source. LocalStack: arrays of the thread (local memory: K1 and
// K4). SharedStack: the thread's column
// of a block's shared-memory table, `stride` entries apart (entry
// [slot][thread]: no bank conflicts).
struct LocalStack {
  struct Source {};
  uint32_t node[STACK_HEIGHT];
  float tmax[STACK_HEIGHT];

  __device__ explicit LocalStack(Source) {}
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < STACK_HEIGHT; ++i) {
      node[i] = 0u;
      tmax[i] = 0.f;
    }
  }
  __device__ __forceinline__ void put(int slot, uint32_t n, float t) {
    node[slot] = n;
    tmax[slot] = t;
  }
  __device__ __forceinline__ void get(int slot, uint32_t& n, float& t) const {
    n = node[slot];
    t = tmax[slot];
  }
};

struct SharedStack {
  struct Source {
    uint32_t* node;  // &table_node[0][thread]
    float* tmax;     // &table_tmax[0][thread]
    int stride;      // threads of the block
  };
  Source s;

  __device__ explicit SharedStack(Source src) : s(src) {}
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < STACK_HEIGHT; ++i) {
      s.node[i * s.stride] = 0u;
      s.tmax[i * s.stride] = 0.f;
    }
  }
  __device__ __forceinline__ void put(int slot, uint32_t n, float t) {
    s.node[slot * s.stride] = n;
    s.tmax[slot * s.stride] = t;
  }
  __device__ __forceinline__ void get(int slot, uint32_t& n, float& t) const {
    n = s.node[slot * s.stride];
    t = s.tmax[slot * s.stride];
  }
};

// One ray through the octree behind `cur` (the JAX classic loop).
// `budget` is the step bound (max_steps rounded up to the JAX loop's
// unroll); `max_dst` < 0 means unlimited; alpha_mode 0 = opaque cast (stop
// at the first leaf), else translucent pass-through judged by texel_alpha.
// `floored`: start at max(t_min, t_floor) in caller ray units, the JAX
// engines' start_floored (voxelrs_tpu/ops/shading.py:1255-1273,
// restart_state_push voxelrs_tpu/ops/traversal.py:700-727): the root octant
// is recomputed from the new t_min at the 1.5 thresholds, and a ray whose
// floor lies past the cube's exit (+inf) misses with 0 steps. Unfloored
// calls run exactly the arithmetic they ran before. Stack / `src`: where
// the stack lives (LocalStack or SharedStack); the arithmetic is the same.
template <class Cursor, class Stack = LocalStack>
__device__ __forceinline__ void traverse_with(
    Cursor cur, float octree_scale, float ro_x, float ro_y, float ro_z,
    float rd_x, float rd_y, float rd_z, float max_dst, int budget,
    int alpha_mode, const TexTables& tx, Hit& out, bool floored = false,
    float t_floor = 0.f,
    typename Stack::Source src = typename Stack::Source()) {
  // ---- ray constants (make_ray_consts) --------------------------------
  const RayConsts c = ray_consts(octree_scale, ro_x, ro_y, ro_z, rd_x, rd_y,
                                 rd_z);
  const float tcx = c.tcx, tcy = c.tcy, tcz = c.tcz;
  const float tbx = c.tbx, tby = c.tby, tbz = c.tbz;
  const int octant_mask = c.octant_mask;
  const float md = max_dst * octree_scale;

  // ---- initial state (init_state) -------------------------------------
  float t_min = fmaxf(fmaxf(2.f * tcx - tbx, 2.f * tcy - tby), 2.f * tcz - tbz);
  t_min = fmaxf(t_min, 0.f);
  float t_max = fminf(fminf(tcx - tbx, tcy - tby), tcz - tbz);
  if (floored) t_min = fmaxf(t_min, t_floor * octree_scale);
  const bool in_x = t_min < 1.5f * tcx - tbx;
  const bool in_y = t_min < 1.5f * tcy - tby;
  const bool in_z = t_min < 1.5f * tcz - tbz;
  int idx = (int)in_x | ((int)in_y << 1) | ((int)in_z << 2);
  int scale = MAX_SCALE - 1;
  float posx = in_x ? 1.5f : 1.f, posy = in_y ? 1.5f : 1.f,
        posz = in_z ? 1.5f : 1.f;
  float h = t_max;
  Stack stk(src);
  stk.clear();
  int adj_count = 0;
  uint32_t last_value = NO_VALUE;

  out.t = -1.f;
  out.value = 0u;
  out.face = 0;
  out.pos[0] = out.pos[1] = out.pos[2] = 0.f;
  out.u = out.v = 0.f;
  out.lod = 0.f;
  out.inside = false;
  out.steps = 0;
  out.passed = false;
  out.t_oct = 0.f;
  out.idx = out.scale = 0;
  out.leaf[0] = out.leaf[1] = out.leaf[2] = 0.f;
  if (floored && !(t_min <= t_max)) return;  // starts past the exit

  for (int it = 0; it < budget; ++it) {
    out.steps++;
    if (md >= 0.f && t_min > md) break;  // distance limit (glsl:153-156)

    const float se = exp2_scale(scale);
    const float tcox = posx * tcx - tbx;
    const float tcoy = posy * tcy - tby;
    const float tcoz = posz * tcz - tbz;
    const float tc_max = fminf(fminf(tcox, tcoy), tcoz);
    const int oct = idx ^ octant_mask;

    bool is_child, is_leaf;
    cur.probe(oct, is_child, is_leaf);
    const bool hit_branch = is_child && t_min <= t_max;
    if (hit_branch && is_leaf && t_min == 0.f) out.inside = true;
    const bool leaf_hit = hit_branch && is_leaf && t_min > 0.f;

    if (leaf_hit) {
      // ---- HIT (glsl:185-265): candidate record (hit_phase) ----------
      const uint32_t leaf_value = cur.leaf_value(oct);
      const HitGeom g =
          hit_geometry(c, octree_scale, scale, posx, posy, posz, t_min);

      bool accept = true;
      if (alpha_mode != 0) {
        const float a =
            texel_alpha(tx, alpha_mode, leaf_value, g.face, g.u, g.v, g.lod);
        const bool first = adj_count == 0 || (leaf_value & NO_VALUE) != last_value;
        accept = a > 0.f && first;
        if (!accept) {
          adj_count = adj_count + 1 < 255 ? adj_count + 1 : 255;
          last_value = leaf_value & NO_VALUE;
          out.passed = true;
        }
      }
      if (accept) {  // finalize
        finalize_hit(c, octree_scale, g, t_min, leaf_value, out);
        out.t_oct = t_min;
        out.idx = idx;
        out.scale = scale;
        out.leaf[0] = posx;
        out.leaf[1] = posy;
        out.leaf[2] = posz;
        return;
      }
    } else if (!hit_branch) {
      adj_count = 0;
      last_value = NO_VALUE;
    }

    // ---- PUSH (glsl:266-311) ------------------------------------------
    const float half = se * 0.5f;
    const float tv_max = fminf(t_max, tc_max);
    const bool want_push = hit_branch && !(is_leaf && t_min > 0.f) && t_min <= tv_max;
    if (want_push) {
      const int slot = scale - STACK_BASE;
      if (tc_max < h && slot >= 0 && slot < STACK_HEIGHT) {
        stk.put(slot, cur.node, t_max);
      }
      h = tc_max;
      const bool pin_x = t_min < half * tcx + tcox;
      const bool pin_y = t_min < half * tcy + tcoy;
      const bool pin_z = t_min < half * tcz + tcoz;
      cur.push(oct);
      scale -= 1;
      idx = (int)pin_x | ((int)pin_y << 1) | ((int)pin_z << 2);
      posx = posx + (pin_x ? half : 0.f);
      posy = posy + (pin_y ? half : 0.f);
      posz = posz + (pin_z ? half : 0.f);
      t_max = tv_max;
      continue;
    }

    // ---- ADVANCE (glsl:319-331) ---------------------------------------
    const bool step_x = tc_max >= tcox;
    const bool step_y = tc_max >= tcoy;
    const bool step_z = tc_max >= tcoz;
    const int step_mask = (int)step_x | ((int)step_y << 1) | ((int)step_z << 2);
    const float ax = posx - (step_x ? se : 0.f);
    const float ay = posy - (step_y ? se : 0.f);
    const float az = posz - (step_z ? se : 0.f);
    const int adv_idx = idx ^ step_mask;
    t_min = tc_max;
    if ((adv_idx & step_mask) == 0) {
      posx = ax;
      posy = ay;
      posz = az;
      idx = adv_idx;
      continue;
    }

    // ---- POP (glsl:335-391) -------------------------------------------
    uint32_t db = 0u;
    if (step_x) db |= __float_as_uint(ax) ^ __float_as_uint(ax + se);
    if (step_y) db |= __float_as_uint(ay) ^ __float_as_uint(ay + se);
    if (step_z) db |= __float_as_uint(az) ^ __float_as_uint(az + se);
    const int pop_scale = 31 - __clz(db);
    if (pop_scale >= MAX_SCALE) break;  // left the octree
    const int pslot = clampi(pop_scale - STACK_BASE, 0, STACK_HEIGHT - 1);
    stk.get(pslot, cur.node, t_max);
    const int sc = clampi(pop_scale, 0, MAX_SCALE);
    const uint32_t shx = __float_as_uint(ax) >> sc;
    const uint32_t shy = __float_as_uint(ay) >> sc;
    const uint32_t shz = __float_as_uint(az) >> sc;
    posx = __uint_as_float(shx << sc);
    posy = __uint_as_float(shy << sc);
    posz = __uint_as_float(shz << sc);
    idx = (int)((shx & 1u) | ((shy & 1u) << 1) | ((shz & 1u) << 2));
    scale = pop_scale;
    h = 0.f;
  }
}

// One ray through the ESVO buffer (K1's traversal; see traverse_with).
__device__ void traverse(const uint32_t* __restrict__ desc, uint32_t n_rows,
                         float octree_scale, float ro_x, float ro_y, float ro_z,
                         float rd_x, float rd_y, float rd_z, float max_dst,
                         int budget, int alpha_mode, const TexTables& tx,
                         Hit& out, bool floored = false, float t_floor = 0.f) {
  traverse_with(EsvoCursor(desc, n_rows), octree_scale, ro_x, ro_y, ro_z,
                rd_x, rd_y, rd_z, max_dst, budget, alpha_mode, tx, out,
                floored, t_floor);
}

}  // namespace vx
