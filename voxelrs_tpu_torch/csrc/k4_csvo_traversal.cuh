// CSVO traversal (K4): the node cursor over the byte-compressed stream,
// driven by the traversal loop of k1_traversal.cuh (traverse_with).
//
// Replaces (JAX package): voxelrs_tpu/ops/traversal_csvo.py::
// intersect_octree_csvo (:151-567), the classic loop: unaligned byte reads
// (:194-215), the 2-bit pointer-size tag decode (:216-228), read_next_ptr
// (:229), read_leaf (:271), hit_phase (:321) and step (:357). The JAX
// opaque cast's push engine (:569-1172, make_overlap_rows :633 and its
// 48-byte overlap rows) is TPU structure and is not carried over: the opaque
// cast here runs the same classic loop with no alpha judge.
//
// Design: one thread per ray, as the reference GLSL
// (assets/shaders/svo.csvo.glsl). The loop, the stack of 12 (node, t_max)
// entries in registers and all float arithmetic are K1's (traverse_with);
// only the node cursor differs: the stack word packs ptr | depth << 27,
// a byte pointer into the stream and the node's remaining depth, which
// selects its encoding (internal u16 tag header, pre-leaf u8 offsets, lnode
// with its u16 material offset, leaf byte). Byte reads are aligned __ldg
// word loads with shifts; a word index past the end reads the last word,
// as the JAX gather clamps it. A pointer with bit 31 set crosses into a
// chunk blob ([lod u8][material bytes u32][materials][nodes]): the cursor
// moves to its nodes, takes the blob's lod as the depth and remembers its
// material section; the last lnode visited (pre_leaf) and that section
// resolve a leaf's value.
//
// What bounds it on an H100: instruction issue, more than the dependent
// loads (chip_smoke.py --renderer-only and --parent on an H100, PERF.md
// §6): a launch of ~2M rays at full occupancy hides the L2 round trips,
// and a node window of 16-byte loads, which brings a child pointer with
// its header, made K4 8-14% slower for the instructions that pick the
// bytes out of it. So the step is cut to few instructions: the probe
// branches on the node's header alone (is_child and is_leaf are its tag
// or mask bit; a pointer never equals INVALID_PTR, so the pointer is
// consumed only by push and leaf_value), and the pointer widths before
// and up to the child are sums of the header's 2-bit tags by popcounts,
// not a loop over the eight tags. The reads stay unconditional, as the
// plain version's: loading a pointer only where there is a child, and
// only the words its bytes lie in, made K4 and K3-CSVO 3% faster still
// but K9's and K9-judged's CSVO traces, whose warps diverge more, 3-7%
// slower than before; keeping an lnode's material offset and leaf masks
// in registers for its leaves' probes made K4 3% and K3-CSVO 6% slower.
// The reads clamp as the JAX gather does, so the hits stay bit for bit
// those of ops.traversal_csvo.CsvoReader.

#pragma once
#include <cstdint>

#include "k1_traversal.cuh"

namespace vx {

constexpr uint32_t CSVO_DEPTH_SHIFT = 27;
constexpr uint32_t CSVO_PTR_MASK = (1u << CSVO_DEPTH_SHIFT) - 1u;
constexpr uint32_t INVALID_PTR = 0xFFFFFFFFu;

// The bytes of the 2-bit pointer tags of a header h (widths 0, 1, 2, 4
// for tags 0-3: a tag's value, plus one for a 3).
__device__ __forceinline__ uint32_t tag_widths(uint32_t h) {
  return __popc(h & 0x5555u) + 2u * __popc(h & 0xAAAAu) +
         __popc(h & (h >> 1) & 0x5555u);
}

struct CsvoCursor {
  const uint32_t* __restrict__ words;
  uint32_t last;      // index of the stream's last word
  uint32_t node;      // ptr | depth << 27
  uint32_t mat_ptr;   // the current chunk's material section
  uint32_t pre_leaf;  // the last lnode (depth 2) visited
  uint32_t next;      // probe's child pointer (where it found a child)
  bool crossed;       // probe's pointer crosses into a chunk blob

  __device__ CsvoCursor(const uint32_t* __restrict__ w, uint32_t n_words,
                        uint32_t root_ptr, int total_depth)
      : words(w), last(n_words - 1u),
        node((root_ptr & CSVO_PTR_MASK) |
             ((uint32_t)total_depth << CSVO_DEPTH_SHIFT)),
        mat_ptr(INVALID_PTR), pre_leaf(INVALID_PTR), next(INVALID_PTR),
        crossed(false) {}

  __device__ __forceinline__ uint32_t word(uint32_t i) const {
    return __ldg(words + (i < last ? i : last));
  }
  __device__ __forceinline__ uint32_t read_u32(uint32_t bp) const {
    const uint32_t lo = word(bp >> 2);
    const uint32_t sh = (bp & 3u) * 8u;
    if (sh == 0u) return lo;
    return (lo >> sh) | (word((bp >> 2) + 1u) << (32u - sh));
  }
  __device__ __forceinline__ uint32_t read_byte(uint32_t bp) const {
    return (word(bp >> 2) >> ((bp & 3u) * 8u)) & 0xFFu;
  }

  // child `oct` of the current node, by its depth (read_next_ptr,
  // svo.csvo.glsl:53-116): is_child / is_leaf from the header alone, the
  // pointer into `next` (and `crossed`) for push
  __device__ __forceinline__ void probe(int oct, bool& is_child,
                                        bool& is_leaf) {
    const uint32_t ptr = node & CSVO_PTR_MASK;
    const uint32_t depth = node >> CSVO_DEPTH_SHIFT;
    const uint32_t idx = (uint32_t)oct;
    crossed = false;
    if (depth > 3u) {  // internal: u16 header of 2-bit pointer widths
      const uint32_t header = read_u32(ptr) & 0xFFFFu;
      const uint32_t tag = (header >> (idx * 2u)) & 3u;
      const uint32_t off = tag_widths(header & ((1u << (idx * 2u)) - 1u));
      uint32_t raw = read_u32(ptr + 2u + off);
      if (tag < 3u) raw &= (1u << (((1u << tag) >> 1) * 8u)) - 1u;
      crossed = tag == 3u && (raw & 0x80000000u) != 0u;
      next = crossed ? raw ^ 0x80000000u : ptr + 2u + tag_widths(header) + raw;
      is_child = tag != 0u;
      is_leaf = false;
      return;
    }
    // pre-leaf (3) and lnode (2, 1): u8 child mask
    const uint32_t header = read_byte(ptr);
    const uint32_t rank = __popc(header & ((1u << idx) - 1u));
    next = depth == 3u ? ptr + 1u + __popc(header) + read_byte(ptr + 1u + rank)
                       : ptr + 3u + rank;
    if (depth == 2u) pre_leaf = ptr;
    is_child = ((header >> idx) & 1u) != 0u;
    is_leaf = is_child && depth < 2u;
  }

  // material of leaf bit `oct` of the current leaf byte: the leaves before
  // it in its lnode index the chunk's material section (read_leaf,
  // svo.csvo.glsl:119-133)
  __device__ __forceinline__ uint32_t leaf_value(int oct) const {
    const uint32_t ptr = node & CSVO_PTR_MASK;
    const uint32_t mat_off = read_u32(pre_leaf + 1u) & 0xFFFFu;
    const int bit_mark = (int)((ptr - (pre_leaf + 3u)) * 8u + (uint32_t)oct);
    const int over = (int)((uint32_t)bit_mark - 32u);
    const uint32_t m0 = bit_mark >= 32 ? 0xFFFFFFFFu
                                       : (1u << clampi(bit_mark, 0, 31)) - 1u;
    uint32_t m1 = over >= 32 ? 0xFFFFFFFFu : (1u << clampi(over, 0, 31)) - 1u;
    if (over <= 0) m1 = 0u;
    const uint32_t preceding = __popc(read_u32(pre_leaf + 3u) & m0) +
                               __popc(read_u32(pre_leaf + 7u) & m1);
    return read_u32(mat_ptr + mat_off * 4u + preceding * 4u);
  }

  // descend into the child found by probe (a crossing enters the chunk
  // blob's nodes, glsl:397-409)
  __device__ __forceinline__ void push(int) {
    uint32_t ptr = next;
    uint32_t depth = (node >> CSVO_DEPTH_SHIFT) - 1u;
    if (crossed) {
      depth = read_byte(next);
      ptr = next + 5u + read_u32(next + 1u);
      mat_ptr = next + 5u;
    }
    node = (ptr & CSVO_PTR_MASK) | (depth << CSVO_DEPTH_SHIFT);
  }
};

// One ray through the CSVO stream (K4; see traverse_with). `budget` is
// max_steps rounded up to a multiple of 2 (the JAX loop's unroll).
__device__ void traverse_csvo(const uint32_t* __restrict__ words,
                              uint32_t n_words, uint32_t root_ptr,
                              int total_depth, float octree_scale, float ro_x,
                              float ro_y, float ro_z, float rd_x, float rd_y,
                              float rd_z, float max_dst, int budget,
                              int alpha_mode, const TexTables& tx, Hit& out,
                              bool floored = false, float t_floor = 0.f) {
  traverse_with(CsvoCursor(words, n_words, root_ptr, total_depth),
                octree_scale, ro_x, ro_y, ro_z, rd_x, rd_y, rd_z, max_dst,
                budget, alpha_mode, tx, out, floored, t_floor);
}

}  // namespace vx
