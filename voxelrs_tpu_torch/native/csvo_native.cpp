// Native CSVO chunk serializer — the byte-compressed format's hot path.
//
// C++ counterpart of voxelrs_tpu_torch.world.csvo.serialize_dense_csvo (a
// copy of the JAX package's voxelrs_tpu/native/csvo_native.cpp; and of
// the reference's Rust serialize_octant recursion,
// reference: src/world/hds/csvo.rs:393-555): dense (32,32,32) voxels ->
// the exact CSVO node byte stream + material array, with LOD clamping and
// the y-first representative pick. Byte-identical to the Python
// serializer (asserted by tests/test_torch_csvo.py).
//
// Two passes over a Morton-dense size table instead of recursion:
//  1. bottom-up per-level node sizes (an internal node's pointer widths
//     depend on its children's running offsets, which depend on sizes);
//  2. one top-down emit writing nodes depth-first and appending leaf
//     materials in visit order (the order the Python recursion produces).

#include <cstdint>
#include <cstring>

namespace {

constexpr int DEPTH = 5;

// representative pick order (y-high first), reference internal.rs:461-485
constexpr int PICK_ORDER[8] = {2, 3, 6, 7, 0, 1, 4, 5};

struct MortonLut {
    int mx[32], my[32], mz[32];
    MortonLut() {
        for (int v = 0; v < 32; ++v) {
            int sx = 0, sy = 0, sz = 0;
            for (int k = DEPTH - 1; k >= 0; --k) {
                int b = (v >> k) & 1;
                sx = (sx << 3) | b;
                sy = (sy << 3) | (b << 1);
                sz = (sz << 3) | (b << 2);
            }
            mx[v] = sx; my[v] = sy; mz[v] = sz;
        }
    }
};
static const MortonLut LUT;

// static scratch: levels 0..5 of the occupancy/representative pyramid and
// the per-node size table (single-threaded per call; the Python side
// serializes chunks from a worker pool, so guard with a per-call stack
// allocation instead — sizes are small enough)
struct Scratch {
    bool     occ[DEPTH + 1][32768];
    uint32_t rep[DEPTH + 1][32768];
    uint32_t size[DEPTH][4096];  // node sizes per level (levels 0..cut-1)
};

struct Ctx {
    const Scratch* s;
    int cut;
    uint8_t*  nodes;
    uint32_t  node_cap;
    uint32_t  node_len;
    uint32_t* mats;
    uint32_t  mat_cap;
    uint32_t  mat_len;
    bool      overflow;
};

inline int ptr_tag(uint32_t off) {
    // (max(off,1).bit_length()-1)//8 + 1 — 1/2/3 => 1/2/4 bytes
    uint32_t v = off ? off : 1;
    int bl = 32 - __builtin_clz(v);
    return (bl - 1) / 8 + 1;
}

inline int tag_bytes(int tag) { return tag == 3 ? 4 : tag; }

void emit(Ctx& c, int lvl, int m);

inline void put(Ctx& c, uint8_t b) {
    if (c.node_len >= c.node_cap) { c.overflow = true; return; }
    c.nodes[c.node_len++] = b;
}

void emit(Ctx& c, int lvl, int m) {
    if (c.overflow) return;
    const Scratch& s = *c.s;
    int depth = c.cut - lvl;
    const bool* child_occ = &s.occ[lvl + 1][8 * (size_t)m];
    const uint32_t* child_rep = &s.rep[lvl + 1][8 * (size_t)m];

    if (depth == 1) {  // leaf node: one mask byte; values -> materials
        int mask = 0;
        for (int ch = 0; ch < 8; ++ch) {
            if (child_occ[ch]) {
                mask |= 1 << ch;
                if (c.mat_len >= c.mat_cap) { c.overflow = true; return; }
                c.mats[c.mat_len++] = child_rep[ch];
            }
        }
        put(c, (uint8_t)mask);
        return;
    }

    if (depth == 2) {  // lnode: [mask][material offset u16 LE][leaves]
        int mask = 0;
        for (int ch = 0; ch < 8; ++ch)
            if (child_occ[ch]) mask |= 1 << ch;
        put(c, (uint8_t)mask);
        if (mask) {
            uint32_t moff = c.mat_len;
            put(c, (uint8_t)(moff & 0xFF));
            put(c, (uint8_t)((moff >> 8) & 0xFF));
        }
        for (int ch = 0; ch < 8; ++ch)
            if (child_occ[ch]) emit(c, lvl + 1, 8 * m + ch);
        return;
    }

    if (depth == 3) {  // pre-leaf: [mask][u8 running offset/child][blobs]
        int mask = 0;
        uint32_t running = 0;
        uint32_t mask_at = c.node_len;
        put(c, 0);
        for (int ch = 0; ch < 8; ++ch) {
            if (!child_occ[ch]) continue;
            mask |= 1 << ch;
            put(c, (uint8_t)running);
            running += s.size[lvl + 1][8 * m + ch];
        }
        if (c.overflow) return;
        c.nodes[mask_at] = (uint8_t)mask;
        for (int ch = 0; ch < 8; ++ch)
            if (child_occ[ch]) emit(c, lvl + 1, 8 * m + ch);
        return;
    }

    // internal: [u16 LE tag header][1/2/4-byte LE rel offsets][blobs]
    uint32_t header = 0;
    uint32_t running = 0;
    uint32_t header_at = c.node_len;
    put(c, 0); put(c, 0);
    for (int ch = 0; ch < 8; ++ch) {
        if (!child_occ[ch]) continue;
        int tag = ptr_tag(running);
        header |= (uint32_t)tag << (ch * 2);
        int nb = tag_bytes(tag);
        for (int b = 0; b < nb; ++b)
            put(c, (uint8_t)((running >> (8 * b)) & 0xFF));
        running += s.size[lvl + 1][8 * m + ch];
    }
    if (c.overflow) return;
    c.nodes[header_at] = (uint8_t)(header & 0xFF);
    c.nodes[header_at + 1] = (uint8_t)((header >> 8) & 0xFF);
    for (int ch = 0; ch < 8; ++ch)
        if (child_occ[ch]) emit(c, lvl + 1, 8 * m + ch);
}

}  // namespace

extern "C" {

// voxels: (32,32,32) u32 C-order [x,y,z]. Writes node bytes to out_nodes
// and u32 materials to out_mats; *out_cut receives the effective depth
// cut. Returns the node byte count, 0 for an empty chunk, 0xFFFFFFFF on
// capacity overflow.
uint32_t csvo_serialize_chunk(const uint32_t* voxels, int lod,
                              uint8_t* out_nodes, uint32_t node_cap,
                              uint32_t* out_mats, uint32_t mat_cap,
                              uint32_t* out_mat_len, uint8_t* out_cut) {
    static thread_local Scratch s;
    int cut = (lod >= 1 && lod <= DEPTH) ? lod : DEPTH;
    *out_cut = (uint8_t)cut;
    *out_mat_len = 0;

    // level 5: voxels in Morton order
    for (int x = 0; x < 32; ++x)
        for (int y = 0; y < 32; ++y) {
            const uint32_t* col = voxels + ((size_t)x * 32 + y) * 32;
            int mxy = LUT.mx[x] | LUT.my[y];
            for (int z = 0; z < 32; ++z) {
                int mi = mxy | LUT.mz[z];
                uint32_t v = col[z];
                s.occ[DEPTH][mi] = v != 0;
                s.rep[DEPTH][mi] = v;
            }
        }
    // pyramid: occupancy any-of-8, representative by PICK_ORDER
    for (int lvl = DEPTH - 1; lvl >= 0; --lvl) {
        int n = 1 << (3 * lvl);
        for (int i = 0; i < n; ++i) {
            const bool* o = &s.occ[lvl + 1][8 * (size_t)i];
            const uint32_t* r = &s.rep[lvl + 1][8 * (size_t)i];
            bool any = false;
            uint32_t chosen = 0;
            for (int k = 0; k < 8; ++k) {
                int ch = PICK_ORDER[k];
                if (o[ch]) { chosen = r[ch]; any = true; break; }
            }
            s.occ[lvl][i] = any;
            s.rep[lvl][i] = chosen;
        }
    }
    if (!s.occ[0][0]) return 0;

    // pass 1: per-node sizes, bottom-up over levels 0..cut-1
    for (int lvl = cut - 1; lvl >= 0; --lvl) {
        int depth = cut - lvl;
        int n = 1 << (3 * lvl);
        for (int i = 0; i < n; ++i) {
            if (!s.occ[lvl][i]) { s.size[lvl][i] = 0; continue; }
            const bool* o = &s.occ[lvl + 1][8 * (size_t)i];
            uint32_t sz;
            if (depth == 1) {
                sz = 1;
            } else if (depth == 2) {
                sz = 1 + 2;  // mask + material offset (mask != 0 here)
                for (int ch = 0; ch < 8; ++ch) if (o[ch]) sz += 1;
            } else if (depth == 3) {
                sz = 1;
                for (int ch = 0; ch < 8; ++ch)
                    if (o[ch]) sz += 1 + s.size[lvl + 1][8 * i + ch];
            } else {
                sz = 2;
                uint32_t running = 0;
                for (int ch = 0; ch < 8; ++ch) {
                    if (!o[ch]) continue;
                    sz += tag_bytes(ptr_tag(running));
                    running += s.size[lvl + 1][8 * i + ch];
                }
                sz += running;  // the children's blobs follow the pointers
            }
            s.size[lvl][i] = sz;
        }
    }

    Ctx c{&s, cut, out_nodes, node_cap, 0, out_mats, mat_cap, 0, false};
    emit(c, 0, 0);
    if (c.overflow) return 0xFFFFFFFFu;
    *out_mat_len = c.mat_len;
    return c.node_len;
}

}  // extern "C"
