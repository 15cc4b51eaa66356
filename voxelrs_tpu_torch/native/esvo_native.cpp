// Native ESVO chunk serializer — the hot host-side path.
//
// C++ counterpart of voxelrs_tpu_torch.world.esvo_dense (a copy of the JAX
// package's voxelrs_tpu/native/esvo_native.cpp; and of the reference's
// Rust construct_octants_with + serialize_octant pipeline,
// reference: src/world/hds/octree.rs:127-172 + esvo.rs:439-512): dense
// (32,32,32) voxels -> the exact ESVO u32 block stream, with LOD clamping
// and the y-first representative pick. Exposed through a plain C ABI for
// ctypes; byte-identical to the numpy serializer (asserted by
// tests/test_torch_csvo.py).

#include <cstdint>
#include <cstring>

namespace {

constexpr int DEPTH = 5;
constexpr uint32_t REL_BIT = 0x80000000u;

// representative pick order (y-high first), reference internal.rs:461-485
constexpr int PICK_ORDER[8] = {2, 3, 6, 7, 0, 1, 4, 5};

struct Pyramid {
    // occupancy + representative per level, Morton-ordered
    // level l has 8^l entries; level 5 = voxels
    bool*     occ[DEPTH + 1];
    uint32_t* rep[DEPTH + 1];
};

// bit-interleave LUTs: morton = MX[x] | MY[y] | MZ[z]
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

inline int morton_index(int x, int y, int z) {
    return LUT.mx[x] | LUT.my[y] | LUT.mz[z];
}

struct Ctx {
    const Pyramid* pyr;
    uint32_t* out;
    uint32_t  cap;
    uint32_t  len;
    int       cut;
    bool      overflow;
};

// returns the u32 offset of the emitted block for node (lvl, m)
uint32_t emit(Ctx& c, int lvl, int m) {
    const Pyramid& p = *c.pyr;
    uint32_t start = c.len;
    if (c.len + 12 > c.cap) { c.overflow = true; return 0; }
    std::memset(c.out + c.len, 0, 12 * sizeof(uint32_t));
    c.len += 12;

    bool last_internal = (lvl == c.cut - 1);
    for (int idx = 0; idx < 8; ++idx) {
        int child = m * 8 + idx;
        if (!p.occ[lvl + 1][child]) continue;

        if (last_internal) {
            // leaf child: value into body, header slot stays zero
            c.out[start + 4 + idx] = p.rep[lvl + 1][child];
        } else {
            uint32_t child_off = c.len - start;
            emit(c, lvl + 1, child);
            if (c.overflow) return start;

            // child's masks into this block's header
            uint32_t ccm = 0;
            for (int k = 0; k < 8; ++k)
                if (p.occ[lvl + 2][child * 8 + k]) ccm |= 1u << k;
            uint32_t clm = (lvl + 1 == c.cut - 1) ? ccm : 0;
            uint32_t slot = (ccm << 8) | clm;
            if (idx & 1) slot <<= 16;
            c.out[start + idx / 2] |= slot;

            uint32_t rel = child_off - 4 - (uint32_t)idx;
            c.out[start + 4 + idx] = rel | REL_BIT;
        }
    }
    return start;
}

}  // namespace

extern "C" {

// voxels: 32*32*32 uint32, index [x][y][z] => x*1024 + y*32 + z
// lod: 1..5 (0 => 5)
// out/cap: output u32 buffer; returns length written (0 if empty chunk),
//          or 0xFFFFFFFF on overflow
// meta[3]: child_mask, leaf_mask, depth of the serialization result
uint32_t esvo_serialize_chunk(const uint32_t* voxels, int lod,
                              uint32_t* out, uint32_t cap, uint8_t* meta) {
    int cut = (lod >= 1 && lod <= DEPTH) ? lod : DEPTH;

    // build Morton pyramids
    static thread_local bool     occ5[32768];
    static thread_local uint32_t rep5[32768];
    static thread_local bool     occ_l[5][4096];
    static thread_local uint32_t rep_l[5][4096];

    // level 5 (voxels) in Morton order
    for (int x = 0; x < 32; ++x)
        for (int y = 0; y < 32; ++y)
            for (int z = 0; z < 32; ++z) {
                uint32_t v = voxels[(x << 10) | (y << 5) | z];
                int m = morton_index(x, y, z);
                occ5[m] = v != 0;
                rep5[m] = v;
            }

    Pyramid pyr;
    pyr.occ[5] = occ5;
    pyr.rep[5] = rep5;
    for (int lvl = 4; lvl >= 0; --lvl) {
        int n = 1 << (3 * lvl);
        bool*     po = occ_l[lvl];
        uint32_t* pr = rep_l[lvl];
        bool*     co = pyr.occ[lvl + 1];
        uint32_t* cr = pyr.rep[lvl + 1];
        for (int i = 0; i < n; ++i) {
            bool any = false;
            uint32_t chosen = 0;
            for (int k = 0; k < 8; ++k) {
                int c = PICK_ORDER[k];
                if (co[i * 8 + c]) { chosen = cr[i * 8 + c]; any = true; break; }
            }
            // occupancy needs all children, not just the pick
            if (!any) {
                for (int c = 0; c < 8 && !any; ++c) any = co[i * 8 + c];
            }
            po[i] = false;
            for (int c = 0; c < 8; ++c) po[i] = po[i] || co[i * 8 + c];
            pr[i] = chosen;
        }
        pyr.occ[lvl] = po;
        pyr.rep[lvl] = pr;
    }

    meta[0] = meta[1] = meta[2] = 0;
    if (!pyr.occ[0][0]) return 0;

    Ctx c{&pyr, out, cap, 0, cut, false};
    emit(c, 0, 0);
    if (c.overflow) return 0xFFFFFFFFu;

    uint32_t root_cm = 0;
    for (int k = 0; k < 8; ++k)
        if (pyr.occ[1][k]) root_cm |= 1u << k;
    meta[0] = (uint8_t)root_cm;
    meta[1] = (cut == 1) ? (uint8_t)root_cm : 0;
    meta[2] = (uint8_t)cut;
    return c.len;
}

}  // extern "C"
