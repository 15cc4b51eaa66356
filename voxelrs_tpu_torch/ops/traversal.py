"""ESVO ray traversal: the plain PyTorch version and the wrapper of kernel K1.

Counterpart: voxelrs_tpu/ops/traversal.py — ``make_ray_consts`` :124,
``init_state`` :162, ``traversal_step`` :311, ``run_loop`` :1038,
``finalize`` :1053 (``hit_phase_fat``/``_hit_geometry`` :241/:270) and
``intersect_octree`` :1087. The Laine–Karras sparse-voxel-octree traversal
(reference: assets/shaders/svo.esvo.glsl:50-393, after "Efficient Sparse
Voxel Octrees", Laine & Karras 2010) works on f32 mantissa bits: PUSH,
ADVANCE and POP, the findMSB ascent and the signed-epsilon substitution are
kept exact through bitcasts.

The plain version steps a ``(B,)`` ray batch together, lane-masked, as the
JAX classic loop does: the same operations in the same order, each rounded
on its own (XLA on the CPU fuses ``a*b - c`` into one FMA, so float fields
differ from it in the last bits). It serves the CPU and the comparisons on
the card, where it equals K1 bit for bit. On a CUDA tensor
``intersect_octree`` launches K1 (``csrc/kernels.cu``), one thread per ray
with the stack in local memory.

Unsigned 32-bit words (descriptors, pointers) are held in int64 tensors
masked to 32 bits: bit 31 of a child pointer is the relative flag and the
stack packs ``ptr | parent_idx << 28``, so a sign-extending shift on int32
would corrupt them silently.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import _build
from .bits import (EPSILON, MAX_SCALE, U32_MASK, copysign_epsilon, f32_bits,
                   find_msb, bits_f32, smoothstep)

MAX_STEPS = 1000
RELATIVE_BIT = 1 << 31
# ptr | parent_idx << 28 packing limits the SVO buffer to 2^28 u32 = 1 GiB
PTR_BITS = 28
PTR_MASK = (1 << PTR_BITS) - 1
STACK_HEIGHT = 12  # supports world depth <= 12 (radius 64 chunks)
_NO_VALUE = 0x00FFFFFF
# the JAX loop runs this many steps per loop iteration; a ray's step budget
# is max_steps rounded up to a multiple of it
UNROLL = 4
# the plain loop tests for live rays (a host sync) every this many steps
_LIVE_CHECK = 16

f32, i64 = torch.float32, torch.int64


class TraversalResult(NamedTuple):
    """Per-ray hit data; ``t == -1`` means no hit
    (mirrors OctreeResult, reference: assets/shaders/svo.glsl:31-40)."""

    t: torch.Tensor  # (B,) world-space distance, -1 = miss
    value: torch.Tensor  # (B,) int64 hit block id (a u32 word)
    face_id: torch.Tensor  # (B,) int32: 0=-x 1=+x 2=-y 3=+y 4=-z 5=+z
    pos: torch.Tensor  # (B,3) world-space hit position
    uv: torch.Tensor  # (B,2) face uv
    lod: torch.Tensor  # (B,) texture lod used
    inside_voxel: torch.Tensor  # (B,) bool
    steps: torch.Tensor  # (B,) int32 traversal steps this ray ran


class RayConsts(NamedTuple):
    """Per-ray loop invariants."""

    rox: torch.Tensor
    roy: torch.Tensor
    roz: torch.Tensor
    rdx: torch.Tensor
    rdy: torch.Tensor
    rdz: torch.Tensor
    tcx: torch.Tensor
    tcy: torch.Tensor
    tcz: torch.Tensor
    tbx: torch.Tensor
    tby: torch.Tensor
    tbz: torch.Tensor
    mirror_x: torch.Tensor
    mirror_y: torch.Tensor
    mirror_z: torch.Tensor
    octant_mask: torch.Tensor
    max_dst: torch.Tensor
    octree_scale: float


class State(NamedTuple):
    active: torch.Tensor
    hit: torch.Tensor
    inside: torch.Tensor
    node: tuple  # the format's node cursor; node[0] is the stack word
    idx: torch.Tensor
    scale: torch.Tensor
    posx: torch.Tensor
    posy: torch.Tensor
    posz: torch.Tensor
    t_min: torch.Tensor
    t_max: torch.Tensor
    h: torch.Tensor
    adj_count: torch.Tensor  # adjacent same-value translucent leaves passed
    last_value: torch.Tensor  # 24-bit value of the last leaf passed
    stack_node: torch.Tensor  # (H, B) stack words
    stack_tmax: torch.Tensor  # (H, B)
    steps: torch.Tensor
    passed: torch.Tensor  # a judged cast rejected a candidate leaf


def _exp2_scale(scale: torch.Tensor) -> torch.Tensor:
    """Exact 2^(scale - MAX_SCALE) via exponent-bit construction."""
    return ((scale - MAX_SCALE + 127) << 23).to(torch.int32).view(f32)


def make_ray_consts(octree_scale: float, ro, rd, max_dst) -> RayConsts:
    """Coordinate shift to [1;2), epsilon substitution, direction mirroring
    (reference: svo.esvo.glsl:51-124)."""
    B = ro.shape[0]
    max_dst = torch.as_tensor(max_dst, dtype=f32, device=ro.device)
    max_dst = max_dst.expand(B) * octree_scale

    rox = ro[:, 0] * octree_scale + 1.0
    roy = ro[:, 1] * octree_scale + 1.0
    roz = ro[:, 2] * octree_scale + 1.0
    rdx = copysign_epsilon(rd[:, 0])
    rdy = copysign_epsilon(rd[:, 1])
    rdz = copysign_epsilon(rd[:, 2])

    tcx = torch.reciprocal(-rdx.abs())
    tcy = torch.reciprocal(-rdy.abs())
    tcz = torch.reciprocal(-rdz.abs())
    tbx = tcx * rox
    tby = tcy * roy
    tbz = tcz * roz

    mirror_x = rdx > 0
    mirror_y = rdy > 0
    mirror_z = rdz > 0
    octant_mask = (mirror_x.to(i64) | (mirror_y.to(i64) << 1)
                   | (mirror_z.to(i64) << 2))
    tbx = torch.where(mirror_x, 3.0 * tcx - tbx, tbx)
    tby = torch.where(mirror_y, 3.0 * tcy - tby, tby)
    tbz = torch.where(mirror_z, 3.0 * tcz - tbz, tbz)

    return RayConsts(rox, roy, roz, rdx, rdy, rdz, tcx, tcy, tcz, tbx, tby,
                     tbz, mirror_x, mirror_y, mirror_z, octant_mask, max_dst,
                     float(octree_scale))


def init_state(c: RayConsts, root: tuple,
               t_floor: Optional[torch.Tensor] = None) -> State:
    """Entry/exit distances of the [1;2) cube and the initial octant
    (reference: svo.esvo.glsl:126-149), at the node cursor ``root``.

    ``t_floor`` (B,) float32, in caller ray units, starts each ray at
    ``max(t_min, t_floor)`` as the JAX engines' ``start_floored`` does
    (voxelrs_tpu/ops/shading.py:1255-1273 and ``restart_state_push``
    voxelrs_tpu/ops/traversal.py:700-727): the root octant is recomputed
    at the 1.5 thresholds from the new ``t_min``, and a ray whose floor
    lies past the cube's exit (a +inf floor) starts inactive and misses.
    A floor at or below the entry leaves every number as without it."""
    B = c.rox.shape[0]
    dev = c.rox.device
    t_min = torch.maximum(torch.maximum(2.0 * c.tcx - c.tbx,
                                        2.0 * c.tcy - c.tby),
                          2.0 * c.tcz - c.tbz)
    t_min = torch.clamp(t_min, min=0.0)
    t_max = torch.minimum(torch.minimum(c.tcx - c.tbx, c.tcy - c.tby),
                          c.tcz - c.tbz)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    if t_floor is not None:
        t_min = torch.maximum(t_min, t_floor.to(f32) * c.octree_scale)
        active = t_min <= t_max
    in_x = t_min < 1.5 * c.tcx - c.tbx
    in_y = t_min < 1.5 * c.tcy - c.tby
    in_z = t_min < 1.5 * c.tcz - c.tbz
    idx = in_x.to(i64) | (in_y.to(i64) << 1) | (in_z.to(i64) << 2)
    half = lambda m: torch.where(m, 1.5, 1.0).to(f32)  # noqa: E731
    return State(
        active=active,
        hit=torch.zeros(B, dtype=torch.bool, device=dev),
        inside=torch.zeros(B, dtype=torch.bool, device=dev),
        node=root,
        idx=idx,
        scale=torch.full((B,), MAX_SCALE - 1, dtype=i64, device=dev),
        posx=half(in_x), posy=half(in_y), posz=half(in_z),
        t_min=t_min,
        t_max=t_max,
        h=t_max,
        adj_count=torch.zeros(B, dtype=i64, device=dev),
        last_value=torch.full((B,), _NO_VALUE, dtype=i64, device=dev),
        stack_node=torch.zeros((STACK_HEIGHT, B), dtype=i64, device=dev),
        stack_tmax=torch.zeros((STACK_HEIGHT, B), dtype=f32, device=dev),
        steps=torch.zeros(B, dtype=torch.int32, device=dev),
        passed=torch.zeros(B, dtype=torch.bool, device=dev),
    )


def _word(words: torch.Tensor, ptr: torch.Tensor, widx) -> torch.Tensor:
    """Word ``widx`` of the 12-word block at word address ``ptr`` (block
    index clamped into the buffer, as the JAX row gather clamps)."""
    n_rows = words.shape[0] // 12
    blk = torch.clamp(ptr // 12, 0, n_rows - 1)
    return words[blk * 12 + widx]


def _resolve_ptr(raw, ptr, pidx):
    """Resolve relative/absolute child pointer (svo.esvo.glsl:9-16)."""
    rel = (ptr + 4 + pidx + (raw & 0x7FFFFFFF)) & U32_MASK
    return torch.where((raw & RELATIVE_BIT) != 0, rel, raw)


class EsvoReader:
    """The plain traversal's reads of an ESVO buffer. A node cursor is
    ``(pp,)``, pp = ptr | parent_idx << 28 (the stack word). The CSVO
    reader (``ops/traversal_csvo.py``) has the same four methods; the loop
    (``traversal_step``) is the same for both, as in the kernels."""

    def __init__(self, words: torch.Tensor):
        self.words = words

    def root(self, B: int, device) -> tuple:
        return (torch.zeros(B, dtype=i64, device=device),)

    def probe(self, node, octant_idx, active):
        """(is_child, is_leaf, node, carry) of child ``octant_idx`` of the
        current node: the step's descriptor fetch."""
        pp, = node
        pidx = pp >> PTR_BITS
        descriptor = _word(self.words, pp & PTR_MASK, pidx // 2)
        descriptor = torch.where(pidx % 2 != 0, descriptor >> 16, descriptor)
        bit = 1 << octant_idx
        return ((descriptor & (bit << 8)) != 0, (descriptor & bit) != 0,
                node, None)

    def _child(self, pp):
        ptr, pidx = pp & PTR_MASK, pp >> PTR_BITS
        return _resolve_ptr(_word(self.words, ptr, 4 + pidx), ptr, pidx)

    def leaf_value(self, node, octant_idx):
        """Value of leaf child ``octant_idx`` (svo.esvo.glsl:185-237)."""
        return _word(self.words, self._child(node[0]), 4 + octant_idx)

    def push(self, node, octant_idx, carry, want_push) -> tuple:
        """The cursor after descending into child ``octant_idx`` where
        ``want_push``."""
        pp, = node
        pushed = (self._child(pp) & PTR_MASK) | (octant_idx << PTR_BITS)
        return (torch.where(want_push, pushed, pp),)


def _hit_geometry(c: RayConsts, scale, posx, posy, posz, t_min):
    """Face id, uv, distance and texture lod of a candidate hit (pure math)."""
    scale_exp2 = _exp2_scale(scale)
    t2x = (posx + scale_exp2) * c.tcx - c.tbx
    t2y = (posy + scale_exp2) * c.tcy - c.tby
    t2z = (posz + scale_exp2) * c.tcz - c.tbz
    tc_min = torch.maximum(torch.maximum(t2x, t2y), t2z)

    upx = torch.where(c.mirror_x, 3.0 - scale_exp2 - posx, posx)
    upy = torch.where(c.mirror_y, 3.0 - scale_exp2 - posy, posy)
    upz = torch.where(c.mirror_z, 3.0 - scale_exp2 - posz, posz)

    sign_x = f32_bits(c.rdx) >> 31
    sign_y = f32_bits(c.rdy) >> 31
    sign_z = f32_bits(c.rdz) >> 31

    on_x = tc_min == t2x
    on_y = (~on_x) & (tc_min == t2y)

    face_id = torch.where(on_x, sign_x,
                          torch.where(on_y, 2 | sign_y, 4 | sign_z))
    ux = torch.where(
        on_x, (c.roz + c.rdz * t2x) - upz,
        torch.where(on_y, (c.rox + c.rdx * t2y) - upx,
                    (c.rox + c.rdx * t2z) - upx))
    uy = torch.where(
        on_x, (c.roy + c.rdy * t2x) - upy,
        torch.where(on_y, (c.roz + c.rdz * t2y) - upz,
                    (c.roy + c.rdy * t2z) - upy))
    ux = ux / scale_exp2
    uy = uy / scale_exp2
    ux = torch.where(on_x & c.mirror_x, 1.0 - ux, ux)
    uy = torch.where(on_y & c.mirror_y, 1.0 - uy, uy)
    ux = torch.where(~on_x & ~on_y & ~c.mirror_z, 1.0 - ux, ux)

    dst = t_min / c.octree_scale
    tex_lod = smoothstep(15.0, 25.0, dst) * (dst - 15.0) * 0.05
    return face_id, ux, uy, dst, tex_lod, (upx, upy, upz)


def traversal_step(reader, c: RayConsts, s: State,
                   alpha_fn: Optional[Callable]) -> State:
    """One lock-step traversal step over all lanes
    (reference: svo.esvo.glsl:152-392) through ``reader``'s format.
    ``alpha_fn`` None = opaque cast (stop at the first leaf)."""
    stack_base = MAX_SCALE - STACK_HEIGHT

    scale_exp2 = _exp2_scale(s.scale)
    steps = s.steps + s.active.to(torch.int32)

    # distance-limit early out (glsl:153-156)
    active = s.active & ~((c.max_dst >= 0) & (s.t_min > c.max_dst))

    tcox = s.posx * c.tcx - c.tbx
    tcoy = s.posy * c.tcy - c.tby
    tcoz = s.posz * c.tcz - c.tbz
    tc_max = torch.minimum(torch.minimum(tcox, tcoy), tcoz)

    octant_idx = s.idx ^ c.octant_mask
    is_child, is_leaf, node, carry = reader.probe(s.node, octant_idx, active)

    hit_branch = is_child & (s.t_min <= s.t_max)
    inside = s.inside | (active & hit_branch & is_leaf & (s.t_min == 0))

    # ---- HIT: leaf with positive travel (glsl:185-265) -----------------
    leaf_hit = hit_branch & is_leaf & (s.t_min > 0)
    adj_count, last_value, passed = s.adj_count, s.last_value, s.passed
    if alpha_fn is not None:
        leaf_value = reader.leaf_value(node, octant_idx)
        face_id, ux, uy, _, tex_lod, _ = _hit_geometry(
            c, s.scale, s.posx, s.posy, s.posz, s.t_min)
        alpha = alpha_fn(leaf_value, face_id, torch.stack([ux, uy], -1),
                         tex_lod)
        first_of_kind = (adj_count == 0) | ((leaf_value & _NO_VALUE)
                                            != last_value)
        accept = active & leaf_hit & (alpha > 0) & first_of_kind
        passthrough = active & leaf_hit & ~accept
        adj_count = torch.where(passthrough,
                                torch.clamp(adj_count + 1, max=255),
                                adj_count)
        last_value = torch.where(passthrough, leaf_value & _NO_VALUE,
                                 last_value)
        passed = passed | passthrough
    else:
        accept = active & leaf_hit

    miss = active & ~hit_branch
    adj_count = torch.where(miss, 0, adj_count)
    last_value = torch.where(miss, _NO_VALUE, last_value)

    hit = s.hit | accept
    active = active & ~accept

    # ---- PUSH (glsl:266-311) ---------------------------------------------
    half_scale = scale_exp2 * 0.5
    t_center_x = half_scale * c.tcx + tcox
    t_center_y = half_scale * c.tcy + tcoy
    t_center_z = half_scale * c.tcz + tcoz
    tv_max = torch.minimum(s.t_max, tc_max)

    want_push = (active & hit_branch & ~(is_leaf & (s.t_min > 0))
                 & (s.t_min <= tv_max))

    slot = s.scale - stack_base
    lv = torch.arange(STACK_HEIGHT, device=slot.device)[:, None] == slot[None]
    do_store = (want_push & (tc_max < s.h))[None, :] & lv
    stack_node = torch.where(do_store, node[0][None, :], s.stack_node)
    stack_tmax = torch.where(do_store, s.t_max[None, :], s.stack_tmax)
    h_new = torch.where(want_push, tc_max, s.h)

    node = reader.push(node, octant_idx, carry, want_push)
    push_scale = s.scale - 1

    pin_x = s.t_min < t_center_x
    pin_y = s.t_min < t_center_y
    pin_z = s.t_min < t_center_z
    push_idx = pin_x.to(i64) | (pin_y.to(i64) << 1) | (pin_z.to(i64) << 2)
    push_posx = s.posx + torch.where(pin_x, half_scale, 0.0)
    push_posy = s.posy + torch.where(pin_y, half_scale, 0.0)
    push_posz = s.posz + torch.where(pin_z, half_scale, 0.0)

    # ---- ADVANCE (glsl:319-331) ------------------------------------------
    advance = active & ~want_push

    step_x = tc_max >= tcox
    step_y = tc_max >= tcoy
    step_z = tc_max >= tcoz
    step_mask = step_x.to(i64) | (step_y.to(i64) << 1) | (step_z.to(i64) << 2)
    adv_posx = s.posx - torch.where(step_x, scale_exp2, 0.0)
    adv_posy = s.posy - torch.where(step_y, scale_exp2, 0.0)
    adv_posz = s.posz - torch.where(step_z, scale_exp2, 0.0)
    adv_idx = s.idx ^ step_mask

    # ---- POP (glsl:335-391) ----------------------------------------------
    need_pop = advance & ((adv_idx & step_mask) != 0)

    zero = torch.zeros_like(s.idx)
    db = torch.where(step_x, f32_bits(adv_posx) ^ f32_bits(adv_posx + scale_exp2), zero)
    db = db | torch.where(step_y, f32_bits(adv_posy) ^ f32_bits(adv_posy + scale_exp2), zero)
    db = db | torch.where(step_z, f32_bits(adv_posz) ^ f32_bits(adv_posz + scale_exp2), zero)
    pop_scale = find_msb(db)

    exited = need_pop & (pop_scale >= MAX_SCALE)
    active = active & ~exited
    do_pop = need_pop & ~exited

    pop_slot = torch.clamp(pop_scale - stack_base, 0, STACK_HEIGHT - 1)
    pop_node = stack_node.gather(0, pop_slot[None])[0]
    pop_t_max = stack_tmax.gather(0, pop_slot[None])[0]

    sc = torch.clamp(pop_scale, 0, MAX_SCALE)
    shx = f32_bits(adv_posx) >> sc
    shy = f32_bits(adv_posy) >> sc
    shz = f32_bits(adv_posz) >> sc
    pop_posx = bits_f32(shx << sc)
    pop_posy = bits_f32(shy << sc)
    pop_posz = bits_f32(shz << sc)
    pop_idx = (shx & 1) | ((shy & 1) << 1) | ((shz & 1) << 2)

    def sel(push_v, pop_v, adv_v, old_v):
        v = torch.where(want_push, push_v, old_v)
        v = torch.where(advance, adv_v, v)
        return torch.where(do_pop, pop_v, v)

    return State(
        active=active,
        hit=hit,
        inside=inside,
        node=(torch.where(do_pop, pop_node, node[0]),) + node[1:],
        idx=sel(push_idx, pop_idx, adv_idx, s.idx),
        scale=sel(push_scale, pop_scale, s.scale, s.scale),
        posx=sel(push_posx, pop_posx, adv_posx, s.posx),
        posy=sel(push_posy, pop_posy, adv_posy, s.posy),
        posz=sel(push_posz, pop_posz, adv_posz, s.posz),
        t_min=torch.where(advance, tc_max, s.t_min),
        t_max=sel(tv_max, pop_t_max, s.t_max, s.t_max),
        h=torch.where(do_pop, 0.0, h_new),
        adj_count=adj_count,
        last_value=last_value,
        stack_node=stack_node,
        stack_tmax=stack_tmax,
        steps=steps,
        passed=passed,
    )


def step_budget(max_steps: int) -> int:
    """Steps a ray may take: the JAX loop runs ``UNROLL`` steps per
    iteration while ``it < max_steps``."""
    return -(-max_steps // UNROLL) * UNROLL


def run_loop(reader, c: RayConsts, state: State, budget: int,
             alpha_fn) -> State:
    """Step until every ray retires or the ``budget`` steps are spent. A
    retired ray's state is frozen, so testing for live rays only every
    ``_LIVE_CHECK`` steps changes nothing but the count of host syncs."""
    for it in range(budget):
        if it % _LIVE_CHECK == 0 and not bool(state.active.any()):
            break
        state = traversal_step(reader, c, state, alpha_fn)
    return state


def finalize_fields(c: RayConsts, scale, posx, posy, posz, t_min, hit,
                    leaf_value):
    """(t, value, face_id, pos, uv, lod) of the leaf of ``scale`` based at
    ``pos`` (mirrored space) entered at ``t_min`` (octree units), where
    ``hit``: the hit record of the JAX finalize (:1053), also that of a
    frozen K9 record (``ops.adaptive``)."""
    face_id, ux, uy, dst, tex_lod, (upx, upy, upz) = _hit_geometry(
        c, scale, posx, posy, posz, t_min)
    scale_exp2 = _exp2_scale(scale)

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    hx = clip(c.rox + t_min * c.rdx, upx + EPSILON, upx + scale_exp2 - EPSILON)
    hy = clip(c.roy + t_min * c.rdy, upy + EPSILON, upy + scale_exp2 - EPSILON)
    hz = clip(c.roz + t_min * c.rdz, upz + EPSILON, upz + scale_exp2 - EPSILON)
    hit_pos = (torch.stack([hx, hy, hz], -1) - 1.0) / c.octree_scale
    return (torch.where(hit, dst, -1.0),
            torch.where(hit, leaf_value, 0),
            torch.where(hit, face_id, 0).to(torch.int32),
            torch.where(hit[:, None], hit_pos, 0.0),
            torch.where(hit[:, None], torch.stack([ux, uy], -1), 0.0),
            torch.where(hit, tex_lod, 0.0))


def finalize(reader, c: RayConsts, state: State) -> TraversalResult:
    """Recompute the full hit record from frozen per-ray state (one pass)."""
    octant_idx = state.idx ^ c.octant_mask
    leaf_value = reader.leaf_value(state.node, octant_idx)
    t, value, face_id, pos, uv, lod = finalize_fields(
        c, state.scale, state.posx, state.posy, state.posz, state.t_min,
        state.hit, leaf_value)
    return TraversalResult(t=t, value=value, face_id=face_id, pos=pos, uv=uv,
                           lod=lod, inside_voxel=state.inside,
                           steps=state.steps)


def trace_state(reader, octree_scale, ro, rd, max_dst, alpha_fn,
                budget: int, t_floor: Optional[torch.Tensor] = None):
    """(ray constants, frozen state) of the plain traversal through
    ``reader``'s format: the (optionally floored) start and the loop. A
    hit lane's state is frozen at its leaf (t_min, idx, scale, pos), the
    state ``finalize`` reads and K9's records hold (``ops.adaptive``)."""
    c = make_ray_consts(octree_scale, ro, rd, max_dst)
    state = init_state(c, reader.root(ro.shape[0], ro.device), t_floor)
    return c, run_loop(reader, c, state, budget, alpha_fn)


def trace(reader, octree_scale, ro, rd, max_dst, alpha_fn, budget: int,
          t_floor: Optional[torch.Tensor] = None):
    """The plain traversal through ``reader``'s format: ray constants,
    the (optionally floored) start, the loop, the hit record."""
    return finalize(reader, *trace_state(reader, octree_scale, ro, rd,
                                         max_dst, alpha_fn, budget, t_floor))


def intersect_octree_plain(descriptors, octree_scale, ro, rd, max_dst,
                           cast_translucent: bool,
                           alpha_fn: Optional[Callable] = None,
                           max_steps: int = MAX_STEPS,
                           t_floor: Optional[torch.Tensor] = None
                           ) -> TraversalResult:
    """The plain PyTorch traversal (the JAX classic loop, lane-masked)."""
    reader = EsvoReader(descriptors.to(i64) & U32_MASK)
    return trace(reader, octree_scale, ro, rd, max_dst,
                 alpha_fn if cast_translucent else None,
                 step_budget(max_steps), t_floor)


# ---------------------------------------------------------------------------
# Kernel K1
# ---------------------------------------------------------------------------

launches = 0  # K1 launches by intersect_octree (the wrapper below)


def _check(name, t, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def intersect_octree(descriptors: torch.Tensor, octree_scale, ro, rd,
                     max_dst, cast_translucent: bool,
                     alpha_fn: Optional[Callable] = None,
                     max_steps: int = MAX_STEPS,
                     t_floor: Optional[torch.Tensor] = None
                     ) -> TraversalResult:
    """Trace a batch of rays through the serialized SVO.

    Args:
      descriptors: (N,) int32 SVO buffer holding u32 words (preamble block
        at word 0), N >= 12.
      octree_scale: 2^-depth — size of one leaf in [0,1] space.
      ro: (B,3) float32 ray origins in world (SVO block) space.
      rd: (B,3) float32 normalized ray directions.
      max_dst: (B,) or scalar; if >= 0 limits travel distance (world units).
      cast_translucent: if True, rays pass through zero-alpha texels.
      alpha_fn: (value, face_id, uv, lod) -> (B,) texel alpha; None =>
        opaque. On a CUDA tensor it must come from
        ``ops.shading.make_alpha_fn`` (the kernel inlines that sampler, K2).
      max_steps: step bound (reference MAX_STEPS = 1000), rounded up to a
        multiple of 4 as the JAX loop does.
      t_floor: None, or (B,) float32 per-ray entry floors in world units
        (``init_state``); None leaves every result as it was.

    On the CPU this is the plain version; on CUDA tensors it launches K1.
    The JAX opaque cast runs the push engine, which this package does not
    carry; both engines give the same hits for rays that finish within
    the step budget.
    """
    if not descriptors.is_cuda:
        return intersect_octree_plain(descriptors, octree_scale, ro, rd,
                                      max_dst, cast_translucent, alpha_fn,
                                      max_steps, t_floor)
    from .shading import AlphaFn

    global launches
    dev = descriptors.device
    B = ro.shape[0]
    _check("descriptors", descriptors, torch.int32, device=dev)
    if descriptors.dim() != 1 or descriptors.shape[0] < 12:
        raise ValueError("descriptors: expected a 1-d buffer of >= 12 words")
    _check("ro", ro, f32, (B, 3), dev)
    _check("rd", rd, f32, (B, 3), dev)
    md = torch.as_tensor(max_dst, dtype=f32, device=dev).expand(B).contiguous()
    if t_floor is not None:
        _check("t_floor", t_floor, f32, (B,), dev)
    judge = alpha_fn if cast_translucent else None
    if judge is not None and not isinstance(judge, AlphaFn):
        raise TypeError("K1 judges texel alpha with make_alpha_fn's sampler "
                        "only; pass alpha_fn=make_alpha_fn(mips, mat_tex)")
    tables = judge.tables if judge is not None else None
    if tables is not None and tables.atlas.device != dev:
        raise ValueError(f"alpha_fn tables on {tables.atlas.device}, "
                         f"expected {dev}")
    alpha_mode = 0 if judge is None else (2 if judge.exact else 1)

    t = torch.empty(B, dtype=f32, device=dev)
    value = torch.empty(B, dtype=torch.int32, device=dev)
    face = torch.empty(B, dtype=torch.int32, device=dev)
    pos = torch.empty((B, 3), dtype=f32, device=dev)
    uv = torch.empty((B, 2), dtype=f32, device=dev)
    lod = torch.empty(B, dtype=f32, device=dev)
    inside = torch.empty(B, dtype=torch.bool, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        _build.launch_k1(descriptors, float(octree_scale), ro, rd, md,
                         step_budget(max_steps), alpha_mode, tables,
                         t, value, face, pos, uv, lod, inside, steps,
                         t_floor)
        launches += 1
    return TraversalResult(t, value.to(i64) & U32_MASK, face, pos, uv, lod,
                           inside, steps)
