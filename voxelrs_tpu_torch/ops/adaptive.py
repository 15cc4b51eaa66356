"""The adaptive thick-ray opaque frame (K9): the plain PyTorch versions and
the wrappers of its four kernels, and the frame around them.

Counterpart: voxelrs_tpu/ops/shading.py — the adaptive block of
``_opaque_frame_body`` (:3773-3895) and its two-pass shadow (:4019-4034):
the selection rule (:3776-3800), ``_pix_rays_for`` :1133,
``_coarse_grid_for`` :1161, ``_bucket_size`` :1208 and ``_margin_bucket``
:458 (the dense-frame test :3912), ``_make_frozen_merge`` :1966,
``_finalize_lanes`` :1894 with ``refine_values`` :1918, ``merge_refined``
:2157, ``shadow_mask1`` :2170, ``_shadow_cell_merge`` :2172 and
``shadow_combine`` :2192. (The reference README.md:243-254 names the idea;
the JAX package made it exact through leaf identity.)

The frame traces a coarse grid of pixel samples — the quarter grid
(hierarchy 1, the default), the half grid (``VOXELRS_HIERARCHY=0``) or
the eighth grid (``VOXELRS_HIERARCHY=2``, from 4,096 quarter lanes) —
and merges each grid onto the next finer one: a sample lane takes its
coarse record, an interior lane whose four cell corners hit one flat
surface (same value, face axis, entry plane, leaf scale and ray octant)
intersects its own ray with that leaf analytically, and the rest re-trace
at their own pixel. On the pixel grid every record is finalized to the
deferred frame's hit record; shading and shadows follow as in the exact
deferred frame, except that a dense frame (JAX's first-frame hit bucket
covers a third of the pixels) traces the shadow rays of the half grid's
sample pixels first and lets an interior pixel whose four cell corners
agree reuse their verdict. The frame is not the exact frame: a fill can
differ from a trace in the last bits, and a reused verdict from the
pixel's own; the tests hold it to the JAX package's thick-ray budget.
A translucent world's adaptive frame (K9-judged, ``ops/adaptive_judged.
py``) takes its grids, its rule (``frame_levels``) and its tail of
shading and shadows (``shade_and_shadow``) from here.

Records. A grid lane's record is the frozen state of its opaque trace,
8 int32 words (``_build.K9_WORDS``): t_min in octree units, ``idx | scale
<< 8``, the leaf base (mirrored [1, 2) space), the leaf value, ``hit |
face axis << 1 | ray octant << 3`` and a pad word; a lane without a hit is
all zeros. The JAX record holds node pointers and refetches the value
(``_EsvoEngine.freeze``, the CSVO engine's ``mat_ptr``/``pre_leaf``
:1322-1420); the port's traversal hands the value out at its hit.

Each kernel wrapper (``k9_trace``, ``k9_merge``, ``k9_finalize``,
``k9_shadow_cells``) runs its plain version for CPU tensors and launches
its kernel (``csrc/k9_adaptive.cuh``) for CUDA tensors, counting the
launches. The plain versions take the same inputs (the kernels'
``FrameParams``) and write the same outputs in place, operation for
operation, so on the card kernel and plain version agree bit for bit.

A pose batch (K10, JAX ``render_frames_opaque_batch`` :3580) runs the same
kernels once for N poses: ``cams`` ((N, 12) float32 on the card, each
pose's cam_pos, right, up and fwd; ``ops.shading.batch_cameras``) and,
for the shadow cells, ``hstart`` (each pose's first hit lane, K6's
segment starts) select it. Lanes are pose-major, so every buffer of one
frame becomes N of them end to end; the tile floors stack to (N, nty,
ntx). The plain versions run a batch pose by pose on those slices with
the pose's ``FrameParams`` (``ops.shading.pose_params``), which is what
holds the kernels' pose arithmetic. ``render_frames_adaptive_batch``
drives the frame of one pose or of a batch.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from .. import _build
from . import compact, shading
from .beams import pixel_floors_at
from .bits import U32_MASK, bits_f32, f32_bits, fdiv, u32_to_i32
from .traversal import (EsvoReader, TraversalResult, _exp2_scale,
                        _hit_geometry, finalize_fields, make_ray_consts,
                        trace_state)
from .traversal_csvo import CsvoBuffer, CsvoReader, check_words

f32, i64, i32 = torch.float32, torch.int64, torch.int32

REC_WORDS = _build.K9_WORDS
# JAX: adaptive by default from 2^18 pixels with both sides > 4 (:3776-3782)
ADAPTIVE_MIN_PIXELS = 1 << 18
# JAX: the eighth grid runs only above this many quarter lanes (:3812)
EIGHTH_MIN_QUARTER = 4096
# JAX: the judged frame traces the quarter grid from this many lanes (:3316)
JUDGED_MIN_QUARTER = 4096

launches_trace = 0  # K9 launches by the wrappers below
launches_merge = 0
launches_finalize = 0
launches_shadow_cells = 0


# ---------------------------------------------------------------------------
# Selection, grids, rays
# ---------------------------------------------------------------------------

def grid_dims(width: int, height: int, levels: int) -> list:
    """[(w, h)] of grid levels 0..levels: level 0 the pixels, each next
    level ``w // 2 + 1`` by ``h // 2 + 1`` (``_coarse_grid_for``)."""
    dims = [(width, height)]
    for _ in range(levels):
        w, h = dims[-1]
        dims.append((w // 2 + 1 if w > 1 else 1, h // 2 + 1 if h > 1 else 1))
    return dims


def adaptive_on(width: int, height: int, adaptive: bool | None = None) -> bool:
    """Whether the JAX rule picks the adaptive frame (:3776-3782, :3104-3108):
    ``adaptive`` None takes ``VOXELRS_ADAPTIVE`` (an integer; unset:
    adaptive from 2^18 pixels with both sides over 4), True / False pin
    it."""
    if adaptive is None:
        env = os.environ.get("VOXELRS_ADAPTIVE")
        adaptive = (bool(int(env)) if env is not None else
                    (width * height >= ADAPTIVE_MIN_PIXELS and width > 4
                     and height > 4))
    return bool(adaptive)


def hierarchy() -> int:
    """``VOXELRS_HIERARCHY`` as the JAX frames read it (unset or not an
    integer: 1)."""
    env = os.environ.get("VOXELRS_HIERARCHY")
    try:
        return int(env) if env else 1
    except ValueError:
        return 1


def adaptive_levels(width: int, height: int,
                    adaptive: bool | None = None) -> int:
    """The grid levels the opaque frame traces above the pixels, 0 for the
    exact frame: the JAX rule (:3776-3800). ``adaptive_on`` decides;
    ``VOXELRS_HIERARCHY`` (``hierarchy``) picks the coarsest grid: 0 the
    half grid (1 level), 1 the quarter grid (2), 2 or more the eighth grid
    (3) where the quarter grid has at least 4,096 lanes, else the quarter
    grid."""
    if not adaptive_on(width, height, adaptive):
        return 0
    hier = hierarchy()
    if hier < 1:
        return 1
    wq, hq = grid_dims(width, height, 2)[2]
    return 3 if hier >= 2 and wq * hq >= EIGHTH_MIN_QUARTER else 2


def frame_levels(width: int, height: int, opaque: bool,
                 adaptive: bool | None = None) -> int:
    """The grid levels of the frame ``render_frame_deferred`` draws, 0 for
    the exact frame: ``adaptive_levels`` for an opaque world; for a
    translucent one the JAX judged rule (:3104-3108, :3311-3316): adaptive
    by ``adaptive_on``, then the quarter grid (2 levels) where
    ``hierarchy`` is at least 1 and the quarter grid has at least 4,096
    lanes, else the half grid (1); never the eighth grid."""
    if opaque:
        return adaptive_levels(width, height, adaptive)
    if not adaptive_on(width, height, adaptive):
        return 0
    wq, hq = grid_dims(width, height, 2)[2]
    return 2 if hierarchy() >= 1 and wq * hq >= JUDGED_MIN_QUARTER else 1


def grid_pixel_ids(width: int, height: int, level: int,
                   device=None) -> torch.Tensor:
    """(n,) int64 pixel ids (flat, row-major) of the lanes of grid level
    ``level``: lane (y, x) samples lane (min(2y, h - 1), min(2x, w - 1))
    of the level below, down to the pixels (JAX ``coarse_pidx`` composed
    per level, :1167/:2124-2150)."""
    dims = grid_dims(width, height, level)
    wl, hl = dims[level]
    ys = torch.arange(hl, dtype=i64, device=device)
    xs = torch.arange(wl, dtype=i64, device=device)
    for k in range(level, 0, -1):
        wk, hk = dims[k - 1]
        ys = torch.clamp(2 * ys, max=hk - 1)
        xs = torch.clamp(2 * xs, max=wk - 1)
    return (ys[:, None] * width + xs[None, :]).reshape(-1)


class CoarseGrid(NamedTuple):
    """JAX ``_coarse_grid_for(width, height)`` (:1161-1206) in torch: the
    half grid of a width x height grid and its helpers."""

    hc: int
    wc: int
    ids: torch.Tensor  # (hc * wc,) lane ids of the fine grid
    up4: object  # coarse (hc*wc[, C]) -> the 4 cell corners of every fine lane
    sample_masks: object  # -> (is_sample, ylast, xlast) over the fine lanes
    pick_sample: object  # (ylast, xlast, a00..a11) -> a fine lane's sample


def coarse_grid(width: int, height: int, device=None) -> CoarseGrid:
    hc = height // 2 + 1 if height > 1 else 1
    wc = width // 2 + 1 if width > 1 else 1
    cy = torch.clamp(2 * torch.arange(hc, dtype=i64, device=device),
                     max=height - 1)
    cx = torch.clamp(2 * torch.arange(wc, dtype=i64, device=device),
                     max=width - 1)
    ids = (cy[:, None] * width + cx[None, :]).reshape(-1)

    def up4(a):
        g = a.reshape(hc, wc) if a.dim() == 1 else a.reshape(hc, wc, -1)
        right = torch.cat([g[:, 1:], g[:, -1:]], dim=1)
        down = torch.cat([g[1:], g[-1:]], dim=0)
        downright = torch.cat([down[:, 1:], down[:, -1:]], dim=1)

        def up(x):
            x = torch.repeat_interleave(x, 2, dim=0)[:height]
            x = torch.repeat_interleave(x, 2, dim=1)[:, :width]
            return (x.reshape(-1) if a.dim() == 1
                    else x.reshape(width * height, -1))

        return up(g), up(right), up(down), up(downright)

    def sample_masks():
        lane = torch.arange(width * height, dtype=i64, device=device)
        y, x = lane // width, lane % width
        ylast, xlast = y == height - 1, x == width - 1
        is_sample = ((y % 2 == 0) | ylast) & ((x % 2 == 0) | xlast)
        return is_sample, ylast, xlast

    def pick_sample(ylast, xlast, a00, a01, a10, a11):
        if a00.dim() == 2:
            ylast, xlast = ylast[:, None], xlast[:, None]
        return torch.where(ylast & xlast, a11,
                           torch.where(ylast, a10,
                                       torch.where(xlast, a01, a00)))

    return CoarseGrid(hc, wc, ids, up4, sample_masks, pick_sample)


def pixel_rays(ids, width: int, height: int, cam_pos, cam_right, cam_up,
               cam_fwd, tan_half: float, aspect: float):
    """(ro, rd) of the pixels ``ids``: ``ops.shading.generate_rays``'s
    derivation, operation for operation, so a pixel's ray here is its ray
    there bit for bit (JAX ``_pix_rays_for`` :1133)."""
    px = (ids % width).to(f32)
    py = (ids // width).to(f32)
    u = fdiv(px, width) * 2.0 - 1.0
    v = fdiv(height - 1.0 - py, height) * 2.0 - 1.0
    u = u * aspect * tan_half
    v = v * tan_half
    rd = u[:, None] * cam_right + v[:, None] * cam_up + cam_fwd
    rd = rd / shading._norm3(rd)[:, None]
    return cam_pos.expand(rd.shape).contiguous(), rd


def _frame_rays(fp: _build.FrameParams, ids):
    dev = ids.device

    def vec(a):
        return torch.tensor([float(x) for x in a], dtype=f32, device=dev)

    return pixel_rays(ids, fp.width, fp.height, vec(fp.cam_pos), vec(fp.right),
                      vec(fp.up), vec(fp.fwd), float(fp.tan_half),
                      float(fp.aspect))


def bucket_size(count: int) -> int:
    """JAX ``_bucket_size`` (:1208): the smallest of the {2^k, 1.5 * 2^k}
    ladder covering ``count`` (at least 256)."""
    if count <= 256:
        return 256
    p = 1 << (count - 1).bit_length()
    return (p * 3) // 4 if count <= (p * 3) // 4 else p


def dense_frame(count: int, B: int) -> bool:
    """The JAX frame's dense test (:3912) on a hit bucket picked from this
    frame's own count with its first-frame rule (``_margin_bucket`` :458):
    ``max(bucket(c + c // 2 + 256), 8192) >= B // 3``. The JAX bucket is
    sticky across frames (``_PlanStore.sticky_scalar`` :955); the port
    decides from each frame's count, on the card."""
    return max(bucket_size(count + count // 2 + 256), 8192) >= B // 3


# ---------------------------------------------------------------------------
# Records and the plain versions of the kernels
# ---------------------------------------------------------------------------

def _f2w(x):
    return x.to(f32).contiguous().view(i32)


def _reader(world):
    if isinstance(world, CsvoBuffer):
        return CsvoReader(world.words.to(i64) & U32_MASK, world.root_ptr,
                          world.total_depth)
    return EsvoReader(world.to(i64) & U32_MASK)


def _records(reader, c, state) -> torch.Tensor:
    """(n, 8) int32 records of frozen traversal states (zero where no hit)."""
    octant_idx = state.idx ^ c.octant_mask
    value = reader.leaf_value(state.node, octant_idx)
    face = _hit_geometry(c, state.scale, state.posx, state.posy, state.posz,
                         state.t_min)[0]
    flags = state.hit.to(i64) | ((face >> 1) << 1) | (c.octant_mask << 3)
    rec = torch.stack([_f2w(state.t_min),
                       u32_to_i32(state.idx | (state.scale << 8)),
                       _f2w(state.posx), _f2w(state.posy), _f2w(state.posz),
                       u32_to_i32(value), u32_to_i32(flags),
                       torch.zeros_like(flags, dtype=i32)], 1)
    return torch.where(state.hit[:, None], rec, torch.zeros_like(rec))


def _unpack(rec):
    """(t, scale, posx, posy, posz, value, flags) of (n, 8) records."""
    fl = rec.view(f32)
    return (fl[:, 0], (rec[:, 1].to(i64) & U32_MASK) >> 8, fl[:, 2], fl[:, 3],
            fl[:, 4], rec[:, 5].to(i64) & U32_MASK, rec[:, 6].to(i64))


def _level_lanes(fp: _build.FrameParams, level: int) -> int:
    w, h = grid_dims(fp.width, fp.height, level)[level]
    return w * h


def k9_trace_plain(world, octree_scale, fp: _build.FrameParams, tf,
                   level: int, out, idx=None, count=None, cams=None):
    """``k9_trace``'s function: the opaque trace of the lanes of grid level
    ``level`` (all of them, or ``idx[:count]``) at their pixels' rays from
    their pixels' tile floors (``tf`` None: unfloored), each lane's record
    written into ``out[lane]``; with ``cams``, of the lanes of every pose
    (lane = pose * the level's lanes + lane of the pose)."""
    dev = out.device
    if cams is not None:
        n = _level_lanes(fp, level)
        lanes = (None if idx is None
                 else idx[: min(int(count), idx.shape[0])].to(i64))
        for p in range(cams.shape[0]):
            local = None
            if lanes is not None:
                local = lanes[(lanes >= p * n) & (lanes < (p + 1) * n)] - p * n
                if local.numel() == 0:
                    continue
            k9_trace_plain(world, octree_scale,
                           shading.pose_params(fp, cams, p),
                           None if tf is None else tf[p], level,
                           out[p * n:(p + 1) * n], local,
                           None if local is None else local.numel())
        return out
    if idx is None:
        lanes = torch.arange(out.shape[0], dtype=i64, device=dev)
    else:
        lanes = idx[: min(int(count), idx.shape[0])].to(i64)
    ids = grid_pixel_ids(fp.width, fp.height, level, dev)[lanes]
    ro, rd = _frame_rays(fp, ids)
    floors = None if tf is None else pixel_floors_at(tf, ids, fp.width)
    reader = _reader(world)
    c, state = trace_state(reader, float(octree_scale), ro, rd, -1.0, None,
                           fp.primary_budget, floors)
    out[lanes] = _records(reader, c, state)
    return out


def k9_merge_plain(octree_scale, fp: _build.FrameParams, level: int, lo, hi,
                   refine, cams=None):
    """``k9_merge``'s function (JAX ``_make_frozen_merge``'s ``merge``
    :1974-2117): the records ``lo`` of grid level + 1 onto the lanes of
    level ``level``, written into ``hi``, and the lanes to re-trace into
    ``refine``; with ``cams``, each pose's from its own records."""
    if cams is not None:
        nh, nl = _level_lanes(fp, level), _level_lanes(fp, level + 1)
        for p in range(cams.shape[0]):
            k9_merge_plain(octree_scale, shading.pose_params(fp, cams, p),
                           level, lo[p * nl:(p + 1) * nl],
                           hi[p * nh:(p + 1) * nh],
                           refine[p * nh:(p + 1) * nh])
        return hi, refine
    dev = lo.device
    wh, hh = grid_dims(fp.width, fp.height, level)[level]
    g = coarse_grid(wh, hh, dev)
    is_sample, ylast, xlast = g.sample_masks()
    t_c, scale_c, px_c, py_c, pz_c, value_c, flags_c = _unpack(lo)
    hit_c = (flags_c & 1) != 0
    axis_c = (flags_c >> 1) & 3
    om_c = (flags_c >> 3) & 7
    sexp2_c = _exp2_scale(scale_c)
    plane_c = torch.where(axis_c == 0, px_c + sexp2_c,
                          torch.where(axis_c == 1, py_c + sexp2_c,
                                      pz_c + sexp2_c))

    def same4(q):
        a00, a01, a10, a11 = g.up4(q)
        return a00, (a00 == a01) & (a00 == a10) & (a00 == a11)

    h00, h01, h10, h11 = g.up4(hit_c)
    hit4 = h00 & h01 & h10 & h11
    miss4 = ~(h00 | h01 | h10 | h11)
    value00, value_eq = same4(value_c)
    axis00, axis_eq = same4(axis_c)
    plane00, plane_eq = same4(plane_c)
    scale00, scale_eq = same4(scale_c)
    om00, om_eq = same4(om_c)

    # own-ray constants (the traversal's ray derivation)
    ro, rd = _frame_rays(fp, grid_pixel_ids(fp.width, fp.height, level, dev))
    c = make_ray_consts(float(octree_scale), ro, rd, -1.0)
    om_ok = om_eq & (c.octant_mask == om00)

    # the pixel's own ray meets the shared plane at t_int
    sexp2 = _exp2_scale(scale00)
    tc_ax = torch.where(axis00 == 0, c.tcx,
                        torch.where(axis00 == 1, c.tcy, c.tcz))
    tb_ax = torch.where(axis00 == 0, c.tbx,
                        torch.where(axis00 == 1, c.tby, c.tbz))
    t_int = plane00 * tc_ax - tb_ax

    # hit point in mirrored [1,2) space -> leaf base by mantissa
    # quantization (face axis comes from the plane itself)
    def mcoord(roa, rda, mirror):
        h = roa + t_int * rda
        return torch.where(mirror, 3.0 - h, h)

    sc = torch.clamp(scale00, 0, 31)

    def quant(m):
        return bits_f32((f32_bits(m) >> sc) << sc)

    base_ax = plane00 - sexp2
    posx = torch.where(axis00 == 0, base_ax, quant(mcoord(c.rox, c.rdx,
                                                          c.mirror_x)))
    posy = torch.where(axis00 == 1, base_ax, quant(mcoord(c.roy, c.rdy,
                                                          c.mirror_y)))
    posz = torch.where(axis00 == 2, base_ax, quant(mcoord(c.roz, c.rdz,
                                                          c.mirror_z)))

    # the plane must be the pixel's own entry face of the synthesized leaf
    t2x = (posx + sexp2) * c.tcx - c.tbx
    t2y = (posy + sexp2) * c.tcy - c.tby
    t2z = (posz + sexp2) * c.tcz - c.tbz
    tcmin = torch.maximum(torch.maximum(t2x, t2y), t2z)
    on_x = tcmin == t2x
    on_y = (~on_x) & (tcmin == t2y)
    axis_own = torch.where(on_x, 0, torch.where(on_y, 1, 2))
    t_cube_exit = torch.minimum(torch.minimum(c.tcx - c.tbx, c.tcy - c.tby),
                                c.tcz - c.tbz)
    smooth = (hit4 & value_eq & axis_eq & plane_eq & scale_eq & om_ok
              & (axis_own == axis00) & (t_int == tcmin)
              & (t_int > 0) & (t_int <= t_cube_exit))

    synth = torch.stack([
        _f2w(t_int), u32_to_i32(scale00 << 8), _f2w(posx), _f2w(posy),
        _f2w(posz), u32_to_i32(value00),
        u32_to_i32(1 | (axis00 << 1) | (om00 << 3)),
        torch.zeros_like(t_int, dtype=i32)], 1)
    picked = g.pick_sample(ylast, xlast, *g.up4(lo))
    hi.copy_(torch.where(is_sample[:, None], picked,
                         torch.where(smooth[:, None], synth,
                                     torch.zeros_like(synth))))
    refine.copy_(~is_sample & ~smooth & ~miss4)
    return hi, refine


def k9_finalize_plain(octree_scale, fp: _build.FrameParams, frec, rec, hit,
                      img, needp, blkp, cams=None):
    """``k9_finalize``'s function (JAX ``_finalize_lanes`` :1894 with the
    carried values): the pixel records ``frec`` as the deferred frame's
    (H*W, 9) hit records ``rec`` and ``hit``; a miss gets its sky in
    ``img``; ``needp``/``blkp`` cleared. With ``cams`` every pose's, its
    image ``img[pose]``."""
    if cams is not None:
        B = fp.width * fp.height
        for p in range(cams.shape[0]):
            sl = slice(p * B, (p + 1) * B)
            k9_finalize_plain(octree_scale, shading.pose_params(fp, cams, p),
                              frec[sl], rec[sl], hit[sl], img[p], needp[sl],
                              blkp[sl])
        return rec, hit
    dev = frec.device
    ro, rd = _frame_rays(fp, torch.arange(frec.shape[0], dtype=i64,
                                          device=dev))
    c = make_ray_consts(float(octree_scale), ro, rd, -1.0)
    t_min, scale, px, py, pz, value, flags = _unpack(frec)
    h = (flags & 1) != 0
    t, value, face, pos, uv, lod = finalize_fields(c, scale, px, py, pz,
                                                   t_min, h, value)
    rec.copy_(torch.cat([_f2w(t)[:, None], u32_to_i32(value)[:, None],
                         face[:, None], _f2w(pos), _f2w(uv),
                         _f2w(lod)[:, None]], 1))
    hit.copy_(h)
    flat = img.view(-1, 4)
    flat[~h] = shading.sky_color(rd[~h])
    needp.zero_()
    blkp.zero_()
    return rec, hit


def _is_sample_pixel(p, width: int, height: int):
    y, x = p // width, p % width
    return (((y % 2 == 0) | (y == height - 1))
            & ((x % 2 == 0) | (x == width - 1)))


def _composite(color, ds, shadow: float, ambient: float):
    light = torch.clamp(ambient + ds * shadow, 0.0, 1.0)
    return torch.cat([color[:, :3] * light[:, None], color[:, 3:4]], -1)


def k9_shadow_cells_plain(step: int, fp: _build.FrameParams, hidx, hcount,
                          need, needp, blkp, mask, dense, color, ds, img,
                          hstart=None):
    """``k9_shadow_cells``'s function over the compacted hit lanes
    (``hidx``, up to ``hcount``). Step 1 (JAX ``shadow_mask1`` :2170 and
    the dense test :3912): ``needp`` at the hit pixels, ``dense``, and the
    pass-1 candidates in ``mask``. Step 2 (``_shadow_cell_merge`` :2172
    and ``shadow_combine`` :2192): on a dense frame an interior pixel whose
    four cell corners agree on (need, verdict) and need a shadow reuses the
    verdict (a blocked one is composited into ``img``); the other
    candidates are the pass-2 ``mask``. ``hstart`` (a batch): pose q's
    hit lanes are ``hidx[hstart[q]:hstart[q + 1]]``, each pose decides its
    own ``dense[q]`` from its own count and reads its own pixels."""
    if hstart is not None:
        B = fp.width * fp.height
        n = min(int(hcount.reshape(-1)[0]), hidx.shape[0])
        ends = hstart.tolist() + [n]
        for q in range(hstart.shape[0]):
            a, b = ends[q], ends[q + 1]
            k9_shadow_cells_plain(
                step, fp, hidx[a:b] - q * B,
                torch.tensor([b - a], dtype=i32, device=hidx.device),
                need[a:b], needp[q * B:(q + 1) * B], blkp[q * B:(q + 1) * B],
                mask[a:b], dense[q:q + 1], color[a:b], ds[a:b], img[q])
        mask[n:] = False
        return mask
    W, H = fp.width, fp.height
    size = hidx.shape[0]
    n = min(int(hcount.reshape(-1)[0]), size)
    d = dense_frame(n, W * H)
    valid = torch.arange(size, device=hidx.device) < n
    p = torch.where(valid, hidx.to(i64), 0)
    nd = need.to(torch.bool) & valid
    sample = _is_sample_pixel(p, W, H)
    if step == 1:
        dense.fill_(int(d))
        needp[p[:n]] = need[:n].to(torch.bool)
        mask.copy_(nd & (sample | (not d)))
        return mask
    if not d:
        mask.zero_()
        return mask
    hc, wc = H // 2 + 1, W // 2 + 1
    cy, cx = (p // W) >> 1, (p % W) >> 1
    cy1 = torch.clamp(cy + 1, max=hc - 1)
    cx1 = torch.clamp(cx + 1, max=wc - 1)
    r0 = torch.clamp(2 * cy, max=H - 1) * W
    r1 = torch.clamp(2 * cy1, max=H - 1) * W
    c0 = torch.clamp(2 * cx, max=W - 1)
    c1 = torch.clamp(2 * cx1, max=W - 1)
    q = (r0 + c0, r0 + c1, r1 + c0, r1 + c1)
    n4 = [needp[qq] for qq in q]
    b4 = [blkp[qq] for qq in q]
    agree = ((n4[0] == n4[1]) & (n4[0] == n4[2]) & (n4[0] == n4[3])
             & (b4[0] == b4[1]) & (b4[0] == b4[2]) & (b4[0] == b4[3]))
    reuse = valid & ~sample & agree & n4[0]
    shadowed = reuse & nd & b4[0]
    flat = img.view(-1, 4)
    flat[p[shadowed]] = _composite(color[shadowed], ds[shadowed], 0.0,
                                   float(fp.ambient))
    mask.copy_(nd & ~sample & ~reuse)
    return mask


# ---------------------------------------------------------------------------
# Kernel wrappers (K9)
# ---------------------------------------------------------------------------

def _check_rec(name, t, n=None):
    """Refuse what K9's kernels cannot take as records: they move each
    32-byte record as two 16-byte words, which fault on the card at an
    address that is not a multiple of 16."""
    if t.dtype != i32 or t.dim() != 2 or t.shape[1] != REC_WORDS \
            or not t.is_contiguous() or (n is not None and t.shape[0] != n):
        raise ValueError(f"{name}: expected contiguous ({n}, {REC_WORDS}) "
                         "int32 records")
    _build.check_aligned(name, t)


def _check_lanes(name, t, n, dtype):
    """Refuse what K9's shadow cells cannot take as a lane array: they move
    a thread's hit indices as one 16-byte word and its need and mask bytes
    as 4-byte words from a 16-byte word at lane 0, which fault on the card
    or miss lanes at an address that is not a multiple of 16."""
    if t.dtype != dtype or t.dim() != 1 or t.shape[0] != n \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({n},) {dtype} "
                         "tensor")
    _build.check_aligned(name, t)


def _poses(cams, fp: _build.FrameParams, dev) -> int:
    """The poses of a launch: 1 for one frame (``cams`` None), else the
    rows of ``cams``, checked (``ops.shading.check_cams``)."""
    if cams is None:
        return 1
    shading.check_cams(cams, fp.width, fp.height, dev)
    return cams.shape[0]


def k9_trace(world, octree_scale, fp: _build.FrameParams, tf, level: int, out,
             idx=None, count=None, cams=None):
    """The trace of grid level ``level`` into its records ``out`` (n, 8)
    int32: every lane, or the refine list ``idx`` up to its device
    ``count`` (K6's output); with ``cams``, of the N poses' lanes (``out``
    N times the level's lanes, ``tf`` (N, nty, ntx)). Plain version on the
    CPU, K9's trace kernel on the card."""
    if not out.is_cuda:
        return k9_trace_plain(world, octree_scale, fp, tf, level, out, idx,
                              count, cams)
    global launches_trace
    if isinstance(world, CsvoBuffer):
        check_words(*world)
    n = _level_lanes(fp, level) * _poses(cams, fp, out.device)
    _check_rec("out", out, n)
    if shading.world_tensor(world).device != out.device or (
            tf is not None and (tf.device != out.device
                                or tf.dtype != f32 or not tf.is_contiguous()
                                or tf.dim() != (2 if cams is None else 3))):
        raise ValueError("k9_trace: world, floors and records on one device")
    if (idx is None) != (count is None):
        raise ValueError("k9_trace: idx and count come together")
    size = n if idx is None else idx.shape[0]
    if size:
        _build.launch_k9_trace(world, float(octree_scale), fp, tf, level, out,
                               idx, count, cams)
        launches_trace += 1
    return out


def k9_merge(octree_scale, fp: _build.FrameParams, level: int, lo, hi,
             refine, cams=None):
    """The merge of the records ``lo`` of level + 1 onto level ``level``
    (``hi`` (n, 8) int32, ``refine`` (n,) bool; with ``cams``, of the N
    poses). Plain version on the CPU, K9's merge kernel on the card."""
    if not lo.is_cuda:
        return k9_merge_plain(octree_scale, fp, level, lo, hi, refine, cams)
    global launches_merge
    N = _poses(cams, fp, lo.device)
    _check_rec("lo", lo, _level_lanes(fp, level + 1) * N)
    n = _level_lanes(fp, level) * N
    _check_rec("hi", hi, n)
    if refine.dtype != torch.bool or tuple(refine.shape) != (n,) \
            or not refine.is_contiguous():
        raise ValueError(f"refine: expected a contiguous ({n},) bool tensor")
    _build.launch_k9_merge(float(octree_scale), fp, level, lo, hi, refine,
                           cams)
    launches_merge += 1
    return hi, refine


def k9_finalize(octree_scale, fp: _build.FrameParams, frec, rec, hit, img,
                needp, blkp, cams=None):
    """The pixel records ``frec`` as the deferred frame's hit records,
    hit flags and sky; ``needp``/``blkp`` cleared; with ``cams``, of the N
    poses (``img`` (N, H, W, 4)). Plain version on the CPU, K9's finalize
    kernel on the card."""
    if not frec.is_cuda:
        return k9_finalize_plain(octree_scale, fp, frec, rec, hit, img, needp,
                                 blkp, cams)
    global launches_finalize
    B = fp.width * fp.height * _poses(cams, fp, frec.device)
    _check_rec("frec", frec, B)
    if tuple(rec.shape) != (B, _build.HIT_WORDS) or hit.shape[0] != B \
            or img.numel() != 4 * B or needp.shape[0] != B \
            or blkp.shape[0] != B:
        raise ValueError("k9_finalize: outputs of another frame size")
    for name, t, dt in (("rec", rec, i32), ("hit", hit, torch.bool),
                        ("img", img, f32), ("needp", needp, torch.bool),
                        ("blkp", blkp, torch.bool)):
        if t.dtype != dt or not t.is_contiguous() \
                or t.device != frec.device:
            raise ValueError(f"{name}: expected a contiguous {dt} tensor on "
                             f"{frec.device}")
        _build.check_aligned(name, t)
    _build.launch_k9_finalize(float(octree_scale), fp, frec, rec, hit, img,
                              needp, blkp, cams)
    launches_finalize += 1
    return rec, hit


def k9_shadow_cells(step: int, fp: _build.FrameParams, hidx, hcount, need,
                    needp, blkp, mask, dense, color, ds, img, hstart=None):
    """Step 1 or 2 of the shadow cells (``k9_shadow_cells_plain``; with
    ``hstart``, of a batch's poses). Plain version on the CPU, K9's
    shadow-cell kernel on the card."""
    if not hidx.is_cuda:
        return k9_shadow_cells_plain(step, fp, hidx, hcount, need, needp,
                                     blkp, mask, dense, color, ds, img,
                                     hstart)
    global launches_shadow_cells
    if step not in (1, 2):
        raise ValueError(f"k9_shadow_cells: step {step}")
    N = 1 if hstart is None else hstart.shape[0]
    if hstart is not None and (hstart.dtype != i32 or hstart.dim() != 1
                               or hstart.device != hidx.device
                               or dense.shape[0] < N):
        raise ValueError("hstart: expected (N,) int32 on the hits' device "
                         "and N dense flags")
    B = fp.width * fp.height * N
    for name, t in (("needp", needp), ("blkp", blkp)):
        if t.dtype != torch.bool or t.shape[0] != B:
            raise ValueError(f"{name}: expected ({B},) bool")
    _check_lanes("hidx", hidx, hidx.shape[0], i32)
    for name, t in (("need", need), ("mask", mask)):
        _check_lanes(name, t, B, torch.bool)
    _build.launch_k9_shadow_cells(step, fp, hidx, hcount, need, needp, blkp,
                                  mask, dense, color, ds, img, hstart)
    launches_shadow_cells += 1
    return mask


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------

class AdaptiveBuffers:
    """The adaptive frame's scratch for one frame size, depth of grids,
    record size (``words`` a lane: K9's 8, K9-judged's 16) and number of
    poses (a batch's, pose-major): the records of each level, a refine
    mask and list, the refine counts of each level, the pixel-space shadow
    need and verdicts, the shadow-pass mask, each pose's dense flag and
    first hit lane."""

    def __init__(self, width: int, height: int, levels: int, dev,
                 words: int = REC_WORDS, n_poses: int = 1):
        self.key = (width, height, levels, words, n_poses)
        dims = grid_dims(width, height, levels)
        N = n_poses
        B = width * height * N
        self.recs = [torch.empty((w * h * N, words), dtype=i32, device=dev)
                     for w, h in dims]
        self.refine = torch.empty(B, dtype=torch.bool, device=dev)
        self.ridx = torch.empty(B, dtype=i32, device=dev)
        self.rcounts = torch.zeros(levels, dtype=i32, device=dev)
        self.needp = torch.empty(B, dtype=torch.bool, device=dev)
        self.blkp = torch.empty(B, dtype=torch.bool, device=dev)
        self.mask = torch.empty(B, dtype=torch.bool, device=dev)
        self.dense = torch.zeros(N, dtype=i32, device=dev)
        self.hstart = torch.zeros(N, dtype=i32, device=dev)


def render_frames_adaptive_batch(world, octree_scale, tables, params, cams,
                                 *, levels: int, beams, light_dir, ws, img):
    """The adaptive frame on the card (``ops.shading.render_frame_deferred``
    dispatches here for an opaque world), of one pose (``cams`` None) or
    of each pose of a batch (``cams`` (N, 12), K10): K9's trace of the
    coarsest grid, then per finer level K9's merge, K6 over the refine mask
    and K9's trace of the refine list; K9's finalize; K6 over the hits and
    the shading stage; with shadows, two passes of K9's shadow cells, K6,
    the certificates (K8, K6) or floors (K7 / K8), the shadow stage and
    the finishing stage. A batch makes these launches once for all its
    poses. No count leaves the card. ``ws`` is the frame's
    ``DeferredWorkspace`` (N * H * W lanes), ``img`` the (H, W, 4) or (N,
    H, W, 4) output, ``beams.tile_floors`` (nty, ntx) or (N, nty, ntx)."""
    W, H = params.width, params.height
    ab = ws.adaptive(W, H, levels, n_poses=1 if cams is None
                     else cams.shape[0])
    scale = float(octree_scale)
    tf = None if beams is None else beams.tile_floors
    k9_trace(world, scale, params, tf, levels, ab.recs[levels], cams=cams)
    for k in range(levels - 1, -1, -1):
        n = ab.recs[k].shape[0]
        k9_merge(scale, params, k, ab.recs[k + 1], ab.recs[k], ab.refine[:n],
                 cams=cams)
        ridx, rcount = compact.compact_indices(
            ab.refine[:n], n, out=ab.ridx[:n], count=ab.rcounts[k:k + 1],
            scratch=ws.scratch)
        k9_trace(world, scale, params, tf, k, ab.recs[k], idx=ridx,
                 count=rcount, cams=cams)
    k9_finalize(scale, params, ab.recs[0], ws.rec, ws.hit, img, ab.needp,
                ab.blkp, cams=cams)
    return shade_and_shadow(world, scale, tables, params, 0, beams, light_dir,
                            ws, ab, img, cams=cams)


def shade_and_shadow(world, scale, tables, params, alpha_mode, beams,
                     light_dir, ws, ab, img, cams=None):
    """The adaptive frame's tail on the card, once its hit records are in
    ``ws.rec`` / ``ws.hit``: K6 over the hits and the shading stage; with
    shadows, two passes of K9's shadow cells, K6, the certificates (K8, K6)
    or floors (K7 / K8), the shadow stage (judged unless ``alpha_mode`` is
    0) and the finishing stage (JAX :3912-4037, :3384-3474). With ``cams``
    the lanes of a batch's poses, whose hit compaction also leaves each
    pose's first hit lane in ``ab.hstart``."""
    n = ws.hit.shape[0]
    hstart = None if cams is None else ab.hstart
    hidx, hcount = compact.compact_indices(ws.hit, n, out=ws.hidx,
                                           count=ws.hcount, scratch=ws.scratch,
                                           starts=hstart)
    _build.launch_kd_shade(tables, params, hidx, hcount, ws.rec, ws.color,
                           ws.ds, ws.need, ws.sro, img, cams=cams)
    shading.launches_shade += 1
    if params.render_shadows:
        for step in (1, 2):
            k9_shadow_cells(step, params, hidx, hcount, ws.need, ab.needp,
                            ab.blkp, ab.mask, ab.dense, ws.color, ws.ds, img,
                            hstart=hstart)
            shading.shadow_pass(world, scale, tables, params, alpha_mode,
                                beams, light_dir, ws, ab.mask, hidx, img,
                                certify=True,
                                blkp=ab.blkp if step == 1 else None)
    return img


def render_frame_adaptive_plain(world, octree_scale, mips, mat_params,
                                mat_tex, *, width: int, height: int,
                                render_shadows: bool, cam_pos, cam_right,
                                cam_up, cam_fwd, fov_y_rad, aspect, ambient,
                                light_dir, shadow_distance, highlight_pos,
                                levels: int, max_steps: int = 1000,
                                beams=None, mip_mode: str | None = None):
    """The plain PyTorch adaptive frame on any device: the same steps as
    ``render_frames_adaptive_batch``, through the plain versions of K9, K6, K7
    and K8 and the deferred frame's plain shading, over ``levels`` grids
    above the pixels (``adaptive_levels``)."""
    csvo = isinstance(world, CsvoBuffer)
    dev = shading.world_tensor(world).device
    mip_mode = mip_mode or shading.mip_mode_from_env()
    fp = shading.frame_params(
        width=width, height=height, render_shadows=render_shadows,
        cam_pos=cam_pos, cam_right=cam_right, cam_up=cam_up, cam_fwd=cam_fwd,
        fov_y_rad=fov_y_rad, aspect=aspect, ambient=ambient,
        light_dir=light_dir, shadow_distance=shadow_distance,
        highlight_pos=highlight_pos, max_steps=max_steps, mip_mode=mip_mode,
        csvo=csvo, deferred=True)
    B = width * height
    scale = float(octree_scale)
    tf = None if beams is None else beams.tile_floors
    recs = [torch.zeros((w * h, REC_WORDS), dtype=i32, device=dev)
            for w, h in grid_dims(width, height, levels)]
    k9_trace_plain(world, scale, fp, tf, levels, recs[levels])
    for k in range(levels - 1, -1, -1):
        refine = torch.empty(recs[k].shape[0], dtype=torch.bool, device=dev)
        k9_merge_plain(scale, fp, k, recs[k + 1], recs[k], refine)
        ridx, rcount = compact.compact_indices_plain(refine, refine.shape[0])
        k9_trace_plain(world, scale, fp, tf, k, recs[k], ridx, rcount)
    rec = torch.empty((B, _build.HIT_WORDS), dtype=i32, device=dev)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    img = torch.empty((height, width, 4), dtype=f32, device=dev)
    needp = torch.empty(B, dtype=torch.bool, device=dev)
    blkp = torch.empty(B, dtype=torch.bool, device=dev)
    k9_finalize_plain(scale, fp, recs[0], rec, hit, img, needp, blkp)
    return shade_and_shadow_plain(
        world, scale, mips, mat_params, mat_tex, fp, rec, hit, img, needp,
        blkp, cam_pos=cam_pos, light_dir=light_dir,
        highlight_pos=highlight_pos, max_steps=max_steps, beams=beams,
        mip_mode=mip_mode, alpha_fn=None)


def shade_and_shadow_plain(world, scale, mips, mat_params, mat_tex, fp, rec,
                           hit, img, needp, blkp, *, cam_pos, light_dir,
                           highlight_pos, max_steps: int, beams,
                           mip_mode: str, alpha_fn):
    """``shade_and_shadow``'s plain version on any device: the deferred
    frame's plain shading of the hit records ``rec`` / ``hit`` into
    ``img``, and with shadows the two passes of the shadow cells, the
    shadow rays opaque (``alpha_fn`` None) or judged by ``alpha_fn``,
    certified by the sun map where ``beams`` has one."""
    dev = rec.device
    B = fp.width * fp.height
    hidx, hcount = compact.compact_indices_plain(hit, B)
    n = int(hcount)
    lane = hidx[:n].to(i64)
    words = rec[lane]
    fl = words.view(f32)
    res = TraversalResult(t=fl[:, 0], value=words[:, 1].to(i64) & U32_MASK,
                          face_id=words[:, 2], pos=fl[:, 3:6], uv=fl[:, 6:8],
                          lod=fl[:, 8], inside_voxel=None, steps=None)
    cpos = shading._vec3(cam_pos, dev)
    ldir = shading._vec3(light_dir, dev)
    color, normal, diffuse, specular = shading.surface_shading(
        res, mips, mat_params, mat_tex, cpos, ldir,
        shading._vec3(highlight_pos, dev), mip_mode)
    ds = diffuse + specular
    amb = float(fp.ambient)
    flat = img.view(-1, 4)
    flat[lane] = _composite(color, ds, 1.0, amb)
    if not fp.render_shadows:
        return img
    need = torch.zeros(B, dtype=torch.bool, device=dev)
    need[:n] = (res.t < float(fp.shadow_distance)) & (ds > 0)
    color_b = torch.zeros((B, 4), dtype=f32, device=dev)
    ds_b = torch.zeros(B, dtype=f32, device=dev)
    color_b[:n], ds_b[:n] = color, ds
    sro = res.pos + normal * 0.001
    mask = torch.empty(B, dtype=torch.bool, device=dev)
    dense = torch.zeros(1, dtype=i32, device=dev)
    for step in (1, 2):
        k9_shadow_cells_plain(step, fp, hidx, hcount, need, needp, blkp, mask,
                              dense, color_b, ds_b, img)
        sidx, scount = compact.compact_indices_plain(mask, B)
        cand = sidx[: int(scount)].to(i64)
        blocked = shading.shadow_blocked_plain(
            world, scale, sro[cand], ldir, beams, alpha_fn is None, alpha_fn,
            max_steps, certify=True)
        pix = lane[cand]
        if step == 1:
            blkp[pix] = blocked
        flat[pix[blocked]] = _composite(color[cand][blocked],
                                        ds[cand][blocked], 0.0, amb)
    return img
