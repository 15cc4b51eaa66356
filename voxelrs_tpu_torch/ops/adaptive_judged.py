"""The adaptive thick-ray frame of a translucent world (K9-judged): the
plain PyTorch versions and the wrappers of its three kernels, the hole
table, and the frame around them.

Counterpart: voxelrs_tpu/ops/shading.py — ``_render_frame_judged_adaptive``
:3183 and ``_judged_frame_body`` :3259 (the dispatch
``render_frame_deferred`` :3104-3120), with the judged trace's surface
identity (``round_body`` :2282-2308), the result-level merge
``_make_res_merge`` :2807-3002, ``_merge_refined_res`` :3023 and
``_merge_refined_res_full`` :3033, and ``_hole_fill_on`` :430.

The frame is the opaque adaptive frame's (``ops/adaptive.py``) over the
alpha-judged traversal: it traces a coarse grid of pixel samples — the
quarter grid where ``VOXELRS_HIERARCHY`` is at least 1 (the default) and
the quarter grid has at least 4,096 lanes, else the half grid; never the
eighth — and merges each grid onto the next finer one at the level of
results. A sample lane takes its coarse record; an interior lane whose
four cell corners accepted one flat surface (same value, signed face,
leaf scale and entry plane) fills analytically when no corner's ray passed
a translucent texel on its way (the interior ray could meet an opaque
texel of that block, e.g. a glass frame), and the surface has no alpha-0
texel at the mip the pixel's lod rounds to (the hole table) or, with
``VOXELRS_HOLE_FILL=1``, the pixel's own texel there has alpha > 0; the
rest re-trace, judged, at their own pixel. Shading and the two-pass shadow
cells are the opaque adaptive frame's; the shadow rays are judged, and
certified by the sun map where one is attached (JAX :3424-3449: a blocked
claim reads the opaque solid bases, a lit claim the tops of any voxel).

The port judges texel alpha inside the traversal loop, as K3 and the exact
judged frame do; the JAX deferred trace judges between rounds and reports
a miss after ``rounds`` translucent texels, so the two frames agree where a
ray passes fewer translucent texels than that.

Records. A lane's record is 16 int32 words (``_build.K9J_WORDS``): the
deferred frame's 9-word hit record (t, value, face, pos, uv, lod; t = -1
for a miss), then ``inside``, the accepted leaf's ``scale``, its entry
``plane`` (float, un-mirrored [1, 2] space), ``passed`` and 3 pad words.

Each kernel wrapper (``k9j_trace``, ``k9j_merge``, ``k9j_finalize``) runs
its plain version for CPU tensors and launches its kernel
(``csrc/k9_judged.cuh``) for CUDA tensors, counting the launches. The plain
versions take the same inputs and write the same outputs in place,
operation for operation, so on the card kernel and plain version agree bit
for bit.
"""

from __future__ import annotations

import os

import torch

from .. import _build
from . import compact, shading
from .adaptive import (_f2w, _frame_rays, _reader, coarse_grid, grid_dims,
                       grid_pixel_ids, shade_and_shadow,
                       shade_and_shadow_plain)
from .beams import pixel_floors_at
from .bits import U32_MASK, bits_f32, f32_bits, u32_to_i32
from .traversal import (_exp2_scale, _hit_geometry, finalize,
                        finalize_fields, make_ray_consts, trace_state)
from .traversal_csvo import CsvoBuffer, check_words

f32, i64, i32 = torch.float32, torch.int64, torch.int32

REC_WORDS = _build.K9J_WORDS
ALPHA_MODE = 1  # the judge: make_alpha_fn's nearest texel (JAX :2275)

launches_trace = 0  # K9-judged launches by the wrappers below
launches_merge = 0
launches_finalize = 0


def hole_fill_on() -> bool:
    """``VOXELRS_HOLE_FILL=1`` lets a holed surface fill where the pixel's
    own texel has alpha > 0 (JAX ``_hole_fill_on`` :430; default off)."""
    return os.environ.get("VOXELRS_HOLE_FILL", "0") == "1"


def hole_table(mips, mat_tex) -> torch.Tensor:
    """(V, L) bool: block value v's colour layers (top, side, bottom) hold
    a texel of alpha <= 0 at mip level l (JAX ``block_hole_L`` :2867-2871).
    Set-up, made once with ``ops.shading.KernelTables``."""
    T = mips[0].shape[0]
    layer_hole = torch.stack([(m[..., 3] <= 0.0).flatten(1).any(1)
                              for m in mips], 1)  # (T, L)
    layers = torch.clamp(mat_tex[:, 0:3].to(i64), 0, T - 1)
    return layer_hole[layers].any(1).contiguous()


# ---------------------------------------------------------------------------
# Records and the plain versions of the kernels
# ---------------------------------------------------------------------------

def _records(res, plane, scale, passed) -> torch.Tensor:
    """(n, 16) int32 records of hit results and surface identities."""
    hit = res.t != -1.0
    zero = torch.zeros_like(res.face_id, dtype=i32)
    return torch.stack([
        _f2w(res.t), u32_to_i32(res.value), res.face_id.to(i32),
        _f2w(res.pos[:, 0]), _f2w(res.pos[:, 1]), _f2w(res.pos[:, 2]),
        _f2w(res.uv[:, 0]), _f2w(res.uv[:, 1]), _f2w(res.lod),
        res.inside_voxel.to(i32), torch.where(hit, scale, 0).to(i32),
        _f2w(torch.where(hit, plane, 0.0)), passed.to(i32), zero, zero,
        zero], 1)


def k9j_trace_plain(world, octree_scale, tables, fp: _build.FrameParams, tf,
                    level: int, out, idx=None, count=None):
    """``k9j_trace``'s function: the judged trace (``tables.alpha_fn``) of
    the lanes of grid level ``level`` (all of them, or ``idx[:count]``) at
    their pixels' rays from their pixels' tile floors (``tf`` None:
    unfloored), each lane's record written into ``out[lane]``. The entry
    plane is the frozen leaf base's on the face axis plus the leaf size,
    un-mirrored with the ray's octant (JAX ``round_body`` :2285-2295)."""
    dev = out.device
    if idx is None:
        lanes = torch.arange(out.shape[0], dtype=i64, device=dev)
    else:
        lanes = idx[: min(int(count), idx.shape[0])].to(i64)
    ids = grid_pixel_ids(fp.width, fp.height, level, dev)[lanes]
    ro, rd = _frame_rays(fp, ids)
    floors = None if tf is None else pixel_floors_at(tf, ids, fp.width)
    reader = _reader(world)
    c, state = trace_state(reader, float(octree_scale), ro, rd, -1.0,
                           tables.alpha_fn, fp.primary_budget, floors)
    res = finalize(reader, c, state)
    axis = (res.face_id >> 1).to(i64)
    pm = torch.where(axis == 0, state.posx,
                     torch.where(axis == 1, state.posy, state.posz)) \
        + _exp2_scale(state.scale)
    mirror = torch.where(axis == 0, c.mirror_x,
                         torch.where(axis == 1, c.mirror_y, c.mirror_z))
    plane = torch.where(mirror, 3.0 - pm, pm)
    out[lanes] = _records(res, plane, state.scale, state.passed)
    return out


def _unpack(rec):
    """(t, value, face, scale, plane, passed) of (n, 16) records."""
    fl = rec.view(f32)
    return (fl[:, 0], rec[:, 1].to(i64) & U32_MASK, rec[:, 2].to(i64),
            rec[:, 10].to(i64), fl[:, 11], rec[:, 12] != 0)


def k9j_merge_plain(octree_scale, tables, fp: _build.FrameParams, level: int,
                    lo, hi, refine, hole_fill: bool):
    """``k9j_merge``'s function (JAX ``_make_res_merge``'s ``merge``
    :2817-3000): the records ``lo`` of grid level + 1 onto the lanes of
    level ``level``, written into ``hi``, and the lanes to re-trace into
    ``refine``; the hole table and the alpha judge are ``tables``'."""
    dev = lo.device
    wh, hh = grid_dims(fp.width, fp.height, level)[level]
    g = coarse_grid(wh, hh, dev)
    is_sample, ylast, xlast = g.sample_masks()
    t_c, value_c, face_c, scale_c, plane_c, passed_c = _unpack(lo)

    def same4(q):
        a00, a01, a10, a11 = g.up4(q)
        return a00, (a00 == a01) & (a00 == a10) & (a00 == a11)

    h00, h01, h10, h11 = g.up4(t_c != -1.0)
    hit4 = h00 & h01 & h10 & h11
    miss4 = ~(h00 | h01 | h10 | h11)
    value00, value_eq = same4(value_c)
    face00, face_eq = same4(face_c)
    scale00, scale_eq = same4(scale_c)
    plane00, plane_eq = same4(plane_c)
    p00, p01, p10, p11 = g.up4(passed_c)
    no_pass = ~(p00 | p01 | p10 | p11)

    # the pixel's own ray
    ro, rd = _frame_rays(fp, grid_pixel_ids(fp.width, fp.height, level, dev))
    c = make_ray_consts(float(octree_scale), ro, rd, -1.0)
    axis00 = face00 >> 1
    sexp2 = _exp2_scale(scale00)
    sx, sy, sz = (f32_bits(r) >> 31 for r in (c.rdx, c.rdy, c.rdz))
    own_sign = torch.where(axis00 == 0, sx, torch.where(axis00 == 1, sy, sz))
    sign_ok = own_sign == (face00 & 1)
    mirror_ax = torch.where(axis00 == 0, c.mirror_x,
                            torch.where(axis00 == 1, c.mirror_y, c.mirror_z))
    # the shared plane, in the pixel's mirrored space, meets its ray at t_int
    plane_m = torch.where(mirror_ax, 3.0 - plane00, plane00)
    tc_ax = torch.where(axis00 == 0, c.tcx,
                        torch.where(axis00 == 1, c.tcy, c.tcz))
    tb_ax = torch.where(axis00 == 0, c.tbx,
                        torch.where(axis00 == 1, c.tby, c.tbz))
    t_int = plane_m * tc_ax - tb_ax

    def mcoord(roa, rda, mirror):
        h = roa + t_int * rda
        return torch.where(mirror, 3.0 - h, h)

    sc = torch.clamp(scale00, 0, 31)

    def quant(m):
        return bits_f32((f32_bits(m) >> sc) << sc)

    base_ax = plane_m - sexp2
    posx = torch.where(axis00 == 0, base_ax,
                       quant(mcoord(c.rox, c.rdx, c.mirror_x)))
    posy = torch.where(axis00 == 1, base_ax,
                       quant(mcoord(c.roy, c.rdy, c.mirror_y)))
    posz = torch.where(axis00 == 2, base_ax,
                       quant(mcoord(c.roz, c.rdz, c.mirror_z)))
    # the plane must be the pixel's own entry face of that leaf
    t2x = (posx + sexp2) * c.tcx - c.tbx
    t2y = (posy + sexp2) * c.tcy - c.tby
    t2z = (posz + sexp2) * c.tcz - c.tbz
    tcmin = torch.maximum(torch.maximum(t2x, t2y), t2z)
    on_x = tcmin == t2x
    on_y = (~on_x) & (tcmin == t2y)
    face_own = torch.where(on_x, sx, torch.where(on_y, 2 | sy, 4 | sz))
    t_cube_exit = torch.minimum(torch.minimum(c.tcx - c.tbx, c.tcy - c.tby),
                                c.tcz - c.tbz)
    fillable = (hit4 & value_eq & face_eq & scale_eq & plane_eq & sign_ok
                & no_pass & (face_own == face00) & (t_int == tcmin)
                & (t_int > 0) & (t_int <= t_cube_exit))

    # the hole table at the mip the pixel's lod rounds to (half to even)
    _face, ux, uy, _dst, tex_lod, _up = _hit_geometry(c, scale00, posx, posy,
                                                      posz, t_int)
    hole = tables.hole
    V, L = hole.shape
    dl = torch.round(torch.clamp(tex_lod, 0.0, float(L - 1))).to(i64)
    vid = u32_to_i32(value00).to(i64)
    value_opaque = (vid < V) & ~hole[torch.clamp(vid, 0, V - 1), dl]
    if hole_fill:
        alpha = tables.alpha_fn(value00, face00, torch.stack([ux, uy], -1),
                                tex_lod)
        smooth = fillable & (value_opaque | (alpha > 0.0))
    else:
        smooth = fillable & value_opaque

    t, value, face, pos, uv, lod = finalize_fields(
        c, scale00, posx, posy, posz, t_int, smooth, value00)
    zero = torch.zeros_like(t_int, dtype=i32)
    synth = torch.stack([
        _f2w(t), u32_to_i32(value), face.to(i32), _f2w(pos[:, 0]),
        _f2w(pos[:, 1]), _f2w(pos[:, 2]), _f2w(uv[:, 0]), _f2w(uv[:, 1]),
        _f2w(lod), zero, torch.where(smooth, scale00, 0).to(i32),
        _f2w(torch.where(smooth, plane00, 0.0)), zero, zero, zero, zero], 1)
    picked = g.pick_sample(ylast, xlast, *g.up4(lo))
    hi.copy_(torch.where(is_sample[:, None], picked, synth))
    refine.copy_(~is_sample & ~smooth & ~miss4)
    return hi, refine


def k9j_finalize_plain(fp: _build.FrameParams, frec, rec, hit, img, needp,
                       blkp):
    """``k9j_finalize``'s function: the pixel records ``frec`` as the
    deferred frame's (H*W, 9) hit records ``rec`` and ``hit``; a miss gets
    its sky in ``img``; ``needp``/``blkp`` cleared."""
    h = frec.view(f32)[:, 0] != -1.0
    rec.copy_(frec[:, : _build.HIT_WORDS])
    hit.copy_(h)
    miss = torch.nonzero(~h)[:, 0]
    _ro, rd = _frame_rays(fp, miss)
    img.view(-1, 4)[miss] = shading.sky_color(rd)
    needp.zero_()
    blkp.zero_()
    return rec, hit


# ---------------------------------------------------------------------------
# Kernel wrappers (K9-judged)
# ---------------------------------------------------------------------------

def _check_rec(name, t, n=None):
    if t.dtype != i32 or t.dim() != 2 or t.shape[1] != REC_WORDS \
            or not t.is_contiguous() or (n is not None and t.shape[0] != n):
        raise ValueError(f"{name}: expected contiguous ({n}, {REC_WORDS}) "
                         "int32 records")


def _check_tables(tables, dev):
    if tables.atlas.device != dev or tables.mat_tex.device != dev:
        raise ValueError(f"tables: expected texture tables on {dev}")


def k9j_trace(world, octree_scale, tables, fp: _build.FrameParams, tf,
              level: int, out, idx=None, count=None):
    """The judged trace of grid level ``level`` into its records ``out``
    (n, 16) int32: every lane, or the refine list ``idx`` up to its device
    ``count`` (K6's output). Plain version on the CPU, K9-judged's trace
    kernel on the card."""
    if not out.is_cuda:
        return k9j_trace_plain(world, octree_scale, tables, fp, tf, level,
                               out, idx, count)
    global launches_trace
    if isinstance(world, CsvoBuffer):
        check_words(*world)
    w, h = grid_dims(fp.width, fp.height, level)[level]
    _check_rec("out", out, w * h)
    _check_tables(tables, out.device)
    if shading.world_tensor(world).device != out.device or (
            tf is not None and (tf.device != out.device
                                or tf.dtype != f32 or not tf.is_contiguous())):
        raise ValueError("k9j_trace: world, floors and records on one device")
    if (idx is None) != (count is None):
        raise ValueError("k9j_trace: idx and count come together")
    size = w * h if idx is None else idx.shape[0]
    if size:
        _build.launch_k9j_trace(world, float(octree_scale), tables, fp, tf,
                                level, out, idx, count)
        launches_trace += 1
    return out


def k9j_merge(octree_scale, tables, fp: _build.FrameParams, level: int, lo,
              hi, refine, hole_fill: bool):
    """The merge of the records ``lo`` of level + 1 onto level ``level``
    (``hi`` (n, 16) int32, ``refine`` (n,) bool). Plain version on the
    CPU, K9-judged's merge kernel on the card."""
    if not lo.is_cuda:
        return k9j_merge_plain(octree_scale, tables, fp, level, lo, hi,
                               refine, hole_fill)
    global launches_merge
    dims = grid_dims(fp.width, fp.height, level + 1)
    _check_rec("lo", lo, dims[level + 1][0] * dims[level + 1][1])
    n = dims[level][0] * dims[level][1]
    _check_rec("hi", hi, n)
    _check_tables(tables, lo.device)
    if refine.dtype != torch.bool or tuple(refine.shape) != (n,) \
            or not refine.is_contiguous():
        raise ValueError(f"refine: expected a contiguous ({n},) bool tensor")
    hole = tables.hole
    if hole.dtype != torch.bool or tuple(hole.shape) != (
            tables.mat_tex.shape[0], len(tables.mips)):
        raise ValueError("tables.hole: expected a (mat_rows, levels) bool "
                         "table")
    _build.launch_k9j_merge(float(octree_scale), tables, fp, level,
                            hole_fill, lo, hi, refine)
    launches_merge += 1
    return hi, refine


def k9j_finalize(fp: _build.FrameParams, frec, rec, hit, img, needp, blkp):
    """The pixel records ``frec`` as the deferred frame's hit records, hit
    flags and sky; ``needp``/``blkp`` cleared. Plain version on the CPU,
    K9-judged's finalize kernel on the card."""
    if not frec.is_cuda:
        return k9j_finalize_plain(fp, frec, rec, hit, img, needp, blkp)
    global launches_finalize
    B = fp.width * fp.height
    _check_rec("frec", frec, B)
    if tuple(rec.shape) != (B, _build.HIT_WORDS) or hit.shape[0] != B \
            or img.numel() != 4 * B or needp.shape[0] != B \
            or blkp.shape[0] != B:
        raise ValueError("k9j_finalize: outputs of another frame size")
    # the kernel moves records, HitRecs, flags and a miss's pixel as
    # 16-byte words
    for name, t, dt in (("frec", frec, i32), ("rec", rec, i32),
                        ("hit", hit, torch.bool), ("img", img, f32),
                        ("needp", needp, torch.bool),
                        ("blkp", blkp, torch.bool)):
        if t.dtype != dt or not t.is_contiguous() \
                or t.device != frec.device:
            raise ValueError(f"{name}: expected a contiguous {dt} tensor on "
                             f"{frec.device}")
        _build.check_aligned(name, t)
    _build.launch_k9j_finalize(fp, frec, rec, hit, img, needp, blkp)
    launches_finalize += 1
    return rec, hit


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------

def render_frame_adaptive_judged(world, octree_scale, tables, params, *,
                                 levels: int, beams, light_dir, ws, img):
    """The judged adaptive frame on the card (``ops.shading.
    render_frame_deferred`` dispatches here for a translucent world):
    K9-judged's trace of the coarsest grid, then per finer level its
    merge, K6 over the refine mask and its trace of the refine list; its
    finalize; then the opaque adaptive frame's tail (``ops.adaptive.
    shade_and_shadow``) with judged shadow rays. No count leaves the card.
    ``ws`` is the frame's ``DeferredWorkspace``, ``img`` the (H, W, 4)
    output."""
    ab = ws.adaptive(params.width, params.height, levels, REC_WORDS)
    scale = float(octree_scale)
    fill = hole_fill_on()
    tf = None if beams is None else beams.tile_floors
    k9j_trace(world, scale, tables, params, tf, levels, ab.recs[levels])
    for k in range(levels - 1, -1, -1):
        n = ab.recs[k].shape[0]
        k9j_merge(scale, tables, params, k, ab.recs[k + 1], ab.recs[k],
                  ab.refine[:n], fill)
        ridx, rcount = compact.compact_indices(
            ab.refine[:n], n, out=ab.ridx[:n], count=ab.rcounts[k:k + 1],
            scratch=ws.scratch)
        k9j_trace(world, scale, tables, params, tf, k, ab.recs[k], idx=ridx,
                  count=rcount)
    k9j_finalize(params, ab.recs[0], ws.rec, ws.hit, img, ab.needp, ab.blkp)
    return shade_and_shadow(world, scale, tables, params, ALPHA_MODE, beams,
                            light_dir, ws, ab, img)


def render_frame_adaptive_judged_plain(world, octree_scale, mips, mat_params,
                                       mat_tex, *, width: int, height: int,
                                       render_shadows: bool, cam_pos,
                                       cam_right, cam_up, cam_fwd, fov_y_rad,
                                       aspect, ambient, light_dir,
                                       shadow_distance, highlight_pos,
                                       levels: int, max_steps: int = 1000,
                                       beams=None, mip_mode: str | None = None,
                                       hole_fill: bool | None = None):
    """The plain PyTorch judged adaptive frame on any device: the same steps
    as ``render_frame_adaptive_judged``, through the plain versions of
    K9-judged, K9's shadow cells, K6, K7 and K8 and the deferred frame's
    plain shading, over ``levels`` grids above the pixels
    (``ops.adaptive.frame_levels``); ``hole_fill`` None reads
    ``VOXELRS_HOLE_FILL``."""
    dev = shading.world_tensor(world).device
    mip_mode = mip_mode or shading.mip_mode_from_env()
    fill = hole_fill_on() if hole_fill is None else hole_fill
    fp = shading.frame_params(
        width=width, height=height, render_shadows=render_shadows,
        cam_pos=cam_pos, cam_right=cam_right, cam_up=cam_up, cam_fwd=cam_fwd,
        fov_y_rad=fov_y_rad, aspect=aspect, ambient=ambient,
        light_dir=light_dir, shadow_distance=shadow_distance,
        highlight_pos=highlight_pos, max_steps=max_steps, mip_mode=mip_mode,
        csvo=isinstance(world, CsvoBuffer), deferred=True)
    tables = shading.KernelTables(mips, mat_tex, mat_params)
    B = width * height
    scale = float(octree_scale)
    tf = None if beams is None else beams.tile_floors
    recs = [torch.zeros((w * h, REC_WORDS), dtype=i32, device=dev)
            for w, h in grid_dims(width, height, levels)]
    k9j_trace_plain(world, scale, tables, fp, tf, levels, recs[levels])
    for k in range(levels - 1, -1, -1):
        refine = torch.empty(recs[k].shape[0], dtype=torch.bool, device=dev)
        k9j_merge_plain(scale, tables, fp, k, recs[k + 1], recs[k], refine,
                        fill)
        ridx, rcount = compact.compact_indices_plain(refine, refine.shape[0])
        k9j_trace_plain(world, scale, tables, fp, tf, k, recs[k], ridx,
                        rcount)
    rec = torch.empty((B, _build.HIT_WORDS), dtype=i32, device=dev)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    img = torch.empty((height, width, 4), dtype=f32, device=dev)
    needp = torch.empty(B, dtype=torch.bool, device=dev)
    blkp = torch.empty(B, dtype=torch.bool, device=dev)
    k9j_finalize_plain(fp, recs[0], rec, hit, img, needp, blkp)
    return shade_and_shadow_plain(
        world, scale, mips, mat_params, mat_tex, fp, rec, hit, img, needp,
        blkp, cam_pos=cam_pos, light_dir=light_dir,
        highlight_pos=highlight_pos, max_steps=max_steps, beams=beams,
        mip_mode=mip_mode, alpha_fn=tables.alpha_fn)
