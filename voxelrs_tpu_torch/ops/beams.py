"""Beam pre-pass: conservative ray-entry floors from the terrain envelope
(kernel K7) and per-voxel sun certificates (kernel K8).

Counterpart: voxelrs_tpu/ops/beams.py — ``_envelope_march`` :52,
``tile_floors`` :137, ``pixel_floors`` :289, ``shadow_ray_floors`` :309,
``sun_verdict_masks`` :379, ``sun_lit_floors`` :473 and ``BeamContext``
:482-555. No reference counterpart: the reference traces every ray from
the root.

One beam per 8x8 pixel tile marches the 2D column-top envelope
(``world/heightfield.py``; a max-pyramid DDA) and returns, per tile, a
distance no ray of the tile can hit geometry before, or +inf when the whole
tile provably misses. The primary trace starts every pixel there
(``ops.traversal.init_state``'s floored start, bit for bit the unfloored
result). A shadow ray is a line, so it marches the exact pyramid; where the
sun map is attached, one row of it certifies a shadow ray lit or blocked
without a trace. Soundness (the JAX module's docstring has the argument)
rests on the same arithmetic here.

Each function has a plain PyTorch version, which the CPU takes and which
the card's results are held to, and a wrapper that launches its kernel on
a CUDA tensor: ``tile_floors`` and ``shadow_ray_floors`` launch K7
(``csrc/k7_beams.cuh``: a group of lanes per tile, up to 96 march
iterations, the descents evaluated at once; one thread per ray, up to 48),
``sun_verdict_masks`` and ``sun_lit_floors`` K8 (``csrc/k8_sun.cuh``: a
grid the card holds at once looping up to the count, one row read as
words, the 25 near-window tests on shared planes and the K band tests).
Per-frame scalars (camera, window, sun) cross by value; the envelope
pyramid, the bounds and the sun table stay device tensors. The small-table
lookups the TPU version turns into one-hot reductions (``ops/smalltab.py``)
are indexed loads.

Exactness: the plain versions spell out every float operation in the
kernels' order (no reductions, IEEE divisions through tensors), so kernel
and plain version agree bit for bit; against the JAX functions, which XLA
contracts into multiply-adds on the CPU, floors agree to a stated
tolerance and their +inf / 0 pattern exactly.

Shadow-ray functions take an optional gather ``idx`` (output lane i reads
ray ``idx[i]``) and an optional device ``count``: lanes at or past it are
pads (floor 0, verdicts False), so a frame feeds them a compaction's output
without a host round trip.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from .bits import fdiv

f32, i64 = torch.float32, torch.int64

CELL = 8.0  # envelope column footprint in voxels (world/heightfield.py)
TILE = 8  # pixels per tile side
_EPS_DIR = float(np.float32(2.0**-23))
_Y_SLACK = float(np.float32(0.75))  # absorbs DDA step nudges + fp rounding
_T_SLACK = float(np.float32(0.01))
_SHADOW_M0 = float(np.float32(0.05))
TILE_ITERS = 96
SHADOW_ITERS = 48
NEAR = 5  # the near window is NEAR x NEAR envelope columns
# the lit claim's footprint margin in float32 units of the octree's [1, 2)
# coordinates: sun_margin(scale) = SUN_MARGIN_ULPS * 2^-23 / scale voxels
SUN_MARGIN_ULPS = 64


def sun_margin(octree_scale) -> float:
    """The lit claim's footprint margin, in voxels, for a world of
    ``octree_scale`` (2^-depth): a few dozen float32 ulps of the
    traversal's coordinates, where its plane crossings round."""
    return _f(SUN_MARGIN_ULPS * 2.0**-23 / float(octree_scale))

# march iterations (summed over lanes) of the last plain march: the work
# a kernel's bound counts; the longest lane's iterations and, of them, its
# descents (a kernel's chain: the march's dependent iterations)
last_march_steps = 0
last_march_max = 0
last_march_descents = 0

# kernel launches by the wrappers below
launches_tile = 0  # K7 tile_floors
launches_shadow = 0  # K7 shadow_ray_floors
launches_sun = 0  # K8 sun_verdict_masks
launches_sun_floors = 0  # K8 sun_lit_floors


def _f(x) -> float:
    """A host float32 value as a Python float."""
    return float(np.float32(x))


def _norm3(a, b, c):
    return torch.sqrt(a * a + b * b + c * c)


def _eps_dir(d):
    """|d| < 2^-23 → ±2^-23 (the sign of ``d < 0``)."""
    return torch.where(d.abs() < _EPS_DIR,
                       torch.where(d < 0, -_EPS_DIR, _EPS_DIR), d)


def _box(txa, txb, tya, tyb, tza, tzb):
    """(entry, exit) of three slabs."""
    t_in = torch.maximum(torch.maximum(torch.minimum(txa, txb),
                                       torch.minimum(tya, tyb)),
                         torch.minimum(tza, tzb))
    t_out = torch.minimum(torch.minimum(torch.maximum(txa, txb),
                                        torch.maximum(tya, tyb)),
                          torch.maximum(tza, tzb))
    return t_in, t_out


def _envelope_march(levels, offsets, n, hmax, rox, roy, roz, dx, dy, dz,
                    inv_x, inv_z, sin_t, m0, t_start, t_hard, max_iters):
    """The max-pyramid 2D march over an envelope pyramid (JAX :52): tests
    the margin-lowered ray height y_lo(t) = roy + t*(dy - sin_t) - m0
    against per-cell maxima, descending near threats. Every argument but
    the pyramid is a (B,) float32 tensor (or broadcasts to one). Returns
    the per-lane stop distance: +inf when the march proves no threat up to
    t_hard; the march's t when its iterations ran out (still a floor)."""
    dev = dx.device
    B = dx.shape[0]
    offs = torch.tensor(list(offsets), dtype=i64, device=dev)
    max_lvl = len(offsets) - 1
    hmax = _f(hmax)
    slope = dy - sin_t
    t = t_start.expand(B).clone()
    lvl = torch.full((B,), max_lvl, dtype=i64, device=dev)
    stop_t = torch.full((B,), math.inf, dtype=f32, device=dev)
    done = (t >= t_hard) | ((slope > 0) & (roy + t * slope - m0 > hmax))
    its = torch.zeros((B,), dtype=i64, device=dev)
    descents = torch.zeros((B,), dtype=i64, device=dev)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        live = ~done
        its += live
        s = (8 << lvl).to(f32)  # cell size in voxels, CELL * 2^lvl
        px = rox + t * dx
        pz = roz + t * dz
        cx = torch.floor(px / s)
        cz = torch.floor(pz / s)
        nl = n >> lvl
        top = (nl - 1).to(f32)
        cxi = torch.minimum(torch.clamp(cx, min=0.0), top).to(i64)
        czi = torch.minimum(torch.clamp(cz, min=0.0), top).to(i64)
        hv = levels[offs[lvl] + cxi * nl + czi].to(f32)
        # exit of the (virtual, unclamped) cell in xz
        bx = (cx + (dx > 0).to(f32)) * s
        bz = (cz + (dz > 0).to(f32)) * s
        t_exit = torch.minimum((bx - rox) * inv_x, (bz - roz) * inv_z)
        t_exit = torch.minimum(torch.maximum(t_exit, t), t_hard)
        # y_lo is linear in t: its span minimum sits at the end slope picks
        y_lo = roy + torch.where(slope >= 0, t, t_exit) * slope - m0
        hit = y_lo <= hv
        stop = live & hit & (lvl == 0)
        descend = live & hit & (lvl > 0)
        advance = live & ~hit
        descents += descend
        t_y = (roy - m0 - hv) / torch.clamp(-slope, min=_EPS_DIR)
        stop_val = torch.where(slope >= 0, t, torch.maximum(t, t_y))
        stop_t = torch.where(stop, stop_val, stop_t)
        t_next = t_exit * _f(1.0 + 2.0**-21) + _f(2.0**-16)
        t = torch.where(advance, t_next, t)
        lvl = torch.where(descend, lvl - 1,
                          torch.where(advance,
                                      torch.clamp(lvl + 1, max=max_lvl), lvl))
        rising = (slope > 0) & (roy + t * slope - m0 > hmax)
        done = done | stop | (advance & ((t >= t_hard) | rising))
    global last_march_steps, last_march_max, last_march_descents
    last_march_steps = int(its.sum())
    longest = int(its.argmax()) if B else 0
    last_march_max = int(its[longest]) if B else 0
    last_march_descents = int(descents[longest]) if B else 0
    stopped = torch.isfinite(stop_t)
    exhausted = ~done & ~stopped  # ran out of iterations mid-march
    return torch.where(stopped, stop_t,
                       torch.where(exhausted, t, math.inf))


def _dir_for(px, py, width, height, right, up, fwd, tan_half, aspect):
    """Pixel-grid directions exactly as ``ops.shading.generate_rays`` maps
    integer pixel coordinates (``px`` fractional for tile centres)."""
    u = (fdiv(px, width) * 2.0 - 1.0) * aspect * tan_half
    v = (fdiv(height - 1.0 - py, height) * 2.0 - 1.0) * tan_half
    d = [u * right[k] + v * up[k] + fwd[k] for k in range(3)]
    n = _norm3(*d)
    return [x / n for x in d]


def _finish_floors(beam):
    return torch.where(torch.isfinite(beam),
                       torch.clamp(beam * _f(1.0 - 2.0**-18) - _T_SLACK,
                                   min=0.0), beam)


def _vec(x):
    return [_f(v) for v in np.asarray(x, np.float32).reshape(-1)]


def tile_floors_plain(levels, offsets, n, hmax, bounds, near_h, near_base,
                      cam_pos, cam_right, cam_up, cam_fwd, tan_half, aspect,
                      max_dst, *, width: int, height: int,
                      max_iters: int = TILE_ITERS):
    """Per-tile conservative entry floors, (nty, ntx) float32; +inf = the
    whole tile certainly misses all geometry (JAX :137). ``levels`` is the
    dilated pyramid (int32 tensor), ``bounds`` the (4,) float32 tensor of
    ``HeightField.device``; ``near_h`` (5,5) and ``near_base`` (2,) host
    arrays; the camera basis host 3-vectors; ``tan_half`` is
    ``ops.shading.tan_half_fov`` of the frame's fov; ``max_iters`` the
    march's budget of iterations a tile (JAX's ``max_iters``)."""
    dev = levels.device
    tile = TILE
    ntx = -(-width // tile)
    nty = -(-height // tile)
    ty, tx = torch.meshgrid(torch.arange(nty, dtype=f32, device=dev),
                            torch.arange(ntx, dtype=f32, device=dev),
                            indexing="ij")
    x0 = tx * float(tile)
    x1 = torch.clamp(x0 + float(tile - 1), max=float(width - 1))
    y0 = ty * float(tile)
    y1 = torch.clamp(y0 + float(tile - 1), max=float(height - 1))
    right, up, fwd = _vec(cam_right), _vec(cam_up), _vec(cam_fwd)
    tan_half, aspect = _f(tan_half), _f(aspect)
    args = (width, height, right, up, fwd, tan_half, aspect)
    d_c = _dir_for((x0 + x1) * 0.5, (y0 + y1) * 0.5, *args)
    # cone half-angle: min cosine against the 4 extreme (corner) pixel rays
    cos_t = torch.ones_like(x0)
    for cx in (x0, x1):
        for cy in (y0, y1):
            dq = _dir_for(cx, cy, *args)
            cos_t = torch.minimum(
                cos_t, dq[0] * d_c[0] + dq[1] * d_c[1] + dq[2] * d_c[2])
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0)) + _f(1e-4)
    sin_t = sin_t.reshape(-1)
    dx, dy, dz = (_eps_dir(d_c[0].reshape(-1)), d_c[1].reshape(-1),
                  _eps_dir(d_c[2].reshape(-1)))
    inv_x, inv_z = 1.0 / dx, 1.0 / dz
    ro = _vec(cam_pos)
    rot = torch.tensor(ro, dtype=f32, device=dev)
    hmax = _f(hmax)
    bounds = bounds.to(device=dev, dtype=f32)
    b0, b1, b2, b3 = bounds[0], bounds[1], bounds[2], bounds[3]

    def farthest(xs, ys, zs):
        """The largest distance from the camera to a box corner (a 0-d
        tensor; corners as 0-d tensors or host float32 values)."""
        far = torch.zeros((), dtype=f32, device=dev)
        for cxv in xs:
            for cyv in ys:
                for czv in zs:
                    far = torch.maximum(far, _norm3(
                        cxv - rot[0], cyv - rot[1], czv - rot[2]))
        return far

    # per-tile hard stop: exit of the deviation-padded occupied box
    far = farthest((b0, b1), (0.0, _f(hmax + 1.0)), (b2, b3))
    dy_safe = torch.where(dy.abs() < _EPS_DIR, _EPS_DIR, dy)
    pad_box = sin_t * far + 2.0
    t_entry, t_exit = _box(
        (b0 - pad_box - ro[0]) * inv_x, (b1 + pad_box - ro[0]) * inv_x,
        (-pad_box - ro[1]) / dy_safe, (hmax + pad_box - ro[1]) / dy_safe,
        (b2 - pad_box - ro[2]) * inv_z, (b3 + pad_box - ro[2]) * inv_z)
    t_hard = torch.where(t_exit >= torch.clamp(t_entry, min=0.0),
                         torch.clamp(t_exit, min=0.0), 0.0)
    max_dst = _f(max_dst)
    if max_dst >= 0.0:
        t_hard = torch.clamp(t_hard, max=max_dst)

    # near field: 5x5 exact column boxes, slab-tested per tile
    near_h = np.asarray(near_h, np.float32)
    ccx, ccz = _vec(near_base)
    nbx0, nbz0 = _f(ccx * CELL), _f(ccz * CELL)
    h_top = _f(near_h.max() + np.float32(1.0))
    d_far = farthest((nbx0, _f(nbx0 + 5 * CELL)), (0.0, h_top),
                     (nbz0, _f(nbz0 + 5 * CELL)))
    pad = sin_t * d_far + 1.0
    t_near = torch.full_like(sin_t, math.inf)
    for ix in range(NEAR):
        for iz in range(NEAR):
            h = _f(near_h[ix, iz])
            bx0 = _f((ccx + ix) * CELL)
            bz0 = _f((ccz + iz) * CELL)
            t_in, t_out = _box(
                (bx0 - pad - ro[0]) * inv_x,
                (_f(bx0 + CELL) + pad - ro[0]) * inv_x,
                (-pad - ro[1]) / dy_safe, (h + pad - ro[1]) / dy_safe,
                (bz0 - pad - ro[2]) * inv_z,
                (_f(bz0 + CELL) + pad - ro[2]) * inv_z)
            if h > 0.0:
                lo = torch.clamp(t_in, min=0.0)
                t_near = torch.where(t_out >= lo, torch.minimum(t_near, lo),
                                     t_near)

    # DDA start: the near box's exit, backed up by the deviation
    tx_far = (torch.where(dx > 0, _f(nbx0 + 5 * CELL), nbx0) - ro[0]) * inv_x
    tz_far = (torch.where(dz > 0, _f(nbz0 + 5 * CELL), nbz0) - ro[2]) * inv_z
    t_box = torch.clamp(torch.minimum(tx_far, tz_far), min=0.0)
    d_xz = torch.sqrt(dx * dx + dz * dz)
    backup = (sin_t * t_box + 2.0) / torch.clamp(d_xz, min=_EPS_DIR)
    t_start = torch.clamp(t_box - backup, min=0.0)

    ones = torch.ones_like(sin_t)
    beam = _envelope_march(levels, offsets, n, hmax, ro[0] * ones,
                           ro[1] * ones, ro[2] * ones, dx, dy, dz, inv_x,
                           inv_z, sin_t, _Y_SLACK * ones, t_start, t_hard,
                           max_iters)
    # the 1-column dilation covers t*sin(theta) <= CELL - slack
    t8 = torch.full_like(sin_t, CELL - 1.0) / sin_t
    beam = torch.where(torch.isinf(beam) & (t_hard <= t8), beam,
                       torch.minimum(beam, t8))
    return _finish_floors(torch.minimum(beam, t_near)).reshape(nty, ntx)


def pixel_floors(tf, *, width: int, height: int):
    """(nty, ntx) tile floors → a flat (H*W,) pixel array in the image's
    row-major lane order (JAX :289). The deferred kernels read
    ``tf[py // 8, px // 8]`` in place of it."""
    up = torch.repeat_interleave(torch.repeat_interleave(tf, TILE, 0), TILE, 1)
    return up[:height, :width].reshape(-1).contiguous()


def pixel_floors_at(tf, ids, width: int):
    """The floors of the pixels ``ids`` (flat, row-major), read in place
    from the (nty, ntx) tile floors as the kernels read them,
    ``tf[py // 8, px // 8]``: ``pixel_floors(tf)[ids]`` (JAX
    ``_floor_gather`` of the adaptive passes, shading.py:3178-3181)."""
    ids = ids.to(i64)
    return tf[(ids // width) // TILE, (ids % width) // TILE]


def _lanes(ro, idx) -> int:
    """Output lanes of a shadow-ray function: one per index, else per ray."""
    return idx.shape[0] if idx is not None else ro.shape[0]


def _gather(ro, idx, count, size):
    """The rays of output lanes 0..size-1 and the valid-lane mask."""
    if idx is not None:
        ro = ro[idx.to(i64)]
    valid = None
    if count is not None:
        valid = torch.arange(size, device=ro.device) < count.to(i64)
    return ro, valid


def shadow_ray_floors_plain(levels_e, h3d0, offsets, n, hmax, bounds, ro,
                            light_to, max_dst, *, idx=None, count=None):
    """(k,) conservative per-ray shadow floors (JAX :309): +inf = the ray
    certainly reaches the light, 0 = no claim. ``levels_e`` is the exact
    pyramid, ``h3d0`` the dilated level 0 (``levels[:n*n]``), ``ro`` the
    (m,3) origins, ``light_to`` the host direction toward the light,
    ``max_dst`` (k,) per output lane (<0 unbounded) or None (all
    unbounded)."""
    k = _lanes(ro, idx)
    ro, valid = _gather(ro, idx, count, k)
    dev = ro.device
    d = _vec(light_to)
    dxs = d[0] if abs(d[0]) >= _EPS_DIR else (-_EPS_DIR if d[0] < 0
                                               else _EPS_DIR)
    dzs = d[2] if abs(d[2]) >= _EPS_DIR else (-_EPS_DIR if d[2] < 0
                                               else _EPS_DIR)
    ones = torch.ones(k, dtype=f32, device=dev)
    dx, dy, dz = dxs * ones, d[1] * ones, dzs * ones
    inv_x, inv_z = 1.0 / dx, 1.0 / dz
    rox, roy, roz = ro[:, 0], ro[:, 1], ro[:, 2]
    hmax = _f(hmax)

    top = float(n - 1)
    ccx = torch.minimum(torch.clamp(torch.floor(fdiv(rox, CELL)), min=0.0),
                        torch.as_tensor(top, device=dev)).to(i64)
    ccz = torch.minimum(torch.clamp(torch.floor(fdiv(roz, CELL)), min=0.0),
                        torch.as_tensor(top, device=dev)).to(i64)
    near = h3d0[ccx * n + ccz].to(f32)
    # 1e-4 < the 1e-3 surface offset: a top-face origin reads exactly its
    # column top after rounding, and nothing can be hit within the offset
    gate = (dy >= _f(0.2)) & (roy >= near - _f(1e-4))
    d_xz = torch.sqrt(dx * dx + dz * dz)
    t_ring = torch.full_like(d_xz, CELL) / torch.clamp(d_xz, min=_EPS_DIR)

    # hard stop: exit of the (lightly padded) occupied box
    bounds = bounds.to(device=dev, dtype=f32)
    b0, b1, b2, b3 = bounds[0], bounds[1], bounds[2], bounds[3]
    dy_safe = torch.where(dy.abs() < _EPS_DIR, _EPS_DIR, dy)
    t_entry, t_exit = _box(
        (b0 - 1.0 - rox) * inv_x, (b1 + 1.0 - rox) * inv_x,
        (-1.0 - roy) / dy_safe, (hmax + 1.0 - roy) / dy_safe,
        (b2 - 1.0 - roz) * inv_z, (b3 + 1.0 - roz) * inv_z)
    t_hard = torch.where(t_exit >= torch.clamp(t_entry, min=0.0),
                         torch.clamp(t_exit, min=0.0), 0.0)
    if max_dst is not None:
        md = max_dst.to(f32)
        t_hard = torch.where(md >= 0.0, torch.minimum(t_hard, md + 1.0),
                             t_hard)

    beam = _envelope_march(levels_e, offsets, n, hmax, rox, roy, roz, dx, dy,
                           dz, inv_x, inv_z, torch.zeros_like(dx),
                           _SHADOW_M0 * ones, t_ring, t_hard, SHADOW_ITERS)
    out = torch.where(gate, _finish_floors(beam), 0.0)
    return out if valid is None else torch.where(valid, out, 0.0)


def _sun_rows(sb_words, ci):
    """Decoded rows of the sun table: u16 quarter-voxel fixed point,
    value = raw * 0.25 - 1 (exact in float32)."""
    raw = sb_words[ci].to(torch.int32) & 0xFFFF
    return raw.to(f32) * 0.25 - 1.0


def sun_verdict_masks_plain(sb_words, n1, ro, max_dst, d_len, d, origin, *,
                            idx=None, count=None, margin=0.0):
    """(lit, blocked) bool masks from the sun certificates (JAX :379):
    ``sb_words`` the (n1*n1, 76+2K) table (int16 holding u16 words), ``ro``
    the (m,3) origins, ``max_dst`` (k,) per output lane, ``d_len``, ``d``
    (toward the sun) and ``origin`` (the window's voxel offset) host
    values (``max_dst`` None: all unbounded). Rays from outside the window
    get no claim.

    ``margin`` (voxels; 0 = the JAX function exactly) widens each near
    column's footprint in the lit claim's window tests. The JAX tests
    widen it in height only, so a ray that passes within float error of a
    higher neighbour's corner keeps its lit claim while the traversal,
    whose plane crossings round in octree units, grazes that corner and
    reports a hit (1 pixel of bench pose 4 at 1080p). The deferred frame
    passes ``sun_margin`` of the world's depth: such lanes then trace."""
    k = _lanes(ro, idx)
    ro, valid = _gather(ro, idx, count, k)
    Wr = sb_words.shape[1]
    K = (Wr - 76) // 2
    org = _vec(origin)
    rox = ro[:, 0] - org[0]
    roz = ro[:, 2] - org[1]
    cx = torch.floor(rox)
    cz = torch.floor(roz)
    edge = _f(n1 + 0.125)
    inw = ((rox >= -0.125) & (rox < edge) & (roz >= -0.125) & (roz < edge))
    ccx = torch.clamp(cx, 0.0, float(n1 - 1))
    ccz = torch.clamp(cz, 0.0, float(n1 - 1))
    ci = ccx.to(i64) * n1 + ccz.to(i64)
    row = _sun_rows(sb_words, ci)
    y = ro[:, 1]
    dv = _vec(d)
    dxs = dv[0] if abs(dv[0]) >= _EPS_DIR else (-_EPS_DIR if dv[0] < 0
                                                 else _EPS_DIR)
    dzs = dv[2] if abs(dv[2]) >= _EPS_DIR else (-_EPS_DIR if dv[2] < 0
                                                 else _EPS_DIR)
    ones = torch.ones_like(y)
    dx, dy, dz = dxs * ones, dv[1] * ones, dzs * ones
    inv_x, inv_z = 1.0 / dx, 1.0 / dz
    md = (torch.full((k,), -1.0, dtype=f32, device=ro.device)
          if max_dst is None else max_dst.to(f32))
    unbounded = md < 0
    margin = _f(margin)

    lit = y + _f(1e-4) >= row[:, 0]
    blk = torch.zeros_like(lit)
    i = 0
    for ddx in (-2, -1, 0, 1, 2):
        for ddz in (-2, -1, 0, 1, 2):
            h = row[:, 1 + i]
            bt = row[:, 26 + i]
            bb = row[:, 51 + i]
            x0 = ccx + float(ddx)  # windows around the CLAMPED cell
            z0 = ccz + float(ddz)
            txa = (x0 - rox) * inv_x
            txb = (x0 + 1.0 - rox) * inv_x
            tza = (z0 - roz) * inv_z
            tzb = (z0 + 1.0 - roz) * inv_z
            t_in = torch.maximum(torch.minimum(txa, txb),
                                 torch.minimum(tza, tzb))
            t_out = torch.minimum(torch.maximum(txa, txb),
                                  torch.maximum(tza, tzb))
            t_lo = torch.clamp(t_in, min=0.0)
            over = t_out > t_lo
            # the lit claim's test, on the footprint widened by margin
            lxa = (x0 - margin - rox) * inv_x
            lxb = (x0 + 1.0 + margin - rox) * inv_x
            lza = (z0 - margin - roz) * inv_z
            lzb = (z0 + 1.0 + margin - roz) * inv_z
            t_in_l = torch.maximum(torch.minimum(lxa, lxb),
                                   torch.minimum(lza, lzb))
            t_out_l = torch.minimum(torch.maximum(lxa, lxb),
                                    torch.maximum(lza, lzb))
            t_lo_l = torch.clamp(t_in_l, min=0.0)
            h_at_l = y + t_lo_l * dy
            lit = lit & ~((t_out_l > t_lo_l)
                          & (h_at_l < h + _f(5e-4) + _f(1e-3) * t_lo_l))
            t_c = torch.maximum(t_lo, (bb + 1.0 - y) / dy)
            h_c = y + t_c * dy
            hit = (over & (bt > 0.5) & (t_c < t_out - _f(1e-2))
                   & (h_c <= bt - 1.0))
            hit = hit & (unbounded | (t_c <= md - 1.0))
            blk = blk | hit
            i += 1
    d_len = _f(d_len)
    for j in range(K):
        band = ((y >= row[:, 76 + j] + _f(1e-4))
                & (y <= row[:, 76 + K + j] - _f(1e-4)))
        blk = blk | (band & (unbounded | (md >= d_len)))
    lit_out, blk_out = lit & inw, blk & inw & ~lit
    if valid is not None:
        lit_out, blk_out = lit_out & valid, blk_out & valid
    return lit_out, blk_out


def sun_lit_floors_plain(sb_words, n1, ro, max_dst, d_len, d, origin, *,
                         idx=None, count=None, margin=0.0):
    """(k,) shadow floors (+inf = certainly lit, 0 = trace) — the lit-only
    view of ``sun_verdict_masks_plain`` (JAX :473)."""
    lit, _blk = sun_verdict_masks_plain(sb_words, n1, ro, max_dst, d_len, d,
                                        origin, idx=idx, count=count,
                                        margin=margin)
    return torch.where(lit, math.inf, 0.0).to(f32)


# ---------------------------------------------------------------------------
# Kernels K7 and K8: the wrappers
# ---------------------------------------------------------------------------


def _f32_on(t, dev):
    """``t`` as a contiguous float32 tensor on ``dev`` (itself if it is)."""
    if t.dtype == f32 and t.device == dev and t.is_contiguous():
        return t
    return t.to(device=dev, dtype=f32).contiguous()


def _check_levels(levels, offsets, n):
    if levels.dtype != torch.int32 or levels.dim() != 1 \
            or not levels.is_contiguous():
        raise ValueError("levels: expected a contiguous 1-d int32 tensor")
    if len(offsets) > _build.MAX_BEAM_LEVELS or n <= 0:
        raise ValueError(f"{len(offsets)} pyramid levels / n {n}: the "
                         f"kernels take 1..{_build.MAX_BEAM_LEVELS} levels")


def _rays_in(ro, max_dst, idx, count, dev):
    for name, t, dt in (("ro", ro, f32), ("max_dst", max_dst, f32),
                        ("idx", idx, torch.int32), ("count", count,
                                                    torch.int32)):
        if t is None:
            continue
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dt} tensor "
                             f"on {dev}")
    if ro.dim() != 2 or ro.shape[1] != 3 or (idx is not None
                                              and idx.dim() != 1):
        raise ValueError("ro: expected (m, 3), idx (k,)")
    k = _lanes(ro, idx)
    if max_dst is not None and tuple(max_dst.shape) != (k,):
        raise ValueError("max_dst: expected one limit per output lane")
    return k


def tile_floors(levels, offsets, n, hmax, bounds, near_h, near_base,
                cam_pos, cam_right, cam_up, cam_fwd, tan_half, aspect,
                max_dst, *, width: int, height: int,
                max_iters: int = TILE_ITERS):
    """``tile_floors_plain``'s function: the plain version on the CPU, K7
    (a group of lanes per tile) on the card."""
    if not levels.is_cuda:
        return tile_floors_plain(levels, offsets, n, hmax, bounds, near_h,
                                 near_base, cam_pos, cam_right, cam_up,
                                 cam_fwd, tan_half, aspect, max_dst,
                                 width=width, height=height,
                                 max_iters=max_iters)
    global launches_tile
    _check_levels(levels, offsets, n)
    dev = levels.device
    bounds = _f32_on(bounds, dev)
    p = tile_params(offsets, n, hmax, near_h, near_base, cam_pos, cam_right,
                    cam_up, cam_fwd, tan_half, aspect, max_dst, width,
                    height, max_iters)
    ntx, nty = -(-width // TILE), -(-height // TILE)
    out = torch.empty((nty, ntx), dtype=f32, device=dev)
    if ntx * nty:
        _build.launch_k7_tiles(levels, bounds, p, out)
        launches_tile += 1
    return out


def _beam_params(offsets, n, hmax, max_iters) -> _build.BeamParams:
    p = _build.BeamParams()
    for i, o in enumerate(offsets):
        p.offsets[i] = int(o)
    p.n_levels, p.n, p.hmax = len(offsets), int(n), _f(hmax)
    p.max_iters = int(max_iters)
    return p


def tile_params(offsets, n, hmax, near_h, near_base, cam_pos, cam_right,
                cam_up, cam_fwd, tan_half, aspect, max_dst, width,
                height, max_iters: int = TILE_ITERS) -> _build.BeamParams:
    """K7's tile-kernel inputs (``tile_floors``'s host values) as the C
    struct."""
    p = _beam_params(offsets, n, hmax, max_iters)
    p.width, p.height = int(width), int(height)
    p.cam_pos[:], p.right[:] = _vec(cam_pos), _vec(cam_right)
    p.up[:], p.fwd[:] = _vec(cam_up), _vec(cam_fwd)
    p.tan_half, p.aspect, p.max_dst = _f(tan_half), _f(aspect), _f(max_dst)
    p.near_h[:] = _vec(near_h)
    p.near_base[:] = _vec(near_base)
    return p


def k7_tiles_plain(levels, bounds, params: _build.BeamParams, out):
    """``_build.launch_k7_tiles``'s function, on its arguments: the floors
    of ``tile_floors_plain`` (every host value read from ``params``,
    ``max_iters`` too) written into ``out``."""
    p = params
    out.copy_(tile_floors_plain(
        levels, list(p.offsets[: p.n_levels]), p.n, p.hmax, bounds,
        np.asarray(list(p.near_h), np.float32).reshape(NEAR, NEAR),
        list(p.near_base), list(p.cam_pos), list(p.right), list(p.up),
        list(p.fwd), p.tan_half, p.aspect, p.max_dst, width=p.width,
        height=p.height, max_iters=p.max_iters))
    return out


def shadow_params(offsets, n, hmax, light_to) -> _build.BeamParams:
    """K7's shadow-kernel inputs as the C struct (``fwd`` = toward the
    light)."""
    p = _beam_params(offsets, n, hmax, SHADOW_ITERS)
    p.fwd[:] = _vec(light_to)
    return p


def shadow_ray_floors(levels_e, h3d0, offsets, n, hmax, bounds, ro,
                      light_to, max_dst, *, idx=None, count=None,
                      out=None):
    """``shadow_ray_floors_plain``'s function: the plain version on the
    CPU, K7 (a ray a thread on a grid of at most the blocks the card
    holds) on the card. ``h3d0`` must be the first ``n*n`` words of the
    dilated pyramid tensor; ``out`` optionally the caller's (k,) float32
    tensor to fill, on a 16-byte word (``_build.check_k7_shadow``)."""
    if not ro.is_cuda:
        return shadow_ray_floors_plain(levels_e, h3d0, offsets, n, hmax,
                                       bounds, ro, light_to, max_dst,
                                       idx=idx, count=count)
    global launches_shadow
    dev = ro.device
    _check_levels(levels_e, offsets, n)
    _check_levels(h3d0, offsets, n)
    k = _rays_in(ro, max_dst, idx, count, dev)
    bounds = _f32_on(bounds, dev)
    p = shadow_params(offsets, n, hmax, light_to)
    if out is None:
        out = torch.empty(k, dtype=f32, device=dev)
    if k:
        _build.launch_k7_shadow(levels_e, h3d0, bounds, p, ro, max_dst, idx,
                                count, out)
        launches_shadow += 1
    return out


def k7_shadow_plain(levels_e, h3d0, bounds, params: _build.BeamParams, ro,
                    max_dst, idx, count, out):
    """``_build.launch_k7_shadow``'s function, on its arguments: the floors
    of ``shadow_ray_floors_plain`` (the pyramid levels, ``n``, ``hmax``
    and the direction toward the light read from ``params``) written into
    ``out``, every lane (pads at or past the count 0)."""
    out.copy_(shadow_ray_floors_plain(
        levels_e, h3d0, list(params.offsets[: params.n_levels]), params.n,
        params.hmax, bounds, ro, list(params.fwd), max_dst, idx=idx,
        count=count))
    return out


def sun_params(sb_words, n1, d_len, d, origin,
               margin=0.0) -> _build.SunParams:
    """K8's inputs (the sun map's host values) as the C struct."""
    s = _build.SunParams()
    s.n1, s.width = int(n1), int(sb_words.shape[1])
    s.d_len, s.margin = _f(d_len), _f(margin)
    s.d[:] = _vec(d)
    s.origin[:] = _vec(origin)
    return s


def k8_plain(sb_words, params: _build.SunParams, ro, max_dst, idx, count, k,
             lit, blk, todo, floors):
    """``_build.launch_k8``'s function, on its arguments: the verdicts of
    ``sun_verdict_masks_plain`` (the sun map's host values read from
    ``params``) over the ``k`` lanes, written into each output that is not
    None (``todo``: the lanes below the count neither lit nor blocked;
    ``floors``: ``sun_lit_floors_plain``'s view)."""
    p = params
    pl, pb = sun_verdict_masks_plain(
        sb_words, p.n1, ro, max_dst, p.d_len, list(p.d), list(p.origin),
        idx=idx, count=count, margin=p.margin)
    valid = torch.ones(k, dtype=torch.bool, device=ro.device)
    if count is not None:
        valid = torch.arange(k, device=ro.device) < count.to(i64)
    for t, v in ((lit, pl), (blk, pb), (todo, valid & ~pl & ~pb),
                 (floors, torch.where(pl, math.inf, 0.0).to(f32))):
        if t is not None:
            t[:k].copy_(v)
    return lit, blk, todo, floors


def _check_sun(sb_words, dev):
    if sb_words.dtype != torch.int16 or sb_words.dim() != 2 \
            or sb_words.shape[1] < 76 or not sb_words.is_contiguous() \
            or sb_words.device != dev:
        raise ValueError("sb_words: expected a contiguous (rows, 76+2K) "
                         f"int16 tensor on {dev}")


def sun_verdict_masks(sb_words, n1, ro, max_dst, d_len, d, origin, *,
                      idx=None, count=None, todo=None, margin=0.0, out=None):
    """``sun_verdict_masks_plain``'s function: the plain version on the
    CPU, K8 on the card. ``todo``, a (k,) bool tensor the caller owns,
    receives ``valid & ~lit & ~blocked`` (the lanes left to trace); ``out``
    optionally the caller's (lit, blocked) (k,) bool tensors to fill."""
    if not ro.is_cuda:
        return sun_verdict_masks_plain(sb_words, n1, ro, max_dst, d_len, d,
                                       origin, idx=idx, count=count,
                                       margin=margin)
    global launches_sun
    dev = ro.device
    _check_sun(sb_words, dev)
    k = _rays_in(ro, max_dst, idx, count, dev)
    lit, blk = out if out is not None else (
        torch.empty(k, dtype=torch.bool, device=dev),
        torch.empty(k, dtype=torch.bool, device=dev))
    if k:
        _build.launch_k8(sb_words,
                         sun_params(sb_words, n1, d_len, d, origin, margin),
                         ro, max_dst, idx, count, k, lit, blk, todo, None)
        launches_sun += 1
    return lit, blk


def sun_lit_floors(sb_words, n1, ro, max_dst, d_len, d, origin, *,
                   idx=None, count=None, margin=0.0, out=None):
    """``sun_lit_floors_plain``'s function: the plain version on the CPU,
    K8 on the card (the verdict kernel writing floors)."""
    if not ro.is_cuda:
        return sun_lit_floors_plain(sb_words, n1, ro, max_dst, d_len, d,
                                    origin, idx=idx, count=count,
                                    margin=margin)
    global launches_sun_floors
    dev = ro.device
    _check_sun(sb_words, dev)
    k = _rays_in(ro, max_dst, idx, count, dev)
    floors = torch.empty(k, dtype=f32, device=dev) if out is None else out
    if k:
        _build.launch_k8(sb_words,
                         sun_params(sb_words, n1, d_len, d, origin, margin),
                         ro, max_dst, idx, count, k, None, None, None,
                         floors)
        launches_sun_floors += 1
    return floors


class BeamContext:
    """Per-frame pre-pass handle (JAX :482-555): the primary tile floors
    plus the envelope state (``HeightField.device``) and, where attached,
    the sun map, needed to floor or certify shadow rays once their origins
    exist. ``graphics.Svo`` builds one per frame when a heightfield is
    attached."""

    def __init__(self, tile_floors, dev, width: int, height: int, sun=None,
                 sun_margin: float = 0.0):
        self.tile_floors = tile_floors  # (nty, ntx) float32
        self._dev = dev
        self.width, self.height = width, height
        # (sb_words (n1*n1, 76+2K) int16, n1, d_len, d, origin) or None
        self._sun = sun
        self.sun_margin = sun_margin  # ``sun_verdict_masks``'s margin
        self._h3d0 = None  # the dilated level 0, a view taken once

    @property
    def t_floor(self):
        """The (H*W,) pixel floors (``pixel_floors``)."""
        return pixel_floors(self.tile_floors, width=self.width,
                            height=self.height)

    def has_sun(self) -> bool:
        return self._sun is not None

    def without_sun(self) -> "BeamContext":
        """The same floors with no sun map (beams only)."""
        return BeamContext(self.tile_floors, self._dev, self.width,
                           self.height, sun_margin=self.sun_margin)

    def sun_verdicts(self, ro, max_dst, *, idx=None, count=None, todo=None,
                     out=None):
        """(lit, blocked) — origins the sun map proves see / don't see the
        light — or None when no sun map is attached."""
        if self._sun is None:
            return None
        sb, n1, d_len, d, origin = self._sun
        return sun_verdict_masks(sb, n1, ro, max_dst, d_len, d, origin,
                                 idx=idx, count=count, todo=todo,
                                 margin=self.sun_margin, out=out)

    def shadow_ray_floors(self, ro, max_dst, direction, *, idx=None,
                          count=None, out=None):
        """(k,) conservative floors for shadow rays from ``ro`` along the
        constant ``direction`` (toward the light): the sun map's where one
        is attached, else the envelope march's."""
        if self._sun is not None:
            sb, n1, d_len, d, origin = self._sun
            return sun_lit_floors(sb, n1, ro, max_dst, d_len, d, origin,
                                  idx=idx, count=count,
                                  margin=self.sun_margin, out=out)
        levels, offsets, n, hmax, bounds, levels_e = self._dev
        if self._h3d0 is None:
            self._h3d0 = levels[: n * n]
        return shadow_ray_floors(levels_e, self._h3d0, offsets, n, hmax,
                                 bounds, ro, direction, max_dst, idx=idx,
                                 count=count, out=out)

    def shadow_ray_floors_plain(self, ro, max_dst, direction):
        """``shadow_ray_floors`` through the plain versions on any device
        (the plain deferred frame's)."""
        if self._sun is not None:
            sb, n1, d_len, d, origin = self._sun
            return sun_lit_floors_plain(sb, n1, ro, max_dst, d_len, d,
                                        origin, margin=self.sun_margin)
        levels, offsets, n, hmax, bounds, levels_e = self._dev
        return shadow_ray_floors_plain(levels_e, levels[: n * n], offsets, n,
                                       hmax, bounds, ro, direction, max_dst)
