"""The exact frame: ray generation, shading, shadows, sky — the plain
PyTorch version and the wrapper of kernel K3.

Counterpart: voxelrs_tpu/ops/shading.py — ``FACE_*``/``SKY_COLOR`` :23-37,
``face_texture_layer`` :60, ``make_alpha_fn`` :69, ``generate_rays`` :119,
``sky_color`` :142, ``surface_shading`` :153, ``shade_hits`` :259,
``crosshair_overlay`` :4053 and ``render_frame`` :4067 (reference:
assets/shaders/world.glsl:27-141): per-pixel primary ray → SVO traversal
with in-loop translucency → texture/normal lookup → Lambert diffuse +
specular → shadow ray → sky and composite.

The world is an ESVO buffer (an int32 tensor of u32 words) or a CSVO world
(``ops.traversal_csvo.CsvoBuffer``), whose rays trace through
``intersect_octree_csvo`` — the JAX ``render_frame``'s ``traverse=`` hook
(:4080-4081, the shadow ray's :276) as the JAX ``Svo.render`` sets it for a
CSVO buffer (graphics/svo.py:292-331): there the shadow rays get the
frame's step budget, in the ESVO frame the reference MAX_STEPS.

On CUDA tensors ``render_frame`` launches K3 (``csrc/kernels.cu``; its CSVO
instantiation for a CSVO world), one thread per pixel for the whole frame;
the plain version runs on the CPU and serves the comparisons on the card.

``render_frame_deferred`` is the JAX package's default mode
(``render_frame_deferred`` :3058): the same pixels through stages — the
primary trace from the beam floors (K7), shading, the shadow trace of the
compacted candidates (K6) with sun certificates (K8) or floors — built on
the card from K3's device functions. From 2^18 pixels it takes the JAX
rule's adaptive thick-ray frame, as the JAX package does: K9
(``ops/adaptive.py``) on an opaque world, K9-judged
(``ops/adaptive_judged.py``) on a translucent one.

``render_frames_opaque_batch`` is K10 (``render_frames_opaque_batch``
:3580): N poses of an opaque world rendered by one launch of each of the
opaque frame's stages (their pose dimension: ``cams``, pose-major lanes),
each pose's image equal to its own deferred frame.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from . import compact
from .beams import sun_verdict_masks_plain
from .bits import fdiv, u32_to_i32
from .texture import level_meta, sample_texture_lod
from .traversal import (MAX_STEPS, TraversalResult, intersect_octree_plain,
                        step_budget)
from .traversal_csvo import CsvoBuffer, check_words, intersect_octree_csvo_plain
from .traversal_csvo import step_budget as csvo_step_budget

# Pre-calculated per-face frames, order [x-, x+, y-, y+, z-, z+]
# (reference: assets/shaders/svo.glsl:1-29).
FACE_NORMALS = torch.tensor(
    [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]],
    dtype=torch.float32)
FACE_TANGENTS = torch.tensor(
    [[0, 0, 1], [0, 0, -1], [1, 0, 0], [1, 0, 0], [-1, 0, 0], [1, 0, 0]],
    dtype=torch.float32)
FACE_BITANGENTS = torch.tensor(
    [[0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1], [0, 1, 0], [0, 1, 0]],
    dtype=torch.float32)

SKY_COLOR = torch.tensor([135.0, 206.0, 235.0], dtype=torch.float32) / 255.0
HORIZON_COLOR = torch.ones(3, dtype=torch.float32) * 0.7 + SKY_COLOR * 0.3

launches = 0  # K3 launches by render_frame (the wrapper below)
launches_csvo = 0  # of those, launches of the CSVO instantiation


def mip_mode_from_env() -> str:
    """Shading mip mode: nearest-mip bilinear by default, trilinear
    (the GL reference's LINEAR_MIPMAP_LINEAR) under VOXELRS_TRILINEAR=1."""
    return "linear" if os.environ.get("VOXELRS_TRILINEAR") == "1" else "nearest"


def _table_row(value: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Row of a per-block table: the u32 value read as int32 and clamped,
    as the JAX one-hot lookup clamps it."""
    return torch.clamp(u32_to_i32(value).to(torch.int64), 0, n_rows - 1)


def face_texture_layer(mat_tex, value, face_id, normal: bool):
    """Texture layer for the hit face: side unless top (face 3) / bottom
    (face 2); +3 column offset for normal maps."""
    base = 3 if normal else 0
    row = mat_tex[_table_row(value, mat_tex.shape[0])][:, base:base + 3]
    top, side, bottom = row[:, 0], row[:, 1], row[:, 2]
    return torch.where(face_id == 3, top, torch.where(face_id == 2, bottom, side))


class KernelTables:
    """Texture and material tables as the kernels read them: the flat RGBA
    atlas of all mip levels plus per-level (h, w, offset), the material
    table and the paired-atlas layer tables. Holds the tensors the C struct
    points into, and, made at first use and kept, the judged adaptive
    frame's hole table (``hole``) and the plain alpha judge over the same
    mips (``alpha_fn``)."""

    def __init__(self, mips, mat_tex, mat_params=None):
        T = mips[0].shape[0]
        if len(mips) > _build.MAX_LEVELS or mips[0].shape[-1] != 4:
            raise ValueError("kernels take at most 8 RGBA mip levels")
        self.mips = tuple(mips)
        self._hole = self._alpha_fn = None
        self.atlas = torch.cat([m.reshape(-1) for m in mips]).to(torch.float32)
        self.mat_tex = mat_tex.to(torch.int32).contiguous()
        self.mat_params = (None if mat_params is None
                           else mat_params.to(torch.float32).contiguous())
        self.pair_color = self.pair_normal = None
        if mat_tex.shape[1] >= 9:
            self.pair_color, self.pair_normal = pair_layers(mat_tex, T)
        hs, ws, offs = level_meta(mips)
        s = _build.TexTables()
        s.atlas = self.atlas.data_ptr()
        for i in range(len(mips)):
            s.level_h[i], s.level_w[i], s.level_off[i] = hs[i], ws[i], offs[i]
        s.n_levels, s.n_layers = len(mips), T
        s.mat_tex = self.mat_tex.data_ptr()
        s.mat_rows, s.mat_cols = mat_tex.shape
        s.mat_params = (0 if self.mat_params is None
                        else self.mat_params.data_ptr())
        if self.pair_color is not None:
            s.pair_color = self.pair_color.data_ptr()
            s.pair_normal = self.pair_normal.data_ptr()
            s.pair_cap = self.pair_color.shape[0]
        self.struct = s

    @property
    def hole(self) -> torch.Tensor:
        """(mat_rows, n_levels) bool: ``ops.adaptive_judged.hole_table``."""
        if self._hole is None:
            from .adaptive_judged import hole_table

            self._hole = hole_table(self.mips, self.mat_tex)
        return self._hole

    @property
    def alpha_fn(self) -> "AlphaFn":
        """``make_alpha_fn(mips, mat_tex)``: the plain judge the kernels
        inline (texel_alpha, mode 1)."""
        if self._alpha_fn is None:
            self._alpha_fn = make_alpha_fn(self.mips, self.mat_tex)
        return self._alpha_fn


def pair_layers(mat_tex, T: int):
    """(colour layer, normal layer) of each paired-atlas id: mat_tex columns
    6:9 hold the pair id of the top/side/bottom slot."""
    from ..graphics.registry import PAIR_CAP

    pslot = mat_tex[:, 6:9].reshape(-1).to(torch.int64)
    cl = torch.zeros(PAIR_CAP, dtype=torch.int32, device=mat_tex.device)
    nl = torch.zeros(PAIR_CAP, dtype=torch.int32, device=mat_tex.device)
    cl[pslot] = torch.clamp(mat_tex[:, 0:3], 0, T - 1).reshape(-1).to(torch.int32)
    nl[pslot] = torch.clamp(mat_tex[:, 3:6], 0, T - 1).reshape(-1).to(torch.int32)
    return cl, nl


class AlphaFn:
    """In-traversal texel alpha sampler for translucent pass-through (K2).

    The reference judges ``textureLod(textures, vec3(uv, tex), tex_lod).a``
    (svo.esvo.glsl:235-241). The default is the nearest texel at the nearest
    mip level of a flat all-levels alpha atlas; ``exact=True`` uses the
    trilinear sampler. Calling it runs the plain version; the kernels read
    ``tables`` and inline the same sampler."""

    def __init__(self, mips, mat_tex, exact: bool = False):
        self.mips = mips
        self.mat_tex = mat_tex
        self.exact = exact
        T = mips[0].shape[0]
        self.n_layers = T
        self.alpha_flat = torch.cat([m[..., 3].reshape(-1) for m in mips])
        hs, ws, offs = level_meta(mips)
        self.meta = torch.tensor([hs, ws, offs], dtype=torch.int64,
                                 device=mips[0].device)
        self._tables = None

    @property
    def tables(self) -> KernelTables:
        if self._tables is None:
            self._tables = KernelTables(self.mips, self.mat_tex)
        return self._tables

    def __call__(self, value, face_id, uv, lod):
        layer = face_texture_layer(self.mat_tex, value, face_id, False)
        if self.exact:
            return sample_texture_lod(self.mips, layer, uv, lod)[:, 3]
        layer = torch.clamp(layer.to(torch.int64), 0, self.n_layers - 1)
        # same level rounding as sample_texture_lod(mip_mode="nearest")
        dl = torch.round(torch.clamp(lod, 0.0, float(len(self.mips) - 1)))
        dl = dl.to(torch.int64)
        h, w, off = self.meta[0][dl], self.meta[1][dl], self.meta[2][dl]
        x = torch.floor(uv[:, 0] * w).to(torch.int64)
        y = torch.floor(uv[:, 1] * h).to(torch.int64)
        x = torch.minimum(torch.clamp(x, min=0), w - 1)
        y = torch.minimum(torch.clamp(y, min=0), h - 1)
        return self.alpha_flat[off + layer * h * w + y * w + x]


def make_alpha_fn(mips, mat_tex, exact: bool = False) -> AlphaFn:
    """The texel-alpha judge of the traversal (see ``AlphaFn``)."""
    return AlphaFn(mips, mat_tex, exact)


def tan_half_fov(fov_y_rad) -> float:
    """tan(fov/2) in float32, computed once so the plain version and K3
    generate rays from the same constant."""
    fov = torch.tensor(float(np.float32(fov_y_rad)), dtype=torch.float32)
    return float(torch.tan(fov * 0.5))


def _norm3(x):
    return torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2])


def generate_rays(width, height, cam_pos, cam_right, cam_up, cam_fwd,
                  tan_half: float, aspect: float):
    """Per-pixel rays (reference: world.glsl:110-129). Returns ro (B,3),
    rd (B,3) with B = width*height in image row-major order (row 0 = top of
    the image). The camera vectors are (3,) float32 tensors on the target
    device."""
    dev = cam_pos.device
    px = torch.arange(width, dtype=torch.float32, device=dev)
    py = torch.arange(height, dtype=torch.float32, device=dev)
    u = fdiv(px, width) * 2.0 - 1.0
    # GL images index y bottom-up; flip so row 0 is the top of the image
    v = fdiv(height - 1.0 - py, height) * 2.0 - 1.0
    u = u * aspect * tan_half
    v = v * tan_half
    uu, vv = torch.meshgrid(u, v, indexing="xy")  # (H, W)
    rd = (uu[..., None] * cam_right + vv[..., None] * cam_up
          + cam_fwd).reshape(-1, 3)
    rd = rd / _norm3(rd)[:, None]
    ro = cam_pos.expand(rd.shape).contiguous()
    return ro, rd


def sky_color(rd):
    """Sky gradient (reference: world.glsl:92-108). acos of the horizontal
    component length is the angle to the xz plane."""
    horiz = torch.sqrt(rd[:, 0] * rd[:, 0] + rd[:, 2] * rd[:, 2])
    a = torch.acos(torch.clamp(horiz, 0.0, 1.0))
    grad = fdiv(a, np.float32(np.pi / 2.0))
    g1 = 1.0 - grad
    grad = 1.0 - g1 * g1 * g1
    sky = SKY_COLOR.to(rd.device)
    horizon = HORIZON_COLOR.to(rd.device)
    rgb = horizon[None, :] * (1.0 - grad[:, None]) + sky[None, :] * grad[:, None]
    return torch.cat([rgb, torch.ones_like(rgb[:, :1])], dim=-1)


def surface_shading(res, mips, mat_params, mat_tex, cam_pos, light_dir,
                    highlight_pos, mip_mode: str):
    """Surface color + normal-mapped lighting terms for traversal hits
    (reference: world.glsl:47-75). Returns (color, normal, diffuse,
    specular)."""
    T = mips[0].shape[0]
    dev = res.t.device
    row = _table_row(res.value, mat_params.shape[0])
    # face -> texture slot: top (face 3) = 0, bottom (face 2) = 2, side = 1
    slot = torch.where(res.face_id == 3, 0,
                       torch.where(res.face_id == 2, 2, 1)).to(torch.int64)
    mrow_tex = mat_tex.to(torch.int64)[row]
    spec_pow = torch.clamp(mat_params[row, 0], min=1e-6)
    spec_strength = mat_params[row, 1]
    nlayer = mrow_tex.gather(1, (3 + slot)[:, None])[:, 0]

    if mat_tex.shape[1] >= 9:
        # paired colour+normal atlas: one layer pair per pair id
        pid = mrow_tex.gather(1, (6 + slot)[:, None])[:, 0]
        cl_u, nl_u = pair_layers(mat_tex, T)
        pair_mips = tuple(torch.cat([m[cl_u.long()], m[nl_u.long()]], dim=-1)
                          for m in mips)
        tex8 = sample_texture_lod(pair_mips, pid, res.uv, res.lod,
                                  mip_mode=mip_mode)
        color, ntex = tex8[:, 0:4], tex8[:, 4:8]
    else:
        clayer = mrow_tex.gather(1, slot[:, None])[:, 0]
        color = sample_texture_lod(mips, clayer, res.uv, res.lod,
                                   mip_mode=mip_mode)
        ntex = sample_texture_lod(mips, nlayer, res.uv, res.lod,
                                  mip_mode=mip_mode)

    # block highlight outline
    same_block = torch.all(torch.floor(res.pos)
                           == torch.floor(highlight_pos)[None, :], dim=-1)
    local = torch.abs(res.uv - 0.5) * 2.0
    lmax = torch.maximum(local[:, 0], local[:, 1])
    outline = same_block & (lmax > 1.0 - 1.0 / 16.0)
    color = torch.where(outline[:, None], torch.ones_like(color), color)

    # normal mapping (.xzy swizzle: blue = up -> y axis)
    f = torch.clamp(res.face_id.to(torch.int64), 0, 5)
    normal = FACE_NORMALS.to(dev)[f]
    tangent = FACE_TANGENTS.to(dev)[f]
    bitangent = FACE_BITANGENTS.to(dev)[f]
    swz = torch.stack([ntex[:, 0], ntex[:, 2], ntex[:, 1]], dim=-1) * 2.0 - 1.0
    swz = swz / _norm3(swz)[:, None]
    mapped = (swz[:, 0:1] * tangent + swz[:, 1:2] * normal
              + swz[:, 2:3] * bitangent)
    normal = torch.where((nlayer != -1)[:, None], mapped, normal)

    def dot(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    incident = (-light_dir)[None, :].expand_as(normal)
    diffuse = torch.clamp(dot(normal, incident), min=0.0)
    view_dir = res.pos - cam_pos[None, :]
    view_dir = view_dir / torch.clamp(_norm3(view_dir), min=1e-12)[:, None]
    reflect_dir = incident - (2.0 * dot(normal, incident))[:, None] * normal
    spec_dot = torch.clamp(dot(view_dir, reflect_dir), min=0.0)
    specular = torch.pow(spec_dot, spec_pow) * spec_strength
    return color, normal, diffuse, specular


def shade_hits(res, ro, rd, mips, mat_params, mat_tex, *, cam_pos, ambient,
               light_dir, render_shadows, shadow_distance, highlight_pos,
               descriptors, octree_scale, alpha_fn, mip_mode: str,
               shadow_steps: int = MAX_STEPS):
    """Shading of traversal results (reference: world.glsl:27-90).
    ``shadow_steps``: the shadow ray's step budget (the JAX ESVO frame
    calls intersect_octree without max_steps, the reference MAX_STEPS)."""
    hit = res.t != -1.0
    B = res.t.shape[0]

    color, normal, diffuse, specular = surface_shading(
        res, mips, mat_params, mat_tex, cam_pos, light_dir, highlight_pos,
        mip_mode)

    if render_shadows:
        need = hit & (res.t < shadow_distance)
        sro = res.pos + normal * 0.001
        srd = (-light_dir)[None, :].expand(B, 3).contiguous()
        # retire unneeded lanes instantly
        smax = torch.where(need, -1.0, 1e-35).to(torch.float32)
        sres = trace_plain(descriptors, octree_scale, sro, srd, smax, True,
                           alpha_fn, shadow_steps)
        shadow = torch.where(need, torch.where(sres.t < 0, 1.0, 0.0), 1.0)
    else:
        shadow = torch.ones(B, dtype=torch.float32, device=res.t.device)

    light = torch.clamp(ambient + (diffuse + specular) * shadow, 0.0, 1.0)
    rgb = color[:, :3] * light[:, None]
    shaded = torch.cat([rgb, color[:, 3:4]], dim=-1)
    return torch.where(hit[:, None], shaded, sky_color(rd))


def world_tensor(world) -> torch.Tensor:
    """The device tensor of a world: the ESVO buffer, or a CSVO world's
    words."""
    return world.words if isinstance(world, CsvoBuffer) else world


def trace_plain(world, octree_scale, ro, rd, max_dst, cast_translucent,
                alpha_fn=None, max_steps: int = MAX_STEPS, t_floor=None):
    """The plain traversal of either format (``world``: an ESVO buffer or a
    ``CsvoBuffer``), optionally from per-ray entry floors."""
    if isinstance(world, CsvoBuffer):
        return intersect_octree_csvo_plain(
            world.words, octree_scale, world.root_ptr, world.total_depth, ro,
            rd, max_dst, cast_translucent, alpha_fn, max_steps, t_floor)
    return intersect_octree_plain(world, octree_scale, ro, rd, max_dst,
                                  cast_translucent, alpha_fn, max_steps,
                                  t_floor)


def _vec3(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def render_frame_plain(descriptors, octree_scale, mips, mat_params, mat_tex,
                       *, width: int, height: int, render_shadows: bool,
                       cam_pos, cam_right, cam_up, cam_fwd, fov_y_rad, aspect,
                       ambient, light_dir, shadow_distance, highlight_pos,
                       max_steps: int = 1000, mip_mode: str | None = None):
    """The plain PyTorch frame: every step in torch ops, on any device."""
    csvo = isinstance(descriptors, CsvoBuffer)
    dev = world_tensor(descriptors).device
    mip_mode = mip_mode or mip_mode_from_env()
    cam_pos, light_dir = _vec3(cam_pos, dev), _vec3(light_dir, dev)
    ro, rd = generate_rays(width, height, cam_pos, _vec3(cam_right, dev),
                           _vec3(cam_up, dev), _vec3(cam_fwd, dev),
                           tan_half_fov(fov_y_rad),
                           float(np.float32(aspect)))
    alpha_fn = make_alpha_fn(mips, mat_tex)
    res = trace_plain(descriptors, octree_scale, ro, rd, -1.0, True,
                      alpha_fn, max_steps)
    img = shade_hits(
        res, ro, rd, mips, mat_params, mat_tex, cam_pos=cam_pos,
        ambient=float(np.float32(ambient)), light_dir=light_dir,
        render_shadows=render_shadows,
        shadow_distance=float(np.float32(shadow_distance)),
        highlight_pos=_vec3(highlight_pos, dev), descriptors=descriptors,
        octree_scale=octree_scale, alpha_fn=alpha_fn, mip_mode=mip_mode,
        shadow_steps=max_steps if csvo else MAX_STEPS)
    return img.reshape(height, width, 4)


def frame_params(*, width, height, render_shadows, cam_pos, cam_right, cam_up,
                 cam_fwd, fov_y_rad, aspect, ambient, light_dir,
                 shadow_distance, highlight_pos, max_steps,
                 mip_mode, csvo: bool = False,
                 deferred: bool = False) -> _build.FrameParams:
    """K3's per-frame inputs as the C struct (``csvo``: the step budgets
    of the CSVO frame; ``deferred``: those of the deferred frame, whose
    shadow rays get the frame's budget)."""
    p = _build.FrameParams()
    p.width, p.height = int(width), int(height)
    p.render_shadows = int(bool(render_shadows))
    if csvo:
        p.primary_budget = p.shadow_budget = csvo_step_budget(max_steps)
    else:
        p.primary_budget = step_budget(max_steps)
        p.shadow_budget = step_budget(max_steps if deferred else MAX_STEPS)
    p.trilinear = int(mip_mode == "linear")
    for name, v in (("cam_pos", cam_pos), ("right", cam_right),
                    ("up", cam_up), ("fwd", cam_fwd), ("light_dir", light_dir),
                    ("highlight", highlight_pos), ("sky", SKY_COLOR),
                    ("horizon", HORIZON_COLOR)):
        getattr(p, name)[:] = [float(c) for c in np.asarray(v, np.float32)]
    p.aspect = float(np.float32(aspect))
    p.tan_half = tan_half_fov(fov_y_rad)
    p.ambient = float(np.float32(ambient))
    p.shadow_distance = float(np.float32(shadow_distance))
    return p


# A batch's record offsets (lane * words, up to K9-judged's 16 words a
# lane) stay under 2^31 so that no kernel index can overflow an int:
# 64 poses at 1920x1080.
MAX_BATCH_WORDS = 1 << 31


def check_batch(n_poses: int, width: int, height: int) -> None:
    """Refuse a batch of no pose, or one whose lanes' record words would
    reach 2^31 (``MAX_BATCH_WORDS``): the kernels index lanes with ints."""
    if n_poses < 1:
        raise ValueError("a batch needs at least one pose")
    if n_poses * width * height * _build.K9J_WORDS >= MAX_BATCH_WORDS:
        raise ValueError(
            f"a batch of {n_poses} poses at {width}x{height}: its records "
            f"would reach 2^31 words; render at most "
            f"{(MAX_BATCH_WORDS - 1) // (width * height * _build.K9J_WORDS)}"
            " poses a batch")


def batch_cameras(cam_stack, device) -> torch.Tensor:
    """(N, 12) float32 on ``device``: each pose's cam_pos, right, up and
    fwd, from ``cam_stack`` = (cam_pos, cam_right, cam_up, cam_fwd), each
    (N, 3) (the JAX batch's layout)."""
    rows = np.concatenate([np.asarray(c, np.float32).reshape(-1, 3)
                           for c in cam_stack], axis=1)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device)


def check_cams(cams, width: int, height: int, device) -> None:
    """A batch's cameras as the kernels take them: a contiguous (N, 12)
    float32 tensor on ``device``, N within ``check_batch``."""
    if cams.dtype != torch.float32 or cams.dim() != 2 \
            or cams.shape[1] != 12 or not cams.is_contiguous() \
            or cams.device != device:
        raise ValueError(f"cams: expected a contiguous (N, 12) float32 "
                         f"tensor on {device}")
    check_batch(cams.shape[0], width, height)


def pose_params(fp: _build.FrameParams, cams,
                pose: int) -> _build.FrameParams:
    """``fp`` with the camera of pose ``pose`` of ``cams`` (N, 12), as the
    kernels read it (``kernels.cu::pose_params``): the plain versions'
    parameters for one pose of a batch."""
    f = _build.FrameParams.from_buffer_copy(fp)
    row = [float(x) for x in cams[pose].tolist()]
    f.cam_pos[:], f.right[:] = row[0:3], row[3:6]
    f.up[:], f.fwd[:] = row[6:9], row[9:12]
    return f


def crosshair_overlay(image: torch.Tensor, radius_px: float = 8.0,
                      thickness: float = 1.5) -> torch.Tensor:
    """Composite a smooth circular crosshair at the image center
    (reference: assets/shaders/crosshair.glsl:27-36 — smooth circle,
    alpha-blended). Elementwise over the (H, W, 4) frame, in plain torch."""
    H, W = image.shape[0], image.shape[1]
    dev = image.device
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - H / 2.0
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - W / 2.0
    d = torch.sqrt(yy * yy + xx * xx)
    ring = torch.clamp(1.0 - fdiv((d - radius_px).abs(), thickness), 0.0,
                       1.0)
    alpha = ring[..., None] * 0.8
    rgb = image[..., :3] * (1 - alpha) + alpha
    return torch.cat([rgb, image[..., 3:4]], dim=-1)


def render_frame(descriptors, octree_scale, mips, mat_params, mat_tex, *,
                 width: int, height: int, render_shadows: bool,
                 cam_pos, cam_right, cam_up, cam_fwd, fov_y_rad, aspect,
                 ambient, light_dir, shadow_distance, highlight_pos,
                 max_steps: int = 1000, tables: KernelTables | None = None):
    """One full frame. Returns (H, W, 4) float32 on the buffer's device.

    ``descriptors`` is the world: an ESVO buffer ((N,) int32 holding u32
    words) or a ``CsvoBuffer``. Camera vectors, light and highlight are (3,)
    array-likes (highlight NaN = none). On the CPU this is the plain
    version; on a CUDA buffer it launches K3 once, the instantiation of the
    world's format. ``tables`` (``KernelTables`` of the same mips and
    materials) lets a caller reuse the kernel tables across frames."""
    kw = dict(width=width, height=height, render_shadows=render_shadows,
              cam_pos=cam_pos, cam_right=cam_right, cam_up=cam_up,
              cam_fwd=cam_fwd, fov_y_rad=fov_y_rad, aspect=aspect,
              ambient=ambient, light_dir=light_dir,
              shadow_distance=shadow_distance, highlight_pos=highlight_pos,
              max_steps=max_steps)
    mip_mode = mip_mode_from_env()
    buf = world_tensor(descriptors)
    if not buf.is_cuda:
        return render_frame_plain(descriptors, octree_scale, mips, mat_params,
                                  mat_tex, mip_mode=mip_mode, **kw)
    global launches, launches_csvo
    dev = buf.device
    csvo = isinstance(descriptors, CsvoBuffer)
    if csvo:
        check_words(*descriptors)
    elif buf.dtype != torch.int32 or buf.dim() != 1 \
            or buf.shape[0] < 12 or not buf.is_contiguous():
        raise ValueError("descriptors: expected a contiguous 1-d int32 buffer "
                         "of >= 12 words")
    for name, t in (("mat_params", mat_params), ("mat_tex", mat_tex),
                    *((f"mips[{i}]", m) for i, m in enumerate(mips))):
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if tables is None:
        tables = KernelTables(mips, mat_tex, mat_params)
    img = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    params = frame_params(mip_mode=mip_mode, csvo=csvo, **kw)
    if width * height:
        _build.launch_k3(descriptors, float(octree_scale), tables, params, img)
        launches += 1
        launches_csvo += int(csvo)
    return img


# ---------------------------------------------------------------------------
# The deferred frame (the JAX package's default render mode)
# ---------------------------------------------------------------------------

# launches of the deferred frame's stages by render_frame_deferred (below)
launches_primary = 0
launches_shade = 0
launches_shadow = 0
launches_finish = 0


class DeferredWorkspace:
    """The deferred frame's scratch on the card for ``B`` pixels: hit
    records, the shading lanes, the three compactions' outputs and counts,
    the certificates and the shadow results. A caller that keeps one and
    passes it to every frame (``render_frame_deferred(workspace=)``; the
    stream orders the reuse) makes a frame allocate only its image: each
    allocation is an operator call that gives up the interpreter lock,
    which the game's job threads then hold."""

    def __init__(self, B: int, dev):
        def e(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        i32, b8 = torch.int32, torch.bool
        self.key = (B, dev)
        self.rec = e((B, _build.HIT_WORDS), i32)
        self.hit, self.need, self.todo = e(B, b8), e(B, b8), e(B, b8)
        self.lit, self.blk, self.traced = e(B, b8), e(B, b8), e(B, b8)
        self.color, self.ds = e((B, 4), torch.float32), e(B, torch.float32)
        self.sro, self.floors = e((B, 3), torch.float32), e(B, torch.float32)
        self.hidx, self.sidx, self.tidx = e(B, i32), e(B, i32), e(B, i32)
        self.hcount, self.scount, self.tcount = (e(1, i32), e(1, i32),
                                                 e(1, i32))
        # K6's tile counter and status words: zeroed once, then kept
        self.scratch = torch.zeros(_build.k6_blocks(B), dtype=i32,
                                   device=dev)
        self._adaptive = None

    def adaptive(self, width: int, height: int, levels: int,
                 words: int = _build.K9_WORDS, n_poses: int = 1):
        """The adaptive frame's buffers (``ops.adaptive.AdaptiveBuffers``)
        for this frame size, depth of grids, record size (``words``: K9's
        records, or K9-judged's ``_build.K9J_WORDS``) and batch of poses,
        made the first time a frame needs them and kept."""
        from .adaptive import AdaptiveBuffers

        if self._adaptive is None or self._adaptive.key != (
                width, height, levels, words, n_poses):
            self._adaptive = None  # free the old scratch first
            self._adaptive = AdaptiveBuffers(width, height, levels,
                                             self.key[1], words, n_poses)
        return self._adaptive


def shadow_verdicts_plain(world, octree_scale, sro, light_dir, beams, opaque,
                          alpha_fn, max_steps, certify: bool):
    """The plain deferred frame's shadow verdicts of the rays from the
    origins ``sro`` ((k, 3)) toward the light, judged by ``alpha_fn``
    unless ``opaque``, as the finishing stage takes them: (blk, todo,
    traced), each (k,) bool. ``certify`` with a sun map: K8's plain
    version certifies what it can (``blk``: certainly blocked) and the rest
    (``todo``) is traced unfloored; otherwise ``blk`` and ``todo`` are None
    and every ray is traced, from the floors of ``beams`` where given.
    ``traced`` = the ray was traced and hit."""
    dev = sro.device
    if sro.shape[0] == 0:
        none = torch.zeros(0, dtype=torch.bool, device=dev)
        return None, None, none
    md = torch.full((sro.shape[0],), -1.0, dtype=torch.float32, device=dev)
    neg_light = -light_dir
    srd = neg_light[None, :].expand(sro.shape).contiguous()
    if certify and beams is not None and beams.has_sun():
        sb, n1, d_len, d, origin = beams._sun
        lit, blk = sun_verdict_masks_plain(sb, n1, sro, md, d_len, d, origin,
                                           margin=beams.sun_margin)
        todo = ~lit & ~blk
        tidx, tcount = compact.compact_indices_plain(todo, sro.shape[0])
        lanes = tidx[: int(tcount)].to(torch.int64)
        sres = trace_plain(world, octree_scale, sro[lanes], srd[lanes], -1.0,
                           not opaque, alpha_fn, max_steps)
        traced = torch.zeros_like(blk)
        traced[lanes] = sres.t >= 0
        return blk, todo, traced
    floors = (None if beams is None else beams.shadow_ray_floors_plain(
        sro, md, neg_light.cpu().numpy()))
    sres = trace_plain(world, octree_scale, sro, srd, -1.0, not opaque,
                       alpha_fn, max_steps, floors)
    return None, None, ~(sres.t < 0)


def shadow_blocked_plain(world, octree_scale, sro, light_dir, beams, opaque,
                         alpha_fn, max_steps, certify: bool):
    """The plain deferred frame's shadow verdicts: (k,) bool, the rays from
    the origins ``sro`` toward the light blocked (``shadow_verdicts_plain``
    combined: certified blocked, or left to trace and hit)."""
    blk, todo, traced = shadow_verdicts_plain(world, octree_scale, sro,
                                              light_dir, beams, opaque,
                                              alpha_fn, max_steps, certify)
    return traced if blk is None else blk | (todo & traced)


def hit_records(res) -> torch.Tensor:
    """(n, 9) int32 hit records of traversal results, as ``kd_primary``
    stores them (``csrc/kernels.cu`` HitRec): t, value, face, pos, uv,
    lod, a float as its bits."""
    def w(x):
        return x.to(torch.float32).contiguous().view(torch.int32)

    return torch.stack([w(res.t), u32_to_i32(res.value),
                        res.face_id.to(torch.int32), w(res.pos[:, 0]),
                        w(res.pos[:, 1]), w(res.pos[:, 2]), w(res.uv[:, 0]),
                        w(res.uv[:, 1]), w(res.lod)], 1)


def kd_primary_plain(world, octree_scale, tables, params, alpha_mode, tf,
                     rec, hit, img, cams=None):
    """``_build.launch_kd_primary``'s function, on its arguments: every
    pixel of each pose (``cams`` None: one frame at ``params``' camera;
    else pose p's camera from ``cams[p]``, lanes pose-major) traced from
    its tile floor ``tf[py // 8, px // 8]`` (``tf`` None: unfloored; a
    batch's (N, nty, ntx)) with the frame's primary budget, judged by
    ``tables.alpha_fn`` unless ``alpha_mode`` is 0; its 9-word hit record
    into ``rec`` ((N*H*W, 9) int32), its hit flag into ``hit`` and, for a
    miss, its sky into ``img``, whose other pixels keep their values.
    Returns (rec, hit, img)."""
    from .adaptive import _frame_rays
    from .beams import pixel_floors_at

    if alpha_mode not in (0, 1):
        raise ValueError(f"kd_primary_plain: alpha mode {alpha_mode}")
    B = params.width * params.height
    ids = torch.arange(B, device=rec.device)
    pix = img.view(-1, 4)
    for p in range(1 if cams is None else cams.shape[0]):
        fp = params if cams is None else pose_params(params, cams, p)
        ro, rd = _frame_rays(fp, ids)
        floors = None if tf is None else pixel_floors_at(
            tf if cams is None else tf[p], ids, params.width)
        res = trace_plain(world, octree_scale, ro, rd, -1.0, alpha_mode != 0,
                          None if alpha_mode == 0 else tables.alpha_fn,
                          params.primary_budget, floors)
        h = res.t != -1.0
        rec[p * B:(p + 1) * B] = hit_records(res)
        hit[p * B:(p + 1) * B] = h.to(hit.dtype)
        miss = torch.nonzero(~h)[:, 0]
        pix[p * B + miss] = sky_color(rd[miss])
    return rec, hit, img


class DeferredStagesPlain(NamedTuple):
    """The plain deferred frame's intermediates: the primary stage's
    pixels ``sky`` ((B, 4): a miss's sky, 0 where a ray hit); the hit
    lanes' pixels
    ``hidx`` ((k,) int64), colour ``color`` ((k, 4)), light ``ds``
    (diffuse + specular, (k,)) and shadow need ``need`` ((k,) bool); the
    shadow candidates' hit lanes ``sidx`` ((m,) int64) and their verdicts
    ``blk``, ``todo``, ``traced`` (``shadow_verdicts_plain``)."""

    sky: torch.Tensor
    hidx: torch.Tensor
    color: torch.Tensor
    ds: torch.Tensor
    need: torch.Tensor
    sidx: torch.Tensor
    blk: torch.Tensor | None
    todo: torch.Tensor | None
    traced: torch.Tensor


def deferred_stages_plain(world, octree_scale, mips, mat_params, mat_tex, *,
                          width: int, height: int, render_shadows: bool,
                          cam_pos, cam_right, cam_up, cam_fwd, fov_y_rad,
                          aspect, ambient, light_dir, shadow_distance,
                          highlight_pos, max_steps: int = 1000,
                          opaque: bool = False, beams=None,
                          mip_mode: str | None = None) -> DeferredStagesPlain:
    """``render_frame_deferred_plain``'s stages up to the shadow verdicts
    (its arguments): the primary stage (``kd_primary_plain``), then torch
    ops and the plain versions of K6, K7 and K8."""
    dev = world_tensor(world).device
    mip_mode = mip_mode or mip_mode_from_env()
    fp = frame_params(width=width, height=height,
                      render_shadows=render_shadows, cam_pos=cam_pos,
                      cam_right=cam_right, cam_up=cam_up, cam_fwd=cam_fwd,
                      fov_y_rad=fov_y_rad, aspect=aspect, ambient=ambient,
                      light_dir=light_dir, shadow_distance=shadow_distance,
                      highlight_pos=highlight_pos, max_steps=max_steps,
                      mip_mode=mip_mode, csvo=isinstance(world, CsvoBuffer),
                      deferred=True)
    tables = KernelTables(mips, mat_tex, mat_params)
    cam_pos, light_dir = _vec3(cam_pos, dev), _vec3(light_dir, dev)
    B = width * height
    rec = torch.empty((B, _build.HIT_WORDS), dtype=torch.int32, device=dev)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    sky = torch.zeros((B, 4), dtype=torch.float32, device=dev)
    kd_primary_plain(world, octree_scale, tables, fp, 0 if opaque else 1,
                     None if beams is None else beams.tile_floors, rec, hit,
                     sky)
    alpha_fn = None if opaque else tables.alpha_fn
    hidx, hcount = compact.compact_indices_plain(hit, B)
    lane = hidx[: int(hcount)].to(torch.int64)
    r = rec[lane]
    rf = r.view(torch.float32)
    res_k = TraversalResult(
        t=rf[:, 0], value=r[:, 1].to(torch.int64) & 0xFFFFFFFF,
        face_id=r[:, 2], pos=rf[:, 3:6], uv=rf[:, 6:8], lod=rf[:, 8],
        inside_voxel=None, steps=None)
    color, normal, diffuse, specular = surface_shading(
        res_k, mips, mat_params, mat_tex, cam_pos, light_dir,
        _vec3(highlight_pos, dev), mip_mode)
    ds = diffuse + specular
    # a shadow only matters where it can darken something
    need = (res_k.t < float(np.float32(shadow_distance))) & (ds > 0)
    if not render_shadows:
        need = torch.zeros_like(need)
    sidx, scount = compact.compact_indices_plain(need, lane.shape[0])
    cand = sidx[: int(scount)].to(torch.int64)
    blk, todo, traced = shadow_verdicts_plain(
        world, octree_scale, res_k.pos[cand] + normal[cand] * 0.001,
        light_dir, beams, opaque, alpha_fn, max_steps, certify=opaque)
    return DeferredStagesPlain(sky, lane, color, ds, need, cand, blk, todo,
                               traced)


def render_frame_deferred_plain(world, octree_scale, mips, mat_params,
                                mat_tex, *, width: int, height: int,
                                render_shadows: bool, cam_pos, cam_right,
                                cam_up, cam_fwd, fov_y_rad, aspect, ambient,
                                light_dir, shadow_distance, highlight_pos,
                                max_steps: int = 1000, opaque: bool = False,
                                beams=None, mip_mode: str | None = None):
    """The plain PyTorch deferred frame (``render_frame_deferred``), every
    stage in torch ops and the plain versions of K6, K7 and K8
    (``deferred_stages_plain``), then the light and the image."""
    st = deferred_stages_plain(
        world, octree_scale, mips, mat_params, mat_tex, width=width,
        height=height, render_shadows=render_shadows, cam_pos=cam_pos,
        cam_right=cam_right, cam_up=cam_up, cam_fwd=cam_fwd,
        fov_y_rad=fov_y_rad, aspect=aspect, ambient=ambient,
        light_dir=light_dir, shadow_distance=shadow_distance,
        highlight_pos=highlight_pos, max_steps=max_steps, opaque=opaque,
        beams=beams, mip_mode=mip_mode)
    blocked = torch.zeros_like(st.need)
    blocked[st.sidx] = (st.traced if st.blk is None
                        else st.blk | (st.todo & st.traced))
    shadow = torch.where(st.need, torch.where(blocked, 0.0, 1.0), 1.0)
    light = torch.clamp(float(np.float32(ambient)) + st.ds * shadow, 0.0, 1.0)
    rgb = st.color[:, :3] * light[:, None]
    img = st.sky
    img[st.hidx] = torch.cat([rgb, st.color[:, 3:4]], dim=-1)
    return img.reshape(height, width, 4)


def render_frame_deferred(world, octree_scale, mips, mat_params, mat_tex, *,
                          width: int, height: int, render_shadows: bool,
                          cam_pos, cam_right, cam_up, cam_fwd, fov_y_rad,
                          aspect, ambient, light_dir, shadow_distance,
                          highlight_pos, max_steps: int = 1000,
                          opaque: bool = False, beams=None,
                          tables: KernelTables | None = None,
                          workspace: DeferredWorkspace | None = None,
                          adaptive: bool | None = None):
    """The deferred frame (voxelrs_tpu/ops/shading.py::render_frame_deferred
    :3058): raygen → primary trace from the pixel floors of
    ``beams`` (an ``ops.beams.BeamContext``, or None) → shade the hits →
    shadow candidates → compact (K6) → opaque with a sun map: certify (K8),
    compact the uncertified (K6) and trace those; otherwise floor the
    shadow rays (K7 ``shadow_ray_floors`` or K8 ``sun_lit_floors``) and
    trace → finish the light → combine. Returns (H, W, 4) float32.

    ``opaque`` (the caller has proved no block of the world has a texel
    with alpha < 1) casts first-hit rays, as the JAX opaque branch
    (:3495/:3722) does; otherwise the judged branch (:3122-3176) judges
    texel alpha inside the traversal loop, as K3 does. The JAX deferred
    trace judges between rounds and reports a miss after ``rounds=4``
    translucent texels along a ray, so the two agree only on scenes whose
    rays pass fewer translucent texels than that. Shadow rays get the
    frame's step budget, as the JAX deferred trace gives them; at the
    default 1000 steps that is K3's, and on an opaque scene the frame is
    K3's fused frame bit for bit (floors are exact restarts, certificates
    are the trace's verdicts).

    On the CPU this is the plain version. On the card: K7 (tile floors),
    the primary stage, K6, the shading stage, K6, then K8 and K6 or K7 /
    K8 floors, the shadow stage and the finishing stage — the counts stay
    in device memory, so the frame makes no host round trip. ``tables``
    and ``workspace`` (a ``DeferredWorkspace`` of this frame's size and
    device) let a caller reuse them across frames.

    On an opaque world the JAX rule picks the adaptive thick-ray frame
    (``ops.adaptive.adaptive_levels``: from 2^18 pixels, both sides over
    4; ``VOXELRS_ADAPTIVE`` and ``VOXELRS_HIERARCHY`` override it, and
    ``adaptive`` True / False pins it): ``ops.adaptive.
    render_frames_adaptive_batch`` (K9) on the card, its plain version on
    the CPU. A translucent world takes the JAX judged rule (``ops.adaptive.
    frame_levels``: the quarter grid from 4,096 quarter lanes, else the half
    grid) and ``ops.adaptive_judged.render_frame_adaptive_judged``
    (K9-judged); ``adaptive=False`` keeps this exact judged frame."""
    from .adaptive import frame_levels

    return render_frame_deferred_at(
        frame_levels(width, height, opaque, adaptive), world, octree_scale,
        mips, mat_params, mat_tex, width=width, height=height,
        render_shadows=render_shadows, cam_pos=cam_pos, cam_right=cam_right,
        cam_up=cam_up, cam_fwd=cam_fwd, fov_y_rad=fov_y_rad, aspect=aspect,
        ambient=ambient, light_dir=light_dir, shadow_distance=shadow_distance,
        highlight_pos=highlight_pos, max_steps=max_steps, opaque=opaque,
        beams=beams, tables=tables, workspace=workspace)


def render_frame_deferred_at(levels: int, world, octree_scale, mips,
                             mat_params, mat_tex, *, width: int, height: int,
                             render_shadows: bool, cam_pos, cam_right, cam_up,
                             cam_fwd, fov_y_rad, aspect, ambient, light_dir,
                             shadow_distance, highlight_pos,
                             max_steps: int = 1000, opaque: bool = False,
                             beams=None, tables: KernelTables | None = None,
                             workspace: DeferredWorkspace | None = None):
    """``render_frame_deferred`` with the grid levels already chosen
    (``ops.adaptive.frame_levels``; 0 the exact frame), for a caller that
    records the choice, as ``Svo.render`` does."""
    from . import adaptive as _adaptive
    from . import adaptive_judged

    kw = dict(width=width, height=height, render_shadows=render_shadows,
              cam_pos=cam_pos, cam_right=cam_right, cam_up=cam_up,
              cam_fwd=cam_fwd, fov_y_rad=fov_y_rad, aspect=aspect,
              ambient=ambient, light_dir=light_dir,
              shadow_distance=shadow_distance, highlight_pos=highlight_pos,
              max_steps=max_steps)
    mip_mode = mip_mode_from_env()
    buf = world_tensor(world)
    if not buf.is_cuda:
        if levels:
            frame = (_adaptive.render_frame_adaptive_plain if opaque else
                     adaptive_judged.render_frame_adaptive_judged_plain)
            return frame(world, octree_scale, mips, mat_params, mat_tex,
                         beams=beams, levels=levels, mip_mode=mip_mode, **kw)
        return render_frame_deferred_plain(world, octree_scale, mips,
                                           mat_params, mat_tex, opaque=opaque,
                                           beams=beams, mip_mode=mip_mode,
                                           **kw)
    params = frame_params(mip_mode=mip_mode, deferred=True,
                          csvo=isinstance(world, CsvoBuffer), **kw)
    img = torch.empty((height, width, 4), dtype=torch.float32,
                      device=buf.device)
    return _frame_on_card(levels, world, octree_scale, mips, mat_params,
                          mat_tex, params, None, opaque=opaque, beams=beams,
                          light_dir=light_dir, tables=tables,
                          workspace=workspace, img=img)


def _frame_on_card(levels: int, world, octree_scale, mips, mat_params,
                   mat_tex, params: _build.FrameParams, cams, *, opaque: bool,
                   beams, light_dir, tables, workspace, img):
    """The deferred frame's launches on the card into ``img``, of one pose
    (``cams`` None) or of a batch (``cams`` (N, 12), an opaque world, K10):
    the adaptive frame for ``levels`` > 0, else ``kd_primary`` → K6 →
    ``kd_shade`` → ``shadow_pass``; each launched once for all the
    poses."""
    from . import adaptive as _adaptive
    from . import adaptive_judged

    global launches_primary, launches_shade
    buf = world_tensor(world)
    dev = buf.device
    if isinstance(world, CsvoBuffer):
        check_words(*world)
    elif buf.dtype != torch.int32 or buf.dim() != 1 \
            or buf.shape[0] < 12 or not buf.is_contiguous():
        raise ValueError("descriptors: expected a contiguous 1-d int32 buffer "
                         "of >= 12 words")
    width, height = params.width, params.height
    N = 1 if cams is None else cams.shape[0]
    if cams is not None:
        check_cams(cams, width, height, dev)
    if tables is None:
        tables = KernelTables(mips, mat_tex, mat_params)
    B = width * height * N
    if B == 0:
        return img
    alpha_mode = 0 if opaque else 1
    scale = float(octree_scale)
    tf = None
    if beams is not None:
        tf = beams.tile_floors
        tiles = (-(-height // 8), -(-width // 8))
        if tf.device != dev or tf.dtype != torch.float32 \
                or not tf.is_contiguous() or tuple(tf.shape) != (
                    tiles if cams is None else (N, *tiles)):
            raise ValueError("beams: tile floors of another frame or device")
    ws = workspace
    if ws is None or ws.key != (B, dev):
        ws = DeferredWorkspace(B, dev)
    if levels:
        if opaque:
            return _adaptive.render_frames_adaptive_batch(
                world, scale, tables, params, cams, levels=levels,
                beams=beams, light_dir=light_dir, ws=ws, img=img)
        if cams is not None:
            raise ValueError("a pose batch renders an opaque world")
        return adaptive_judged.render_frame_adaptive_judged(
            world, scale, tables, params, levels=levels, beams=beams,
            light_dir=light_dir, ws=ws, img=img)
    _build.launch_kd_primary(world, scale, tables, params, alpha_mode, tf,
                             ws.rec, ws.hit, img, cams=cams)
    launches_primary += 1
    hidx, hcount = compact.compact_indices(ws.hit, B, out=ws.hidx,
                                           count=ws.hcount, scratch=ws.scratch)
    _build.launch_kd_shade(tables, params, hidx, hcount, ws.rec, ws.color,
                           ws.ds, ws.need, ws.sro, img, cams=cams)
    launches_shade += 1
    if params.render_shadows:
        # the exact judged frame floors its shadow rays (JAX :3152-3163)
        shadow_pass(world, scale, tables, params, alpha_mode, beams,
                    light_dir, ws, ws.need, hidx, img, certify=opaque)
    return img


def shadow_pass(world, scale, tables, params, alpha_mode, beams, light_dir,
                ws, mask, hidx, img, *, certify: bool, blkp=None):
    """One shadow pass of the deferred stages on the card over the
    candidate lanes ``mask`` (of the compacted hits ``hidx``): K6;
    ``certify`` with a sun map, K8's certificates and K6 over the
    uncertified, else K7 / K8 floors where ``beams``; the shadow stage
    (judged unless ``alpha_mode`` is 0); the finishing stage (``blkp``:
    None, or the pixel-space verdicts it writes)."""
    global launches_shadow, launches_finish
    if isinstance(world, CsvoBuffer):
        check_words(*world)
    B = mask.shape[0]
    sidx, scount = compact.compact_indices(mask, B, out=ws.sidx,
                                           count=ws.scount, scratch=ws.scratch)
    blk = todo = tidx = tcount = floors = None
    if certify and beams is not None and beams.has_sun():
        # certify what the sun map can; trace the rest unfloored
        beams.sun_verdicts(ws.sro, None, idx=sidx, count=scount,
                           todo=ws.todo, out=(ws.lit, ws.blk))
        blk, todo = ws.blk, ws.todo
        tidx, tcount = compact.compact_indices(todo, B, out=ws.tidx,
                                               count=ws.tcount,
                                               scratch=ws.scratch)
    elif beams is not None:
        floors = beams.shadow_ray_floors(
            ws.sro, None, -np.asarray(light_dir, np.float32), idx=sidx,
            count=scount, out=ws.floors)
    _build.launch_kd_shadow(world, scale, tables, params, alpha_mode, ws.sro,
                            sidx, scount, tidx, tcount, floors, ws.traced)
    launches_shadow += 1
    _build.launch_kd_finish(params, hidx, sidx, scount, ws.color, ws.ds, blk,
                            todo, ws.traced, img, blkp)
    launches_finish += 1


def kd_shadow_plain(world, octree_scale, tables, params, alpha_mode, sro,
                    sidx, scount, tidx, tcount, floors, traced):
    """``_build.launch_kd_shadow``'s function, on its arguments: for each
    slot m < count of the candidate list (``sidx``, ``scount``) or, with
    ``tidx``, of its uncertified sub-list (``tidx``, ``tcount``), the
    shadow ray of candidate c (``tidx[m]``, else m) from ``sro[sidx[c]]``
    toward the light of ``params``, from ``floors[c]`` where given, with
    the frame's shadow budget, judged by ``tables.alpha_fn`` unless
    ``alpha_mode`` is 0; ``traced[c]`` = it hit. The other entries of
    ``traced`` keep their values."""
    if alpha_mode not in (0, 1):
        raise ValueError(f"kd_shadow_plain: alpha mode {alpha_mode}")
    n = min(int((scount if tidx is None else tcount).reshape(-1)[0]),
            sidx.shape[0])
    if n <= 0:
        return traced
    dev = sro.device
    c = (torch.arange(n, device=dev) if tidx is None
         else tidx[:n].to(torch.int64))
    ro = sro[sidx[c].to(torch.int64)]
    rd = (-torch.tensor(list(params.light_dir), dtype=torch.float32,
                        device=dev)).expand(n, 3).contiguous()
    res = trace_plain(world, octree_scale, ro, rd, -1.0, alpha_mode != 0,
                      None if alpha_mode == 0 else tables.alpha_fn,
                      params.shadow_budget,
                      None if floors is None else floors[c])
    traced[c] = (~(res.t < 0)).to(traced.dtype)
    return traced


def kd_finish_plain(params, hidx, sidx, scount, color, ds, blk, todo,
                    traced, img, blkp=None):
    """``_build.launch_kd_finish``'s function, on its arguments: candidate
    c < count of the list (``sidx``, ``scount``) is blocked when it was
    traced and hit (``traced[c]``), or with certificates (``blk`` and
    ``todo`` given) when K8 certified it so or it was left to trace and
    hit; a blocked candidate's pixel ``hidx[sidx[c]]`` of ``img`` gets its
    hit lane's colour in the ambient light alone (the shadow factor 0), and
    ``blkp`` (None, or the pixel-space verdicts) its verdict at every
    candidate's pixel. Every other entry of ``img`` and ``blkp`` keeps its
    value."""
    n = min(int(scount.reshape(-1)[0]), sidx.shape[0])
    if n <= 0:
        return img
    blocked = traced[:n].bool()
    if blk is not None:
        blocked = blk[:n].bool() | (todo[:n].bool() & blocked)
    j = sidx[:n].to(torch.int64)
    px = hidx[j].to(torch.int64)
    if blkp is not None:
        blkp[px] = blocked.to(blkp.dtype)
    jb, pb = j[blocked], px[blocked]
    light = torch.clamp(params.ambient + ds[jb] * 0.0, 0.0, 1.0)
    c = color[jb]
    img.view(-1, 4)[pb] = torch.cat([c[:, :3] * light[:, None], c[:, 3:4]],
                                    dim=-1)
    return img


# ---------------------------------------------------------------------------
# K10: a batch of poses (the JAX package's render_frames_opaque_batch)
# ---------------------------------------------------------------------------

def _batch_beams(beams_shared, t_floor_stack, n_poses: int):
    """The batch's beam context: each pose's tile floors stacked (N, nty,
    ntx) (``t_floor_stack``, or the shared context's own floors for every
    pose), the envelope and the sun map shared (JAX :3625-3634)."""
    from .beams import BeamContext

    if beams_shared is None:
        return None
    tf = t_floor_stack
    if tf is None:
        tf = beams_shared.tile_floors.expand(n_poses,
                                             *beams_shared.tile_floors.shape)
    return BeamContext(tf.contiguous(), beams_shared._dev,
                       beams_shared.width, beams_shared.height,
                       sun=beams_shared._sun,
                       sun_margin=beams_shared.sun_margin)


def render_frames_opaque_batch_plain(world, octree_scale, mips, mat_params,
                                     mat_tex, cam_stack, fov_y_rad, aspect,
                                     ambient, light_dir, shadow_distance,
                                     highlight_pos, *, width: int,
                                     height: int, render_shadows: bool,
                                     max_steps: int = 1000,
                                     beams_shared=None, t_floor_stack=None,
                                     levels: int = 0,
                                     mip_mode: str | None = None):
    """``render_frames_opaque_batch``'s plain version on any device: the
    port's plain frame of each pose in turn (the adaptive frame for
    ``levels`` > 0, else the exact deferred frame), with that pose's tile
    floors and the shared envelope and sun map. Returns (N, H, W, 4)."""
    from .adaptive import render_frame_adaptive_plain
    from .beams import BeamContext

    beams = _batch_beams(beams_shared, t_floor_stack, len(cam_stack[0]))
    frames = []
    for p, cam in enumerate(zip(*cam_stack)):
        b = None if beams is None else BeamContext(
            beams.tile_floors[p], beams._dev, width, height, sun=beams._sun,
            sun_margin=beams.sun_margin)
        kw = dict(width=width, height=height, render_shadows=render_shadows,
                  cam_pos=cam[0], cam_right=cam[1], cam_up=cam[2],
                  cam_fwd=cam[3], fov_y_rad=fov_y_rad, aspect=aspect,
                  ambient=ambient, light_dir=light_dir,
                  shadow_distance=shadow_distance,
                  highlight_pos=highlight_pos, max_steps=max_steps, beams=b,
                  mip_mode=mip_mode)
        frames.append(
            render_frame_adaptive_plain(world, octree_scale, mips, mat_params,
                                        mat_tex, levels=levels, **kw)
            if levels else
            render_frame_deferred_plain(world, octree_scale, mips, mat_params,
                                        mat_tex, opaque=True, **kw))
    return torch.stack(frames)


def render_frames_opaque_batch(world, octree_scale, mips, mat_params, mat_tex,
                               cam_stack, fov_y_rad, aspect, ambient,
                               light_dir, shadow_distance, highlight_pos, *,
                               width: int, height: int, render_shadows: bool,
                               max_steps: int = 1000, beams_shared=None,
                               t_floor_stack=None,
                               tables: KernelTables | None = None,
                               workspace: DeferredWorkspace | None = None):
    """N poses of an opaque world in one pass (voxelrs_tpu/ops/shading.py::
    render_frames_opaque_batch :3580, K10). Returns (N, H, W, 4) float32.

    ``cam_stack`` = (cam_pos, cam_right, cam_up, cam_fwd), each (N, 3);
    every pose takes the one ``fov_y_rad``, ``aspect``, ``ambient``,
    ``light_dir``, ``shadow_distance``, ``highlight_pos`` and
    ``render_shadows`` (the JAX batch passes pose 0's). ``beams_shared``
    (an ``ops.beams.BeamContext``, or None) gives the envelope and the sun
    map all poses share, ``t_floor_stack`` the (N, nty, ntx) tile floors of
    each pose (None: the shared context's own). Each pose's image is the
    frame ``render_frame_deferred_at`` draws for it on an opaque world: the
    adaptive frame where ``ops.adaptive.frame_levels`` picks it (from 2^18
    pixels, or as ``VOXELRS_ADAPTIVE`` / ``VOXELRS_HIERARCHY`` say), else
    the exact deferred frame. The JAX ``max_steps`` applies;
    ``stack_height`` and ``engine`` have no counterpart (the port's
    traversal keeps its stack in registers, and the world's format picks
    it).

    The JAX function is a ``lax.map`` of the frame in one XLA program,
    paying the per-dispatch floor once per batch. Here every stage of the
    opaque frame is launched once for all N poses (``_frame_on_card`` with
    ``cams``: pose-major lanes, each pose's camera from an (N, 12) device
    array), so a batch makes as many stage launches as one frame; only the
    per-pose tile floors (K7, built by the caller) grow with N. On the CPU
    this is ``render_frames_opaque_batch_plain``. ``tables`` and
    ``workspace`` (a ``DeferredWorkspace`` of N * H * W lanes) let a caller
    reuse them. A batch is refused beyond ``check_batch``."""
    from .adaptive import frame_levels

    N = len(cam_stack[0])
    check_batch(N, width, height)
    levels = frame_levels(width, height, True)
    buf = world_tensor(world)
    mip_mode = mip_mode_from_env()
    if not buf.is_cuda:
        return render_frames_opaque_batch_plain(
            world, octree_scale, mips, mat_params, mat_tex, cam_stack,
            fov_y_rad, aspect, ambient, light_dir, shadow_distance,
            highlight_pos, width=width, height=height,
            render_shadows=render_shadows, max_steps=max_steps,
            beams_shared=beams_shared, t_floor_stack=t_floor_stack,
            levels=levels, mip_mode=mip_mode)
    params = frame_params(
        width=width, height=height, render_shadows=render_shadows,
        cam_pos=cam_stack[0][0], cam_right=cam_stack[1][0],
        cam_up=cam_stack[2][0], cam_fwd=cam_stack[3][0], fov_y_rad=fov_y_rad,
        aspect=aspect, ambient=ambient, light_dir=light_dir,
        shadow_distance=shadow_distance, highlight_pos=highlight_pos,
        max_steps=max_steps, mip_mode=mip_mode,
        csvo=isinstance(world, CsvoBuffer), deferred=True)
    img = torch.empty((N, height, width, 4), dtype=torch.float32,
                      device=buf.device)
    return _frame_on_card(
        levels, world, octree_scale, mips, mat_params, mat_tex, params,
        batch_cameras(cam_stack, buf.device), opaque=True,
        beams=_batch_beams(beams_shared, t_floor_stack, N),
        light_dir=light_dir, tables=tables, workspace=workspace, img=img)
