"""voxelrs_tpu_torch's adaptive frame of a translucent world
(``ops/adaptive_judged.py``, the plain versions of K9-judged on the CPU)
against voxelrs_tpu's judged adaptive frame (``_render_frame_judged_
adaptive``): the judged trace's surface identity against the JAX
deferred trace (``_deferred_pipeline(...)[1]``), the result-level merge
against ``_make_res_merge`` at both levels (``[15]`` quarter onto half,
``[12]`` half onto pixels) with the hole fill off and on, whole frames
against ``Svo.render`` with ``VOXELRS_ADAPTIVE=1`` (its second render) in
ESVO at hierarchy 1 and 0 with beams and the sun map (the CSVO frame and
trace: tests/test_torch_csvo.py, with these helpers), the frame against
the port's exact judged frame, and the judged selection rule.

The scene is tests/test_torch_deferred.py's terrain (2 x 2 chunks) with a
water pool below a sea level (uniform alpha 0.65, hole-free: it fills), a
glass wall (alpha-0 panes in an opaque frame: rays through the panes pass,
so the cells around them trip the no-pass guard and the hole table) and a
one-voxel leaf canopy on a trunk (25% alpha-0 holes: the hole table, and
with ``VOXELRS_HOLE_FILL=1`` the per-pixel hole-fill judge). The canopy is
one voxel thick so that the JAX deferred trace, which judges texel alpha
between rounds and misses a ray that passes more translucent texels than
its rounds allow, draws most of it as its fused frame does.

Tolerances. Integer fields (hit, value, face, scale, passed, inside,
refine) and the entry plane are equal. Float fields of a hit within 5e-4
in world units (t, pos; measured up to 2.8e-4: XLA on the CPU contracts
multiply-adds into FMAs, the port does not; distances here reach ~80
units), uv within 1e-4, lod within 1e-5. The merge decides fills by exact
float equalities, so an FMA can flip a lane between fill and re-trace:
measured 0 of 19,481 / 76,800 lanes, bounded at 0.5%
(tests/test_torch_adaptive.py). Frames against the JAX frame: the port's
frame budget (mean |d| <= 1e-3, at most 1% of the pixels off by more than
1e-3; tests/test_torch_deferred.py; measured 6 and 64 pixels off on the
two ESVO views at hierarchy 1, 6 at hierarchy 0, 0 in CSVO); in ESVO the
pixels off must also lie within a cell (2^levels pixels) of a pixel where
the two packages' exact judged frames already differ — the "rounds"
pixels, where the JAX deferred trace runs out of judges (46 on the canopy
view), and FMA grazes — since fills and shadow cells carry a corner's
result across its cell. A trace lane may differ only at such a pixel or
where an FMA picks the other face of a voxel edge at the same distance
(measured: 1). The adaptive frame against the port's exact frame: the
traced grid's pixels equal, and the JAX package's budget for its judged
adaptive frame (tests/test_render.py:222-252: mean |d| < 0.004, under 3%
of the pixels off by more than 1e-3); the glass wall's lattice shadow,
finer than a cell, is most of it, in both packages (measured on the
overview: 617 pixels off, mean 0.0025, in each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrs_tpu.gamelogic import content as jcontent
from voxelrs_tpu.graphics.svo import RenderParams as JRenderParams
from voxelrs_tpu.graphics.svo import Svo as JSvo
from voxelrs_tpu.ops import shading as jshading
from voxelrs_tpu.world import ChunkPos, Position
from voxelrs_tpu.world import heightfield as jhf
from voxelrs_tpu.world.csvo import Csvo as JCsvo
from voxelrs_tpu.world.csvo import CsvoSerializedChunk as JCsvoChunk
from voxelrs_tpu.world.esvo import Esvo as JEsvo
from voxelrs_tpu.world.esvo import SerializedChunk as JChunk
from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.graphics.svo import RenderParams, Svo
from voxelrs_tpu_torch.ops import adaptive, compact
from voxelrs_tpu_torch.ops import adaptive_judged as aj
from voxelrs_tpu_torch.ops.beams import pixel_floors_at
from voxelrs_tpu_torch.ops.shading import KernelTables, frame_params
from voxelrs_tpu_torch.world import ChunkPos as TCP
from voxelrs_tpu_torch.world import Position as TPos
from voxelrs_tpu_torch.world import csvo as tcsvo
from voxelrs_tpu_torch.world import esvo as tesvo
from voxelrs_tpu_torch.world import heightfield as thf

from torch_threads import one_torch_thread  # noqa: F401

W, H = 320, 240  # quarter grid 81 x 61 = 4,941 lanes: two levels
SW, SH = 128, 96  # quarter grid 33 x 25: one level (the half grid)
SEA = 9
C = jcontent
CAMS = {
    # the pool, the glass wall and the canopy from above
    "overview": ([30.0, 28.0, 20.0], [0.3, -0.6, 0.7]),
    # across the canopy toward the pool
    "canopy": ([8.0, 26.0, 60.0], [0.6, -0.5, -0.5]),
}
WORLD_TOL, UV_TOL, LOD_TOL = 5e-4, 1e-4, 1e-5
FLIP_SHARE = 0.005


def _chunk(cx, cz):
    vox = np.zeros((32, 32, 32), np.uint32)
    x = np.arange(32) + cx * 32
    z = np.arange(32) + cz * 32
    hh = (10 + 6 * np.sin(x[:, None] * 0.11)
          + 5 * np.cos(z[None, :] * 0.17)).astype(np.int32)
    for ix in range(32):
        for iz in range(32):
            h = max(1, hh[ix, iz])
            vox[ix, : h - 1, iz] = C.STONE
            vox[ix, h - 1, iz] = C.GRASS
            vox[ix, h:SEA, iz] = C.WATER
    if (cx, cz) == (1, 1):
        vox[8:20, 12:22, 14] = C.GLASS
    if (cx, cz) == (0, 1):
        vox[20, 10:19, 8] = C.OAK_LOG
        vox[14:27, 19, 2:15] = C.OAK_LEAVES
    return vox


def _build(fmt):
    """(JAX Svo, port Svo, JAX field, port field) of the 2 x 2 scene."""
    dtype = np.uint32 if fmt == "esvo" else np.uint8
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=8, buffer_dtype=dtype)
    tsvo = Svo(content.new_registry(), capacity_mb=8, buffer_dtype=dtype,
               device="cpu")
    lut = jhf.opaque_lut_from_mask(jsvo.translucent_block_mask)
    jw, tw = (JEsvo(), tesvo.Esvo()) if fmt == "esvo" else (JCsvo(),
                                                          tcsvo.Csvo())
    jc, tc = ((JChunk, tesvo.SerializedChunk) if fmt == "esvo"
              else (JCsvoChunk, tcsvo.CsvoSerializedChunk))
    jh, th = jhf.HeightField(), thf.HeightField()
    for cx in range(2):
        for cz in range(2):
            vox = _chunk(cx, cz)
            jw.set_leaf(Position(cx, 0, cz),
                        jc.from_voxels(ChunkPos(cx, 0, cz), vox, 5), True)
            tw.set_leaf(TPos(cx, 0, cz),
                        tc.from_voxels(TCP(cx, 0, cz), vox, 5), True)
            for hf in (jh, th):
                hf.set_chunk((cx, 0, cz), jhf.chunk_column_tops(vox, 5),
                             vtops=jhf.chunk_voxel_tops(vox, 5),
                             sbase=jhf.chunk_solid_bases(vox, 5, lut))
    jw.serialize()
    tw.serialize()
    jsvo.update(jw)
    tsvo.update(tw)
    assert not tsvo.is_opaque()
    assert jsvo.world_value_mask == tsvo.world_value_mask
    jsvo.set_heightfield(jh)
    tsvo.set_heightfield(th)
    return jsvo, tsvo


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def scenes():
    built = {}

    def get(fmt):
        if fmt not in built:
            built[fmt] = _build(fmt)
        return built[fmt]

    yield get
    built.clear()


def _params(cls, cam, w=W, h=H):
    pos, fwd = CAMS[cam]
    fwd = np.asarray(fwd, np.float32)
    return cls(cam_pos=np.asarray(pos, np.float32),
               cam_fwd=fwd / np.linalg.norm(fwd), aspect_ratio=w / h,
               fov_y_rad=np.radians(70.0), render_shadows=True,
               shadow_distance=100.0)


@pytest.fixture(scope="module")
def jax_frames(scenes):
    """JAX frames with the heightfield (beams and the sun map), each
    rendered once per view and configuration, its second render
    (the first after a change of view replays the previous view's
    buckets): ``adaptive`` "1" the judged adaptive frame at ``hierarchy``,
    "0" the exact judged frame."""
    cache = {}

    def get(fmt, cam, adaptive="1", hierarchy="1", w=W, h=H):
        key = (fmt, cam, adaptive, hierarchy, w, h)
        if key not in cache:
            jsvo = scenes(fmt)[0]
            jp = _params(JRenderParams, cam, w, h)
            mp = pytest.MonkeyPatch()
            try:
                mp.setenv("VOXELRS_HIERARCHY", hierarchy)
                mp.setenv("VOXELRS_ADAPTIVE", adaptive)
                mp.delenv("VOXELRS_HOLE_FILL", raising=False)
                jsvo.render(jp, w, h)
                cache[key] = np.asarray(jsvo.render(jp, w, h))
            finally:
                mp.undo()
        return cache[key]

    yield get
    cache.clear()


@pytest.fixture(scope="module")
def port_exact(scenes):
    """The port's exact judged frames (``adaptive=False``), once per view."""
    cache = {}

    def get(fmt, cam, w=W, h=H):
        key = (fmt, cam, w, h)
        if key not in cache:
            cache[key] = scenes(fmt)[1].render(_params(RenderParams, cam, w, h),
                                                w, h, adaptive=False).numpy()
        return cache[key]

    yield get
    cache.clear()


def _inputs(tsvo, cam, w=W, h=H):
    """(FrameParams, kernel tables, tile floors, frame kwargs) of a view."""
    tp = _params(RenderParams, cam, w, h)
    kw = tsvo.frame_kwargs(tp, w, h)
    fp = frame_params(mip_mode="nearest", deferred=True,
                      csvo=tsvo.buffer_dtype == np.uint8, **kw)
    tables = KernelTables(tsvo.mips, tsvo.mat_tex, tsvo.mat_params)
    return fp, tables, tsvo.beam_context(tp, w, h).tile_floors, kw


def _off(a, b):
    """(H, W) mask of the pixels of two frames more than 1e-3 apart."""
    return np.abs(np.asarray(a, np.float64)
                  - np.asarray(b, np.float64)).max(-1) > 1e-3


def _dilate(mask, r):
    """``mask`` grown by ``r`` pixels in each direction (a square)."""
    h, w = mask.shape
    pad = np.pad(mask, r)
    out = np.zeros_like(mask)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            out |= pad[dy:dy + h, dx:dx + w]
    return out


def assert_frames_close(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.mean() <= 1e-3, d.mean()
    off = (d.max(-1) > 1e-3).mean()
    assert off <= 0.01, off


def _known(jax_frames, port_exact, cam):
    """The pixels of an ESVO view where the two packages' exact judged
    frames already differ: rays the JAX deferred trace misjudges after its
    rounds, and FMA grazes."""
    return _off(jax_frames("esvo", cam, "0"), port_exact("esvo", cam))


def assert_thick_ray_budget(img, exact, levels, w=W, h=H):
    ids = adaptive.grid_pixel_ids(w, h, levels).numpy()
    np.testing.assert_array_equal(img.reshape(-1, 4)[ids],
                                  exact.reshape(-1, 4)[ids])
    d = np.abs(img.astype(np.float64) - exact)
    assert d.mean() < 0.004, d.mean()
    assert (d.max(-1) > 1e-3).mean() < 0.03


# ---- whole frames against the JAX package --------------------------------

FRAME_CONFIGS = {
    # (format, VOXELRS_HIERARCHY, width, height, cameras, grid levels);
    # the CSVO frame is tests/test_torch_csvo.py's
    "esvo-quarter": ("esvo", "1", W, H, ("overview", "canopy"), 2),
    "esvo-half": ("esvo", "0", W, H, ("overview",), 1),
}


@pytest.mark.parametrize("config", FRAME_CONFIGS)
def test_judged_frame_matches_jax(config, scenes, jax_frames, port_exact,
                                  monkeypatch):
    """ESVO at 320x240: the quarter grid (two views) and the half grid
    (``VOXELRS_HIERARCHY=0``), each against the JAX frame (``check_frame``,
    the off pixels within a cell of ``_known``)."""
    fmt, hierarchy, w, h, cams, levels = FRAME_CONFIGS[config]
    monkeypatch.setenv("VOXELRS_HIERARCHY", hierarchy)
    monkeypatch.delenv("VOXELRS_HOLE_FILL", raising=False)
    for cam in cams:
        check_frame(fmt, hierarchy, w, h, cam, levels, scenes, jax_frames,
                    port_exact, _known(jax_frames, port_exact, cam))


def check_frame(fmt, hierarchy, w, h, cam, levels, scenes, jax_frames,
                port_exact, known=None):
    """The judged adaptive frame (beams and the sun map) against the JAX
    frame (off pixels within a cell of ``known`` where given) and within
    the thick-ray budget of the port's exact judged frame."""
    tsvo = scenes(fmt)[1]
    jimg = jax_frames(fmt, cam, "1", hierarchy, w, h)
    img = tsvo.render(_params(RenderParams, cam, w, h), w, h,
                      adaptive=True).numpy()
    assert tsvo.last_frame == dict(
        mode="deferred", opaque=False, beams=True, sun=True, adaptive=True,
        hierarchy=levels - 1), tsvo.last_frame
    assert img.shape == (h, w, 4) and np.isfinite(img).all()
    assert_frames_close(img, jimg)
    if known is not None:
        assert not (_off(img, jimg) & ~_dilate(known, 1 << levels)).any()
    assert_thick_ray_budget(img, port_exact(fmt, cam, w, h), levels, w, h)


# ---- the judged trace ------------------------------------------------------

@pytest.mark.parametrize("cam", sorted(CAMS))
def test_judged_trace_matches_jax(cam, scenes, jax_frames, port_exact):
    """The port's plain judged trace of the quarter grid at W x H (from the
    pixel floors) against the JAX deferred trace on the same rays and
    floors (``check_trace``)."""
    jax_frames("esvo", cam)  # the programs at these widths
    check_trace("esvo", cam, scenes, _known(jax_frames, port_exact, cam))


def check_trace(fmt, cam, scenes, known_pixels=None):
    """The port's plain judged trace of the coarsest grid (ESVO: the
    quarter grid at W x H; CSVO: the half grid at SW x SH) against the JAX
    deferred trace: on the lanes where both accept the same value and
    face, the accepted leaf's scale, entry plane and passed flag are equal,
    and every lane's passed and inside flags; a lane may disagree only at
    ``known_pixels`` or at a voxel edge."""
    jsvo, tsvo = scenes(fmt)
    w, h, level = (W, H, 2) if fmt == "esvo" else (SW, SH, 1)
    fp, tables, tf, kw = _inputs(tsvo, cam, w, h)
    scale = float(tsvo.octree_scale)
    wl, hl = adaptive.grid_dims(w, h, level)[level]
    rec = torch.zeros((wl * hl, aj.REC_WORDS), dtype=torch.int32)
    aj.k9j_trace_plain(tsvo.world(), scale, tables, fp, tf, level, rec)
    ids = adaptive.grid_pixel_ids(w, h, level)
    ro, rd = adaptive._frame_rays(fp, ids)
    floors = pixel_floors_at(tf, ids, w)
    world = (jsvo.device_buf if fmt == "esvo" else
             (jsvo.device_buf, jnp.uint32(jsvo.root_ptr),
              jnp.int32(jsvo.depth)))
    trace = jshading._deferred_pipeline(
        w * h, w, h, True, 1000, 4,
        min(12, max(jsvo.depth, 1) + 1) if fmt == "esvo" else 12, fmt)[1]
    res, jsc, jpl, jps = trace(
        world, jnp.float32(tsvo.octree_scale), jnp.asarray(ro.numpy()),
        jnp.asarray(rd.numpy()), jnp.float32(-1.0), jsvo.mips, jsvo.mat_tex,
        tag="test-judged-trace", t_floor=jnp.asarray(floors.numpy()))
    words, fl = rec.numpy(), rec.view(torch.float32).numpy()
    jt = np.asarray(res.t)
    phit, jhit = fl[:, 0] != -1.0, jt != -1.0
    same = ((phit == jhit) & (words[:, 1].view(np.uint32)
                              == np.asarray(res.value))
            & (words[:, 2] == np.asarray(res.face_id)))
    both = phit & same
    # lanes that disagree: pixels where the exact frames differ (rounds,
    # FMA grazes; ESVO), or a ray meeting a voxel edge, where an FMA picks
    # the other face at the same distance (measured: 1 on the canopy view,
    # none on the others)
    known = (np.zeros(len(ids), bool) if known_pixels is None
             else known_pixels.reshape(-1)[ids.numpy()])
    edge = (phit & jhit & (words[:, 1].view(np.uint32)
                           == np.asarray(res.value))
            & (np.abs(fl[:, 0] - jt) <= WORLD_TOL))
    assert (known | edge)[~same].all()
    print(fmt, cam, "hit lanes", int(both.sum()), "disagreeing",
          int((~same).sum()), "passed", int((words[both, 12] != 0).sum()))
    assert both.sum() > 0.5 * len(both)
    np.testing.assert_array_equal(words[both, 10], np.asarray(jsc)[both])
    np.testing.assert_array_equal(fl[both, 11], np.asarray(jpl)[both])
    np.testing.assert_array_equal(words[:, 12] != 0, np.asarray(jps))
    np.testing.assert_array_equal(words[:, 9] != 0,
                                  np.asarray(res.inside_voxel))
    assert (words[both, 12] != 0).any()  # rays through panes and holes
    assert np.abs(fl[both, 0] - jt[both]).max() <= WORLD_TOL
    assert np.abs(fl[both, 3:6] - np.asarray(res.pos)[both]).max() \
        <= WORLD_TOL


# ---- the merge ----------------------------------------------------------------

@pytest.fixture(scope="module")
def merge_inputs(scenes):
    """The port's plain records of a view: the quarter grid traced, and
    the half grid merged from it and refined (the pixel level's input)."""
    cache = {}

    def get(cam):
        if cam not in cache:
            cache[cam] = _merge_inputs(scenes("esvo")[1], cam)
        return cache[cam]

    yield get
    cache.clear()


def _merge_inputs(tsvo, cam):
    fp, tables, tf, kw = _inputs(tsvo, cam)
    scale = float(tsvo.octree_scale)
    dims = adaptive.grid_dims(W, H, 2)
    recs = [torch.zeros((w * h, aj.REC_WORDS), dtype=torch.int32)
            for w, h in dims]
    aj.k9j_trace_plain(tsvo.world(), scale, tables, fp, tf, 2, recs[2])
    n = recs[1].shape[0]
    refine = torch.empty(n, dtype=torch.bool)
    aj.k9j_merge_plain(scale, tables, fp, 1, recs[2], recs[1], refine, False)
    ridx, rcount = compact.compact_indices_plain(refine, n)
    aj.k9j_trace_plain(tsvo.world(), scale, tables, fp, tf, 1, recs[1], ridx,
                       rcount)
    return fp, tables, kw, recs


@pytest.mark.parametrize("cam", sorted(CAMS))
@pytest.mark.parametrize("hole_fill", [False, True])
@pytest.mark.parametrize("level", [1, 0])
def test_merge_matches_jax(level, hole_fill, cam, scenes, merge_inputs):
    """The port's merge of level + 1 onto ``level`` against the JAX
    result-level merge (``_deferred_pipeline(...)[15]`` onto the half
    grid, ``[12]`` onto the pixels) on the same records."""
    jsvo, tsvo = scenes("esvo")
    fp, tables, kw, recs = merge_inputs(cam)
    lo = recs[level + 1]
    n = recs[level].shape[0]
    hi = torch.empty((n, aj.REC_WORDS), dtype=torch.int32)
    refine = torch.empty(n, dtype=torch.bool)
    aj.k9j_merge_plain(float(tsvo.octree_scale), tables, fp, level, lo, hi,
                       refine, hole_fill)

    lw, lf = lo.numpy(), lo.view(torch.float32).numpy()
    res_c = (jnp.asarray(lf[:, 0]), jnp.asarray(lw[:, 1].view(np.uint32)),
             jnp.asarray(lw[:, 2]), jnp.asarray(lf[:, 3:6]),
             jnp.asarray(lf[:, 6:8]), jnp.asarray(lf[:, 8]))
    ray_args = tuple(jnp.asarray(np.asarray(kw[k], np.float32)) for k in
                     ("cam_pos", "cam_right", "cam_up", "cam_fwd")) + (
        jnp.float32(kw["fov_y_rad"]), jnp.float32(kw["aspect"]))
    merge = jshading._deferred_pipeline(
        W * H, W, H, True, 1000, 4, min(12, max(jsvo.depth, 1) + 1),
        "esvo")[12 if level == 0 else 15]
    ((jt, jv, jf, jp, juv, jl), jhit, jins, jsc, jpl, jps, jref,
     jcount) = merge(res_c, jnp.asarray(lw[:, 10]), jnp.asarray(lf[:, 11]),
                     jnp.asarray(lw[:, 12] != 0), jnp.asarray(lw[:, 9] != 0),
                     jnp.float32(tsvo.octree_scale), ray_args, jsvo.mips,
                     jsvo.mat_tex, hole_fill)
    jhit, jref = np.asarray(jhit), np.asarray(jref)
    assert int(jcount) == int(jref.sum())

    hw, hf = hi.numpy(), hi.view(torch.float32).numpy()
    phit, pref = hf[:, 0] != -1.0, refine.numpy()
    flips = (phit != jhit) | (pref != jref)
    assert flips.mean() <= FLIP_SHARE, flips.sum()
    sample = adaptive.coarse_grid(*adaptive.grid_dims(W, H, level)[level]
                                  ).sample_masks()[0].numpy()
    filled = phit & ~sample & ~pref
    print("merge", cam, "level", level, "hole fill", hole_fill, "flips",
          int(flips.sum()), "of", n, "filled", int(filled.sum()), "refined",
          int(pref.sum()))
    assert filled.sum() > 0 and pref.sum() > 0
    both = phit & jhit & ~flips
    for got, want in ((hw[:, 1].view(np.uint32), jv), (hw[:, 2], jf),
                      (hw[:, 10], jsc), (hf[:, 11], jpl)):
        np.testing.assert_array_equal(got[both], np.asarray(want)[both])
    np.testing.assert_array_equal(hw[~flips, 12] != 0, np.asarray(jps)[~flips])
    np.testing.assert_array_equal(hw[~flips, 9] != 0, np.asarray(jins)[~flips])
    assert np.abs(hf[both, 0] - np.asarray(jt)[both]).max() <= WORLD_TOL
    assert np.abs(hf[both, 3:6] - np.asarray(jp)[both]).max() <= WORLD_TOL
    assert np.abs(hf[both, 6:8] - np.asarray(juv)[both]).max() <= UV_TOL
    assert np.abs(hf[both, 8] - np.asarray(jl)[both]).max() <= LOD_TOL


def test_hole_table_matches_jax(scenes):
    """The (V, L) hole table against the JAX merge's ``block_hole_L``
    expression (:2867-2871): water is hole-free at every mip, the glass
    panes and the leaves' holes are holes at mip 0, and the glass frame
    blends its panes away at the coarsest mips."""
    jsvo, tsvo = scenes("esvo")
    mips, mat_tex = jsvo.mips, jsvo.mat_tex
    T = mips[0].shape[0]
    layer_hole = jnp.stack([(m[..., 3] <= 0.0).any(axis=(1, 2))
                            for m in mips], axis=1)
    want = np.asarray(layer_hole[jnp.clip(mat_tex[:, 0:3], 0, T - 1)]
                      .any(axis=1))
    got = KernelTables(tsvo.mips, tsvo.mat_tex).hole.numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[C.WATER].any() and not got[C.STONE].any()
    assert got[C.GLASS, 0] and got[C.OAK_LEAVES, 0]
    assert not got[C.GLASS, -1]


# ---- the port against itself --------------------------------------------

def test_beam_variants_and_hole_fill(scenes, port_exact, monkeypatch):
    """With the sun map's certificates on its judged shadow rays, with the
    beams only (K7 / K8 floors) and without a heightfield the judged
    adaptive frame is one frame (the certificates and the floors are
    exact); with ``VOXELRS_HOLE_FILL=1`` it is the plain frame's with the
    hole fill and stays within the thick-ray budget."""
    _jsvo, tsvo = scenes("esvo")
    monkeypatch.delenv("VOXELRS_HIERARCHY", raising=False)
    monkeypatch.delenv("VOXELRS_HOLE_FILL", raising=False)
    tp = _params(RenderParams, "overview")
    ctx = tsvo.beam_context(tp, W, H)
    assert ctx.has_sun()
    frames = [tsvo.render(tp, W, H, beams=b, adaptive=True).numpy()
              for b in (ctx, ctx.without_sun(), None)]
    for f in frames[1:]:
        np.testing.assert_array_equal(f, frames[0])
    monkeypatch.setenv("VOXELRS_HOLE_FILL", "1")
    filled = tsvo.render(tp, W, H, beams=ctx, adaptive=True).numpy()
    plain = aj.render_frame_adaptive_judged_plain(
        tsvo.world(), tsvo.octree_scale, tsvo.mips, tsvo.mat_params,
        tsvo.mat_tex, **tsvo.frame_kwargs(tp, W, H), beams=ctx, levels=2,
        hole_fill=True).numpy()
    np.testing.assert_array_equal(filled, plain)
    assert_thick_ray_budget(filled, port_exact("esvo", "overview"), 2)


@pytest.mark.parametrize("level", [1, 0])
def test_hole_fill_fills_the_canopy(level, scenes, merge_inputs):
    """With the hole fill a merge fills leaf lanes whose own texel is
    opaque, which the hole table alone sends to re-trace (the half grid
    from the quarter grid, the pixels from the refined half grid)."""
    _jsvo, tsvo = scenes("esvo")
    fp, tables, _kw, recs = merge_inputs("overview")
    n = recs[level].shape[0]
    refined, leaves = {}, {}
    for fill in (False, True):
        hi = torch.empty((n, aj.REC_WORDS), dtype=torch.int32)
        ref = torch.empty(n, dtype=torch.bool)
        aj.k9j_merge_plain(float(tsvo.octree_scale), tables, fp, level,
                           recs[level + 1], hi, ref, fill)
        refined[fill] = int(ref.sum())
        leaves[fill] = int(((hi[:, 1] == C.OAK_LEAVES)
                            & (hi.view(torch.float32)[:, 0] != -1.0)).sum())
    assert refined[True] < refined[False]
    assert leaves[True] > leaves[False]


# ---- the selection rule -------------------------------------------------

def test_judged_selection_rule(monkeypatch):
    """A translucent world: adaptive by the JAX rule (from 2^18 pixels,
    ``VOXELRS_ADAPTIVE``, the keyword); the quarter grid where the
    hierarchy is at least 1 and the quarter grid has at least 4,096
    lanes, else the half grid; never the eighth grid."""
    monkeypatch.delenv("VOXELRS_ADAPTIVE", raising=False)
    monkeypatch.delenv("VOXELRS_HIERARCHY", raising=False)
    lv = adaptive.frame_levels
    assert lv(1920, 1080, False) == 2 and lv(128, 96, False) == 0
    assert lv(1920, 1080, False, False) == 0
    assert lv(W, H, False, True) == 2 and lv(SW, SH, False, True) == 1
    # the 4,096-lane gate: 252 x 252 has a 64 x 64 quarter grid
    assert adaptive.grid_dims(252, 252, 2)[2] == (64, 64)
    assert lv(252, 252, False, True) == 2
    assert adaptive.grid_dims(248, 252, 2)[2] == (63, 64)
    assert lv(248, 252, False, True) == 1
    for env, want in (("0", 1), ("-1", 1), ("1", 2), ("", 2), ("x", 2),
                      ("2", 2), ("7", 2)):
        monkeypatch.setenv("VOXELRS_HIERARCHY", env)
        assert lv(1920, 1080, False) == want, env
        assert lv(SW, SH, False, True) == 1, env
    monkeypatch.setenv("VOXELRS_ADAPTIVE", "1")
    assert lv(SW, SH, False) == 1 and lv(SW, SH, False, False) == 0
    monkeypatch.setenv("VOXELRS_ADAPTIVE", "0")
    assert lv(1920, 1080, False) == 0
