"""voxelrs_tpu_torch's adaptive thick-ray opaque frame (``ops/adaptive.py``,
the plain versions of K9 on the CPU) against voxelrs_tpu's: the grid
geometry against ``_coarse_grid_for``, the merge against
``_make_frozen_merge``, whole frames against ``Svo.render`` with
``VOXELRS_ADAPTIVE=1`` (its second render), the frame against the port's
own exact frame (the JAX package's thick-ray budget,
tests/test_render.py:162-182), the single-pass shadow branch and the
selection rule.

Tolerances. Frames against the JAX frame: the port's frame budget of
tests/test_torch_deferred.py (mean |d| <= 1e-3, at most 1% of the pixels
off by more than 1e-3), since XLA on the CPU contracts multiply-adds into
FMAs and the port does not. The merge decides fills by exact float
equalities (t_int == tcmin, equal entry planes), so the FMAs flip a few
lanes between fill and re-trace against the JAX merge on the same coarse
records: none of the 12,288 lanes on the test view flipped (measured),
bounded here at 0.5%; the synthesized t and leaf base of lanes both fill
agree within the traversal tolerances of tests/test_torch_traversal.py
(2.2e-4 / 1.8e-4 in world units). The adaptive frame against the exact
frame: the traced grid's pixels equal (the JAX test's coarse samples
with the half grid), mean |d| < 0.002, under 2% of the pixels off by
more than 1e-3; with the quarter grid a filled half-grid sample can
differ, on the same pixels as in the JAX frame. The JAX frame comes from
its second render: its first render after a change of view replays the
previous view's buckets (tests/test_torch_deferred.py).
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
from voxelrs_tpu_torch.ops import adaptive
from voxelrs_tpu_torch.world import ChunkPos as TCP
from voxelrs_tpu_torch.world import Position as TPos
from voxelrs_tpu_torch.world import csvo as tcsvo
from voxelrs_tpu_torch.world import esvo as tesvo
from voxelrs_tpu_torch.world import heightfield as thf

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 128, 96
STONE, GRASS = jcontent.STONE, jcontent.GRASS
CAMS = {
    "horizon": ([48.0, 30.0, -20.0], [0.0, -0.12, 1.0]),
    "down": ([48.0, 70.0, 48.0], [0.01, -1.0, 0.01]),
    "on-ground": ([40.0, 13.0, 40.0], [0.7, 0.05, 0.7]),
    # pitched up: about 11% of a 256x128 frame hits, under the dense
    # threshold (the single-pass shadow branch)
    "sky": ([48.0, 25.0, -10.0], [0.0, 0.25, 1.0]),
}
T_TOL, POS_TOL = 2.2e-4, 1.8e-4
FLIP_SHARE = 0.005


def _chunk(cx, cz):
    """tests/test_beams.py's terrain chunk (opaque)."""
    vox = np.zeros((32, 32, 32), np.uint32)
    x = np.arange(32) + cx * 32
    z = np.arange(32) + cz * 32
    hh = (10 + 6 * np.sin(x[:, None] * 0.11)
          + 5 * np.cos(z[None, :] * 0.17)).astype(np.int32)
    for ix in range(32):
        for iz in range(32):
            h = max(1, hh[ix, iz])
            vox[ix, : h - 1, iz] = STONE
            vox[ix, h - 1, iz] = GRASS
    return vox


def _build(fmt):
    """(JAX Svo, port Svo, JAX field, port field) of the 2 x 2 terrain."""
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
    assert tsvo.is_opaque() and jsvo.world_value_mask == tsvo.world_value_mask
    return jsvo, tsvo, jh, th


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


def assert_frames_close(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.mean() <= 1e-3, d.mean()
    off = (d.max(-1) > 1e-3).mean()
    assert off <= 0.01, off


def assert_thick_ray_budget(adaptive_img, exact, levels, w=W, h=H):
    """tests/test_render.py:162-182: the traced samples equal, a tight mean,
    few pixels off. The samples are the pixels of the coarsest grid, the
    one the frame traces: with the half grid (tests/test_render.py's
    VOXELRS_HIERARCHY=0, "flat path: samples trace") the even coordinates
    and the last row and column; above it a half-grid lane can be a fill,
    which a feature smaller than a cell makes wrong in both packages
    (``test_hierarchy_fills_half_grid_samples_as_jax``)."""
    ids = adaptive.grid_pixel_ids(w, h, levels).numpy()
    np.testing.assert_array_equal(adaptive_img.reshape(-1, 4)[ids],
                                  exact.reshape(-1, 4)[ids])
    d = np.abs(adaptive_img.astype(np.float64) - exact)
    assert d.mean() < 0.002, d.mean()
    assert (d.max(-1) > 1e-3).mean() < 0.02


# ---- grid geometry ------------------------------------------------------

@pytest.mark.parametrize("w,h", [(8, 6), (9, 7), (67, 45), (128, 96)])
def test_grid_geometry_matches_jax(w, h):
    hc, wc, ids_fn, up4_fn, masks_fn, pick_fn = jshading._coarse_grid_for(w, h)
    g = adaptive.coarse_grid(w, h)
    assert (g.hc, g.wc) == (hc, wc)
    np.testing.assert_array_equal(g.ids.numpy(), np.asarray(ids_fn()))
    # the half grid's pixel ids are level 1 of the port's grid chain
    np.testing.assert_array_equal(adaptive.grid_pixel_ids(w, h, 1).numpy(),
                                  np.asarray(ids_fn()))
    a = np.arange(hc * wc, dtype=np.int32)
    a2 = np.stack([a, 2 * a + 1], 1)
    for src in (a, a2):
        for pu, ju in zip(g.up4(torch.from_numpy(src)),
                          up4_fn(jnp.asarray(src))):
            np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    masks = g.sample_masks()
    for pm, jm in zip(masks, masks_fn()):
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    corners = g.up4(torch.from_numpy(a))
    np.testing.assert_array_equal(
        g.pick_sample(masks[1], masks[2], *corners).numpy(),
        np.asarray(pick_fn(masks_fn()[1], masks_fn()[2],
                           *up4_fn(jnp.asarray(a)))))
    # the quarter grid: the half grid's own half grid, composed
    _hq, _wq, q_in_c, *_ = jshading._coarse_grid_for(wc, hc)
    np.testing.assert_array_equal(adaptive.grid_pixel_ids(w, h, 2).numpy(),
                                  np.asarray(ids_fn())[np.asarray(q_in_c())])
    # pixel_rays is generate_rays bit for bit
    from voxelrs_tpu_torch.ops.shading import generate_rays

    cam = [torch.tensor(v, dtype=torch.float32) for v in
           ([1.0, 2.0, 3.0], [0.8, 0.0, -0.6], [0.0, 1.0, 0.0],
            [0.6, 0.0, 0.8])]
    ro, rd = generate_rays(w, h, *cam, 0.7002075, w / h)
    ids = torch.arange(w * h)
    pro, prd = adaptive.pixel_rays(ids, w, h, *cam, 0.7002075, w / h)
    assert torch.equal(ro, pro) and torch.equal(rd, prd)


# ---- the merge ------------------------------------------------------------

def test_merge_matches_jax(scenes):
    """The port's merge (half grid onto the pixels) against the JAX merge,
    both fed the port's plain trace of the half grid."""
    jsvo, tsvo, _jh, _th = scenes("esvo")
    p = _params(RenderParams, "horizon")
    kw = tsvo.frame_kwargs(p, W, H)
    from voxelrs_tpu_torch.ops.shading import frame_params

    fp = frame_params(mip_mode="nearest", deferred=True, **kw)
    scale = float(tsvo.octree_scale)
    hc, wc = adaptive.grid_dims(W, H, 1)[1][::-1]
    lo = torch.zeros((hc * wc, adaptive.REC_WORDS), dtype=torch.int32)
    adaptive.k9_trace_plain(tsvo.world(), scale, fp, None, 1, lo)
    hi = torch.empty((W * H, adaptive.REC_WORDS), dtype=torch.int32)
    refine = torch.empty(W * H, dtype=torch.bool)
    adaptive.k9_merge_plain(scale, fp, 0, lo, hi, refine)

    # the same coarse state as the JAX frozen record
    fl = lo.view(torch.float32).numpy()
    words = lo.numpy().view(np.uint32)
    zero = jnp.zeros(hc * wc, jnp.uint32)
    frozen_c = (jnp.asarray(fl[:, 0]), zero, jnp.asarray(words[:, 1]),
                jnp.asarray(fl[:, 2]), jnp.asarray(fl[:, 3]),
                jnp.asarray(fl[:, 4]), zero)
    hit_c = jnp.asarray((words[:, 6] & 1) != 0)
    ray_args = tuple(jnp.asarray(np.asarray(kw[k], np.float32)) for k in
                     ("cam_pos", "cam_right", "cam_up", "cam_fwd")) + (
        jnp.float32(kw["fov_y_rad"]), jnp.float32(kw["aspect"]))
    merge = jshading._opaque_pipeline(W * H, W, H, 1000, 12, "esvo")[10]
    outs, jhit, jknown, jval, jrefine, jcount = merge(
        jsvo.device_buf, frozen_c, hit_c, jnp.float32(tsvo.octree_scale),
        ray_args, jnp.ones(hc * wc, bool), jnp.asarray(words[:, 5]))
    jhit, jknown, jrefine = (np.asarray(a) for a in (jhit, jknown, jrefine))
    assert int(jcount) == int(jrefine.sum())

    hw = hi.numpy().view(np.uint32)
    phit = (hw[:, 6] & 1) != 0
    prefine = refine.numpy()
    pknown = phit & ~prefine
    flips = (phit != jhit) | (prefine != jrefine) | (pknown != jknown)
    assert flips.mean() <= FLIP_SHARE, flips.sum()
    sample = adaptive.coarse_grid(W, H).sample_masks()[0].numpy()
    assert prefine.sum() > 0 and (phit & ~sample & ~prefine).sum() > 0
    print("merge: flips", int(flips.sum()), "filled",
          int((phit & ~sample & ~prefine).sum()), "refined",
          int(prefine.sum()))
    both = pknown & jknown
    np.testing.assert_array_equal(hw[both, 5], np.asarray(jval)[both])
    # synthesized (and copied) t and leaf base, in world units
    hf = hi.view(torch.float32).numpy()
    jt = np.asarray(outs[0])
    assert np.abs(hf[both, 0] - jt[both]).max() / scale <= T_TOL
    for k in range(3):
        jp = np.asarray(outs[3 + k])
        assert np.abs(hf[both, 2 + k] - jp[both]).max() / scale <= POS_TOL


# ---- whole frames against the JAX package --------------------------------

@pytest.fixture(scope="module")
def jax_frames():
    """JAX adaptive frames, each rendered once per view and configuration
    (its second render)."""
    cache = {}

    def get(jsvo, jh, cam, hierarchy, sun, beams, w=W, h=H, adaptive="1"):
        key = (id(jsvo), cam, hierarchy, sun, beams, w, h, adaptive)
        if key not in cache:
            mp = pytest.MonkeyPatch()
            try:
                mp.setenv("VOXELRS_ADAPTIVE", adaptive)
                mp.setenv("VOXELRS_HIERARCHY", hierarchy)
                if not sun:
                    mp.setenv("VOXELRS_SUN", "0")
                jsvo.set_heightfield(jh if beams else None)
                jp = _params(JRenderParams, cam, w, h)
                jsvo.render(jp, w, h)  # settles the replayed buckets
                cache[key] = np.asarray(jsvo.render(jp, w, h))
            finally:
                jsvo.set_heightfield(None)
                mp.undo()
        return cache[key]

    yield get
    cache.clear()


FRAME_CONFIGS = {
    # (format, VOXELRS_HIERARCHY, beams, sun map)
    "esvo-quarter-beams-sun": ("esvo", "1", True, True),
    "esvo-half-no-heightfield": ("esvo", "0", False, False),
    "csvo-quarter-beams": ("csvo", "1", True, False),
}


# test_adaptive_frame_matches_jax's case run in
# tests/test_torch_adaptive_budget.py (with
# test_adaptive_frame_within_the_thick_ray_budget), on the same scenes and
# checks, so that two workers share this file's JAX compiles
BUDGET_FILE_CONFIGS = ["csvo-quarter-beams"]


@pytest.mark.parametrize("config", [c for c in FRAME_CONFIGS
                                    if c not in BUDGET_FILE_CONFIGS])
def test_adaptive_frame_matches_jax(config, scenes, jax_frames, monkeypatch):
    check_adaptive_frame_matches_jax(config, scenes, jax_frames, monkeypatch)


def check_adaptive_frame_matches_jax(config, scenes, jax_frames,
                                     monkeypatch):
    """test_adaptive_frame_matches_jax's checks of one configuration."""
    fmt, hierarchy, beams, sun = FRAME_CONFIGS[config]
    jsvo, tsvo, jh, th = scenes(fmt)
    monkeypatch.setenv("VOXELRS_HIERARCHY", hierarchy)
    for cam in ("horizon", "down"):
        jimg = jax_frames(jsvo, jh, cam, hierarchy, sun, beams)
        tp = _params(RenderParams, cam)
        tsvo.set_heightfield(th if beams else None)
        try:
            ctx = tsvo.beam_context(tp, W, H) if beams else None
            if ctx is not None and not sun:
                ctx = ctx.without_sun()
            img = tsvo.render(tp, W, H, beams=ctx, adaptive=True).numpy()
        finally:
            tsvo.set_heightfield(None)
        assert tsvo.last_frame == dict(
            mode="deferred", opaque=True, beams=beams, sun=sun,
            adaptive=True, hierarchy=int(hierarchy)), tsvo.last_frame
        assert img.shape == (H, W, 4) and np.isfinite(img).all()
        assert_frames_close(img, jimg)


def test_single_pass_shadow_branch_matches_jax(scenes, jax_frames):
    """A 256x128 frame with about 11% of its pixels hit: under the dense
    threshold (16.2% there), so the shadow rays take the single pass, as
    in the JAX frame; with the beams and the sun map."""
    w, h = 256, 128
    jsvo, tsvo, jh, th = scenes("esvo")
    tp = _params(RenderParams, "sky", w, h)
    exact = tsvo.render(tp, w, h, adaptive=False).numpy()
    from voxelrs_tpu_torch.ops.shading import sky_color

    kw = tsvo.frame_kwargs(tp, w, h)
    hits = int(np.abs(exact - sky_color(_rays(kw, w, h)).reshape(
        h, w, 4).numpy()).max(-1).astype(bool).sum())
    assert 0.05 * w * h < hits < 0.162 * w * h
    assert not adaptive.dense_frame(hits, w * h)
    assert adaptive.dense_frame(5292, w * h)
    assert not adaptive.dense_frame(5291, w * h)
    tsvo.set_heightfield(th)
    try:
        img = tsvo.render(tp, w, h, adaptive=True).numpy()
        assert tsvo.last_frame["sun"] and tsvo.last_frame["adaptive"]
    finally:
        tsvo.set_heightfield(None)
    assert_frames_close(img, jax_frames(jsvo, jh, "sky", "1", True, True,
                                        w, h))
    assert_thick_ray_budget(img, exact, 2, w, h)


def test_hierarchy_fills_half_grid_samples_as_jax(scenes, jax_frames):
    """With the quarter grid (hierarchy 1) a half-grid lane between four
    agreeing quarter samples is filled, not traced: a surface step smaller
    than the cell makes the fill wrong there, so the adaptive frame can
    differ from the exact one on a half-grid sample pixel. The JAX frame
    does so on the same pixels (256x128, looking down; beams and sun)."""
    w, h = 256, 128
    jsvo, tsvo, jh, th = scenes("esvo")
    tp = _params(RenderParams, "down", w, h)
    tsvo.set_heightfield(th)
    try:
        pad = tsvo.render(tp, w, h, adaptive=True).numpy()
        pex = tsvo.render(tp, w, h, adaptive=False).numpy()
    finally:
        tsvo.set_heightfield(None)
    jad = jax_frames(jsvo, jh, "down", "1", True, True, w, h)
    jex = jax_frames(jsvo, jh, "down", "1", True, True, w, h, adaptive="0")
    ids = adaptive.grid_pixel_ids(w, h, 1).numpy()

    def off_samples(a, e):
        return np.flatnonzero((a.reshape(-1, 4)[ids]
                               != e.reshape(-1, 4)[ids]).any(-1))

    port, jax = off_samples(pad, pex), off_samples(jad, jex)
    assert port.size > 0
    np.testing.assert_array_equal(port, jax)
    assert_thick_ray_budget(pad, pex, 2, w, h)


def _rays(kw, w, h):
    from voxelrs_tpu_torch.ops.shading import (_vec3, generate_rays,
                                               tan_half_fov)

    return generate_rays(w, h, *(_vec3(kw[k], "cpu") for k in
                                 ("cam_pos", "cam_right", "cam_up",
                                  "cam_fwd")),
                         tan_half_fov(kw["fov_y_rad"]),
                         float(np.float32(kw["aspect"])))[1]


# ---- the port against itself ------------------------------------------
# (test_adaptive_frame_within_the_thick_ray_budget: in
# tests/test_torch_adaptive_budget.py)

def test_adaptive_frame_without_shadows(scenes):
    """Without shadows the adaptive frame skips both shadow passes and
    stays within the thick-ray budget of the exact frame."""
    _jsvo, tsvo, _jh, th = scenes("esvo")
    tp = _params(RenderParams, "on-ground")
    tp.render_shadows = False
    exact = tsvo.render(tp, W, H, adaptive=False).numpy()
    tsvo.set_heightfield(th)
    try:
        img = tsvo.render(tp, W, H, adaptive=True).numpy()
        assert tsvo.last_frame["adaptive"] and tsvo.last_frame["beams"]
    finally:
        tsvo.set_heightfield(None)
    assert_thick_ray_budget(img, exact, 2)
    shadowed = tsvo.render(_params(RenderParams, "on-ground"), W, H,
                           adaptive=True).numpy()
    assert np.abs(shadowed - img).max() > 0.1


# ---- the selection rule -------------------------------------------------

def test_selection_rule(monkeypatch):
    monkeypatch.delenv("VOXELRS_ADAPTIVE", raising=False)
    monkeypatch.delenv("VOXELRS_HIERARCHY", raising=False)
    lv = adaptive.adaptive_levels
    # the 2^18 gate and the > 4 gates
    assert lv(1920, 1080) == 2 and lv(512, 512) == 2
    assert lv(511, 512) == 0 and lv(128, 96) == 0
    assert lv(4, 1 << 16) == 0 and lv(1 << 16, 4) == 0
    assert lv(5, 52429) == 2
    # the keyword pins it
    assert lv(128, 96, True) == 2 and lv(1920, 1080, False) == 0
    # VOXELRS_ADAPTIVE: an integer, as in the JAX package
    monkeypatch.setenv("VOXELRS_ADAPTIVE", "0")
    assert lv(1920, 1080) == 0 and lv(128, 96, True) == 2
    monkeypatch.setenv("VOXELRS_ADAPTIVE", "2")
    assert lv(8, 6) == 2
    monkeypatch.setenv("VOXELRS_ADAPTIVE", "yes")
    with pytest.raises(ValueError):
        lv(1920, 1080)
    monkeypatch.delenv("VOXELRS_ADAPTIVE")
    # VOXELRS_HIERARCHY: 0 the half grid, 1 the quarter grid, 2 the eighth
    # grid from 4,096 quarter lanes; unset or unparsable: 1
    for env, want in (("0", 1), ("-1", 1), ("1", 2), ("", 2), ("x", 2),
                      ("2", 3), ("7", 3)):
        monkeypatch.setenv("VOXELRS_HIERARCHY", env)
        assert lv(1920, 1080) == want, env
    monkeypatch.setenv("VOXELRS_HIERARCHY", "2")
    assert adaptive.grid_dims(256, 256, 2)[2] == (65, 65)  # 4,225 lanes
    assert lv(256, 256, True) == 3 and lv(256, 200, True) == 2
    assert adaptive.frame_levels(1920, 1080, False) == 2
    monkeypatch.delenv("VOXELRS_HIERARCHY")
    # a translucent world takes the JAX judged rule: the quarter grid from
    # 4,096 quarter lanes (1080p), else the half grid (128x96), never the
    # eighth grid; adaptive=False keeps the exact judged frame
    assert adaptive.frame_levels(1920, 1080, False) == 2
    assert adaptive.frame_levels(1920, 1080, False, True) == 2
    assert adaptive.frame_levels(1920, 1080, False, False) == 0
    monkeypatch.setenv("VOXELRS_ADAPTIVE", "1")
    assert adaptive.frame_levels(128, 96, False) == 1
    assert adaptive.frame_levels(128, 96, False, False) == 0
    # the dense test is JAX's first-frame bucket rule
    from voxelrs_tpu.ops.shading import _margin_bucket

    B = 1920 * 1080
    for c in (0, 100, 8191, 349355, 349356, 400000, B):
        assert adaptive.dense_frame(c, B) == (_margin_bucket(c) >= B // 3), c
    assert adaptive.dense_frame(349356, B) and not adaptive.dense_frame(
        349355, B)
    assert all(adaptive.dense_frame(c, 24578) for c in (0, 1, 100))


def test_render_frame_deferred_choice_is_svo_render_choice(scenes,
                                                           monkeypatch):
    """``render_frame_deferred(adaptive=)`` draws the frame that
    ``Svo.render`` draws and records in ``last_frame``: the rule at this
    size (the exact frame), each pin, and the hierarchy from the
    environment."""
    from voxelrs_tpu_torch.ops.shading import render_frame_deferred

    monkeypatch.delenv("VOXELRS_ADAPTIVE", raising=False)
    monkeypatch.delenv("VOXELRS_HIERARCHY", raising=False)
    _jsvo, tsvo, _jh, _th = scenes("esvo")
    w, h = 32, 24
    tp = _params(RenderParams, "horizon", w, h)
    kw = tsvo.frame_kwargs(tp, w, h)
    frames = {}
    for pin, env, want in ((None, None, (False, None)),
                           (False, None, (False, None)),
                           (True, None, (True, 1)),
                           (True, "0", (True, 0))):
        if env is not None:
            monkeypatch.setenv("VOXELRS_HIERARCHY", env)
        img = tsvo.render(tp, w, h, beams=None, adaptive=pin).numpy()
        lf = tsvo.last_frame
        assert (lf["adaptive"], lf["hierarchy"]) == want, (pin, env)
        ref = render_frame_deferred(
            tsvo.world(), tsvo.octree_scale, tsvo.mips, tsvo.mat_params,
            tsvo.mat_tex, **kw, opaque=True, adaptive=pin).numpy()
        np.testing.assert_array_equal(img, ref)
        frames[(pin, env)] = img
    np.testing.assert_array_equal(frames[(None, None)], frames[(False, None)])
