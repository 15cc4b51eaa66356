"""The shadow stage's plain version (``ops.shading.kd_shadow_plain``, the
function of the ``kd_shadow`` kernel on the same arguments) against
voxelrs_tpu's ``intersect_octree``: shadow rays toward the frame's light
from points just above the top faces of tests/test_torch_deferred.py's
opaque terrain (opaque rays, alpha mode 0) and glass-tower terrain
(judged rays, alpha mode 1; a quarter of the points around the tower),
ESVO, from a seed. The port's slots are traced unfloored, from K7's floors
(the scene's heightfield, beams without the sun map) and as a sub-list
(``tidx``); the JAX rays unfloored, since the floors are exact restarts (a
floored ray hits what the unfloored one hits; test_beams.py:282-336).

Tolerance: the hit flags of the traced slots equal the JAX hits (t >= 0)
but for rays that graze a voxel edge, which XLA's CPU FMAs can send into
the voxel in one package and past it in the other: at most GRAZE_SHARE of
the rays (measured on these rays: none). Slots outside the count keep
their values.

The finishing stage's plain version (``ops.shading.kd_finish_plain``, the
function of the ``kd_finish`` kernel on the same arguments), fed the plain
deferred stages' own intermediates (``deferred_stages_plain``) in the
card's layout — lists of the frame's size whose slots past the count hold
other candidates, all of them blocked — turns the shading stage's image
into ``render_frame_deferred_plain``'s bit for bit (that frame is held to
the JAX frame by tests/test_torch_deferred.py), on the opaque terrain
with every candidate traced from K7's floors, and with the sun map's
certificates (``blk``/``todo``) and the pixel-space verdicts (``blkp``).
"""

import numpy as np
import pytest
import torch

from voxelrs_tpu.ops.shading import make_alpha_fn as jmake_alpha_fn
from voxelrs_tpu.ops.traversal import intersect_octree as jintersect
from voxelrs_tpu_torch.ops import shading

from test_torch_deferred import (W, H, RenderParams, _get, _params,
                                 _terrain_chunk)

RAYS = 1024
# the share of rays whose flags may differ (FMA grazes)
GRAZE_SHARE = 0.005


def _origins(n_chunks, glass, seed=5):
    """(RAYS, 3) float32 points 0.001 above the top face of random columns
    of the scene's n_chunks x n_chunks terrain (a quarter around the glass
    tower of chunk (1, 1) where ``glass``)."""
    g = np.random.default_rng(seed)
    tops = np.zeros((32 * n_chunks, 32 * n_chunks), np.int64)
    for cx in range(n_chunks):
        for cz in range(n_chunks):
            vox = _terrain_chunk(cx, cz, glass and cx == cz == 1)
            solid = vox != 0
            top = 32 - np.argmax(solid[:, ::-1, :], axis=1)
            tops[32 * cx:32 * cx + 32, 32 * cz:32 * cz + 32] = top
    xz = g.integers(0, 32 * n_chunks, (RAYS, 2))
    if glass:
        xz[: RAYS // 4] = g.integers(36, 56, (RAYS // 4, 2))
    uv = g.uniform(0.05, 0.95, (RAYS, 2))
    y = tops[xz[:, 0], xz[:, 1]] + 0.001
    return np.stack([xz[:, 0] + uv[:, 0], y, xz[:, 1] + uv[:, 1]],
                    1).astype(np.float32)


@pytest.mark.parametrize("scene", ["opaque", "glass"])
def test_kd_shadow_plain_matches_jax_hits(scene):
    jsvo, tsvo, _jh, th = _get(scene)
    judged = scene == "glass"
    tp = _params(RenderParams, "horizon")
    fp = shading.frame_params(mip_mode="nearest", deferred=True,
                              **tsvo.frame_kwargs(tp, W, H))
    sro = torch.from_numpy(_origins(3 if judged else 2, judged))
    light = np.asarray(fp.light_dir, np.float32)
    jres = jintersect(
        jsvo.device_buf, jsvo.octree_scale, sro.numpy(),
        np.broadcast_to(-light, (RAYS, 3)).copy(), -1.0, judged,
        jmake_alpha_fn(jsvo.mips, jsvo.mat_tex) if judged else None,
        max_steps=1000)
    jhit = np.asarray(jres.t) >= 0
    assert 0.05 < jhit.mean() < 0.95
    tsvo.set_heightfield(th)
    try:
        ctx = tsvo.beam_context(tp, W, H).without_sun()
    finally:
        tsvo.set_heightfield(None)
    sidx = torch.arange(RAYS, dtype=torch.int32)
    scount = torch.tensor([RAYS], dtype=torch.int32)
    floors = ctx.shadow_ray_floors(sro, None, -light, idx=sidx, count=scount)
    assert bool((floors > 0).any())
    sub = np.flatnonzero(np.random.default_rng(3).random(RAYS) < 0.3)
    tidx = torch.zeros(RAYS, dtype=torch.int32)
    tidx[: sub.shape[0]] = torch.from_numpy(sub.astype(np.int32))
    tcount = torch.tensor([sub.shape[0]], dtype=torch.int32)
    args = (tsvo.world(), float(tsvo.octree_scale), tsvo.kernel_tables(), fp,
            int(judged), sro, sidx, scount)
    for name, extra, slots in (("unfloored", (None, None, None),
                                np.arange(RAYS)),
                               ("floored", (None, None, floors),
                                np.arange(RAYS)),
                               ("sub-list", (tidx, tcount, None), sub)):
        traced = torch.full((RAYS,), 2, dtype=torch.uint8)
        shading.kd_shadow_plain(*args, *extra, traced)
        t = traced.numpy()
        assert (np.delete(t, slots) == 2).all(), name
        off = (t[slots] == 1) != jhit[slots]
        assert off.mean() <= GRAZE_SHARE, (name, int(off.sum()))
    if judged:
        # some rays pass the tower's glass: an opaque cast stops there
        cast = torch.zeros(RAYS, dtype=torch.uint8)
        shading.kd_shadow_plain(*args[:4], 0, *args[5:], None, None, None,
                                cast)
        assert ((cast.numpy() == 1) != jhit).any()


@pytest.mark.parametrize("case", ["traced", "certified"])
def test_kd_finish_plain_reproduces_the_plain_frame(case):
    _jsvo, tsvo, _jh, th = _get("opaque")
    tp = _params(RenderParams, "horizon")
    tsvo.set_heightfield(th)
    try:
        ctx = tsvo.beam_context(tp, W, H)
    finally:
        tsvo.set_heightfield(None)
    certified = case == "certified"
    assert ctx.has_sun()
    kw = dict(tsvo.frame_kwargs(tp, W, H), opaque=True, mip_mode="nearest",
              beams=ctx if certified else ctx.without_sun())
    args = (tsvo.world(), float(tsvo.octree_scale), tsvo.mips,
            tsvo.mat_params, tsvo.mat_tex)
    st = shading.deferred_stages_plain(*args, **kw)
    ref = shading.render_frame_deferred_plain(*args, **kw)
    assert (st.blk is not None) == certified
    B, k, m = W * H, st.hidx.shape[0], st.sidx.shape[0]
    blocked = (st.traced if st.blk is None
               else st.blk | (st.todo & st.traced))
    assert 0 < int(blocked.sum()) < m < k
    fp = shading.frame_params(mip_mode="nearest", deferred=True,
                              **tsvo.frame_kwargs(tp, W, H))
    # the card's layout: B slots a list; past the counts other lanes
    g = np.random.default_rng(11)
    hidx = torch.from_numpy(g.integers(0, B, B).astype(np.int32))
    hidx[:k] = st.hidx.to(torch.int32)
    color = torch.from_numpy(g.random((B, 4), np.float32))
    color[:k] = st.color
    ds = torch.from_numpy(g.random(B, np.float32))
    ds[:k] = st.ds
    sidx = torch.from_numpy(g.integers(0, k, B).astype(np.int32))
    sidx[:m] = st.sidx.to(torch.int32)
    scount = torch.tensor([m], dtype=torch.int32)
    flags = [torch.ones(B, dtype=torch.bool) for _ in range(3)]
    for f, v in zip(flags, (st.traced, st.blk, st.todo)):
        if v is not None:
            f[:m] = v
    traced, blk, todo = flags
    if not certified:
        blk = todo = None
    # the shading stage's image: the primary stage's sky, each hit lane in
    # full light
    light = torch.clamp(fp.ambient + st.ds, 0.0, 1.0)
    img = st.sky.clone()
    img[st.hidx] = torch.cat([st.color[:, :3] * light[:, None],
                              st.color[:, 3:4]], dim=-1)
    img = img.reshape(H, W, 4)
    blkp = None
    if certified:
        blkp = torch.full((B,), 7, dtype=torch.uint8)
    out = shading.kd_finish_plain(fp, hidx, sidx, scount, color, ds, blk,
                                  todo, traced, img, blkp)
    assert out is img
    assert torch.equal(img.view(torch.int32), ref.view(torch.int32))
    if certified:
        px = st.hidx[st.sidx]
        assert torch.equal(blkp[px], blocked.to(torch.uint8))
        rest = torch.ones(B, dtype=torch.bool)
        rest[px] = False
        assert bool((blkp[rest] == 7).all())
