"""voxelrs_tpu_torch's pose batch (``Svo.render_batch``,
``ops.shading.render_frames_opaque_batch``, K10's plain versions on the
CPU) against voxelrs_tpu's ``Svo.render_batch`` on the scene and poses of
tests/test_render.py:512-547 (128x96, three poses, ``max_steps`` 300; the
JAX singles rendered twice first to record its plans, as that test does),
against the port's own per-pose ``render``, the batch's ``None`` cases,
``systems/worldsvo.py``'s camera conversion, the refusal of a batch past
32-bit offsets and the batched plain versions of K6 and K9 against their
per-pose runs.

Tolerances. The adaptive branch (``VOXELRS_ADAPTIVE=1``,
``VOXELRS_HIERARCHY=0``) against the JAX batch: the frame budget of
tests/test_torch_adaptive.py (mean |d| <= 1e-3, at most 1% of the pixels
off by more than 1e-3); the exact branch (``VOXELRS_ADAPTIVE=0``): mean
|d| <= 4.5e-5, tests/test_torch_render.py's measured bound. XLA on the
CPU contracts multiply-adds into FMAs and the port does not, so a ray that
grazes an edge can land on the neighbouring voxel. The port's batch
against its own per-pose frames, and the batched plain versions against
their per-pose runs: equal bit for bit (the same operations).

Each test runs with one torch thread (``one_torch_thread``,
tests/torch_threads.py) and clears the JAX package's whole-frame
program caches first: their keys do not hold ``VOXELRS_ADAPTIVE``, so a
program traced under one branch would serve the other.
"""

import numpy as np
import pytest
import torch

from voxelrs_tpu.gamelogic import content as jcontent
from voxelrs_tpu.graphics.svo import RenderParams as JRenderParams
from voxelrs_tpu.graphics.svo import Svo as JSvo
from voxelrs_tpu.ops import shading as jshading
from voxelrs_tpu.systems import worldsvo as jworldsvo
from voxelrs_tpu.world import ChunkPos, Position
from voxelrs_tpu.world import heightfield as jhf
from voxelrs_tpu.world.csvo import Csvo as JCsvo
from voxelrs_tpu.world.csvo import CsvoSerializedChunk as JCsvoChunk
from voxelrs_tpu.world.esvo import Esvo as JEsvo
from voxelrs_tpu.world.esvo import SerializedChunk as JChunk
from voxelrs_tpu_torch import _build
from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.graphics.svo import RenderParams, Svo
from voxelrs_tpu_torch.ops import adaptive, compact, shading
from voxelrs_tpu_torch.systems import worldsvo as tworldsvo
from voxelrs_tpu_torch.world import ChunkPos as TCP
from voxelrs_tpu_torch.world import Position as TPos
from voxelrs_tpu_torch.world import csvo as tcsvo
from voxelrs_tpu_torch.world import esvo as tesvo
from voxelrs_tpu_torch.world import heightfield as thf

from torch_threads import one_torch_thread  # noqa: F401

W, H = 128, 96
STEPS = 300


def _voxels(glass: bool = False):
    """tests/test_render.py's chunk: stone, grass and a little tower (with
    ``glass``, a glass block on it)."""
    vox = np.zeros((32, 32, 32), np.uint32)
    vox[:, :8, :] = jcontent.STONE
    vox[:, 8, :] = jcontent.GRASS
    vox[10:14, 9:12, 10:14] = jcontent.STONE
    if glass:
        vox[11, 12, 11] = jcontent.GLASS
    return vox


def _build_pair(fmt: str = "esvo", glass: bool = False):
    """(JAX Svo, port Svo on the CPU, JAX field, port field) of the chunk."""
    dtype = np.uint32 if fmt == "esvo" else np.uint8
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=4, buffer_dtype=dtype)
    tsvo = Svo(content.new_registry(), capacity_mb=4, buffer_dtype=dtype,
               device="cpu")
    vox = _voxels(glass)
    jw, tw = (JEsvo(), tesvo.Esvo()) if fmt == "esvo" else (JCsvo(),
                                                          tcsvo.Csvo())
    jc, tc = ((JChunk, tesvo.SerializedChunk) if fmt == "esvo"
              else (JCsvoChunk, tcsvo.CsvoSerializedChunk))
    jw.set_leaf(Position(0, 0, 0), jc.from_voxels(ChunkPos(0, 0, 0), vox, 5),
                True)
    tw.set_leaf(TPos(0, 0, 0), tc.from_voxels(TCP(0, 0, 0), vox, 5), True)
    jw.serialize()
    tw.serialize()
    jsvo.update(jw)
    tsvo.update(tw)
    lut = jhf.opaque_lut_from_mask(jsvo.translucent_block_mask)
    jh, th = jhf.HeightField(), thf.HeightField()
    for hf in (jh, th):
        hf.set_chunk((0, 0, 0), jhf.chunk_column_tops(vox, 5),
                     vtops=jhf.chunk_voxel_tops(vox, 5),
                     sbase=jhf.chunk_solid_bases(vox, 5, lut))
    return jsvo, tsvo, jh, th


@pytest.fixture(scope="module")
def scene():
    return _build_pair()


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _poses(cls):
    """tests/test_render.py:521-526's three poses."""
    fwd = np.array([0.5, -0.5, 0.7], np.float32)
    fwd /= np.linalg.norm(fwd)
    out = []
    for i in range(3):
        out.append(cls(cam_pos=np.array([2.0, 20.0, -4.0], np.float32)
                       + np.array([1.5 * i, 0.0, 1.0 * i], np.float32),
                       cam_fwd=fwd, aspect_ratio=W / H,
                       fov_y_rad=np.radians(70.0), render_shadows=True,
                       shadow_distance=100.0, ambient_intensity=0.3))
    return out


def assert_frames_close(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.mean() <= 1e-3, d.mean()
    off = (d.max(-1) > 1e-3).mean()
    assert off <= 0.01, off


BRANCHES = {
    # name: (VOXELRS_ADAPTIVE, heightfield and shared sun map)
    "adaptive": ("1", False),
    "exact": ("0", False),
    "adaptive-heightfield": ("1", True),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_batch_matches_jax(scene, branch, monkeypatch):
    env, with_hf = BRANCHES[branch]
    jsvo, tsvo, jh, th = scene
    for k, v in (("VOXELRS_ADAPTIVE", env), ("VOXELRS_HIERARCHY", "0"),
                 ("VOXELRS_FUSED_FRAME", "1"), ("VOXELRS_FUSED_REPLAY", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jshading, "_FUSED_FRAME_CACHE", {})
    monkeypatch.setattr(jshading, "_BATCH_FRAME_CACHE", {})
    jsvo.set_heightfield(jh if with_hf else None)
    tsvo.set_heightfield(th if with_hf else None)
    try:
        jposes, tposes = _poses(JRenderParams), _poses(RenderParams)
        for _ in range(2):  # record the JAX plans (sync, then replay)
            for p in jposes:
                np.asarray(jsvo.render(p, W, H, max_steps=STEPS))
        jbatch = jsvo.render_batch(jposes, W, H, max_steps=STEPS)
        assert jbatch is not None, "the JAX batch did not run"
        jbatch = np.asarray(jbatch)
        tbatch = tsvo.render_batch(tposes, W, H, max_steps=STEPS)
        assert tsvo.last_frame["adaptive"] == (env == "1")
        assert tsvo.last_frame["beams"] == tsvo.last_frame["sun"] == with_hf
        sun0 = (tsvo.beam_context(tposes[0], W, H)._sun if with_hf
                else None)
    finally:
        jsvo.set_heightfield(None)
        tsvo.set_heightfield(None)
    assert tuple(tbatch.shape) == jbatch.shape == (3, H, W, 4)
    for i, p in enumerate(tposes):
        if env == "1":
            assert_frames_close(tbatch[i].numpy(), jbatch[i])
        else:
            d = np.abs(tbatch[i].numpy().astype(np.float64) - jbatch[i])
            assert d.mean() <= 4.5e-5, (i, d.mean())
        # the port's batch is its per-pose frame given pose 0's sun map
        tsvo.set_heightfield(th if with_hf else None)
        try:
            beams = (tsvo.beam_context(p, W, H, shared_sun=sun0) if with_hf
                     else None)
            single = tsvo.render(p, W, H, max_steps=STEPS, beams=beams)
        finally:
            tsvo.set_heightfield(None)
        assert torch.equal(tbatch[i], single), i


def test_batch_is_none_where_jax_gives_none(scene, monkeypatch):
    """A CSVO buffer, a world with a translucent block and beams missing
    for a later pose: None in both packages."""
    monkeypatch.setenv("VOXELRS_FUSED_FRAME", "1")
    jposes, tposes = _poses(JRenderParams), _poses(RenderParams)
    for fmt, glass in (("csvo", False), ("esvo", True)):
        jc, tc, _jh, _th = _build_pair(fmt, glass)
        assert tc.is_opaque() == (not glass)
        assert jc.render_batch(jposes, W, H, max_steps=STEPS) is None
        assert tc.render_batch(tposes, W, H, max_steps=STEPS) is None
    # mixed beam availability: pose 0 has beams, pose 2 none (JAX :456-457)
    jsvo, tsvo, jh, th = scene
    jfloors, tctx = JSvo._beam_floors, Svo.beam_context
    calls = {"j": 0, "t": 0}

    def jbeams(self, *a, **kw):
        calls["j"] += 1
        return None if calls["j"] == 3 else jfloors(self, *a, **kw)

    def tbeams(self, *a, **kw):
        calls["t"] += 1
        return None if calls["t"] == 3 else tctx(self, *a, **kw)

    monkeypatch.setattr(JSvo, "_beam_floors", jbeams)
    monkeypatch.setattr(Svo, "beam_context", tbeams)
    jsvo.set_heightfield(jh)
    tsvo.set_heightfield(th)
    try:
        assert jsvo.render_batch(jposes, W, H, max_steps=STEPS) is None
        assert tsvo.render_batch(tposes, W, H, max_steps=STEPS) is None
    finally:
        jsvo.set_heightfield(None)
        tsvo.set_heightfield(None)
    assert calls == {"j": 3, "t": 3}


class _Recorder:
    """Stands in for a graphics Svo: keeps what ``render_batch`` got."""

    def __init__(self):
        self.got = None

    def render_batch(self, params_list, width, height, max_steps=1000):
        self.got = (params_list, width, height, max_steps)
        return "batch"


def test_worldsvo_render_batch_converts_like_jax():
    """systems/worldsvo.py::Svo.render_batch: each pose's camera and
    highlighted block in SVO space, as the JAX one converts them."""
    out = []
    for mod, cp, cls in ((jworldsvo, ChunkPos, JRenderParams),
                         (tworldsvo, TCP, RenderParams)):
        ws = object.__new__(mod.Svo)  # no job system: only the conversion
        ws.coord_space = mod.SvoCoordSpace(cp(3, 1, -2), 4)
        ws.graphics_svo = _Recorder()
        poses = _poses(cls)
        for i, p in enumerate(poses):
            p.cam_pos = p.cam_pos + np.array([100.3, 5.0, -70.6], np.float32)
            p.selected_voxel = (None if i == 1 else np.array(
                [101.0 + i, 20.0, -60.0], np.float32))
        assert ws.render_batch(poses, W, H, max_steps=STEPS) == "batch"
        # the caller's poses stay in world space
        assert poses[0].cam_pos[0] == np.float32(102.3)
        out.append(ws.graphics_svo.got)
    (jps, *jrest), (tps, *trest) = out
    assert jrest == trest == [W, H, STEPS]
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(tp.cam_pos, jp.cam_pos)
        assert (tp.selected_voxel is None) == (jp.selected_voxel is None)
        if jp.selected_voxel is not None:
            np.testing.assert_array_equal(tp.selected_voxel, jp.selected_voxel)
        np.testing.assert_array_equal(tp.cam_fwd, jp.cam_fwd)


def test_batch_past_32_bit_offsets_is_refused(scene):
    """64 poses at 1920x1080 keep every record offset (16 words a lane at
    most) under 2^31; 65 would not, and are refused before anything is
    allocated or traced."""
    shading.check_batch(64, 1920, 1080)
    with pytest.raises(ValueError, match="2\\^31"):
        shading.check_batch(65, 1920, 1080)
    with pytest.raises(ValueError, match="at least one pose"):
        shading.check_batch(0, W, H)
    _jsvo, tsvo, _jh, _th = scene
    poses = _poses(RenderParams)
    with pytest.raises(ValueError, match="2\\^31"):
        tsvo.render_batch(poses * 22, 1920, 1080)  # 66 poses
    cams = torch.zeros((65, 12), dtype=torch.float32)
    with pytest.raises(ValueError, match="2\\^31"):
        shading.check_cams(cams, 1920, 1080, cams.device)
    cam_stack = tuple(np.zeros((65, 3), np.float32) for _ in range(4))
    with pytest.raises(ValueError, match="2\\^31"):
        shading.render_frames_opaque_batch(
            tsvo.world(), tsvo.octree_scale, tsvo.mips, tsvo.mat_params,
            tsvo.mat_tex, cam_stack, 1.2, 16 / 9, 0.3,
            np.array([-1, -1, -1], np.float32), 100.0,
            np.full(3, np.nan, np.float32), width=1920, height=1080,
            render_shadows=True)


def test_batched_plain_versions_equal_per_pose(scene):
    """K9's and K6's batched plain versions (the card's kernels are held
    to them) on the three poses' pose-major lanes against each pose's own
    run: the grid traces, merges and refine lists, the finalize, both
    shadow-cell steps and K6's segment starts."""
    _jsvo, tsvo, _jh, th = scene
    poses = _poses(RenderParams)
    kws = [tsvo.frame_kwargs(p, W, H, STEPS) for p in poses]
    fps = [shading.frame_params(mip_mode="nearest", deferred=True, **kw)
           for kw in kws]
    cams = shading.batch_cameras(tuple(np.stack([kw[k] for kw in kws]) for k
                                       in ("cam_pos", "cam_right", "cam_up",
                                           "cam_fwd")), "cpu")
    for i, f in enumerate(fps):  # pose_params rebuilds each pose's camera
        g = shading.pose_params(fps[0], cams, i)
        assert bytes(g) == bytes(f)
    tsvo.set_heightfield(th)
    try:
        tf = torch.stack([tsvo.beam_context(p, W, H).tile_floors
                          for p in poses])
    finally:
        tsvo.set_heightfield(None)
    world, scale, N, B = tsvo.world(), float(tsvo.octree_scale), 3, W * H
    levels = 2
    dims = adaptive.grid_dims(W, H, levels)

    def per_pose(fn, n, *bufs):
        """Each pose's run of ``fn(pose, *its slices)`` stacked."""
        outs = [t.clone() for t in bufs]
        for q in range(N):
            fn(q, *(t[q * n:(q + 1) * n] for t in outs))
        return outs

    recs = [torch.zeros((w * h * N, 8), dtype=torch.int32) for w, h in dims]
    adaptive.k9_trace(world, scale, fps[0], tf, levels, recs[levels],
                      cams=cams)
    nl = dims[levels][0] * dims[levels][1]
    ref, = per_pose(lambda q, o: adaptive.k9_trace_plain(
        world, scale, fps[q], tf[q], levels, o), nl,
        torch.zeros_like(recs[levels]))
    assert torch.equal(recs[levels], ref)
    for k in range(levels - 1, -1, -1):
        n = dims[k][0] * dims[k][1]
        refine = torch.zeros(N * n, dtype=torch.bool)
        adaptive.k9_merge(scale, fps[0], k, recs[k + 1], recs[k], refine,
                          cams)
        nk1 = dims[k + 1][0] * dims[k + 1][1]
        ref_hi, ref_refine = per_pose(
            lambda q, hi, rf: adaptive.k9_merge_plain(
                scale, fps[q], k, recs[k + 1][q * nk1:(q + 1) * nk1], hi,
                rf), n, torch.zeros_like(recs[k]), torch.zeros_like(refine))
        assert torch.equal(recs[k], ref_hi) and torch.equal(refine, ref_refine)
        ridx, rcount = compact.compact_indices(refine, N * n)
        assert int(rcount) > 0
        before = recs[k].clone()
        adaptive.k9_trace(world, scale, fps[0], tf, k, recs[k], idx=ridx,
                          count=rcount, cams=cams)

        def retrace(q, o):
            lanes = ridx[: int(rcount)].long()
            mine = lanes[(lanes >= q * n) & (lanes < (q + 1) * n)] - q * n
            adaptive.k9_trace_plain(world, scale, fps[q], tf[q], k, o,
                                    mine, mine.numel())
        ref, = per_pose(retrace, n, before)
        assert torch.equal(recs[k], ref)
    # the finalize: hit records, flags, sky
    outs = [torch.zeros((N * B, _build.HIT_WORDS), dtype=torch.int32),
            torch.zeros(N * B, dtype=torch.bool),
            torch.zeros((N, H, W, 4)), torch.ones(N * B, dtype=torch.bool),
            torch.ones(N * B, dtype=torch.bool)]
    refs = [t.clone() for t in outs]
    adaptive.k9_finalize(scale, fps[0], recs[0], *outs[:2], outs[2],
                         *outs[3:], cams=cams)
    for q in range(N):
        sl = slice(q * B, (q + 1) * B)
        adaptive.k9_finalize_plain(scale, fps[q], recs[0][sl], refs[0][sl],
                                   refs[1][sl], refs[2][q], refs[3][sl],
                                   refs[4][sl])
    assert all(torch.equal(a, b) for a, b in zip(outs, refs))
    # K6 over the pose-major hits: each pose's first hit lane
    hit = outs[1]
    starts = torch.full((N,), -1, dtype=torch.int32)
    hidx, hcount = compact.compact_indices(hit, N * B, starts=starts)
    counts = [int(hit[q * B:(q + 1) * B].sum()) for q in range(N)]
    assert starts.tolist() == [0, counts[0], counts[0] + counts[1]]
    assert int(hcount) == sum(counts)
    # the shadow cells' two steps, each pose deciding its own dense flag
    rng = np.random.default_rng(5)
    need = torch.from_numpy(rng.random(N * B) < 0.6)
    color = torch.from_numpy(rng.random((N * B, 4), np.float32))
    ds = torch.from_numpy(rng.random(N * B, np.float32))
    blkp = torch.from_numpy(rng.random(N * B) < 0.3)
    state = [torch.zeros(N * B, dtype=torch.bool), blkp,
             torch.ones(N * B, dtype=torch.bool),
             torch.full((N,), -1, dtype=torch.int32),
             torch.zeros((N, H, W, 4))]
    for step in (1, 2):
        mine = [t.clone() for t in state]
        adaptive.k9_shadow_cells(step, fps[0], hidx, hcount, need, *mine[:3],
                                 mine[3], color, ds, mine[4], hstart=starts)
        ref = [t.clone() for t in state]
        ends = starts.tolist() + [int(hcount)]
        for q in range(N):
            a, b = ends[q], ends[q + 1]
            sl = slice(q * B, (q + 1) * B)
            adaptive.k9_shadow_cells_plain(
                step, fps[q], hidx[a:b] - q * B,
                torch.tensor([b - a], dtype=torch.int32), need[a:b],
                ref[0][sl], ref[1][sl], ref[2][a:b], ref[3][q:q + 1],
                color[a:b], ds[a:b], ref[4][q])
        ref[2][int(hcount):] = False
        assert all(torch.equal(a, b) for a, b in zip(mine, ref)), step
        assert mine[3].tolist() == [int(adaptive.dense_frame(c, B))
                                    for c in counts]
        state = mine
