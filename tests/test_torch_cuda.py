"""Kernels K1, K3, K4, K5, K6, K7, K8, K9, K10 (K9's kernels and K6 with a
pose dimension) and P0 against their plain PyTorch versions on a CUDA card
(K3, K5 and K9's trace in both their ESVO and CSVO instantiations), K1 and
K4 from the beam floors against their unfloored runs, the deferred frame
against K3's fused frame in both formats, the adaptive frame against its
plain version, a pose batch against each pose's own frame, the game loop
launching K5 and the deferred frame's kernels in both formats, and the
crosshair overlay on the card against the CPU.

Every test here needs the card (marker ``cuda``) and skips without one. The
file imports neither JAX nor ``voxelrs_tpu``, so it also runs where JAX is
not installed:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: K1 equals its plain version bit for bit (the same IEEE float32
operations in the same order; the kernel is built with -fmad=false). K3:
max |d| <= 1e-6 over every pixel and channel — the same operations again,
with room only for a last-bit rounding of powf/acosf against
torch.pow/torch.acos. K4 equals its plain version bit for bit, field by
field, as K1. K5 equals its plain version bit for bit, every column of
every task, with a task's ray cast by 1, 2, 8, 31 and 32 lanes (its plain
split too), and one native call a pick (``ops.picker.pick``: pinned
upload, K5, copy back) gives the rows of the launch-and-copy path at 8,
32 and 5,000 tasks, its buffers grown to the largest batch and reused.
K6, K7 and K8 equal their plain versions bit for bit (torch.equal). Floored K1 and K4 equal their unfloored runs on value, face_id,
inside_voxel and t. The deferred frame is within max |d| 1e-6 of K3's
frame (its stages are K3's device functions; measured 0). K9's kernels
equal their plain versions bit for bit (the finalize's sky within 1e-6:
acosf), at grid and frame sizes that are not multiples of the merge's
tile or the finalize's block, and refuse records off a 16-byte word; the adaptive frame is within max |d| 1e-6 of its plain version and
within the thick-ray budget of K3's frame (mean |d| <
0.002, under 2% of the pixels off by more than 1e-3, the traced grid's
pixels equal). The shadow stage (``kd_shadow``) equals
``ops.shading.kd_shadow_plain`` and K9's shadow cells their plain version
bit for bit: counts of 0, equal to the list's size and off a block or a
thread's word, sub-lists, floors, opaque and judged rays, both formats,
every launch of the frames and of a batch, odd frame sizes, 3 poses; the
shadow cells refuse lanes off a 16-byte word. The finishing stage
(``kd_finish``) equals ``ops.shading.kd_finish_plain`` and K7's shadow
floors ``ops.beams.shadow_ray_floors_plain`` bit for bit: counts of 0,
equal to the list's size and off a word or a block, with and without
certificates and pixel verdicts, no list, per-lane limits, pads 0, 3
poses, every launch of the frames and of a batch. K3 in 4x8 tiles
equals the plain frame bit for bit at 1x1, 15x12, 33x17 and 1920x1080,
with and without shadows, trilinear and at the CSVO budget of 40, both
formats, its tile counters back at 0 after each launch, and refuses a
frame off a 16-byte word; K9-judged's trace equals ``k9j_trace_plain``
bit for bit on each grid level of the judged frame, the whole grid and
refine lists at counts 0, 1, odd, the list's size and past it. K4 equals
its plain version bit for bit, and K3-CSVO the plain frame within 1e-6,
on hand-built CSVO streams (``CSVO_STREAMS``: every pointer width and all
eight children, nodes of eight 4-byte pointers, crossings,
the stream's last word and word counts off a multiple of 4); every CSVO
launch path refuses words off a 16-byte word. K9-judged's finalize
equals its plain version bit for bit (the sky within 1e-6) at 1x1,
127x1, 129x1, 37x21 and 1080p on records from a seed whose words 9-15
are never 0, and refuses each of its tensors off a 16-byte word. The
primary stage (``kd_primary``: 16 x 4 pixel patches, HitRecs and flags
stored through shared memory as 16-byte words, the trace through a
shared stack) equals
``ops.shading.kd_primary_plain`` bit for bit (a miss's sky within 1e-6)
at 1001x597 and 37x23, opaque and judged, with and without floors, both
formats, and on a batch of 3 poses; K9-judged's merge (K9's merge tile)
equals ``k9j_merge_plain`` bit for bit at levels 0 and 1 of 1001x597 and
37x21, hole fill off and on, both formats. K8 on its resident grid
equals ``ops.beams.k8_plain`` bit for bit at counts around a 16-lane pad
word and past its lanes, each output alone and all four together, and
on tables whose rows start on each 4-byte word of a 16-byte one (every
row word its launch may take); K7's
tile floors (a group of lanes a tile) equal ``ops.beams.k7_tiles_plain``
bit for bit from 1x1 to 1920x1080 at march budgets that end
mid-descent, with the pyramid staged in shared memory and read from
global memory. The crosshair equals the CPU's result bit for bit.
"""

import numpy as np
import pytest
import torch

from voxelrs_tpu_torch import _build
from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.gamelogic.game import Game, GameArgs
from voxelrs_tpu_torch.graphics.picker import Aabb, PickerBatch, PickerBatchResult
from voxelrs_tpu_torch.graphics.svo import RenderParams, Svo
from voxelrs_tpu_torch.ops import (adaptive, beams, compact, picker, shading,
                                   traversal, traversal_csvo)
from voxelrs_tpu_torch.world import ChunkPos, Position
from voxelrs_tpu_torch.world.csvo import Csvo, CsvoSerializedChunk
from voxelrs_tpu_torch.world.esvo import Esvo, SerializedChunk
from voxelrs_tpu_torch.world.heightfield import (HeightField, chunk_column_tops,
                                                 chunk_solid_bases,
                                                 chunk_voxel_tops,
                                                 opaque_lut_from_mask)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene_voxels():
    """Stone, grass, a tower, glass, leaves and water."""
    rng = np.random.default_rng(7)
    vox = np.zeros((32, 32, 32), np.uint32)
    vox[:, :8, :] = content.STONE
    vox[:, 8, :] = content.GRASS
    vox[10:14, 9:12, 10:14] = content.STONE
    vox[3:6, 9:12, 3:6] = content.GLASS
    vox[16:20, 9:11, 3:9] = content.OAK_LEAVES
    vox[20:28, 8, 20:28] = content.WATER
    blobs = rng.random((32, 32, 32)) < 0.02
    vox[blobs] = content.OAK_LEAVES
    return vox


def _svo(dev, fmt):
    """The scene over two chunks (lod 5 and 4) in ``fmt`` on the card."""
    vox = _scene_voxels()
    world, chunk, dtype = ((Esvo(), SerializedChunk, np.uint32) if fmt == "esvo"
                           else (Csvo(), CsvoSerializedChunk, np.uint8))
    for x, v, lod in ((0, vox, 5), (1, vox[::-1].copy(), 4)):
        world.set_leaf(Position(x, 0, 0),
                       chunk.from_voxels(ChunkPos(x, 0, 0), v, lod), True)
    world.serialize()
    s = Svo(content.new_registry(), capacity_mb=4, buffer_dtype=dtype,
            device=dev)
    s.update(world)
    return s


@pytest.fixture(scope="module")
def svo(dev):
    return _svo(dev, "esvo")


@pytest.fixture(scope="module")
def csvo(dev):
    return _svo(dev, "csvo")


@pytest.mark.cuda
@pytest.mark.parametrize("translucent,exact", [(False, False), (True, False),
                                               (True, True)])
def test_k1_equals_plain(svo, dev, translucent, exact):
    rng = np.random.default_rng(9)
    n = 50000
    ro = rng.uniform(-10, 70, (n, 3))
    rd = rng.uniform(0, 40, (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = torch.tensor(ro, dtype=torch.float32, device=dev)
    r = torch.tensor(rd, dtype=torch.float32, device=dev)
    md = torch.tensor(np.where(rng.random(n) < 0.3, 20.0, -1.0),
                      dtype=torch.float32, device=dev)
    alpha = shading.make_alpha_fn(svo.mips, svo.mat_tex, exact=exact)
    scale = float(svo.octree_scale)
    n0 = traversal.launches
    k = traversal.intersect_octree(svo.device_buf, scale, o, r, md,
                                   translucent, alpha_fn=alpha)
    p = traversal.intersect_octree_plain(svo.device_buf, scale, o, r, md,
                                         translucent, alpha)
    torch.cuda.synchronize()
    assert traversal.launches == n0 + 1
    assert int((k.t >= 0).sum()) > n // 10
    for f in ("t", "value", "face_id", "pos", "uv", "lod", "inside_voxel",
              "steps"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.cuda
def test_k1_rejects_a_foreign_alpha_function(svo, dev):
    o = torch.zeros((4, 3), device=dev)
    r = torch.tensor([[1.0, 0, 0]] * 4, device=dev)
    with pytest.raises(TypeError):
        traversal.intersect_octree(svo.device_buf, 1.0, o, r, -1.0, True,
                                   alpha_fn=lambda v, f, uv, lod: v * 0 + 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shadows,trilinear", [(True, False), (False, False),
                                               (True, True)])
def test_k3_matches_plain(svo, dev, shadows, trilinear, monkeypatch):
    _check_k3(svo, shadows, trilinear, 300, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("shadows,trilinear,max_steps", [
    (True, False, 300), (False, False, 1000), (True, True, 1000),
    (True, False, 40)])
def test_k3_csvo_matches_plain(csvo, dev, shadows, trilinear, max_steps,
                               monkeypatch):
    """The CSVO instantiation; at 40 steps the shadow rays run out of the
    frame's budget, as in the JAX CSVO frame."""
    n0 = shading.launches_csvo
    _check_k3(csvo, shadows, trilinear, max_steps, monkeypatch)
    assert shading.launches_csvo == n0 + 1


def _check_k3(svo, shadows, trilinear, max_steps, monkeypatch):
    monkeypatch.setenv("VOXELRS_TRILINEAR", "1" if trilinear else "0")
    W, H = 320, 240
    fwd = np.array([0.5, -0.5, 0.7], np.float32)
    fwd /= np.linalg.norm(fwd)
    p = RenderParams(cam_pos=np.array([2.0, 20.0, -4.0], np.float32),
                     cam_fwd=fwd, aspect_ratio=W / H,
                     fov_y_rad=np.radians(70.0), render_shadows=shadows,
                     shadow_distance=100.0,
                     selected_voxel=np.array([12.0, 11.0, 10.0], np.float32))
    n0 = shading.launches
    img = svo.render(p, W, H, max_steps=max_steps, mode="fused")
    ref = shading.render_frame_plain(
        svo.world(), svo.octree_scale, svo.mips, svo.mat_params,
        svo.mat_tex, **svo.frame_kwargs(p, W, H, max_steps=max_steps))
    torch.cuda.synchronize()
    assert shading.launches == n0 + 1
    assert img.shape == (H, W, 4) and bool(torch.isfinite(img).all())
    assert float((img - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 33, 5000])
def test_k5_equals_plain(svo, dev, n):
    """Look rays and axis-aligned sweep rays (origins on and off the voxel
    lattice), distance limits of 10 and 30 blocks, plus padding tasks."""
    _check_k5(svo, dev, n, "esvo")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 33, 5000])
def test_k5_csvo_equals_plain(csvo, dev, n):
    """The same batches through the CSVO instantiation."""
    _check_k5(csvo, dev, n, "csvo")


def _check_k5(svo, dev, n, fmt):
    tasks = _k5_tasks(n, dev)
    n0, c0 = picker.launches, picker.launches_csvo
    k = picker.raycast(svo.world(), svo.octree_scale, tasks)
    p = picker.raycast_plain(svo.world(), svo.octree_scale, tasks)
    torch.cuda.synchronize()
    assert picker.launches == n0 + 1
    assert picker.launches_csvo == c0 + (fmt == "csvo")
    assert k.shape == (n, 8) and k.dtype == torch.float32
    if n > 100:
        assert int((k[:, 0] > 0).sum()) > n // 10
    for col, name in ((slice(0, 1), "dst"), (slice(1, 2), "inside"),
                      (slice(2, 5), "pos"), (slice(5, 8), "normal")):
        assert torch.equal(k[:, col], p[:, col]), name


def _k5_tasks(n, dev=None):
    """_check_k5's batch: look rays and axis-aligned sweep rays (origins on
    and off the voxel lattice), limits of 10 and 30 blocks, a padding
    task last; numpy, or on ``dev``."""
    rng = np.random.default_rng(n)
    o = rng.uniform(-4, 68, (n, 3))
    o[::3] = np.round(o[::3])  # on the lattice
    d = rng.normal(size=(n, 3))
    d[1::2] = np.eye(3)[rng.integers(0, 3, n // 2)] * rng.choice([-1, 1], (n // 2, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    md = rng.choice([10.0, 30.0], (n, 1))
    md[-1] = 0.0  # a padding task: max_dst 0, direction +x
    d[-1] = (1.0, 0.0, 0.0)
    tasks = np.concatenate([md, o, d], 1).astype(np.float32)
    return tasks if dev is None else torch.tensor(tasks, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("segments", [1, 2, 8, 31, 32])
@pytest.mark.parametrize("n", [8, 33, 5000])
def test_k5_segments_equal_plain(svo, csvo, dev, fmt, segments, n):
    """K5 with a task's ray cut into ``segments`` lanes' segments (1: lane
    0 casts it whole) equals the plain picker bit for bit, and its plain
    split (``raycast_split_plain``) too."""
    s = svo if fmt == "esvo" else csvo
    tasks = _k5_tasks(n, dev)
    budget = (traversal_csvo if fmt == "csvo" else traversal).step_budget(
        traversal.MAX_STEPS)
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    _build.launch_k5(s.world(), float(s.octree_scale), tasks, budget, out,
                     steps, segments=segments)
    ref = picker.raycast_plain(s.world(), s.octree_scale, tasks)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(picker.raycast_split_plain(
        s.world(), s.octree_scale, tasks, segments), ref)
    assert int(steps.min()) >= 0 and int(steps.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("n", [8, 32, 5000])
def test_k5_pick_equals_launch_and_copy(svo, csvo, dev, fmt, n):
    """One native call a pick (``ops.picker.pick``: pinned upload, K5,
    copy back, wait) gives the rows of ``raycast`` and a copy, and of the
    plain version, counting one launch."""
    s = svo if fmt == "esvo" else csvo
    tasks = _k5_tasks(n)
    bufs = picker.PickBuffers(s.device_buf.device)
    n0, c0 = picker.launches, picker.launches_csvo
    rows = picker.pick(s.world(), s.octree_scale, tasks, bufs)
    assert picker.launches == n0 + 1
    assert picker.launches_csvo == c0 + (fmt == "csvo")
    assert bufs.host_tasks.is_pinned() and bufs.host_rows.is_pinned()
    assert isinstance(rows, np.ndarray) and rows.shape == (n, 8)
    t = torch.from_numpy(tasks).to(dev)
    old = picker.raycast(s.world(), s.octree_scale, t).cpu().numpy()
    ref = picker.raycast_plain(s.world(), s.octree_scale, t).cpu().numpy()
    np.testing.assert_array_equal(rows, old)
    np.testing.assert_array_equal(rows, ref)


@pytest.mark.cuda
def test_k5_pick_buffers_grow_and_are_reused(svo, dev):
    """A pick's buffers grow to the largest batch and are reused below it;
    each pick's rows are its own."""
    bufs = picker.PickBuffers(svo.device_buf.device)
    seen = []
    for n in (8, 32, 8, 5000, 33):
        tasks = _k5_tasks(n)
        rows = picker.pick(svo.world(), svo.octree_scale, tasks, bufs)
        seen.append((bufs.size, bufs.host_rows.data_ptr()))
        ref = picker.raycast_plain(svo.world(), svo.octree_scale,
                                   torch.from_numpy(tasks).to(dev))
        np.testing.assert_array_equal(rows, ref.cpu().numpy())
    assert [s for s, _ in seen] == [8, 32, 32, 5000, 5000]
    assert seen[1][1] == seen[2][1] and seen[3][1] == seen[4][1]


@pytest.mark.cuda
def test_svo_raycast_launches_k5(svo, dev):
    batch, res = PickerBatch(), PickerBatchResult()
    batch.add_ray(np.array([12.5, 20.0, 12.5], np.float32),
                  np.array([0.0, -1.0, 0.0], np.float32), 30.0)
    batch.add_aabb(Aabb.new([20.3, 11.0, 20.6], [-0.4, -1.7, -0.4],
                            [0.8, 1.8, 0.8]))
    n0 = picker.launches
    svo.raycast(batch, res)
    assert picker.launches == n0 + 1
    assert res.rays[0].did_hit() and res.rays[0].normal[1] == 1.0
    assert res.aabbs[0].neg[1] >= 0.0  # standing on the grass
    again = PickerBatchResult()
    svo.raycast(batch, again)  # the same batch on the same buffer: memo
    assert picker.launches == n0 + 1
    assert again.rays[0].dst == res.rays[0].dst


@pytest.mark.cuda
def test_game_loop_launches_k5_and_k3(dev):
    _check_game_loop("esvo")


@pytest.mark.cuda
def test_csvo_game_loop_launches_the_csvo_instantiations(dev):
    _check_game_loop("csvo")


def _check_game_loop(fmt):
    """Ten frames of the game: K5 (the picker) and the deferred frame with
    the world's heightfield (K6, K7; K8 once a sun map is attached, which
    the streaming engine builds on a thread once the world is quiet); then
    one fused frame of the streamed buffer (K3 in its format's
    instantiation) equal to the deferred one."""
    g = Game(GameArgs(player_pos=(16.37, 63.21, 16.83),
                      player_euler_rot=(-30.0, 45.0, 0.0), render_distance=2,
                      gpu_buffer_size_mb=16, workers=2, svo_format=fmt))
    try:
        assert g.wait_for_world(timeout=120)
        g.player.caps.flying = False
        n5, c5 = picker.launches, picker.launches_csvo
        stages = ("launches_primary", "launches_shade", "launches_shadow",
                  "launches_finish")
        nd = [getattr(shading, s) for s in stages]
        n6 = compact.launches
        n7 = beams.launches_tile + beams.launches_shadow
        n8 = beams.launches_sun + beams.launches_sun_floors
        gsvo = g.world.world_svo.graphics_svo
        sun = 0
        for _ in range(10):
            img = g.step_frame(dt=1 / 60, render=True, width=160, height=120)
            sun += bool(gsvo.last_frame.get("sun"))
        for _ in range(200):  # until the sun map attaches
            if sun:
                break
            import time

            time.sleep(0.05)
            img = g.step_frame(dt=1 / 60, render=True, width=160, height=120)
            sun += bool(gsvo.last_frame.get("sun"))
        torch.cuda.synchronize()
        assert img.is_cuda and img.shape == (120, 160, 4)
        assert bool(torch.isfinite(img).all())
        assert gsvo.last_frame["mode"] == "deferred" and gsvo.last_frame["beams"]
        assert all(getattr(shading, s) - n >= 10 for s, n in zip(stages, nd))
        assert compact.launches > n6
        assert beams.launches_tile + beams.launches_shadow > n7
        assert sun and beams.launches_sun + beams.launches_sun_floors > n8
        assert picker.launches > n5
        csvo = fmt == "csvo"
        assert picker.launches_csvo - c5 == (picker.launches - n5 if csvo else 0)
        assert g.player.state.is_grounded
        n3, c3 = shading.launches, shading.launches_csvo
        p = g.world.render_params(160 / 120)
        fused = g.world.world_svo.render(p, 160, 120, mode="fused")
        deferred = g.world.world_svo.render(p, 160, 120)
        assert shading.launches == n3 + 1
        assert shading.launches_csvo == c3 + int(csvo)
        assert float((fused - deferred).abs().max()) <= K3_MAX_ABS
    finally:
        g.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("translucent,exact,max_steps", [
    (False, False, 1000), (True, False, 1000), (True, True, 1000),
    (True, False, 13)])
@pytest.mark.parametrize("n", [7, 1000, 50000])
def test_k4_equals_plain(csvo, dev, translucent, exact, max_steps, n):
    """K4 against intersect_octree_csvo_plain on rays from inside and
    outside the terrain, with and without distance limits."""
    rng = np.random.default_rng(n)
    ro = rng.uniform(-10, 70, (n, 3))
    rd = rng.uniform(0, 40, (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = torch.tensor(ro, dtype=torch.float32, device=dev)
    r = torch.tensor(rd, dtype=torch.float32, device=dev)
    md = torch.tensor(np.where(rng.random(n) < 0.3, 20.0, -1.0),
                      dtype=torch.float32, device=dev)
    alpha = shading.make_alpha_fn(csvo.mips, csvo.mat_tex, exact=exact)
    w = csvo.world()
    args = (w.words, float(csvo.octree_scale), w.root_ptr, w.total_depth, o,
            r, md, translucent)
    n0 = traversal_csvo.launches
    k = traversal_csvo.intersect_octree_csvo(*args, alpha_fn=alpha,
                                             max_steps=max_steps)
    p = traversal_csvo.intersect_octree_csvo_plain(*args, alpha, max_steps)
    torch.cuda.synchronize()
    assert traversal_csvo.launches == n0 + 1
    if n > 100:
        assert int((k.t >= 0).sum()) > n // 10
    for f in ("t", "value", "face_id", "pos", "uv", "lod", "inside_voxel",
              "steps"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f


# ---- hand-built CSVO streams ---------------------------------------------
# Streams whose bytes exercise every way K4's cursor reads a node: internal
# pointers of every tag width (1, 2 and 4 bytes, chosen at random above the
# width an offset needs, so with junk between child blobs) and of all eight
# children, nodes of eight 4-byte pointers (34 bytes: a pointer read there
# reaches 32 bytes past the node's first word), crossings into chunk blobs of lod 5 and 4 (the root's
# absolute pointers), a node in the stream's last word, and word counts
# 1, 2 and 3 past a multiple of 4, so that the clamped reads run. The CPU
# tests hold ops.traversal_csvo.intersect_octree_csvo_plain to the JAX
# traversal on the same streams (tests/test_torch_csvo_streams.py).

def _csvo_internal(children, rng, stats):
    """An internal node: a u16 header of 2-bit tags, each child's offset in
    a tag of at least its width (1, 2 or 4 bytes at random; a third of
    the nodes of eight children all 4 bytes, 34 bytes in all, so their
    last pointers lie 30 bytes past the header), 0-40 junk bytes before a
    child's blob at random, then the blobs."""
    wide = len(children) == 8 and rng.random() < 0.33
    blobs, offs = bytearray(), []
    for _idx, data in children:
        if rng.random() < 0.3:
            blobs += rng.integers(0, 256, int(rng.integers(1, 41)),
                                  dtype=np.uint8).tobytes()
        offs.append(len(blobs))
        blobs += data
    header, ptrs = 0, bytearray()
    for (idx, _), off in zip(children, offs):
        tag = 3 if wide else max((max(off, 1).bit_length() - 1) // 8 + 1,
                                 int(rng.integers(1, 4)))
        header |= tag << (2 * idx)
        ptrs += off.to_bytes((1 << tag) >> 1, "little")
        stats["widths"].add((1 << tag) >> 1)
    if len(children) == 8:
        stats["eight"] += 1
        if len(ptrs) == 32:
            stats["eight_wide"] += 1
    return header.to_bytes(2, "little") + bytes(ptrs) + bytes(blobs)


def _csvo_chunk_blob(vox, lod, rng, stats):
    """A chunk blob, [lod u8][material bytes u32][materials][nodes], its
    nodes as the serializer encodes them at ``lod`` but for the internal
    nodes' tags and junk (world/csvo.py serialize_dense_csvo)."""
    from voxelrs_tpu_torch.world.csvo import _pyramids

    occ, rep = _pyramids(vox)
    materials = []

    def node(lvl, m):
        depth = lod - lvl
        kids = [c for c in range(8) if occ[lvl + 1][8 * m + c]]
        mask = sum(1 << c for c in kids)
        if depth == 1:
            materials.extend(int(rep[lvl + 1][8 * m + c]) for c in kids)
            return bytes([mask])
        if depth == 2:
            off = len(materials)
            out = bytearray([mask])
            if mask:
                out += off.to_bytes(2, "little")
            for c in kids:
                out += node(lvl + 1, 8 * m + c)
            return bytes(out)
        children = [(c, node(lvl + 1, 8 * m + c)) for c in kids]
        if depth == 3:
            out, run = bytearray([mask]), 0
            for _c, data in children:
                out.append(run)
                run += len(data)
            for _c, data in children:
                out += data
            return bytes(out)
        return _csvo_internal(children, rng, stats)

    nodes = node(0, 0)
    return (bytes([lod]) + (4 * len(materials)).to_bytes(4, "little")
            + np.asarray(materials, "<u4").tobytes() + nodes)


def _csvo_root(blob_at, R, rng, stats):
    """The root tree over R levels of chunks (``blob_at``: chunk (x, y, z)
    -> its blob's byte offset): internal nodes down to the chunks' level,
    whose children are 4-byte absolute pointers with bit 31 set."""
    def rec(level, base):
        children = []
        for idx in range(8):
            c = tuple(2 * b + ((idx >> a) & 1) for a, b in enumerate(base))
            if level == 1:
                if c in blob_at:
                    children.append((idx, blob_at[c]))
                continue
            span = 1 << (level - 1)
            if any(all(c[a] * span <= k[a] < (c[a] + 1) * span
                       for a in range(3)) for k in blob_at):
                children.append((idx, rec(level - 1, c)))
        if level > 1:
            return _csvo_internal(children, rng, stats)
        header = sum(3 << (2 * idx) for idx, _ in children)
        stats["crossings"] += len(children)
        return header.to_bytes(2, "little") + b"".join(
            (off | 1 << 31).to_bytes(4, "little") for _, off in children)

    return rec(R, (0, 0, 0))


# name: (seed, root levels, chunks {(x, y, z): lod}, root first, words % 4,
# bytes cut off the end)
CSVO_STREAMS = {
    "root-last-1": (3, 1, {(0, 0, 0): 5, (1, 0, 1): 4}, False, 1, 0),
    "root-first-2": (4, 1, {(0, 0, 0): 5, (1, 1, 0): 5}, True, 2, 0),
    "two-levels-3": (5, 2, {(0, 0, 0): 5, (2, 1, 3): 4, (3, 0, 0): 5},
                     False, 3, 0),
    # the root's last pointer cut short: its missing bytes read the last
    # word again, as the clamped gather reads them
    "root-cut-1": (6, 1, {(0, 0, 0): 5, (1, 1, 1): 5}, False, 1, 3),
}


def csvo_stream(name):
    """(words as uint32, root_ptr, total_depth, stats) of a hand-built
    stream of CSVO_STREAMS: junk first (so the word count takes its
    class), the chunk blobs and the root in either order, the last node
    ending in the last word (or cut short there)."""
    seed, R, chunks, root_first, mod, cut = CSVO_STREAMS[name]
    stats = dict(widths=set(), eight=0, eight_wide=0, crossings=0)
    rng = np.random.default_rng(seed)
    blobs = {}
    for k, lod in chunks.items():
        vox = np.where(rng.random((32, 32, 32)) < 0.25,
                       rng.integers(1, 13, (32, 32, 32)), 0).astype(np.uint32)
        vox[8:24, 4:20, 8:24] = rng.integers(1, 13, (16, 16, 16))
        vox[rng.random((32, 32, 32)) < 0.02] = 7
        blobs[k] = _csvo_chunk_blob(vox, lod, rng, stats)

    def layout(lead, root_seed_stats):
        # the root's size does not depend on the blobs' offsets (4-byte
        # crossings), so lay it out once with a copy of its generator
        root_len = len(_csvo_root({k: 0 for k in blobs}, R,
                                  np.random.default_rng(seed + 100),
                                  dict(widths=set(), eight=0, eight_wide=0,
                                       crossings=0)))
        at, pos = {}, lead + (root_len if root_first else 0)
        for k, b in blobs.items():
            at[k] = pos
            pos += len(b)
        root = _csvo_root(at, R, np.random.default_rng(seed + 100),
                          root_seed_stats)
        body = b"".join(blobs.values())
        junk = rng.integers(0, 256, lead, dtype=np.uint8).tobytes()
        data = junk + (root + body if root_first else body + root)
        return data[:len(data) - cut], lead if root_first else lead + len(
            body)

    base = len(layout(0, dict(widths=set(), eight=0, eight_wide=0,
                              crossings=0))[0])
    lead = next(p for p in range(16) if -(-(base + p) // 4) % 4 == mod)
    data, root_ptr = layout(lead, stats)
    words = np.frombuffer(data + bytes(-len(data) % 4), "<u4").copy()
    stats["last_node_in_last_word"] = (len(data) - 1) // 4 == len(words) - 1
    return words, root_ptr, R + max(chunks.values()), stats


def _stream_rays(n, depth, seed):
    """Rays from around and inside the stream's world at its chunks."""
    rng = np.random.default_rng(seed)
    size = float(1 << depth)
    ro = rng.uniform(-0.2 * size, 1.2 * size, (n, 3))
    ro[: n // 4] = rng.uniform(0.0, size, (n // 4, 3))  # inside
    rd = rng.uniform(0.2 * size, 0.8 * size, (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("judged", [False, True])
@pytest.mark.parametrize("name", sorted(CSVO_STREAMS))
def test_k4_on_hand_built_streams(csvo, dev, name, judged):
    """K4 against intersect_octree_csvo_plain on the hand-built streams
    (every pointer width, nodes of eight 4-byte pointers, crossings, the last
    word, word counts off a multiple of 4): every field of every ray
    equal, opaque and judged (the scene's texel alpha)."""
    words, root_ptr, depth, _stats = csvo_stream(name)
    w = torch.tensor(words.view(np.int32), device=dev)
    ro, rd = _stream_rays(4096, depth, 17)
    args = (w, 2.0 ** -depth, root_ptr, depth,
            torch.tensor(ro, device=dev), torch.tensor(rd, device=dev),
            -1.0, judged)
    alpha = shading.make_alpha_fn(csvo.mips, csvo.mat_tex)
    n0 = traversal_csvo.launches
    k = traversal_csvo.intersect_octree_csvo(*args, alpha_fn=alpha)
    p = traversal_csvo.intersect_octree_csvo_plain(*args, alpha)
    torch.cuda.synchronize()
    assert traversal_csvo.launches == n0 + 1
    assert 400 < int((k.t >= 0).sum()) < 4000
    for f in ("t", "value", "face_id", "pos", "uv", "lod", "inside_voxel",
              "steps"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CSVO_STREAMS))
def test_k3_csvo_on_hand_built_streams(csvo, dev, name):
    """K3's CSVO instantiation on the hand-built streams against the plain
    frame (the scene's textures; 96x64, with shadows): max |d| <= 1e-6."""
    words, root_ptr, depth, _stats = csvo_stream(name)
    world = traversal_csvo.CsvoBuffer(
        torch.tensor(words.view(np.int32), device=dev), root_ptr, depth)
    size = float(1 << depth)
    W, H = 96, 64
    fwd = np.array([0.45, -0.35, 0.8], np.float32)
    p = RenderParams(cam_pos=np.array([-0.1, 0.9, -0.2], np.float32) * size,
                     cam_fwd=fwd / np.linalg.norm(fwd), aspect_ratio=W / H,
                     fov_y_rad=np.radians(70.0), render_shadows=True,
                     shadow_distance=4.0 * size)
    kw = csvo.frame_kwargs(p, W, H)
    n0 = shading.launches_csvo
    img = shading.render_frame(world, 2.0 ** -depth, csvo.mips,
                               csvo.mat_params, csvo.mat_tex, **kw)
    ref = shading.render_frame_plain(world, 2.0 ** -depth, csvo.mips,
                                     csvo.mat_params, csvo.mat_tex, **kw)
    torch.cuda.synchronize()
    assert shading.launches_csvo == n0 + 1
    assert img.shape == (H, W, 4) and bool(torch.isfinite(img).all())
    assert float((img - ref).abs().max()) <= K3_MAX_ABS


@pytest.mark.cuda
def test_crosshair_on_the_card_equals_the_cpu(dev):
    rng = np.random.default_rng(3)
    img = torch.tensor(rng.random((97, 130, 4)), dtype=torch.float32)
    cpu = shading.crosshair_overlay(img)
    card = shading.crosshair_overlay(img.to(dev)).cpu()
    assert torch.equal(card, cpu)


# ---------------------------------------------------------------------------
# K6, K7, K8, the floored traversals and the deferred frame
# ---------------------------------------------------------------------------

K3_MAX_ABS = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n,density,size", [
    (1, 1.0, 1), (1000, 0.0, 1000), (4097, 1.0, 4097), (5000, 0.5, 700),
    (1024 * 37 + 5, 0.3, 1024 * 37 + 5), (2_073_600, 0.6, 2_073_600),
    (2_073_600, 0.001, 4096)])
def test_k6_equals_plain(dev, n, density, size):
    rng = np.random.default_rng(n + size)
    mask = torch.tensor(rng.random(n) < density, device=dev)
    n0 = compact.launches
    idx, count = compact.compact_indices(mask, size)
    pidx, pcount = compact.compact_indices_plain(mask, size)
    torch.cuda.synchronize()
    assert compact.launches == n0 + 1
    assert torch.equal(idx, pidx) and torch.equal(count, pcount)
    # the library call that computes the same function
    want = torch.nonzero(mask).flatten()[:size].to(torch.int32)
    assert torch.equal(idx[: want.shape[0]], want)


K6_TILE = 8192  # lanes of a K6 tile (csrc/k6_compact.cuh)


def _k6_check(mask, size, starts_m=None, **ws):
    """K6 against its plain version: indices, count and starts equal."""
    ks = None if starts_m is None else torch.full(
        (starts_m,), -1, dtype=torch.int32, device=mask.device)
    ps = None if ks is None else ks.clone()
    idx, count = compact.compact_indices(mask, size, starts=ks, **ws)
    pidx, pcount = compact.compact_indices_plain(mask, size, starts=ps)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx) and torch.equal(count, pcount)
    assert ks is None or torch.equal(ks, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [K6_TILE - 1, K6_TILE, K6_TILE + 1,
                               3 * K6_TILE - 1, 3 * K6_TILE + 1,
                               300 * K6_TILE + 1])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_k6_tile_boundaries(dev, n, density):
    """n = tile * k +- 1: the scalar tail of the last tile, and a size
    below and above the count."""
    rng = np.random.default_rng(n)
    mask = torch.tensor(rng.random(n) < density, device=dev)
    _k6_check(mask, n)
    _k6_check(mask, n // 3)
    _k6_check(mask, n + 100)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 15])
def test_k6_mask_sliced_at_an_odd_offset(dev, offset):
    """A mask that starts at any byte: the head before the first 16-byte
    boundary is read with scalar loads."""
    rng = np.random.default_rng(offset)
    n = 5 * K6_TILE + 77
    base = torch.tensor(rng.random(n + offset) < 0.4, device=dev)
    mask = base[offset:]
    assert mask.data_ptr() % 16 == offset % 16
    _k6_check(mask, n)
    _k6_check(mask, 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(3000, 3000), (7 * K6_TILE, 7),
                                 (5 * 12_345, 5), (3 * 1000, 3)])
def test_k6_starts(dev, n, m):
    """``starts`` with segment 1, and with segments that are not a
    multiple of the tile."""
    rng = np.random.default_rng(n + m)
    mask = torch.tensor(rng.random(n) < 0.5, device=dev)
    _k6_check(mask, n, starts_m=m)


@pytest.mark.cuda
def test_k6_calls_in_a_row_on_one_workspace(dev):
    """Calls on one scratch: the status words and the tile counter an
    earlier call left must not be read as this call's (a larger mask, then
    smaller ones, then the larger again)."""
    rng = np.random.default_rng(11)
    big = 9 * K6_TILE + 5
    scratch = torch.zeros(_build.k6_blocks(big), dtype=torch.int32,
                          device=dev)
    for n, p in [(big, 0.5), (2 * K6_TILE, 0.9), (big, 0.1), (100, 0.5),
                 (big, 1.0), (big, 0.0), (0, 0.5), (big, 0.7)]:
        mask = torch.tensor(rng.random(n) < p, device=dev)
        out = torch.full((n,), -1, dtype=torch.int32, device=dev)
        count = torch.full((1,), -1, dtype=torch.int32, device=dev)
        _k6_check(mask, n, out=out, count=count, scratch=scratch)
    assert int(scratch[0]) == 0  # the tile counter, back to 0


def _terrain_chunk(cx, cz, glass_tower=False):
    """tests/test_beams.py's terrain chunk."""
    vox = np.zeros((32, 32, 32), np.uint32)
    x = np.arange(32) + cx * 32
    z = np.arange(32) + cz * 32
    hh = (10 + 6 * np.sin(x[:, None] * 0.11)
          + 5 * np.cos(z[None, :] * 0.17)).astype(np.int32)
    for ix in range(32):
        for iz in range(32):
            h = max(1, hh[ix, iz])
            vox[ix, : h - 1, iz] = content.STONE
            vox[ix, h - 1, iz] = content.GRASS
    if glass_tower:
        vox[12:15, 14:26, 12:15] = content.GLASS
    return vox


def _terrain(dev, fmt, glass):
    world, chunk, dtype = ((Esvo(), SerializedChunk, np.uint32) if fmt == "esvo"
                           else (Csvo(), CsvoSerializedChunk, np.uint8))
    s = Svo(content.new_registry(), capacity_mb=8, buffer_dtype=dtype,
            device=dev)
    lut = opaque_lut_from_mask(s.translucent_block_mask)
    hf = HeightField()
    for cx in range(3):
        for cz in range(3):
            vox = _terrain_chunk(cx, cz, glass_tower=glass and cx == cz == 1)
            world.set_leaf(Position(cx, 0, cz),
                           chunk.from_voxels(ChunkPos(cx, 0, cz), vox, 5), True)
            hf.set_chunk((cx, 0, cz), chunk_column_tops(vox, 5),
                         vtops=chunk_voxel_tops(vox, 5),
                         sbase=chunk_solid_bases(vox, 5, lut))
    world.serialize()
    s.update(world)
    s.set_heightfield(hf)
    assert s.is_opaque() == (not glass)
    return s


TW, TH = 640, 360
TCAMS = {
    "horizon": ([48.0, 30.0, -20.0], [0.0, -0.12, 1.0]),
    "down": ([48.0, 70.0, 48.0], [0.01, -1.0, 0.01]),
    "on-ground": ([40.0, 13.0, 40.0], [0.7, 0.05, 0.7]),
    "underground": ([49.0, 4.0, 49.0], [0.8, 0.1, 0.5]),
}


def _tparams(name):
    pos, fwd = TCAMS[name]
    fwd = np.asarray(fwd, np.float32)
    return RenderParams(cam_pos=np.asarray(pos, np.float32),
                        cam_fwd=fwd / np.linalg.norm(fwd),
                        aspect_ratio=TW / TH, fov_y_rad=np.radians(70.0),
                        render_shadows=True, shadow_distance=100.0)


@pytest.fixture(scope="module")
def terrains(dev):
    return {(fmt, glass): _terrain(dev, fmt, glass)
            for fmt, glass in (("esvo", False), ("esvo", True),
                               ("csvo", False), ("csvo", True))}


def _k7_origins(s, p, dev):
    """Shadow origins of pose ``p``'s primary hits (0.001 off the hit
    face), the hit lanes' list and count as K6 leaves them."""
    kw = s.frame_kwargs(p, TW, TH)
    ro, rd = shading.generate_rays(
        TW, TH, *(torch.tensor(kw[k], device=dev) for k in
                  ("cam_pos", "cam_right", "cam_up", "cam_fwd")),
        shading.tan_half_fov(p.fov_y_rad), float(np.float32(p.aspect_ratio)))
    res = traversal.intersect_octree(s.device_buf, s.octree_scale, ro, rd,
                                     -1.0, False)
    hit = res.t >= 0
    normal = shading.FACE_NORMALS.to(dev)[res.face_id.long().clamp(0, 5)]
    sro = (res.pos + normal * 0.001).contiguous()
    idx, count = compact.compact_indices(hit, hit.shape[0])
    return sro, idx, count


@pytest.mark.cuda
@pytest.mark.parametrize("cam", sorted(TCAMS))
def test_k7_k8_equal_plain(terrains, dev, cam):
    """K7's tile and shadow floors and K8's verdicts and floors against
    their plain versions, on the frame's own shadow origins (gathered and
    counted as the deferred frame feeds them)."""
    s = terrains[("esvo", False)]
    p = _tparams(cam)
    n7 = beams.launches_tile
    ctx = s.beam_context(p, TW, TH)
    assert beams.launches_tile == n7 + 1 and ctx.has_sun()
    kw = s.frame_kwargs(p, TW, TH)
    levels, offsets, n, hmax, bounds, levels_e = ctx._dev
    ccx = int(np.floor(kw["cam_pos"][0] / 8)) - 2
    ccz = int(np.floor(kw["cam_pos"][2] / 8)) - 2
    near = s.heightfield.near_window(ccx + 2, ccz + 2).astype(np.float32)
    plain = beams.tile_floors_plain(
        levels, offsets, n, hmax, bounds, near,
        np.array([ccx, ccz], np.float32), kw["cam_pos"], kw["cam_right"],
        kw["cam_up"], kw["cam_fwd"], shading.tan_half_fov(p.fov_y_rad),
        p.aspect_ratio, -1.0, width=TW, height=TH)
    assert torch.equal(ctx.tile_floors, plain)

    sro, idx, count = _k7_origins(s, p, dev)
    light = -np.asarray(p.light_dir, np.float32)
    md = torch.full((sro.shape[0],), -1.0, device=dev)
    sb, n1, d_len, d, origin = ctx._sun
    for gather in ((None, None, 0.0), (idx, count, ctx.sun_margin)):
        g = dict(idx=gather[0], count=gather[1])
        m = dict(margin=gather[2])
        k = beams.shadow_ray_floors(levels_e, levels[: n * n], offsets, n,
                                    hmax, bounds, sro, light, md, **g)
        pl = beams.shadow_ray_floors_plain(levels_e, levels[: n * n],
                                           offsets, n, hmax, bounds, sro,
                                           light, md, **g)
        assert torch.equal(k, pl)
        todo = torch.empty(md.shape[0], dtype=torch.bool, device=dev)
        kl, kb = beams.sun_verdict_masks(sb, n1, sro, md, d_len, d, origin,
                                         todo=todo, **g, **m)
        pl_, pb = beams.sun_verdict_masks_plain(sb, n1, sro, md, d_len, d,
                                                origin, **g, **m)
        assert torch.equal(kl, pl_) and torch.equal(kb, pb)
        assert torch.equal(todo, torch.arange(md.shape[0], device=dev)
                           .lt(int(count) if gather[1] is not None
                               else md.shape[0]) & ~pl_ & ~pb)
        kf = beams.sun_lit_floors(sb, n1, sro, md, d_len, d, origin, **g,
                                  **m)
        pf = beams.sun_lit_floors_plain(sb, n1, sro, md, d_len, d, origin,
                                        **g, **m)
        assert torch.equal(kf, pf)
    assert int(kl.sum()) > 0 or cam == "underground"


# K8's counts around its 16-lane pad words and past its lanes, K8_K of them
K8_K = TW * TH - 7  # not a multiple of 16
K8_COUNTS = (0, 1, 15, 16, 17, 1001, K8_K, K8_K + 5)
K8_OUTS = (("lit",), ("blk",), ("todo",), ("floors",),
           ("lit", "blk", "todo", "floors"))


@pytest.fixture(scope="module")
def k8_case(terrains, dev):
    """K8's inputs from the horizon camera's frame: the sun table, the
    shadow origins of its hits and their list (as K6 leaves it), cut to
    K8_K lanes."""
    s = terrains[("esvo", False)]
    p = _tparams("horizon")
    ctx = s.beam_context(p, TW, TH)
    sro, idx, _count = _k7_origins(s, p, dev)
    return ctx, sro, idx[:K8_K]


@pytest.mark.cuda
@pytest.mark.parametrize("count", K8_COUNTS)
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("limits", ["margin0", "margin-dlen", "margin"])
def test_k8_resident_equals_plain(k8_case, dev, count, gather, limits):
    """K8 on its resident grid against ``beams.k8_plain`` bit for bit: the
    counts around a 16-lane word, at and past the k lanes (k not a
    multiple of 16), a gather list or none, each output alone and all four
    together, margin 0 and the world's ``sun_margin``, no limits and
    per-lane limits around ``d_len``."""
    ctx, sro, idx = k8_case
    sb, n1, d_len, d, origin = ctx._sun
    margin = 0.0 if limits == "margin0" else ctx.sun_margin
    params = beams.sun_params(sb, n1, d_len, d, origin, margin)
    ro = sro if gather else sro[:K8_K].contiguous()
    g = idx if gather else None
    rng = np.random.default_rng(count)
    md = None
    if limits == "margin-dlen":
        lim = np.float32(d_len) + rng.uniform(-2.0, 2.0, K8_K)
        lim[rng.random(K8_K) < 0.2] = -1.0
        md = torch.tensor(lim, dtype=torch.float32, device=dev)
    cnt = torch.tensor([count], dtype=torch.int32, device=dev)
    for outs in K8_OUTS:
        def fresh():
            return {n: (torch.full((K8_K,), 7.0, device=dev)
                        if n == "floors" else
                        torch.ones(K8_K, dtype=torch.bool, device=dev))
                    if n in outs else None
                    for n in ("lit", "blk", "todo", "floors")}
        ko, po = fresh(), fresh()
        _build.launch_k8(sb, params, ro, md, g, cnt, K8_K, *ko.values())
        beams.k8_plain(sb, params, ro, md, g, cnt, K8_K, *po.values())
        torch.cuda.synchronize()
        for n in outs:
            assert _bits_equal(ko[n], po[n]), (outs, n)
    if 0 < count <= K8_K:
        assert int(po["lit"][:count].sum() + po["blk"][:count].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 1, 2, 3])
@pytest.mark.parametrize("off", [0, 4, 8, 12])
def test_k8_row_words_equal_plain(k8_case, dev, extra, off):
    """K8 on sun tables whose rows start on every 4-byte word of a 16-byte
    one: the terrain's table widened by ``extra`` bands that never claim
    (rows of 152 + 4K bytes for four K in a row, so a multiple of 16, of
    8 and neither) and copied ``off`` bytes past a 16-byte word, so that
    the launch reads its rows in every row word it may take; all four
    outputs against ``beams.k8_plain`` bit for bit."""
    ctx, sro, idx = k8_case
    sb, n1, d_len, d, origin = ctx._sun
    k = (sb.shape[1] - 76) // 2
    never = torch.full((sb.shape[0], extra), -1, dtype=torch.int16,
                       device=dev)  # raw 0xFFFF: lows no ray reaches
    wide = torch.cat([sb[:, :76 + k], never, sb[:, 76 + k:],
                      torch.zeros_like(never)], dim=1)
    buf = torch.empty(wide.numel() + 8, dtype=torch.int16, device=dev)
    table = buf[off // 2: off // 2 + wide.numel()].view(wide.shape)
    table.copy_(wide)
    params = beams.sun_params(table, n1, d_len, d, origin, ctx.sun_margin)
    cnt = torch.tensor([K8_K], dtype=torch.int32, device=dev)

    def fresh():
        return [torch.ones(K8_K, dtype=torch.bool, device=dev)
                for _ in range(3)] + [torch.full((K8_K,), 7.0, device=dev)]
    ko, po = fresh(), fresh()
    _build.launch_k8(table, params, sro, None, idx, cnt, K8_K, *ko)
    beams.k8_plain(table, params, sro, None, idx, cnt, K8_K, *po)
    torch.cuda.synchronize()
    for a, b in zip(ko, po):
        assert _bits_equal(a, b)
    assert int(po[0].sum() + po[1].sum()) > 0


# K7's tile floors: frame sizes, cameras past TCAMS and march budgets
# that end mid-descent
K7_SIZES = ((1, 1), (8, 8), (9, 9), (15, 12), (33, 17), (1001, 597),
            (1920, 1080))
K7_CAMS = {**TCAMS,
           "up": ([48.0, 40.0, 48.0], [0.002, 1.0, 0.001]),
           "straight-down": ([48.0, 60.0, 48.0], [0.0, -1.0, 0.0005]),
           "graze": ([48.0, 22.5, -10.0], [0.0, -0.004, 1.0]),
           "near-window": ([44.0, 9.0, 44.0], [0.3, -0.2, 0.9])}
K7_BUDGETS = (1, 2, 3, 5, 8, 96)


@pytest.fixture(scope="module")
def wide_field():
    """An envelope of 16 x 16 chunks of random column tops: 64 x 64
    columns, a pyramid of 5,461 ints, more than a tile block stages in
    shared memory (4,096 ints: ``K7_STAGE_INTS`` of
    ``csrc/k7_beams.cuh``), so its launches read it from global memory;
    the terrain's 16 x 16 columns, a pyramid of 341 ints, are staged."""
    rng = np.random.default_rng(19)
    hf = HeightField()
    for cx in range(16):
        for cz in range(16):
            hf.set_chunk((cx, 0, cz),
                         rng.integers(0, 24, (4, 4)).astype(np.int16))
    return hf


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["terrain", "wide"])
@pytest.mark.parametrize("size", K7_SIZES)
@pytest.mark.parametrize("cam", sorted(K7_CAMS))
def test_k7_tiles_equal_plain(terrains, wide_field, dev, size, cam, field):
    """K7's tile floors (a group of lanes a tile, the descents at once,
    the pyramid staged in shared memory or read from global memory)
    against ``beams.k7_tiles_plain`` bit for bit (as words: no -0 where
    the plain version has +0) at every budget; straight
    up every tile of a full frame over the terrain misses (a tile of a
    small frame is a wide cone, whose padded near boxes hold the
    camera)."""
    s = terrains[("esvo", False)]
    hf = s.heightfield if field == "terrain" else wide_field
    w, h = size
    pos, fwd = K7_CAMS[cam]
    fwd = np.asarray(fwd, np.float32)
    p = RenderParams(cam_pos=np.asarray(pos, np.float32),
                     cam_fwd=fwd / np.linalg.norm(fwd), aspect_ratio=w / h,
                     fov_y_rad=np.radians(70.0))
    levels, offsets, n, hmax, bounds = hf.device(dev)[:5]
    kw = s.frame_kwargs(p, w, h)
    ccx = int(np.floor(kw["cam_pos"][0] / 8)) - 2
    ccz = int(np.floor(kw["cam_pos"][2] / 8)) - 2
    near = hf.near_window(ccx + 2, ccz + 2).astype(np.float32)
    for budget in K7_BUDGETS:
        params = beams.tile_params(
            offsets, n, hmax, near, np.array([ccx, ccz], np.float32),
            kw["cam_pos"], kw["cam_right"], kw["cam_up"], kw["cam_fwd"],
            shading.tan_half_fov(p.fov_y_rad), p.aspect_ratio, -1.0, w, h,
            budget)
        shape = (-(-h // 8), -(-w // 8))
        out = torch.full(shape, -7.0, device=dev)
        _build.launch_k7_tiles(levels, bounds, params, out)
        plain = beams.k7_tiles_plain(levels, bounds, params,
                                     torch.empty(shape, device=dev))
        torch.cuda.synchronize()
        assert _bits_equal(out, plain), budget  # a zero's sign too
        if cam == "up" and w >= 1001 and field == "terrain":
            assert bool(torch.isinf(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("cam", sorted(TCAMS))
def test_floored_traversal_equals_unfloored(terrains, dev, fmt, cam):
    """K1 / K4 from the pixel floors against their unfloored runs, and
    against their plain versions."""
    s = terrains[(fmt, True)]
    p = _tparams(cam)
    kw = s.frame_kwargs(p, TW, TH)
    ro, rd = shading.generate_rays(
        TW, TH, *(torch.tensor(kw[k], device=dev) for k in
                  ("cam_pos", "cam_right", "cam_up", "cam_fwd")),
        shading.tan_half_fov(p.fov_y_rad), float(np.float32(p.aspect_ratio)))
    tfl = s.beam_context(p, TW, TH).t_floor
    alpha = shading.make_alpha_fn(s.mips, s.mat_tex)
    if fmt == "esvo":
        head, fn, plain = ((s.device_buf, s.octree_scale),
                           traversal.intersect_octree,
                           traversal.intersect_octree_plain)
    else:
        w = s.world()
        head, fn, plain = ((w.words, s.octree_scale, w.root_ptr,
                            w.total_depth),
                           traversal_csvo.intersect_octree_csvo,
                           traversal_csvo.intersect_octree_csvo_plain)
    floored = fn(*head, ro, rd, -1.0, True, alpha, t_floor=tfl)
    free = fn(*head, ro, rd, -1.0, True, alpha)
    ref = plain(*head, ro, rd, -1.0, True, alpha, t_floor=tfl)
    torch.cuda.synchronize()
    for f in ("t", "value", "face_id", "inside_voxel"):
        assert torch.equal(getattr(floored, f), getattr(free, f)), f
    for f in floored._fields:
        assert torch.equal(getattr(floored, f), getattr(ref, f)), f
    if cam in ("horizon", "down"):
        assert int(floored.steps.sum()) < int(free.steps.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("glass", [False, True])
@pytest.mark.parametrize("cam", sorted(TCAMS))
def test_deferred_frame_equals_k3(terrains, dev, fmt, glass, cam):
    """The deferred frame (with beams and the sun map, with beams only,
    without a heightfield) against K3's fused frame and against the plain
    deferred frame (the stages' plain version); each stage launches once a
    frame, and the frame launches K6, K7 and, on the opaque branch with the
    sun map, K8."""
    s = terrains[(fmt, glass)]
    p = _tparams(cam)
    fused = s.render(p, TW, TH, mode="fused")
    ctx = s.beam_context(p, TW, TH)
    n6, n8 = compact.launches, beams.launches_sun
    n7 = beams.launches_shadow
    stages = ("launches_primary", "launches_shade", "launches_shadow",
              "launches_finish")
    nd = [getattr(shading, st) for st in stages]
    for b in (ctx, ctx.without_sun(), None):
        img = s.render(p, TW, TH, beams=b)
        ref = shading.render_frame_deferred_plain(
            s.world(), s.octree_scale, s.mips, s.mat_params, s.mat_tex,
            **s.frame_kwargs(p, TW, TH), opaque=s.is_opaque(), beams=b)
        torch.cuda.synchronize()
        assert float((img - fused).abs().max()) <= K3_MAX_ABS, b
        assert float((img - ref).abs().max()) <= K3_MAX_ABS, b
    assert [getattr(shading, st) - n for st, n in zip(stages, nd)] == [3] * 4
    assert compact.launches >= n6 + 2 * 3
    if not glass:
        assert beams.launches_sun == n8 + 1  # only with the sun map
        assert beams.launches_shadow == n7 + 1  # beams only: K7 floors
    else:
        assert beams.launches_sun_floors > 0 or not ctx.has_sun()


def _k9_inputs(s, p, dev):
    """(world, scale, FrameParams, tile floors) of a 640x360 frame."""
    kw = s.frame_kwargs(p, TW, TH)
    fp = shading.frame_params(mip_mode=shading.mip_mode_from_env(),
                              csvo=s.buffer_dtype == np.uint8, deferred=True,
                              **kw)
    return s.world(), float(s.octree_scale), fp, s.beam_context(
        p, TW, TH).tile_floors


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("cam", sorted(TCAMS))
def test_k9_trace_merge_finalize_equal_plain(terrains, dev, fmt, levels, cam):
    """K9's trace (a grid level, then each refine list), merge and
    finalize against their plain versions on the same inputs, level by
    level down to the pixels (torch.equal on every output)."""
    s = terrains[(fmt, False)]
    world, scale, fp, tf = _k9_inputs(s, _tparams(cam), dev)
    dims = adaptive.grid_dims(TW, TH, levels)
    recs = [torch.zeros((w * h, 8), dtype=torch.int32, device=dev)
            for w, h in dims]
    n0 = (adaptive.launches_trace, adaptive.launches_merge,
          adaptive.launches_finalize)
    adaptive.k9_trace(world, scale, fp, tf, levels, recs[levels])
    ref = adaptive.k9_trace_plain(world, scale, fp, tf, levels,
                                  torch.zeros_like(recs[levels]))
    assert torch.equal(recs[levels], ref)
    for k in range(levels - 1, -1, -1):
        n = recs[k].shape[0]
        refine = torch.empty(n, dtype=torch.bool, device=dev)
        adaptive.k9_merge(scale, fp, k, recs[k + 1], recs[k], refine)
        hi_p = torch.empty_like(recs[k])
        ref_p = torch.empty_like(refine)
        adaptive.k9_merge_plain(scale, fp, k, recs[k + 1], hi_p, ref_p)
        assert torch.equal(recs[k], hi_p) and torch.equal(refine, ref_p)
        ridx, rcount = compact.compact_indices(refine, n)
        before = recs[k].clone()
        adaptive.k9_trace(world, scale, fp, tf, k, recs[k], ridx, rcount)
        adaptive.k9_trace_plain(world, scale, fp, tf, k, before, ridx, rcount)
        assert torch.equal(recs[k], before)
        assert int(rcount) > 0
    B = TW * TH
    outs = [(torch.empty((B, 9), dtype=torch.int32, device=dev),
             torch.empty(B, dtype=torch.bool, device=dev),
             torch.zeros((TH, TW, 4), device=dev),
             torch.ones(B, dtype=torch.bool, device=dev),
             torch.ones(B, dtype=torch.bool, device=dev)) for _ in range(2)]
    adaptive.k9_finalize(scale, fp, recs[0], *outs[0])
    adaptive.k9_finalize_plain(scale, fp, recs[0], *outs[1])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert float((a.float() - b.float()).abs().max()) <= K3_MAX_ABS
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1]) and not outs[0][3].any()
    assert (adaptive.launches_trace - n0[0], adaptive.launches_merge - n0[1],
            adaptive.launches_finalize - n0[2]) == (levels + 1, levels, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("listed", [0, 1])
def test_k9_trace_of_an_empty_and_a_one_lane_refine_list(terrains, dev, fmt,
                                                         listed):
    """K9's trace of a refine list with no entry and with one: equal to the
    plain version, every other record untouched."""
    s = terrains[(fmt, False)]
    world, scale, fp, tf = _k9_inputs(s, _tparams(sorted(TCAMS)[0]), dev)
    w, h = adaptive.grid_dims(TW, TH, 1)[0]
    recs = torch.full((w * h, 8), 7, dtype=torch.int32, device=dev)
    refine = torch.zeros(w * h, dtype=torch.bool, device=dev)
    refine[(w * h) // 2 + 3: (w * h) // 2 + 3 + listed] = True
    ridx, rcount = compact.compact_indices(refine, w * h)
    before = recs.clone()
    adaptive.k9_trace(world, scale, fp, tf, 0, recs, ridx, rcount)
    adaptive.k9_trace_plain(world, scale, fp, tf, 0, before, ridx, rcount)
    torch.cuda.synchronize()
    assert int(rcount) == listed
    assert torch.equal(recs, before)
    assert int((recs != 7).any(1).sum()) <= listed


def _k9_fp(s, p, width, height):
    """The FrameParams of a ``width`` x ``height`` frame of pose ``p``."""
    return shading.frame_params(
        mip_mode=shading.mip_mode_from_env(), csvo=s.buffer_dtype == np.uint8,
        deferred=True, **s.frame_kwargs(p, width, height))


def _k9_traced(s, poses, width, height, level, dev):
    """(FrameParams of pose 0, cams or None, the unfloored records of grid
    level ``level`` of every pose, pose-major) from K9's trace."""
    fps = [_k9_fp(s, p, width, height) for p in poses]
    cams = None if len(fps) == 1 else torch.tensor(
        [list(f.cam_pos) + list(f.right) + list(f.up) + list(f.fwd)
         for f in fps], dtype=torch.float32, device=dev)
    w, h = adaptive.grid_dims(width, height, level)[level]
    recs = torch.zeros((len(fps) * w * h, 8), dtype=torch.int32, device=dev)
    adaptive.k9_trace(s.world(), float(s.octree_scale), fps[0], None, level,
                      recs, cams=cams)
    return fps[0], cams, recs


# frame sizes whose grids are odd, even and not multiples of the merge's
# 32 x 8 tile, and a 1 x N and an N x 1 frame
K9_SIZES = [(37, 21), (64, 48), (70, 34), (161, 93), (1, 40), (40, 1)]


def _merge_check(s, dev, poses, size, level):
    fp, cams, lo = _k9_traced(s, poses, *size, level + 1, dev)
    wh, hh = adaptive.grid_dims(*size, level)[level]
    n = len(poses) * wh * hh
    hi = torch.full((n, 8), 77, dtype=torch.int32, device=dev)
    refine = torch.ones(n, dtype=torch.bool, device=dev)
    hi_p, refine_p = hi.clone(), refine.clone()
    n0 = adaptive.launches_merge
    scale = float(s.octree_scale)
    adaptive.k9_merge(scale, fp, level, lo, hi, refine, cams=cams)
    adaptive.k9_merge_plain(scale, fp, level, lo, hi_p, refine_p, cams=cams)
    torch.cuda.synchronize()
    assert adaptive.launches_merge == n0 + 1
    assert torch.equal(hi, hi_p) and torch.equal(refine, refine_p)
    # the fill ran: some interior lane hit without a re-trace
    assert bool((((hi_p[:, 6] & 1) != 0) & ~refine_p).any())


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("size", K9_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k9_merge_tiles_equal_plain(terrains, dev, size, level):
    """K9's merge (a block a 32 x 8 tile of the hi grid, its lo patch and
    its hi rows moved as 16-byte words through shared memory) against its
    plain version bit for bit, where the tiles and the clamped last row
    and column meet the grid's edges."""
    _merge_check(terrains[("esvo", False)], dev, [_tparams("horizon")], size,
                 level)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("size", [(45, 27), (70, 34)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k9_merge_of_a_batch_equals_plain(terrains, dev, size, level):
    """K9's merge of 3 poses in one launch, whose tiles end at each pose's
    last row (no tile crosses a pose), against its plain version pose by
    pose, bit for bit."""
    _merge_check(terrains[("esvo", False)], dev,
                 [_tparams(c) for c in BATCH_CAMS], size, level)


def _k9_pose(kind):
    """A pose whose pixels all hit ("hit": a 20-degree view straight down
    onto the terrain), all miss ("miss": straight up) or both ("mixed")."""
    if kind == "mixed":
        return _tparams("horizon")
    fwd = np.asarray([0.01, -1.0 if kind == "hit" else 1.0, 0.01],
                     np.float32)
    return RenderParams(cam_pos=np.asarray([48.0, 70.0, 48.0], np.float32),
                        cam_fwd=fwd / np.linalg.norm(fwd),
                        aspect_ratio=TW / TH, fov_y_rad=np.radians(20.0),
                        render_shadows=True, shadow_distance=100.0)


def _finalize_check(s, dev, poses, size):
    fp, cams, frec = _k9_traced(s, poses, *size, 0, dev)
    W, H = size
    B = len(poses) * W * H
    img_shape = (H, W, 4) if cams is None else (len(poses), H, W, 4)
    outs = [(torch.full((B, 9), 5, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev),
             torch.full(img_shape, 3.0, device=dev),
             torch.ones(B, dtype=torch.bool, device=dev),
             torch.ones(B, dtype=torch.bool, device=dev)) for _ in range(2)]
    scale = float(s.octree_scale)
    adaptive.k9_finalize(scale, fp, frec, *outs[0], cams=cams)
    adaptive.k9_finalize_plain(scale, fp, frec, *outs[1], cams=cams)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*outs)):
        if i == 2:  # the sky: within 1e-6 (acosf)
            assert float((a - b).abs().max()) <= K3_MAX_ABS
        else:
            assert torch.equal(a, b), i
    assert not outs[0][3].any() and not outs[0][4].any()
    return int(outs[1][1].sum()), B


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "hit", "miss"])
@pytest.mark.parametrize("size", [(37, 21), (64, 48), (33, 1), (161, 93)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k9_finalize_equals_plain(terrains, dev, size, kind):
    """K9's finalize (a block's 128 records loaded and its 128 HitRecs and
    flags stored as 16-byte words through shared memory; a last block of
    fewer pixels stores its tail word by word) against its plain version:
    every HitRec, flag and cleared mask bit for bit, the sky within 1e-6,
    at frame sizes that are not multiples of 128, on records that all hit,
    all miss, or both."""
    hits, B = _finalize_check(terrains[("esvo", False)], dev,
                              [_k9_pose(kind)], size)
    assert hits == {"hit": B, "miss": 0}.get(kind, hits)
    # (the horizon pose's one-row frame hits on every pixel)
    assert kind != "mixed" or size[1] == 1 or 0 < hits < B


@pytest.mark.cuda
def test_k9_finalize_of_a_batch_equals_plain(terrains, dev):
    """K9's finalize of 3 poses in one launch (blocks across the poses'
    boundaries) against its plain version pose by pose."""
    hits, B = _finalize_check(terrains[("esvo", False)], dev,
                              [_tparams(c) for c in BATCH_CAMS], (37, 21))
    assert 0 < hits < B


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trace", "merge", "finalize"])
def test_k9_refuses_records_off_a_16_byte_word(terrains, dev, kernel):
    """A record tensor viewed 4 bytes into its storage is refused by the
    wrapper (the kernels' 16-byte accesses would fault), before a launch."""
    s = terrains[("esvo", False)]
    fp = _k9_fp(s, _tparams("horizon"), 37, 21)
    scale = float(s.octree_scale)

    def recs(level, shift=0):
        w, h = adaptive.grid_dims(37, 21, level)[level]
        buf = torch.zeros(w * h * 8 + 1, dtype=torch.int32, device=dev)
        return buf[shift:shift + w * h * 8].view(w * h, 8)

    B = 37 * 21
    n0 = (adaptive.launches_trace, adaptive.launches_merge,
          adaptive.launches_finalize)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "trace":
            adaptive.k9_trace(s.world(), scale, fp, None, 1, recs(1, 1))
        elif kernel == "merge":
            adaptive.k9_merge(scale, fp, 0, recs(1, 1), recs(0),
                              torch.empty(B, dtype=torch.bool, device=dev))
        else:
            adaptive.k9_finalize(
                scale, fp, recs(0, 1),
                torch.empty((B, 9), dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev),
                torch.empty((21, 37, 4), device=dev),
                torch.empty(B, dtype=torch.bool, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev))
    assert (adaptive.launches_trace, adaptive.launches_merge,
            adaptive.launches_finalize) == n0


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("cam", sorted(TCAMS))
def test_adaptive_frame_equals_plain(terrains, dev, fmt, cam, monkeypatch):
    """The adaptive frame (with beams and the sun map, with beams only,
    without a heightfield) against ``render_frame_adaptive_plain`` (max |d|
    1e-6) and within the thick-ray budget of K3's fused frame; each K9
    kernel launches; K9's shadow cells, both steps, against their plain
    version on the frame's own inputs."""
    monkeypatch.delenv("VOXELRS_HIERARCHY", raising=False)
    s = terrains[(fmt, False)]
    p = _tparams(cam)
    fused = s.render(p, TW, TH, mode="fused")
    ctx = s.beam_context(p, TW, TH)
    counts = ("launches_trace", "launches_merge", "launches_finalize",
              "launches_shadow_cells")
    n0 = [getattr(adaptive, c) for c in counts]
    for b in (ctx, ctx.without_sun(), None):
        img = s.render(p, TW, TH, beams=b, adaptive=True)
        assert s.last_frame["adaptive"] and s.last_frame["hierarchy"] == 1
        ref = adaptive.render_frame_adaptive_plain(
            s.world(), s.octree_scale, s.mips, s.mat_params, s.mat_tex,
            **s.frame_kwargs(p, TW, TH), beams=b, levels=2)
        torch.cuda.synchronize()
        assert float((img - ref).abs().max()) <= K3_MAX_ABS, b
        # the traced (quarter) grid's pixels are K3's
        a, e = img.cpu().numpy(), fused.cpu().numpy()
        ids = adaptive.grid_pixel_ids(TW, TH, 2).numpy()
        assert float(np.abs(a.reshape(-1, 4)[ids]
                            - e.reshape(-1, 4)[ids]).max()) <= K3_MAX_ABS
        d = np.abs(a.astype(np.float64) - e)
        assert d.mean() < 0.002 and (d.max(-1) > 1e-3).mean() < 0.02
    assert [getattr(adaptive, c) - n for c, n in zip(counts, n0)] == \
        [3 * 3, 3 * 2, 3, 3 * 2]
    # the shadow cells on this frame's own inputs (the last frame: no
    # heightfield)
    ws = s._workspace
    ab = ws.adaptive(TW, TH, 2)
    fp = _k9_inputs(s, p, dev)[2]
    for step in (1, 2):
        args = [t.clone() for t in (ws.hidx, ws.hcount, ws.need, ab.needp,
                                    ab.blkp, ab.mask, ab.dense, ws.color,
                                    ws.ds, img)]
        plain = [t.clone() for t in args]
        adaptive.k9_shadow_cells(step, fp, *args)
        adaptive.k9_shadow_cells_plain(step, fp, *plain)
        torch.cuda.synchronize()
        for a, b in zip(args, plain):
            # floats as their words: the buffers' unwritten tails (past the
            # hit count) may hold NaNs, equal in both copies
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), step
    # the flat path (the half grid traced): its pixels are K3's
    monkeypatch.setenv("VOXELRS_HIERARCHY", "0")
    flat = s.render(p, TW, TH, beams=ctx, adaptive=True).cpu().numpy()
    assert s.last_frame["hierarchy"] == 0
    ids = adaptive.grid_pixel_ids(TW, TH, 1).numpy()
    e = fused.cpu().numpy().reshape(-1, 4)
    assert float(np.abs(flat.reshape(-1, 4)[ids] - e[ids]).max()) \
        <= K3_MAX_ABS


# ---- K9-judged: the adaptive frame of a translucent world ------------------

def _judged_chunk(cx, cz):
    """tests/test_torch_judged.py's chunk: the terrain with a water pool
    below y 9, a glass wall and a one-voxel leaf canopy on a trunk."""
    vox = _terrain_chunk(cx, cz)
    for ix in range(32):
        for iz in range(32):
            top = int(np.flatnonzero(vox[ix, :, iz])[-1]) + 1
            vox[ix, top:9, iz] = content.WATER
    if (cx, cz) == (1, 1):
        vox[8:20, 12:22, 14] = content.GLASS
    if (cx, cz) == (0, 1):
        vox[20, 10:19, 8] = content.OAK_LOG
        vox[14:27, 19, 2:15] = content.OAK_LEAVES
    return vox


def _judged_scene(dev, fmt):
    world, chunk, dtype = ((Esvo(), SerializedChunk, np.uint32) if fmt == "esvo"
                           else (Csvo(), CsvoSerializedChunk, np.uint8))
    s = Svo(content.new_registry(), capacity_mb=8, buffer_dtype=dtype,
            device=dev)
    lut = opaque_lut_from_mask(s.translucent_block_mask)
    hf = HeightField()
    for cx in range(2):
        for cz in range(2):
            vox = _judged_chunk(cx, cz)
            world.set_leaf(Position(cx, 0, cz),
                           chunk.from_voxels(ChunkPos(cx, 0, cz), vox, 5), True)
            hf.set_chunk((cx, 0, cz), chunk_column_tops(vox, 5),
                         vtops=chunk_voxel_tops(vox, 5),
                         sbase=chunk_solid_bases(vox, 5, lut))
    world.serialize()
    s.update(world)
    s.set_heightfield(hf)
    assert not s.is_opaque()
    return s


JCAMS = {
    "overview": ([30.0, 28.0, 20.0], [0.3, -0.6, 0.7]),
    "canopy": ([8.0, 26.0, 60.0], [0.6, -0.5, -0.5]),
    "sky": ([30.0, 14.0, 20.0], [0.3, 0.5, 0.7]),
}


def _jparams(name):
    pos, fwd = JCAMS[name]
    fwd = np.asarray(fwd, np.float32)
    return RenderParams(cam_pos=np.asarray(pos, np.float32),
                        cam_fwd=fwd / np.linalg.norm(fwd),
                        aspect_ratio=TW / TH, fov_y_rad=np.radians(70.0),
                        render_shadows=True, shadow_distance=100.0)


@pytest.fixture(scope="module")
def judged_scenes(dev):
    return {fmt: _judged_scene(dev, fmt) for fmt in ("esvo", "csvo")}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("hole_fill", [False, True])
@pytest.mark.parametrize("cam", sorted(JCAMS))
def test_k9j_trace_merge_finalize_equal_plain(judged_scenes, dev, fmt,
                                              hole_fill, cam):
    """K9-judged's trace (the quarter grid, then each refine list), merge
    and finalize against their plain versions on the same inputs, level
    by level down to the pixels (torch.equal on every output; the sky
    within 1e-6)."""
    from voxelrs_tpu_torch.ops import adaptive_judged as aj

    s = judged_scenes[fmt]
    world, scale, fp, tf = _k9_inputs(s, _jparams(cam), dev)
    tables = s.kernel_tables()
    levels = adaptive.frame_levels(TW, TH, False, True)
    assert levels == 2
    dims = adaptive.grid_dims(TW, TH, levels)
    recs = [torch.zeros((w * h, aj.REC_WORDS), dtype=torch.int32, device=dev)
            for w, h in dims]
    n0 = (aj.launches_trace, aj.launches_merge, aj.launches_finalize)
    aj.k9j_trace(world, scale, tables, fp, tf, levels, recs[levels])
    ref = aj.k9j_trace_plain(world, scale, tables, fp, tf, levels,
                             torch.zeros_like(recs[levels]))
    assert torch.equal(recs[levels], ref)
    for k in range(levels - 1, -1, -1):
        n = recs[k].shape[0]
        refine = torch.empty(n, dtype=torch.bool, device=dev)
        aj.k9j_merge(scale, tables, fp, k, recs[k + 1], recs[k], refine,
                     hole_fill)
        hi_p = torch.empty_like(recs[k])
        ref_p = torch.empty_like(refine)
        aj.k9j_merge_plain(scale, tables, fp, k, recs[k + 1], hi_p, ref_p,
                           hole_fill)
        assert torch.equal(recs[k], hi_p) and torch.equal(refine, ref_p)
        ridx, rcount = compact.compact_indices(refine, n)
        before = recs[k].clone()
        aj.k9j_trace(world, scale, tables, fp, tf, k, recs[k], ridx, rcount)
        aj.k9j_trace_plain(world, scale, tables, fp, tf, k, before, ridx,
                           rcount)
        assert torch.equal(recs[k], before)
    B = TW * TH
    outs = [(torch.empty((B, 9), dtype=torch.int32, device=dev),
             torch.empty(B, dtype=torch.bool, device=dev),
             torch.zeros((TH, TW, 4), device=dev),
             torch.ones(B, dtype=torch.bool, device=dev),
             torch.ones(B, dtype=torch.bool, device=dev)) for _ in range(2)]
    aj.k9j_finalize(fp, recs[0], *outs[0])
    aj.k9j_finalize_plain(fp, recs[0], *outs[1])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert float((a.float() - b.float()).abs().max()) <= K3_MAX_ABS
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1]) and not outs[0][3].any()
    assert (aj.launches_trace - n0[0], aj.launches_merge - n0[1],
            aj.launches_finalize - n0[2]) == (levels + 1, levels, 1)


def _k9j_records(B, kind, seed):
    """(B, 16) int32 judged records from a seed: t = -1 on a miss, words
    1-15 random and never 0 (a miss's too), so that a finalize which
    copies words past the HitRec's 9, or skips a miss's words, differs."""
    rng = np.random.default_rng(seed)
    rec = rng.integers(1, 1 << 31, (B, 16)).astype(np.int32)
    hit = {"hit": np.ones(B, bool), "miss": np.zeros(B, bool)}.get(
        kind, rng.random(B) < 0.5)
    t = np.where(hit, rng.uniform(0.5, 300.0, B), -1.0).astype(np.float32)
    rec[:, 0] = t.view(np.int32)
    return rec


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "hit", "miss"])
@pytest.mark.parametrize("size", [(1, 1), (127, 1), (129, 1), (37, 21),
                                  (1920, 1080)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k9j_finalize_equals_plain(csvo, dev, size, kind):
    """K9-judged's finalize (K9's finalize body: a block's 128 records'
    first three 16-byte words loaded and its HitRecs and flags stored as
    16-byte words through shared memory, a last block of fewer pixels
    word by word) against its plain version on records made from a seed:
    every HitRec, flag and cleared mask bit for bit, the sky within 1e-6,
    pixels that hit untouched, at sizes off 128 and 1080p."""
    from voxelrs_tpu_torch.ops import adaptive_judged as aj

    W, H = size
    B = W * H
    fp = _k9_fp(csvo, _k9_pose("mixed"), W, H)
    frec = torch.tensor(_k9j_records(B, kind, B), device=dev)
    outs = [(torch.full((B, 9), 5, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev),
             torch.full((H, W, 4), 3.0, device=dev),
             torch.ones(B, dtype=torch.bool, device=dev),
             torch.ones(B, dtype=torch.bool, device=dev)) for _ in range(2)]
    n0 = aj.launches_finalize
    aj.k9j_finalize(fp, frec, *outs[0])
    aj.k9j_finalize_plain(fp, frec, *outs[1])
    torch.cuda.synchronize()
    assert aj.launches_finalize == n0 + 1
    for i, (a, b) in enumerate(zip(*outs)):
        if i == 2:  # the sky: within 1e-6 (acosf)
            assert float((a - b).abs().max()) <= K3_MAX_ABS
        else:
            assert torch.equal(a, b), i
    hits = frec.view(torch.float32)[:, 0] != -1.0
    assert int(outs[0][1].sum()) == int(hits.sum())
    assert bool((outs[0][2].view(B, 4)[hits] == 3.0).all())
    assert not outs[0][3].any() and not outs[0][4].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["frec", "rec", "hit", "img", "needp",
                                  "blkp"])
def test_k9j_finalize_refuses_views_off_a_16_byte_word(csvo, dev, name):
    """Each of K9-judged's finalize's tensors viewed one element off a
    16-byte word is refused by the wrapper, before a launch."""
    from voxelrs_tpu_torch.ops import adaptive_judged as aj

    W, H = 37, 21
    B = W * H

    def view(shape, dtype, off):
        n = int(np.prod(shape))
        return torch.zeros(n + 16, dtype=dtype, device=dev)[
            off:off + n].view(shape)

    shapes = dict(frec=((B, 16), torch.int32), rec=((B, 9), torch.int32),
                  hit=((B,), torch.bool), img=((H, W, 4), torch.float32),
                  needp=((B,), torch.bool), blkp=((B,), torch.bool))
    args = [view(*shapes[k], 1 if k == name else 0) for k in shapes]
    fp = _k9_fp(csvo, _k9_pose("mixed"), W, H)
    n0 = aj.launches_finalize
    with pytest.raises(ValueError, match=f"{name}: expected a 16-byte"):
        aj.k9j_finalize(fp, *args)
    assert aj.launches_finalize == n0


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["k4", "k3", "k5", "kd_primary",
                                  "kd_shadow", "k9_trace", "k9j_trace"])
def test_csvo_paths_refuse_words_off_a_16_byte_word(csvo, dev, path):
    """A CSVO world whose words start one word off a 16-byte word (the
    CSVO kernels' launch contract) is refused with a
    ValueError by every CSVO launch path, before a launch."""
    from voxelrs_tpu_torch.ops import adaptive_judged as aj

    w = csvo.world()
    buf = torch.zeros(w.words.shape[0] + 4, dtype=torch.int32, device=dev)
    buf[1:1 + w.words.shape[0]].copy_(w.words)
    world = traversal_csvo.CsvoBuffer(buf[1:1 + w.words.shape[0]],
                                      w.root_ptr, w.total_depth)
    scale = float(csvo.octree_scale)
    W, H = 37, 21
    p = _k9_pose("mixed")
    fp = _k9_fp(csvo, p, W, H)
    tables = csvo.kernel_tables()
    rays = torch.zeros((5, 3), device=dev)
    counts = (traversal_csvo.launches, shading.launches, picker.launches,
              adaptive.launches_trace, aj.launches_trace)
    with pytest.raises(ValueError, match="words"):
        if path == "k4":
            traversal_csvo.intersect_octree_csvo(
                world.words, scale, world.root_ptr, world.total_depth, rays,
                rays + 1.0, -1.0, False)
        elif path == "k3":
            shading.render_frame(world, scale, csvo.mips, csvo.mat_params,
                                 csvo.mat_tex, **csvo.frame_kwargs(p, W, H))
        elif path == "k5":
            picker.raycast(world, scale, torch.zeros((5, 7), device=dev))
        elif path == "kd_primary":
            _build.launch_kd_primary(
                world, scale, tables, fp, 1, None,
                torch.empty((W * H, 9), dtype=torch.int32, device=dev),
                torch.empty(W * H, dtype=torch.bool, device=dev),
                torch.empty((H, W, 4), device=dev))
        elif path == "kd_shadow":
            idx = torch.zeros(16, dtype=torch.int32, device=dev)
            _build.launch_kd_shadow(
                world, scale, tables, fp, 1, torch.zeros((16, 3), device=dev),
                idx, idx[:1], None, None, None,
                torch.zeros(16, dtype=torch.bool, device=dev))
        elif path == "k9_trace":
            n = adaptive.grid_dims(W, H, 1)[1]
            adaptive.k9_trace(world, scale, fp, None, 1, torch.zeros(
                (n[0] * n[1], 8), dtype=torch.int32, device=dev))
        else:
            n = adaptive.grid_dims(W, H, 1)[1]
            aj.k9j_trace(world, scale, tables, fp, None, 1, torch.zeros(
                (n[0] * n[1], 16), dtype=torch.int32, device=dev))
    assert counts == (traversal_csvo.launches, shading.launches,
                      picker.launches, adaptive.launches_trace,
                      aj.launches_trace)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("cam", sorted(JCAMS))
def test_judged_adaptive_frame_equals_plain(judged_scenes, dev, fmt, cam,
                                            monkeypatch):
    """The judged adaptive frame (with beams and the sun map, whose
    certificates take the judged shadow rays; with beams only; without a
    heightfield) against ``render_frame_adaptive_judged_plain`` (max |d|
    1e-6) and within the JAX judged budget of K3's fused frame (the
    quarter grid's pixels equal, mean |d| < 0.004, under 3% of the pixels
    off by more than 1e-3, tests/test_torch_judged.py); K9-judged, K9's
    shadow cells, K6, K8 and the shading and shadow stages launch, the
    deferred primary stage does not."""
    from voxelrs_tpu_torch.ops import adaptive_judged as aj

    monkeypatch.delenv("VOXELRS_HIERARCHY", raising=False)
    monkeypatch.delenv("VOXELRS_HOLE_FILL", raising=False)
    s = judged_scenes[fmt]
    p = _jparams(cam)
    fused = s.render(p, TW, TH, mode="fused").cpu().numpy()
    ctx = s.beam_context(p, TW, TH)
    assert ctx.has_sun()
    ids = adaptive.grid_pixel_ids(TW, TH, 2).numpy()
    counts = [(aj, "launches_trace"), (aj, "launches_merge"),
              (aj, "launches_finalize"), (adaptive, "launches_shadow_cells"),
              (beams, "launches_sun"), (shading, "launches_primary"),
              (shading, "launches_shade"), (shading, "launches_shadow")]
    n0 = [getattr(m, c) for m, c in counts]
    for b in (ctx, ctx.without_sun(), None):
        img = s.render(p, TW, TH, beams=b, adaptive=True)
        assert s.last_frame["adaptive"] and s.last_frame["hierarchy"] == 1
        assert not s.last_frame["opaque"]
        ref = aj.render_frame_adaptive_judged_plain(
            s.world(), s.octree_scale, s.mips, s.mat_params, s.mat_tex,
            **s.frame_kwargs(p, TW, TH), beams=b, levels=2)
        torch.cuda.synchronize()
        assert float((img - ref).abs().max()) <= K3_MAX_ABS, b
        a = img.cpu().numpy()
        assert float(np.abs(a.reshape(-1, 4)[ids]
                            - fused.reshape(-1, 4)[ids]).max()) <= K3_MAX_ABS
        d = np.abs(a.astype(np.float64) - fused)
        assert d.mean() < 0.004 and (d.max(-1) > 1e-3).mean() < 0.03
    got = [getattr(m, c) - n for (m, c), n in zip(counts, n0)]
    assert got[:4] == [3 * 3, 3 * 2, 3, 3 * 2], got
    assert got[4] == 2 and got[5] == 0 and got[6] == 3 and got[7] == 6, got
    # the hole fill and the half grid: kernels against plain, still
    monkeypatch.setenv("VOXELRS_HOLE_FILL", "1")
    monkeypatch.setenv("VOXELRS_HIERARCHY", "0")
    img = s.render(p, TW, TH, beams=ctx, adaptive=True)
    assert s.last_frame["hierarchy"] == 0
    ref = aj.render_frame_adaptive_judged_plain(
        s.world(), s.octree_scale, s.mips, s.mat_params, s.mat_tex,
        **s.frame_kwargs(p, TW, TH), beams=ctx, levels=1)
    torch.cuda.synchronize()
    assert float((img - ref).abs().max()) <= K3_MAX_ABS


# ---- K10: a batch of poses -------------------------------------------------

BATCH_CAMS = ("horizon", "down", "on-ground")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
def test_batched_stages_equal_plain(terrains, dev, fmt, monkeypatch):
    """Each pose-batched K9 kernel and K6 with segment starts against its
    plain version on the batch's own inputs (3 poses, the quarter grid),
    bit for bit (the finalize's sky within 1e-6: acosf). The world's
    format picks the trace's instantiation (the CSVO one is reached by
    ``render_frames_opaque_batch`` on a CSVO world; ``Svo.render_batch``
    returns None for it, as in the JAX package)."""
    s = terrains[(fmt, False)]
    monkeypatch.setenv("VOXELRS_ADAPTIVE", "1")
    poses = [_tparams(c) for c in BATCH_CAMS]
    ctx0 = s.beam_context(poses[0], TW, TH)
    ctxs = [s.beam_context(p, TW, TH, shared_sun=ctx0._sun) for p in poses]
    kws = [s.frame_kwargs(p, TW, TH) for p in poses]
    cam_stack = tuple(np.stack([kw[k] for kw in kws]) for k in (
        "cam_pos", "cam_right", "cam_up", "cam_fwd"))
    k0 = kws[0]
    calls = {}
    names = ("k9_trace", "k9_merge", "k9_finalize", "k9_shadow_cells")
    for mod, name in [(adaptive, n) for n in names] + [(compact,
                                                        "compact_indices")]:
        fn = getattr(mod, name)
        calls[name] = []

        def run(*args, _fn=fn, _name=name, **kw):
            keep = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
            calls[_name].append(([keep(a) for a in args],
                                 {k: keep(v) for k, v in kw.items()}))
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, run)
    shading.render_frames_opaque_batch(
        s.world(), s.octree_scale, s.mips, s.mat_params, s.mat_tex, cam_stack,
        k0["fov_y_rad"], k0["aspect"], k0["ambient"], k0["light_dir"],
        k0["shadow_distance"], k0["highlight_pos"], width=TW, height=TH,
        render_shadows=True, beams_shared=ctx0,
        t_floor_stack=torch.stack([c.tile_floors for c in ctxs]))
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert [len(calls[n]) for n in names] == [3, 2, 1, 2]
    assert len(calls["compact_indices"]) == 7
    for name in names:
        kernel, plain = getattr(adaptive, name), getattr(adaptive,
                                                         f"{name}_plain")
        for args, kw in calls[name]:
            ka = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args]
            pa = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args]
            kernel(*ka, **kw)
            plain(*pa, **kw)
            torch.cuda.synchronize()
            for a, b in zip(ka, pa):
                if not isinstance(a, torch.Tensor):
                    continue
                if name == "k9_finalize" and a.dtype == torch.float32:
                    assert float((a - b).abs().max()) <= K3_MAX_ABS
                    continue
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b), name
    starts_seen = 0
    for (mask, size), kw in calls["compact_indices"]:
        st = kw.get("starts")
        ks = None if st is None else st.clone()
        ps = None if st is None else st.clone()
        ki, kc = compact.compact_indices(mask, size, starts=ks)
        pi, pc = compact.compact_indices_plain(mask, size, starts=ps)
        assert torch.equal(ki, pi) and torch.equal(kc, pc)
        if st is not None:
            starts_seen += 1
            assert torch.equal(ks, ps) and ks.shape[0] == len(poses)
    assert starts_seen == 1  # the hits' compaction


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["adaptive", "exact"])
def test_render_batch_equals_per_pose_render(terrains, dev, branch,
                                             monkeypatch):
    """``Svo.render_batch`` against ``Svo.render`` of each pose given pose
    0's sun map, bit for bit, with the batch's stage launches those of one
    frame (apart from the per-pose tile floors); the exact branch within
    1e-6 of K3's frames."""
    monkeypatch.setenv("VOXELRS_ADAPTIVE", "1" if branch == "adaptive"
                       else "0")
    s = terrains[("esvo", False)]
    poses = [_tparams(c) for c in BATCH_CAMS]
    s.render_batch(poses, TW, TH)
    counters = [(shading, f"launches_{st}") for st in
                ("primary", "shade", "shadow", "finish")] + [
        (compact, "launches"), (beams, "launches_tile"),
        (beams, "launches_sun")] + [
        (adaptive, f"launches_{k}") for k in ("trace", "merge", "finalize",
                                              "shadow_cells")]

    def launches(fn):
        n0 = [getattr(m, c) for m, c in counters]
        r = fn()
        torch.cuda.synchronize()
        return r, [getattr(m, c) - n for (m, c), n in zip(counters, n0)]

    imgs, nb = launches(lambda: s.render_batch(poses, TW, TH))
    _, n1 = launches(lambda: s.render(poses[0], TW, TH))
    tile = counters.index((beams, "launches_tile"))
    assert nb[tile] == len(poses) and n1[tile] == 1
    nb[tile] = n1[tile] = 0
    assert nb == n1 and any(nb)
    assert s.last_frame["adaptive"] == (branch == "adaptive")
    assert tuple(imgs.shape) == (len(poses), TH, TW, 4)
    sun0 = s.beam_context(poses[0], TW, TH)._sun
    for i, p in enumerate(poses):
        single = s.render(p, TW, TH,
                          beams=s.beam_context(p, TW, TH, shared_sun=sun0))
        assert torch.equal(imgs[i], single), i
        if branch == "exact":
            fused = s.render(p, TW, TH, mode="fused")
            assert float((imgs[i] - fused).abs().max()) <= K3_MAX_ABS
    # a CSVO and a translucent renderer give None, as in the JAX package
    assert terrains[("csvo", False)].render_batch(poses, TW, TH) is None
    assert terrains[("esvo", True)].render_batch(poses, TW, TH) is None


# ---- P0: the gather probe --------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flat", "axis0", "axis1", "two_step"])
def test_p0_equals_plain(dev, kind):
    """P0's kernel against its plain version, bit for bit: the probe's
    tables (rows 512, 4096, 16384; axis1 512) and a random one, at 512
    steps and 37."""
    from voxelrs_tpu_torch.probes import gather_probe as gp

    for _kind, rows, sub in gp.probe_configs([kind]):
        seeds = gp.random_words((sub, 128), seed=3, high=1 << 30,
                                device=dev)
        for tbl in (gp.arange_table(rows, dev),
                    gp.random_words((rows, 128), seed=rows, device=dev)):
            for steps in (gp.N_STEPS, 37):
                n0 = gp.launches
                got = gp.gather_probe(tbl, seeds, kind, steps)
                assert gp.launches == n0 + 1
                want = gp.gather_probe_plain(tbl, seeds, kind, steps)
                assert torch.equal(got, want), (rows, steps)


# ---- the shadow stage: kd_shadow and K9's shadow cells ---------------------

def _bits_equal(a, b):
    """Equal bit for bit (floats as their words: the buffers' unwritten
    tails may hold NaNs, equal in both copies)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _kd_shadow_check(args, kw=None):
    """One ``launch_kd_shadow`` call (its arguments) through the kernel and
    through ``kd_shadow_plain`` on copies of ``traced``: equal bit for
    bit; the slots it traced."""
    kw = kw or {}
    *head, traced = args
    k, p = traced.clone(), traced.clone()
    n0 = shading.launches_shadow
    _build.launch_kd_shadow(*head, k, **kw)
    shading.kd_shadow_plain(*head, p, **kw)
    torch.cuda.synchronize()
    assert shading.launches_shadow == n0  # the launch wrapper counts nothing
    assert torch.equal(k, p)
    sidx, scount, tidx, tcount = head[6:10]
    return min(int(scount if tidx is None else tcount), sidx.shape[0])


def _shadow_lanes(s, p, dev):
    """The exact deferred frame's hit lanes of pose ``p``: (FrameParams,
    shadow origins of the hit lanes, their count)."""
    s.render(p, TW, TH, adaptive=False)
    ws = s._workspace
    k = int(ws.hcount)
    return _k9_fp(s, p, TW, TH), ws.sro[:k].clone(), k


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("glass", [False, True])
@pytest.mark.parametrize("case", ["count 0", "count = size", "off a block",
                                  "sub-list", "floors"])
def test_kd_shadow_equals_plain(terrains, dev, fmt, glass, case):
    """The shadow stage's kernel (a resident grid looping over the slots
    up to the count on the card, the stack in shared memory) against
    ``kd_shadow_plain`` bit for bit: a count of 0, a count equal to the
    list's size, a count off the 64-thread block, an uncertified sub-list
    (``tidx``), K7's floors, opaque rays (alpha mode 0, the opaque
    terrain) and judged ones (1, the glass terrain), both formats."""
    s = terrains[(fmt, glass)]
    p = _tparams("horizon")
    fp, sro, k = _shadow_lanes(s, p, dev)
    assert k > 4096
    sidx = torch.arange(k, dtype=torch.int32, device=dev)
    count = {"count 0": 0, "off a block": 64 * 37 + 29}.get(case, k)
    scount = torch.tensor([count], dtype=torch.int32, device=dev)
    tidx = tcount = floors = None
    if case == "sub-list":
        g = torch.Generator().manual_seed(5)
        keep = torch.rand(k, generator=g) < 0.3
        tidx = torch.zeros(k, dtype=torch.int32, device=dev)
        sub = torch.nonzero(keep).flatten().to(torch.int32)
        tidx[: sub.shape[0]] = sub.to(dev)
        tcount = torch.tensor([sub.shape[0]], dtype=torch.int32, device=dev)
    if case == "floors":
        ctx = s.beam_context(p, TW, TH).without_sun()
        floors = ctx.shadow_ray_floors(
            sro, None, -np.asarray(p.light_dir, np.float32), idx=sidx,
            count=scount)
        assert bool(torch.isinf(floors).any()) or glass
    traced = torch.full((k,), True, dtype=torch.bool, device=dev)
    traced[::3] = False
    n = _kd_shadow_check((s.world(), float(s.octree_scale),
                          s.kernel_tables(), fp, int(glass), sro, sidx,
                          scount, tidx, tcount, floors, traced))
    assert n == (count if tidx is None else int(tcount))


@pytest.mark.cuda
@pytest.mark.parametrize("path,fmt", [
    (path, fmt) for path in ("exact", "adaptive", "judged")
    for fmt in ("esvo", "csvo")] + [("batch", "esvo")])
def test_kd_shadow_calls_of_frames_equal_plain(terrains, judged_scenes, dev,
                                               path, fmt, monkeypatch):
    """Every shadow-stage launch of the frames (the exact frame with the sun
    map's sub-list, with K7's floors and unfloored; the adaptive frame's
    two passes; the judged adaptive frame's judged rays; a batch of 3
    poses over the concatenated lanes, ESVO: ``Svo.render_batch`` renders
    no other) held to ``kd_shadow_plain`` on the call's own inputs, bit
    for bit."""
    calls = []
    launch = _build.launch_kd_shadow

    def spy(*args, **kw):
        keep = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
        calls.append([keep(a) for a in args])
        return launch(*args, **kw)

    monkeypatch.setattr(_build, "launch_kd_shadow", spy)
    if path == "judged":
        s = judged_scenes[fmt]
        p = _jparams("overview")
    else:
        s = terrains[(fmt, False)]
        p = _tparams("horizon")
    ctx = s.beam_context(p, TW, TH)
    if path == "batch":
        monkeypatch.setenv("VOXELRS_ADAPTIVE", "1")
        s.render_batch([_tparams(c) for c in BATCH_CAMS], TW, TH)
    else:
        for b in (ctx, ctx.without_sun(), None):
            s.render(p, TW, TH, beams=b, adaptive=path != "exact")
    torch.cuda.synchronize()
    monkeypatch.setattr(_build, "launch_kd_shadow", launch)
    assert len(calls) == {"exact": 3, "batch": 2}.get(path, 6)
    traced = [_kd_shadow_check(args) for args in calls]
    assert sum(traced) > 0
    if path != "batch":
        # with the sun map the uncertified sub-list, then K7's floors
        assert calls[0][8] is not None and calls[-1][10] is None
        assert calls[-1][8] is None


def _cells_inputs(W, H, n_poses, share, seed, dev):
    """Random inputs of K9's shadow cells for ``n_poses`` W x H poses whose
    pixels hit with probability ``share``: hidx, hcount, need, needp,
    blkp, mask, dense, color, ds, img, hstart (None for one pose); needp
    and blkp in 2 x 2 patches, so that some cells agree."""
    g = np.random.default_rng(seed)
    B = W * H * n_poses
    hit = torch.tensor(g.random(B) < share)
    starts = (None if n_poses == 1
              else torch.zeros(n_poses, dtype=torch.int32))
    hidx, hcount = compact.compact_indices_plain(hit, B, starts=starts)

    def patches(p_one):
        y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        cell = (y // 2) * (W // 2 + 1) + x // 2
        v = g.random((n_poses, cell.max() + 1)) < p_one
        return torch.tensor(v[:, cell].reshape(-1))

    t = lambda a: a.to(dev)  # noqa: E731
    return dict(
        hidx=t(hidx), hcount=t(hcount),
        need=t(torch.tensor(g.random(B) < 0.8)), needp=t(patches(0.8)),
        blkp=t(patches(0.5)), mask=t(torch.ones(B, dtype=torch.bool)),
        dense=t(torch.full((n_poses,), 7, dtype=torch.int32)),
        color=t(torch.tensor(g.random((B, 4)), dtype=torch.float32)),
        ds=t(torch.tensor(g.random(B), dtype=torch.float32)),
        img=t(torch.tensor(g.random((n_poses, H, W, 4)) if n_poses > 1
                           else g.random((H, W, 4)), dtype=torch.float32)),
        hstart=None if starts is None else t(starts))


def _cells_check(fp, inputs, step, count=None):
    """K9's shadow cells (step 1 or 2) against their plain version on
    copies of ``inputs`` (``count`` overrides the hit count), bit for bit;
    (hits, dense flags, mask lanes set)."""
    if count is not None:
        inputs = dict(inputs, hcount=torch.tensor(
            [count], dtype=torch.int32, device=inputs["hidx"].device))
    names = ("hidx", "hcount", "need", "needp", "blkp", "mask", "dense",
             "color", "ds", "img")
    k = [inputs[n].clone() for n in names]
    p = [inputs[n].clone() for n in names]
    hs = inputs["hstart"]
    n0 = adaptive.launches_shadow_cells
    adaptive.k9_shadow_cells(step, fp, *k, hstart=hs)
    adaptive.k9_shadow_cells_plain(step, fp, *p, hstart=hs)
    torch.cuda.synchronize()
    assert adaptive.launches_shadow_cells == n0 + 1
    for name, a, b in zip(names, k, p):
        assert _bits_equal(a, b), (step, name)
    return int(k[1]), k[6].tolist(), int(k[5].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("size,share", [((37, 21), 0.7), ((64, 48), 0.5),
                                        ((33, 1), 0.9), ((161, 93), 0.6),
                                        ((37, 21), 1.0), ((1001, 427), 0.05)],
                         ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple)
                         else str(v))
def test_k9_shadow_cells_equal_plain(terrains, dev, step, size, share):
    """K9's shadow cells (a resident grid; a thread's 4 lanes moved as a
    16-byte word of indices and 4-byte words of need and mask, the mask's
    tail as 16-byte zero words) against their plain version bit for bit,
    both steps: odd frame widths, hit counts that are not multiples of 4
    or 16, a count of 0, every pixel a hit (the count is the lane array's
    size), and a frame that is not dense (the single pass)."""
    W, H = size
    fp = _k9_fp(terrains[("esvo", False)], _tparams("horizon"), W, H)
    inputs = _cells_inputs(W, H, 1, share, W * 7 + step, dev)
    n = int(inputs["hcount"])
    assert (n == W * H) == (share == 1.0)
    hits, dense, _set = _cells_check(fp, inputs, step)
    if step == 1:
        assert dense == [int(adaptive.dense_frame(n, W * H))]
        assert dense == [0 if size == (1001, 427) else 1]
    for count in (0, n - n % 4 - 3, n - n % 16 - 3):
        if count >= 0:
            _cells_check(fp, inputs, step, count)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 2])
def test_k9_shadow_cells_of_a_batch_equal_plain(terrains, dev, step):
    """K9's shadow cells over 3 poses' hit lanes (each pose's dense flag from
    its own hits, ``hstart``) against their plain version, bit for bit."""
    W, H = 45, 27
    fp = _k9_fp(terrains[("esvo", False)], _tparams("horizon"), W, H)
    inputs = _cells_inputs(W, H, 3, 0.6, 11 + step, dev)
    _hits, dense, _set = _cells_check(fp, inputs, step)
    assert dense == ([1, 1, 1] if step == 1 else [7, 7, 7])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hidx", "need", "mask"])
def test_k9_shadow_cells_refuse_lanes_off_a_16_byte_word(terrains, dev, name):
    """A hit-index, need or mask tensor viewed off a 16-byte word is
    refused by the wrapper (the kernel moves them as 16- and 4-byte words
    from lane 0), before a launch."""
    W, H = 37, 21
    fp = _k9_fp(terrains[("esvo", False)], _tparams("horizon"), W, H)
    inputs = _cells_inputs(W, H, 1, 0.5, 3, dev)
    t = inputs[name]
    buf = torch.zeros(t.shape[0] + 4, dtype=t.dtype, device=dev)
    view = buf[1:1 + t.shape[0]]
    view.copy_(t)
    inputs[name] = view
    n0 = adaptive.launches_shadow_cells
    with pytest.raises(ValueError, match="16-byte aligned"):
        adaptive.k9_shadow_cells(1, fp, *(inputs[n] for n in (
            "hidx", "hcount", "need", "needp", "blkp", "mask", "dense",
            "color", "ds", "img")))
    assert adaptive.launches_shadow_cells == n0


# ---- the finishing stage (kd_finish) and K7's shadow floors ----------------

FINISH_CASES = {  # candidate count of the list: 0, every slot, a partial word
    "count 0": lambda m: 0, "count = size": lambda m: m,
    "off a block": lambda m: 512 * 5 + 129, "candidates": lambda m: m}


def _finish_inputs(fp, n_poses, case, certified, blkp, seed, dev):
    """``launch_kd_finish``'s arguments for ``n_poses`` poses of ``fp``'s
    W x H, from a seed: half the pixels hit (``hidx``, in order), a third
    of the hit lanes are candidates (``sidx``, in order, cut at the case's
    count),
    colours, lights and flags random. The list holds the frame's every
    lane ("count = size": exactly its candidates, an odd number), its
    slots past the count other hit lanes, all flagged blocked; ``blkp``
    random verdicts or None."""
    g = np.random.default_rng(seed)
    W, H = fp.width, fp.height
    B = W * H * n_poses
    hit = np.flatnonzero(g.random(B) < 0.5)
    k = hit.shape[0]
    cand = np.flatnonzero(g.random(k) < 1 / 3)
    if cand.shape[0] % 2 == 0:
        cand = cand[:-1]
    m = cand.shape[0]
    count = FINISH_CASES[case](m)
    assert count <= m
    size = m if case == "count = size" else B
    hidx = g.integers(0, B, B).astype(np.int32)
    hidx[:k] = hit
    sidx = g.integers(0, k, size).astype(np.int32)
    sidx[:count] = cand[:count]
    flags = [g.random(size) < p for p in (0.5, 0.3, 0.4)]
    for f in flags:
        f[count:] = True

    def t(a, dtype=None):
        return torch.tensor(a, dtype=dtype, device=dev)

    traced, blk, todo = (t(f) for f in flags)
    return (fp, t(hidx),
            t(sidx), t([count], torch.int32),
            t(g.random((B, 4)).astype(np.float32)),
            t(g.random(B).astype(np.float32)),
            blk if certified else None, todo if certified else None, traced,
            t(g.random((n_poses, H, W, 4)).astype(np.float32)),
            t(g.random(B) < 0.5) if blkp else None)


def _kd_finish_check(args):
    """One ``launch_kd_finish`` call (its arguments) through the kernel and
    through ``kd_finish_plain`` on copies of ``img`` and ``blkp``: equal
    bit for bit; the number of pixels it changed."""
    *head, img, blkp = args
    ki, pi = img.clone(), img.clone()
    kb = None if blkp is None else blkp.clone()
    pb = None if blkp is None else blkp.clone()
    n0 = shading.launches_finish
    _build.launch_kd_finish(*head, ki, kb)
    shading.kd_finish_plain(*head, pi, pb)
    torch.cuda.synchronize()
    assert shading.launches_finish == n0  # the launch wrapper counts nothing
    assert _bits_equal(ki, pi)
    if blkp is not None:
        assert torch.equal(kb, pb)
    return int((ki != img).any(-1).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("blkp", [False, True])
@pytest.mark.parametrize("certified", [False, True])
@pytest.mark.parametrize("case", sorted(FINISH_CASES) + ["batch"])
def test_kd_finish_equals_plain(terrains, dev, case, certified, blkp):
    """The finishing stage's kernel (a resident grid looping over words of
    4 candidate slots up to the count on the card: the indices as a
    16-byte word, each flag array as a 4-byte word, a pixel as a 16-byte
    store) against ``kd_finish_plain`` bit for bit: a count of 0, a count
    equal to the list's size (odd: a partial last word), a count off a
    block's 512 slots and off a word, every candidate of a 1080p-like
    list; with and without K8's certificates and the pixel-space
    verdicts; 3 poses of a batch. Slots past the count (flagged blocked)
    change nothing."""
    fp = _k9_fp(terrains[("esvo", False)], _tparams("horizon"), 321, 187)
    n_poses = 3 if case == "batch" else 1
    args = _finish_inputs(fp, n_poses,
                          "candidates" if case == "batch" else case,
                          certified, blkp, 7, dev)
    changed = _kd_finish_check(args)
    assert (changed == 0) == (int(args[3]) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["count 0", "count = size", "off a word",
                                  "hits", "idx None", "max_dst"])
def test_k7_shadow_floors_equal_plain(terrains, dev, case):
    """K7's shadow kernel (a resident grid looping over the rays up to the
    count on the card, then the pads as 16-byte zero words) against
    ``shadow_ray_floors_plain`` (and ``k7_shadow_plain`` on the launch's
    own arguments) bit for bit, on pose "horizon"'s shadow origins: a
    count of 0, a count equal to the list's size, an odd count (its last
    ray with a floor) of an odd-sized list, the frame's hits of a list of
    every lane, no list (every ray, count None), per-lane limits; every
    lane written, the pads 0."""
    s = terrains[("esvo", False)]
    p = _tparams("horizon")
    ctx = s.beam_context(p, TW, TH).without_sun()
    levels, offsets, n, hmax, bounds, levels_e = ctx._dev
    bounds = bounds.to(device=dev, dtype=torch.float32).contiguous()
    sro, idx, count = _k7_origins(s, p, dev)
    hits = int(count)
    assert hits > 4096
    md = None
    if case == "count 0":
        count = torch.zeros_like(count)
    elif case == "count = size":
        idx = idx[:hits].clone()
    elif case == "off a word":
        # an odd list size, an odd count whose last ray has a floor
        idx = idx[: (hits - 1) | 1].clone()
        full = beams.shadow_ray_floors_plain(levels_e, levels[: n * n],
                                             offsets, n, hmax, bounds, sro,
                                             -np.asarray(p.light_dir,
                                                         np.float32), None,
                                             idx=idx)
        lit = torch.nonzero(full[: hits - 2:2]).flatten() * 2
        c = int(lit[lit.shape[0] // 2]) + 1
        count = torch.tensor([c], dtype=torch.int32, device=dev)
    elif case == "idx None":
        idx = count = None
    lanes = sro.shape[0] if idx is None else idx.shape[0]
    if case == "max_dst":
        g = np.random.default_rng(9)
        md = torch.tensor(g.uniform(-1.0, 60.0, lanes).astype(np.float32),
                          device=dev)
    light = -np.asarray(p.light_dir, np.float32)
    params = beams.shadow_params(offsets, n, hmax, light)
    out = torch.full((lanes,), 7.0, device=dev)
    n0 = beams.launches_shadow
    _build.launch_k7_shadow(levels_e, levels[: n * n], bounds, params, sro, md,
                            idx, count, out)
    plain = beams.shadow_ray_floors_plain(levels_e, levels[: n * n], offsets,
                                          n, hmax, bounds, sro, light, md,
                                          idx=idx, count=count)
    again = beams.k7_shadow_plain(levels_e, levels[: n * n], bounds, params,
                                  sro, md, idx, count, torch.empty_like(out))
    torch.cuda.synchronize()
    assert beams.launches_shadow == n0  # the launch wrapper counts nothing
    assert _bits_equal(out, plain) and _bits_equal(again, plain)
    rays = lanes if count is None else min(int(count), lanes)
    assert bool((out[rays:] == 0).all())
    assert bool(torch.isinf(out[:rays]).any()) == (rays > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("path,fmt", [
    (path, fmt) for path in ("exact", "adaptive", "judged")
    for fmt in ("esvo", "csvo")] + [("batch", "esvo")])
def test_kd_finish_and_k7_shadow_calls_of_frames_equal_plain(
        terrains, judged_scenes, dev, path, fmt, monkeypatch):
    """Every finishing-stage launch and every K7 shadow launch of the frames
    (the exact frame with the sun map's certificates, with K7's floors and
    unfloored; the adaptive frame's two passes, the first writing the
    pixel-space verdicts; the judged adaptive frame; a batch of 3 poses,
    ESVO) held to ``kd_finish_plain`` / ``k7_shadow_plain`` on the call's
    own inputs, bit for bit."""
    calls = {"launch_kd_finish": [], "launch_k7_shadow": []}
    launch = {name: getattr(_build, name) for name in calls}

    def spy(name):
        def run(*args, **kw):
            keep = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
            calls[name].append([keep(a) for a in args])
            return launch[name](*args, **kw)
        return run

    for name in calls:
        monkeypatch.setattr(_build, name, spy(name))
    if path == "judged":
        s = judged_scenes[fmt]
        p = _jparams("overview")
    else:
        s = terrains[(fmt, False)]
        p = _tparams("horizon")
    ctx = s.beam_context(p, TW, TH)
    if path == "batch":
        monkeypatch.setenv("VOXELRS_ADAPTIVE", "1")
        s.render_batch([_tparams(c) for c in BATCH_CAMS], TW, TH)
    else:
        for b in (ctx, ctx.without_sun(), None):
            s.render(p, TW, TH, beams=b, adaptive=path != "exact")
    torch.cuda.synchronize()
    for name in calls:
        monkeypatch.setattr(_build, name, launch[name])
    fin, k7 = calls["launch_kd_finish"], calls["launch_k7_shadow"]
    assert len(fin) == {"exact": 3, "batch": 2}.get(path, 6)
    assert sum(_kd_finish_check(args) for args in fin) > 0
    if path != "batch":
        # the sun map's certificates first, the pixel verdicts in pass 1
        assert fin[0][6] is not None and fin[-1][6] is None
        assert (fin[0][10] is not None) == (path != "exact")
    assert len(k7) == {"exact": 1, "batch": 0}.get(path, 2)
    for args in k7:
        out = args[8].clone()
        _build.launch_k7_shadow(*args[:8], out)
        ref = beams.k7_shadow_plain(*args[:8], args[8].clone())
        torch.cuda.synchronize()
        assert _bits_equal(out, ref)


# ---- K3 and K9-judged's trace in 4x8 tiles on a resident grid ---------------

# K3's variants: (render_shadows, VOXELRS_TRILINEAR, max_steps); at 40 steps
# the CSVO shadow rays run out of the frame's budget, as in the JAX CSVO
# frame (the ESVO ones get MAX_STEPS)
K3_VARIANTS = {"shadows": (True, False, 300), "no shadows": (False, False,
                                                             1000),
               "trilinear": (True, True, 1000), "budget 40": (True, False, 40)}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("variant", sorted(K3_VARIANTS))
@pytest.mark.parametrize("size", [(1, 1), (15, 12), (33, 17), (1920, 1080)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k3_tiles_equal_plain(svo, csvo, dev, fmt, variant, size,
                              monkeypatch):
    """K3 (a warp a 4x8 pixel tile, both rays through the block's shared
    stacks, a pixel a 16-byte store, a grid of at most the blocks the card
    holds, whose warps take the tiles from the stream's counters) against
    the plain frame bit for bit, with a highlighted block, at frame sizes
    that are not multiples of a tile and at 1080p; its steps a pixel from
    ``steps``, the counters back at 0 after each launch."""
    shadows, trilinear, max_steps = K3_VARIANTS[variant]
    monkeypatch.setenv("VOXELRS_TRILINEAR", "1" if trilinear else "0")
    s = svo if fmt == "esvo" else csvo
    W, H = size
    fwd = np.array([0.5, -0.5, 0.7], np.float32)
    p = RenderParams(cam_pos=np.array([2.0, 20.0, -4.0], np.float32),
                     cam_fwd=fwd / np.linalg.norm(fwd), aspect_ratio=W / H,
                     fov_y_rad=np.radians(70.0), render_shadows=shadows,
                     shadow_distance=100.0,
                     selected_voxel=np.array([12.0, 11.0, 10.0], np.float32))
    n0 = shading.launches
    img = s.render(p, W, H, max_steps=max_steps, mode="fused")
    kw = s.frame_kwargs(p, W, H, max_steps=max_steps)
    ref = shading.render_frame_plain(s.world(), s.octree_scale, s.mips,
                                     s.mat_params, s.mat_tex, **kw)
    fp = shading.frame_params(mip_mode=shading.mip_mode_from_env(),
                              csvo=fmt == "csvo", **kw)
    again = torch.full_like(img, 7.0)
    steps = torch.full((W * H,), -1, dtype=torch.int32, device=dev)
    _build.launch_k3(s.world(), float(s.octree_scale), s.kernel_tables(), fp,
                     again, steps)
    torch.cuda.synchronize()
    assert shading.launches == n0 + 1
    assert _bits_equal(img, ref) and _bits_equal(again, ref)
    assert bool((steps >= 1).all())
    # each launch leaves the stream's tile counters at 0 for the next
    assert not bool(_build.k3_tiles(dev).any())


@pytest.mark.cuda
def test_k3_refuses_a_frame_off_a_16_byte_word(svo, dev):
    fp = shading.frame_params(mip_mode="nearest", **svo.frame_kwargs(
        _tparams("horizon"), 8, 4))
    buf = torch.zeros(8 * 4 * 4 + 4, device=dev)
    with pytest.raises(ValueError, match="img: expected a 16-byte aligned"):
        _build.launch_k3(svo.world(), float(svo.octree_scale),
                         svo.kernel_tables(), fp, buf[1:1 + 128].view(4, 8, 4))


# a refine list's count against its size: 0, 1, an odd count, the size and
# past the size (the kernel stops at the size)
K9J_COUNTS = ("count 0", "count 1", "odd count", "count = size",
              "count > size")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("case", ("grid",) + K9J_COUNTS)
def test_k9j_trace_tiles_equal_plain(judged_scenes, dev, fmt, level, case):
    """K9-judged's trace (K9's shape: 4x8 tiles a warp on the whole grid,
    the stack in shared memory, a resident grid looping up to the refine
    list's count on the card, a record as four 16-byte words) against
    ``k9j_trace_plain`` bit for bit on each grid level of the judged
    frame, the whole grid or a refine list, every other record
    untouched."""
    from voxelrs_tpu_torch.ops import adaptive_judged as aj

    s = judged_scenes[fmt]
    world, scale, fp, tf = _k9_inputs(s, _jparams("canopy"), dev)
    tables = s.kernel_tables()
    w, h = adaptive.grid_dims(TW, TH, 2)[level]
    n = w * h
    idx = count = None
    if case != "grid":
        g = torch.Generator(device=dev).manual_seed(level)
        idx = torch.nonzero(torch.rand(n, generator=g, device=dev)
                            < 0.37).flatten().to(torch.int32)
        size = idx.shape[0]
        c = {"count 0": 0, "count 1": 1, "odd count": (size // 2) | 1,
             "count = size": size, "count > size": size + 5}[case]
        count = torch.tensor([c], dtype=torch.int32, device=dev)
    rec = torch.full((n, aj.REC_WORDS), 9, dtype=torch.int32, device=dev)
    ref = rec.clone()
    n0 = aj.launches_trace
    aj.k9j_trace(world, scale, tables, fp, tf, level, rec, idx, count)
    aj.k9j_trace_plain(world, scale, tables, fp, tf, level, ref, idx, count)
    torch.cuda.synchronize()
    assert aj.launches_trace == n0 + 1
    assert torch.equal(rec, ref)
    traced = int((rec != 9).any(1).sum())
    assert traced == (n if idx is None else min(int(count), idx.shape[0]))


# ---- kd_primary and K9-judged's merge on their tiles -------------------------

# frame sizes whose last kd_primary patches (16 x 4 pixels) cross the
# frame's last column and row, and whose rows start off a 16-byte word of
# the records
KD_PRIMARY_SIZES = [(1001, 597), (37, 23)]


def _primary_check(s, fp, tf, dev, cams=None):
    """kd_primary (``_build.launch_kd_primary``) against
    ``ops.shading.kd_primary_plain`` on the same inputs: every record and
    hit flag bit for bit, a miss's sky within 1e-6, the pixels that hit
    untouched."""
    n = fp.width * fp.height * (1 if cams is None else cams.shape[0])
    alpha_mode = 0 if s.is_opaque() else 1
    outs = [(torch.full((n, 9), 7, dtype=torch.int32, device=dev),
             torch.ones(n, dtype=torch.bool, device=dev),
             torch.full((n, 4), 0.5, device=dev)) for _ in range(2)]
    args = (s.world(), float(s.octree_scale), s.kernel_tables(), fp,
            alpha_mode, tf)
    n0 = shading.launches_primary
    _build.launch_kd_primary(*args, *outs[0], cams=cams)
    shading.kd_primary_plain(*args, *outs[1], cams=cams)
    torch.cuda.synchronize()
    (rec, hit, img), (rec_p, hit_p, img_p) = outs
    assert shading.launches_primary == n0  # the launch alone: no frame
    assert torch.equal(rec, rec_p) and torch.equal(hit, hit_p)
    assert float((img - img_p).abs().max()) <= K3_MAX_ABS
    assert bool((img[hit] == 0.5).all())
    assert 0 < int(hit.sum()) < n


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("glass", [False, True])
@pytest.mark.parametrize("floored", [False, True])
@pytest.mark.parametrize("size", KD_PRIMARY_SIZES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_kd_primary_equals_plain(terrains, dev, fmt, glass, floored, size):
    """The primary stage (a block's 16 x 4 patch of HitRecs and flags
    stored through shared memory as 16-byte words, rows that start off one
    word by word, the trace through the block's shared stack) against
    ``kd_primary_plain`` bit for bit, opaque and judged, with and without
    the tile floors."""
    s = terrains[(fmt, glass)]
    p = _tparams("horizon")
    fp = _k9_fp(s, p, *size)
    tf = s.beam_context(p, *size).tile_floors if floored else None
    _primary_check(s, fp, tf, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("floored", [False, True])
def test_kd_primary_of_a_batch_equals_plain(terrains, dev, floored):
    """The primary stage of 3 poses in one launch (pose-major lanes, each
    pose's camera and tile floors, no patch crossing a pose) against
    ``kd_primary_plain`` pose by pose, bit for bit."""
    s = terrains[("esvo", False)]
    W, H = 101, 59
    poses = [_tparams(c) for c in BATCH_CAMS]
    kws = [s.frame_kwargs(p, W, H) for p in poses]
    cams = shading.batch_cameras(tuple(np.stack([kw[k] for kw in kws]) for k
                                       in ("cam_pos", "cam_right", "cam_up",
                                           "cam_fwd")), dev)
    tf = (torch.stack([s.beam_context(p, W, H).tile_floors for p in poses])
          if floored else None)
    _primary_check(s, _k9_fp(s, poses[0], W, H), tf, dev, cams)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("hole_fill", [False, True])
@pytest.mark.parametrize("size", [(1001, 597), (37, 21)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k9j_merge_tiles_equal_plain(judged_scenes, dev, fmt, level,
                                     hole_fill, size):
    """K9-judged's merge (a block a tile of the hi grid, its lo patch
    loaded once and its hi rows stored as 16-byte words through shared
    memory, the fill from a packed list) against ``k9j_merge_plain`` bit
    for bit on odd grids, where the tiles and the clamped last row and
    column meet the grid's edges, with the hole fill off and on."""
    from voxelrs_tpu_torch.ops import adaptive_judged as aj

    s = judged_scenes[fmt]
    p = _jparams("overview")
    fp = _k9_fp(s, p, *size)
    tables = s.kernel_tables()
    ctx = s.beam_context(p, *size)
    dims = adaptive.grid_dims(*size, 2)
    wl, hl = dims[level + 1]
    lo = torch.zeros((wl * hl, aj.REC_WORDS), dtype=torch.int32, device=dev)
    aj.k9j_trace(s.world(), float(s.octree_scale), tables, fp,
                 None if ctx is None else ctx.tile_floors, level + 1, lo)
    n = dims[level][0] * dims[level][1]
    hi = torch.full((n, aj.REC_WORDS), 77, dtype=torch.int32, device=dev)
    refine = torch.ones(n, dtype=torch.bool, device=dev)
    hi_p, refine_p = hi.clone(), refine.clone()
    n0 = aj.launches_merge
    scale = float(s.octree_scale)
    aj.k9j_merge(scale, tables, fp, level, lo, hi, refine, hole_fill)
    aj.k9j_merge_plain(scale, tables, fp, level, lo, hi_p, refine_p,
                       hole_fill)
    torch.cuda.synchronize()
    assert aj.launches_merge == n0 + 1
    assert torch.equal(hi, hi_p) and torch.equal(refine, refine_p)
    if size[0] > 100:  # the fill ran: an interior lane hit, not re-traced
        g = adaptive.coarse_grid(*dims[level], dev)
        filled = (hi_p.view(torch.float32)[:, 0] != -1.0) & ~refine_p \
            & ~g.sample_masks()[0]
        assert bool(filled.any())
