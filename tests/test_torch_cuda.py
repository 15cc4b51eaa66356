"""Kernels K1, K3, K4 and K5 against their plain PyTorch versions on a CUDA
card (K3 and K5 in both their ESVO and CSVO instantiations), the game loop
launching K5 and K3 in both formats, and the crosshair overlay on the card
against the CPU.

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
every task. The crosshair equals the CPU's result bit for bit.
"""

import numpy as np
import pytest
import torch

from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.gamelogic.game import Game, GameArgs
from voxelrs_tpu_torch.graphics.picker import Aabb, PickerBatch, PickerBatchResult
from voxelrs_tpu_torch.graphics.svo import RenderParams, Svo
from voxelrs_tpu_torch.ops import picker, shading, traversal, traversal_csvo
from voxelrs_tpu_torch.world import ChunkPos, Position
from voxelrs_tpu_torch.world.csvo import Csvo, CsvoSerializedChunk
from voxelrs_tpu_torch.world.esvo import Esvo, SerializedChunk


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
    img = svo.render(p, W, H, max_steps=max_steps)
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
    rng = np.random.default_rng(n)
    o = rng.uniform(-4, 68, (n, 3))
    o[::3] = np.round(o[::3])  # on the lattice
    d = rng.normal(size=(n, 3))
    d[1::2] = np.eye(3)[rng.integers(0, 3, n // 2)] * rng.choice([-1, 1], (n // 2, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    md = rng.choice([10.0, 30.0], (n, 1))
    md[-1] = 0.0  # a padding task: max_dst 0, direction +x
    d[-1] = (1.0, 0.0, 0.0)
    tasks = torch.tensor(np.concatenate([md, o, d], 1), dtype=torch.float32,
                         device=dev)
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
    g = Game(GameArgs(player_pos=(16.37, 63.21, 16.83),
                      player_euler_rot=(-30.0, 45.0, 0.0), render_distance=2,
                      gpu_buffer_size_mb=16, workers=2, svo_format=fmt))
    try:
        assert g.wait_for_world(timeout=120)
        g.player.caps.flying = False
        n5, n3 = picker.launches, shading.launches
        c5, c3 = picker.launches_csvo, shading.launches_csvo
        for _ in range(10):
            img = g.step_frame(dt=1 / 60, render=True, width=160, height=120)
        torch.cuda.synchronize()
        assert img.is_cuda and img.shape == (120, 160, 4)
        assert bool(torch.isfinite(img).all())
        assert shading.launches == n3 + 10
        assert picker.launches > n5
        csvo = fmt == "csvo"
        assert shading.launches_csvo - c3 == (10 if csvo else 0)
        assert picker.launches_csvo - c5 == (picker.launches - n5 if csvo else 0)
        assert g.player.state.is_grounded
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


@pytest.mark.cuda
def test_crosshair_on_the_card_equals_the_cpu(dev):
    rng = np.random.default_rng(3)
    img = torch.tensor(rng.random((97, 130, 4)), dtype=torch.float32)
    cpu = shading.crosshair_overlay(img)
    card = shading.crosshair_overlay(img.to(dev)).cpu()
    assert torch.equal(card, cpu)
