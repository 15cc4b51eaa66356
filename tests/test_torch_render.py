"""voxelrs_tpu_torch frames (K3 and its plain version) against voxelrs_tpu:
``render_frame`` against the JAX ``render_frame``, ``Svo.render`` against
the JAX ``Svo.render(mode="fused")`` with and without shadows and with a
highlighted block, and the texture sampler. Its scenes and checks serve
tests/test_torch_render_modes.py too (both mip modes, a radius-1
procedural world, the golden frame, the default (deferred) mode), a file
of its own so that the tier-1 run's workers share the two.

Tolerances. Frames: mean |d| <= 1e-3 over all channels and at most 1% of
the pixels off by more than 1e-3. The JAX CPU build contracts multiply-adds
into FMAs and torch's CPU sqrt is not always correctly rounded, so a ray
that grazes a voxel edge can hit the neighbouring voxel (measured: mean |d|
<= 4.5e-5 and <= 0.1% of the pixels). The golden frame keeps the
repository's 0.015 mean-abs budget. Texture samples: exact texel choice;
the bilinear weights differ by the same FMA contraction (<= 1e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrs_tpu.gamelogic import content as jcontent
from voxelrs_tpu.graphics.camera import Camera
from voxelrs_tpu.graphics.svo import RenderParams as JRenderParams
from voxelrs_tpu.graphics.svo import Svo as JSvo
from voxelrs_tpu.ops.shading import render_frame as jrender_frame
from voxelrs_tpu.ops.texture import build_mip_chain as jbuild_mip_chain
from voxelrs_tpu.ops.texture import sample_texture_lod as jsample
from voxelrs_tpu.world import ChunkPos, Position
from voxelrs_tpu.world.esvo import Esvo, SerializedChunk
from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.graphics.svo import RenderParams, Svo
from voxelrs_tpu_torch.ops import shading
from voxelrs_tpu_torch.ops.texture import build_mip_chain, sample_texture_lod
from voxelrs_tpu_torch.world.esvo import Esvo as TEsvo

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "render_basic.npy")
W, H = 64, 48


def _port_world(chunks, world=None):
    """The same world built (or extended) by the port's own serializer."""
    from voxelrs_tpu_torch.world import ChunkPos as TCP, Position as TPos
    from voxelrs_tpu_torch.world.esvo import SerializedChunk as TSC

    world = TEsvo() if world is None else world
    for (x, y, z), vox, lod in chunks:
        world.set_leaf(TPos(x, y, z), TSC.from_voxels(TCP(x, y, z), vox, lod),
                       True)
    world.serialize()
    return world


def _jax_world(chunks, world=None):
    world = Esvo() if world is None else world
    for (x, y, z), vox, lod in chunks:
        world.set_leaf(Position(x, y, z),
                       SerializedChunk.from_voxels(ChunkPos(x, y, z), vox, lod),
                       True)
    world.serialize()
    return world


def _pair(chunks, capacity_mb=4):
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=capacity_mb)
    jsvo.update(_jax_world(chunks))
    tsvo = Svo(content.new_registry(), capacity_mb=capacity_mb, device="cpu")
    tsvo.update(_port_world(chunks))
    np.testing.assert_array_equal(
        tsvo.device_buf.numpy().view(np.uint32), np.asarray(jsvo.device_buf))
    return jsvo, tsvo


def _basic_voxels():
    vox = np.zeros((32, 32, 32), np.uint32)
    vox[:, :8, :] = jcontent.STONE
    vox[:, 8, :] = jcontent.GRASS
    vox[10:14, 9:12, 10:14] = jcontent.STONE  # a little tower
    return vox


@pytest.fixture(scope="module")
def basic_pair():
    """tests/test_render.py's scene."""
    return _pair([((0, 0, 0), _basic_voxels(), 5)])


@pytest.fixture(scope="module")
def translucent_pair():
    """The same scene plus glass, leaves and water."""
    vox = _basic_voxels()
    vox[3:6, 9:12, 3:6] = jcontent.GLASS
    vox[16:20, 9:11, 3:9] = jcontent.OAK_LEAVES
    vox[20:28, 8, 20:28] = jcontent.WATER
    return _pair([((0, 0, 0), vox, 5), ((1, 0, 0), vox[::-1].copy(), 4)])


def params(cls, w=W, h=H, **kw):
    fwd = np.array([0.5, -0.5, 0.7], np.float32)
    fwd /= np.linalg.norm(fwd)
    d = dict(cam_pos=np.array([2.0, 20.0, -4.0], np.float32), cam_fwd=fwd,
             aspect_ratio=w / h, fov_y_rad=np.radians(70.0),
             render_shadows=True, shadow_distance=100.0,
             ambient_intensity=0.3)
    d.update(kw)
    return cls(**d)


def assert_frames_close(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.mean() <= 1e-3, d.mean()
    off = (d.max(-1) > 1e-3).mean()
    assert off <= 0.01, off


@pytest.mark.parametrize("shadows,highlight", [
    (True, None), (False, None), (True, (12.0, 11.0, 10.0)),
    (False, (3.0, 10.0, 4.0))])
def test_svo_render_fused_matches_jax(translucent_pair, shadows, highlight):
    jsvo, tsvo = translucent_pair
    hl = None if highlight is None else np.array(highlight, np.float32)
    jimg = np.asarray(jsvo.render(params(JRenderParams, render_shadows=shadows,
                                         selected_voxel=hl),
                                  W, H, max_steps=300, mode="fused"))
    timg = tsvo.render(params(RenderParams, render_shadows=shadows,
                              selected_voxel=hl), W, H, max_steps=300,
                       mode="fused")
    assert timg.shape == (H, W, 4) and timg.dtype == torch.float32
    assert_frames_close(timg.numpy(), jimg)


def test_svo_update_uploads_like_jax():
    """Delta range uploads and ladder growth leave the port's device buffer
    equal to the JAX package's, word for word, after every update."""
    rng = np.random.default_rng(5)

    def chunk(density):
        occ = rng.random((32, 32, 32)) < density
        return np.where(occ, rng.integers(1, 13, occ.shape), 0
                        ).astype(np.uint32)

    steps = [[((0, 0, 0), chunk(0.05), 5)],
             [((0, 1, 0), chunk(0.002), 4)],  # small: a delta upload
             [((x, 0, 1), chunk(0.5), 5) for x in range(3)]]  # it grows
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=8)
    tsvo = Svo(content.new_registry(), capacity_mb=8, device="cpu")
    jworld = tworld = None
    sizes = []
    for chunks in steps:
        jworld = _jax_world(chunks, jworld)
        tworld = _port_world(chunks, tworld)
        jsvo.update(jworld)
        tsvo.update(tworld)
        np.testing.assert_array_equal(
            tsvo.device_buf.numpy().view(np.uint32),
            np.asarray(jsvo.device_buf))
        js, ts = jsvo.get_stats(), tsvo.get_stats()
        assert (ts.used_bytes, ts.capacity_bytes, ts.depth) == (
            js.used_bytes, js.capacity_bytes, js.depth)
        assert tsvo.octree_scale == jsvo.octree_scale
        sizes.append(tsvo.device_buf.shape[0])
    assert sizes[0] == sizes[1] < sizes[2]


def test_highlight_and_shadows_change_the_frame(translucent_pair):
    _, tsvo = translucent_pair
    base = tsvo.render(params(RenderParams), W, H, max_steps=300,
                       mode="fused").numpy()
    lit = tsvo.render(params(RenderParams, render_shadows=False), W, H,
                      max_steps=300, mode="fused").numpy()
    hi = tsvo.render(params(RenderParams, selected_voxel=np.array(
        [12.0, 11.0, 10.0], np.float32)), W, H, max_steps=300,
        mode="fused").numpy()
    assert (lit[..., :3] - base[..., :3]).max() > 0.05  # the tower's shadow
    changed = np.abs(hi - base).max(-1) > 0.05
    assert 0 < changed.sum() < 0.2 * W * H  # outline only


def test_render_frame_matches_jax(basic_pair):
    """ops.shading.render_frame against the JAX function on the same
    buffer, tables and camera (the 1000-step default)."""
    jsvo, tsvo = basic_pair
    cam = Camera(75.0, W / H, 0.01, 1024)
    cam.position = np.array([30.0, 14.0, 36.0], np.float32)
    cam.forward = np.array([-0.6, -0.3, -0.7], np.float32)
    s, u, f = cam.camera_basis()
    kw = dict(width=W, height=H, render_shadows=True, fov_y_rad=np.radians(75.0),
              aspect=W / H, ambient=0.25, shadow_distance=60.0)
    light = np.array([-0.3, -0.9, 0.2], np.float32)
    light /= np.linalg.norm(light)
    hl = np.array([11.0, 10.0, 13.0], np.float32)
    jimg = jax.jit(lambda b, m, p, t: jrender_frame(
        b, jnp.float32(jsvo.octree_scale), m, p, t, cam_pos=jnp.asarray(cam.position),
        cam_right=jnp.asarray(s), cam_up=jnp.asarray(u), cam_fwd=jnp.asarray(f),
        light_dir=jnp.asarray(light), highlight_pos=jnp.asarray(hl),
        **{**kw, "fov_y_rad": jnp.float32(kw["fov_y_rad"]),
           "aspect": jnp.float32(kw["aspect"]),
           "ambient": jnp.float32(kw["ambient"]),
           "shadow_distance": jnp.float32(kw["shadow_distance"])}))(
        jsvo.device_buf, jsvo.mips, jsvo.mat_params, jsvo.mat_tex)
    timg = shading.render_frame(
        tsvo.device_buf, tsvo.octree_scale, tsvo.mips, tsvo.mat_params,
        tsvo.mat_tex, cam_pos=cam.position, cam_right=s, cam_up=u, cam_fwd=f,
        light_dir=light, highlight_pos=hl, **kw)
    assert_frames_close(timg.numpy(), np.asarray(jimg))


@pytest.mark.parametrize("mode", ["nearest", "linear"])
def test_sample_texture_lod_matches_jax_footprint(mode):
    rng = np.random.default_rng(11)
    base = rng.random((3, 16, 16, 4)).astype(np.float32)
    jm = jbuild_mip_chain(jnp.asarray(base), 5)
    tm = build_mip_chain(torch.from_numpy(base), 5)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    B = 4096
    layer = rng.integers(-1, 4, B).astype(np.int32)
    uv = np.where(rng.random((B, 1)) < 0.5, rng.random((B, 2)),
                  np.clip(rng.normal(0.5, 0.7, (B, 2)), 0.0, 1.0)
                  ).astype(np.float32)
    lod = (rng.random(B) * 5.5 - 0.5).astype(np.float32)
    j = np.asarray(jsample(jm, jnp.asarray(layer), jnp.asarray(uv),
                           jnp.asarray(lod), mip_mode=mode, footprint=True))
    t = sample_texture_lod(tm, torch.from_numpy(layer), torch.from_numpy(uv),
                           torch.from_numpy(lod), mip_mode=mode).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    # single-channel stacks squeeze like the JAX sampler
    t1 = sample_texture_lod(tuple(m[..., 0] for m in tm),
                            torch.from_numpy(layer), torch.from_numpy(uv),
                            torch.from_numpy(lod), mip_mode=mode).numpy()
    np.testing.assert_array_equal(t1, t[:, 0])
