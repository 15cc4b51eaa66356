"""tests/test_torch_render.py's frames, continued (its scenes, camera,
tolerances and checks): the trilinear mip mode against the JAX fused frame,
a radius-1 procedural world, the golden frame tests/goldens/
render_basic.npy, and the default (deferred) mode against the fused frame.
A file of its own so that the tier-1 run's workers share the two files
(``--dist loadfile`` gives a file to one worker).

Tolerances: tests/test_torch_render.py's.
"""

import numpy as np
import pytest

from test_torch_render import (GOLDEN, H, W, _pair, assert_frames_close,
                               basic_pair, params, translucent_pair)  # noqa: F401
from voxelrs_tpu.gamelogic.worldgen import Generator, default_config
from voxelrs_tpu.graphics.svo import RenderParams as JRenderParams
from voxelrs_tpu.world import ChunkPos
from voxelrs_tpu.world.chunk import Chunk
from voxelrs_tpu_torch.graphics.svo import RenderParams

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_trilinear_mode_matches_jax(translucent_pair, monkeypatch):
    monkeypatch.setenv("VOXELRS_TRILINEAR", "1")
    jsvo, tsvo = translucent_pair
    # the JAX Svo reads the knob while tracing: trace afresh
    monkeypatch.setattr(jsvo, "_render_cache", {})
    p = dict(cam_pos=np.array([-20.0, 30.0, -25.0], np.float32),
             cam_fwd=np.array([0.6, -0.4, 0.7], np.float32))
    jimg = np.asarray(jsvo.render(params(JRenderParams, **p), W, H,
                                  max_steps=300, mode="fused"))
    timg = tsvo.render(params(RenderParams, **p), W, H, max_steps=300,
                       mode="fused").numpy()
    assert_frames_close(timg, jimg)
    monkeypatch.setenv("VOXELRS_TRILINEAR", "0")
    nearest = tsvo.render(params(RenderParams, **p), W, H,
                          max_steps=300, mode="fused").numpy()
    assert np.abs(nearest - timg).max() > 1e-3  # the knob is read


def test_procedural_world_matches_jax():
    """A radius-1 bench.py world (2x2 columns, LOD banded) at 64x48."""
    gen = Generator(1, default_config())
    chunks = []
    for cx in range(2):
        for cz in range(2):
            col = gen.get_column(cx, cz)
            for cy in range(8):
                if not col.contains_chunk(cy):
                    continue
                chunk = Chunk(ChunkPos(cx, cy, cz))
                gen.generate_chunk(chunk)
                if chunk.voxels.any():
                    chunks.append(((cx, cy, cz), chunk.voxels.copy(), 5))
    jsvo, tsvo = _pair(chunks, capacity_mb=8)
    p = dict(cam_pos=np.array([8.0, 95.0, -10.0], np.float32),
             cam_fwd=np.array([0.55, -0.45, 0.7], np.float32),
             shadow_distance=300.0, fov_y_rad=np.radians(80.0))
    jimg = np.asarray(jsvo.render(params(JRenderParams, **p), W, H,
                                  mode="fused"))
    timg = tsvo.render(params(RenderParams, **p), W, H, mode="fused").numpy()
    assert_frames_close(timg, jimg)
    assert 0.05 < (timg[..., 2] > 0.7).mean() < 0.95  # terrain and sky


def test_golden_image(basic_pair):
    _, tsvo = basic_pair
    img = tsvo.render(params(RenderParams, w=128, h=96), 128, 96,
                      max_steps=300, mode="fused").numpy()
    assert img.shape == (96, 128, 4) and not np.isnan(img).any()
    assert img.min() >= 0.0 and img.max() <= 1.0 + 1e-5
    golden = np.load(GOLDEN)
    assert np.abs(img.astype(np.float64) - golden).mean() < 0.015


def test_deferred_is_the_default_mode(basic_pair, translucent_pair):
    """The JAX package's default mode renders here too, by default: on the
    opaque basic scene (the opaque branch) and on the glass tower (the
    judged branch) it is the fused frame bit for bit; "csvo" (the JAX name
    of the fused mode for a CSVO buffer) is the fused frame; other modes
    raise."""
    for _, tsvo in (basic_pair, translucent_pair):
        p = params(RenderParams)
        fused = tsvo.render(p, W, H, max_steps=300, mode="fused").numpy()
        img = tsvo.render(p, W, H, max_steps=300).numpy()
        assert tsvo.last_frame["mode"] == "deferred"
        np.testing.assert_array_equal(img, fused)
        np.testing.assert_array_equal(
            tsvo.render(p, W, H, max_steps=300, mode="csvo").numpy(), fused)
    assert basic_pair[1].is_opaque() and not translucent_pair[1].is_opaque()
    with pytest.raises(ValueError, match="mode"):
        basic_pair[1].render(params(RenderParams), W, H, mode="adaptive")
