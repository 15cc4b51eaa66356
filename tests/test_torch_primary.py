"""voxelrs_tpu_torch's primary stage, ``ops.shading.kd_primary_plain``
(the plain version of the ``kd_primary`` kernel, on the kernel's own
arguments), against the primary trace of voxelrs_tpu's deferred frame
(``ops/shading.py::render_frame_deferred`` :3129-3134, spied from the
frame) at 128x96 from the beam floors of the terrain envelope, on the
glass-tower terrain of tests/test_torch_deferred.py (the judged branch).
The frames are rendered without shadows: the primary trace is the same.

Tolerances: tests/test_torch_traversal.py's — t and pos within 1e-3
world units, uv within 1e-3, lod within 1e-4 — on every pixel where both
traces hit the same value and face. The hit mask, value and face are
exact but on at most 1% of the pixels: the grazing rays on which the JAX
package's fused multiply-adds pick the neighbouring voxel, and the rays
the JAX deferred trace reports as misses after rounds=4 translucent
texels (tests/test_torch_deferred.py). The JAX deferred frame is its
second render, as in tests/test_torch_deferred.py."""

import numpy as np
import pytest
import torch

import test_torch_deferred as td
from test_torch_deferred import _drop_scenes  # noqa: F401
from voxelrs_tpu.ops import shading as jshading
from voxelrs_tpu_torch.ops import shading
from voxelrs_tpu_torch.ops.adaptive import _frame_rays

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL_T = 1e-3
TOL_UV = 1e-3
TOL_LOD = 1e-4


def _jax_primary(jsvo, jp, monkeypatch):
    """The primary trace result of the JAX deferred frame's second render
    of pose ``jp`` (its first settles the replayed compaction buckets)."""
    real = jshading._deferred_pipeline
    got = {}

    def pipeline(*a, **k):
        stages = list(real(*a, **k))
        trace = stages[1]

        def spied(*ta, **tk):
            out = trace(*ta, **tk)
            if tk.get("tag", "primary") == "primary":
                got["res"] = out[0]
            return out

        stages[1] = spied
        return tuple(stages)

    monkeypatch.setattr(jshading, "_deferred_pipeline", pipeline)
    td._jax_deferred(jsvo, jp)
    monkeypatch.undo()
    return got["res"]


@pytest.mark.parametrize("cam", ["horizon"])
def test_kd_primary_plain_matches_the_jax_primary_trace(cam, monkeypatch):
    jsvo, tsvo, jh, th = td._get("glass")
    jp, tp = td._params(td.JRenderParams, cam), td._params(td.RenderParams,
                                                           cam)
    W, H = td.W, td.H
    jp.render_shadows = tp.render_shadows = False
    jsvo.set_heightfield(jh)
    tsvo.set_heightfield(th)
    try:
        jres = _jax_primary(jsvo, jp, monkeypatch)
        ctx = tsvo.beam_context(tp, W, H)
        assert ctx is not None
        fp = shading.frame_params(mip_mode="nearest", deferred=True,
                                  **tsvo.frame_kwargs(tp, W, H))
        B = W * H
        rec = torch.empty((B, 9), dtype=torch.int32)
        hit = torch.empty(B, dtype=torch.bool)
        img = torch.zeros((B, 4))
        shading.kd_primary_plain(tsvo.world(), tsvo.octree_scale,
                                 tsvo.kernel_tables(), fp, 1,
                                 ctx.tile_floors, rec, hit, img)
    finally:
        jsvo.set_heightfield(None)
        tsvo.set_heightfield(None)
    rf = rec.view(torch.float32).numpy()
    t, pos, uv, lod = rf[:, 0], rf[:, 3:6], rf[:, 6:8], rf[:, 8]
    value = rec[:, 1].numpy().view(np.uint32)
    face = rec[:, 2].numpy()
    h = hit.numpy()
    np.testing.assert_array_equal(h, t != -1.0)
    jt = np.asarray(jres.t)
    jhit = jt != -1.0
    same = h & jhit & (value == np.asarray(jres.value).astype(np.uint32)) \
        & (face == np.asarray(jres.face_id))
    off = (h | jhit) & ~same
    assert off.mean() <= 0.01, off.mean()
    assert np.abs(t - jt)[same].max() <= TOL_T
    assert np.abs(pos - np.asarray(jres.pos))[same].max() <= TOL_T
    assert np.abs(uv - np.asarray(jres.uv))[same].max() <= TOL_UV
    assert np.abs(lod - np.asarray(jres.lod))[same].max() <= TOL_LOD
    assert 0.2 < h.mean() < 0.95  # terrain, the tower and sky
    # a miss pixel carries its sky, a hit pixel nothing
    rd = _frame_rays(fp, torch.arange(B))[1]
    assert torch.equal(img[~hit], shading.sky_color(rd[~hit]))
    assert not img[hit].any()

