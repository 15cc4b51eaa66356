"""The second file of tests/test_torch_adaptive.py: its case
``csvo-quarter-beams`` of test_adaptive_frame_matches_jax (the CSVO JAX
adaptive frame, whose compile is the first file's largest cost) and
test_adaptive_frame_within_the_thick_ray_budget, on that file's scenes,
cameras, sizes, tolerances and checks. A file of its own so that the
tier-1 run's workers share the file's work (``--dist loadfile`` gives a
file to one worker)."""

import numpy as np
import pytest

import test_torch_adaptive as ta
from test_torch_adaptive import jax_frames, scenes  # noqa: F401
from voxelrs_tpu_torch.graphics.svo import RenderParams

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("config", ta.BUDGET_FILE_CONFIGS)
def test_adaptive_frame_matches_jax(config, scenes, jax_frames, monkeypatch):
    ta.check_adaptive_frame_matches_jax(config, scenes, jax_frames,
                                        monkeypatch)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_adaptive_frame_within_the_thick_ray_budget(levels, scenes):
    """The adaptive frame against the port's exact frame, at each depth of
    grids (1 the half grid, 2 the quarter grid, 3 the eighth grid), with
    the beams and the sun map; the three beam variants give one frame."""
    _jsvo, tsvo, _jh, th = scenes("esvo")
    from voxelrs_tpu_torch.ops.adaptive import render_frame_adaptive_plain

    for cam in ("horizon", "down", "on-ground"):
        tp = ta._params(RenderParams, cam)
        exact = tsvo.render(tp, ta.W, ta.H, adaptive=False).numpy()
        tsvo.set_heightfield(th)
        try:
            ctx = tsvo.beam_context(tp, ta.W, ta.H)
        finally:
            tsvo.set_heightfield(None)
        kw = tsvo.frame_kwargs(tp, ta.W, ta.H)
        frames = [render_frame_adaptive_plain(
            tsvo.world(), tsvo.octree_scale, tsvo.mips, tsvo.mat_params,
            tsvo.mat_tex, beams=b, levels=levels, **kw).numpy()
            for b in (ctx, ctx.without_sun(), None)]
        for f in frames[1:]:
            np.testing.assert_array_equal(f, frames[0])
        ta.assert_thick_ray_budget(frames[0], exact, levels)
