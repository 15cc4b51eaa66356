"""voxelrs_tpu_torch's game loop (``gamelogic.game.Game`` on the CPU)
against the JAX package's ``Game``, with tests/test_game.py's arguments
(render distance 2, 16 MB, 2 workers, the same pose) and frames at 64x48:
chunk streaming to the same loaded world, the frame, the look ray, the
fixed-step physics, and a block break and place round trip.

Chunks arrive in thread order, so the two buffers hold the same world in
different layouts: only what the world renders and answers is compared.

The fixture's pose streams the world. The comparisons after it move the
player to an off-lattice pose above the terrain (ABOVE, same chunk): the
fixture's pose puts the camera exactly on a voxel corner inside the
terrain, where the starting voxel of a ray hangs on the last bit of its
direction. There, XLA's CPU fusion of ``a*b - c`` into one FMA changes the
JAX traversal itself (the jitted JAX frame differs from the same program run
op by op on most pixels), and one-ulp differences in the ray directions
(torch's CPU ``sqrt`` is not correctly rounded) move the op-by-op frame off
the port's: neither is a reference for the last bit. The port's kernels
equal its plain versions bit for bit on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: the loaded chunk set, the SVO's leaves and depth, ``inside``, the
normal and the edited blocks exact; the look-ray distance and position and
the player's position within 1e-3 (tests/test_torch_traversal.py's float
tolerance); the frame against the JAX fused frame within
tests/test_torch_render.py's bound (mean |d| <= 1e-3, <= 1% of pixels over
1e-3), and against the JAX game's own (deferred) frame within the golden
budget, mean |d| < 0.015.
"""

import copy

import numpy as np
import pytest
import torch

from voxelrs_tpu.gamelogic import content as jcontent
from voxelrs_tpu.gamelogic.game import Game as JGame
from voxelrs_tpu.gamelogic.game import GameArgs as JGameArgs
from voxelrs_tpu.graphics.svo import RenderParams as JRenderParams
from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.gamelogic.game import Game, GameArgs
from voxelrs_tpu_torch.ops import picker, shading

W, H = 64, 48
TOL = 1e-3
ABOVE = (16.37, 63.21, 16.83)  # feet 0.5 above the ground, chunk (0, 1, 0)
ARGS = dict(player_pos=(16.0, 60.0, 16.0), player_euler_rot=(-30.0, 45.0, 0.0),
            render_distance=2, width=W, height=H, gpu_buffer_size_mb=16,
            workers=2)


@pytest.fixture(scope="module")
def games():
    jg = JGame(JGameArgs(**ARGS))
    tg = Game(GameArgs(device="cpu", **ARGS))
    yield jg, tg
    jg.shutdown()
    tg.shutdown()


def _chunks(game):
    return {(p.x, p.y, p.z) for p in game.world.world.chunks}


def test_worlds_stream_to_the_same_chunks(games):
    jg, tg = games
    assert jg.wait_for_world(timeout=120)
    assert tg.wait_for_world(timeout=120)
    assert len(_chunks(tg)) > 0
    assert _chunks(tg) == _chunks(jg)
    # the SVO's byte size depends on the order and batching in which the
    # chunks arrived (freed ranges are reused), so only its leaves and
    # depth are compared
    leaves = {(p.x, p.y, p.z) for p in tg.world.world_svo.leaf_ids}
    assert leaves == {(p.x, p.y, p.z) for p in jg.world.world_svo.leaf_ids}
    js, ts = jg.world.world_svo.get_stats(), tg.world.world_svo.get_stats()
    assert ts.depth == js.depth and ts.used_bytes > 0
    assert tg.debug_stats()["chunks_loaded"] == len(_chunks(tg))


def test_frame_and_look_ray_match_jax(games):
    jg, tg = games
    for g in games:
        g.player.position = np.array(ABOVE, np.float32)
    n5, n3 = picker.launches, shading.launches
    img = tg.step_frame(dt=1 / 60, render=True, width=W, height=H)
    assert (picker.launches, shading.launches) == (n5, n3)  # no card here
    # the game renders the JAX package's default mode, with its heightfield
    frame = tg.world.world_svo.graphics_svo.last_frame
    assert frame["mode"] == "deferred" and frame["beams"], frame
    assert isinstance(img, torch.Tensor) and img.shape == (H, W, 4)
    img = img.numpy().astype(np.float64)
    assert np.isfinite(img).all()
    jdef = np.asarray(jg.step_frame(dt=1 / 60, render=True, width=W, height=H))
    # the JAX fused frame on the JAX game's own render parameters
    p = jg.world.render_params(W / H)
    jp = JRenderParams(**{k: copy.copy(v) for k, v in p.__dict__.items()})
    cs = jg.world.world_svo.coord_space
    jp.cam_pos = cs.cnv_block_pos(np.asarray(p.cam_pos, np.float64))
    assert p.selected_voxel is not None
    jp.selected_voxel = cs.cnv_block_pos(np.asarray(p.selected_voxel, np.float64))
    jfused = np.asarray(jg.world.world_svo.graphics_svo.render(
        jp, W, H, mode="fused"))

    jl, tl = jg.gameplay.looking_at, tg.gameplay.looking_at
    assert tl is not None and jl is not None
    assert abs(tl.dst - jl.dst) <= TOL
    assert tl.inside_voxel == jl.inside_voxel
    np.testing.assert_allclose(tl.pos, jl.pos, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tl.normal, jl.normal)

    d = np.abs(img - jfused)
    assert d.mean() <= 1e-3, d.mean()
    assert (d.max(-1) > 1e-3).mean() <= 0.01
    golden = float(np.abs(img - jdef).mean())
    print(f"port frame vs the JAX game's deferred frame: mean |d| {golden:.3g}")
    assert golden < 0.015
    sky = img[..., 2] > 0.75
    assert 0.05 < sky.mean() < 0.95  # terrain and sky both in view


def test_physics_steps_match_jax(games):
    """Fixed 250 Hz steps of a player falling from ABOVE: equal after every
    step, landed after the 30 steps of the comparison and 30 more."""
    jg, tg = games
    for g in games:
        g.player.caps.flying = False
        g.player.velocity[:] = 0.0
    for i in range(60):
        jg.world.update_fixed(jg.player, 1 / 250)
        tg.world.update_fixed(tg.player, 1 / 250)
        np.testing.assert_allclose(tg.player.position, jg.player.position,
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(tg.player.velocity, jg.player.velocity,
                                   rtol=0, atol=TOL)
        assert tg.player.state.is_grounded == jg.player.state.is_grounded
        if i == 29:
            assert tg.player.position[1] < ABOVE[1] - 0.1  # falling
    assert tg.player.state.is_grounded
    for g in games:
        g.player.caps.flying = True


def _look_down_and_press(game, button):
    game.input.buttons_pressed = {button} if button else set()
    game.step_frame(dt=1 / 60)
    return game.gameplay.looking_at


def test_block_break_and_place_round_trip(games):
    jg, tg = games
    edits = []
    for g, ct in ((jg, jcontent), (tg, content)):
        g.player.position = np.array(ABOVE, np.float32)
        g.player.euler_rotation[:] = (-np.pi / 2 + 1e-3, 0.0, 0.0)
        hit = _look_down_and_press(g, None)
        assert hit is not None and hit.did_hit()
        cell = tuple(int(np.floor(v)) for v in hit.pos)
        before = g.world.world.get_block(*cell)
        assert before != ct.AIR
        _look_down_and_press(g, 1)  # break
        assert g.world.world.get_block(*cell) == ct.AIR
        assert g.wait_for_world(timeout=60)  # re-serialized and uploaded
        hit = _look_down_and_press(g, None)
        below = tuple(int(np.floor(v)) for v in hit.pos)
        _look_down_and_press(g, 2)  # place on the block below
        edits.append((cell, int(before), below, tuple(hit.normal),
                      int(g.world.world.get_block(*cell))))
    assert edits[1] == edits[0]
    cell, _, below, normal, after = edits[1]
    assert below == (cell[0], cell[1] - 1, cell[2]) and normal == (0, 1, 0)
    assert after == content.GRASS


def test_game_runs_on_the_card_unless_asked_for_the_cpu():
    """``GameArgs().device`` is None, the card; without one the game raises
    (no CPU fallback) and leaves no job thread running."""
    import threading

    assert GameArgs().device is None
    if torch.cuda.is_available():
        return
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Game(GameArgs())
    assert threading.active_count() == before


def test_chunk_processor_pending_matches_jax():
    """``ChunkProcessor.has_pending`` (the port's stops at the first live
    job) and the results it hands out agree with the JAX package's through
    enqueues, re-enqueues, dequeues, cancellations (as ``JobSystem.clear``
    cancels) and partial drains."""
    from voxelrs_tpu.systems import jobs as jjobs
    from voxelrs_tpu_torch.systems import jobs

    class ManualJobs:
        """A job system whose jobs run when the test says so."""

        def __init__(self, handle_cls):
            self.handle_cls, self.queue = handle_cls, []

        def push(self, prioritize, fn):
            h = self.handle_cls()
            self.queue.append((h, fn))
            return h

        def run(self, k):
            for h, fn in self.queue[:k]:
                if not h.is_cancelled():
                    fn()
            del self.queue[:k]

    rng = np.random.default_rng(2)
    script = rng.integers(0, 5, 300)
    positions = rng.integers(0, 40, 300).tolist()
    results = []
    for mod in (jjobs, jobs):
        js = ManualJobs(mod.JobHandle)
        proc = mod.ChunkProcessor(js)
        seen = []
        for op, pos in zip(script, positions):
            if op <= 1:
                proc.enqueue(pos, False, lambda pos=pos: pos * 10)
            elif op == 2:
                proc.dequeue(pos)
            elif op == 3:
                for h, _ in js.queue[::3]:
                    h.cancel()
            else:
                js.run(4)
                seen.append(sorted((r.pos, r.value)
                                   for r in proc.get_results(3)))
            seen.append(proc.has_pending())
        for h, _ in js.queue:
            h.cancel()
        seen.append(proc.has_pending())
        results.append(seen)
    assert results[1] == results[0]
    assert True in results[1] and results[1][-1] is False
