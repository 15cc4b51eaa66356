"""voxelrs_tpu_torch's game loop in the CSVO format (``Game`` with
``svo_format="csvo"`` on the CPU) against the JAX package's CSVO ``Game``,
with tests/test_torch_game.py's arguments (render distance 2, 16 MB, 2
workers, the same pose) and frames at 64x48: chunk streaming to the same
loaded world, the frame against the JAX fused CSVO frame, the look ray, the
fixed-step physics, and a block break and place round trip.

As in tests/test_torch_game.py, the comparisons after streaming move the
player to an off-lattice pose above the terrain (ABOVE), where neither
package's result hangs on the last bit of a ray direction (that file's
docstring says why the fixture's pose does not serve).

Tolerances: the loaded chunk set, the SVO's leaves and depth, ``inside``,
the normal and the edited blocks exact; the look-ray distance and position
and the player's position within 1e-3 (tests/test_torch_traversal.py's
float tolerance); the frame against the JAX fused CSVO frame within
tests/test_torch_render.py's bound (mean |d| <= 1e-3, at most 1% of the
pixels over 1e-3). The JAX picker casts with its CSVO push engine, the port
with the classic loop (K5's CSVO instantiation on the card): the game's own
batches here show that they agree.
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
from voxelrs_tpu_torch.gamelogic.game import Game, GameArgs, parse_args
from voxelrs_tpu_torch.ops.traversal_csvo import CsvoBuffer

W, H = 64, 48
TOL = 1e-3
ABOVE = (16.37, 63.21, 16.83)  # feet 0.5 above the ground, chunk (0, 1, 0)
ARGS = dict(player_pos=(16.0, 60.0, 16.0), player_euler_rot=(-30.0, 45.0, 0.0),
            render_distance=2, width=W, height=H, gpu_buffer_size_mb=16,
            workers=2, svo_format="csvo")


@pytest.fixture(scope="module")
def games():
    jg = JGame(JGameArgs(**ARGS))
    tg = Game(GameArgs(device="cpu", **ARGS))
    yield jg, tg
    jg.shutdown()
    tg.shutdown()


def _chunks(game):
    return {(p.x, p.y, p.z) for p in game.world.world.chunks}


def test_csvo_worlds_stream_to_the_same_chunks(games):
    jg, tg = games
    assert jg.wait_for_world(timeout=120)
    assert tg.wait_for_world(timeout=120)
    assert len(_chunks(tg)) > 0
    assert _chunks(tg) == _chunks(jg)
    leaves = {(p.x, p.y, p.z) for p in tg.world.world_svo.leaf_ids}
    assert leaves == {(p.x, p.y, p.z) for p in jg.world.world_svo.leaf_ids}
    js, ts = jg.world.world_svo.get_stats(), tg.world.world_svo.get_stats()
    assert ts.depth == js.depth and ts.used_bytes > 0
    gsvo = tg.world.world_svo.graphics_svo
    assert gsvo.host_buf.dtype == np.uint8
    world = gsvo.world()
    assert isinstance(world, CsvoBuffer) and world.total_depth == ts.depth
    assert world.root_ptr == int.from_bytes(bytes(gsvo.host_buf[:4]), "little")


def test_csvo_frame_and_look_ray_match_jax(games):
    jg, tg = games
    for g in games:
        g.player.position = np.array(ABOVE, np.float32)
    img = tg.step_frame(dt=1 / 60, render=True, width=W, height=H)
    assert isinstance(img, torch.Tensor) and img.shape == (H, W, 4)
    img = img.numpy().astype(np.float64)
    assert np.isfinite(img).all()
    jg.step_frame(dt=1 / 60)
    # the JAX fused CSVO frame on the JAX game's own render parameters
    p = jg.world.render_params(W / H)
    jp = JRenderParams(**{k: copy.copy(v) for k, v in p.__dict__.items()})
    cs = jg.world.world_svo.coord_space
    jp.cam_pos = cs.cnv_block_pos(np.asarray(p.cam_pos, np.float64))
    assert p.selected_voxel is not None
    jp.selected_voxel = cs.cnv_block_pos(np.asarray(p.selected_voxel,
                                                    np.float64))
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
    sky = img[..., 2] > 0.75
    assert 0.05 < sky.mean() < 0.95  # terrain and sky both in view


def test_csvo_physics_steps_match_jax(games):
    """60 fixed 250 Hz steps of a player falling from ABOVE: equal after
    every step, and landed."""
    jg, tg = games
    for g in games:
        g.player.caps.flying = False
        g.player.velocity[:] = 0.0
    for _ in range(60):
        jg.world.update_fixed(jg.player, 1 / 250)
        tg.world.update_fixed(tg.player, 1 / 250)
        np.testing.assert_allclose(tg.player.position, jg.player.position,
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(tg.player.velocity, jg.player.velocity,
                                   rtol=0, atol=TOL)
        assert tg.player.state.is_grounded == jg.player.state.is_grounded
    assert tg.player.state.is_grounded
    for g in games:
        g.player.caps.flying = True


def _look_down_and_press(game, button):
    game.input.buttons_pressed = {button} if button else set()
    game.step_frame(dt=1 / 60)
    return game.gameplay.looking_at


def test_csvo_block_break_and_place_round_trip(games):
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


def test_the_cli_takes_csvo():
    """``--svo-format csvo`` reaches ``GameArgs``; ``--mc-world`` still
    raises (not ported)."""
    assert parse_args(["--svo-format", "csvo"]).svo_format == "csvo"
    with pytest.raises(NotImplementedError, match="mc-world"):
        Game(GameArgs(mc_world="x", device="cpu", svo_format="csvo"))
