"""voxelrs_tpu_torch's picker (``ops.picker.raycast_plain``, the plain
version of kernel K5, and ``graphics.Svo.raycast``) against the JAX
package's ``graphics.Svo._raycast_fn`` on the same ESVO buffer, and the
port's ``Physics`` against the JAX ``Physics``.

Scenes: generated terrain (the procedural world of bench.py at radius 2)
with a stone wall, and a sparse depth-11 world of four chunks spread over a
2048-block window (the octree depth of the game at render distance 20).
Batches: random look rays, and the AABB sweeps the JAX physics casts for a
player standing on the terrain, falling onto it and walking into the wall
(recorded from the JAX ``Svo.raycast`` while the JAX physics runs).

Tolerances. ``inside`` and ``normal`` and the hit/miss mask are exact.
``dst`` and ``pos`` within ``tol(depth)`` world units: XLA on the CPU
contracts ``a*b - c`` into fused multiply-adds and the port does not (nor
does K5, built with -fmad=false), so plane distances differ in their last
bits. The traversal runs in [1, 2) octree space, where one float32 ulp is
2^(depth-23) world units, so the tolerance is tests/test_torch_traversal.py's
1e-3 at depth 8 scaled by 2^(depth-8): 8e-3 at depth 11 (largest |d|
measured there: 2.3e-3, about ten ulps). The JAX picker runs the push engine, the
port the classic loop; the batches here show they agree. Physics: equal
trajectories, bit for bit (the same float32 host arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrs_tpu.gamelogic import content as jcontent
from voxelrs_tpu.gamelogic.worldgen import Generator as JGenerator
from voxelrs_tpu.gamelogic.worldgen import default_config as jdefault_config
from voxelrs_tpu.graphics import picker as jpicker
from voxelrs_tpu.graphics.svo import Svo as JSvo
from voxelrs_tpu.systems import physics as jphysics
from voxelrs_tpu.world import ChunkPos as JChunkPos
from voxelrs_tpu.world import Position as JPosition
from voxelrs_tpu.world.chunk import Chunk as JChunk
from voxelrs_tpu.world.esvo import Esvo as JEsvo
from voxelrs_tpu.world.esvo import SerializedChunk as JSerializedChunk
from voxelrs_tpu_torch import convert
from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.graphics import picker
from voxelrs_tpu_torch.graphics.svo import Svo
from voxelrs_tpu_torch.ops.picker import raycast, raycast_plain
from voxelrs_tpu_torch.systems import physics

WALL_X = 40  # the stone wall of the terrain scene: x in [40, 42)


def tol(depth: int) -> float:
    return 1e-3 * 2.0 ** max(0, depth - 8)


def _terrain_chunks():
    """{(cx, cy, cz): voxels} of the procedural world at radius 2, with a
    wall four blocks high on the terrain along x = 40..41."""
    gen = JGenerator(1, jdefault_config())
    chunks = {}
    for cx in range(4):
        for cz in range(4):
            col = gen.get_column(cx, cz)
            for cy in range(8):
                if col.contains_chunk(cy):
                    chunk = JChunk(JChunkPos(cx, cy, cz))
                    gen.generate_chunk(chunk)
                    if chunk.voxels.any():
                        chunks[(cx, cy, cz)] = chunk.voxels.copy()
    for (cx, cy, cz), vox in chunks.items():
        if cx == WALL_X // 32:
            x = WALL_X % 32
            solid = vox[x:x + 2] != 0
            top = np.where(solid.any(1), 31 - np.argmax(solid[:, ::-1], 1), -1)
            for i in range(2):
                for z in range(32):
                    if top[i, z] >= 0:
                        vox[x + i, top[i, z]:min(32, top[i, z] + 5), z] = \
                            jcontent.STONE
    return chunks


def _svo_pair(chunks):
    """(JAX graphics Svo, port Svo on the CPU) over the same ESVO buffer;
    the port's buffer is carried across with ``convert``."""
    world = JEsvo()
    for (cx, cy, cz), vox in chunks.items():
        sc = JSerializedChunk.from_voxels(JChunkPos(cx, cy, cz), vox, 5)
        if sc.has_data():
            world.set_leaf(JPosition(cx, cy, cz), sc, True)
    world.serialize()
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=16)
    jsvo.update(world)
    tsvo = Svo(content.new_registry(), capacity_mb=16, device="cpu")
    state = convert.svo_state_from_jax(
        np.asarray(jsvo.device_buf), jsvo.octree_scale, [], np.zeros((0, 2)),
        np.zeros((0, 6)), device="cpu")
    tsvo.device_buf = state.descriptors
    tsvo.octree_scale, tsvo.depth = state.octree_scale, jsvo.depth
    return jsvo, tsvo


@pytest.fixture(scope="module")
def terrain():
    chunks = _terrain_chunks()
    jsvo, tsvo = _svo_pair(chunks)
    heights = np.full((128, 128), -1)
    for (cx, cy, cz), vox in chunks.items():
        solid = vox != 0
        top = np.where(solid.any(1), 31 - np.argmax(solid[:, ::-1, :], 1), -1)
        top = np.where(top >= 0, top + cy * 32, -1)
        sl = heights[cx * 32:cx * 32 + 32, cz * 32:cz * 32 + 32]
        np.maximum(sl, top, out=sl)
    return jsvo, tsvo, heights


@pytest.fixture(scope="module")
def sparse():
    """Four chunks over a 2048-block window: octree depth 11."""
    rng = np.random.default_rng(11)
    chunks = {}
    for pos in ((0, 0, 0), (63, 0, 2), (5, 63, 40), (62, 61, 63)):
        vox = np.zeros((32, 32, 32), np.uint32)
        vox[:, :10, :] = jcontent.STONE
        vox[:, 10, :] = jcontent.GRASS
        vox[rng.random((32, 32, 32)) < 0.05] = jcontent.DIRT
        chunks[pos] = vox
    jsvo, tsvo = _svo_pair(chunks)
    assert jsvo.depth == 11
    return jsvo, tsvo, list(chunks)


def _padded(tasks):
    n = len(tasks)
    n_pad = 1 << max(3, (n - 1).bit_length())
    padded = np.zeros((n_pad, 7), np.float32)
    padded[:n] = tasks
    padded[n:, 4] = 1.0
    return padded


def _jax_rows(jsvo, tasks):
    padded = _padded(tasks)
    dst, inside, pos, normal = jsvo._raycast_fn(len(padded))(
        jsvo.device_buf, jnp.float32(jsvo.octree_scale), jnp.uint32(0),
        jnp.asarray(padded))
    n = len(tasks)
    return (np.asarray(dst)[:n], np.asarray(inside)[:n], np.asarray(pos)[:n],
            np.asarray(normal)[:n])


def assert_picker_parity(jsvo, tsvo, tasks):
    """The port's plain K5 against JAX ``_raycast_fn`` on one batch."""
    dst, inside, pos, normal = _jax_rows(jsvo, tasks)
    rows = raycast_plain(tsvo.device_buf, tsvo.octree_scale,
                         torch.from_numpy(_padded(tasks)))[:len(tasks)]
    rows = rows.numpy()
    atol = tol(jsvo.depth)
    np.testing.assert_array_equal(rows[:, 0] == -1.0, dst == -1.0)
    np.testing.assert_allclose(rows[:, 0], dst, rtol=0, atol=atol)
    np.testing.assert_array_equal(rows[:, 1] != 0, inside)
    np.testing.assert_allclose(rows[:, 2:5], pos, rtol=0, atol=atol)
    np.testing.assert_array_equal(rows[:, 5:8], normal)
    return rows


def _look_rays(rng, origins, n, max_dst, spread=20.0):
    """n rays [max_dst, pos, dir] from random points within ``spread`` of
    ``origins``, in random directions."""
    o = origins[rng.integers(0, len(origins), n)] + rng.uniform(
        -spread, spread, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([np.full((n, 1), max_dst), o, d], 1).astype(np.float32)


def test_raycast_wrapper_is_the_plain_version_on_the_cpu(terrain):
    _, tsvo, _ = terrain
    tasks = torch.from_numpy(_padded(_look_rays(
        np.random.default_rng(0), np.array([[64.0, 80.0, 64.0]]), 20, 30.0)))
    a = raycast(tsvo.device_buf, tsvo.octree_scale, tasks)
    b = raycast_plain(tsvo.device_buf, tsvo.octree_scale, tasks)
    assert a.shape == (tasks.shape[0], 8) and a.dtype == torch.float32
    assert torch.equal(a, b)


@pytest.mark.parametrize("max_dst", [30.0, 10.0])
def test_look_rays_on_terrain(terrain, max_dst):
    """Look rays from a few blocks above the terrain, in every direction."""
    jsvo, tsvo, heights = terrain
    rng = np.random.default_rng(int(max_dst))
    xz = rng.integers(8, 120, (300, 2))
    above = np.stack([xz[:, 0], heights[xz[:, 0], xz[:, 1]] + 2.0, xz[:, 1]],
                     1).astype(np.float64)
    tasks = _look_rays(rng, above, 300, max_dst, spread=3.0)
    rows = assert_picker_parity(jsvo, tsvo, tasks)
    assert 0.1 < (rows[:, 0] > 0).mean() < 0.95


def test_look_rays_in_the_depth_11_world(sparse):
    jsvo, tsvo, chunks = sparse
    origins = np.array([[32 * x + 16, 32 * y + 16, 32 * z + 16]
                        for x, y, z in chunks], np.float64)
    tasks = _look_rays(np.random.default_rng(3), origins, 400, 30.0)
    rows = assert_picker_parity(jsvo, tsvo, tasks)
    assert (rows[:, 0] > 0).mean() > 0.2


class _Recorder:
    """Wraps the JAX ``Svo.raycast`` and keeps every task batch it casts."""

    def __init__(self, svo):
        self.svo = svo
        self.batches = []

    def raycast(self, batch, result):
        self.batches.append(batch.serialize_tasks())
        self.svo.raycast(batch, result)


def _player(module, pos):
    return module.Entity(
        position=np.array(pos, np.float32),
        aabb_def=module.AABBDef(np.array([-0.4, -1.7, -0.4], np.float32),
                                np.array([0.8, 1.8, 0.8], np.float32)))


@pytest.mark.parametrize("scenario", ["standing", "falling", "wall"])
def test_physics_sweeps_on_terrain(terrain, scenario):
    """The AABB sweeps of a player on the terrain: the JAX physics casts
    them; each batch then goes through both pickers."""
    jsvo, tsvo, heights = terrain
    x, z = 36.3, 52.6
    ground = heights[int(x), int(z)] + 1.0
    # standing: feet on the top face; falling: from 4.3 blocks up; wall:
    # feet just above the ground, as a landed player rests
    y = ground + {"standing": 1.7, "falling": 6.0, "wall": 1.71}[scenario]
    e = _player(jphysics, (x, y, z))
    if scenario == "wall":
        e.velocity[0] = 9.0  # walking speed, +x into the wall
    rec = _Recorder(jsvo)
    p = jphysics.Physics()
    for _ in range(150):
        if scenario == "wall":
            e.velocity[0] = 9.0
        p.step(1 / 250, rec, e)
    assert e.state.is_grounded
    if scenario == "wall":
        assert WALL_X - 0.41 < e.position[0] < WALL_X - 0.39  # stopped at it
    batches = {b.tobytes(): b for b in rec.batches}.values()
    hits = 0
    for tasks in batches:
        assert tasks.shape == (32, 7)
        rows = assert_picker_parity(jsvo, tsvo, tasks)
        hits += int((rows[:, 0] > 0).sum())
    assert hits > 0


def test_svo_raycast_memo_and_padding(terrain):
    """``Svo.raycast`` fills the picker results like the JAX ``Svo.raycast``
    and replays a repeated batch from its memo until ``update`` changes the
    buffer."""
    jsvo, tsvo, heights = terrain
    results = []
    for mod, svo in ((jpicker, jsvo), (picker, tsvo)):
        batch, res = mod.PickerBatch(), mod.PickerBatchResult()
        batch.add_ray(np.array([60.5, heights[60, 60] + 10.0, 60.5], np.float32),
                      np.array([0.0, -1.0, 0.0], np.float32), 30.0)
        batch.add_aabb(mod.Aabb.new([36.3, heights[36, 52] + 2.7, 52.6],
                                    [-0.4, -1.7, -0.4], [0.8, 1.8, 0.8]))
        svo.raycast(batch, res)
        results.append(res)
    (jr,), (tr,) = results[0].rays, results[1].rays
    assert tr.did_hit() and jr.did_hit()
    atol = tol(jsvo.depth)
    assert abs(tr.dst - jr.dst) <= atol and tr.inside_voxel == jr.inside_voxel
    np.testing.assert_array_equal(tr.normal, jr.normal)
    (ja,), (ta,) = results[0].aabbs, results[1].aabbs
    np.testing.assert_allclose(ta.neg, ja.neg, rtol=0, atol=atol)
    np.testing.assert_allclose(ta.pos, ja.pos, rtol=0, atol=atol)

    version = tsvo._buffer_version
    (key, cached), = tsvo._raycast_memo[1].items()
    batch, res = picker.PickerBatch(), picker.PickerBatchResult()
    batch.add_ray(np.array([60.5, heights[60, 60] + 10.0, 60.5], np.float32),
                  np.array([0.0, -1.0, 0.0], np.float32), 30.0)
    batch.add_aabb(picker.Aabb.new([36.3, heights[36, 52] + 2.7, 52.6],
                                   [-0.4, -1.7, -0.4], [0.8, 1.8, 0.8]))
    tsvo._raycast_memo[1][key] = tuple(a * 0 + 7 for a in cached)
    tsvo.raycast(batch, res)
    assert res.rays[0].dst == 7.0  # replayed from the memo
    assert tsvo._buffer_version == version


class _Mock:
    """tests/test_physics.py's mock raycaster, for either package: canned
    per-step AabbResults."""

    def __init__(self, module, script):
        self.module, self.script, self.i = module, script, 0

    def raycast(self, batch, result):
        neg, pos = self.script[self.i % len(self.script)]
        self.i += 1
        for _ in batch.aabbs:
            result.aabbs.append(self.module.AabbResult(
                np.array(neg, np.float32), np.array(pos, np.float32)))


@pytest.mark.parametrize("flying,wall_clip", [(False, False), (False, True),
                                               (True, False)])
def test_physics_trajectories_equal_jax(flying, wall_clip):
    rng = np.random.default_rng(4)
    script = []
    for _ in range(40):
        neg = np.where(rng.random(3) < 0.5, -1.0, rng.uniform(0, 0.3, 3))
        pos = np.where(rng.random(3) < 0.5, -1.0, rng.uniform(0, 0.3, 3))
        script.append((neg, pos))
    runs = []
    for mod, pmod in ((jphysics, jpicker), (physics, picker)):
        e = _player(mod, (1.5, 70.25, -3.5))
        e.caps.flying, e.caps.wall_clip = flying, wall_clip
        ray = _Mock(pmod, script)
        p = mod.Physics()
        traj = []
        for i in range(200):
            e.velocity[0] = 9.0 * np.cos(i / 17)
            e.velocity[2] = 9.0 * np.sin(i / 23)
            if flying:
                e.velocity[1] = 3.0 * np.sin(i / 11)
            p.step(1 / 250, ray, e)
            traj.append((e.position.copy(), e.velocity.copy(),
                         bool(e.state.is_grounded)))
        runs.append(traj)
    for (jp, jv, jg), (tp, tv, tg) in zip(*runs):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tv, jv)
        assert tg == jg
