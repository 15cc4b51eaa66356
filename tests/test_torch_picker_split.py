"""K5's split cast in plain PyTorch (``ops.picker.raycast_split_plain``:
a picker task's ray cut into a warp's lanes' segments, the nearest hit
winning, lane 0 casting the whole ray where the split could differ) against
the classic cast (``raycast_plain``) bit for bit, and against the JAX
``Svo._raycast_fn``, in both formats.

Batches: the AABB sweeps the JAX physics casts for a player standing on
the terrain, falling onto it and walking into a wall (feet on a block's
top face: rays that start on or inside a voxel), look rays from above
the terrain, the picker batches of the port's game on the CPU, and seeded
tasks that start inside voxels, on faces, graze along faces (axis-aligned
rays in a face's plane), pad a batch (``max_dst`` 0, direction +x), are
shorter than lane 0's segment or start outside the world; and the same
tasks at step budgets of 4-40 steps, where some tasks run out of steps
(the classic cast's cut must come out the same). Segments: 2, 8, 31 and
32 lanes. Tolerances against JAX: test_torch_picker.py's (``tol``).

The split skips lane 0's recast only where lane 0's steps plus
``split_cells`` fit the budget; that this reproduces the classic cast's cut
rests on the bound that the classic cast, uncut, takes at most lane 0's
steps plus ``split_cells``. It is checked on every batch above and on long
rays (up to 250 blocks, grazing the terrain), and at budgets between the
two, where some tasks skip the recast and others are cut."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_csvo as tc
import test_torch_picker as tp
from test_torch_picker import sparse, terrain  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401
from voxelrs_tpu.graphics.svo import Svo as JSvo
from voxelrs_tpu.gamelogic import content as jcontent
from voxelrs_tpu.systems import physics as jphysics
from voxelrs_tpu_torch import convert
from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.graphics.svo import Svo
from voxelrs_tpu_torch.ops.picker import (K5_FIRST, _rows, raycast_plain,
                                          raycast_split_plain, split_cells)
from voxelrs_tpu_torch.ops.shading import trace_plain
from voxelrs_tpu_torch.ops.traversal import step_budget
from voxelrs_tpu_torch.ops.traversal_csvo import CsvoBuffer
from voxelrs_tpu_torch.ops.traversal_csvo import step_budget as csvo_budget

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEGMENTS = [2, 8, 31, 32]


@pytest.fixture(scope="module")
def csvo_terrain():
    """The terrain scene of test_torch_picker.py (its wall included) as a
    CSVO world, in both Svos, and its height map."""
    chunks = tp._terrain_chunks()
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=16, buffer_dtype=np.uint8)
    jsvo.update(tc._jax_world(chunks))
    tsvo = Svo(content.new_registry(), capacity_mb=16, buffer_dtype=np.uint8,
               device="cpu")
    buf = convert.csvo_buffer_from_jax(np.asarray(jsvo.device_buf),
                                       jsvo.root_ptr, jsvo.depth, device="cpu")
    tsvo.device_buf, tsvo.root_ptr, tsvo.depth = buf
    tsvo.octree_scale = jsvo.octree_scale
    return jsvo, tsvo


@pytest.fixture(scope="module")
def worlds(terrain, csvo_terrain):  # noqa: F811
    """{format: (JAX Svo, port Svo)} and the terrain's height map."""
    return {"esvo": terrain[:2], "csvo": csvo_terrain}, terrain[2]


def _jax_rows(jsvo, tasks):
    padded = tp._padded(tasks)
    root = jsvo.root_ptr if jsvo.buffer_dtype == np.uint8 else 0
    dst, inside, pos, normal = jsvo._raycast_fn(len(padded))(
        jsvo.device_buf, jnp.float32(jsvo.octree_scale), jnp.uint32(root),
        jnp.asarray(padded))
    n = len(tasks)
    return (np.asarray(dst)[:n], np.asarray(inside)[:n], np.asarray(pos)[:n],
            np.asarray(normal)[:n])


def assert_split_equal(tsvo, tasks, segments=SEGMENTS, max_steps=None):
    """Every segment count's split rows equal the classic cast's."""
    t = torch.from_numpy(np.asarray(tasks, np.float32))
    w = tsvo.world()
    if max_steps is None:
        ref = raycast_plain(w, tsvo.octree_scale, t)
    else:
        ref = _rows(trace_plain(w, tsvo.octree_scale, t[:, 1:4], t[:, 4:7],
                                t[:, 0], False, max_steps=max_steps), t)
    for s in segments:
        kw = {} if max_steps is None else {"max_steps": max_steps}
        got = raycast_split_plain(w, tsvo.octree_scale, t, s, **kw)
        bad = (got != ref).any(1)
        assert not bool(bad.any()), (s, t[bad][:3].tolist(),
                                     got[bad][:3].tolist(),
                                     ref[bad][:3].tolist())
    return ref.numpy()


def assert_split_matches_jax(jsvo, tsvo, tasks):
    """The 32-lane split against the JAX picker, within ``tol``."""
    dst, inside, pos, normal = _jax_rows(jsvo, tasks)
    rows = raycast_split_plain(tsvo.world(), tsvo.octree_scale,
                               torch.from_numpy(tasks), 32).numpy()
    atol = tp.tol(jsvo.depth)
    np.testing.assert_array_equal(rows[:, 0] == -1.0, dst == -1.0)
    np.testing.assert_allclose(rows[:, 0], dst, rtol=0, atol=atol)
    np.testing.assert_array_equal(rows[:, 1] != 0, inside)
    np.testing.assert_allclose(rows[:, 2:5], pos, rtol=0, atol=atol)
    np.testing.assert_array_equal(rows[:, 5:8], normal)


def _sweeps(jsvo, heights, scenario):
    """The JAX physics' AABB sweep batches for a player on the terrain
    (test_torch_picker.py's scenarios)."""
    x, z = 36.3, 52.6
    ground = heights[int(x), int(z)] + 1.0
    y = ground + {"standing": 1.7, "falling": 6.0, "wall": 1.71}[scenario]
    e = tp._player(jphysics, (x, y, z))
    rec, p = tp._Recorder(jsvo), jphysics.Physics()
    for _ in range(150):
        if scenario == "wall":
            e.velocity[0] = 9.0
        p.step(1 / 250, rec, e)
    return list({b.tobytes(): b for b in rec.batches}.values())


@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("scenario", ["standing", "falling", "wall"])
def test_split_equals_classic_on_physics_sweeps(worlds, fmt, scenario):
    (jsvo, tsvo), heights = worlds[0][fmt], worlds[1]
    batches = _sweeps(jsvo, heights, scenario)
    rows = [assert_split_equal(tsvo, b) for b in batches]
    assert sum(int((r[:, 0] > 0).sum()) for r in rows) > 0
    assert_split_matches_jax(jsvo, tsvo, batches[-1])


@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
def test_split_equals_classic_on_look_rays(worlds, fmt):
    """Look rays of 30 and 10 blocks from a few blocks above the terrain,
    in every direction; the 30-block ones also against JAX."""
    (jsvo, tsvo), heights = worlds[0][fmt], worlds[1]
    rng = np.random.default_rng(20)
    xz = rng.integers(8, 120, (256, 2))
    above = np.stack([xz[:, 0], heights[xz[:, 0], xz[:, 1]] + 2.0, xz[:, 1]],
                     1).astype(np.float64)
    for md in (30.0, 10.0):
        tasks = tp._look_rays(rng, above, 256, md, spread=3.0)
        rows = assert_split_equal(tsvo, tasks)
        assert 0.1 < (rows[:, 0] > 0).mean() < 0.95
    assert_split_matches_jax(jsvo, tsvo, tasks)


def test_split_equals_classic_in_the_depth_11_world(sparse):  # noqa: F811
    jsvo, tsvo, chunks = sparse
    origins = np.array([[32 * x + 16, 32 * y + 16, 32 * z + 16]
                        for x, y, z in chunks], np.float64)
    tasks = tp._look_rays(np.random.default_rng(4), origins, 300, 30.0)
    rows = assert_split_equal(tsvo, tasks)
    assert (rows[:, 0] > 0).mean() > 0.2
    assert_split_matches_jax(jsvo, tsvo, tasks[:64])


def _edge_tasks(heights, n, seed):
    """Tasks that start inside voxels (block centres under the surface),
    on faces (the surface's top face, block corners), graze along faces
    (axis-aligned, in the plane of the surface's top), pad a batch, are
    shorter than lane 0's segment or start outside the world."""
    rng = np.random.default_rng(seed)
    xz = rng.integers(8, 120, (n, 2)).astype(np.float64)
    top = heights[xz[:, 0].astype(int), xz[:, 1].astype(int)] + 1.0
    kind = rng.integers(0, 6, n)
    o = np.stack([xz[:, 0], top, xz[:, 1]], 1)
    o[kind == 0] += (0.5, -1.5, 0.5)  # inside the block under the top
    o[kind == 1] += rng.choice([0.0, 0.5], (int((kind == 1).sum()), 3))
    o[kind == 4] = rng.uniform(-40, -20, (int((kind == 4).sum()), 3))
    d = rng.normal(size=(n, 3))
    axis = np.isin(kind, (1, 2, 3))
    d[axis] = np.eye(3)[rng.choice([0, 2, 1], int(axis.sum()))] * \
        rng.choice([-1.0, 1.0], (int(axis.sum()), 1))
    d[kind == 2, 1] = 0.0  # a graze: in the top face's plane
    d[(kind == 2) & (np.abs(d).sum(1) == 0)] = (1.0, 0.0, 0.0)
    d[kind == 4] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    md = rng.choice([10.0, 30.0, K5_FIRST, K5_FIRST + 0.25, 1.5], n)
    md[kind == 5] = 0.0  # padding tasks
    d[kind == 5] = (1.0, 0.0, 0.0)
    return np.concatenate([md[:, None], o, d], 1).astype(np.float32)


@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
def test_split_equals_classic_on_edge_tasks(worlds, fmt):
    (_, tsvo), heights = worlds[0][fmt], worlds[1]
    tasks = _edge_tasks(heights, 1200, 5)
    rows = assert_split_equal(tsvo, tasks)
    assert (rows[:, 1] != 0).sum() > 50  # starts inside a voxel that hit
    assert (rows[:, 0] > 0).sum() > 200


@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("max_steps", [4, 8, 12, 20, 40])
def test_split_equals_classic_near_the_step_budget(worlds, fmt, max_steps):
    """At small budgets the classic cast runs out of steps on some tasks;
    the split's rows are its rows all the same."""
    (_, tsvo), heights = worlds[0][fmt], worlds[1]
    tasks = np.concatenate([_edge_tasks(heights, 300, 6),
                            tp._look_rays(np.random.default_rng(7),
                                          np.array([[64.0, 70.0, 64.0]]),
                                          300, 30.0, spread=30.0)])
    t = torch.from_numpy(tasks)
    steps = trace_plain(tsvo.world(), tsvo.octree_scale, t[:, 1:4],
                        t[:, 4:7], t[:, 0], False, max_steps=max_steps).steps
    assert int((steps >= max_steps).sum()) > 0  # the budget cuts tasks
    assert_split_equal(tsvo, tasks, max_steps=max_steps)


@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
def test_split_equals_classic_on_the_games_batches(fmt):
    """Every picker batch of the port's game on the CPU (its look ray and
    physics sweeps while the player falls and lands), recorded at
    ``Svo.raycast``'s call."""
    import sys

    from voxelrs_tpu_torch.gamelogic.game import Game, GameArgs

    svo_mod = sys.modules["voxelrs_tpu_torch.graphics.svo"]
    batches = []
    real = svo_mod.raycast

    def record(desc, scale, tasks):
        batches.append((desc, scale, tasks.clone()))
        return real(desc, scale, tasks)

    g = Game(GameArgs(player_pos=(16.37, 70.0, 16.83),
                      player_euler_rot=(-30.0, 45.0, 0.0), render_distance=2,
                      device="cpu", gpu_buffer_size_mb=16, workers=2,
                      svo_format=fmt))
    svo_mod.raycast = record
    try:
        assert g.wait_for_world(timeout=120)
        g.player.caps.flying = False
        for _ in range(30):
            g.step_frame(dt=1 / 60)
    finally:
        svo_mod.raycast = real
        g.shutdown()
    assert len(batches) > 20
    for desc, scale, tasks in batches:
        ref = raycast_plain(desc, scale, tasks)
        for s in (8, 32):
            assert torch.equal(raycast_split_plain(desc, scale, tasks, s),
                               ref)


UNCUT = 1 << 16  # a step budget no task here reaches


@pytest.fixture(scope="module")
def slots():
    """{format: port Svo} of a world of stone (2 x 2 chunks, octree depth
    6) cut by a slot one block high at y = 10, with pillars in 1% of its
    blocks, and by tunnels one block wide along x at y = 20 and along z at
    y = 24, closed at the world's faces: a level ray in them crosses a cell
    of the octree's finest level at every block, the most cells a ray of
    its length can cross."""
    rng = np.random.default_rng(12)
    chunks = {}
    for cx in range(2):
        for cz in range(2):
            v = np.full((32, 32, 32), jcontent.STONE, np.uint32)
            v[:, 10, :] = 0
            v[:, 10, :][rng.random((32, 32)) < 0.01] = jcontent.STONE
            v[1 - cx:32 - cx, 20, 15] = 0
            v[15, 24, 1 - cz:32 - cz] = 0
            chunks[(cx, 0, cz)] = v
    esvo = tp._svo_pair(chunks)[1]
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=16, buffer_dtype=np.uint8)
    jsvo.update(tc._jax_world(chunks))
    csvo = Svo(content.new_registry(), capacity_mb=16, buffer_dtype=np.uint8,
               device="cpu")
    csvo.device_buf, csvo.root_ptr, csvo.depth = convert.csvo_buffer_from_jax(
        np.asarray(jsvo.device_buf), jsvo.root_ptr, jsvo.depth, device="cpu")
    csvo.octree_scale = jsvo.octree_scale
    return {"esvo": esvo, "csvo": csvo}


def _slot_rays(n, seed):
    """Level rays of 10-90 blocks in the slot (in every direction) and
    along the tunnels (both ways, from near either end)."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, n)
    o = np.stack([rng.uniform(1, 63, n), np.full(n, 10.5),
                  rng.uniform(1, 63, n)], 1)
    a = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(a), np.zeros(n), np.sin(a)], 1)
    for k, y, across, along in ((1, 20.5, 2, 0), (2, 24.5, 0, 2)):
        m = kind == k
        sign = rng.choice([-1.0, 1.0], int(m.sum()))
        o[m, 1] = y
        o[m, across] = 15.5 + 32 * rng.integers(0, 2, int(m.sum()))
        o[m, along] = np.where(sign > 0, rng.uniform(1, 4, int(m.sum())),
                               rng.uniform(60, 63, int(m.sum())))
        d[m] = 0.0
        d[m, along] = sign
    md = rng.choice([10.0, 30.0, 60.0, 90.0], n)
    return np.concatenate([md[:, None], o, d], 1).astype(np.float32)


def _bound_parts(tsvo, tasks):
    """The split tasks of a batch (``max_dst`` > K5_FIRST), the classic
    cast's steps on each with no budget, lane 0's steps on its segment,
    and ``split_cells``."""
    t = torch.from_numpy(np.asarray(tasks, np.float32))
    t = t[t[:, 0] > K5_FIRST]
    w, sc = tsvo.world(), tsvo.octree_scale
    classic = trace_plain(w, sc, t[:, 1:4], t[:, 4:7], t[:, 0], False,
                          max_steps=UNCUT)
    lane0 = trace_plain(w, sc, t[:, 1:4], t[:, 4:7],
                        torch.full_like(t[:, 0], K5_FIRST), False,
                        max_steps=UNCUT).steps
    return t, classic, lane0.float(), split_cells(sc, t)


def _batch(worlds, fmt, kind):
    (jsvo, _), heights = worlds[0][fmt], worlds[1]
    if kind == "sweeps":
        return np.concatenate([b for sc in ("standing", "falling", "wall")
                               for b in _sweeps(jsvo, heights, sc)])
    if kind == "look":
        rng = np.random.default_rng(20)
        xz = rng.integers(8, 120, (256, 2))
        above = np.stack([xz[:, 0], heights[xz[:, 0], xz[:, 1]] + 2.0,
                          xz[:, 1]], 1).astype(np.float64)
        return np.concatenate([tp._look_rays(rng, above, 256, md, spread=3.0)
                               for md in (30.0, 10.0)])
    return np.concatenate([_edge_tasks(heights, 1200, 5),
                           _edge_tasks(heights, 300, 6)])


@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("kind", ["sweeps", "look", "edge", "slots"])
def test_split_cells_bound_the_classic_steps(worlds, slots, fmt, kind):
    """On every split task the classic cast, uncut, takes at most lane 0's
    steps plus ``split_cells``: where those fit the budget the classic cast
    is not cut, so the split may skip lane 0's recast. In the slots the
    casts come within a quarter of the bound (a bound with half the cells
    a block would fail there)."""
    if kind == "slots":
        tsvo, tasks = slots[fmt], _slot_rays(2000, 1)
    else:
        tsvo, tasks = worlds[0][fmt][1], _batch(worlds, fmt, kind)
    t, classic, lane0, cells = _bound_parts(tsvo, tasks)
    assert len(t) > 100
    rest = classic.steps.float() - lane0
    over = rest > cells
    assert not bool(over.any()), (t[over][:3].tolist(), rest[over][:3],
                                  cells[over][:3])
    if kind == "slots":
        assert float((rest / cells).max()) > 0.75
        assert float((4.0 * tsvo.depth + 3.0 + 0.5 * (cells - 4.0 * tsvo.depth
                                                     - 3.0) - rest).min()) < 0


def test_split_cells_bound_the_classic_steps_at_depth_11(sparse):  # noqa: F811
    jsvo, tsvo, chunks = sparse
    origins = np.array([[32 * x + 16, 32 * y + 16, 32 * z + 16]
                        for x, y, z in chunks], np.float64)
    tasks = tp._look_rays(np.random.default_rng(4), origins, 300, 30.0)
    tasks[::3, 0] = 250.0
    t, classic, lane0, cells = _bound_parts(tsvo, tasks)
    assert not bool((classic.steps.float() - lane0 > cells).any())


@pytest.mark.parametrize("fmt", ["esvo", "csvo"])
@pytest.mark.parametrize("q", [0.25, 0.35, 0.5])
def test_split_skips_the_recast_and_keeps_the_budgets_cut(slots, fmt, q):
    """Level rays in the slots at a budget between ``split_cells`` and the
    classic cast's steps (the ``q`` quantile of lane 0's steps plus the
    cells): some tasks skip lane 0's recast, the budget cuts the classic
    cast of others that hit when uncut, and the split's rows are the
    classic cast's on all of them."""
    tsvo, tasks = slots[fmt], _slot_rays(1000, 9)
    t, classic, lane0, cells = _bound_parts(tsvo, tasks)
    max_steps = int(torch.quantile(lane0 + cells, q))
    budget = (csvo_budget if isinstance(tsvo.world(), CsvoBuffer)
              else step_budget)(max_steps)
    skips = lane0 + cells <= budget
    cut = classic.steps > budget
    assert int(skips.sum()) > 20  # no recast: the segments' rows stand
    assert int((skips & (classic.steps > 0.5 * budget)).sum()) > 0
    assert int((cut & (classic.t > 0)).sum()) > 5  # hits the cut loses
    assert_split_equal(tsvo, tasks, segments=[8, 32], max_steps=max_steps)
