"""The CSVO format of voxelrs_tpu_torch against voxelrs_tpu: the chunk
serializers (numpy and native, ESVO and CSVO), the CSVO world and its
upload, the plain CSVO traversal (kernel K4's plain version), the CSVO
frame, the CSVO picker and the crosshair overlay.

Every comparison feeds both packages the same inputs, made from a numpy
seed; traversal, frame and picker comparisons run on the very same word
buffer (``convert.csvo_buffer_from_jax``).

Tolerances. Serializers, buffers, uploads and every integer field (value,
face_id, inside_voxel, the hit/miss mask, normals) are exact. Float fields
of the traversal: tests/test_torch_traversal.py's bounds (t and pos within
TOL_T, uv within TOL_UV, lod within TOL_LOD): XLA on the CPU contracts
``a*b - c`` into fused multiply-adds, the port does not (nor does K4, built
with -fmad=false). Against the port's own ESVO traversal on the same
voxels: value and face_id exact, t within 1e-3 (tests/test_traversal_csvo.py).
Frames: tests/test_torch_render.py's bound (mean |d| <= 1e-3, at most 1% of
pixels over 1e-3). Picker distances and positions: 1e-3·2^(depth-8)
(tests/test_torch_picker.py). The crosshair: equal, bit for bit, to the JAX
overlay run op by op, within 1.2e-7 of the jitted one (its test says why).

The JAX opaque cast runs its CSVO push engine, with a step budget of its
own; the port runs the classic loop. Opaque comparisons therefore use the
default budget, where every ray here finishes; the small budgets (5-30) are
compared on translucent casts, which both packages run in the classic loop
(``unroll=2``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrs_tpu.gamelogic import content as jcontent
from voxelrs_tpu.gamelogic.worldgen import Generator as JGenerator
from voxelrs_tpu.gamelogic.worldgen import default_config as jdefault_config
from voxelrs_tpu.graphics import picker as jpicker
from voxelrs_tpu.graphics.svo import RenderParams as JRenderParams
from voxelrs_tpu.graphics.svo import Svo as JSvo
from voxelrs_tpu.ops.shading import crosshair_overlay as jcrosshair
from voxelrs_tpu.ops.shading import make_alpha_fn as jmake_alpha_fn
from voxelrs_tpu.ops.traversal_csvo import intersect_octree_csvo as jcsvo_trace
from voxelrs_tpu.systems import physics as jphysics
from voxelrs_tpu.world import ChunkPos as JChunkPos
from voxelrs_tpu.world import Position as JPosition
from voxelrs_tpu.world import csvo as jcsvo
from voxelrs_tpu.world import esvo_dense as jesvo_dense
from voxelrs_tpu.world.chunk import Chunk as JChunk
from voxelrs_tpu_torch import convert, native
from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.graphics import picker
from voxelrs_tpu_torch.graphics.svo import RenderParams, Svo
from voxelrs_tpu_torch.ops import shading, traversal_csvo
from voxelrs_tpu_torch.ops.picker import raycast_plain
from voxelrs_tpu_torch.ops.traversal import intersect_octree_plain
from voxelrs_tpu_torch.world import ChunkPos, Position, csvo, esvo_dense
from voxelrs_tpu_torch.world.esvo import PREAMBLE_LENGTH_IN_U32, Esvo
from voxelrs_tpu_torch.world.esvo import SerializedChunk

import test_torch_judged as tj
# the judged scene's module fixtures (a module of their own here)
from test_torch_judged import (jax_frames,  # noqa: F401
                               port_exact, scenes)

from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL_T = 1e-3
TOL_UV = 1e-3
TOL_LOD = 1e-4


def _cases():
    """The chunks of tests/test_native.py, plus a 20% random one."""
    rng = np.random.default_rng(0)
    empty = np.zeros((32, 32, 32), np.uint32)
    single = empty.copy()
    single[5, 17, 30] = 7
    sparse = np.where(rng.random((32, 32, 32)) < 0.03,
                      rng.integers(1, 13, (32, 32, 32)), 0).astype(np.uint32)
    dense = np.full((32, 32, 32), 3, np.uint32)
    x, z = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    h = (8 + 6 * np.sin(x / 5.0) + 4 * np.cos(z / 7.0)).astype(np.int32)
    terrain = np.zeros((32, 32, 32), np.uint32)
    for y in range(32):
        terrain[:, y, :] = np.where(y <= h, np.where(y == h, 1, 3), 0)
    rng = np.random.default_rng(17)
    random = (rng.random((32, 32, 32)) < 0.2).astype(np.uint32) * 7
    return {"empty": empty, "single": single, "sparse": sparse,
            "dense": dense, "terrain": terrain, "random": random}


# ---------------------------------------------------------------------------
# Serializers, worlds, uploads
# ---------------------------------------------------------------------------


def test_native_libraries_load_from_the_build_directory():
    assert native.loaded() == {"esvo_native": True, "csvo_native": True}
    for name in ("esvo_native", "csvo_native"):
        path = native._lib_path(name)
        assert "/voxelrs_tpu_torch/_build/native/" in path
        assert path.endswith(f"lib{name}.so")


@pytest.mark.parametrize("lod", [1, 2, 3, 4, 5, 0])
def test_serializers_byte_for_byte(lod):
    """CSVO: the port's numpy and native serializers against the JAX one.
    ESVO: the port's native serializer against its numpy one and the JAX
    package's."""
    for name, vox in _cases().items():
        ref_nodes, ref_mats, ref_cut = jcsvo.serialize_dense_csvo(vox, lod)
        nodes, mats, cut = csvo.serialize_dense_csvo(vox, lod)
        n_nodes, n_mats, n_cut = native.serialize_csvo_native(vox, lod)
        assert cut == n_cut == ref_cut, (name, lod)
        if ref_nodes is None:
            assert nodes is None and n_nodes is None, (name, lod)
        else:
            for got, got_mats in ((nodes, mats), (n_nodes, n_mats)):
                np.testing.assert_array_equal(got, ref_nodes, err_msg=name)
                np.testing.assert_array_equal(
                    np.asarray(got_mats, np.uint32),
                    np.asarray(ref_mats, np.uint32), err_msg=name)

        ref_buf, ref_res = jesvo_dense.serialize_dense_chunk(vox, lod)
        buf, res = esvo_dense.serialize_dense_chunk(vox, lod)
        n_buf, meta = native.serialize_chunk_native(vox, lod)
        assert meta == (ref_res.child_mask, ref_res.leaf_mask, ref_res.depth)
        assert (res.child_mask, res.leaf_mask, res.depth) == meta
        np.testing.assert_array_equal(n_buf, ref_buf, err_msg=name)
        np.testing.assert_array_equal(buf, ref_buf, err_msg=name)
        sc = SerializedChunk.from_voxels(ChunkPos(0, 0, 0), vox, lod)
        assert sc.result == res
        if sc.has_data():
            np.testing.assert_array_equal(sc.buffer, ref_buf, err_msg=name)


def _chunk(rng, density):
    occ = rng.random((32, 32, 32)) < density
    return np.where(occ, rng.integers(1, 13, occ.shape), 0).astype(np.uint32)


def test_csvo_world_and_upload_match_jax():
    """``Csvo.write_to``/``write_changes_to`` and ``Svo.update`` (byte
    mirror, word upload, ladder growth, root pointer) against the JAX
    package through adds, a move, a remove and a growth, word for word."""
    rng = np.random.default_rng(5)
    jworld, tworld = jcsvo.Csvo(), csvo.Csvo()
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=8, buffer_dtype=np.uint8)
    tsvo = Svo(content.new_registry(), capacity_mb=8, buffer_dtype=np.uint8,
               device="cpu")
    leaves = {}

    def add(pos, vox, lod=5):
        jl, _ = jworld.set_leaf(JPosition(*pos), jcsvo.CsvoSerializedChunk
                                .from_voxels(JChunkPos(*pos), vox, lod), True)
        tl, _ = tworld.set_leaf(Position(*pos), csvo.CsvoSerializedChunk
                                .from_voxels(ChunkPos(*pos), vox, lod), True)
        leaves[pos] = (jl, tl)

    def check():
        jworld.serialize()
        tworld.serialize()
        assert tworld.depth() == jworld.depth()
        assert tworld.size_in_bytes() == jworld.size_in_bytes()
        a = np.zeros(jworld.size_in_bytes() + 4, np.uint8)
        b = np.zeros_like(a)
        assert tworld.write_to(b) == jworld.write_to(a)
        np.testing.assert_array_equal(b, a)
        a[:], b[:] = 0, 0
        assert tworld.write_changes_to(b, reset=False) == \
            jworld.write_changes_to(a, reset=False)
        np.testing.assert_array_equal(b, a)
        version = tsvo._buffer_version
        jsvo.update(jworld)
        tsvo.update(tworld)
        assert tsvo._buffer_version == version + 1
        assert (tsvo.root_ptr, tsvo.depth) == (jsvo.root_ptr, jsvo.depth)
        assert tsvo.octree_scale == jsvo.octree_scale
        np.testing.assert_array_equal(tsvo.device_buf.numpy().view(np.uint32),
                                      np.asarray(jsvo.device_buf))
        np.testing.assert_array_equal(tsvo.host_buf, jsvo.host_buf)
        js, ts = jsvo.get_stats(), tsvo.get_stats()
        assert (ts.used_bytes, ts.capacity_bytes, ts.depth) == (
            js.used_bytes, js.capacity_bytes, js.depth)
        return tsvo.device_buf.shape[0]

    for pos, d in (((0, 0, 0), 0.04), ((1, 0, 0), 0.04), ((0, 0, 1), 0.04)):
        add(pos, _chunk(rng, d))
    sizes = [check()]
    jl, tl = leaves.pop((1, 0, 0))
    leaves[(1, 0, 1)] = (jworld.move_leaf(jl, JPosition(1, 0, 1))[0],
                         tworld.move_leaf(tl, Position(1, 0, 1))[0])
    sizes.append(check())
    jl, tl = leaves.pop((0, 0, 0))
    jworld.remove_leaf(jl)
    tworld.remove_leaf(tl)
    sizes.append(check())
    for x in range(5):  # dense chunks: the device buffer grows
        add((x, 1, 0), _chunk(rng, 0.9))
    sizes.append(check())
    assert sizes[0] == sizes[1] == sizes[2] < sizes[3]


# ---------------------------------------------------------------------------
# Traversal: intersect_octree_csvo_plain against the JAX function
# ---------------------------------------------------------------------------


def _jax_world(chunks):
    """{(cx,cy,cz): voxels or (voxels, lod)} → a JAX Csvo world."""
    world = jcsvo.Csvo()
    for pos, vox in chunks.items():
        vox, lod = vox if isinstance(vox, tuple) else (vox, 5)
        world.set_leaf(JPosition(*pos), jcsvo.CsvoSerializedChunk.from_voxels(
            JChunkPos(*pos), vox, lod), True)
    world.serialize()
    return world


WORDS = 1 << 15  # every scene's word buffer: one JAX program per cast mode
RAYS = 512  # every batch is padded to this many rays, for the same reason


def build_csvo(chunks):
    """(JAX words, port CsvoBuffer on the CPU, octree_scale) of the same
    world: the stream after its prefix, zero-padded to WORDS words."""
    world = _jax_world(chunks)
    buf = np.zeros(4 + 4 * WORDS, np.uint8)
    assert world.size_in_bytes() + 8 <= len(buf)
    world.write_to(buf)
    words = buf[4:].view(np.uint32)
    root_ptr = int.from_bytes(bytes(buf[:4]), "little")
    tbuf = convert.csvo_buffer_from_jax(words, root_ptr, world.depth(),
                                        device="cpu")
    return words, tbuf, np.float32(2.0 ** -world.depth())


def rays(ro, rd):
    ro = np.atleast_2d(np.asarray(ro, np.float64))
    rd = np.atleast_2d(np.asarray(rd, np.float64))
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


_jit = {}


def trace_both(world, ro, rd, max_dst=-1.0, translucent=False, jalpha=None,
               talpha=None, max_steps=1000):
    """The same rays through both packages (JAX jitted on the CPU, one
    program per cast mode, alpha function and depth: the step budget is
    an argument of it, and the rays are padded to RAYS)."""
    words, tbuf, scale = world
    n = ro.shape[0]
    assert n <= RAYS
    pad = np.zeros((RAYS - n, 3), np.float32)
    ro = np.concatenate([ro, pad])
    rd = np.concatenate([rd, pad + [1.0, 0.0, 0.0]]).astype(np.float32)
    key = (translucent, jalpha, tbuf.total_depth)
    if key not in _jit:
        depth = tbuf.total_depth
        _jit[key] = jax.jit(lambda w, s, rp, o, d, m, n: jcsvo_trace(
            w, s, rp, depth, o, d, m, translucent, alpha_fn=jalpha,
            max_steps=n))
    md = np.zeros(RAYS, np.float32)
    md[:n] = max_dst
    j = _jit[key](jnp.asarray(words), scale, jnp.uint32(tbuf.root_ptr),
                  jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(md),
                  jnp.int32(max_steps))
    t = traversal_csvo.intersect_octree_csvo(
        tbuf.words, float(scale), tbuf.root_ptr, tbuf.total_depth,
        torch.from_numpy(ro[:n]), torch.from_numpy(rd[:n]),
        torch.from_numpy(md[:n]), translucent, alpha_fn=talpha,
        max_steps=max_steps)
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[:n], j), t


def assert_parity(j, t):
    jt = np.asarray(j.t)
    np.testing.assert_array_equal(t.t.numpy() == -1.0, jt == -1.0)
    np.testing.assert_array_equal(t.value.numpy(), np.asarray(j.value))
    np.testing.assert_array_equal(t.face_id.numpy(), np.asarray(j.face_id))
    np.testing.assert_array_equal(t.inside_voxel.numpy(),
                                  np.asarray(j.inside_voxel))
    np.testing.assert_allclose(t.t.numpy(), jt, rtol=0, atol=TOL_T)
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), rtol=0,
                               atol=TOL_T)
    np.testing.assert_allclose(t.uv.numpy(), np.asarray(j.uv), rtol=0,
                               atol=TOL_UV)
    np.testing.assert_allclose(t.lod.numpy(), np.asarray(j.lod), rtol=0,
                               atol=TOL_LOD)


def _j_clear7(value, face_id, uv, lod):
    return jnp.where(value == 7, 0.0, 1.0)


def _t_clear7(value, face_id, uv, lod):
    return torch.where(value == 7, 0.0, 1.0)


CASTS = {"opaque": (False, None, None), "clear7": (True, _j_clear7, _t_clear7)}


@pytest.fixture(scope="module")
def simple_world():
    """tests/test_traversal_csvo.py's voxels, and a second chunk at lod 4
    (the same depth as every scene of this file)."""
    vox = np.zeros((32, 32, 32), np.uint32)
    vox[5, 5, 5] = 1
    vox[10, 5, 5] = 2
    vox[5, 20, 5] = 3
    vox[31, 31, 31] = 5
    far = np.zeros((32, 32, 32), np.uint32)
    far[16:20, 0:4, 16:20] = 7
    return build_csvo({(0, 0, 0): vox, (1, 1, 1): (far, 4)})


AXIS_RAYS = [
    ([-10, 5.5, 5.5], [1, 0, 0]), ([40, 5.5, 5.5], [-1, 0, 0]),
    ([5.5, 50, 5.5], [0, -1, 0]), ([5.5, -10, 5.5], [0, 1, 0]),
    ([5.5, 5.5, -3], [0, 0, 1]), ([5.5, 5.5, 40], [0, 0, -1]),
    ([-10, 5.75, 5.25], [1, 0, 0]), ([5.25, 50, 5.75], [0, -1, 0]),
    ([5.5, 5.5, 5.5], [1, 0, 0]), ([-10, 2.5, 2.5], [1, 0, 0]),
    ([-5, -5, -5], [1, 1, 1]), ([50, 50.5, 50], [0, -1, 0.01]),
]


@pytest.mark.parametrize("cast", ["opaque", "clear7"])
def test_axis_rays_inside_and_max_dst(simple_world, cast):
    translucent, jalpha, talpha = CASTS[cast]
    ro, rd = rays(*zip(*AXIS_RAYS))
    j, t = trace_both(simple_world, ro, rd, translucent=translucent,
                      jalpha=jalpha, talpha=talpha)
    assert_parity(j, t)
    # the expectations of tests/test_traversal_csvo.py, on the port
    assert t.t[0].item() == pytest.approx(15.0, abs=1e-4)
    assert t.value[0].item() == 1 and t.face_id[0].item() == 0
    np.testing.assert_allclose(t.pos[0].numpy(), [5.0, 5.5, 5.5], atol=1e-4)
    assert [int(v) for v in t.face_id[:6]] == [0, 1, 3, 2, 4, 5]
    assert t.value[2].item() == 3 and t.t[2].item() == pytest.approx(29.0, abs=1e-4)
    assert bool(t.inside_voxel[8]) and t.value[8].item() == 2
    assert t.t[9].item() == -1.0
    # the lod-4 chunk: value 7 hides from the translucent cast
    assert (t.value[11].item() == 7) == (cast == "opaque")

    ro, rd = rays([[-10, 5.5, 5.5]] * 4 + [[5.5, 50, 5.5]] * 2,
                  [[1, 0, 0]] * 4 + [[0, -1, 0]] * 2)
    md = np.array([5.0, 14.9, 20.0, -1.0, 28.0, 30.0], np.float32)
    j, t = trace_both(simple_world, ro, rd, max_dst=md, translucent=translucent,
                      jalpha=jalpha, talpha=talpha)
    assert_parity(j, t)
    np.testing.assert_array_equal(t.t.numpy() == -1.0,
                                  [True, True, False, False, True, False])


def test_chunk_boundary_materials():
    """Crossing between chunks re-resolves the material section."""
    a = np.zeros((32, 32, 32), np.uint32)
    b = np.zeros((32, 32, 32), np.uint32)
    a[31, 5, 5] = 4
    b[0, 5, 5] = 9
    world = build_csvo({(0, 0, 0): a, (1, 0, 0): b})
    ro, rd = rays([[-5, 5.5, 5.5], [70, 5.5, 5.5], [31.5, 5.5, 5.5]],
                  [[1, 0, 0], [-1, 0, 0], [1, 0, 0]])
    for translucent, jalpha, talpha in CASTS.values():
        j, t = trace_both(world, ro, rd, translucent=translucent,
                          jalpha=jalpha, talpha=talpha)
        assert_parity(j, t)
        assert t.value.tolist() == [4, 9, 9]


@pytest.fixture(scope="module")
def random_world():
    rng = np.random.default_rng(11)
    vox = np.where(rng.random((32, 32, 32)) < 0.03,
                   rng.integers(1, 13, (32, 32, 32)), 0).astype(np.uint32)
    vox[rng.random((32, 32, 32)) < 0.01] = 7
    return vox, build_csvo({(0, 0, 0): vox, (1, 0, 0): (vox[::-1].copy(), 4)})


def _random_rays(seed, n=300):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-20, 84, (n, 3))
    return rays(ro, rng.uniform(4, 60, (n, 3)) - ro)


@pytest.mark.parametrize("cast,max_steps", [
    ("opaque", 1000), ("clear7", 1000), ("clear7", 5), ("clear7", 9),
    ("clear7", 13), ("clear7", 30)])
def test_random_rays_and_step_budgets(random_world, cast, max_steps):
    _, world = random_world
    translucent, jalpha, talpha = CASTS[cast]
    ro, rd = _random_rays(max_steps)
    j, t = trace_both(world, ro, rd, translucent=translucent, jalpha=jalpha,
                      talpha=talpha, max_steps=max_steps)
    assert_parity(j, t)
    assert int(t.steps.max()) <= traversal_csvo.step_budget(max_steps)
    if max_steps == 1000:
        assert 50 < int((t.t >= 0).sum()) < 300
        assert int(t.steps.max()) < 200  # every ray finished


def test_step_budget_rounds_to_the_classic_loops_unroll():
    assert [traversal_csvo.step_budget(n) for n in (1, 2, 5, 300, 1000)] == \
        [2, 2, 6, 300, 1000]


def test_matches_the_ports_esvo_traversal(random_world):
    """The same voxels through the port's ESVO traversal, rays from
    outside the voxels (tests/test_traversal_csvo.py)."""
    vox, (_, tbuf, scale) = random_world
    esvo = Esvo()
    esvo.set_leaf(Position(0, 0, 0),
                  SerializedChunk.from_voxels(ChunkPos(0, 0, 0), vox, 5), True)
    esvo.set_leaf(Position(1, 0, 0), SerializedChunk.from_voxels(
        ChunkPos(1, 0, 0), vox[::-1].copy(), 4), True)
    esvo.serialize()
    ebuf = np.zeros(esvo.size_in_u32() + PREAMBLE_LENGTH_IN_U32, np.uint32)
    esvo.write_to(ebuf)
    assert np.float32(2.0 ** -esvo.depth()) == scale
    rng = np.random.default_rng(12)
    ro = rng.uniform(-20, 84, (300, 3))
    ro[:, 1] = rng.choice([-20.0, 50.0], 300)  # outside the chunks
    ro, rd = rays(ro, rng.uniform(4, 60, (300, 3)) * [1.9, 0.9, 0.9] - ro)
    c = traversal_csvo.intersect_octree_csvo(
        tbuf.words, float(scale), tbuf.root_ptr, tbuf.total_depth,
        torch.from_numpy(ro), torch.from_numpy(rd), -1.0, False)
    e = intersect_octree_plain(torch.from_numpy(ebuf.view(np.int32)),
                               float(scale), torch.from_numpy(ro),
                               torch.from_numpy(rd), -1.0, False)
    assert int((c.t >= 0).sum()) > 100
    np.testing.assert_array_equal(c.value.numpy(), e.value.numpy())
    np.testing.assert_array_equal(c.face_id.numpy(), e.face_id.numpy())
    np.testing.assert_allclose(c.t.numpy(), e.t.numpy(), rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def textured_world():
    """A chunk of glass, leaves, water and stone (and a lod-4 copy), and
    both registries."""
    rng = np.random.default_rng(7)
    vox = np.zeros((32, 32, 32), np.uint32)
    vox[:, :6, :] = jcontent.STONE
    ids = np.array([jcontent.GLASS, jcontent.OAK_LEAVES, jcontent.WATER,
                    jcontent.GRASS], np.uint32)
    blobs = rng.random((32, 32, 32)) < 0.06
    vox[blobs] = ids[rng.integers(0, 4, int(blobs.sum()))]
    world = build_csvo({(0, 0, 0): vox, (1, 0, 0): (vox[::-1].copy(), 4)})
    jm, _, jt = jcontent.new_registry().build()
    tm, _, tt = content.new_registry().build(device="cpu")
    return world, (jm, jt), (tm, tt)


@pytest.mark.parametrize("exact", [False, True])
def test_textured_alpha_judge(textured_world, exact):
    world, (jm, jt), (tm, tt) = textured_world
    rng = np.random.default_rng(8)
    ro = rng.uniform(-10, 74, (400, 3))
    ro[:, 1] = rng.uniform(20, 45, 400)
    ro, rd = rays(ro, rng.uniform(0, 64, (400, 3)) * [1, 0.5, 1] - ro)
    jalpha = jmake_alpha_fn(jm, jt, exact=exact)
    talpha = shading.make_alpha_fn(tm, tt, exact=exact)
    j, t = trace_both(world, ro, rd, translucent=True, jalpha=jalpha,
                      talpha=talpha)
    assert_parity(j, t)
    _, tbuf, scale = world
    o = traversal_csvo.intersect_octree_csvo(
        tbuf.words, float(scale), tbuf.root_ptr, tbuf.total_depth,
        torch.from_numpy(ro), torch.from_numpy(rd), -1.0, False)
    assert int((o.value != t.value).sum()) > 10  # rays pass translucent texels


def test_words_outside_the_packing_raise():
    words = torch.zeros(8, dtype=torch.int32)
    traversal_csvo.check_words(words, 0, 11)
    for rp, depth in ((1 << 27, 11), (-1, 11), (0, 32)):
        with pytest.raises(ValueError):
            traversal_csvo.check_words(words, rp, depth)
    with pytest.raises(ValueError):
        traversal_csvo.check_words(words.to(torch.int64), 0, 11)
    with pytest.raises(ValueError):
        convert.csvo_buffer_from_jax(np.zeros(4, np.int64), 0, 6, device="cpu")


# ---------------------------------------------------------------------------
# Frame
# ---------------------------------------------------------------------------

W, H = 64, 48


@pytest.fixture(scope="module")
def frame_pair():
    """tests/test_csvo.py's render scene (and glass, and a lod-4 chunk) in
    the JAX and the port's CSVO Svo."""
    vox = np.zeros((32, 32, 32), np.uint32)
    vox[:, :8, :] = 3
    vox[:, 8, :] = 1
    vox[10:14, 9:12, 10:14] = 12
    vox[3:6, 9:12, 3:6] = jcontent.GLASS
    chunks = {(0, 0, 0): vox, (1, 0, 0): (vox[::-1].copy(), 4)}
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=4, buffer_dtype=np.uint8)
    jsvo.update(_jax_world(chunks))
    world = csvo.Csvo()
    for pos, v in chunks.items():
        v, lod = v if isinstance(v, tuple) else (v, 5)
        world.set_leaf(Position(*pos), csvo.CsvoSerializedChunk.from_voxels(
            ChunkPos(*pos), v, lod), True)
    world.serialize()
    tsvo = Svo(content.new_registry(), capacity_mb=4, buffer_dtype=np.uint8,
               device="cpu")
    tsvo.update(world)
    np.testing.assert_array_equal(tsvo.device_buf.numpy().view(np.uint32),
                                  np.asarray(jsvo.device_buf))
    return jsvo, tsvo


def _params(cls, **kw):
    fwd = np.array([0.5, -0.5, 0.7], np.float32)
    d = dict(cam_pos=np.array([2.0, 20.0, -4.0], np.float32),
             cam_fwd=fwd / np.linalg.norm(fwd), aspect_ratio=W / H,
             render_shadows=True, shadow_distance=100.0,
             selected_voxel=np.array([11.0, 10.0, 12.0], np.float32))
    d.update(kw)
    return cls(**d)


def assert_frames_close(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.mean() <= 1e-3, d.mean()
    assert (d.max(-1) > 1e-3).mean() <= 0.01


@pytest.mark.parametrize("max_steps", [40, 300, 1000])
def test_csvo_frame_matches_jax(frame_pair, max_steps):
    """The port's fused CSVO frame against the JAX ``Svo.render`` of a CSVO
    buffer (its ``mode="csvo"``). At 40 steps the shadow rays run out of
    the frame's budget, as they do in the JAX CSVO frame (the ESVO frame
    gives them 1000)."""
    jsvo, tsvo = frame_pair
    jimg = np.asarray(jsvo.render(_params(JRenderParams), W, H,
                                  max_steps=max_steps, mode="fused"))
    timg = tsvo.render(_params(RenderParams), W, H, max_steps=max_steps,
                       mode="fused")
    assert timg.shape == (H, W, 4) and bool(torch.isfinite(timg).all())
    assert_frames_close(timg.numpy(), jimg)
    if max_steps == 40:
        # the CSVO shadow budget: with the ESVO one the frame differs
        kw = tsvo.frame_kwargs(_params(RenderParams), W, H, max_steps)
        full = shading.render_frame_plain(
            tsvo.world(), tsvo.octree_scale, tsvo.mips, tsvo.mat_params,
            tsvo.mat_tex, **{**kw, "max_steps": 1000})
        assert np.abs(full.numpy() - timg.numpy()).max() > 0.05
    # the deferred frame (the default mode) over the CSVO buffer: its
    # judged branch, here the fused frame bit for bit at every budget
    dimg = tsvo.render(_params(RenderParams), W, H, max_steps=max_steps)
    np.testing.assert_array_equal(dimg.numpy(), timg.numpy())


# ---------------------------------------------------------------------------
# Picker
# ---------------------------------------------------------------------------


def test_csvo_judged_adaptive_frame_matches_jax(scenes, jax_frames,
                                                port_exact, monkeypatch):
    """The judged adaptive frame of a CSVO world (tests/test_torch_judged.py's
    translucent scene at 128x96, whose quarter grid is under 4,096 lanes:
    the half grid) against the JAX ``Svo.render`` with
    ``VOXELRS_ADAPTIVE=1`` (its second render; beams and the sun map)
    within the port's frame budget (measured: 0 pixels off) and within the
    thick-ray budget of the port's exact judged frame; then the port's
    plain judged trace of the half grid against the JAX CSVO deferred trace
    (measured: no lane disagrees)."""
    monkeypatch.setenv("VOXELRS_HIERARCHY", "1")
    monkeypatch.delenv("VOXELRS_HOLE_FILL", raising=False)
    tj.check_frame("csvo", "1", tj.SW, tj.SH, "overview", 1, scenes,
                   jax_frames, port_exact)
    tj.check_trace("csvo", "overview", scenes)


def tol(depth: int) -> float:
    return 1e-3 * 2.0 ** max(0, depth - 8)


@pytest.fixture(scope="module")
def terrain():
    """The procedural world at radius 2 as CSVO, in both Svos, and its
    height map."""
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
    jsvo = JSvo(jcontent.new_registry(), capacity_mb=16, buffer_dtype=np.uint8)
    jsvo.update(_jax_world(chunks))
    tsvo = Svo(content.new_registry(), capacity_mb=16, buffer_dtype=np.uint8,
               device="cpu")
    buf = convert.csvo_buffer_from_jax(np.asarray(jsvo.device_buf),
                                       jsvo.root_ptr, jsvo.depth, device="cpu")
    tsvo.device_buf, tsvo.root_ptr, tsvo.depth = buf
    tsvo.octree_scale = jsvo.octree_scale
    heights = np.full((128, 128), -1)
    for (cx, cy, cz), vox in chunks.items():
        solid = vox != 0
        top = np.where(solid.any(1), 31 - np.argmax(solid[:, ::-1, :], 1), -1)
        top = np.where(top >= 0, top + cy * 32, -1)
        sl = heights[cx * 32:cx * 32 + 32, cz * 32:cz * 32 + 32]
        np.maximum(sl, top, out=sl)
    return jsvo, tsvo, heights


def _padded(tasks):
    n = len(tasks)
    padded = np.zeros((1 << max(3, (n - 1).bit_length()), 7), np.float32)
    padded[:n] = tasks
    padded[n:, 4] = 1.0
    return padded


def assert_picker_parity(jsvo, tsvo, tasks):
    """The port's plain K5 on the CSVO world against the JAX
    ``_raycast_fn``'s CSVO branch on one batch."""
    padded = _padded(tasks)
    n = len(tasks)
    dst, inside, pos, normal = (np.asarray(a)[:n] for a in jsvo._raycast_fn(
        len(padded))(jsvo.device_buf, jnp.float32(jsvo.octree_scale),
                     jnp.uint32(jsvo.root_ptr), jnp.asarray(padded)))
    rows = raycast_plain(tsvo.world(), tsvo.octree_scale,
                         torch.from_numpy(padded))[:n].numpy()
    atol = tol(jsvo.depth)
    np.testing.assert_array_equal(rows[:, 0] == -1.0, dst == -1.0)
    np.testing.assert_allclose(rows[:, 0], dst, rtol=0, atol=atol)
    np.testing.assert_array_equal(rows[:, 1] != 0, inside)
    np.testing.assert_allclose(rows[:, 2:5], pos, rtol=0, atol=atol)
    np.testing.assert_array_equal(rows[:, 5:8], normal)
    return rows


def test_picker_look_rays_and_sweeps(terrain):
    """Look rays from above the terrain in every direction, and the AABB
    sweeps the JAX physics casts for a player falling onto it, through
    both pickers; then ``Svo.raycast`` on both."""
    jsvo, tsvo, heights = terrain
    rng = np.random.default_rng(30)
    xz = rng.integers(8, 120, (96, 2))
    o = np.stack([xz[:, 0], heights[xz[:, 0], xz[:, 1]] + 2.0, xz[:, 1]], 1)
    o = o + rng.uniform(-3, 3, (96, 3))
    d = rng.normal(size=(96, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    look = np.concatenate([np.full((96, 1), 30.0), o, d], 1).astype(np.float32)
    # batches of 32, the size of the sweeps: one JAX program for all
    rows = np.concatenate([assert_picker_parity(jsvo, tsvo, look[i:i + 32])
                           for i in range(0, 96, 32)])
    assert 0.1 < (rows[:, 0] > 0).mean() < 0.95

    class Recorder:
        def __init__(self):
            self.batches = []

        def raycast(self, batch, result):
            self.batches.append(batch.serialize_tasks())
            jsvo.raycast(batch, result)

    x, z = 36.3, 52.6
    e = jphysics.Entity(
        position=np.array([x, heights[int(x), int(z)] + 6.0, z], np.float32),
        aabb_def=jphysics.AABBDef(np.array([-0.4, -1.7, -0.4], np.float32),
                                  np.array([0.8, 1.8, 0.8], np.float32)))
    rec, p = Recorder(), jphysics.Physics()
    for _ in range(120):
        p.step(1 / 250, rec, e)
    assert e.state.is_grounded
    hits = 0
    for tasks in {b.tobytes(): b for b in rec.batches}.values():
        hits += int((assert_picker_parity(jsvo, tsvo, tasks)[:, 0] > 0).sum())
    assert hits > 0

    results = []
    for mod, svo in ((jpicker, jsvo), (picker, tsvo)):
        batch, res = mod.PickerBatch(), mod.PickerBatchResult()
        batch.add_ray(np.array([60.5, heights[60, 60] + 10.0, 60.5], np.float32),
                      np.array([0.0, -1.0, 0.0], np.float32), 30.0)
        batch.add_aabb(mod.Aabb.new([x, heights[int(x), int(z)] + 2.7, z],
                                    [-0.4, -1.7, -0.4], [0.8, 1.8, 0.8]))
        svo.raycast(batch, res)
        results.append(res)
    jr, tr = results[0].rays[0], results[1].rays[0]
    assert tr.did_hit() and jr.did_hit()
    assert abs(tr.dst - jr.dst) <= tol(jsvo.depth)
    np.testing.assert_array_equal(tr.normal, jr.normal)
    ja, ta = results[0].aabbs[0], results[1].aabbs[0]
    np.testing.assert_allclose(ta.neg, ja.neg, rtol=0, atol=tol(jsvo.depth))
    np.testing.assert_allclose(ta.pos, ja.pos, rtol=0, atol=tol(jsvo.depth))


# ---------------------------------------------------------------------------
# Crosshair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 64), (97, 130)])
def test_crosshair_overlay_matches_jax(shape):
    """Equal, bit for bit, to the JAX overlay run op by op (the ring divides
    by the thickness with ``fdiv``, as XLA divides); within 1.2e-7 (one
    float32 ulp at 1.0, the top of the pixel range) of the jitted one, where
    XLA on the CPU fuses the blend ``image * (1 - alpha) + alpha`` into a
    multiply-add (measured: 1.2e-7 on about 1% of the values)."""
    rng = np.random.default_rng(shape[0])
    img = rng.random((*shape, 4)).astype(np.float32)
    t = shading.crosshair_overlay(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(t, np.asarray(jcrosshair(jnp.asarray(img))))
    j = np.asarray(jax.jit(jcrosshair)(jnp.asarray(img)))
    np.testing.assert_allclose(t, j, rtol=0, atol=1.2e-7)
    assert (t != img).any()
