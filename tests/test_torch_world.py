"""voxelrs_tpu_torch host side against voxelrs_tpu: the ESVO buffer word for
word, worldgen, LOD banding, registry tables, camera basis, the bit
primitives, the JAX→torch state carry, device resolution, and the rule that
the port imports neither JAX nor the JAX package.

Tolerances: everything here is exact (integer words, bit patterns, or the
same float ops in the same order on the host)."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrs_tpu.gamelogic import content as jcontent
from voxelrs_tpu.gamelogic.worldgen import Generator as JGenerator
from voxelrs_tpu.gamelogic.worldgen import default_config as jdefault_config
from voxelrs_tpu.graphics.camera import Camera as JCamera
from voxelrs_tpu.ops import bits as jbits
from voxelrs_tpu.systems.chunkloader import ChunkLoader as JChunkLoader
from voxelrs_tpu.world import ChunkPos as JChunkPos
from voxelrs_tpu.world import Position as JPosition
from voxelrs_tpu.world.chunk import Chunk as JChunk
from voxelrs_tpu.world.esvo import PREAMBLE_LENGTH_IN_U32
from voxelrs_tpu.world.esvo import Esvo as JEsvo
from voxelrs_tpu.world.esvo import SerializedChunk as JSerializedChunk
from voxelrs_tpu_torch import convert, device
from voxelrs_tpu_torch.gamelogic import content
from voxelrs_tpu_torch.gamelogic.worldgen import Generator, default_config
from voxelrs_tpu_torch.graphics.camera import Camera
from voxelrs_tpu_torch.ops import bits
from voxelrs_tpu_torch.systems.chunkloader import ChunkLoader
from voxelrs_tpu_torch.world import ChunkPos, Position
from voxelrs_tpu_torch.world.chunk import Chunk
from voxelrs_tpu_torch.world.esvo import Esvo, SerializedChunk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _buffer(esvo):
    n = esvo.size_in_u32() + PREAMBLE_LENGTH_IN_U32
    buf = np.zeros(n, np.uint32)
    assert esvo.write_to(buf) == n
    return buf


def _procedural_pair(radius):
    """The bench.py procedural world at ``radius``, built by both packages."""
    out = []
    for G, cfg, Ch, CP, Pos, E, SC, CL in (
            (JGenerator, jdefault_config, JChunk, JChunkPos, JPosition, JEsvo,
             JSerializedChunk, JChunkLoader),
            (Generator, default_config, Chunk, ChunkPos, Position, Esvo,
             SerializedChunk, ChunkLoader)):
        gen = G(1, cfg())
        svo = E()
        center = CP(radius, 2, radius)
        for cx in range(radius * 2):
            for cz in range(radius * 2):
                col = gen.get_column(cx, cz)
                lod = CL.calculate_lod(center, CP(cx, 0, cz))
                for cy in range(8):
                    if not col.contains_chunk(cy):
                        continue
                    chunk = Ch(CP(cx, cy, cz))
                    gen.generate_chunk(chunk)
                    sc = SC.from_voxels(chunk.pos, chunk.voxels, lod)
                    if sc.has_data():
                        svo.set_leaf(Pos(cx, cy, cz), sc, True)
        svo.serialize()
        out.append(svo)
    return out


@pytest.mark.parametrize("radius", [1, 2])
def test_procedural_world_buffer_word_for_word(radius):
    jsvo, tsvo = _procedural_pair(radius)
    assert tsvo.depth() == jsvo.depth()
    np.testing.assert_array_equal(_buffer(tsvo), _buffer(jsvo))


@pytest.mark.parametrize("lod", [5, 3, 1])
def test_random_chunks_buffer_word_for_word(lod):
    rng = np.random.default_rng(lod)
    chunks = {}
    for key, density in (((0, 0, 0), 0.05), ((1, 0, 0), 0.5),
                         ((0, 1, 2), 0.001)):
        occ = rng.random((32, 32, 32)) < density
        chunks[key] = np.where(occ, rng.integers(1, 13, occ.shape), 0
                               ).astype(np.uint32)
    pair = []
    for E, SC, CP, Pos in ((JEsvo, JSerializedChunk, JChunkPos, JPosition),
                           (Esvo, SerializedChunk, ChunkPos, Position)):
        svo = E()
        for (x, y, z), vox in chunks.items():
            svo.set_leaf(Pos(x, y, z), SC.from_voxels(CP(x, y, z), vox, lod),
                         True)
        svo.serialize()
        pair.append(svo)
    np.testing.assert_array_equal(_buffer(pair[1]), _buffer(pair[0]))


def test_worldgen_columns_and_chunks_match():
    jg, tg = JGenerator(1, jdefault_config()), Generator(1, default_config())
    for cx, cz in [(0, 0), (3, -2), (-5, 7)]:
        np.testing.assert_array_equal(tg.get_column(cx, cz).height_map,
                                      jg.get_column(cx, cz).height_map)
        jc, tc = JChunk(JChunkPos(cx, 2, cz)), Chunk(ChunkPos(cx, 2, cz))
        jg.generate_chunk(jc)
        tg.generate_chunk(tc)
        np.testing.assert_array_equal(tc.voxels, jc.voxels)


def test_calculate_lod_bands_match():
    center_j, center_t = JChunkPos(4, 2, 4), ChunkPos(4, 2, 4)
    for x in range(-30, 31, 3):
        for z in range(-30, 31, 5):
            assert (ChunkLoader.calculate_lod(center_t, ChunkPos(x, 0, z))
                    == JChunkLoader.calculate_lod(center_j, JChunkPos(x, 0, z)))


def test_registry_tables_match():
    jm, jp, jt = jcontent.new_registry().build()
    tm, tp, tt = content.new_registry().build(device="cpu")
    assert len(tm) == len(jm) == 5
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt.shape[1] == 9  # the paired-atlas pair ids ride columns 6:9


def test_camera_basis_matches():
    rng = np.random.default_rng(3)
    for _ in range(20):
        fwd = rng.normal(size=3).astype(np.float32)
        jc, tc = JCamera(70, 1.5, 0.01, 1024), Camera(70, 1.5, 0.01, 1024)
        jc.forward = tc.forward = fwd
        for a, b in zip(tc.camera_basis(), jc.camera_basis()):
            np.testing.assert_array_equal(a, b)


def _edge_floats(rng, n=4096):
    special = np.array([0.0, -0.0, 1.0, -1.0, 1.5, 2.0 ** -23, -(2.0 ** -23),
                        2.0 ** -24, -(2.0 ** -30), 1e-38, -1e-45, 3e38,
                        1.9999999, 1.0000001], np.float32)
    rand = (rng.normal(size=n) * 10.0 ** rng.integers(-30, 5, n))
    return np.concatenate([special, rand.astype(np.float32)])


def test_bits_exact():
    rng = np.random.default_rng(0)
    x = _edge_floats(rng)
    u = np.concatenate([np.array([0, 1, 2, 3, 0x7FFFFFFF, 0x80000000,
                                  0xFFFFFFFF], np.uint32),
                        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
                        .astype(np.uint32)])
    tx, tu = torch.from_numpy(x), torch.from_numpy(u.astype(np.int64))
    np.testing.assert_array_equal(bits.f32_bits(tx).numpy(),
                                  np.asarray(jbits.f32_bits(jnp.asarray(x))))
    np.testing.assert_array_equal(
        bits.bits_f32(tu).numpy().view(np.uint32),
        np.asarray(jbits.bits_f32(jnp.asarray(u))).view(np.uint32))
    np.testing.assert_array_equal(bits.find_msb(tu).numpy(),
                                  np.asarray(jbits.find_msb(jnp.asarray(u))))
    np.testing.assert_array_equal(
        bits.copysign_epsilon(tx).numpy().view(np.uint32),
        np.asarray(jbits.copysign_epsilon(jnp.asarray(x))).view(np.uint32))
    scale = rng.integers(0, 24, x.shape[0])
    pos = np.abs(x) % 2.0 + 1.0
    fl, sh = bits.floor_to_scale(torch.from_numpy(pos), torch.from_numpy(scale))
    jfl, jsh = jbits.floor_to_scale(jnp.asarray(pos), jnp.asarray(scale))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(jfl))
    np.testing.assert_array_equal(sh.numpy(), np.asarray(jsh))
    # exp2i against the exact power of two: XLA's CPU exp2 is an
    # approximation (off by ~1e-6 relative below 2^-30), torch.exp2 is exact
    s = np.arange(-20, 24)
    np.testing.assert_array_equal(bits.exp2i(torch.from_numpy(s)).numpy(),
                                  np.ldexp(np.float32(1), s - 23))
    np.testing.assert_allclose(bits.exp2i(torch.from_numpy(s)).numpy(),
                               np.asarray(jbits.exp2i(jnp.asarray(s))),
                               rtol=2e-6)
    # smoothstep: exact against the separate float32 operations; XLA on
    # the CPU contracts 3 - 2t into an FMA, so JAX agrees to 2 ulp of 1
    d = np.linspace(0.0, 40.0, 1001, dtype=np.float32)
    got = bits.smoothstep(15.0, 25.0, torch.from_numpy(d)).numpy()
    t = np.clip((d - np.float32(15)) / np.float32(10), 0, 1).astype(np.float32)
    np.testing.assert_array_equal(got, t * t * (np.float32(3) - np.float32(2) * t))
    np.testing.assert_allclose(
        got, np.asarray(jax.jit(lambda v: jbits.smoothstep(15.0, 25.0, v))(d)),
        rtol=0, atol=2.5e-7)


def test_svo_state_from_jax_round_trip():
    jm, jp, jt = jcontent.new_registry().build()
    jsvo, _ = _procedural_pair(1)
    desc = _buffer(jsvo)
    state = convert.svo_state_from_jax(
        desc, np.float32(2.0 ** -jsvo.depth()), [np.asarray(m) for m in jm],
        np.asarray(jp), np.asarray(jt), device="cpu")
    assert state.descriptors.dtype == torch.int32
    np.testing.assert_array_equal(state.descriptors.numpy().view(np.uint32),
                                  desc)
    assert state.octree_scale == 2.0 ** -jsvo.depth()
    for a, b in zip(state.mips, jm):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(state.mat_params.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(state.mat_tex.numpy(), np.asarray(jt))
    with pytest.raises(ValueError):
        convert.svo_state_from_jax(desc.astype(np.int64), 1.0, jm, jp, jt,
                                   device="cpu")


def test_resolve_device():
    assert device.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device.resolve_device(None)
        with pytest.raises(RuntimeError):
            content.new_registry().build()  # default device is the card


def _port_sources():
    root = os.path.join(REPO, "voxelrs_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    seen = set()
    for path in _port_sources():
        seen.add(os.path.relpath(path, REPO))
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "voxelrs_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert len(seen) > 30
    for module in ("world/world.py", "systems/jobs.py", "systems/worldgen.py",
                   "systems/storage.py", "systems/chunkloader.py",
                   "systems/physics.py", "systems/worldsvo.py",
                   "graphics/picker.py", "ops/picker.py",
                   "gamelogic/benchmark.py", "gamelogic/gameplay.py",
                   "gamelogic/world.py", "gamelogic/game.py",
                   "native/__init__.py", "world/common.py", "world/csvo.py",
                   "ops/traversal_csvo.py", "convert.py",
                   "world/heightfield.py", "ops/beams.py", "ops/compact.py",
                   "bench.py", "ops/adaptive.py", "ops/adaptive_judged.py",
                   "probes/__init__.py", "probes/gather_probe.py"):
        assert f"voxelrs_tpu_torch/{module}" in seen, module
    assert not bad, bad
