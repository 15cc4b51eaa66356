"""voxelrs_tpu_torch's beam pre-pass against voxelrs_tpu's: the terrain
envelope (``world/heightfield.py``), the floors and certificates of K7 and
K8 (``ops/beams.py``) and the compaction of K6 (``ops/compact.py``), each
in its plain version on the CPU.

Inputs are made with numpy from seeds and handed to both packages; the
JAX tables reach the port's functions through ``convert.beam_state_from_jax``.

Tolerances. Envelope maps, pyramids, bounds and sun-map rows: exact (host
numpy on both sides). Compaction: exact. Floors: the +inf / 0 pattern
exact, finite floors within 2e-4 relative (XLA on the CPU contracts the
ray arithmetic into multiply-adds, which round once where the port rounds
twice, and the tile cones take tan(fov/2) from jnp.tan here and from
torch there; measured <= 8.4e-5 relative). Sun verdicts (lit, blocked):
exact at the JAX function's footprint (margin 0); with the deferred
frame's footprint margin the port's lit claims are a subset of the JAX
package's and its blocked claims a superset.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrs_tpu.gamelogic.content import GLASS, GRASS, STONE
from voxelrs_tpu.ops import beams as jbeams
from voxelrs_tpu.ops.shading import compact_indices as jcompact
from voxelrs_tpu.world import heightfield as jhf
from voxelrs_tpu_torch import convert
from voxelrs_tpu_torch.gamelogic.content import new_registry
from voxelrs_tpu_torch.graphics.camera import Camera
from voxelrs_tpu_torch.graphics.svo import Svo
from voxelrs_tpu_torch.ops import beams
from voxelrs_tpu_torch.ops.compact import compact_indices, compact_indices_plain
from voxelrs_tpu_torch.ops.shading import tan_half_fov
from voxelrs_tpu_torch.world import heightfield as thf

W, H = 128, 96
FLOOR_RTOL = 2e-4

# the cameras of tests/test_beams.py
CAMS = {
    "horizon": ([48.0, 30.0, -20.0], [0.0, -0.12, 1.0]),
    "down": ([48.0, 70.0, 48.0], [0.01, -1.0, 0.01]),
    "on-ground": ([40.0, 13.0, 40.0], [0.7, 0.05, 0.7]),
    "sky": ([48.0, 25.0, 48.0], [0.2, 0.95, 0.1]),
    "outside": ([-40.0, 50.0, -40.0], [0.6, -0.25, 0.6]),
    "underground": ([49.0, 4.0, 49.0], [0.8, 0.1, 0.5]),
    "grazing": ([48.0, 22.5, -10.0], [0.0, -0.004, 1.0]),
}
LIGHTS = ([-1.0, -1.0, -1.0], [0.3, -0.8, 0.52], [-0.9, -0.5, 0.1])


def _opaque_lut():
    return jhf.opaque_lut_from_mask(
        Svo(new_registry(), capacity_mb=1, device="cpu").translucent_block_mask)


def _terrain_chunk(cx, cz, glass_tower=False):
    """tests/test_beams.py's terrain chunk."""
    vox = np.zeros((32, 32, 32), np.uint32)
    x = np.arange(32) + cx * 32
    z = np.arange(32) + cz * 32
    hh = (10 + 6 * np.sin(x[:, None] * 0.11)
          + 5 * np.cos(z[None, :] * 0.17)).astype(np.int32)
    for ix in range(32):
        for iz in range(32):
            h = max(1, hh[ix, iz])
            vox[ix, : h - 1, iz] = STONE
            vox[ix, h - 1, iz] = GRASS
    if glass_tower:
        vox[12:15, 14:26, 12:15] = GLASS
    return vox


def _hills(rng, lut):
    """Two chunk layers of hills with glass columns and caves (the sun
    certificate scene of tests/test_beams.py): {pos: (voxels, tops...)}."""
    out = {}
    ph = rng.uniform(0, 6.28, size=2)
    for cx in range(2):
        for cz in range(2):
            x = np.arange(32) + cx * 32
            z = np.arange(32) + cz * 32
            hh = (30 + 20 * np.sin(x[:, None] * 0.14 + ph[0])
                  + 16 * np.cos(z[None, :] * 0.11 + ph[1])
                  + rng.integers(-1, 2, size=(32, 32))).astype(int)
            hh = np.clip(hh, 2, 62)
            glass_col = rng.random((32, 32)) < 0.05
            for cy in range(2):
                ys = np.arange(32) + cy * 32
                fill = ys[None, :, None] < hh[:, None, :]
                vox = np.where(fill, STONE, 0).astype(np.uint32)
                vox = np.where(glass_col[:, None, :] & fill, GLASS, vox)
                vox[rng.random((32, 32, 32)) < (0.004 * cy)] = 0
                out[(cx, cy, cz)] = vox
    return out


def _fields(chunks, lut, window=None):
    """The same envelope in both packages: (JAX field, port field)."""
    pair = (jhf.HeightField(), thf.HeightField())
    for hf in pair:
        if window is not None:
            hf.SUN_WINDOW = window
        for pos, vox in chunks.items():
            hf.set_chunk(pos, jhf.chunk_column_tops(vox, 5),
                         vtops=jhf.chunk_voxel_tops(vox, 5),
                         sbase=jhf.chunk_solid_bases(vox, 5, lut))
    return pair


@pytest.fixture(scope="module")
def lut():
    return _opaque_lut()


@pytest.fixture(scope="module")
def terrain(lut):
    """tests/test_beams.py's beam scene: 3x3 chunks, a glass tower and a
    floating block."""
    chunks = {}
    for cx in range(3):
        for cz in range(3):
            vox = _terrain_chunk(cx, cz, glass_tower=(cx == cz == 1))
            if cx == 2 and cz == 0:
                vox[5, 30, 5] = STONE
            chunks[(cx, 0, cz)] = vox
    return _fields(chunks, lut)


@pytest.fixture(scope="module")
def hills(lut):
    return _hills(np.random.default_rng(11), lut)


# -- the envelope -------------------------------------------------------------


@pytest.mark.parametrize("lod", [0, 1, 2, 3, 4, 5])
def test_chunk_maps_match(lod, lut):
    rng = np.random.default_rng(lod)
    vox = np.where(rng.random((32, 32, 32)) < 0.3, STONE, 0).astype(np.uint32)
    vox[rng.random((32, 32, 32)) < 0.05] = GLASS
    for jf, tf in ((jhf.chunk_column_tops, thf.chunk_column_tops),
                   (jhf.chunk_voxel_tops, thf.chunk_voxel_tops)):
        np.testing.assert_array_equal(tf(vox, lod), jf(vox, lod))
    np.testing.assert_array_equal(thf.chunk_solid_bases(vox, lod, lut),
                                  jhf.chunk_solid_bases(vox, lod, lut))
    np.testing.assert_array_equal(
        thf.opaque_lut_from_mask(0x1234 | 1 << 63), jhf.opaque_lut_from_mask(
            0x1234 | 1 << 63))


def _assert_device_equal(jdev, tdev):
    lv_d, offsets, n, hmax, bounds, lv_e = tdev
    np.testing.assert_array_equal(lv_d.numpy(), np.asarray(jdev[0]))
    assert offsets == jdev[1] and n == jdev[2] and hmax == jdev[3]
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(jdev[4]))
    np.testing.assert_array_equal(lv_e.numpy(), np.asarray(jdev[5]))


def test_heightfield_maintenance_matches(lut):
    chunks = {(cx, 0, cz): _terrain_chunk(cx, cz, glass_tower=cx == cz == 1)
              for cx in range(3) for cz in range(3)}
    jh, th = _fields(chunks, lut)
    np.testing.assert_array_equal(th.exact(), jh.exact())
    _assert_device_equal(jh.device(), th.device("cpu"))
    for c in ((0, 0), (5, 7), (11, 11), (-1, 3)):
        np.testing.assert_array_equal(th.near_window(*c), jh.near_window(*c))
    # removal, stacking, a stale removal and a rebuild, on both sides
    extra = np.full((4, 4), 9, np.int16)
    for hf in (jh, th):
        hf.set_chunk((1, 1, 1), extra)
        hf.remove_chunk((0, 0, 0))
        hf.remove_chunk((1, 1, 1), expect=np.full((4, 4), 9, np.int16))
    np.testing.assert_array_equal(th.exact(), jh.exact())
    _assert_device_equal(jh.device(), th.device("cpu"))


@pytest.mark.parametrize("light", range(len(LIGHTS)))
def test_sun_map_rows_match(hills, lut, light):
    jh, th = _fields(hills, lut)
    ld = np.asarray(LIGHTS[light], np.float32)
    ld /= np.linalg.norm(ld)
    js, ts = jh.sun_map(ld), th.sun_map(ld, device="cpu")
    assert js is not None and ts is not None
    np.testing.assert_array_equal(ts[0].numpy().view(np.uint16),
                                  np.asarray(js[0]))
    assert ts[1] == js[1]
    assert ts[2] == np.float32(js[2])
    np.testing.assert_array_equal(ts[3], np.asarray(js[3]))
    np.testing.assert_array_equal(ts[4], np.asarray(js[4]))


def test_windowed_sun_map_rows_match(lut):
    rng = np.random.default_rng(23)
    chunks = {}
    for cx in range(4):
        for cz in range(4):
            chunks[(cx, 0, cz)] = _terrain_chunk(cx, cz)
    jh, th = _fields(chunks, lut, window=64)
    ld = np.array([-1.0, -1.0, -1.0], np.float32) / np.sqrt(3)
    center = np.array([70.0, 30.0, 40.0 + rng.uniform()], np.float32)
    js = jh.sun_map(ld, center=center)
    ts = th.sun_map(ld, center=center, device="cpu")
    assert js[1] == ts[1] == 64
    np.testing.assert_array_equal(ts[0].numpy().view(np.uint16),
                                  np.asarray(js[0]))
    np.testing.assert_array_equal(ts[4], np.asarray(js[4]))


# -- floors and certificates ---------------------------------------------------


def _assert_floors_close(t, j):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    np.testing.assert_array_equal(t == 0, j == 0)
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], rtol=FLOOR_RTOL, atol=1e-5)


def _camera(name):
    pos, fwd = CAMS[name]
    cam = Camera(70.0, W / H, 0.01, 1024)
    cam.position = np.asarray(pos, np.float32)
    f = np.asarray(fwd, np.float32)
    cam.forward = f / np.linalg.norm(f)
    return cam


def _tile_floors_both(terrain, name, max_iters=beams.TILE_ITERS):
    """The port's and the JAX tile floors of camera ``name`` at W x H, the
    march's budget ``max_iters`` a tile."""
    jh, _th = terrain
    jdev = jh.device()
    tdev, _ = convert.beam_state_from_jax(
        tuple(np.asarray(a) if hasattr(a, "shape") else a for a in jdev),
        device="cpu")
    cam = _camera(name)
    s, u, f = cam.camera_basis()
    ccx = int(np.floor(cam.position[0] / 8)) - 2
    ccz = int(np.floor(cam.position[2] / 8)) - 2
    near = jh.near_window(ccx + 2, ccz + 2).astype(np.float32)
    base = np.array([ccx, ccz], np.float32)
    fov = np.float32(np.radians(70.0))
    jtf = jbeams.tile_floors(
        jdev[0], offsets=jdev[1], n=jdev[2], hmax=jnp.float32(jdev[3]),
        bounds=jnp.asarray(jdev[4]), near_h=jnp.asarray(near),
        near_base=jnp.asarray(base), cam_pos=jnp.asarray(cam.position),
        cam_right=jnp.asarray(s), cam_up=jnp.asarray(u),
        cam_fwd=jnp.asarray(f), fov_y_rad=jnp.float32(fov),
        aspect=jnp.float32(W / H), max_dst=jnp.float32(-1.0), width=W,
        height=H, max_iters=max_iters)
    ttf = beams.tile_floors(tdev[0], tdev[1], tdev[2], tdev[3], tdev[4],
                            near, base, cam.position, s, u, f,
                            tan_half_fov(fov), W / H, -1.0, width=W, height=H,
                            max_iters=max_iters)
    return ttf, jtf


@pytest.mark.parametrize("name", sorted(CAMS))
def test_tile_and_pixel_floors_match_jax(terrain, name):
    ttf, jtf = _tile_floors_both(terrain, name)
    assert tuple(ttf.shape) == (12, 16)
    _assert_floors_close(ttf.numpy(), jtf)
    # the pixel broadcast, and the tile read the deferred kernel makes
    tpf = beams.pixel_floors(ttf, width=W, height=H)
    np.testing.assert_array_equal(
        tpf.numpy(), np.asarray(jbeams.pixel_floors(jnp.asarray(ttf.numpy()),
                                                    width=W, height=H)))
    py, px = np.divmod(np.arange(W * H), W)
    np.testing.assert_array_equal(tpf.numpy(), ttf.numpy()[py // 8, px // 8])


@pytest.mark.parametrize("max_iters", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("name", sorted(CAMS))
def test_tile_floors_budget_matches_jax(terrain, name, max_iters):
    """``tile_floors_plain`` at march budgets that end mid-march (and,
    from the top level, mid-descent) against the JAX ``tile_floors`` at
    the same ``max_iters``: a floor is the march's t where the budget
    runs out."""
    ttf, jtf = _tile_floors_both(terrain, name, max_iters)
    _assert_floors_close(ttf.numpy(), jtf)


def _shadow_origins(rng, chunks, n=3000):
    """Shadow-ray-like origins: points just above the surface (a 1e-3
    normal push off the top face) and air points."""
    occ = np.zeros((96, 64, 96), bool)
    for (cx, cy, cz), vox in chunks.items():
        if cx < 3 and cz < 3 and cy < 2:
            occ[cx * 32:cx * 32 + 32, cy * 32:cy * 32 + 32,
                cz * 32:cz * 32 + 32] = vox != 0
    span = max(cx for cx, _, _ in chunks) * 32 + 32
    px = rng.uniform(0, span, size=n).astype(np.float32)
    pz = rng.uniform(0, span, size=n).astype(np.float32)
    col = occ[px.astype(int), :, pz.astype(int)]
    top = np.where(col.any(1), 64 - np.argmax(col[:, ::-1], axis=1), 0)
    lift = np.where(rng.random(n) < 0.5, 0.001,
                    rng.uniform(0.001, 20.0, size=n))
    py = (top + lift).astype(np.float32)
    return np.stack([px, py, pz], axis=1).astype(np.float32)


@pytest.mark.parametrize("light", range(len(LIGHTS)))
def test_shadow_ray_floors_match_jax(terrain, light):
    jh, _th = terrain
    jdev = jh.device()
    tdev, _ = convert.beam_state_from_jax(
        tuple(np.asarray(a) if hasattr(a, "shape") else a for a in jdev),
        device="cpu")
    rng = np.random.default_rng(light)
    chunks = {(cx, 0, cz): _terrain_chunk(cx, cz) for cx in range(3)
              for cz in range(3)}
    ro = _shadow_origins(rng, chunks)
    ld = np.asarray(LIGHTS[light], np.float32)
    to_light = -ld / np.linalg.norm(ld)
    md = np.where(rng.random(len(ro)) < 0.7, -1.0,
                  rng.uniform(0, 60, size=len(ro))).astype(np.float32)
    jf = jbeams.shadow_ray_floors(
        jdev[5], jdev[0][: jdev[2] ** 2], offsets=jdev[1], n=jdev[2],
        hmax=jnp.float32(jdev[3]), bounds=jnp.asarray(jdev[4]),
        ro=jnp.asarray(ro), light_to=jnp.asarray(to_light),
        max_dst=jnp.asarray(md))
    lv_d, offsets, n = tdev[0], tdev[1], tdev[2]
    tf = beams.shadow_ray_floors(tdev[5], lv_d[: n * n], offsets, n, tdev[3],
                                 tdev[4], torch.from_numpy(ro), to_light,
                                 torch.from_numpy(md))
    assert np.isinf(np.asarray(jf)).mean() > 0.05  # the march claims
    _assert_floors_close(tf.numpy(), jf)
    # the gathered, counted form the deferred frame uses
    idx = rng.permutation(len(ro))[:1000].astype(np.int32)
    count = torch.tensor([700], dtype=torch.int32)
    tg = beams.shadow_ray_floors(tdev[5], lv_d[: n * n], offsets, n, tdev[3],
                                 tdev[4], torch.from_numpy(ro), to_light,
                                 torch.from_numpy(md[idx]),
                                 idx=torch.from_numpy(idx), count=count)
    np.testing.assert_array_equal(tg.numpy()[:700], tf.numpy()[idx[:700]])
    assert (tg.numpy()[700:] == 0).all()


@pytest.mark.parametrize("light", range(len(LIGHTS)))
def test_sun_verdicts_match_jax(hills, lut, light):
    jh, _th = _fields(hills, lut)
    ld = np.asarray(LIGHTS[light], np.float32)
    ld /= np.linalg.norm(ld)
    js = jh.sun_map(ld)
    _env, tsun = convert.beam_state_from_jax(
        tuple(np.asarray(a) if hasattr(a, "shape") else a
              for a in jh.device()),
        tuple(np.asarray(a) if hasattr(a, "shape") else a for a in js),
        device="cpu")
    rng = np.random.default_rng(100 + light)
    ro = _shadow_origins(rng, hills, n=4000)
    md = np.where(rng.random(len(ro)) < 0.6, -1.0,
                  rng.uniform(0, 80, size=len(ro))).astype(np.float32)
    jl, jb = jbeams.sun_verdict_masks(
        js[0], n1=js[1], ro=jnp.asarray(ro), max_dst=jnp.asarray(md),
        d_len=js[2], d=js[3], origin=js[4])
    sb, n1, d_len, d, origin = tsun
    tl, tb = beams.sun_verdict_masks(sb, n1, torch.from_numpy(ro),
                                     torch.from_numpy(md), d_len, d, origin)
    jl, jb = np.asarray(jl), np.asarray(jb)
    assert jl.sum() > 50 and jb.sum() > 30  # both certificates claim
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tb.numpy(), jb)
    jfl = jbeams.sun_lit_floors(js[0], n1=js[1], ro=jnp.asarray(ro),
                                max_dst=jnp.asarray(md), d_len=js[2],
                                d=js[3], origin=js[4])
    tfl = beams.sun_lit_floors(sb, n1, torch.from_numpy(ro),
                               torch.from_numpy(md), d_len, d, origin)
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl))
    # the deferred frame's margin only withdraws lit claims (the lanes
    # within float error of a higher neighbour's footprint then trace)
    ml, mb = beams.sun_verdict_masks(sb, n1, torch.from_numpy(ro),
                                     torch.from_numpy(md), d_len, d, origin,
                                     margin=0.05)
    ml, mb = ml.numpy(), mb.numpy()
    assert not (ml & ~jl).any() and not (jb & ~mb).any()
    assert 0 < (jl & ~ml).sum() < 0.2 * jl.sum()


GRAZE_Y0, GRAZE_CX, GRAZE_CZ = 8, 13, 21  # ground top, the origins' column


def _graze_world(far):
    """A flat ground with one column 12 voxels taller beside the origins'
    column, at +x; a second, flat chunk at (far, 0, far) sets the octree's
    depth (far 7: depth 8, far 63: depth 11). (port Svo, port field)."""
    from voxelrs_tpu_torch.world import ChunkPos as TCP
    from voxelrs_tpu_torch.world import Position as TPos
    from voxelrs_tpu_torch.world import esvo as tesvo

    svo = Svo(new_registry(), capacity_mb=4, device="cpu")
    lut = thf.opaque_lut_from_mask(svo.translucent_block_mask)
    w, hf = tesvo.Esvo(), thf.HeightField()
    hf.SUN_WINDOW = 64
    ground = np.zeros((32, 32, 32), np.uint32)
    ground[:, :GRAZE_Y0, :] = STONE
    near = ground.copy()
    near[GRAZE_CX + 1, GRAZE_Y0:GRAZE_Y0 + 12, GRAZE_CZ] = STONE
    for pos, vox in (((0, 0, 0), near), ((far, 0, far), ground)):
        w.set_leaf(TPos(*pos),
                   tesvo.SerializedChunk.from_voxels(TCP(*pos), vox, 5), True)
        hf.set_chunk(pos, thf.chunk_column_tops(vox, 5),
                     vtops=thf.chunk_voxel_tops(vox, 5),
                     sbase=thf.chunk_solid_bases(vox, 5, lut))
    w.serialize()
    svo.update(w)
    return svo, hf


@pytest.mark.parametrize("far,depth", [(7, 8), (63, 11)])
def test_sun_margin_withdraws_corner_grazes(far, depth):
    """Shadow rays from the ground's top face that pass the tall column's
    corner within a few float32 ulps of the octree's coordinates: at margin
    0 (the JAX function) the sun map claims some of them lit while the
    traversal, rounding in octree units, hits the corner; at
    ``sun_margin(scale)`` no lit claim meets a hit, the claims farther out
    than the margin stand, and the disagreement at margin 0 stays within 4
    ulps of the corner (the margin is 64)."""
    from voxelrs_tpu_torch.ops.shading import trace_plain

    svo, hf = _graze_world(far)
    assert svo.depth == depth
    scale = float(svo.octree_scale)
    ulp = 2.0**-23 / scale  # one float32 ulp of the octree's [1, 2), in voxels
    rng = np.random.default_rng(depth)
    n = 4000
    d = np.array([0.55, 0.9, 0.7])
    d /= np.linalg.norm(d)  # toward the sun
    perp = np.array([-d[2], 0.0, d[0]]) / np.hypot(d[0], d[2])
    # offsets from the corner across the ray: half within 8 ulps, half 256
    off = np.concatenate([rng.uniform(-8, 8, n // 2),
                          rng.uniform(-256, 256, n - n // 2)]) * ulp
    back = rng.uniform(0.3, 0.6, n) / np.hypot(d[0], d[2])
    corner = np.array([GRAZE_CX + 1.0, 0.0, GRAZE_CZ + 1.0])
    o = corner + off[:, None] * perp - back[:, None] * d * [1.0, 0.0, 1.0]
    o[:, 1] = GRAZE_Y0 + 1e-3  # the frame's surface offset
    ro = torch.tensor(o, dtype=torch.float32)
    rd = torch.tensor(d, dtype=torch.float32).expand(n, 3).contiguous()
    hit = (trace_plain(svo.world(), scale, ro, rd, -1.0, False).t
           >= 0).numpy()
    sb, n1, d_len, dv, origin = hf.sun_map(
        -d, center=(GRAZE_CX, 0, GRAZE_CZ), device=torch.device("cpu"))
    lit0, blk0 = (m.numpy() for m in beams.sun_verdict_masks_plain(
        sb, n1, ro, None, d_len, dv, origin))
    graze = lit0 & hit
    assert graze.sum() > 10  # the JAX footprint's lit claim meets a hit
    assert np.abs(off[graze]).max() <= 4 * ulp
    assert not (blk0 & ~hit).any()
    lit, blk = (m.numpy() for m in beams.sun_verdict_masks_plain(
        sb, n1, ro, None, d_len, dv, origin, margin=beams.sun_margin(scale)))
    assert not (lit & hit).any()
    assert not (lit & ~lit0).any() and (blk == blk0).all()
    far_out = np.abs(off) > 2 * beams.SUN_MARGIN_ULPS * ulp
    assert lit[far_out & lit0].mean() > 0.9  # the certificate still certifies


# -- compaction ----------------------------------------------------------------


K6_TILE = 8192  # lanes of a K6 tile on the card (csrc/k6_compact.cuh)


def _masks():
    """(name, mask, size, starts segments or None): the shapes K6 is held
    to on the card too (tests/test_torch_cuda.py): tile boundaries, a mask
    sliced at an odd offset, starts with segment 1 and with segments that
    are not a multiple of the tile."""
    rng = np.random.default_rng(5)
    yield "all false", np.zeros(3000, bool), 1024, None
    yield "all true", np.ones(2500, bool), 2500, None
    yield "size below count", rng.random(5000) < 0.5, 700, None
    yield "ragged B", rng.random(1024 * 3 + 17) < 0.1, 1024 * 3 + 17, None
    yield "one lane", np.eye(1, 4099, 4098, dtype=bool)[0], 8, None
    yield "empty", np.zeros(0, bool), 4, None
    for k, d in ((1, -1), (1, 0), (1, 1), (3, -1), (3, 1)):
        n = K6_TILE * k + d
        yield f"tile {k}{d:+d}", rng.random(n) < 0.3, n, None
    yield "tile 3+1, size above count", rng.random(3 * K6_TILE + 1) < 0.3, \
        3 * K6_TILE + 100, None
    yield "sliced at offset 1", (rng.random(5 * K6_TILE + 78) < 0.4)[1:], \
        5 * K6_TILE + 77, None
    yield "starts, segment 1", rng.random(3000) < 0.5, 3000, 3000
    yield "starts, segments off the tile", rng.random(5 * 12_345) < 0.5, \
        5 * 12_345, 5


@pytest.mark.parametrize("case", [m[0] for m in _masks()])
def test_compact_indices_match_nonzero(case):
    _name, mask, size, m = next(c for c in _masks() if c[0] == case)
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size,
                                  fill_value=0)[0])
    tmask = torch.from_numpy(np.ascontiguousarray(mask))
    starts = None if m is None else torch.full((m,), -1, dtype=torch.int32)
    idx, count = compact_indices(tmask, size, starts=starts)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (size,)
    np.testing.assert_array_equal(idx.numpy(), want)
    assert count.tolist() == [int(mask.sum())]
    if len(mask):  # the JAX package's bitpacked form agrees too
        np.testing.assert_array_equal(
            np.asarray(jcompact(jnp.asarray(mask), size)), want)
    if m is not None:  # each segment's first rank: set lanes before it
        every = np.asarray(jnp.nonzero(jnp.asarray(mask), size=len(mask),
                                       fill_value=len(mask))[0])
        seg = len(mask) // m
        np.testing.assert_array_equal(
            starts.numpy(), np.searchsorted(every, np.arange(m) * seg))
    plain, _ = compact_indices_plain(tmask, size)
    np.testing.assert_array_equal(plain.numpy(), want)
