"""The CSVO traversal's plain version (``ops.traversal_csvo.
intersect_octree_csvo_plain``, the yardstick K4 and K3-CSVO are held to on
the card) against the JAX package's ``intersect_octree_csvo`` on the
hand-built streams of tests/test_torch_cuda.py (``CSVO_STREAMS``): internal
pointers of every tag width and of all eight children, pointers past a
node's first 32 bytes, crossings into chunk blobs of lod 5 and 4, a node in the
stream's last word, a root cut short there, and word counts 1, 2 and 3
past a multiple of 4. The JAX function gets the stream at its own length,
so that its gather clamps where the port's reads clamp.

Both casts run the JAX classic loop, which the plain version mirrors
read for read: the translucent cast judges value 7 clear; the port's
opaque cast (no judge) is held to the JAX cast with a judge that keeps
every texel, since the JAX opaque cast runs its push engine, which can
leave a ray that starts inside a voxel elsewhere on such streams.

Tolerances: value, face_id, inside_voxel and hit/miss equal; t, pos, uv
and lod within tests/test_torch_csvo.py's TOL_T, TOL_UV and TOL_LOD (XLA
on the CPU contracts multiply-adds into FMAs, the port does not), t and
pos scaled by the world's size against that file's 64-voxel worlds (the
rounding of a float32 distance grows with it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cuda as tc
from test_torch_csvo import TOL_LOD, TOL_T, TOL_UV
from voxelrs_tpu.ops.traversal_csvo import intersect_octree_csvo as jtrace
from voxelrs_tpu_torch.ops import traversal_csvo

RAYS = 1024


def _j_clear7(value, face_id, uv, lod):
    return jnp.where(value == 7, 0.0, 1.0)


def _j_keep(value, face_id, uv, lod):
    return jnp.ones(value.shape, jnp.float32)


def _t_clear7(value, face_id, uv, lod):
    return torch.where(value == 7, 0.0, 1.0)


def test_streams_cover_what_the_cursor_reads():
    """Every stream has nodes of eight children, nodes of eight 4-byte
    pointers and crossings; together they hold every pointer width, the
    last node in the last word, and every word count class."""
    seen = set()
    for name in tc.CSVO_STREAMS:
        words, _root, _depth, st = tc.csvo_stream(name)
        assert st["eight"] and st["eight_wide"] and st["crossings"] >= 2
        assert st["last_node_in_last_word"]
        assert len(words) % 4 == tc.CSVO_STREAMS[name][4]
        seen |= st["widths"]
    assert seen == {1, 2, 4}


@pytest.mark.parametrize("cast", ["opaque", "clear7"])
@pytest.mark.parametrize("name", sorted(tc.CSVO_STREAMS))
def test_plain_csvo_traversal_matches_jax_on_hand_built_streams(name, cast):
    words, root_ptr, depth, _stats = tc.csvo_stream(name)
    ro, rd = tc._stream_rays(RAYS, depth, 17)
    scale = np.float32(2.0 ** -depth)
    judged = cast == "clear7"
    j = jax.jit(lambda w, o, d: jtrace(
        w, scale, jnp.uint32(root_ptr), depth, o, d, jnp.float32(-1.0),
        True, alpha_fn=_j_clear7 if judged else _j_keep))(
            jnp.asarray(words), jnp.asarray(ro), jnp.asarray(rd))
    t = traversal_csvo.intersect_octree_csvo_plain(
        torch.from_numpy(words.view(np.int32)), float(scale), root_ptr,
        depth, torch.from_numpy(ro), torch.from_numpy(rd), -1.0, judged,
        _t_clear7 if judged else None)
    jt = np.asarray(j.t)
    hit = t.t.numpy() != -1.0
    assert 100 < int(hit.sum()) < RAYS
    np.testing.assert_array_equal(hit, jt != -1.0)
    np.testing.assert_array_equal(t.value.numpy(), np.asarray(j.value))
    np.testing.assert_array_equal(t.face_id.numpy(), np.asarray(j.face_id))
    np.testing.assert_array_equal(t.inside_voxel.numpy(),
                                  np.asarray(j.inside_voxel))
    tol_t = TOL_T * 2.0 ** (depth - 6)
    np.testing.assert_allclose(t.t.numpy(), jt, rtol=0, atol=tol_t)
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), rtol=0,
                               atol=tol_t)
    np.testing.assert_allclose(t.uv.numpy(), np.asarray(j.uv), rtol=0,
                               atol=TOL_UV)
    np.testing.assert_allclose(t.lod.numpy(), np.asarray(j.lod), rtol=0,
                               atol=TOL_LOD)
