"""The launch checks of the finishing stage's kernel (``kd_finish``), of
K7's shadow floors, of K8 (its sun table on a 4-byte word, each output
on a 16-byte word), of K3, of the primary stage (``kd_primary``: records,
flags and a miss's pixel stored as 16-byte words), of K9-judged's trace,
merge and finalize, of every
CSVO launch (words on a 16-byte word, the CSVO kernels' launch contract),
and of the one-call pick
(``_build.launch_k5_pick``: buffers of the batch's rows, float32,
contiguous, on the world's device or in host memory; ``PickBuffers``
grown to the largest batch; the split's depth, ``picker.split_cells``),
and the work items of the
launches in 4x8 pixel tiles. ``kd_finish`` reads a thread's 4
candidate slots as one 16-byte word of ``sidx`` and one 4-byte word of
each flag array (``traced``, ``blk``, ``todo``) from slot 0, and gathers
colours and writes pixels as 16-byte words; K7's shadow kernel writes its
pads as 16-byte words from lane 0; K3 writes each pixel, and K9-judged's
trace each record, as 16-byte words. On the card a view off those words
faults or misses lanes, so the ``_build`` launch functions refuse it
before they touch the kernel library, and ``_build.check_kd_finish`` /
``check_k7_shadow`` / ``check_k3`` take the aligned views. K3 and K9's and
K9-judged's grid traces give a warp a 4x8 tile of a grid
(``csrc/kernels.cu::tile_lane``, mirrored by ``_build.tile_lanes``): every
lane is one item's, once. CPU tensors only; no JAX, no card."""

import pytest
import torch

from voxelrs_tpu_torch import _build
from voxelrs_tpu_torch.ops import adaptive

N = 37  # candidate slots: a partial last word of 4


def _view(n, dtype, offset, cols=None):
    """A contiguous view of ``n`` rows (of ``cols``) at ``offset``
    elements into a buffer that starts on a 16-byte word."""
    width = cols or 1
    buf = torch.zeros(n * width + 16, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    v = buf[offset:offset + n * width]
    return v if cols is None else v.view(n, cols)


def _finish_args(sidx=0, traced=0, blk=0, todo=0, color=0, img=0,
                 certified=True):
    """``launch_kd_finish``'s arguments over N slots, each view at the
    given element offset (``certified`` False: ``blk``/``todo`` None)."""
    fp = _build.FrameParams()
    hidx = torch.arange(N, dtype=torch.int32)
    flags = [_view(N, torch.bool, o) for o in (blk, todo, traced)]
    if not certified:
        flags[:2] = None, None
    return (fp, hidx, _view(N, torch.int32, sidx),
            torch.tensor([N], dtype=torch.int32),
            _view(N, torch.float32, color, 4), torch.zeros(N), *flags,
            _view(N, torch.float32, img, 4), None)


def _check(args):
    _, _, sidx, _, color, _, blk, todo, traced, img, _ = args
    _build.check_kd_finish(sidx, color, blk, todo, traced, img)


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 8])
def test_kd_finish_refuses_sidx_off_a_16_byte_word(offset):
    args = _finish_args(sidx=offset)
    if offset % 4 == 0:
        _check(args)
    else:
        with pytest.raises(ValueError,
                           match="sidx: expected a 16-byte aligned"):
            _build.launch_kd_finish(*args)


@pytest.mark.parametrize("name,certified", [("traced", False),
                                            ("traced", True), ("blk", True),
                                            ("todo", True)])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 16])
def test_kd_finish_refuses_flags_off_a_4_byte_word(offset, name, certified):
    args = _finish_args(**{name: offset}, certified=certified)
    if offset % 4 == 0:
        _check(args)
    else:
        with pytest.raises(ValueError,
                           match=f"{name}: expected a 4-byte aligned"):
            _build.launch_kd_finish(*args)


@pytest.mark.parametrize("name", ["color", "img"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_kd_finish_refuses_pixels_off_a_16_byte_word(name, offset):
    args = _finish_args(**{name: offset})
    if offset % 4 == 0:
        _check(args)
    else:
        with pytest.raises(ValueError,
                           match=f"{name}: expected a 16-byte aligned"):
            _build.launch_kd_finish(*args)


def test_kd_finish_refuses_what_its_words_cannot_read():
    fp, hidx, sidx, scount, color, ds, blk, todo, traced, img, _ = \
        _finish_args()
    for bad, match in (
            (dict(blk=None), "blk, todo: expected both or neither"),
            (dict(traced=traced[:N - 1]), "traced: expected a contiguous"),
            (dict(todo=todo.to(torch.float32)), "todo: expected a contiguous"),
            (dict(sidx=sidx.to(torch.int64)), "sidx: expected a contiguous"),
            (dict(sidx=_view(2 * N, torch.int32, 0)[::2]),
             "sidx: expected a contiguous"),
            (dict(img=img.t()), "img: expected a contiguous float32")):
        a = dict(sidx=sidx, color=color, blk=blk, todo=todo, traced=traced,
                 img=img)
        a.update(bad)
        with pytest.raises(ValueError, match=match):
            _build.launch_kd_finish(fp, hidx, a["sidx"], scount, a["color"],
                                    ds, a["blk"], a["todo"], a["traced"],
                                    a["img"])
    # uint8 flags take the same words as bool ones
    _build.check_kd_finish(sidx, color, blk.to(torch.uint8), todo,
                           traced.to(torch.uint8), img)


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 5])
def test_k7_shadow_refuses_an_output_off_a_16_byte_word(offset):
    out = _view(N, torch.float32, offset)
    if offset % 4 == 0:
        _build.check_k7_shadow(out)
    else:
        with pytest.raises(ValueError, match="out: expected a 16-byte aligned"):
            _build.launch_k7_shadow(None, None, None, _build.BeamParams(),
                                    None, None, None, None, out)
    with pytest.raises(ValueError, match="out: expected a contiguous"):
        _build.launch_k7_shadow(None, None, None, _build.BeamParams(), None,
                                None, None, None,
                                _view(2 * N, torch.float32, 0)[::2])


def _at_byte(n, dtype, byte):
    """A 1-d tensor of ``n`` ``dtype`` elements whose first byte lies
    ``byte`` bytes past a 16-byte word (any byte, also inside an
    element)."""
    size = torch.empty((), dtype=dtype).element_size()
    buf = bytearray(n * size + 32)
    base = torch.frombuffer(buf, dtype=torch.uint8).data_ptr()
    t = torch.frombuffer(buf, dtype=dtype, offset=(byte - base) % 16,
                         count=n)
    assert t.data_ptr() % 16 == byte
    return t


K8_OUTS = {"lit": torch.bool, "blk": torch.bool, "todo": torch.uint8,
           "floors": torch.float32}


def _k8(sb=None, **outs):
    """``launch_k8`` over N lanes with the given outputs (the rest None);
    its check refuses before the library is touched."""
    sb = torch.zeros((4, 80), dtype=torch.int16) if sb is None else sb
    args = {n: outs.get(n) for n in K8_OUTS}
    _build.launch_k8(sb, _build.SunParams(), None, None, None, None, N,
                     *args.values())


@pytest.mark.parametrize("name", sorted(K8_OUTS))
@pytest.mark.parametrize("byte", range(1, 16))
def test_k8_refuses_outputs_off_a_16_byte_word(name, byte):
    """K8 writes its pads as 16-byte words from lane 0 of each output: an
    output 1-15 bytes off a 16-byte word is refused, alone or beside
    aligned ones."""
    out = _at_byte(N, K8_OUTS[name], byte)
    others = {n: _at_byte(N, dt, 0) for n, dt in K8_OUTS.items()
              if n != name}
    with pytest.raises(ValueError,
                       match=f"{name}: expected a 16-byte aligned"):
        _k8(**{name: out})
    with pytest.raises(ValueError,
                       match=f"{name}: expected a 16-byte aligned"):
        _k8(**others, **{name: out})
    _build.check_k8(torch.zeros((4, 80), dtype=torch.int16), N,
                    *(_at_byte(N, dt, 0) for dt in K8_OUTS.values()))


@pytest.mark.parametrize("name", sorted(K8_OUTS))
def test_k8_refuses_a_wrong_dtype_or_size(name):
    """Each output is 1-d, contiguous, of its dtype (flags bool or uint8,
    floors float32) and holds at least the k lanes; the sun table is a
    contiguous int16 (rows, 76+2K) tensor on a 4-byte word."""
    wrong = torch.int32 if name != "floors" else torch.float64
    for bad in (_at_byte(N, wrong, 0), _at_byte(N - 1, K8_OUTS[name], 0),
                _at_byte(2 * N, K8_OUTS[name], 0)[::2],
                _at_byte(N, K8_OUTS[name], 0).view(1, N)):
        with pytest.raises(ValueError, match=f"{name}: expected a contig"):
            _k8(**{name: bad})
    for sb in (torch.zeros((4, 80), dtype=torch.int32),
               torch.zeros((4, 81), dtype=torch.int16),
               torch.zeros((4, 160), dtype=torch.int16)[:, ::2],
               _at_byte(320, torch.int16, 2).view(4, 80)):
        with pytest.raises(ValueError, match="sb_words: expected a"):
            _k8(sb=sb, **{name: _at_byte(N, K8_OUTS[name], 0)})


@pytest.mark.parametrize("size", [(1, 1), (15, 12), (33, 17), (127, 95),
                                  (1920, 1080)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_k3_tiles_cover_every_pixel_once(size):
    """K3's items (4x8 tiles a warp over the frame): each pixel is one
    item's, and a warp's 32 items lie in one 4-row, 8-column patch."""
    W, H = size
    lanes = _build.tile_lanes(W, H)
    assert lanes.shape[0] == -(-W // 8) * -(-H // 4) * 32
    on = lanes[lanes >= 0]
    assert torch.equal(torch.sort(on).values, torch.arange(W * H))
    warps = lanes.view(-1, 32)
    y = torch.where(warps >= 0, warps // W, -1)
    x = torch.where(warps >= 0, warps % W, -1)
    for v, span in ((y, 4), (x, 8)):
        lo = torch.where(v >= 0, v, 1 << 30).amin(1)
        hi = v.amax(1)
        assert bool((hi - lo < span).all())


@pytest.mark.parametrize("size", [(1920, 1080), (640, 360), (127, 95)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_judged_grid_tiles_cover_every_lane_once(size):
    """K9-judged's (and K9's) whole-grid trace on each grid level of the
    judged frame (the quarter grid's levels): every lane of the level is
    one item's."""
    W, H = size
    dims = adaptive.grid_dims(W, H, 2)
    assert len(dims) == 3
    for w, h in dims:
        lanes = _build.tile_lanes(w, h)
        on = lanes[lanes >= 0]
        assert torch.equal(torch.sort(on).values, torch.arange(w * h))


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_k3_refuses_a_frame_off_a_16_byte_word(offset):
    img = _view(8 * 4, torch.float32, offset, 4).view(4, 8, 4)
    fp = _build.FrameParams()
    if offset % 4 == 0:
        _build.check_k3(img)
    else:
        with pytest.raises(ValueError, match="img: expected a 16-byte aligned"):
            _build.launch_k3(None, 1.0, None, fp, img)


def test_k3_refuses_what_its_stores_cannot_take():
    img = torch.zeros((4, 8, 4))
    fp = _build.FrameParams()
    for bad, match in (
            (dict(img=img.transpose(0, 1)), "img: expected a contiguous"),
            (dict(img=img.double()), "img: expected a contiguous"),
            (dict(steps=torch.zeros(32, dtype=torch.int64)), "steps"),
            (dict(steps=torch.zeros(31, dtype=torch.int32)), "steps"),
            (dict(steps=torch.zeros(64, dtype=torch.int32)[::2]), "steps")):
        a = dict(img=img, steps=None)
        a.update(bad)
        with pytest.raises(ValueError, match=match):
            _build.launch_k3(None, 1.0, None, fp, a["img"], a["steps"])
    _build.check_k3(img, torch.zeros(32, dtype=torch.int32))


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_k9j_trace_refuses_records_off_a_16_byte_word(offset):
    out = _view(N, torch.int32, offset, 16)
    if offset % 4 == 0:
        _build.check_aligned("out", out)
    else:
        with pytest.raises(ValueError, match="out: expected a 16-byte aligned"):
            _build.launch_k9j_trace(None, 1.0, None, _build.FrameParams(),
                                    None, 0, out)


@pytest.mark.parametrize("name", ["frec", "rec", "hit", "img", "needp",
                                  "blkp"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_k9j_finalize_refuses_views_off_a_16_byte_word(name, offset):
    """K9-judged's finalize moves its records, HitRecs, flags and a miss's
    pixel as 16-byte words: each view off one is refused, by name."""
    B = N
    views = dict(frec=_view(B, torch.int32, 0, 16),
                 rec=_view(B, torch.int32, 0, 9),
                 hit=_view(B, torch.bool, 0), img=_view(B, torch.float32, 0, 4),
                 needp=_view(B, torch.bool, 0), blkp=_view(B, torch.bool, 0))
    dtype, cols = {"frec": (torch.int32, 16), "rec": (torch.int32, 9),
                   "img": (torch.float32, 4)}.get(name, (torch.bool, None))
    # offset 4-byte words into the buffer (4 flags to a word)
    views[name] = _view(B, dtype, offset * (4 if dtype == torch.bool else 1),
                        cols)
    if views[name].data_ptr() % 16 == 0:
        for n, t in views.items():
            _build.check_aligned(n, t)
    else:
        with pytest.raises(ValueError,
                           match=f"{name}: expected a 16-byte aligned"):
            _build.launch_k9j_finalize(_build.FrameParams(), *views.values())


@pytest.mark.parametrize("name", ["rec", "hit", "img"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_kd_primary_refuses_outputs_off_a_16_byte_word(name, offset):
    """kd_primary stores a block's hit records and flags as 16-byte words
    from lane 0, and a miss's pixel as one: each view off one is refused,
    by name, before the kernel library is touched."""
    views = dict(rec=_view(N, torch.int32, 0, 9),
                 hit=_view(N, torch.bool, 0),
                 img=_view(N, torch.float32, 0, 4))
    dtype, cols = {"rec": (torch.int32, 9), "hit": (torch.bool, None),
                   "img": (torch.float32, 4)}[name]
    # offset 4-byte words into the buffer (4 flags to a word)
    views[name] = _view(N, dtype, offset * (4 if dtype == torch.bool else 1),
                        cols)
    if views[name].data_ptr() % 16 == 0:
        _build.check_kd_primary(**views)
    else:
        with pytest.raises(ValueError,
                           match=f"{name}: expected a 16-byte aligned"):
            _build.launch_kd_primary(None, 1.0, None, _build.FrameParams(), 0,
                                     None, *views.values())


@pytest.mark.parametrize("name", ["lo", "hi"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_k9j_merge_refuses_records_off_a_16_byte_word(name, offset):
    """K9-judged's merge loads its lo records and stores its hi records as
    16-byte words from their first record: a view off one is refused, by
    name, before the kernel library is touched."""
    views = dict(lo=_view(N, torch.int32, 0, 16),
                 hi=_view(N, torch.int32, 0, 16))
    views[name] = _view(N, torch.int32, offset, 16)
    if offset % 4 == 0:
        _build.check_k9j_merge(**views)
    else:
        with pytest.raises(ValueError,
                           match=f"{name}: expected a 16-byte aligned"):
            _build.launch_k9j_merge(1.0, None, _build.FrameParams(), 0, False,
                                    views["lo"], views["hi"],
                                    _view(N, torch.bool, 0))


def _csvo_world(offset):
    """A CSVO world whose words start ``offset`` words into a buffer that
    starts on a 16-byte word."""
    from voxelrs_tpu_torch.ops.traversal_csvo import CsvoBuffer

    return CsvoBuffer(_view(64, torch.int32, offset), 0, 8)


CSVO_LAUNCHES = ["k3", "k4", "k5", "kd_primary", "kd_shadow", "k9_trace",
                 "k9j_trace"]


def _launch_csvo(name, world):
    """``_build.launch_<name>`` on ``world`` with arguments that pass every
    check before the world's."""
    fp = _build.FrameParams()
    img = _view(8 * 4, torch.float32, 0, 4).view(4, 8, 4)
    rays = torch.zeros((4, 3))
    if name == "k3":
        _build.launch_k3(world, 1.0, None, fp, img)
    elif name == "k4":
        _build.launch_k4(world.words, 1.0, world.root_ptr, world.total_depth,
                         rays, rays, torch.zeros(4), 2, 0, None,
                         *(None,) * 8)
    elif name == "k5":
        _build.launch_k5(world, 1.0, torch.zeros((4, 7)), 2,
                         torch.zeros((4, 8)))
    elif name == "kd_primary":
        _build.launch_kd_primary(world, 1.0, None, fp, 1, None,
                                 _view(32, torch.int32, 0, 9),
                                 _view(32, torch.bool, 0), img)
    elif name == "kd_shadow":
        idx = _view(16, torch.int32, 0)
        _build.launch_kd_shadow(world, 1.0, None, fp, 1, rays, idx, idx[:1],
                                None, None, None, _view(16, torch.bool, 0))
    elif name == "k9_trace":
        _build.launch_k9_trace(world, 1.0, fp, None, 1,
                               _view(N, torch.int32, 0, 8))
    else:
        _build.launch_k9j_trace(world, 1.0, None, fp, None, 1,
                                _view(N, torch.int32, 0, 16))


@pytest.mark.parametrize("name", CSVO_LAUNCHES)
@pytest.mark.parametrize("offset", [1, 2, 3, 5])
def test_csvo_launches_refuse_words_off_a_16_byte_word(name, offset):
    """Every CSVO launch refuses a words view one to three words off a
    16-byte word, before it touches the kernel library (there is none
    here: a launch that got past the check would fail otherwise)."""
    with pytest.raises(ValueError, match="words: expected a 16-byte aligned"):
        _launch_csvo(name, _csvo_world(offset))


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_check_words_refuses_words_off_a_16_byte_word(offset):
    """``ops.traversal_csvo.check_words``, which every CSVO wrapper runs,
    takes words on a 16-byte word and refuses the others."""
    from voxelrs_tpu_torch.ops.traversal_csvo import check_words

    world = _csvo_world(offset)
    if offset % 4 == 0:
        check_words(*world)
        assert _build.csvo_words(world) == tuple(world)
    else:
        with pytest.raises(ValueError,
                           match="words: expected a 16-byte aligned"):
            check_words(*world)



def _pick_args(n=8, **bad):
    """A pick's world and buffers on the CPU (the world's device), each
    replaceable by a bad one."""
    world = torch.zeros(24, dtype=torch.int32)
    bufs = dict(host_tasks=torch.zeros((n, 7)), dev_tasks=torch.zeros((n, 7)),
                dev_rows=torch.zeros((n, 8)), host_rows=torch.zeros((n, 8)))
    bufs.update(bad)
    return world, bufs


@pytest.mark.parametrize("name", ["host_tasks", "dev_tasks", "dev_rows",
                                  "host_rows"])
@pytest.mark.parametrize("kind", ["dtype", "rows", "strided", "device"])
def test_k5_pick_refuses_buffers_it_cannot_use(name, kind):
    """``launch_k5_pick`` refuses a buffer of another dtype, with fewer
    rows than the batch, not contiguous, or on another device (the device
    buffers on the world's, the host buffers in host memory), before it
    touches the kernel library."""
    width = 7 if name.endswith("tasks") else 8
    bad = {"dtype": torch.zeros((8, width), dtype=torch.float64),
           "rows": torch.zeros((7, width)),
           "strided": torch.zeros((8, 2 * width))[:, ::2],
           "device": torch.zeros((8, width), device="meta")}[kind]
    world, bufs = _pick_args(**{name: bad})
    with pytest.raises(ValueError, match=name):
        _build.launch_k5_pick(world, 2.0 ** -7, 8, 1000, **bufs)


def test_k5_pick_refuses_an_empty_batch_and_bad_shapes():
    world, bufs = _pick_args()
    with pytest.raises(ValueError, match="at least 1 task"):
        _build.launch_k5_pick(world, 1.0, 0, 1000, **bufs)
    for segments in (0, 33):  # the lanes of a task (a pick casts with 32)
        with pytest.raises(ValueError, match="segments"):
            _build.launch_k5(world, 1.0, bufs["dev_tasks"], 1000,
                             bufs["dev_rows"], segments=segments)


def test_k5_pick_refuses_pageable_host_buffers():
    """A host buffer must be pinned (``check_pinned``, which
    ``PickBuffers`` runs when it allocates on a card): a CPU tensor here
    is pageable."""
    with pytest.raises(ValueError, match="host_rows: expected a tensor in "
                                         "pinned host memory"):
        _build.check_pinned("host_rows", torch.zeros((8, 8)))


@pytest.mark.parametrize("scale,depth", [(1.0, 0), (0.5, 1), (2.0 ** -11, 11),
                                         (0.3, 2), (2.0, 0), (0.75, 1)])
def test_scale_depth(scale, depth):
    """K5's split bounds a ray's cells by the octree's depth D, of
    octree_scale = 2^-D (the kernel's -ilogb): another scale's depth is
    rounded up, at least 0, on the CPU as on the card; a task of length 0
    crosses at most 4 D + 3 cells."""
    from voxelrs_tpu_torch.ops.picker import split_cells

    tasks = torch.zeros((2, 7))
    tasks[1, 4] = 1.0
    assert split_cells(scale, tasks).tolist() == [4.0 * depth + 3.0] * 2


def test_pick_buffers_grow_to_the_largest_batch():
    """``PickBuffers`` allocates for a batch once and reuses the buffers
    for every smaller one; its numpy views are the host tensors' memory."""
    from voxelrs_tpu_torch.ops.picker import PickBuffers

    b = PickBuffers("cpu")
    sizes, ptrs = [], []
    for n in (8, 32, 8, 5000, 33, 5000):
        b.hold(n)
        sizes.append(b.size)
        ptrs.append((b.host_tasks.data_ptr(), b.dev_rows.data_ptr()))
        assert b.host_tasks.shape == (b.size, 7)
        assert b.host_rows.shape == b.dev_rows.shape == (b.size, 8)
    assert sizes == [8, 32, 32, 5000, 5000, 5000]
    assert ptrs[1] == ptrs[2] and ptrs[3] == ptrs[4] == ptrs[5]
    assert ptrs[0] != ptrs[1]
    b.tasks[0, 0] = 7.0
    assert float(b.host_tasks[0, 0]) == 7.0
    assert not b.host_tasks.is_pinned()  # pinned only for a card


def test_pick_refuses_buffers_of_another_device():
    from voxelrs_tpu_torch.ops.picker import PickBuffers, pick

    world = torch.zeros(24, dtype=torch.int32)
    with pytest.raises(ValueError, match="buffers: on meta"):
        pick(world, 1.0, torch.zeros((8, 7)).numpy(), PickBuffers("meta"))
