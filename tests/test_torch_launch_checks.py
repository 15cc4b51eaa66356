"""The launch checks of the finishing stage's kernel (``kd_finish``) and of
K7's shadow floors. ``kd_finish`` reads a thread's 4 candidate slots as one
16-byte word of ``sidx`` and one 4-byte word of each flag array
(``traced``, ``blk``, ``todo``) from slot 0, and gathers colours and
writes pixels as 16-byte words; K7's shadow kernel writes its pads as
16-byte words from lane 0. On the card a view off those words faults or
misses lanes, so ``_build.launch_kd_finish`` and ``_build.launch_k7_shadow``
refuse it before they touch the kernel library, and ``_build.
check_kd_finish`` / ``check_k7_shadow`` take the aligned views. CPU
tensors only; no JAX, no card."""

import pytest
import torch

from voxelrs_tpu_torch import _build

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
