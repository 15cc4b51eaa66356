"""K9's record tensors as its kernels take them. The kernels move a
32-byte record as two 16-byte words, which fault on the card at an address
that is not a multiple of 16, so ``ops.adaptive._check_rec`` refuses a
record view whose address is not, and takes one whose address is. K9's
shadow cells move a thread's hit indices as a 16-byte word and its need
and mask bytes as 4-byte words from lane 0, so ``ops.adaptive.
_check_lanes`` refuses such a lane view off a 16-byte word. CPU tensors
only; no JAX."""

import pytest
import torch

from voxelrs_tpu_torch.ops import adaptive


@pytest.mark.parametrize("offset_words", [0, 1, 2, 3, 4, 8])
def test_check_rec_refuses_a_view_off_a_16_byte_word(offset_words):
    n = 5
    buf = torch.zeros(n * 8 + 8, dtype=torch.int32)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset_words:offset_words + n * 8].view(n, 8)
    assert view.is_contiguous()
    if offset_words % 4 == 0:
        adaptive._check_rec("lo", view, n)
    else:
        with pytest.raises(ValueError, match="lo: expected a 16-byte aligned"):
            adaptive._check_rec("lo", view, n)


@pytest.mark.parametrize("dtype,offset", [(torch.bool, o) for o in
                                          (0, 1, 4, 15, 16)]
                         + [(torch.int32, o) for o in (0, 1, 2, 4)])
def test_check_lanes_refuses_a_view_off_a_16_byte_word(dtype, offset):
    n = 37
    buf = torch.zeros(n + 16, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:offset + n]
    if view.data_ptr() % 16 == 0:
        adaptive._check_lanes("mask", view, n, dtype)
    else:
        with pytest.raises(ValueError,
                           match="mask: expected a 16-byte aligned"):
            adaptive._check_lanes("mask", view, n, dtype)
    with pytest.raises(ValueError, match="mask: expected a contiguous"):
        adaptive._check_lanes("mask", buf[: 2 * n:2], n, dtype)
