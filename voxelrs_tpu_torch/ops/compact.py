"""Stream compaction (kernel K6): the ascending indices of a mask's set lanes.

Counterpart: voxelrs_tpu/ops/shading.py::compact_indices (:313), which is
``jnp.nonzero(mask, size=size, fill_value=0)[0]`` in a bitpacked form. The
JAX package's sticky buckets, plan stores and its dense switch around it
are TPU structure and are not carried over: here the count stays in device
memory, and the kernels downstream read it and exit past it, so a frame
makes no host round trip per compaction.

On a CUDA mask ``compact_indices`` launches K6 (``csrc/k6_compact.cuh``):
one kernel that reads the mask once, ranks its lanes with a single-pass
scan (decoupled look-back over 8192-lane tiles), writes each set lane at
its rank, the count, and the 0 padding past it. On the CPU it runs the
plain version.

A pose batch (K10) compacts the lanes of all its poses at once, pose-major;
``starts`` then receives where each pose's set lanes begin in the output
(the rank of each pose's first lane), so a kernel reads each pose's count
on the card.
"""

from __future__ import annotations

import torch

from .. import _build

launches = 0  # K6 launches by compact_indices (the wrapper below)


def _check_starts(starts, n: int) -> int:
    """The segment length of a ``starts`` tensor over ``n`` lanes."""
    if starts.dtype != torch.int32 or starts.dim() != 1 \
            or not starts.is_contiguous() or starts.shape[0] == 0 \
            or n % starts.shape[0]:
        raise ValueError("starts: expected a contiguous (m,) int32 tensor, "
                         "m dividing the mask's lanes")
    return n // starts.shape[0]


def compact_indices_plain(mask: torch.Tensor, size: int, *, starts=None):
    """(indices, count): the ascending indices of the set lanes of the 1-d
    ``mask``, truncated at ``size`` and padded with 0 to ``size`` (int32),
    and the number of set lanes as a (1,) int32 tensor (not truncated).
    ``starts`` None, or an (m,) int32 tensor that receives the number of
    set lanes before lane ``k * n / m`` for each k (m segments of the n
    lanes)."""
    m = mask.reshape(-1).to(torch.bool)
    if starts is not None:
        seg = _check_starts(starts, m.shape[0])
        before = torch.cumsum(m.to(torch.int64), 0) - m.to(torch.int64)
        starts.copy_(before[::seg].to(torch.int32))
    rank = torch.cumsum(m.to(torch.int64), 0) - 1
    keep = m & (rank < size)
    out = torch.zeros(size, dtype=torch.int32, device=m.device)
    lanes = torch.arange(m.shape[0], dtype=torch.int32, device=m.device)
    out[rank[keep]] = lanes[keep]
    count = m.sum().to(torch.int32).reshape(1)
    return out, count


def compact_indices(mask: torch.Tensor, size: int, *, out=None, count=None,
                    scratch=None, starts=None):
    """``compact_indices_plain``'s function: the plain version for a CPU
    mask, K6 for a CUDA mask (a contiguous 1-d bool tensor). On the card
    ``out`` ((size,) int32), ``count`` ((1,) int32) and ``scratch``
    (int32, at least ``_build.k6_blocks(n)``, zeroed when allocated and
    given to K6 alone) may be the caller's workspace, reused across calls
    on one stream; ``starts`` as in the plain version."""
    if not mask.is_cuda:
        return compact_indices_plain(mask, size, starts=starts)
    global launches
    if mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("mask: expected a contiguous 1-d bool tensor")
    n = mask.shape[0]
    if n >= 1 << 31 or size < 0:
        raise ValueError(f"mask of {n} lanes / size {size} out of range")
    dev = mask.device
    if out is None:
        out = torch.empty(size, dtype=torch.int32, device=dev)
    if count is None:
        count = torch.empty(1, dtype=torch.int32, device=dev)
    if scratch is None:
        scratch = torch.zeros(_build.k6_blocks(n), dtype=torch.int32,
                              device=dev)
    if out.shape[0] != size or scratch.shape[0] < _build.k6_blocks(n):
        raise ValueError("compact_indices: workspace of another size")
    if starts is not None and (_check_starts(starts, n) == 0
                               or starts.device != dev):
        raise ValueError("starts: on another device or of empty segments")
    _build.launch_k6(mask, size, out, count, scratch, starts)
    launches += 1
    return out, count
