"""The picker's device work: the plain PyTorch version and the wrapper of
kernel K5.

Counterpart: voxelrs_tpu/graphics/svo.py::_raycast_fn (:526-557), the jitted
function behind ``Svo.raycast`` (reference: src/graphics/svo.rs:233-255 and
assets/shaders/picker.glsl:30-51). Each task of an (n, 7) float32 batch
``[max_dst, pos.xyz, dir.xyz]`` (``graphics.picker.PickerBatch``) is cast
opaque — no alpha judge, the first leaf stops it — and its hit packed into
one (n, 8) float32 row ``[dst, inside, pos.xyz, normal.xyz]``:

- ``dst``: the hit distance where ``t > 0``, else -1;
- ``inside``: 1 where the ray started inside a voxel and hit, else 0;
- ``pos``: the hit position where hit, else 0;
- ``normal``: the hit face's normal where hit, else 0.

The world is an ESVO buffer or a CSVO world (``CsvoBuffer``, the JAX CSVO
branch :535-541). On a CUDA tensor ``raycast`` launches K5
(``csrc/kernels.cu``): a warp a task, ``_build.K5_SEGMENTS`` lanes casting
it (``raycast_split_plain`` is the split in plain PyTorch), through K1's
traversal, or K4's in its CSVO instantiation; on the CPU it is the plain
version. ``pick`` is ``Svo.raycast``'s whole pick on the card: numpy tasks
in, numpy rows out, in one native call through ``PickBuffers``. The JAX
opaque casts run push engines (ESVO and CSVO), the port the classic loop:
both give the same hits for rays that finish within the step budget, as
picker tasks (at most 30 blocks long) do.
"""

from __future__ import annotations

import torch

from .. import _build
from .bits import fdiv
from .shading import FACE_NORMALS, trace_plain, world_tensor
from .traversal import MAX_STEPS, _check, step_budget
from .traversal_csvo import CsvoBuffer, check_words
from .traversal_csvo import step_budget as csvo_step_budget

launches = 0  # K5 launches by raycast and pick (the wrappers below)
launches_csvo = 0  # of those, launches of the CSVO instantiation
K5_FIRST = 2.0  # world units that lane 0 of a split cast casts (kernels.cu)


def raycast_plain(descriptors: torch.Tensor, octree_scale,
                  tasks: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch picker: (n, 7) tasks → (n, 8) rows."""
    return _rows(trace_plain(descriptors, octree_scale, tasks[:, 1:4],
                             tasks[:, 4:7], tasks[:, 0], False,
                             max_steps=MAX_STEPS), tasks)


def _rows(res, tasks) -> torch.Tensor:
    """Picker rows of traversal results (``inside`` as ``res`` has it)."""
    hit = res.t > 0
    normals = FACE_NORMALS.to(tasks.device)[res.face_id.long()]
    return torch.cat([
        torch.where(hit, res.t, -1.0)[:, None],
        (res.inside_voxel & hit).to(torch.float32)[:, None],
        torch.where(hit[:, None], res.pos, 0.0),
        torch.where(hit[:, None], normals, 0.0),
    ], dim=1)


def raycast_split_plain(descriptors, octree_scale, tasks: torch.Tensor,
                        segments: int, max_steps: int = MAX_STEPS
                        ) -> torch.Tensor:
    """K5's split cast in plain PyTorch (csrc/kernels.cu
    ``k5_picker_kernel``): rows equal to ``raycast_plain``'s with the same
    ``max_steps``. Where ``segments`` S > 1 and ``max_dst`` > ``K5_FIRST``,
    lane 0 casts [0, K5_FIRST] and lane k = 1 .. S - 1 the segment of
    [K5_FIRST, max_dst] at fractions (k - 1) / (S - 1) and k / (S - 1)
    (the last ending at max_dst) from that floor; the nearest hit wins, the
    lower lane on a tie. A lane that starts inside a leaf reports its
    floor, where the ray entered that leaf in an earlier segment, whose
    lane hits it or an earlier leaf first, unless the ray starts inside a
    voxel, which the classic loop passes through; so the whole ray is cast
    after all where the winner hit at its floor (its distance (floor *
    scale) / scale), and where lane 0's steps plus the cells the rest of
    the ray can cross (``split_cells``, each probed at most once) exceed
    the step budget. ``inside`` is lane 0's: only steps
    at t = 0 set it."""
    n, S = tasks.shape[0], segments
    md, d = tasks[:, 0], tasks[:, 4:7]
    split = (md > K5_FIRST) if S > 1 else torch.zeros_like(md,
                                                            dtype=torch.bool)
    if not bool(split.any()):
        return _rows(trace_plain(descriptors, octree_scale, tasks[:, 1:4], d,
                                 md, False, max_steps=max_steps), tasks)
    dev = tasks.device
    scale = torch.tensor(octree_scale, dtype=torch.float32, device=dev)
    frac = fdiv(torch.arange(S - 1, dtype=torch.float32, device=dev), S - 1)
    floors = K5_FIRST + (md - K5_FIRST)[:, None] * frac[None, :]  # lanes 1..
    ends = torch.cat([floors[:, 1:], md[:, None]], 1)
    lane0 = trace_plain(descriptors, octree_scale, tasks[:, 1:4], d,
                        torch.where(split, K5_FIRST, md), False,
                        max_steps=max_steps)
    rest = trace_plain(
        descriptors, octree_scale,
        tasks[:, None, 1:4].expand(n, S - 1, 3).reshape(-1, 3),
        d[:, None].expand(n, S - 1, 3).reshape(-1, 3), ends.reshape(-1),
        False, max_steps=max_steps, t_floor=floors.reshape(-1))

    def lanes(x0, x):  # (n, S, ...): lane 0, then lanes 1..
        return torch.cat([x0[:, None], x.view(n, S - 1, *x.shape[1:])], 1)

    t = lanes(lane0.t, rest.t)
    key = torch.where(t > 0, t, torch.inf)
    win = torch.argmin(key, 1)  # the first lane of the least distance
    won = key.gather(1, win[:, None])[:, 0] < torch.inf
    floor_t = lanes(torch.zeros(n, device=dev), floors.reshape(-1)).gather(
        1, win[:, None])[:, 0]
    floor_hit = won & (win > 0) & (
        t.gather(1, win[:, None])[:, 0] == (floor_t * scale) / scale)
    cells = split_cells(octree_scale, tasks)
    budget = (csvo_step_budget if isinstance(descriptors, CsvoBuffer)
              else step_budget)(max_steps)
    redo = split & (floor_hit | (lane0.steps.float() + cells > budget))

    def winner(f):
        x = lanes(getattr(lane0, f), getattr(rest, f))
        idx = win.view(n, 1, *[1] * (x.dim() - 2)).expand(n, 1, *x.shape[2:])
        return x.gather(1, idx)[:, 0]

    res = lane0._replace(t=winner("t"), face_id=winner("face_id"),
                         pos=winner("pos"))
    rows = torch.where(split[:, None], _rows(res, tasks),
                       _rows(lane0, tasks))
    if bool(redo.any()):
        whole = trace_plain(descriptors, octree_scale, tasks[redo, 1:4],
                            d[redo], md[redo], False, max_steps=max_steps)
        rows[redo] = _rows(whole, tasks[redo])
    return rows


def split_cells(octree_scale, tasks: torch.Tensor) -> torch.Tensor:
    """The most cells that each task's ray can cross past lane 0's segment
    of a split cast (csrc/kernels.cu ``k5_picker_kernel``): 4 D + 3 + 2
    max_dst (|d|_1 + 1e-6), D = -ilogb(octree_scale), at least 0: the
    octree's depth where octree_scale = 2^-D, another scale's rounded
    up."""
    scale = torch.tensor(octree_scale, dtype=torch.float32)
    depth = max(0, 1 - int(torch.frexp(scale).exponent))
    a = tasks[:, 4:7].abs()
    return (4.0 * depth + 3.0
            + 2.0 * tasks[:, 0] * (((a[:, 0] + a[:, 1]) + a[:, 2]) + 1e-6))


def _check_world(descriptors, dev):
    """Refuse a world K5 cannot read (``dev``: its buffer's device)."""
    if isinstance(descriptors, CsvoBuffer):
        check_words(*descriptors)
        return
    _check("descriptors", descriptors, torch.int32, device=dev)
    if descriptors.dim() != 1 or descriptors.shape[0] < 12:
        raise ValueError("descriptors: expected a 1-d buffer of >= 12 words")


def _budget(descriptors) -> int:
    return (csvo_step_budget if isinstance(descriptors, CsvoBuffer)
            else step_budget)(MAX_STEPS)


def _count(descriptors):
    global launches, launches_csvo
    launches += 1
    launches_csvo += int(isinstance(descriptors, CsvoBuffer))


def raycast(descriptors: torch.Tensor, octree_scale,
            tasks: torch.Tensor) -> torch.Tensor:
    """Cast an (n, 7) float32 task batch through the world ``descriptors``
    (an ESVO buffer, (N,) int32 holding u32 words, or a ``CsvoBuffer``);
    returns (n, 8) float32 on the buffer's device. On the CPU this is the
    plain version; on CUDA tensors it launches K5 once, the instantiation
    of the world's format."""
    buf = world_tensor(descriptors)
    if not buf.is_cuda:
        return raycast_plain(descriptors, octree_scale, tasks)
    dev = buf.device
    n = tasks.shape[0]
    _check_world(descriptors, dev)
    _check("tasks", tasks, torch.float32, (n, 7), dev)
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    if n:
        _build.launch_k5(descriptors, float(octree_scale), tasks,
                         _budget(descriptors), out)
        _count(descriptors)
    return out


class PickBuffers:
    """The task and row buffers of ``pick`` for one device: two float32
    tensors on the device and two in host memory, pinned where the device
    is a card (a copy from pageable memory is not asynchronous), each
    allocated once and grown to the largest batch seen; ``tasks`` and
    ``rows`` are numpy views of the host pair."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.size = 0  # tasks the buffers hold
        self.host_tasks = self.dev_tasks = self.dev_rows = None
        self.host_rows = self.tasks = self.rows = None

    def hold(self, n: int) -> "PickBuffers":
        """Make room for ``n`` tasks (the buffers are reused below that)."""
        if n > self.size:
            pin = self.device.type == "cuda"
            host = [torch.empty((n, w), dtype=torch.float32, pin_memory=pin)
                    for w in (7, 8)]
            if pin:
                for name, t in zip(("host_tasks", "host_rows"), host):
                    _build.check_pinned(name, t)
            self.host_tasks, self.host_rows = host
            self.dev_tasks, self.dev_rows = (
                torch.empty((n, w), dtype=torch.float32, device=self.device)
                for w in (7, 8))
            self.tasks, self.rows = (t.numpy() for t in host)
            self.size = n
        return self


def pick(descriptors, octree_scale, tasks, buffers: PickBuffers):
    """Cast an (n, 7) float32 numpy task batch through the world on the
    card and return its (n, 8) float32 rows as a new numpy array: the
    tasks go into ``buffers``' pinned host memory, and one native call
    (``_build.launch_k5_pick``, which keeps the interpreter lock) uploads
    them, launches K5 and waits for the rows' copy back. Between the
    serialization and the rows no call gives up the lock (a buffer's
    growth allocates)."""
    n = len(tasks)
    buf = world_tensor(descriptors)
    _check_world(descriptors, buf.device)
    if buffers.device != buf.device:
        raise ValueError(f"buffers: on {buffers.device}, expected the "
                         f"world's {buf.device}")
    b = buffers.hold(n)
    b.tasks[:n] = tasks
    _build.launch_k5_pick(descriptors, float(octree_scale), n,
                          _budget(descriptors), b.host_tasks, b.dev_tasks,
                          b.dev_rows, b.host_rows)
    _count(descriptors)
    return b.rows[:n].copy()
