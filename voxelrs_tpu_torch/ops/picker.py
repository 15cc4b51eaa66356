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
(``csrc/kernels.cu``), one thread per task running K1's traversal, or K4's
in its CSVO instantiation; on the CPU it is the plain version. The JAX
opaque casts run push engines (ESVO and CSVO), the port the classic loop:
both give the same hits for rays that finish within the step budget, as
picker tasks (at most 30 blocks long) do.
"""

from __future__ import annotations

import torch

from .. import _build
from .shading import FACE_NORMALS, trace_plain, world_tensor
from .traversal import MAX_STEPS, _check, step_budget
from .traversal_csvo import CsvoBuffer, check_words
from .traversal_csvo import step_budget as csvo_step_budget

launches = 0  # K5 launches by raycast (the wrapper below)
launches_csvo = 0  # of those, launches of the CSVO instantiation


def raycast_plain(descriptors: torch.Tensor, octree_scale,
                  tasks: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch picker: (n, 7) tasks → (n, 8) rows."""
    res = trace_plain(descriptors, octree_scale, tasks[:, 1:4],
                      tasks[:, 4:7], tasks[:, 0], False, max_steps=MAX_STEPS)
    hit = res.t > 0
    normals = FACE_NORMALS.to(tasks.device)[res.face_id.long()]
    return torch.cat([
        torch.where(hit, res.t, -1.0)[:, None],
        (res.inside_voxel & hit).to(torch.float32)[:, None],
        torch.where(hit[:, None], res.pos, 0.0),
        torch.where(hit[:, None], normals, 0.0),
    ], dim=1)


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
    global launches, launches_csvo
    dev = buf.device
    n = tasks.shape[0]
    csvo = isinstance(descriptors, CsvoBuffer)
    if csvo:
        check_words(*descriptors)
    else:
        _check("descriptors", buf, torch.int32, device=dev)
        if buf.dim() != 1 or buf.shape[0] < 12:
            raise ValueError("descriptors: expected a 1-d buffer of >= 12 "
                             "words")
    _check("tasks", tasks, torch.float32, (n, 7), dev)
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    budget = (csvo_step_budget if csvo else step_budget)(MAX_STEPS)
    if n:
        _build.launch_k5(descriptors, float(octree_scale), tasks, budget,
                         out)
        launches += 1
        launches_csvo += int(csvo)
    return out
