"""Renderer front-end: owns the device-resident SVO buffer, material table
and texture mips; exposes ``update`` (delta upload), ``render`` (one exact
frame) and ``raycast`` (picker batches).

Counterpart: voxelrs_tpu/graphics/svo.py (``__init__`` :63-111,
``_grow_device`` :113, ``update`` :150-197, ``reload_resources``,
``_compute_translucent_blocks`` :207, ``render`` in ``mode="fused"`` and,
for a CSVO buffer, ``mode="csvo"`` :292-366, ``raycast`` :559-589,
``get_stats``), itself after reference: src/graphics/svo.rs:56-255. The
persistently-mapped GL buffer is an int32 torch tensor holding u32 words,
patched on exactly the ranges the serializer changed.

Two formats, by ``buffer_dtype``: ``np.uint32`` (ESVO: a u32 host mirror,
uploaded word for word) and ``np.uint8`` (CSVO: a byte host mirror
``[root_ptr u32][node bytes...]``; the device holds the node bytes after
the 4-byte prefix as words, and ``root_ptr`` rides beside it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.picker import raycast
from ..ops.shading import KernelTables, render_frame
from ..ops.traversal_csvo import MAX_STREAM_BYTES, CsvoBuffer
from .picker import PickerBatch, PickerBatchResult


@dataclass
class RenderParams:
    """Per-frame render inputs (reference: src/graphics/svo.rs:85-106)."""

    cam_pos: np.ndarray
    cam_fwd: np.ndarray
    cam_up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    fov_y_rad: float = np.radians(72.0)
    aspect_ratio: float = 16 / 9
    ambient_intensity: float = 0.3
    light_dir: np.ndarray = field(
        default_factory=lambda: np.array([-1, -1, -1], np.float32) / np.sqrt(3)
    )
    render_shadows: bool = True
    shadow_distance: float = 300.0
    selected_voxel: Optional[np.ndarray] = None


@dataclass
class Stats:
    used_bytes: int = 0
    capacity_bytes: int = 0
    depth: int = 0


class Svo:
    """Device-side SVO renderer (ESVO u32 or CSVO byte buffers)."""

    def __init__(self, registry, capacity_mb: float = 64.0,
                 buffer_dtype=np.uint32, device=None):
        self.device = resolve_device(device)
        self.mips, self.mat_params, self.mat_tex = registry.build(self.device)
        self._compute_translucent_blocks()
        self._tables = None
        self.buffer_dtype = np.dtype(buffer_dtype)
        # the host mirror holds the full capacity; the device buffer is
        # sized to the live world and grows on demand
        if self.buffer_dtype == np.uint32:
            capacity = int(capacity_mb * 1_000_000) // 4
            capacity -= capacity % 12
            self.capacity_bytes = capacity * 4
        else:
            capacity = int(capacity_mb * 1_000_000)
            capacity -= capacity % 4
            self.capacity_bytes = capacity
        self.host_buf = np.zeros(capacity, self.buffer_dtype)
        self.device_buf = torch.zeros(12, dtype=torch.int32, device=self.device)
        self.root_ptr = 0
        self.octree_scale = np.float32(1.0)
        self.depth = 0
        self.stats = Stats(capacity_bytes=self.capacity_bytes)
        # picker memo: (buffer_version, {task bytes: results}). A batch
        # cast again against the same buffer gives the same rows, so the
        # 250 Hz physics loop, which casts the same AABB batch every step
        # while the player stands still, replays the earlier readback
        # instead of a launch and a device-to-host copy.
        self._buffer_version = 0
        self._raycast_memo = None

    # -- world upload ---------------------------------------------------------

    def _grow_device(self, needed_words: int) -> bool:
        """Ensure the device buffer holds ``needed_words`` u32 words, sized on
        the JAX package's {3/4 * 2^k, 2^k} ladder of 108-word rows (grow-only,
        ~5% headroom). Returns True when a fresh buffer was allocated (full
        re-upload required)."""
        if needed_words <= self.device_buf.shape[0]:
            return False
        rows = max((needed_words * 21 // 20) // 108 + 1, 1024)
        p = 1 << (rows - 1).bit_length()
        bucket = p if rows > (p * 3) // 4 else (p * 3) // 4
        self.device_buf = torch.zeros(bucket * 108, dtype=torch.int32,
                                      device=self.device)
        return True

    def update(self, world_svo) -> None:
        """Apply the serializer's changed ranges to the device buffer
        (reference: svo.rs:171-189)."""
        prev_state = (self.depth, self.root_ptr)
        self.depth = world_svo.depth()
        self.octree_scale = (np.float32(2.0 ** -self.depth) if self.depth
                             else np.float32(1.0))
        ranges = world_svo.write_changes_to(self.host_buf, reset=True)
        if self.buffer_dtype == np.uint32:
            from ..world.esvo import PREAMBLE_LENGTH_IN_U32

            needed = world_svo.size_in_u32() + PREAMBLE_LENGTH_IN_U32
            if self._grow_device(needed):
                ranges = [(0, needed)]  # fresh buffer: full upload
            words = self.host_buf
        else:
            if world_svo.size_in_bytes() >= MAX_STREAM_BYTES:
                raise ValueError(
                    f"CSVO stream of {world_svo.size_in_bytes()} bytes: the "
                    "traversal's ptr | depth << 27 packing holds < 128 MiB")
            self.root_ptr = int.from_bytes(bytes(self.host_buf[:4]), "little")
            # byte ranges -> word ranges of the post-prefix stream, with one
            # word of slack; a range ending inside a word takes the word
            needed = (world_svo.size_in_bytes() + 3) // 4 + 1
            if self._grow_device(needed):
                ranges = [(4, needed * 4)]
            word_ranges = []
            for start, length in ranges:
                ws = max(0, (start - 4) // 4)
                word_ranges.append((ws, (start - 4 + length + 3) // 4 + 1 - ws))
            ranges = word_ranges
            words = self.host_buf[4:].view(np.uint32)
        n = min(self.device_buf.shape[0], len(words))
        for start, length in ranges:
            end = min(start + length, n)
            if end <= start:
                continue
            chunk = torch.from_numpy(words[start:end].view(np.int32))
            self.device_buf[start:end].copy_(chunk)
        if ranges or (self.depth, self.root_ptr) != prev_state:
            self._buffer_version += 1  # invalidates the picker memo
        self.stats = Stats(used_bytes=world_svo.size_in_bytes(),
                           capacity_bytes=self.capacity_bytes,
                           depth=self.depth)

    # -- rendering --------------------------------------------------------------

    def reload_resources(self, registry) -> None:
        """Rebuild textures + materials (the reference's hot-reload path,
        svo.rs:155-168)."""
        self.mips, self.mat_params, self.mat_tex = registry.build(self.device)
        self._compute_translucent_blocks()
        self._tables = None

    def _compute_translucent_blocks(self) -> None:
        """Bitmask of block values whose face textures contain any texel
        with alpha < 1 (bit 63 = unknown/overflow values). The JAX package
        uses it to pick its opaque pipeline; kept for that later slice."""
        alpha0 = self.mips[0][..., 3].cpu().numpy()
        layer_translucent = (alpha0 < 1.0).any(axis=(1, 2))
        mat_tex = self.mat_tex.cpu().numpy()
        mask = 0
        for block in range(mat_tex.shape[0]):
            layers = mat_tex[block, 0:3]
            if any(l >= 0 and layer_translucent[l] for l in layers):
                mask |= 1 << min(block, 63)
        mask |= 1 << 63
        self.translucent_block_mask = mask

    def kernel_tables(self) -> KernelTables:
        """The kernels' view of the textures and materials (built once per
        registry)."""
        if self._tables is None:
            self._tables = KernelTables(self.mips, self.mat_tex, self.mat_params)
        return self._tables

    def frame_kwargs(self, params: RenderParams, width: int, height: int,
                     max_steps: int = 1000) -> dict:
        """``render_frame`` keyword arguments for one frame: the camera
        basis of ``params`` and its lighting, shadow and highlight inputs.
        ``render`` feeds K3 from these; the plain version takes the same."""
        from .camera import Camera

        cam = Camera(np.degrees(params.fov_y_rad), params.aspect_ratio, 0.01, 1024)
        cam.position = np.asarray(params.cam_pos, np.float32)
        cam.forward = np.asarray(params.cam_fwd, np.float32)
        cam.up = np.asarray(params.cam_up, np.float32)
        s, u, f = cam.camera_basis()
        highlight = (
            np.asarray(params.selected_voxel, np.float32)
            if params.selected_voxel is not None
            else np.full(3, np.nan, np.float32)
        )
        return dict(
            width=width, height=height,
            render_shadows=bool(params.render_shadows),
            cam_pos=cam.position, cam_right=s, cam_up=u, cam_fwd=f,
            fov_y_rad=params.fov_y_rad, aspect=params.aspect_ratio,
            ambient=params.ambient_intensity, light_dir=params.light_dir,
            shadow_distance=params.shadow_distance, highlight_pos=highlight,
            max_steps=max_steps)

    def world(self):
        """The device world as the kernels take it: the ESVO buffer, or a
        ``CsvoBuffer`` of the CSVO words, root pointer and depth."""
        if self.buffer_dtype == np.uint32:
            return self.device_buf
        return CsvoBuffer(self.device_buf, self.root_ptr, self.depth)

    def render(self, params: RenderParams, width: int, height: int,
               max_steps: int = 1000, mode: str = "fused") -> torch.Tensor:
        """Render one frame; returns an (H, W, 4) float32 tensor on the
        renderer's device (row 0 = top).

        ``mode="fused"`` — the only mode of this package so far, and its
        default — is the exact per-pixel frame with in-loop alpha judging:
        kernel K3 on the card (its CSVO instantiation for a CSVO buffer, the
        JAX package's ``mode="csvo"``), the plain version on the CPU. The
        JAX package's default, ``"deferred"`` (host-orchestrated rounds with
        beams and sun certificates), is a later slice (ROADMAP.md, queue 1,
        item 3: the deferred pipeline).
        """
        if mode != "fused":
            raise NotImplementedError(
                f"Svo.render mode={mode!r}: only 'fused' is ported (for a "
                "CSVO buffer it is the JAX mode 'csvo'); the deferred "
                "pipeline is ROADMAP.md queue 1 item 3")
        return render_frame(
            self.world(), self.octree_scale, self.mips, self.mat_params,
            self.mat_tex, **self.frame_kwargs(params, width, height, max_steps),
            tables=self.kernel_tables() if self.device.type == "cuda" else None)

    # -- picking ---------------------------------------------------------------

    def raycast(self, batch: PickerBatch, result: PickerBatchResult) -> None:
        """Run the picker over the batch (reference: svo.rs:233-255 +
        picker.glsl:30-51): K5 on the card, the plain version on the CPU.
        The batch is padded to ``1 << max(3, bit_length(n - 1))`` tasks, as
        the JAX package pads it; padding tasks have ``max_dst`` 0 and
        direction +x."""
        tasks = batch.serialize_tasks()
        n = len(tasks)
        if n == 0:
            return
        if self._raycast_memo is None or \
                self._raycast_memo[0] != self._buffer_version:
            self._raycast_memo = (self._buffer_version, {})
        memo = self._raycast_memo[1]
        key = (n, tasks.tobytes())
        hit = memo.get(key)
        if hit is None:
            n_pad = 1 << max(3, (n - 1).bit_length())
            padded = np.zeros((n_pad, 7), np.float32)
            padded[:n] = tasks
            padded[n:, 4] = 1.0  # a valid direction for the padding tasks
            rows = raycast(self.world(), self.octree_scale,
                           torch.from_numpy(padded).to(self.device))
            rows = rows.cpu().numpy()[:n]
            if len(memo) >= 16:  # bound the entries of one buffer version
                memo.clear()
            hit = (rows[:, 0], rows[:, 1] != 0, rows[:, 2:5], rows[:, 5:8])
            memo[key] = hit
        # hand out copies: result objects hold views into these arrays
        batch.deserialize_results(*(a.copy() for a in hit), result)

    def get_stats(self) -> Stats:
        return self.stats
