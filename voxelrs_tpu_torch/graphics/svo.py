"""Renderer front-end: owns the device-resident SVO buffer, material table
and texture mips; exposes ``update`` (delta upload), ``render`` (one exact
frame) and ``raycast`` (picker batches).

Counterpart: voxelrs_tpu/graphics/svo.py (``__init__`` :63-111,
``_grow_device`` :113, ``update`` :150-197 with ``world_value_mask`` :191,
``reload_resources``, ``_compute_translucent_blocks`` :207, ``render`` :224
— its default ``mode="deferred"`` :245-290 for both formats, ``"fused"``
and, for a CSVO buffer, ``"csvo"`` :292-366 — ``set_heightfield`` :413,
``render_batch`` :419-470, ``_beam_floors`` :479-521, ``raycast``
:559-589, ``get_stats``), itself
after reference: src/graphics/svo.rs:56-255. The
persistently-mapped GL buffer is an int32 torch tensor holding u32 words,
patched on exactly the ranges the serializer changed.

Two formats, by ``buffer_dtype``: ``np.uint32`` (ESVO: a u32 host mirror,
uploaded word for word) and ``np.uint8`` (CSVO: a byte host mirror
``[root_ptr u32][node bytes...]``; the device holds the node bytes after
the 4-byte prefix as words, and ``root_ptr`` rides beside it).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.adaptive import frame_levels
from ..ops.picker import PickBuffers, pick, raycast
from ..ops.shading import (DeferredWorkspace, KernelTables, check_batch,
                           render_frame, render_frame_deferred_at,
                           render_frames_opaque_batch)
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
        self.world_value_mask = ~0  # until update() reports the world's set
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
        self._pick_buffers = None  # ops.picker.PickBuffers, on the card
        # terrain envelope for the beam pre-pass (set_heightfield; None = no
        # pre-pass), and what the last frame ran: its mode, whether the
        # world was proved opaque, whether beams and a sun map fed it
        self.heightfield = None
        self.last_frame = {}
        self._workspace = None  # the deferred frame's scratch on the card
        self._batch_workspace = None  # render_batch's, for N poses

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
        self.world_value_mask = getattr(world_svo, "value_mask", ~0)
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
        with alpha < 1 (bit 63 = unknown/overflow values). When the world
        provably holds none of them (``is_opaque``), translucent casting
        degenerates to first-hit casting and the deferred frame takes its
        opaque branch."""
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

    def is_opaque(self) -> bool:
        """The world holds no block with a texel of alpha < 1 (JAX :287)."""
        return (self.world_value_mask & self.translucent_block_mask) == 0

    def set_heightfield(self, hf) -> None:
        """Attach a ``world.heightfield.HeightField``: enables the beam
        pre-pass of the deferred frame (conservative per-tile entry floors
        and, with shadows, the sun map; the frame stays bit for bit the
        same). ``None`` disables it."""
        self.heightfield = hf

    def beam_context(self, params: RenderParams, width: int, height: int,
                     shared_sun=None):
        """``ops.beams.BeamContext`` for this frame (JAX ``_beam_floors``
        :479-521): the tile floors of K7 plus the envelope, and, where
        shadows are on, the heightfield's sun map (or ``shared_sun``, a map
        already built, whose certificates are exact wherever its window
        covers). None without a heightfield, below 16x16 pixels, before
        the field holds a chunk or under ``VOXELRS_BEAMS=0``; no sun map
        is built under ``VOXELRS_SUN=0`` (``shared_sun`` is still taken),
        as in JAX; ``BeamContext.without_sun`` gives the beams alone."""
        from ..ops.beams import CELL, BeamContext, sun_margin, tile_floors
        from ..ops.shading import tan_half_fov

        if (self.heightfield is None or width < 16 or height < 16
                or os.environ.get("VOXELRS_BEAMS") == "0"):
            return None
        dev = self.heightfield.device(self.device)
        if dev is None:
            return None
        levels, offsets, n, hmax, bounds = dev[:5]
        kw = self.frame_kwargs(params, width, height)
        pos = kw["cam_pos"]
        ccx = int(np.floor(pos[0] / CELL)) - 2
        ccz = int(np.floor(pos[2] / CELL)) - 2
        near = self.heightfield.near_window(ccx + 2, ccz + 2).astype(
            np.float32)
        tf = tile_floors(levels, offsets, n, hmax, bounds, near,
                         np.array([ccx, ccz], np.float32), pos,
                         kw["cam_right"], kw["cam_up"], kw["cam_fwd"],
                         tan_half_fov(params.fov_y_rad), params.aspect_ratio,
                         -1.0, width=width, height=height)
        sun_map = shared_sun
        if (sun_map is None and params.render_shadows
                and os.environ.get("VOXELRS_SUN") != "0"):
            sun_map = self.heightfield.sun_map(params.light_dir,
                                               center=params.cam_pos,
                                               device=self.device)
        return BeamContext(tf, dev, width, height, sun=sun_map,
                           sun_margin=sun_margin(self.octree_scale))

    def render(self, params: RenderParams, width: int, height: int,
               max_steps: int = 1000, mode: str = "deferred",
               beams="auto", adaptive: bool | None = None) -> torch.Tensor:
        """Render one frame; returns an (H, W, 4) float32 tensor on the
        renderer's device (row 0 = top).

        ``mode="deferred"`` (the default, as in the JAX package) runs
        ``ops.shading.render_frame_deferred`` for either buffer format: its
        opaque branch where ``is_opaque``, else the judged one; ``beams``
        "auto" takes ``beam_context`` (the pre-pass, where a heightfield is
        attached), None runs without it, or pass a ``BeamContext``.
        ``mode="fused"`` (the JAX ``"csvo"`` for a CSVO buffer) is the
        exact per-pixel frame with in-loop alpha judging, kernel K3 (its
        CSVO instantiation for a CSVO buffer). On the card the kernels
        run; on the CPU their plain versions.

        Both branches take the adaptive thick-ray frame by the JAX rule
        (``ops.adaptive.frame_levels``: from 2^18 pixels, or as
        ``VOXELRS_ADAPTIVE``/``VOXELRS_HIERARCHY`` say): K9 on an opaque
        world, K9-judged on a translucent one (never the eighth grid);
        ``adaptive`` True / False pins it. ``last_frame`` records
        ``opaque``, ``adaptive`` and the ``hierarchy`` the frame traced (0
        the half grid, 1 the quarter grid, 2 the eighth grid; None for the
        exact frame)."""
        if mode not in ("deferred", "fused", "csvo"):
            raise ValueError(f"Svo.render: unknown mode {mode!r}")
        kw = self.frame_kwargs(params, width, height, max_steps)
        tables = self.kernel_tables() if self.device.type == "cuda" else None
        if mode != "deferred":
            self.last_frame = dict(mode="fused")
            return render_frame(self.world(), self.octree_scale, self.mips,
                                self.mat_params, self.mat_tex, **kw,
                                tables=tables)
        if isinstance(beams, str):
            if beams != "auto":
                raise ValueError(f"Svo.render: beams={beams!r}")
            beams = self.beam_context(params, width, height)
        opaque = self.is_opaque()
        levels = frame_levels(width, height, opaque, adaptive)
        self.last_frame = dict(mode="deferred", opaque=opaque,
                               beams=beams is not None,
                               sun=beams is not None and beams.has_sun(),
                               adaptive=levels > 0,
                               hierarchy=levels - 1 if levels else None)
        return render_frame_deferred_at(
            levels, self.world(), self.octree_scale, self.mips,
            self.mat_params, self.mat_tex, **kw, opaque=opaque, beams=beams,
            tables=tables, workspace=self._workspace_for("_workspace",
                                                         width * height))

    def _workspace_for(self, attr: str, lanes: int):
        """The ``DeferredWorkspace`` kept in ``attr`` for ``lanes`` lanes on
        the card (None on the CPU), the old one freed before a new one is
        allocated."""
        if self.device.type != "cuda":
            return None
        key = (lanes, self.device_buf.device)
        if getattr(self, attr) is None or getattr(self, attr).key != key:
            setattr(self, attr, None)  # free the old scratch first
            setattr(self, attr, DeferredWorkspace(*key))
        return getattr(self, attr)

    def render_batch(self, params_list, width: int, height: int,
                     max_steps: int = 1000):
        """Render a sequence of poses in one pass (JAX :419-470, the
        benchmark fly-through): ``ops.shading.render_frames_opaque_batch``
        (K10) launches each stage of the opaque frame once for all the
        poses. Returns an (N, H, W, 4) float32 tensor on the renderer's
        device, each pose's image equal to ``render`` of that pose given
        pose 0's sun map (``beam_context(shared_sun=)``), or None where the
        JAX package returns None: a CSVO buffer, a world with a translucent
        block, or beams available for pose 0 and not for every pose.

        As in JAX, every pose takes pose 0's ``fov_y_rad``,
        ``aspect_ratio``, ``ambient_intensity``, ``light_dir``,
        ``shadow_distance`` and ``render_shadows``, no block is highlighted,
        and each pose's tile floors (K7, one launch a pose) come with the
        envelope and pose 0's sun map shared. ``last_frame`` records what
        ran, as for ``render``. The JAX switch ``_fused_frame_on()``
        (``VOXELRS_FUSED_FRAME``) selects its whole-frame XLA programs and
        their plan store, which the port does not have, so it is not read:
        the batch always runs. A batch beyond
        ``ops.shading.check_batch`` (64 poses at 1080p) is refused."""
        n = len(params_list)
        check_batch(n, width, height)
        if self.buffer_dtype != np.uint32 or not self.is_opaque():
            return None
        ctxs = []
        for i, p in enumerate(params_list):
            ctxs.append(self.beam_context(
                p, width, height,
                shared_sun=ctxs[0]._sun if i and ctxs[0] is not None
                else None))
        beams0 = ctxs[0]
        if beams0 is not None and any(c is None for c in ctxs):
            return None  # mixed beam availability (JAX :456-457)
        kws = [self.frame_kwargs(p, width, height, max_steps)
               for p in params_list]
        kw0 = kws[0]
        cam_stack = tuple(np.stack([kw[k] for kw in kws]) for k in (
            "cam_pos", "cam_right", "cam_up", "cam_fwd"))
        levels = frame_levels(width, height, True)
        self.last_frame = dict(mode="batch", poses=n, opaque=True,
                               beams=beams0 is not None,
                               sun=beams0 is not None and beams0.has_sun(),
                               adaptive=levels > 0,
                               hierarchy=levels - 1 if levels else None)
        return render_frames_opaque_batch(
            self.world(), self.octree_scale, self.mips, self.mat_params,
            self.mat_tex, cam_stack, kw0["fov_y_rad"], kw0["aspect"],
            kw0["ambient"], kw0["light_dir"], kw0["shadow_distance"],
            np.full(3, np.nan, np.float32), width=width, height=height,
            render_shadows=kw0["render_shadows"], max_steps=max_steps,
            beams_shared=beams0,
            t_floor_stack=(None if beams0 is None else torch.stack(
                [c.tile_floors for c in ctxs])),
            tables=self.kernel_tables() if self.device.type == "cuda"
            else None,
            workspace=self._workspace_for("_batch_workspace",
                                          n * width * height))

    # -- picking ---------------------------------------------------------------

    def raycast(self, batch: PickerBatch, result: PickerBatchResult) -> None:
        """Run the picker over the batch (reference: svo.rs:233-255 +
        picker.glsl:30-51): on the card one native call (``ops.picker.
        pick``: the upload from pinned memory, K5 and the rows' copy back,
        holding the interpreter lock), the plain version on the CPU. The
        batch is padded to ``1 << max(3, bit_length(n - 1))`` tasks, as the
        JAX package pads it; padding tasks have ``max_dst`` 0 and
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
            if self.device.type == "cuda":
                if self._pick_buffers is None:
                    self._pick_buffers = PickBuffers(self.device_buf.device)
                rows = pick(self.world(), self.octree_scale, padded,
                            self._pick_buffers)[:n]
            else:
                rows = raycast(self.world(), self.octree_scale,
                               torch.from_numpy(padded)).numpy()[:n]
            if len(memo) >= 16:  # bound the entries of one buffer version
                memo.clear()
            hit = (rows[:, 0], rows[:, 1] != 0, rows[:, 2:5], rows[:, 5:8])
            memo[key] = hit
        # hand out copies: result objects hold views into these arrays
        batch.deserialize_results(*(a.copy() for a in hit), result)

    def get_stats(self) -> Stats:
        return self.stats
