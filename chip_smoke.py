#!/usr/bin/env python3
"""Smoke run of voxelrs_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the kernels (one nvcc call), builds the procedural scene of
``bench.py`` (8x8 chunk columns, distance-banded LOD), drives the renderer's
path (``Svo.update``, then per pose a full-frame ``intersect_octree`` ray
query and ``Svo.render``), holds each kernel against its plain PyTorch
version on the card, checks a small frame against
``tests/goldens/render_basic.npy``, and times the 1080p frame with CUDA
events. Then it drives the game loop's path: ``Game(GameArgs())`` at its
defaults (render distance 20, 1920x1080, shadows, the procedural world)
loads its world and plays a scripted run of about 120 frames — flying
across chunk boundaries (chunks unload, load and change LOD), falling to
the ground, breaking and placing a block — then holds K5 against its plain
version on every picker batch of that run, K3 against the plain frame on the
streamed buffer, and times the frame loop and K5. Every phase prints its
seconds.

Tolerances: K1 against its plain version — every field of every ray
equal (torch.equal); K5 — every column of every task equal; K3 against the plain frame — max |d| <= 1e-6 over all
pixels and channels; the golden frame — mean |d| < 0.015, the repository's
image budget. Both kernels run the same IEEE float32 operations as their
plain versions in the same order (built with -fmad=false); H100 runs
measured no difference at all, and the 1e-6 leaves room only for a last-bit
rounding of powf/acosf, not for a wrong pixel.

Times: ``ms`` of a kernel is the kernel alone — its inputs prepared
beforehand, KERNEL_REPS launches back to back between two CUDA events —
and the host time of its Python wrapper is printed apart. The frame time
is CUDA events around ``Svo.render``, i.e. from the call to the finished
frame, host work included. The game's frame time is the host clock around
``Game.step_frame`` and a ``torch.cuda.synchronize()``: streaming, the look
ray, physics and the 1080p frame.

Exits non-zero, printing no result, when no CUDA device is present or a
phase fails. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

W, H = 1920, 1080
POSES = 5
REPS = 5
KERNEL_REPS = 20
HOST_REPS = 50
K3_MAX_ABS = 1e-6
BUDGET_S = 600  # this script's own wall-clock budget on one H100
# the game phase: GameArgs() defaults; its scripted run (frames at 1/60 s)
GAME_RENDER_DISTANCE = 20
FLY_FRAMES = 84  # forward at 60 blocks/s: three chunk boundaries
DESCEND_FRAMES = 36  # the last frames of the flight also descend
FALL_FRAMES = 60  # at most, until the player lands
EDIT_WAIT_FRAMES = 30  # at most, for the broken block's chunk to upload
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations per traversal step, counted from the step's arithmetic in
# csrc/k1_traversal.cuh (plane distances, centre tests, position updates,
# min/max); integer work and loads are not counted, so the bound is low
OPS_PER_STEP = 30
# bytes a traversal step reads (one 4-byte descriptor word)
BYTES_PER_STEP = 4
# float operations of K3 per pixel outside the traversal (raygen, sampling,
# normal mapping, lighting, sky), counted from csrc/kernels.cu
OPS_PER_PIXEL = 150


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints the seconds a phase took."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        log(f"phase {self.name}: {self.seconds:.2f} s")
        return False


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build_world(radius: int = 4):
    """bench.py::build_world with this package's own worldgen."""
    from voxelrs_tpu_torch.gamelogic.worldgen import Generator, default_config
    from voxelrs_tpu_torch.systems.chunkloader import ChunkLoader
    from voxelrs_tpu_torch.world.chunk import Chunk, ChunkPos
    from voxelrs_tpu_torch.world.esvo import Esvo, SerializedChunk
    from voxelrs_tpu_torch.world.octree import Position

    gen = Generator(1, default_config())
    svo = Esvo()
    center = ChunkPos(radius, 2, radius)
    count = 0
    for cx in range(radius * 2):
        for cz in range(radius * 2):
            col = gen.get_column(cx, cz)
            lod = ChunkLoader.calculate_lod(center, ChunkPos(cx, 0, cz))
            for cy in range(0, 8):
                if not col.contains_chunk(cy):
                    continue
                chunk = Chunk(ChunkPos(cx, cy, cz))
                gen.generate_chunk(chunk)
                sc = SerializedChunk.from_voxels(chunk.pos, chunk.voxels, lod)
                if not sc.has_data():
                    continue
                svo.set_leaf(Position(cx, cy, cz), sc, True)
                count += 1
    svo.serialize()
    return svo, count


def bench_poses():
    """The 5 camera poses of bench.py::_scene_procedural."""
    import numpy as np

    from voxelrs_tpu_torch.graphics.svo import RenderParams

    fwd = np.array([0.55, -0.35, 0.76], np.float32)
    fwd /= np.linalg.norm(fwd)
    base = RenderParams(cam_pos=np.array([16.0, 95.0, -20.0], np.float32),
                        cam_fwd=fwd, aspect_ratio=W / H,
                        fov_y_rad=np.radians(80.0), render_shadows=True,
                        shadow_distance=300.0)
    poses = []
    for i in range(POSES):
        p = RenderParams(**{**base.__dict__})
        p.cam_pos = base.cam_pos + np.array([2.0 * i, 0.0, 1.5 * i], np.float32)
        poses.append(p)
    return poses


def primary_rays(svo, p):
    """Pose ``p``'s primary rays on the card (ops.shading.generate_rays)."""
    import numpy as np
    import torch

    from voxelrs_tpu_torch.ops.shading import generate_rays, tan_half_fov

    kw = svo.frame_kwargs(p, W, H)

    def vec(name):
        return torch.as_tensor(np.asarray(kw[name], np.float32),
                               device=svo.device)

    return generate_rays(W, H, vec("cam_pos"), vec("cam_right"),
                         vec("cam_up"), vec("cam_fwd"),
                         tan_half_fov(kw["fov_y_rad"]),
                         float(np.float32(kw["aspect"])))


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_ms(launch) -> float:
    """Milliseconds of one kernel launch: one warm-up launch, then
    KERNEL_REPS launches back to back between two CUDA events. The first
    event is queued behind the warm-up, so the host time of the launches
    overlaps the card's work and is not counted."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    launch()
    a.record()
    for _ in range(KERNEL_REPS):
        launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / KERNEL_REPS


def host_us(fn) -> float:
    """Median host microseconds of one call of ``fn`` (no synchronisation
    between calls: the wrapper's own work, not the card's)."""
    import torch

    torch.cuda.synchronize()
    times = []
    for _ in range(HOST_REPS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def golden_check(repo: str) -> float:
    """Mean |d| of the one-chunk test scene (tests/test_render.py) rendered
    by K3 against the repository's golden frame."""
    import numpy as np

    from voxelrs_tpu_torch.gamelogic.content import GRASS, STONE, new_registry
    from voxelrs_tpu_torch.graphics.svo import RenderParams, Svo
    from voxelrs_tpu_torch.world import ChunkPos, Position
    from voxelrs_tpu_torch.world.esvo import Esvo, SerializedChunk

    vox = np.zeros((32, 32, 32), np.uint32)
    vox[:, :8, :] = STONE
    vox[:, 8, :] = GRASS
    vox[10:14, 9:12, 10:14] = STONE
    world = Esvo()
    world.set_leaf(Position(0, 0, 0),
                   SerializedChunk.from_voxels(ChunkPos(0, 0, 0), vox, 5), True)
    world.serialize()
    svo = Svo(new_registry(), capacity_mb=4, device="cuda")
    svo.update(world)
    fwd = np.array([0.5, -0.5, 0.7], np.float32)
    fwd /= np.linalg.norm(fwd)
    p = RenderParams(cam_pos=np.array([2.0, 20.0, -4.0], np.float32),
                     cam_fwd=fwd, aspect_ratio=128 / 96,
                     fov_y_rad=np.radians(70.0), render_shadows=True,
                     shadow_distance=100.0, ambient_intensity=0.3)
    img = svo.render(p, 128, 96, max_steps=300).cpu().numpy()
    golden = np.load(os.path.join(repo, "tests", "goldens", "render_basic.npy"))
    return float(np.abs(img.astype(np.float64) - golden).mean())

class PickerRecorder:
    """Stands in for ``ops.picker.raycast`` inside ``graphics.svo``: calls
    it, and keeps each batch, its K5 rows and the buffer it was cast on (one
    device copy per buffer state), for the comparison after the run."""

    def __init__(self, raycast):
        self.raycast = raycast
        self.buffers = {}  # (address, version, words) -> buffer copy
        self.batches = []  # (buffer key, octree_scale, tasks, rows)

    def __call__(self, desc, octree_scale, tasks):
        rows = self.raycast(desc, octree_scale, tasks)
        key = (desc.data_ptr(), desc._version, desc.numel())
        if key not in self.buffers:
            self.buffers[key] = desc.clone()
        self.batches.append((key, octree_scale, tasks.clone(), rows.clone()))
        return rows


def play_game(game, recorder):
    """Load the game's world, then play the scripted run with ``recorder``
    in place of the picker's kernel call. Returns the run's numbers."""
    import math

    import torch

    from voxelrs_tpu_torch.gamelogic import content
    from voxelrs_tpu_torch.ops import picker

    out = {}
    with Phase("game load") as ph:
        loaded = game.wait_for_world(timeout=BUDGET_S / 3)
    out["load_s"] = ph.seconds
    stats = game.world.world_svo.get_stats()
    out.update(chunks=len(game.world.world.chunks),
               svo_leaves=len(game.world.world_svo.leaf_ids),
               svo_mb=stats.used_bytes / 1e6, depth=stats.depth)
    log(f"game load: {out['load_s']:.2f} s (wait_for_world, loaded "
        f"{loaded}); {out['chunks']} chunks, {out['svo_leaves']} SVO "
        f"leaves, {out['svo_mb']:.2f} MB SVO, depth {out['depth']}, device "
        f"buffer {game.world.world_svo.graphics_svo.device_buf.numel()} words")
    if not loaded:
        raise RuntimeError("the world did not finish loading")

    world, player, inp = game.world, game.player, game.input
    frame_s = []
    # the frame's spans: host clock around each, the render's ending in a
    # synchronize (the frame's own synchronize follows it anyway)
    spans = {"streaming": [], "look ray": [], "physics": [], "render": []}
    timed = [(world, "update", "streaming", False),
             (game.gameplay, "update_look_ray", "look ray", False),
             (world, "update_fixed", "physics", False),
             (world, "render", "render", True)]

    def span(name, fn, sync):
        def run(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            spans[name].append(time.perf_counter() - t0)
            return r
        return run

    by_part = {}  # part of the run -> [(frame s, {span: s}, busy jobs)]

    def frame(part):
        """One frame, timed from the call to the finished frame, then paced
        to 60 Hz as a display paces the game: the job threads stream chunks
        in the rest of the 1/60 s (the pause is not in the frame time)."""
        n0 = {k: len(v) for k, v in spans.items()}
        busy = game.job_system.len()  # queued + running jobs
        t0 = time.perf_counter()
        img = game.step_frame(dt=1 / 60, render=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame_s.append(t1 - t0)
        by_part.setdefault(part, []).append(
            (t1 - t0, {k: sum(v[n0[k]:]) for k, v in spans.items()}, busy))
        time.sleep(max(0.0, 1 / 60 - (t1 - t0)))
        return img

    for obj, attr, name, sync in timed:
        setattr(obj, attr, span(name, getattr(obj, attr), sync))
    svo_mod = sys.modules["voxelrs_tpu_torch.graphics.svo"]
    svo_mod.raycast = recorder
    k5_0 = picker.launches
    try:
        with Phase("game run") as ph:
            start = player.position.copy()
            for i in range(FLY_FRAMES):
                inp.keys_down = {"w"} | (
                    {"shift"} if i >= FLY_FRAMES - DESCEND_FRAMES else set())
                img = frame("fly")
            inp.keys_down = set()
            inp.keys_pressed = {"f"}  # flying off: the player falls
            for _ in range(FALL_FRAMES):
                img = frame("fall")
                if player.state.is_grounded:
                    break
            landed = bool(player.state.is_grounded)
            out["flown"] = [float(v) for v in player.position - start]
            # break and place through the look ray, 45 degrees down ahead
            player.euler_rotation[0] = -math.pi / 4
            frame("edit")
            hit = game.gameplay.looking_at
            if hit is None:
                raise RuntimeError("the look ray hits nothing after landing")
            cell = tuple(int(math.floor(v)) for v in hit.pos)
            before = world.world.get_block(*cell)
            inp.buttons_pressed = {1}
            frame("edit")
            broken = world.world.get_block(*cell)
            for _ in range(EDIT_WAIT_FRAMES):
                frame("edit")
                if not (world.world.has_changed_chunks()
                        or world.world_svo.has_pending_jobs()):
                    break
            hit = game.gameplay.looking_at
            target = tuple(int(math.floor(v))
                           for v in hit.pos + hit.normal)
            placed_before = world.world.get_block(*target)
            inp.buttons_pressed = {2}
            img = frame("edit")
            placed = world.world.get_block(*target)
    finally:
        for obj, attr, _, _ in timed:
            delattr(obj, attr)  # the class's method again
        svo_mod.raycast = recorder.raycast
    out["run_s"] = ph.seconds
    out["frames"] = len(frame_s)
    out["k5_per_frame"] = (picker.launches - k5_0) / len(frame_s)
    out["landed"] = landed
    out["edit"] = dict(cell=cell, before=int(before), broken=int(broken),
                       placed_cell=target, placed_before=int(placed_before),
                       placed=int(placed))
    out["edit_ok"] = (before != content.AIR and broken == content.AIR
                      and placed_before == content.AIR
                      and placed == game.gameplay.selected_block)
    fs = sorted(frame_s)
    out["frame_ms_median"] = fs[len(fs) // 2] * 1e3
    # p90 is the highest percentile with ten frames beyond it; p99 has one
    out["frame_ms_p90"] = fs[int(0.9 * len(fs))] * 1e3
    out["frame_ms_p99"] = fs[min(len(fs) - 1, int(0.99 * len(fs)))] * 1e3
    out["frame_ms_max"] = fs[-1] * 1e3
    total = sum(frame_s)
    out["share"] = {k: sum(v) / total for k, v in spans.items()}
    out["ms_per_frame"] = {k: sum(v) / len(frame_s) * 1e3
                           for k, v in spans.items()}
    out["physics_steps"] = len(spans["physics"])

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    out["parts"] = {part: dict(
        frames=len(rows), frame_ms_median=med([r[0] for r in rows]) * 1e3,
        busy_jobs_median=med([r[2] for r in rows]),
        span_ms_median={k: med([r[1][k] for r in rows]) * 1e3
                        for k in spans}) for part, rows in by_part.items()}
    out["final_img_ok"] = (tuple(img.shape) == (game.args.height, game.args.width, 4)
                           and bool(torch.isfinite(img).all()))
    log(f"game run: {out['frames']} frames flown {out['flown']}, landed "
        f"{landed}, edit {out['edit']} ok {out['edit_ok']}")
    log(f"game frame (step_frame + synchronize, {game.args.width}x"
        f"{game.args.height}): median "
        f"{out['frame_ms_median']:.3f} ms, p90 {out['frame_ms_p90']:.3f} ms, "
        f"p99 {out['frame_ms_p99']:.3f} ms, "
        f"max {out['frame_ms_max']:.3f} ms; K5 {out['k5_per_frame']:.2f} "
        f"launches/frame, {out['physics_steps']} physics steps")
    log("game frame spans, share of frame time (mean ms a frame): " + ", ".join(
        f"{k} {out['share'][k]:.3f} ({out['ms_per_frame'][k]:.3f})"
        for k in spans))
    for part, d in out["parts"].items():
        log(f"  {part}: {d['frames']} frames, median {d['frame_ms_median']:.3f}"
            f" ms, job queue median {d['busy_jobs_median']}, span medians (ms)"
            f" " + ", ".join(f"{k} {v:.3f}" for k, v in
                               d["span_ms_median"].items()))
    return out


def check_game(game, recorder, card):
    """K5 against its plain version on every recorded batch, K3 against the
    plain frame on the streamed buffer, and K5's timing."""
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import picker, shading
    from voxelrs_tpu_torch.ops.traversal import MAX_STEPS, step_budget

    out = {}
    with Phase("k5 vs plain"):
        by_buffer = {}
        for key, scale, tasks, rows in recorder.batches:
            by_buffer.setdefault((key, scale), []).append((tasks, rows))
        bad = 0
        k5_err = 0.0
        for (key, scale), items in by_buffer.items():
            tasks = torch.cat([t for t, _ in items])
            rows = torch.cat([r for _, r in items])
            ref = picker.raycast_plain(recorder.buffers[key], scale, tasks)
            bad += int((rows != ref).any(1).sum())
            k5_err = max(k5_err, float((rows - ref).abs().max()))
    n_tasks = sum(t.shape[0] for _, _, t, _ in recorder.batches)
    out.update(k5_batches=len(recorder.batches), k5_tasks=n_tasks,
               k5_buffers=len(recorder.buffers), k5_bad=bad, k5_err=k5_err,
               k5_ok=bad == 0 and len(recorder.batches) > 0)
    log(f"k5 vs plain: {len(recorder.batches)} batches, {n_tasks} tasks, "
        f"{len(recorder.buffers)} buffer states; tasks differing {bad}, "
        f"max |d| {k5_err:.3g}; ok {out['k5_ok']}")

    gsvo = game.world.world_svo.graphics_svo
    desc, scale = gsvo.device_buf, float(gsvo.octree_scale)
    with Phase("k3 vs plain (streamed world)"):
        world = game.world
        kw = gsvo.frame_kwargs(
            world.world_svo.svo_params(world.render_params(W / H)), W, H)
        img = shading.render_frame(desc, scale, gsvo.mips, gsvo.mat_params,
                                   gsvo.mat_tex, **kw,
                                   tables=gsvo.kernel_tables())
        ref = shading.render_frame_plain(desc, scale, gsvo.mips,
                                         gsvo.mat_params, gsvo.mat_tex, **kw)
        d = float((img - ref).abs().max())
    out["k3_game_err"] = d
    out["k3_game_ok"] = d <= K3_MAX_ABS
    log(f"k3 vs plain on the streamed buffer (final pose): max |d| {d:.3g} "
        f"(tolerance {K3_MAX_ABS:g}); ok {out['k3_game_ok']}")

    with Phase("k5 timing"):
        # the last AABB sweep of the run, on the final buffer
        tasks = next(t for _, _, t, _ in reversed(recorder.batches)
                     if t.shape[0] >= 32)
        n = tasks.shape[0]
        rows = torch.empty((n, 8), dtype=torch.float32, device=desc.device)
        steps = torch.empty(n, dtype=torch.int32, device=desc.device)
        budget = step_budget(MAX_STEPS)
        _build.launch_k5(desc, scale, tasks, budget, rows, steps)
        k5_steps = int(steps.sum())
        k5_ms = kernel_ms(lambda: _build.launch_k5(desc, scale, tasks,
                                                   budget, rows))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        picker.raycast_plain(desc, scale, tasks)
        b.record()
        b.synchronize()
        k5_plain_ms = a.elapsed_time(b)
        k5_host = host_us(lambda: picker.raycast(desc, scale, tasks))
        # the physics step's picker call (the world's Svo.raycast) with the
        # memo cleared: coordinates, upload, launch, copy back
        from voxelrs_tpu_torch.graphics.picker import (Aabb, PickerBatch,
                                                       PickerBatchResult)

        times = []
        for _ in range(HOST_REPS):
            batch = PickerBatch()  # world_svo.raycast moves it to SVO space
            batch.add_aabb(Aabb.new(game.player.position,
                                    game.player.aabb_def.offset,
                                    game.player.aabb_def.extents))
            gsvo._raycast_memo = None
            t0 = time.perf_counter()
            game.world.world_svo.raycast(batch, PickerBatchResult())
            times.append((time.perf_counter() - t0) * 1e6)
        times.sort()
        round_trip_us = times[len(times) // 2]
    k5_bytes = n * (28 + 32) + k5_steps * BYTES_PER_STEP
    k5_bound = bound(k5_bytes, k5_steps * OPS_PER_STEP)
    out.update(k5_ms=k5_ms, k5_plain_ms=k5_plain_ms, k5_host_us=k5_host,
               k5_round_trip_us=round_trip_us, k5_bound=k5_bound,
               k5_steps=k5_steps, k5_n=n)
    log(f"k5 alone ({n} tasks, {k5_steps} steps, {KERNEL_REPS} back-to-back "
        f"launches): {k5_ms:.4f} ms; plain {k5_plain_ms:.1f} ms; wrapper "
        f"host time {k5_host:.1f} us; Svo.raycast round trip (upload, "
        f"launch, copy back) {round_trip_us:.1f} us; bound "
        f"{k5_bound[0]:.3g} ms ({k5_bound[1]}) on {card}")
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.gamelogic.content import new_registry
    from voxelrs_tpu_torch.graphics.svo import Svo
    from voxelrs_tpu_torch.ops import shading, traversal
    from voxelrs_tpu_torch.ops.traversal import TraversalResult

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 1. build ----------------------------------------------------------
    with Phase("build"):
        _build.library()
    log(f"build: {_build.build_seconds:.2f} s (one nvcc call)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 2. world ----------------------------------------------------------
    with Phase("world"):
        world, chunks = build_world()
        svo = Svo(new_registry(), capacity_mb=64, device="cuda")
        svo.update(world)
    log(f"world: {chunks} chunks, depth {svo.depth}, "
        f"{svo.stats.used_bytes / 1e6:.2f} MB SVO, device buffer "
        f"{svo.device_buf.shape[0]} words")
    poses = bench_poses()
    desc, scale = svo.device_buf, float(svo.octree_scale)
    alpha = shading.make_alpha_fn(svo.mips, svo.mat_tex)

    # ---- 3. the main path: counts from 0, one query + one frame per pose --
    with Phase("main path"):
        traversal.launches = 0
        shading.launches = 0
        frames = []
        for p in poses:
            ro, rd = primary_rays(svo, p)
            hits = traversal.intersect_octree(desc, scale, ro, rd, -1.0, True,
                                              alpha_fn=alpha)
            frames.append(svo.render(p, W, H))
        torch.cuda.synchronize()
        k1_main, k3_main = traversal.launches, shading.launches
    log(f"main path launches: k1_traversal {k1_main}, k3_frame {k3_main}")
    if k1_main == 0 or k3_main == 0:
        fail("a kernel of the main path was not launched")
    for img in frames:
        if tuple(img.shape) != (H, W, 4) or not bool(torch.isfinite(img).all()):
            fail("frame has the wrong shape or non-finite values")
        if float(img.min()) < 0.0 or float(img.max()) > 1.0 + 1e-5:
            fail("frame values outside [0, 1]")
    hit_share = float((hits.t >= 0).float().mean())
    sky_share = float((frames[0][..., 2] > 0.7).float().mean())
    log(f"pose 4 primary hit share {hit_share:.4f}; pose 0 sky-blue share "
        f"{sky_share:.4f}")
    if not 0.05 < hit_share < 0.999:
        fail("the query hits too little or too much of the frame")

    # ---- 4. K1 against its plain version (pose 0 primary rays) -----------
    with Phase("k1 vs plain"):
        ro, rd = primary_rays(svo, poses[0])
        k1 = traversal.intersect_octree(desc, scale, ro, rd, -1.0, True,
                                        alpha_fn=alpha)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = traversal.intersect_octree_plain(desc, scale, ro, rd, -1.0,
                                               True, alpha)
        b.record()
        b.synchronize()
        k1_plain_ms = a.elapsed_time(b)
    B = ro.shape[0]
    fields = TraversalResult._fields
    diff = {f: int((getattr(k1, f) != getattr(ref, f)).reshape(B, -1)
                   .any(-1).sum())
            for f in fields}
    k1_err = max(float((getattr(k1, f) - getattr(ref, f)).abs().max())
                 for f in ("t", "pos", "uv", "lod"))
    k1_ok = all(torch.equal(getattr(k1, f), getattr(ref, f)) for f in fields)
    log(f"k1 vs plain: rays differing per field {json.dumps(diff)}; "
        f"max |d| over t/pos/uv/lod {k1_err:.3g}; "
        f"plain {k1_plain_ms:.1f} ms; ok {k1_ok} (every field equal)")
    k1_steps = int(k1.steps.sum())
    if not k1_ok:
        fail("K1 disagrees with its plain version")

    # ---- 5. K3 against the plain frame (pose 0, shadows, 1000 steps) -----
    with Phase("k3 vs plain"):
        p = poses[0]
        img = svo.render(p, W, H, max_steps=1000)
        kw = svo.frame_kwargs(p, W, H, max_steps=1000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref_img = shading.render_frame_plain(
            desc, svo.octree_scale, svo.mips, svo.mat_params, svo.mat_tex,
            **kw)
        b.record()
        b.synchronize()
        k3_plain_ms = a.elapsed_time(b)
    d = (img - ref_img).abs()
    k3_mean, k3_max = float(d.mean()), float(d.max())
    k3_bad = int((d.amax(-1) > 1e-3).sum())
    k3_ok = k3_max <= K3_MAX_ABS
    log(f"k3 vs plain: mean |d| {k3_mean:.3g}, max |d| {k3_max:.3g} "
        f"(tolerance {K3_MAX_ABS:g}), pixels > 1e-3: {k3_bad}; "
        f"plain {k3_plain_ms:.1f} ms; ok {k3_ok}")
    if not k3_ok:
        fail("K3 disagrees with the plain frame")

    # ---- 6. small frame against the repository's golden -------------------
    with Phase("golden"):
        gd = golden_check(repo)
    log(f"golden render_basic.npy: mean |d| {gd:.5f} (budget 0.015)")
    if not gd < 0.015:
        fail("golden frame over budget")

    # ---- 7. timing ---------------------------------------------------------
    with Phase("timing"):
        for p in poses:  # warm-up
            svo.render(p, W, H)
        frame_ms = []
        for p in poses:
            frame_ms.append(cuda_ms(lambda: svo.render(p, W, H), REPS))
        frame_ms.sort()
        med_ms = frame_ms[len(frame_ms) // 2]
        # the kernels alone, on pose 0, from inputs prepared beforehand
        dev = desc.device
        ro, rd = primary_rays(svo, poses[0])
        md = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
        k1_out = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in (
            (B, torch.float32), (B, torch.int32), (B, torch.int32),
            ((B, 3), torch.float32), ((B, 2), torch.float32),
            (B, torch.float32), (B, torch.bool), (B, torch.int32))]
        budget = traversal.step_budget(traversal.MAX_STEPS)
        k1_ms = kernel_ms(lambda: _build.launch_k1(
            desc, scale, ro, rd, md, budget, 1, alpha.tables, *k1_out))
        fp = shading.frame_params(mip_mode=shading.mip_mode_from_env(),
                                  **svo.frame_kwargs(poses[0], W, H))
        tables = svo.kernel_tables()
        k3_img = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
        k3_ms = kernel_ms(lambda: _build.launch_k3(desc, scale, tables, fp,
                                                   k3_img))
        steps3 = torch.empty(W * H, dtype=torch.int32, device=dev)
        _build.launch_k3(desc, scale, tables, fp, k3_img, steps3)
        k3_steps = int(steps3.sum())
        # the wrappers' host time around those launches
        k1_host = host_us(lambda: traversal.intersect_octree(
            desc, scale, ro, rd, -1.0, True, alpha_fn=alpha))
        k3_host = host_us(lambda: svo.render(poses[0], W, H))
    mrays = W * H * 2 / (med_ms / 1e3) / 1e6
    log(f"frame 1080p (Svo.render, fused, K3; events from call to finished "
        f"frame): median {med_ms:.3f} ms/frame over {POSES} poses x {REPS} "
        f"runs, per-pose medians {[round(x, 3) for x in frame_ms]}; "
        f"{mrays:.2f} Mrays/s (primary + shadow, W*H*2/dt) on {card}")
    log(f"kernels alone (pose 0, {KERNEL_REPS} back-to-back launches): "
        f"k1 {k1_ms:.4f} ms, k3 {k3_ms:.4f} ms; wrapper host time "
        f"(median of {HOST_REPS} calls): intersect_octree {k1_host:.1f} us, "
        f"Svo.render {k3_host:.1f} us")

    # ---- 8. the game loop's path: counts from 0, load + scripted run ------
    from voxelrs_tpu_torch.gamelogic.game import Game, GameArgs
    from voxelrs_tpu_torch.ops import picker

    recorder = PickerRecorder(picker.raycast)
    traversal.launches = shading.launches = picker.launches = 0
    game = Game(GameArgs(render_distance=GAME_RENDER_DISTANCE))
    try:
        g = play_game(game, recorder)
        torch.cuda.synchronize()
        k5_game, k3_game = picker.launches, shading.launches
        log(f"game path launches: k5_picker {k5_game}, k3_frame {k3_game} "
            f"(k1_traversal {traversal.launches}: not on this path)")
        if k5_game == 0 or k3_game == 0:
            fail("a kernel of the game's path was not launched")
        if not g["final_img_ok"]:
            fail("the game's frame has the wrong shape or non-finite values")
        if not g["landed"]:
            fail("the player did not land")
        if not g["edit_ok"]:
            fail("breaking and placing a block did not change the voxel")
        c = check_game(game, recorder, card)
    finally:
        game.shutdown()
    del recorder  # the buffer copies
    if not c["k5_ok"]:
        fail("K5 disagrees with its plain version")
    if not c["k3_game_ok"]:
        fail("K3 disagrees with the plain frame on the streamed buffer")

    # ---- bounds: the least time the card could take for the same work -----
    tex_bytes = sum(m.numel() * 4 for m in svo.mips)
    k1_bytes = desc.numel() * 4 + tex_bytes + B * (24 + 4) + B * 41
    k3_bytes = desc.numel() * 4 + tex_bytes + W * H * 16
    k1_bound = bound(k1_bytes, k1_steps * OPS_PER_STEP)
    k3_bound = bound(k3_bytes, k3_steps * OPS_PER_STEP + W * H * OPS_PER_PIXEL)
    log(f"k1 steps {k1_steps} ({k1_steps / B:.1f}/ray), k3 steps {k3_steps} "
        f"({k3_steps / (W * H):.1f}/pixel, primary + shadow)")
    kernels = [
        dict(name="k1_traversal", route="cuda",
             source="voxelrs_tpu_torch/csrc/k1_traversal.cuh",
             replaces="voxelrs_tpu/ops/traversal.py:1087", launches=k1_main,
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=None,
             ok=k1_ok, rays_differing=diff, wrapper_host_us=k1_host),
        dict(name="k3_frame", route="cuda",
             source="voxelrs_tpu_torch/csrc/kernels.cu",
             replaces="voxelrs_tpu/ops/shading.py:4067", launches=k3_main,
             max_abs_err=k3_max, ms=k3_ms, plain_ms=k3_plain_ms,
             bound_ms=k3_bound[0], bound_by=k3_bound[1], library_ms=None,
             ok=k3_ok and c["k3_game_ok"], mean_abs_err=k3_mean,
             pixels_over_1e3=k3_bad, wrapper_host_us=k3_host,
             launches_game=k3_game, max_abs_err_game=c["k3_game_err"]),
        dict(name="k5_picker", route="cuda",
             source="voxelrs_tpu_torch/csrc/kernels.cu",
             replaces="voxelrs_tpu/graphics/svo.py:526", launches=k5_game,
             max_abs_err=c["k5_err"], ms=c["k5_ms"],
             plain_ms=c["k5_plain_ms"], bound_ms=c["k5_bound"][0],
             bound_by=c["k5_bound"][1], library_ms=None, ok=c["k5_ok"],
             tasks=c["k5_n"], steps=c["k5_steps"],
             batches_checked=c["k5_batches"],
             launches_per_frame=g["k5_per_frame"],
             wrapper_host_us=c["k5_host_us"],
             svo_raycast_round_trip_us=c["k5_round_trip_us"]),
    ]
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s (budget {BUDGET_S} s)")
    log(json.dumps({"frame_ms": med_ms, "mrays_per_s": mrays, "card": card,
                    "build_s": _build.build_seconds, "total_s": total,
                    "game": {k: g[k] for k in (
                        "load_s", "chunks", "svo_leaves", "svo_mb", "depth",
                        "frames", "frame_ms_median", "frame_ms_p90",
                        "frame_ms_p99",
                        "frame_ms_max", "share", "ms_per_frame",
                        "k5_per_frame", "physics_steps", "parts",
                        "run_s")}}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bound(n_bytes: int, n_ops: int):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and float operations over the fp32 peak."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


if __name__ == "__main__":
    sys.exit(main())
