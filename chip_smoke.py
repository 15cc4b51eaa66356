#!/usr/bin/env python3
"""Smoke run of voxelrs_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the kernels (one nvcc call) and the native chunk serializers (g++;
the run fails if they do not load), builds the procedural scene of
``bench.py`` (8x8 chunk columns, distance-banded LOD) in both formats, ESVO
and CSVO, drives the renderer's path (``Svo.update``, then per pose a
full-frame ``intersect_octree`` ray query and ``Svo.render``), holds each
kernel against its plain PyTorch version on the card, checks a small frame
against ``tests/goldens/render_basic.npy``, and times the 1080p frame with
CUDA events. It drives the CSVO renderer's path the same way (K4 ray
queries, K3's CSVO instantiation), holds K4 against its plain version and
against K1 on the ESVO buffer of the same scene, and K3-CSVO against the
plain CSVO frame and the ESVO frame. Then it drives the game loop's path,
once per format: ``Game(GameArgs())`` at its defaults (render distance 20,
1920x1080, shadows, the procedural world; ``svo_format="csvo"`` the second
time) loads its world and plays a scripted run of about 120 frames —
flying across chunk boundaries (chunks unload, load and change LOD),
falling to the ground, breaking and placing a block — then holds K5
against its plain version on every picker batch of that run, K3 against
the plain frame on the streamed buffer, and times the world load (with the
job threads' ``serialize_chunk`` time a chunk), the frame loop and K5.
Every phase prints its seconds.

Tolerances: K1 and K4 against their plain versions — every field of every
ray equal (torch.equal); K4 against K1 on the same scene — value, face_id
and inside equal, t within 1e-3 (tests/test_torch_csvo.py); K5 — every
column of every task equal; K3 against the plain frame — max |d| <= 1e-6
over all pixels and channels; the golden frame and the CSVO frame against
the ESVO one — mean |d| < 0.015, the repository's image budget. Both kernels run the same IEEE float32 operations as their
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
IMAGE_BUDGET = 0.015  # mean |d| of two renders of one scene
K4_T_TOL = 1e-3  # K4 against K1: t (tests/test_torch_csvo.py)
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
# bytes a traversal step reads: ESVO one 4-byte descriptor word, CSVO about
# two unaligned 4-byte words (the node header and one child pointer)
BYTES_PER_STEP = 4
CSVO_BYTES_PER_STEP = 8
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
    """bench.py::build_world with this package's own worldgen, serialized
    as ESVO and as CSVO: (esvo world, csvo world, chunks)."""
    from voxelrs_tpu_torch.gamelogic.worldgen import Generator, default_config
    from voxelrs_tpu_torch.systems.chunkloader import ChunkLoader
    from voxelrs_tpu_torch.world.chunk import Chunk, ChunkPos
    from voxelrs_tpu_torch.world.csvo import Csvo, CsvoSerializedChunk
    from voxelrs_tpu_torch.world.esvo import Esvo, SerializedChunk
    from voxelrs_tpu_torch.world.octree import Position

    gen = Generator(1, default_config())
    svo, csvo = Esvo(), Csvo()
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
                csvo.set_leaf(Position(cx, cy, cz), CsvoSerializedChunk
                              .from_voxels(chunk.pos, chunk.voxels, lod), True)
                count += 1
    svo.serialize()
    csvo.serialize()
    return svo, csvo, count


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
    it, and keeps each batch, its K5 rows and the world it was cast on (one
    device copy per buffer state, ESVO or CSVO), for the comparison after
    the run."""

    def __init__(self, raycast):
        self.raycast = raycast
        self.buffers = {}  # (address, version, words, root, depth) -> copy
        self.batches = []  # (buffer key, octree_scale, tasks, rows)

    def __call__(self, desc, octree_scale, tasks):
        from voxelrs_tpu_torch.ops.traversal_csvo import CsvoBuffer

        rows = self.raycast(desc, octree_scale, tasks)
        csvo = isinstance(desc, CsvoBuffer)
        buf = desc.words if csvo else desc
        key = (buf.data_ptr(), buf._version, buf.numel(),
               tuple(desc[1:]) if csvo else None)
        if key not in self.buffers:
            self.buffers[key] = (desc._replace(words=buf.clone()) if csvo
                                 else buf.clone())
        self.batches.append((key, octree_scale, tasks.clone(), rows.clone()))
        return rows


def play_game(game, recorder):
    """Load the game's world, then play the scripted run with ``recorder``
    in place of the picker's kernel call. Returns the run's numbers."""
    import math

    import torch

    from voxelrs_tpu_torch.gamelogic import benchmark, content
    from voxelrs_tpu_torch.ops import picker

    fmt = game.args.svo_format
    out = {}
    benchmark.reset_all()
    with Phase(f"game load ({fmt})") as ph:
        loaded = game.wait_for_world(timeout=BUDGET_S / 3)
    out["load_s"] = ph.seconds
    ser = benchmark.collect()["traces"].get("serialize_chunk",
                                            {"avg": 0.0, "med": 0.0, "n": 0})
    out.update(serialize_chunk_ms_mean=ser["avg"] * 1e3,
               serialize_chunk_ms_median=ser["med"] * 1e3,
               serialize_chunk_n=ser["n"])
    stats = game.world.world_svo.get_stats()
    out.update(chunks=len(game.world.world.chunks),
               svo_leaves=len(game.world.world_svo.leaf_ids),
               svo_mb=stats.used_bytes / 1e6, depth=stats.depth)
    log(f"game load ({fmt}): {out['load_s']:.2f} s (wait_for_world, loaded "
        f"{loaded}); {out['chunks']} chunks, {out['svo_leaves']} SVO "
        f"leaves, {out['svo_mb']:.2f} MB {fmt.upper()}, depth "
        f"{out['depth']}, device buffer "
        f"{game.world.world_svo.graphics_svo.device_buf.numel()} words; "
        f"serialize_chunk (job threads, lock waits included) mean "
        f"{out['serialize_chunk_ms_mean']:.3f} ms, median "
        f"{out['serialize_chunk_ms_median']:.3f} ms over "
        f"{out['serialize_chunk_n']} chunks")
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
        with Phase(f"game run ({fmt})") as ph:
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
    log(f"game run ({fmt}): {out['frames']} frames flown {out['flown']}, "
        f"landed {landed}, edit {out['edit']} ok {out['edit_ok']}")
    log(f"game frame ({fmt}; step_frame + synchronize, {game.args.width}x"
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
    from voxelrs_tpu_torch.ops import picker, shading, traversal_csvo
    from voxelrs_tpu_torch.ops.traversal import MAX_STEPS, step_budget

    fmt = game.args.svo_format
    out = {}
    with Phase(f"k5 vs plain ({fmt})"):
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
    log(f"k5 vs plain ({fmt}): {len(recorder.batches)} batches, {n_tasks} tasks, "
        f"{len(recorder.buffers)} buffer states; tasks differing {bad}, "
        f"max |d| {k5_err:.3g}; ok {out['k5_ok']}")

    gsvo = game.world.world_svo.graphics_svo
    desc, scale = gsvo.world(), float(gsvo.octree_scale)
    dev = gsvo.device_buf.device
    with Phase(f"k3 vs plain (streamed world, {fmt})"):
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
    log(f"k3 vs plain on the streamed {fmt} buffer (final pose): max |d| {d:.3g} "
        f"(tolerance {K3_MAX_ABS:g}); ok {out['k3_game_ok']}")

    with Phase(f"k5 timing ({fmt})"):
        # the last AABB sweep of the run, on the final buffer
        tasks = next(t for _, _, t, _ in reversed(recorder.batches)
                     if t.shape[0] >= 32)
        n = tasks.shape[0]
        rows = torch.empty((n, 8), dtype=torch.float32, device=dev)
        steps = torch.empty(n, dtype=torch.int32, device=dev)
        csvo = fmt == "csvo"
        budget = (traversal_csvo.step_budget if csvo else step_budget)(
            MAX_STEPS)
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
    k5_bytes = n * (28 + 32) + k5_steps * (CSVO_BYTES_PER_STEP if csvo
                                           else BYTES_PER_STEP)
    k5_bound = bound(k5_bytes, k5_steps * OPS_PER_STEP)
    out.update(k5_ms=k5_ms, k5_plain_ms=k5_plain_ms, k5_host_us=k5_host,
               k5_round_trip_us=round_trip_us, k5_bound=k5_bound,
               k5_steps=k5_steps, k5_n=n)
    log(f"k5 alone ({fmt}; {n} tasks, {k5_steps} steps, {KERNEL_REPS} back-to-back "
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
    import numpy as np

    from voxelrs_tpu_torch import _build, native
    from voxelrs_tpu_torch.gamelogic.content import new_registry
    from voxelrs_tpu_torch.graphics.svo import Svo

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 1. build: the kernels (nvcc) and the native serializers (g++) ----
    with Phase("build"):
        _build.library()
        libs = native.loaded()
    log(f"build: {_build.build_seconds:.2f} s (one nvcc call)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"native serializers: loaded {libs}; g++ {' '.join(native.GXX_FLAGS)}"
        f", seconds {native.build_seconds}")
    if not all(libs.values()):
        fail("the native chunk serializers did not load")

    # ---- 2. world, in both formats ------------------------------------------
    with Phase("world"):
        world, cworld, chunks = build_world()
        svo = Svo(new_registry(), capacity_mb=64, device="cuda")
        svo.update(world)
        csvo = Svo(new_registry(), capacity_mb=64, buffer_dtype=np.uint8,
                   device="cuda")
        csvo.update(cworld)
    log(f"world: {chunks} chunks, depth {svo.depth}, "
        f"{svo.stats.used_bytes / 1e6:.2f} MB ESVO, device buffer "
        f"{svo.device_buf.shape[0]} words; "
        f"{csvo.stats.used_bytes / 1e6:.2f} MB CSVO, depth {csvo.depth}, "
        f"device buffer {csvo.device_buf.shape[0]} words")
    poses = bench_poses()

    # ---- 3-5. the renderer's path in ESVO: K1 and K3 ------------------------
    e = renderer_phase(svo, poses, card)

    # ---- 6. small frame against the repository's golden -------------------
    with Phase("golden"):
        gd = golden_check(repo)
    log(f"golden render_basic.npy: mean |d| {gd:.5f} (budget 0.015)")
    if not gd < 0.015:
        fail("golden frame over budget")

    # ---- 7. the renderer's path in CSVO: K4 and K3-CSVO, held to ESVO ------
    c = renderer_phase(csvo, poses, card)
    vs = {f: int((getattr(c["hits"], f) != getattr(e["hits"], f)).sum())
          for f in ("value", "face_id", "inside_voxel")}
    vs["t_max_abs"] = float((c["hits"].t - e["hits"].t).abs().max())
    vs_frame = float((c["img"] - e["img"]).abs().mean())
    log(f"k4 vs k1 (pose 0, the same scene): {json.dumps(vs)} (value, "
        f"face_id, inside equal; t within {K4_T_TOL:g}); the CSVO frame vs "
        f"the ESVO frame: mean |d| {vs_frame:.3g} (budget {IMAGE_BUDGET})")
    if any(vs[f] for f in ("value", "face_id", "inside_voxel")) \
            or not vs["t_max_abs"] <= K4_T_TOL:
        fail("K4 disagrees with K1 on the same scene")
    if not vs_frame < IMAGE_BUDGET:
        fail("the CSVO frame disagrees with the ESVO frame")

    # ---- 8. the game loop's path, ESVO then CSVO: counts from 0 -----------
    ge, ce = game_phase("esvo", card)
    gc, cc = game_phase("csvo", card)

    # ---- bounds: the least time the card could take for the same work -----
    B = W * H
    tex_bytes = sum(m.numel() * 4 for m in svo.mips)
    ray_bytes = B * (24 + 4) + B * 41  # rays in, hit records out
    k1_bound = bound(svo.device_buf.numel() * 4 + tex_bytes + ray_bytes,
                     e["trav_steps"] * OPS_PER_STEP)
    # K4: its rays, its hit records and the words its steps load
    k4_bound = bound(ray_bytes + c["trav_steps"] * CSVO_BYTES_PER_STEP,
                     c["trav_steps"] * OPS_PER_STEP)
    k3_bound, k3c_bound = (
        bound(s.device_buf.numel() * 4 + tex_bytes + W * H * 16,
              r["k3_steps"] * OPS_PER_STEP + W * H * OPS_PER_PIXEL)
        for s, r in ((svo, e), (csvo, c)))
    for name, r in (("esvo", e), ("csvo", c)):
        log(f"{name}: traversal steps {r['trav_steps']} "
            f"({r['trav_steps'] / B:.1f}/ray), k3 steps {r['k3_steps']} "
            f"({r['k3_steps'] / B:.1f}/pixel, primary + shadow)")
    kernels = [
        dict(name="k1_traversal", route="cuda",
             source="voxelrs_tpu_torch/csrc/k1_traversal.cuh",
             replaces="voxelrs_tpu/ops/traversal.py:1087",
             launches=e["trav_launches"], max_abs_err=e["trav_err"],
             ms=e["trav_ms"], plain_ms=e["trav_plain_ms"],
             bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=None,
             ok=e["trav_ok"], rays_differing=e["trav_diff"],
             wrapper_host_us=e["trav_host_us"]),
        dict(name="k3_frame", route="cuda",
             source="voxelrs_tpu_torch/csrc/kernels.cu",
             replaces="voxelrs_tpu/ops/shading.py:4067",
             launches=e["k3_launches"], max_abs_err=e["k3_err"],
             ms=e["k3_ms"], plain_ms=e["k3_plain_ms"],
             bound_ms=k3_bound[0], bound_by=k3_bound[1], library_ms=None,
             ok=e["k3_ok"] and ce["k3_game_ok"] and c["k3_ok"]
             and cc["k3_game_ok"],
             mean_abs_err=e["k3_mean_err"], wrapper_host_us=e["k3_host_us"],
             frame_ms=e["frame_ms"], launches_game=ge["launches"]["k3"],
             max_abs_err_game=ce["k3_game_err"],
             launches_csvo=c["k3_launches"],
             launches_csvo_game=gc["launches"]["k3_csvo"],
             ms_csvo=c["k3_ms"], plain_ms_csvo=c["k3_plain_ms"],
             bound_ms_csvo=k3c_bound[0], bound_by_csvo=k3c_bound[1],
             max_abs_err_csvo=c["k3_err"],
             max_abs_err_csvo_game=cc["k3_game_err"],
             mean_abs_csvo_vs_esvo=vs_frame, frame_ms_csvo=c["frame_ms"]),
        dict(name="k4_csvo_traversal", route="cuda",
             source="voxelrs_tpu_torch/csrc/k4_csvo_traversal.cuh",
             replaces="voxelrs_tpu/ops/traversal_csvo.py:151",
             launches=c["trav_launches"], max_abs_err=c["trav_err"],
             ms=c["trav_ms"], plain_ms=c["trav_plain_ms"],
             bound_ms=k4_bound[0], bound_by=k4_bound[1], library_ms=None,
             ok=c["trav_ok"], rays_differing=c["trav_diff"], vs_k1=vs,
             wrapper_host_us=c["trav_host_us"],
             launches_inside_k3_k5_csvo_game=(gc["launches"]["k3_csvo"]
                                              + gc["launches"]["k5_csvo"])),
        dict(name="k5_picker", route="cuda",
             source="voxelrs_tpu_torch/csrc/kernels.cu",
             replaces="voxelrs_tpu/graphics/svo.py:526",
             launches=ge["launches"]["k5"],
             max_abs_err=ce["k5_err"], ms=ce["k5_ms"],
             plain_ms=ce["k5_plain_ms"], bound_ms=ce["k5_bound"][0],
             bound_by=ce["k5_bound"][1], library_ms=None,
             ok=ce["k5_ok"] and cc["k5_ok"], tasks=ce["k5_n"],
             steps=ce["k5_steps"], batches_checked=ce["k5_batches"],
             launches_per_frame=ge["k5_per_frame"],
             wrapper_host_us=ce["k5_host_us"],
             svo_raycast_round_trip_us=ce["k5_round_trip_us"],
             launches_csvo=gc["launches"]["k5_csvo"],
             ms_csvo=cc["k5_ms"], plain_ms_csvo=cc["k5_plain_ms"],
             bound_ms_csvo=cc["k5_bound"][0], bound_by_csvo=cc["k5_bound"][1],
             max_abs_err_csvo=cc["k5_err"], steps_csvo=cc["k5_steps"],
             batches_checked_csvo=cc["k5_batches"],
             launches_per_frame_csvo=gc["k5_per_frame"],
             svo_raycast_round_trip_us_csvo=cc["k5_round_trip_us"]),
    ]
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s (budget {BUDGET_S} s)")
    game_keys = ("load_s", "serialize_chunk_ms_mean",
                 "serialize_chunk_ms_median", "serialize_chunk_n", "chunks",
                 "svo_leaves", "svo_mb", "depth", "frames", "frame_ms_median",
                 "frame_ms_p90", "frame_ms_p99", "frame_ms_max", "share",
                 "ms_per_frame", "k5_per_frame", "physics_steps", "parts",
                 "run_s", "launches")
    log(json.dumps({"frame_ms": e["frame_ms"], "mrays_per_s": e["mrays"],
                    "frame_ms_csvo": c["frame_ms"],
                    "mrays_per_s_csvo": c["mrays"],
                    "card": card, "build_s": _build.build_seconds,
                    "native_build_s": native.build_seconds, "total_s": total,
                    "game": {k: ge[k] for k in game_keys},
                    "game_csvo": {k: gc[k] for k in game_keys}}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def renderer_phase(svo, poses, card) -> dict:
    """The renderer's path on ``svo``'s format — ESVO (K1, K3) or CSVO (K4,
    K3-CSVO): counts from 0, one full-frame ray query and one frame per
    pose; then the traversal kernel against its plain version and K3
    against the plain frame on pose 0, and their timing. Returns the
    numbers, pose 0's hits (``hits``) and frame (``img``)."""
    import numpy as np
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import shading, traversal, traversal_csvo
    from voxelrs_tpu_torch.ops.traversal import MAX_STEPS, TraversalResult

    csvo = svo.buffer_dtype == np.uint8
    fmt, kname = ("csvo", "k4") if csvo else ("esvo", "k1")
    world, scale = svo.world(), float(svo.octree_scale)
    alpha = shading.make_alpha_fn(svo.mips, svo.mat_tex)
    if csvo:
        trav, head = traversal_csvo, (world.words, scale, world.root_ptr,
                                      world.total_depth)
        query_fn = traversal_csvo.intersect_octree_csvo
        plain_fn = traversal_csvo.intersect_octree_csvo_plain
        launch_fn = _build.launch_k4
    else:
        trav, head = traversal, (world, scale)
        query_fn = traversal.intersect_octree
        plain_fn = traversal.intersect_octree_plain
        launch_fn = _build.launch_k1

    def query(ro, rd):
        return query_fn(*head, ro, rd, -1.0, True, alpha_fn=alpha)

    out = {}
    with Phase(f"main path ({fmt})"):
        trav.launches = 0
        shading.launches = shading.launches_csvo = 0
        frames = []
        for p in poses:
            ro, rd = primary_rays(svo, p)
            hits = query(ro, rd)
            frames.append(svo.render(p, W, H))
        torch.cuda.synchronize()
        out.update(trav_launches=trav.launches, k3_launches=shading.launches)
        k3_csvo = shading.launches_csvo
    log(f"main path launches ({fmt}): {kname} {out['trav_launches']}, "
        f"k3_frame {out['k3_launches']} ({k3_csvo} in the CSVO "
        f"instantiation)")
    if out["trav_launches"] == 0 or out["k3_launches"] == 0:
        fail(f"a kernel of the {fmt} renderer's path was not launched")
    if k3_csvo != (out["k3_launches"] if csvo else 0):
        fail(f"the {fmt} path launched the other format's K3")
    for img in frames:
        if tuple(img.shape) != (H, W, 4) or not bool(torch.isfinite(img).all()):
            fail(f"{fmt} frame has the wrong shape or non-finite values")
        if float(img.min()) < 0.0 or float(img.max()) > 1.0 + 1e-5:
            fail(f"{fmt} frame values outside [0, 1]")
    hit_share = float((hits.t >= 0).float().mean())
    sky_share = float((frames[0][..., 2] > 0.7).float().mean())
    log(f"{fmt}: pose 4 primary hit share {hit_share:.4f}; pose 0 sky-blue "
        f"share {sky_share:.4f}")
    if not 0.05 < hit_share < 0.999:
        fail("the query hits too little or too much of the frame")

    with Phase(f"{kname} vs plain"):
        ro, rd = primary_rays(svo, poses[0])
        hits = query(ro, rd)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = plain_fn(*head, ro, rd, -1.0, True, alpha)
        b.record()
        b.synchronize()
        out["trav_plain_ms"] = a.elapsed_time(b)
    B = ro.shape[0]
    fields = TraversalResult._fields
    out["trav_diff"] = {f: int((getattr(hits, f) != getattr(ref, f))
                               .reshape(B, -1).any(-1).sum()) for f in fields}
    out["trav_err"] = max(float((getattr(hits, f) - getattr(ref, f))
                                .abs().max()) for f in ("t", "pos", "uv", "lod"))
    out["trav_ok"] = all(torch.equal(getattr(hits, f), getattr(ref, f))
                         for f in fields)
    out["trav_steps"] = int(hits.steps.sum())
    out["hits"] = hits
    log(f"{kname} vs plain: rays differing per field "
        f"{json.dumps(out['trav_diff'])}; max |d| over t/pos/uv/lod "
        f"{out['trav_err']:.3g}; plain {out['trav_plain_ms']:.1f} ms; ok "
        f"{out['trav_ok']} (every field equal)")
    if not out["trav_ok"]:
        fail(f"{kname.upper()} disagrees with its plain version")

    with Phase(f"k3 vs plain ({fmt})"):
        p = poses[0]
        img = svo.render(p, W, H, max_steps=1000)
        kw = svo.frame_kwargs(p, W, H, max_steps=1000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref_img = shading.render_frame_plain(
            world, svo.octree_scale, svo.mips, svo.mat_params, svo.mat_tex,
            **kw)
        b.record()
        b.synchronize()
        out["k3_plain_ms"] = a.elapsed_time(b)
    d = (img - ref_img).abs()
    out.update(k3_err=float(d.max()), k3_mean_err=float(d.mean()), img=img)
    out["k3_ok"] = out["k3_err"] <= K3_MAX_ABS
    log(f"k3 vs plain ({fmt}): mean |d| {out['k3_mean_err']:.3g}, max |d| "
        f"{out['k3_err']:.3g} (tolerance {K3_MAX_ABS:g}), pixels > 1e-3: "
        f"{int((d.amax(-1) > 1e-3).sum())}; plain {out['k3_plain_ms']:.1f} "
        f"ms; ok {out['k3_ok']}")
    if not out["k3_ok"]:
        fail(f"K3 disagrees with the plain frame ({fmt})")

    with Phase(f"timing ({fmt})"):
        for p in poses:  # warm-up
            svo.render(p, W, H)
        frame_ms = sorted(cuda_ms(lambda: svo.render(p, W, H), REPS)
                          for p in poses)
        out["frame_ms"] = frame_ms[len(frame_ms) // 2]
        out["mrays"] = W * H * 2 / (out["frame_ms"] / 1e3) / 1e6
        # the kernels alone, on pose 0, from inputs prepared beforehand
        dev = svo.device_buf.device
        md = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
        trav_out = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in (
            (B, torch.float32), (B, torch.int32), (B, torch.int32),
            ((B, 3), torch.float32), ((B, 2), torch.float32),
            (B, torch.float32), (B, torch.bool), (B, torch.int32))]
        budget = trav.step_budget(MAX_STEPS)
        out["trav_ms"] = kernel_ms(lambda: launch_fn(
            *head, ro, rd, md, budget, 1, alpha.tables, *trav_out))
        fp = shading.frame_params(mip_mode=shading.mip_mode_from_env(),
                                  csvo=csvo, **svo.frame_kwargs(poses[0], W, H))
        tables = svo.kernel_tables()
        k3_img = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
        out["k3_ms"] = kernel_ms(lambda: _build.launch_k3(world, scale, tables,
                                                          fp, k3_img))
        steps3 = torch.empty(W * H, dtype=torch.int32, device=dev)
        _build.launch_k3(world, scale, tables, fp, k3_img, steps3)
        out["k3_steps"] = int(steps3.sum())
        # the wrappers' host time around those launches
        out["trav_host_us"] = host_us(lambda: query(ro, rd))
        out["k3_host_us"] = host_us(lambda: svo.render(poses[0], W, H))
    log(f"frame {W}x{H} ({fmt}; Svo.render, fused, K3; events from call to "
        f"finished frame): median {out['frame_ms']:.3f} ms/frame over "
        f"{len(poses)} poses x {REPS} runs, per-pose medians "
        f"{[round(x, 3) for x in frame_ms]}; {out['mrays']:.2f} Mrays/s "
        f"(primary + shadow, W*H*2/dt) on {card}")
    log(f"kernels alone ({fmt}, pose 0, {KERNEL_REPS} back-to-back "
        f"launches): {kname} {out['trav_ms']:.4f} ms, k3 {out['k3_ms']:.4f} "
        f"ms; wrapper host time (median of {HOST_REPS} calls): query "
        f"{out['trav_host_us']:.1f} us, Svo.render {out['k3_host_us']:.1f} us")
    return out


def game_phase(fmt: str, card):
    """``Game(GameArgs(svo_format=fmt))`` at its defaults: counts from 0,
    the load and the scripted run, then ``check_game``. Returns the run's
    and the checks' numbers."""
    import torch

    from voxelrs_tpu_torch.gamelogic.game import Game, GameArgs
    from voxelrs_tpu_torch.ops import picker, shading, traversal, traversal_csvo

    recorder = PickerRecorder(picker.raycast)
    traversal.launches = traversal_csvo.launches = 0
    shading.launches = shading.launches_csvo = 0
    picker.launches = picker.launches_csvo = 0
    game = Game(GameArgs(render_distance=GAME_RENDER_DISTANCE,
                         svo_format=fmt))
    try:
        g = play_game(game, recorder)
        torch.cuda.synchronize()
        n = g["launches"] = dict(
            k5=picker.launches, k3=shading.launches,
            k5_csvo=picker.launches_csvo, k3_csvo=shading.launches_csvo,
            k1=traversal.launches, k4=traversal_csvo.launches)
        log(f"game path launches ({fmt}): {json.dumps(n)} (k1 and k4 run "
            f"inside k3 and k5 here)")
        if n["k5"] == 0 or n["k3"] == 0:
            fail(f"a kernel of the {fmt} game's path was not launched")
        csvo = fmt == "csvo"
        if (n["k5_csvo"], n["k3_csvo"]) != ((n["k5"], n["k3"]) if csvo
                                            else (0, 0)):
            fail(f"the {fmt} game launched the other format's instantiation")
        if not g["final_img_ok"]:
            fail(f"the {fmt} game's frame has the wrong shape or non-finite "
                 "values")
        if not g["landed"]:
            fail(f"the player did not land ({fmt})")
        if not g["edit_ok"]:
            fail(f"breaking and placing a block did not change the voxel "
                 f"({fmt})")
        c = check_game(game, recorder, card)
    finally:
        game.shutdown()
    del recorder  # the buffer copies
    if not c["k5_ok"]:
        fail(f"K5 disagrees with its plain version ({fmt})")
    if not c["k3_game_ok"]:
        fail(f"K3 disagrees with the plain frame on the streamed {fmt} buffer")
    return g, c


def bound(n_bytes: int, n_ops: int):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and float operations over the fp32 peak."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


if __name__ == "__main__":
    sys.exit(main())
