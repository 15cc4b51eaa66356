#!/usr/bin/env python3
"""Smoke run of voxelrs_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py [--parent DIR] [--renderer-only]

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
The renderer and the game render the JAX package's default mode, the
deferred frame, with the scene's terrain envelope: per format a deferred
phase drives it on the bench scene (counts from 0; K7's tile floors, the
four stages — primary, shade, shadow, finish — each counted, K6's
compactions, K8's sun certificates), holds it against the plain deferred
frame (the stages' plain version, on the same tensors and beam context)
and against K3's fused frame on all 5 poses with the beams and the sun map,
with the beams only and without a heightfield, holds K6, K7 and K8 against
their plain versions on pose 0's own inputs and K1 / K4 from the pixel
floors against their unfloored runs, and times the kernels and stages
alone and the frame from call to done; these phases pin the exact deferred
frame (``adaptive=False``). At 1080p the default is the JAX package's
adaptive thick-ray frame (K9): per format an adaptive phase drives it
(counts from 0 over the 5 bench poses and one pitched up until under 16%
of the pixels hit, which takes the single-pass shadow branch; K9's four
kernels and the stages around them), holds it against its plain version
(``render_frame_adaptive_plain``) on every pose with beams + sun map,
beams only and no heightfield and against K3's frame within the JAX
thick-ray budget, holds K9's kernels against their plain versions on pose
0's own inputs and its coarse trace against K1 / K4 on the same rays, and
times the kernels alone and the adaptive, exact deferred and fused frames
in the same run. On a translucent world the default at 1080p is the JAX
package's judged adaptive frame (K9-judged): ``build_translucent_world``
puts water in the valleys, glass towers and leaf canopies into the bench
region from a seed, and per format a judged phase drives the frame
(counts from 0 over the 5 bench poses and a pitched-up one; K9-judged's
three kernels, K9's shadow cells, K6, K8 and the shading and shadow
stages), holds it against its plain version
(``render_frame_adaptive_judged_plain``) on those poses and one with
``VOXELRS_HOLE_FILL=1``, against the exact judged frame within the
thick-ray budget, and against its beams-only variant (the sun map's
certificates on judged shadow rays against floored judged traces:
reported), holds K9-judged's kernels against their plain versions on pose
0's own inputs and its traces against K1 / K4 judged on the same rays,
and times the judged adaptive, exact judged and fused frames in one run.
The game phases count the frames
that had a sun map and hold the deferred frame of the streamed buffer
against K3's and against the plain deferred frame, and the adaptive frame
(the game's own at 1080p) against its plain version, timing the three
paths once each on that buffer. A batch phase drives the JAX package's
batched fly-through path, ``Svo.render_batch`` (K10: the opaque frame's
stages with a pose dimension, each launched once for the 5 bench poses),
on the ESVO renderer with the envelope and pose 0's sun map shared: counts
from 0 over one batch and over one frame, on the adaptive branch (the
1080p default) and on the exact one (``VOXELRS_ADAPTIVE=0``), equal apart
from the per-pose K7 tile floors; each pose's image against ``Svo.render``
of that pose given the shared sun map, and the exact batch against K3's
frames; the batched K9 kernels and K6 with segment starts against their
plain versions on the batch's own inputs, the batched stages through the
plain frames of poses 0 and 3; None from the CSVO and translucent
renderers; then the batch (call to done and two batches in flight, ms a
pose), the sequential and two-in-flight single frames and the host time
of one batch call, timed in one run, and the batch workspace's megabytes.
A probe phase runs the gather probe P0 (``python -m
voxelrs_tpu_torch.probes.gather_probe``'s 10 configurations, counted from
0) and holds its kernel to its plain version on the probe's table and a
random one.
K6 is held to its plain version on every call of the exact and adaptive
frames, the batch and both game runs (indices, count and starts equal),
and each call of a frame and of the batch is timed alone beside
``torch.nonzero`` plus the pad, timed the same way; the kernels the card
runs for one K6 call are counted from a ``torch.profiler`` trace, after
the game runs; each launch of K9's trace prints its lanes, its mean and
maximum steps a lane and its SIMD efficiency (from K1 / K4's steps on the
same rays), and is timed alone. K9's merge and finalize are held to their
plain versions on every call of the adaptive phases' frames (both
formats, the pitched-up pose among them) and of the batch, each launch
is timed alone, and the card operations of one merge and one finalize
call are counted from a profiler trace; the build prints the K9 kernels'
and the shadow stage's loads and stores by width from ``cuobjdump
-sass``. The shadow stage (``kd_shadow``) and K9's shadow cells (both
steps) are held to their plain versions on every call of the deferred,
adaptive and judged phases' frames, the batch and each game's final
adaptive frame; each is timed alone on pose 0's own inputs and at a
count of 0, ``kd_shadow`` also on the adaptive frame's two passes with
the sun map and under ``VOXELRS_SUN=0`` (K7's floors, the games' branch)
with its traced slots' steps, slowest warp and SIMD efficiency, and the
card operations of one call of each are counted. The finishing stage
(``kd_finish``) and K7's shadow floors are held to their plain versions
(``ops.shading.kd_finish_plain``, ``ops.beams.k7_shadow_plain``) on every
call of the same frames (the deferred phases' three variants, K7's floors
where no sun map is attached, and each game's final frames rendered once
more without the sun map); each is timed alone and at a count of 0 on
pose 0's exact frame, on the adaptive frame's passes with the sun map and
under ``VOXELRS_SUN=0`` and (``kd_finish``) on the batch's launches; the
profiler counts the kernels and reads the grid of one call of each, which
must not exceed the blocks the card holds at once; K5's fixed cost is
timed on one task outside the world. With ``--parent DIR``
(the parent commit's ``voxelrs_tpu_torch``, e.g. from ``git archive``,
unpacked in DIR) the parent's kernels build in a second ``nvcc`` beside
this tree's, its K6 and K9 trace, merge and finalize are timed on the
same inputs (each K9 launch held to the plain outputs), so are its
shadow stage, shadow cells, finishing stage and K7 shadow floors, and its
renderer's frames (adaptive,
exact and fused in both formats, the judged adaptive and exact judged
frames of the translucent world, the ESVO batch on both branches) are
timed in turns with
this tree's and compared with them, each path's difference set beside the
opaque adaptive frame's (whose kernels this slice left alone: the
noise). K3 is held to the plain frame on the 5 bench poses and
pose 0 trilinear in both formats; its steps are split into the primary
ray's (K1 / K4 on the pixel's ray) and the shadow ray's, with each
phase's SIMD efficiency in warps of 32 pixels of a row and in K3's 4x8
tiles and the shadow share of the slowest warps (``k3_split``).
K9-judged's trace is held to ``k9j_trace_plain`` on every call of the
judged phases' frames (the 6 poses and the hole fill, both formats), each
launch of pose 0's frame is timed alone, at a count of 0 (its refine
lists) and, with --parent, against the parent's kernel, with its lanes'
steps and SIMD efficiency (rows and, on the whole grid, 4x8 tiles). Both
kernels' card operations a call and grid come from the profiler (one
kernel, a grid within the blocks the card holds), their registers and
spills from ptxas (the build's log, kept beside the library) and their
stores by width from the SASS. K9-judged's finalize is held to its plain
version on every call of the judged phases' frames (both formats), its
card operations a call counted from the profiler, and with --parent the
parent's finalize and the parent's K1 / K4 are timed on the same inputs;
K4's and K1's microseconds a step on the same rays are printed, and the
ptxas lines of K1, K4 and every CSVO instantiation (this tree's and the
parent's) and the SASS loads of K4 and both finalizes by width. The
primary stage (``kd_primary``) is held to ``kd_primary_plain`` on every
call of the exact frames (the deferred phases' frames and variants, the
judged phases' exact judged frames, the exact batch and its single
frame), and its launch on pose 0's exact frame (both formats) and the
batch's is timed alone, against the plain version and, with --parent,
the parent's kernel, with its rays' steps from the floors (mean, max,
SIMD efficiency in rows and in 4x8 tiles, K1 / K4 on the same rays) and
the picoseconds a step of it and of K1 / K4 unfloored; K9-judged's merge
is held to ``k9j_merge_plain`` on every call of the judged phases'
frames, the hole-fill frame too, and timed against the parent's. K7's
tile floors (``_build.launch_k7_tiles`` against
``ops.beams.k7_tiles_plain``) and K8 (``_build.launch_k8`` against
``ops.beams.k8_plain``: verdicts, the lanes left to trace, lit floors)
are held to their plain versions on every call of the exact, adaptive,
exact judged and judged adaptive frames (both formats), of the batch and
of each game's final frames (the game's pyramid too large to stage in
shared memory, its tile launch reads it from global memory);
pose 0's tile launch is timed alone, without its march (max_iters 0),
against the plain version and the parent's kernel, with the plain
march's longest lane (iterations and descents), and pose 0's K8 launch
(and its lit floors on the same inputs) alone, at count 0, plain and the
parent's, and in each row word its table allows (the table copied 0, 8
and 4 bytes past a 16-byte word, ``k8_widths``); each game's final exact
frame's tile launch (its pyramid read from global memory) and K8 launch
(the game's map) are timed the same way; K8's bound counts each distinct
row its rays read once (``k8_table_bytes``); the kernels line carries
both kernels' ptxas lines (K8's three row-word instantiations, K7's
staged and global-memory ones) and the profiler reads K8's grid.
``--kernels-only`` stops after the build and the worlds and times the
launches this slice redesigned (``slice_kernels_phase``: K1 on pose 0's
rays, K5's shapes on picker batches near the 5 poses in both formats,
and the ESVO launches that trace with K1's cursor: K3, ``kd_primary``,
``kd_shadow``, K9's and K9-judged's traces) against the parent's kernel
in turns: a quick comparison of shapes, with --parent a copy of the
tree with another shape; it also counts each kernel's SASS instructions
and the size and shortest step of the traversal loops of K1, K5 and
``kd_primary`` (``sass_loop``), this tree's and the parent's. The game
phases hold K5 (the one-call pick of
``Svo.raycast``, ``ops.picker.pick``) to its plain version, to the
launch-and-copy path and in every shape (K5_SHAPES) on every recorded
batch, time each shape and the parent's K5 on the last sweep, the last
look ray and the batch of the longest chain, time each pick of the run
under the job threads and the quiet round trip, and report the physics
span a step; the scripted flight takes turns, a frame each, between the
one-call pick and the parent's round trip (``launch_and_copy``: a
pageable upload, K5, a blocking copy back), each side's picks and
physics span reported on their own.
``--renderer-only`` stops after the
renderer phases (the build, K1 / K4 and K3 in both formats, with --parent
the parent's K1 / K4 and K3 on the same inputs) and prints no result: a
quick comparison of K3's or the CSVO cursor's shapes, with --parent
pointing at a copy of the tree with another shape.
Every phase prints its seconds.

Tolerances: K1 and K4 against their plain versions — every field of every
ray equal (torch.equal); K4 against K1 on the same scene — value, face_id
and inside equal, t within 1e-3 (tests/test_torch_csvo.py); K5 — every
column of every task equal; K3 against the plain frame — max |d| <= 1e-6
over all pixels and channels; the golden frame and the CSVO frame against
the ESVO one — mean |d| < 0.015, the repository's image budget; K6, K7
and K8 against their plain versions — equal (torch.equal); K1 / K4 from
the floors against their unfloored runs — value, face_id, inside_voxel
and t equal; the deferred frame against K3's and against the plain
deferred frame — max |d| <= 1e-6; K9's kernels against their plain
versions — equal (the finalize's sky within 1e-6), K9's coarse trace
against K1 / K4 — every field equal; the adaptive frame against its plain
version — max |d| <= 1e-6, against K3's — the thick-ray budget of
tests/test_render.py:162-182 (coarse-sample pixels equal to the exact
deferred frame's, mean |d| < 0.002, under 2% of the pixels off by more
than 1e-3); K9-judged's kernels against their plain versions — equal (the
finalize's sky within 1e-6), its traces against K1 / K4 judged — every
field equal; ``kd_primary`` against ``kd_primary_plain`` — records and
hit flags equal, the sky within 1e-6 (its max |d| is printed); the judged adaptive frame against its plain version — max
|d| <= 1e-6, against the exact judged frame — the same thick-ray budget;
``kd_shadow``, ``kd_finish``, K7's shadow floors and K9's shadow cells
against their plain versions on every held call — bit for bit
(``kd_shadow``'s hits also equal K1's / K4's on the same rays); each
pose of a batch against its own frame — max |d|
0, the exact batch
against K3's — max |d| <= 1e-6; the batched K9 kernels and K6 against
their plain versions — equal (the finalize's sky within 1e-6), the
batched stages' images against the plain frames — max |d| <= 1e-6; P0 —
equal, every configuration and table.
Both kernels run the same IEEE float32 operations as their
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
import threading
import time

W, H = 1920, 1080
POSES = 5
REPS = 5
KERNEL_REPS = 20
K6_LAUNCH_SEED = 11  # the masks of k6_launch_phase
KERNEL_SLEEP_CYCLES = 4_000_000  # ~2 ms of the card's clock: kernel_ms
AB_ROUNDS = 6  # rounds of turns of the frames against the parent's
K8_WIDTH_ROUNDS = 9  # rounds of turns of K8's row words (k8_widths)
HOST_REPS = 50
K3_MAX_ABS = 1e-6
# K5's shapes timed and held (lanes a task: 1 = S1, the classic loop on
# lane 0; 8 and 32 = S2, the task's ray cut into segments)
K5_SHAPES = (1, 8, 32)
IMAGE_BUDGET = 0.015  # mean |d| of two renders of one scene
K4_T_TOL = 1e-3  # K4 against K1: t (tests/test_torch_csvo.py)
BUDGET_S = 600  # this script's own wall-clock budget on one H100
SUN_WAIT_S = 60  # at most, for the game's sun map to attach after the run
# the game phase: GameArgs() defaults; its scripted run (frames at 1/60 s)
GAME_RENDER_DISTANCE = 20
FLY_FRAMES = 84  # forward at 60 blocks/s: three chunk boundaries
DESCEND_FRAMES = 36  # the last frames of the flight also descend
FALL_FRAMES = 60  # at most, until the player lands
EDIT_WAIT_FRAMES = 30  # at most, for the broken block's chunk to upload
GAME_K6_CALLS = 1000  # rows of K6's recorder in a game run (~550 calls)
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
# float operations of K7 and K8, counted from csrc/k7_beams.cuh and
# k8_sun.cuh: a tile's set-up (5 directions, the occupied box, 25 near
# boxes), a shadow ray's set-up, one march iteration (steps from this run's
# plain march), one ray's 25 window tests and band tests
OPS_TILE_SETUP = 1000
OPS_SHADOW_SETUP = 60
OPS_MARCH_STEP = 25
OPS_SUN_RAY = 800
# the deferred frame's stages (csrc/kernels.cu: kd_<stage>_kernel), each
# counted by ops.shading.launches_<stage>
STAGES = ("primary", "shade", "shadow", "finish")
# K9's kernels (csrc/k9_adaptive.cuh: k9_<name>_kernel), each counted by
# ops.adaptive.launches_<name>, and the JAX functions they replace
K9 = {"trace": "voxelrs_tpu/ops/shading.py:1677",
      "merge": "voxelrs_tpu/ops/shading.py:1966",
      "finalize": "voxelrs_tpu/ops/shading.py:1894",
      "shadow_cells": "voxelrs_tpu/ops/shading.py:2172"}
# float operations of K9 outside the traversal, counted from
# csrc/k9_adaptive.cuh: a pixel ray (gen_ray and the ray constants), one
# fill test (plane, quantization, entry face; counted for every lane whose
# four corners hit, a superset of those that reach it), one hit's finalize
OPS_K9_RAY = 40
OPS_K9_FILL = 60
OPS_K9_FINALIZE = 60
# the pitched-up pose of the adaptive phase: under this share of the
# pixels hit, below JAX's dense threshold (349,356 of 2,073,600 at 1080p)
SKY_HIT_SHARE = 0.16
# K9-judged's kernels (csrc/k9_judged.cuh: k9j_<name>_kernel), each counted
# by ops.adaptive_judged.launches_<name>, and the JAX functions they replace
K9J = {"trace": "voxelrs_tpu/ops/shading.py:3259",
       "merge": "voxelrs_tpu/ops/shading.py:2807",
       "finalize": "voxelrs_tpu/ops/shading.py:3023"}
# float operations of K9-judged outside the traversal, counted from
# csrc/k9_judged.cuh: one fill (plane, quantization, entry face, the
# geometry and finalize of the filled hit; counted for every interior lane
# whose four corners hit), one sky colour
OPS_K9J_FILL = 160
OPS_SKY = 20
# the translucent scene of the judged phases: bench.py's region with water
# in the valleys, glass towers and leaf canopies placed from a seed
TRANSLUCENT_SEED = 1
SEA_PERCENTILE = 30
GLASS_TOWERS = 4
CANOPIES = 8


# the parent commit's kernel library (``parent_vx._build``), built beside
# this tree's when the script is given --parent DIR (a git archive of the
# parent's voxelrs_tpu_torch unpacked in DIR): K6, K9's trace, merge and
# finalize and the frames are then timed against the parent's on the same
# inputs, in the same run
PARENT = None


def log(msg: str) -> None:
    print(msg, flush=True)


def load_parent(path: str) -> None:
    """Import the parent tree's ``voxelrs_tpu_torch`` as the package
    ``parent_vx`` (its modules import each other relatively; its kernels
    build into the parent tree's ``_build/``)."""
    import importlib
    import importlib.util

    init = os.path.join(path, "voxelrs_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        "parent_vx", init,
        submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["parent_vx"] = pkg
    spec.loader.exec_module(pkg)


class FullWorld:
    """A serialized world whose changed ranges are all of it: the first
    ``Svo.update`` of another renderer on a world already uploaded once."""

    def __init__(self, world):
        self.world = world

    def __getattr__(self, name):
        return getattr(self.world, name)

    def write_changes_to(self, dst, reset: bool = True):
        return [(0, self.world.write_to(dst))]


def parent_frames_phase(worlds, hf, tworlds, thf, poses, card) -> dict:
    """The renderer's frames of this tree against the parent's on the same
    worlds and envelopes: per format the adaptive, exact deferred and fused
    frames, the judged adaptive and exact judged frames of the translucent
    world (``tworlds``, envelope ``thf``), and the ESVO batch on both
    branches (adaptive and, under ``VOXELRS_ADAPTIVE=0``, exact), one frame
    a sample, the sides in turns (parent, this tree, this tree, parent) on
    each pose, AB_ROUNDS times; each side's median and quartiles, and each
    path's difference of the medians (this tree less the parent). The
    opaque adaptive frame (K9's kernels and the deferred stages, which
    this slice leaves alone: the same code on both sides) shows the noise:
    its difference is set beside every path's."""
    import importlib

    import numpy as np

    from voxelrs_tpu_torch.gamelogic.content import new_registry
    from voxelrs_tpu_torch.graphics.svo import Svo

    PSvo = importlib.import_module("parent_vx.graphics.svo").Svo
    preg = importlib.import_module("parent_vx.gamelogic.content").new_registry
    out, diff = {}, {}
    adaptive = ("adaptive", lambda sv, p: sv.render(p, W, H))
    exact = ("exact", lambda sv, p: sv.render(p, W, H, adaptive=False))
    fused = ("fused", lambda sv, p: sv.render(p, W, H, mode="fused"))
    cells = [(fmt, w, hf, [adaptive, exact, fused]
              + ([("batch", None), ("batch exact", None)]
                 if fmt == "esvo" else []))
             for fmt, w in worlds.items()]
    cells += [(f"{fmt} judged", w, thf, [adaptive, exact])
              for fmt, w in tworlds.items()]
    with Phase("frames, this tree against the parent"):
        for cell, world, field, paths in cells:
            dt = np.uint32 if cell.startswith("esvo") else np.uint8
            sides = {"this tree": Svo(new_registry(), capacity_mb=64,
                                      buffer_dtype=dt, device="cuda"),
                     "parent": PSvo(preg(), capacity_mb=64, buffer_dtype=dt,
                                    device="cuda")}
            for sv in sides.values():
                sv.update(FullWorld(world))
                sv.set_heightfield(field)
            for path, fn in paths:
                if path == "batch exact":
                    os.environ["VOXELRS_ADAPTIVE"] = "0"
                got = {k: [] for k in sides}
                for sv in sides.values():  # warm-up
                    for p in poses:
                        fn(sv, p) if fn else sv.render_batch(poses, W, H)
                imgs = [fn(sv, poses[0]) if fn else sv.render_batch(
                    poses, W, H) for sv in sides.values()]
                diff[f"{cell} {path}"] = max_abs(*imgs)
                # one frame (or batch) a sample, the sides in turns on
                # each pose, so that a slow spell of the host falls on both
                for _ in range(AB_ROUNDS):
                    for p in poses if fn else [None]:
                        for side in ("parent", "this tree", "this tree",
                                     "parent"):
                            sv = sides[side]
                            got[side].append(
                                cuda_ms(lambda: fn(sv, p), 1) if fn else
                                cuda_ms(lambda: sv.render_batch(poses, W, H),
                                        1) / len(poses))
                os.environ.pop("VOXELRS_ADAPTIVE", None)
                # each side's median and quartiles
                out[f"{cell} {path}"] = {
                    k: [sorted(v)[len(v) * q // 4] for q in (2, 1, 3)]
                    for k, v in got.items()}
            del sides
    log(f"frames, this tree against the parent (ms: median, lower and "
        f"upper quartile of {AB_ROUNDS} rounds of turns parent, this tree, "
        f"this tree, parent on each pose; the batch ms a pose): "
        f"{json.dumps(out)}; max |d| "
        f"of the two sides' images "
        f"(pose 0, the batch's 5): {json.dumps(diff)} on {card}")
    delta = {k: v["this tree"][0] - v["parent"][0] for k, v in out.items()}
    for fmt in worlds:
        noise = delta[f"{fmt} adaptive"]
        log(f"frames ({fmt}), this tree less the parent (medians, ms): "
            + ", ".join(f"{k[len(fmt) + 1:]} {d:+.4f}"
                        for k, d in delta.items() if k.startswith(fmt))
            + f"; the noise, the opaque adaptive frame's (the same code on "
            f"both sides): {noise:+.4f} on {card}")
    if not all(d <= K3_MAX_ABS for d in diff.values()):
        fail("this tree's frames differ from the parent's")
    return dict(ms=out, max_abs=diff, delta=delta,
                noise_is="the opaque adaptive frame's delta, per format")


def warp_stats(steps, wid) -> dict:
    """Per-lane traversal steps of one launch grouped into warps by
    ``wid``: lanes, mean and maximum steps a lane, the maximum steps of a
    warp summed over the warps against the steps summed over the lanes,
    and their ratio over 32 lanes (the SIMD efficiency)."""
    import torch

    s = steps.long()
    if s.numel() == 0:
        return dict(lanes=0, mean=0.0, max=0, warp_max_sum=0, lane_sum=0,
                    simd_eff=None)
    wid = wid.long()
    wmax = torch.zeros(int(wid.max()) + 1, dtype=torch.long,
                       device=s.device).scatter_reduce_(0, wid, s, "amax")
    wsum, lsum = int(wmax.sum()), int(s.sum())
    return dict(lanes=s.numel(), mean=lsum / s.numel(), max=int(s.max()),
                warp_max_sum=wsum, lane_sum=lsum,
                simd_eff=lsum / (32 * wsum) if wsum else None)


def tiled_warps(lanes, wl: int, hl: int):
    """The warp of each coarsest-grid lane under K9's 4x8 tiles."""
    pose, r = lanes // (wl * hl), lanes % (wl * hl)
    y, x = r // wl, r % wl
    return (pose * -(-hl // 4) + y // 4) * -(-wl // 8) + x // 8


def trace_launch_stats(steps, lanes, idx, wl: int, hl: int) -> dict:
    """A K9 trace launch's lanes and steps (``steps`` in launch order:
    the grid's lanes, or the refine list's entries): warps of 32
    consecutive items, and for the coarsest grid also of 4x8 tiles."""
    import torch

    st = warp_stats(steps, torch.arange(steps.numel(),
                                        device=steps.device) // 32)
    if idx is None:
        st["tiled"] = warp_stats(steps, tiled_warps(lanes, wl, hl))
    return st


def k6_calls(calls, dev) -> list:
    """K6 on each spied call of ``compact_indices`` (its mask, size and
    starts): the kernel against its plain version (indices, count and
    starts equal), and, alone, the kernel, the parent's
    K6 (with --parent), ``torch.nonzero`` plus the pad (the library
    yardstick, timed as the kernel is) and the plain version; the bound
    counts the mask read once and every output slot, the count and the
    starts written once."""
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import compact

    rows = []
    for args, kw in calls:
        mask, size = args[0], args[1]
        starts = kw.get("starts")
        n = mask.shape[0]
        ks = None if starts is None else torch.full_like(starts, -1)
        ki, kc = compact.compact_indices(mask, size, starts=ks)
        ps = None if starts is None else torch.full_like(starts, -1)
        plain_ms = event_ms(lambda: compact.compact_indices_plain(
            mask, size, starts=ps))
        pi, pc = compact.compact_indices_plain(mask, size, starts=ps)
        pairs = [(ki, pi), (kc, pc)] + ([] if ks is None else [(ks, ps)])
        o, c = torch.empty_like(ki), torch.empty_like(kc)
        ts = None if starts is None else torch.empty_like(starts)
        scr = torch.zeros(_build.k6_blocks(n), dtype=torch.int32, device=dev)
        ms = kernel_ms(lambda: _build.launch_k6(mask, size, o, c, scr, ts))
        parent_ms = None
        if PARENT is not None:
            pscr = torch.zeros(max(1, PARENT.k6_blocks(n)), dtype=torch.int32,
                               device=dev)
            parent_ms = kernel_ms(lambda: PARENT.launch_k6(
                mask, size, o, c, pscr, ts))

        def library():
            nz = torch.nonzero(mask).flatten()[:size].to(torch.int32)
            return torch.nn.functional.pad(nz, (0, size - nz.shape[0]))

        library_ms = kernel_ms(library)
        rows.append(dict(
            lanes=n, set=int(pc), size=size,
            starts=None if starts is None else starts.numel(),
            equal=all(bool(torch.equal(a, b)) for a, b in pairs),
            err=max(max_abs(a, b) for a, b in pairs), ms=ms,
            parent_ms=parent_ms, library_ms=library_ms, plain_ms=plain_ms,
            bound=bound(n + size * 4 + 4 + (0 if starts is None
                                            else starts.numel() * 4), 0)))
    return rows


# the arguments a held launch writes (by position: of K9's and
# K9-judged's wrappers, and of _build.launch_kd_primary (records, flags,
# the image's sky), launch_kd_shadow, launch_kd_finish (the image, the
# pixel verdicts or None) and launch_k7_shadow), for parent_launch and
# held_calls; the finalizes' and kd_primary's images are the sky, within
# K3_MAX_ABS (their max |d| is reported)
# the shadow pass's held launches: the shadow stage, the finishing stage
# and K7's shadow floors (where no sun map is attached)
SHADOW_HELD = ("kd_shadow", "kd_finish", "k7_shadow")
# the beam pre-pass's held launches: K7's tile floors (Svo.beam_context)
# and K8 (the sun map's verdicts or lit floors, in the shadow pass)
BEAM_HELD = ("k7_tiles", "k8")
LAUNCH_OUTS = {"k9_trace": (5,), "k9_merge": (4, 5),
               "k9_finalize": (3, 4, 5, 6, 7),
               "k9_shadow_cells": (5, 7, 8, 11), "kd_primary": (6, 7, 8),
               "kd_shadow": (11,), "kd_finish": (9, 10), "k7_shadow": (8,),
               "k9j_trace": (6,), "k9j_merge": (5, 6),
               "k9j_finalize": (2, 3, 4, 5, 6), "k3": (4,),
               "k7_tiles": (3,), "k8": (7, 8, 9, 10)}
SKY_LAUNCHES = ("k9_finalize", "k9j_finalize", "kd_primary")
# the launches spied in _build (the others are K9's wrappers in
# ops.adaptive and K9-judged's in ops.adaptive_judged), the position of
# each one's count (None: it has none), and its plain version
RAW_LAUNCHES = {"kd_primary": None, "kd_shadow": 7, "kd_finish": 3,
                "k7_shadow": 7, "k7_tiles": None, "k8": 5}
# the launches whose grid is at most the blocks the card holds at once
RESIDENT_LAUNCHES = ("kd_shadow", "kd_finish", "k7_shadow", "k3",
                     "k9j_trace", "k8")


def copy_outs(name, args) -> list:
    """``args`` of launch ``name`` with copies of the tensors it writes."""
    return [x.clone() if i in LAUNCH_OUTS[name] and x is not None else x
            for i, x in enumerate(args)]


def outs_of(name, args) -> list:
    """The tensors launch ``name`` writes, of its arguments ``args``."""
    return [args[i] if i < len(args) else None for i in LAUNCH_OUTS[name]]


def launch_outputs_equal(name, outs, ref) -> tuple:
    """(equal, max |d|) of a launch's outputs against the plain version's
    (outputs that are None on both sides skipped): bit for bit, the images
    of SKY_LAUNCHES (the sky of a miss: acosf) within K3_MAX_ABS."""
    pairs = [(a, b) for a, b in zip(outs, ref)
             if a is not None or b is not None]
    errs = [max_abs(a, b) for a, b in pairs]
    eq = all(bits_equal(a, b) or (name in SKY_LAUNCHES
                                  and a.dtype.is_floating_point
                                  and e <= K3_MAX_ABS)
             for (a, b), e in zip(pairs, errs))
    return eq, max(errs)


def spied(name):
    """(module, attribute) of the function a held launch is spied on: K9's
    and K9-judged's wrappers, the launch functions of the shadow stage,
    the finishing stage and K7's shadow floors."""
    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import adaptive, adaptive_judged

    if name in RAW_LAUNCHES:
        return _build, f"launch_{name}"
    return (adaptive_judged if name.startswith("k9j_") else adaptive), name


def plain_of(name):
    """The plain version of a held launch."""
    from voxelrs_tpu_torch.ops import adaptive, beams, shading

    return {"kd_primary": shading.kd_primary_plain,
            "kd_shadow": shading.kd_shadow_plain,
            "kd_finish": shading.kd_finish_plain,
            "k7_shadow": beams.k7_shadow_plain,
            "k7_tiles": beams.k7_tiles_plain, "k8": beams.k8_plain}.get(name) \
        or getattr(spied(name)[0], f"{name}_plain")


class Held:
    """Spies (``Spy`` with ``outs``) on the launches ``names`` of
    LAUNCH_OUTS over a run; ``check()`` then holds every call to its
    plain version on the call's own inputs (``held_calls``)."""

    def __init__(self, names):
        self.spies = {n: Spy(*spied(n), LAUNCH_OUTS[n]) for n in names}

    def __enter__(self):
        for sp in self.spies.values():
            sp.__enter__()
        return self

    def __exit__(self, *exc):
        for sp in self.spies.values():
            sp.__exit__()
        return False

    def check(self) -> dict:
        r = {n: held_calls(sp, n) for n, sp in self.spies.items()}
        self.spies = {}  # frees the copies
        return r


def held_calls(spy, name) -> dict:
    """Every call a ``Spy`` of launch ``name`` kept (with ``outs``: the
    arguments the launch writes) held to the plain version on the call's
    own inputs: calls, equal, max |d|."""
    plain = plain_of(name)
    eq, err = True, 0.0
    for (args, kw), outs in zip(spy.calls, spy.outs):
        plain(*args, **kw)  # into the spy's own copies
        e, d = launch_outputs_equal(name, outs, outs_of(name, args))
        eq, err = eq and e, max(err, d)
    return dict(calls=len(spy.calls), equal=eq, err=err)


def held_ok(held, branch=("k7_shadow",)) -> bool:
    """Every held launch equal to its plain version, and launched at least
    once but those of ``branch`` (K7's shadow floors run only where no sun
    map is attached)."""
    return all(h["equal"] and (h["calls"] or n in branch)
               for n, h in held.items())


def held_merge(*helds) -> dict:
    """Held results of several runs, summed a launch."""
    out = {}
    for h in helds:
        for n, r in h.items():
            o = out.setdefault(n, dict(calls=0, equal=True, err=0.0))
            o.update(calls=o["calls"] + r["calls"],
                     equal=o["equal"] and r["equal"],
                     err=max(o["err"], r["err"]))
    return out


def parent_launch(name, args, kw, ref, count_pos=None):
    """With --parent, one spied launch (``name``: of LAUNCH_OUTS, its
    wrapper's arguments) through the parent's kernel on copies of the
    arguments it writes, held to ``ref`` (the plain version's outputs) and
    timed alone, and with ``count_pos`` (the position of its count) also
    timed at count 0; None without."""
    if PARENT is None:
        return None
    import torch

    launch = getattr(PARENT, f"launch_{name}")
    a = copy_outs(name, args)
    launch(*a, **kw)
    eq, err = launch_outputs_equal(name, outs_of(name, a), ref)
    torch.cuda.synchronize()
    r = dict(equal=eq, err=err, ms=kernel_ms(lambda: launch(*a, **kw)))
    if count_pos is not None:
        idle = zero_count(a, count_pos)
        r["ms_count0"] = kernel_ms(lambda: launch(*idle, **kw))
    return r


def zero_count(args, pos):
    """``args`` with the count at position ``pos`` replaced by a (1,)
    zero: the same launch with no work (its fixed cost)."""
    import torch

    a = list(args)
    a[pos] = torch.zeros_like(args[pos])
    return a


def launch_call(name, args, kw) -> dict:
    """One spied launch of the primary stage, the finishing stage, K7's
    shadow or tile floors or K8 (``name`` kd_primary / kd_finish /
    k7_shadow / k7_tiles / k8: its ``_build`` launch function's
    arguments): the kernel on copies of the
    arguments it writes against
    the plain version on copies (bit for bit), the launch alone and at
    count 0 (where it has a count), the plain version's time and, with
    --parent, the parent's kernel held to the same plain outputs; its
    candidates or rays and the bound. kd_finish's bound counts each
    candidate's index and flags, and each candidate whose pixel it
    touches (blocked, or every one with the pixel verdicts) its hit
    lane's pixel index, colour and light and its pixel written (or its
    verdict byte); K7's the pyramids, each ray's index, origin and limit,
    every lane written, and the march's operations (its steps from the
    plain version); K7's tiles also time the launch without its march
    (max_iters 0) and report the longest march and its descents."""
    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import beams

    launch = getattr(_build, f"launch_{name}")
    pos = RAW_LAUNCHES[name]
    ka = copy_outs(name, args)
    launch(*ka, **kw)
    pa = copy_outs(name, args)
    plain_ms = event_ms(lambda: plain_of(name)(*pa, **kw))
    ref = outs_of(name, pa)
    eq, err = launch_outputs_equal(name, outs_of(name, ka), ref)
    ta = copy_outs(name, args)
    r = dict(equal=eq, err=err, plain_ms=plain_ms,
             ms=kernel_ms(lambda: launch(*ta, **kw)))
    counted = pos is not None and args[pos] is not None
    if counted:
        idle = zero_count(ta, pos)
        r["ms_count0"] = kernel_ms(lambda: launch(*idle, **kw))
    r["parent"] = parent_launch(name, args, kw, ref,
                                pos if counted else None)
    if r["parent"] is not None:
        r["equal"] = r["equal"] and r["parent"]["equal"]
    if name == "kd_primary":  # its bound comes from the traced steps
        r["hits"] = int(outs_of(name, ka)[1].sum())
    elif name == "kd_finish":
        (_fp, _hidx, sidx, scount, _c, _ds, blk, todo, traced, _img,
         blkp) = list(args) + [None] * (11 - len(args))
        n = min(int(scount), sidx.shape[0])
        hit = traced[:n].bool()
        blocked = hit if blk is None else blk[:n].bool() | (
            todo[:n].bool() & hit)
        nb = int(blocked.sum())
        touched = n if blkp is not None else nb
        r.update(candidates=n, blocked=nb, bound=bound(
            n * (4 + (1 if blk is None else 3)) + touched * 4
            + nb * (16 + 4 + 16) + (n if blkp is not None else 0),
            n * 4 + nb * 8))
    elif name == "k7_tiles":
        # the bound counts the pyramid, the params, each tile's floor and
        # the set-up and march steps' operations (the plain version's
        # steps); the longest march and its descents are the kernel's chain
        levels, bounds, params, out = args
        n = out.numel()
        bare = _build.BeamParams.from_buffer_copy(params)
        bare.max_iters = 0
        r.update(tiles=n, pyramid_ints=levels.numel(),
                 march_steps=beams.last_march_steps,
                 march_max=beams.last_march_max,
                 march_descents=beams.last_march_descents,
                 ms_no_march=kernel_ms(lambda: launch(levels, bounds, bare,
                                                      ta[3])),
                 bound=bound(levels.numel() * 4 + 16 + n * 4,
                             n * OPS_TILE_SETUP
                             + beams.last_march_steps * OPS_MARCH_STEP))
    elif name == "k8":
        # each ray's index, origin and limit, the table's bytes that its
        # rays need (k8_table_bytes), each output lane written; the
        # operations of its window and band tests
        sb, sp, ro, md, idx, count, k, *outs = args
        n = k if count is None else max(0, min(int(count), k))
        lane_bytes = sum(0 if o is None else o.element_size() for o in outs)
        rows, row_bytes = k8_table_bytes(sb, sp, ro, md, idx, count, k, n)
        r.update(rays=n, lanes=k, rows_read=rows, table_bytes=row_bytes,
                 bound=bound(n * ((4 if idx is not None else 0) + 12
                                  + (4 if md is not None else 0))
                             + row_bytes + k * lane_bytes,
                             n * OPS_SUN_RAY))
    else:
        levels_e, h3d0, _b, _p, _ro, md, idx, count, out = args
        k = out.shape[0]
        n = k if count is None else max(0, min(int(count), k))
        r.update(rays=n, lanes=k, march_steps=beams.last_march_steps,
                 bound=bound(levels_e.numel() * 4 + h3d0.numel() * 4 + 16
                             + n * ((4 if idx is not None else 0) + 12
                                    + (4 if md is not None else 0))
                             + k * 4,
                             n * OPS_SHADOW_SETUP
                             + beams.last_march_steps * OPS_MARCH_STEP))
    return r


def k8_table_bytes(sb, sp, ro, md, idx, count, k, n) -> tuple:
    """(rows, bytes) of K8's sun table that its first ``n`` rays need
    (``_build.launch_k8``'s arguments): the 76 fixed fields of every
    distinct row that a ray inside the window reads, and the 2K band
    fields of every distinct row that a ray reads to its last band (a ray
    neither lit nor blocked, where the bands may claim: no limit or one of
    at least ``d_len``). A row that several rays read counts once (the L2
    serves it again), and a ray that a band blocks counts no band: a
    least count of what the data needs."""
    import torch

    from voxelrs_tpu_torch.ops import beams

    if n == 0:
        return 0, 0
    dev = ro.device
    r = ro[idx[:n].long()] if idx is not None else ro[:n]
    org = torch.tensor(list(sp.origin), dtype=torch.float32, device=dev)
    rox, roz = r[:, 0] - org[0], r[:, 2] - org[1]
    edge = torch.tensor(sp.n1 + 0.125, dtype=torch.float32, device=dev)
    inw = (rox >= -0.125) & (rox < edge) & (roz >= -0.125) & (roz < edge)
    ci = (torch.clamp(torch.floor(rox), 0.0, sp.n1 - 1.0).long() * sp.n1
          + torch.clamp(torch.floor(roz), 0.0, sp.n1 - 1.0).long())
    cnt = torch.tensor([n], dtype=torch.int32, device=dev)
    lit, blk = beams.sun_verdict_masks_plain(
        sb, sp.n1, ro, md, sp.d_len, list(sp.d), list(sp.origin), idx=idx,
        count=cnt, margin=sp.margin)
    bands = torch.ones(n, dtype=torch.bool, device=dev) if md is None else (
        (md[:n] < 0) | (md[:n] >= torch.tensor(sp.d_len, device=dev)))
    full = inw & ~lit[:n] & ~blk[:n] & bands
    n_band = 2 * (sb.shape[1] - 76)  # bytes of a row's 2K band fields
    rows = int(torch.unique(ci[inw]).numel())
    return rows, rows * 152 + int(torch.unique(ci[full]).numel()) * n_band


def k8_table_at(sb, off):
    """A copy of the sun table ``sb`` starting ``off`` bytes (a multiple
    of 4) past a 16-byte word."""
    import torch

    buf = torch.empty(sb.numel() + 8, dtype=sb.dtype, device=sb.device)
    t = buf[off // 2: off // 2 + sb.numel()].view(sb.shape)
    t.copy_(sb)
    return t


def k8_row_word(sb) -> int:
    """The row word (bytes) in which K8 reads table ``sb``: the widest of
    16, 8 and 4 on which every row starts (``vx_k8_sun``)."""
    row, at = sb.shape[1] * 2, sb.data_ptr()
    return next(w for w in (16, 8, 4) if row % w == 0 and at % w == 0)


def k8_widths(args, kw, rounds=K8_WIDTH_ROUNDS) -> dict:
    """K8's launch (``_build.launch_k8``'s arguments) with its table
    copied 0, 8 and 4 bytes past a 16-byte word, so that it takes each row
    word the table's width allows: each held to the plain version (bit for
    bit) and timed alone in turns, ``rounds`` times; a row word's median
    and quartiles (ms)."""
    from voxelrs_tpu_torch import _build

    tables = {}
    for off in (0, 8, 4):
        t = k8_table_at(args[0], off)
        tables.setdefault(k8_row_word(t), t)
    pa = copy_outs("k8", args)
    plain_of("k8")(*pa, **kw)
    runs, eq = {}, True
    for wb, t in tables.items():
        a = copy_outs("k8", [t] + list(args[1:]))
        _build.launch_k8(*a, **kw)
        e, _ = launch_outputs_equal("k8", outs_of("k8", a), outs_of("k8", pa))
        eq = eq and e
        runs[wb] = (a, [])
    for _ in range(rounds):
        for a, ms in runs.values():
            ms.append(kernel_ms(lambda: _build.launch_k8(*a, **kw)))
    return dict(equal=eq, row_bytes=args[0].shape[1] * 2, ms={
        wb: [sorted(ms)[len(ms) * q // 4] for q in (2, 1, 3)]
        for wb, (_a, ms) in runs.items()})


def primary_call(svo, args, kw) -> dict:
    """One spied launch of the primary stage (``_build.launch_kd_primary``'s
    arguments, one frame): ``launch_call`` (the kernel against
    ``kd_primary_plain`` on copies, alone, the plain version's time and
    the parent's kernel), its rays' steps from their floors with the
    frame's cast (K1 / K4 on the same rays: mean, max, and the SIMD
    efficiency of warps of 32 pixels of a row and of 4x8 tiles), K1 / K4
    on the same rays unfloored (steps and time alone), and the
    picoseconds a step of each."""
    import numpy as np
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import adaptive, beams

    r = launch_call("kd_primary", args, kw)
    world, scale, tables, fp, alpha_mode, tf = args[:6]
    csvo = svo.buffer_dtype == np.uint8
    dev = args[6].device
    n = fp.width * fp.height
    lanes = torch.arange(n, device=dev)
    ro, rd = adaptive._frame_rays(fp, lanes)
    md = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    outs = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in (
        (n, torch.float32), (n, torch.int32), (n, torch.int32),
        ((n, 3), torch.float32), ((n, 2), torch.float32),
        (n, torch.float32), (n, torch.bool), (n, torch.int32))]
    if csvo:
        head = (world.words, scale, world.root_ptr, world.total_depth)
        launch = _build.launch_k4
    else:
        head = (world, scale)
        launch = _build.launch_k1
    tb = tables if alpha_mode else None
    floors = None if tf is None else beams.pixel_floors(tf, width=fp.width,
                                                        height=fp.height)
    st = {}
    for key, fl in (("floored", floors), ("unfloored", None)):
        launch(*head, ro, rd, md, fp.primary_budget, alpha_mode, tb, *outs,
               fl)
        steps = outs[7].clone()
        st[key] = warp_stats(steps, lanes // 32)
        st[key]["tiled"] = warp_stats(steps, tiled_warps(lanes, fp.width,
                                                         fp.height))
    k1_ms = kernel_ms(lambda: launch(*head, ro, rd, md, fp.primary_budget,
                                     alpha_mode, tb, *outs, None))
    ps = lambda ms, s: ms * 1e9 / s if s else None  # noqa: E731
    par = (r["parent"] or {}).get("ms")
    r.update(st, k1_ms=k1_ms,
             ps_per_step=ps(r["ms"], st["floored"]["lane_sum"]),
             ps_per_step_parent=None if par is None
             else ps(par, st["floored"]["lane_sum"]),
             k1_ps_per_step=ps(k1_ms, st["unfloored"]["lane_sum"]))
    return r


def kd_shadow_call(svo, args) -> dict:
    """One shadow-stage launch (``_build.launch_kd_shadow``'s arguments):
    its traced slots and their traversal steps (K1 / K4 on the same rays
    from the same floors, judged where the launch judges; their hits equal
    to the kernel's flags), warps of 32 consecutive slots (the slowest
    warp's steps, the SIMD efficiency), the launch alone and at count 0,
    its plain version (the kernel bit for bit equal to it) and, with
    --parent, the parent's kernel; the bound counts the world once, each
    traced slot's index, candidate, origin, floor and flag, and its
    steps."""
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import shading, traversal, traversal_csvo

    (world, scale, tables, fp, am, sro, sidx, scount, tidx, tcount, floors,
     traced) = args
    dev = sro.device
    n = min(int(scount if tidx is None else tcount), sidx.shape[0])
    c = (tidx[:n].long() if tidx is not None
         else torch.arange(n, device=dev))
    ro = sro[sidx[c].long()].contiguous()
    rd = (-torch.tensor(list(fp.light_dir), dtype=torch.float32,
                        device=dev)).expand(ro.shape).contiguous()
    kw = dict(alpha_fn=tables.alpha_fn if am else None,
              max_steps=fp.shadow_budget,
              t_floor=None if floors is None else floors[c].contiguous())
    if isinstance(world, torch.Tensor):
        k1 = traversal.intersect_octree(world, scale, ro, rd, -1.0, am != 0,
                                        **kw)
    else:
        k1 = traversal_csvo.intersect_octree_csvo(
            world.words, scale, world.root_ptr, world.total_depth, ro, rd,
            -1.0, am != 0, **kw)
    kt, pt, tt = traced.clone(), traced.clone(), traced.clone()
    _build.launch_kd_shadow(*args[:11], kt)
    plain_ms = event_ms(lambda: shading.kd_shadow_plain(*args[:11], pt))
    ms = kernel_ms(lambda: _build.launch_kd_shadow(*args[:11], tt))
    count_pos = 7 if tidx is None else 9
    idle = zero_count(args[:11], count_pos)
    ms0 = kernel_ms(lambda: _build.launch_kd_shadow(*idle, tt))
    parent = parent_launch("kd_shadow", list(args[:11]) + [tt], {}, [pt],
                           count_pos)
    st = warp_stats(k1.steps, torch.arange(n, device=dev) // 32)
    return dict(
        lanes=n, floored=floors is not None, sublist=tidx is not None,
        judged=am != 0, steps=st["lane_sum"], launch=st,
        equal=bits_equal(kt, pt) and (parent is None or parent["equal"]),
        vs_k1=int(((k1.t >= 0) != kt[c].bool()).sum()), ms=ms,
        ms_count0=ms0, plain_ms=plain_ms, parent=parent,
        bound=bound(shading.world_tensor(world).numel() * 4
                    + n * (4 + 4 + 12 + 1 + (4 if floors is not None
                                             else 0)),
                    st["lane_sum"] * OPS_PER_STEP))


def shadow_passes(svo, p) -> dict:
    """The shadow passes of pose ``p``'s adaptive frame (two on a dense
    frame) with the sun map, the renderer's branch (certificates, the
    uncertified sub-list traced unfloored), and under VOXELRS_SUN=0, the
    games' branch (every candidate traced from K7's shadow floors): each
    shadow-stage launch (``kd_shadow_call``), each finishing-stage and K7
    shadow launch (``launch_call``), by branch; and under "args" a call of
    each (kd_shadow and kd_finish with the sun map, K7 without) for the
    profiler count."""
    import torch

    from voxelrs_tpu_torch import _build

    out = {n: {} for n in SHADOW_HELD}
    out["args"] = {}
    for branch, sun in (("sun_map", True), ("no_sun_map", False)):
        old = os.environ.get("VOXELRS_SUN")
        if not sun:
            os.environ["VOXELRS_SUN"] = "0"
        try:
            ctx = svo.beam_context(p, W, H)
            spies = {n: Spy(_build, f"launch_{n}") for n in SHADOW_HELD}
            for sp in spies.values():
                sp.__enter__()
            try:
                svo.render(p, W, H, beams=ctx)
            finally:
                for sp in spies.values():
                    sp.__exit__()
        finally:
            if old is None:
                os.environ.pop("VOXELRS_SUN", None)
            else:
                os.environ["VOXELRS_SUN"] = old
        torch.cuda.synchronize()
        if ctx.has_sun() != sun or not svo.last_frame.get("adaptive"):
            fail(f"the adaptive frame's {branch} branch did not run")
        out["kd_shadow"][branch] = [kd_shadow_call(svo, a)
                                    for a, _kw in spies["kd_shadow"].calls]
        for n in ("kd_finish", "k7_shadow"):
            out[n][branch] = [launch_call(n, a, kw)
                              for a, kw in spies[n].calls]
        for n in (("kd_shadow", "kd_finish") if sun else ("k7_shadow",)):
            out["args"][n] = spies[n].calls[0]
    return out


def k6_fixed_ms(dev) -> dict:
    """K6 alone on a 1-lane mask (one tile, one block: the launch and the
    chain of one tile's claim, load, scan and stores) and on 2,073,600
    lanes with none set and size 1 (every tile, the look-back, almost no
    output): what the kernel costs above its bytes."""
    import torch

    from voxelrs_tpu_torch import _build

    out = {}
    for name, n, size in (("one_lane", 1, 1), ("frame_none_set", W * H, 1)):
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        o = torch.empty(size, dtype=torch.int32, device=dev)
        c = torch.empty(1, dtype=torch.int32, device=dev)
        scr = torch.zeros(_build.k6_blocks(n), dtype=torch.int32, device=dev)
        out[name] = kernel_ms(lambda: _build.launch_k6(mask, size, o, c, scr))
    return out


def device_ops(fn, grids=None, traces: int = 3) -> list | None:
    """The names of the operations the card ran for one call of ``fn``
    (kernels, copies, memsets), from a ``torch.profiler`` trace of the
    call: the first of up to ``traces`` traces (one call each) that holds
    device activity (a trace has come back without any), else None.
    ``grids`` None, or a list that receives each kernel's grid and block
    sizes ([x, y, z] each) from that trace's chrome export (nothing where
    it has none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        for _ in range(traces):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                break
        if grids is not None and names:
            from voxelrs_tpu_torch import _build

            # beside the built kernels, a directory .gitignore lists
            path = os.path.join(_build._HERE, "_build", "launch_trace.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
            os.remove(path)
            grids += [dict(grid=e["args"]["grid"], block=e["args"]["block"])
                      for e in trace.get("traceEvents", [])
                      if e.get("cat") == "kernel"
                      and "grid" in e.get("args", {})]
    except Exception as exc:  # reported as not measured
        log(f"torch.profiler: {type(exc).__name__}: {exc}")
        return None
    return names or None


def k6_launch_phase(dev) -> dict:
    """The card operations of one K6 launch call (``_build.launch_k6`` on
    a workspace allocated before), counted from a profiler trace
    (``device_ops``), and with --parent those of the parent's, on a
    frame's mask (2,073,600 lanes, a third set, from a seed) and on a
    batch's mask with starts (5 poses): the kernels a call, which the
    timings do not show."""
    import torch

    from voxelrs_tpu_torch import _build

    g = torch.Generator(device=dev).manual_seed(K6_LAUNCH_SEED)
    out = {}
    libs = [("", _build)] + ([] if PARENT is None else [("parent_", PARENT)])
    for name, n, segs in (("frame", W * H, None), ("batch", POSES * W * H,
                                                   POSES)):
        mask = torch.rand(n, generator=g, device=dev) < 1 / 3
        st = None if segs is None else torch.empty(segs, dtype=torch.int32,
                                                   device=dev)
        o = torch.empty(n, dtype=torch.int32, device=dev)
        c = torch.empty(1, dtype=torch.int32, device=dev)
        r = out[name] = dict(lanes=n)
        for key, lib in libs:
            scr = torch.zeros(max(1, lib.k6_blocks(n)), dtype=torch.int32,
                              device=dev)
            lib.launch_k6(mask, n, o, c, scr, st)  # warm-up
            ops = device_ops(lambda: lib.launch_k6(mask, n, o, c, scr, st))
            r[key + "ops"] = ops
            r[key + "launches"] = None if ops is None else len(ops)
        del mask, o
    torch.cuda.synchronize()
    return out


def launch_ops_phase(calls) -> dict:
    """The card operations of one launch call of each kernel of ``calls``
    (name: a spied call's (args, kw), on pose 0's own inputs of the ESVO
    adaptive frame), counted from a profiler trace (``device_ops``), and
    with --parent those of the parent's kernels."""
    from voxelrs_tpu_torch import _build

    libs = [("", _build)] + ([] if PARENT is None else [("parent_", PARENT)])
    out = {}
    for name, (args, kw) in calls.items():
        a = copy_outs(name, args)
        r = out[name] = {}
        for key, lib in libs:
            launch = getattr(lib, f"launch_{name}")
            launch(*a, **kw)  # warm-up
            grids = []
            ops = device_ops(lambda: launch(*a, **kw), grids)
            r[key + "ops"] = ops
            r[key + "launches"] = None if ops is None else len(ops)
            r[key + "grids"] = grids or None
    return out


# the kernels whose ptxas lines the build reports (this tree's and, with
# --parent, the parent's): K1, K4 and every kernel with a CSVO
# instantiation in both formats (K3, K5, kd_primary, kd_shadow, K9's and
# K9-judged's traces), the shadow pass's kernels and both finalizes
PTXAS_KERNELS = {"k1_traverse": "k1_traverse_kernel",
                 "k9j_merge": "k9j_merge_kernel",
                 "k4_traverse": "k4_traverse_kernel",
                 "k5_picker": "k5_picker_kernel",
                 "kd_primary": "kd_primary_kernel",
                 "k9_trace": "k9_trace_kernel",
                 "k9_finalize": "k9_finalize_kernel",
                 "k9j_finalize": "k9j_finalize_kernel",
                 "k3_frame": "k3_frame_kernel", "k9j_trace": "k9j_trace_kernel",
                 "kd_shadow": "kd_shadow_kernel",
                 "k9_shadow_cells": "k9_shadow_cells_kernel",
                 "kd_finish": "kd_finish_kernel",
                 "k7_shadow": "k7_shadow_kernel",
                 "k7_tiles": "k7_tile_kernel", "k8_sun": "k8_sun_kernel"}


def ptxas_of(build_log: str) -> dict:
    """The ptxas summary (registers, spill stores and loads, shared and
    stack bytes) of each kernel of PTXAS_KERNELS in an ``-Xptxas -v`` build
    log, by instantiation (``k3_frame_esvo``, ``k3_frame_csvo`` ...; a
    kernel of no world format by its name): the lines from its "Compiling
    entry" to its "Used N registers"."""
    import re

    out, key = {}, None
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            key = None
            for name, fn in PTXAS_KERNELS.items():
                if fn in line:
                    # K8's instantiations by the bytes of its row words
                    words = re.search(r"k8_sun_kernelILi(\d+)E", line)
                    key = name + ("_csvo" if "CsvoWorld" in line else
                                  "_esvo" if "EsvoWorld" in line else
                                  f"_w{words.group(1)}" if words else
                                  "_staged" if "k7_tile_kernelILb1E" in line
                                  else "")
            continue
        if key is None:
            continue
        for field, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                           ("spill_stores", r"(\d+) bytes spill stores"),
                           ("spill_loads", r"(\d+) bytes spill loads"),
                           ("registers", r"Used (\d+) registers"),
                           ("shared_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                out.setdefault(key, {})[field] = int(m.group(1))
        if "registers" in line:
            key = None
    return out


def sass_widths(names=("k9_trace", "k9j_merge", "k9_merge", "k9_finalize",
                       "kd_primary", "k8_sun", "k7_tile",
                       "k9_shadow_cells", "kd_shadow", "kd_finish",
                       "k7_shadow", "k3_frame", "k9j_trace", "k9j_finalize",
                       "k4_traverse", "k1_traverse")) -> dict:
    """The global and shared loads and stores of the K9 kernels, the
    shadow and finishing stages, K7's shadow floors, K3, K9-judged's trace
    and finalize, K4 and K1 in the built library's SASS (``cuobjdump
    -sass``), counted
    by width (.128 = 16-byte words, .64, and 32 bits and less): per kernel,
    instruction counts in the code, not executions. None where the toolkit
    has no cuobjdump."""
    import re
    import shutil

    from voxelrs_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = os.path.join(_build._HERE, "_build", _build.source_digest(),
                       _build.LIB_NAME)
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    out, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((n for n in names if n in m.group(1)), None)
            words = re.search(r"k8_sun_kernelILi(\d+)E", m.group(1))
            key = None if fn is None else (
                fn + ("_csvo" if "Csvo" in m.group(1) else "")
                + (f"_w{words.group(1)}" if words else "")
                + ("_staged" if "k7_tile_kernelILb1E" in m.group(1)
                   else ""))
            continue
        m = re.search(r"\b(LDG|STG|LDS|STS)(\.\S+)?\s", line)
        if key and m:
            mods = m.group(2) or ""
            w = ("128" if ".128" in mods else "64" if ".64" in mods
                 else "32")
            d = out.setdefault(key, {})
            d[f"{m.group(1)}.{w}"] = d.get(f"{m.group(1)}.{w}", 0) + 1
    return out


def sass_loop(lines) -> dict | None:
    """The traversal loop of one kernel's SASS (``cuobjdump -sass`` lines):
    the back-edge of the widest span is the loop's; its instructions from
    head to back-edge, and the fewest a trip around it issues (the
    shortest path from the head to the back-edge over fall-throughs and
    branch targets: a step that neither hits, pushes nor pops). None
    without a back-edge."""
    import heapq
    import re

    ins = []
    for line in lines:
        m = re.match(r"\s+/\*([0-9a-f]+)\*/\s+(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    at = {a: k for k, (a, _) in enumerate(ins)}

    def target(t):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
        return int(m.group(1), 16) if m else None

    back = [(a, target(t)) for a, t in ins
            if target(t) is not None and target(t) < a]
    if not back:
        return None
    end, head = max(back, key=lambda b: b[0] - b[1])
    start, goal = at[head], at[end]
    dist, pq = {start: 1}, [(1, start)]
    while pq:
        d, k = heapq.heappop(pq)
        if k == goal:
            break
        if d > dist.get(k, 1 << 30):
            continue
        t = ins[k][1]
        tg, cond = target(t), t.startswith("@")
        nxt = [] if re.search(r"\b(EXIT|RET)\b", t) and not cond else (
            ([at[tg]] if tg in at else []) + ([k + 1] if cond else [])
            if tg is not None else [k + 1])
        for n in nxt:
            if start <= n <= goal and d + 1 < dist.get(n, 1 << 30):
                dist[n] = d + 1
                heapq.heappush(pq, (d + 1, n))
    return dict(loop_instructions=goal - start + 1,
                shortest_step=dist.get(goal))


SASS_LOOPS = ("k1_traverse_kernel", "k5_picker_kernel", "kd_primary_kernel")


def sass_dump(build) -> dict:
    """The SASS of ``build``'s library (``cuobjdump -sass``): each
    kernel's instruction count (every instantiation), and for the kernels
    of SASS_LOOPS (ESVO instantiations) their traversal loop
    (``sass_loop``). None where the toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = os.path.join(build._HERE, "_build", build.source_digest(),
                       build.LIB_NAME)
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    counts, texts, fn = {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[fn] = counts.get(fn, 0) + 1
            texts.setdefault(fn, []).append(line)
    loops = {name: sass_loop(lines) for name in SASS_LOOPS
             for fn, lines in texts.items()
             if name in fn and "Csvo" not in fn}
    return dict(instructions=counts, loops=loops)


def k6_summary(rows) -> dict:
    """K6's calls of one path, summed."""
    par = [r["parent_ms"] for r in rows]
    return dict(calls=len(rows), equal=all(r["equal"] for r in rows),
                err=max((r["err"] for r in rows), default=0.0),
                ms=sum(r["ms"] for r in rows),
                parent_ms=None if None in par else sum(par),
                library_ms=sum(r["library_ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound"][0] for r in rows))


def log_k6(label: str, rows, card) -> None:
    for i, r in enumerate(rows):
        par = ("" if r["parent_ms"] is None
               else f", parent's K6 {r['parent_ms']:.4f} ms")
        log(f"k6 {label} call {i}: {r['lanes']} lanes, {r['set']} set, size "
            f"{r['size']}" + ("" if r["starts"] is None
                              else f", {r['starts']} starts")
            + f"; equal {r['equal']}; alone {r['ms']:.4f} ms"
            f"{par}, torch.nonzero + pad {r['library_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) on {card}")
    sm = k6_summary(rows)
    log(f"k6 {label}: {sm['calls']} calls, equal {sm['equal']}; sum "
        f"{sm['ms']:.4f} ms" + ("" if sm["parent_ms"] is None else
                                f" (parent's {sm['parent_ms']:.4f} ms)")
        + f", torch.nonzero + pad {sm['library_ms']:.4f} ms, bound "
        f"{sm['bound_ms']:.4f} ms on {card}")


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
    event is queued behind the warm-up and a spin of the card
    (``torch.cuda._sleep``, longer than the host takes to queue the
    launches), so the host time of the launches is not counted even where
    a launch takes the card less time than the host takes to queue it."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    launch()
    torch.cuda._sleep(KERNEL_SLEEP_CYCLES)
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
    img = svo.render(p, 128, 96, max_steps=300, mode="fused").cpu().numpy()
    golden = np.load(os.path.join(repo, "tests", "goldens", "render_basic.npy"))
    return float(np.abs(img.astype(np.float64) - golden).mean())

class PickerRecorder:
    """Stands in for ``ops.picker.pick`` inside ``graphics.svo``: calls
    it, and keeps each batch (numpy), its rows and the world it was cast
    on (one device copy per buffer state, ESVO or CSVO), for the
    comparison after the run; with ``timed`` it also keeps each pick's
    host microseconds and whether the stream had work queued before it
    (``torch.cuda.Stream.query``, asked before the pick). With ``legacy``
    it picks through ``launch_and_copy`` (the parent's round trip)
    instead."""

    def __init__(self, pick):
        self.pick = pick
        self.buffers = {}  # (address, version, words, root, depth) -> copy
        self.batches = []  # (buffer key, octree_scale, tasks, rows)
        self.timed = False
        self.legacy = False
        self.times = []  # (us, the stream idle before the pick, legacy)

    def __call__(self, desc, octree_scale, tasks, buffers):
        import torch

        from voxelrs_tpu_torch.ops.traversal_csvo import CsvoBuffer

        idle = (torch.cuda.current_stream().query() if self.timed
                else None)
        t0 = time.perf_counter()
        rows = (launch_and_copy if self.legacy else self.pick)(
            desc, octree_scale, tasks, buffers)
        if self.timed:
            self.times.append(((time.perf_counter() - t0) * 1e6, idle,
                               self.legacy))
        csvo = isinstance(desc, CsvoBuffer)
        buf = desc.words if csvo else desc
        key = (buf.data_ptr(), buf._version, buf.numel(),
               tuple(desc[1:]) if csvo else None)
        if key not in self.buffers:
            self.buffers[key] = (desc._replace(words=buf.clone()) if csvo
                                 else buf.clone())
        self.batches.append((key, octree_scale, tasks.copy(), rows.copy()))
        return rows


def launch_and_copy(desc, octree_scale, tasks, buffers):
    """The parent's pick, its ``Svo.raycast``'s body: the padded numpy
    tasks uploaded from pageable memory, K5 launched
    (``ops.picker.raycast``) and its rows copied back by a blocking
    ``.cpu()``, three calls that each give up the interpreter lock
    (``buffers`` only names the device)."""
    import torch

    from voxelrs_tpu_torch.ops import picker

    return picker.raycast(desc, octree_scale, torch.from_numpy(tasks).to(
        buffers.device)).cpu().numpy()


def driver_copy():
    """``copy(dst, src)``: a device-to-device copy of the contiguous CUDA
    tensor ``src`` into the first bytes of ``dst`` on the current stream,
    through the CUDA driver's ``cuMemcpyDtoDAsync`` called from a
    ``ctypes.PyDLL``, which keeps the interpreter lock over the call (a
    torch copy gives it up, and the game's job threads then hold it for
    up to a switch interval)."""
    import ctypes

    import torch

    fn = ctypes.PyDLL("libcuda.so.1").cuMemcpyDtoDAsync_v2
    fn.argtypes = [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_size_t,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def copy(dst, src):
        n = src.numel() * src.element_size()
        if (not (src.is_contiguous() and dst.is_contiguous())
                or dst.numel() * dst.element_size() < n):
            raise ValueError("driver_copy: contiguous tensors, dst at "
                             "least as large")
        err = fn(dst.data_ptr(), src.data_ptr(), n,
                 torch.cuda.current_stream(src.device).cuda_stream)
        if err:
            raise RuntimeError(f"cuMemcpyDtoDAsync: CUresult {err}")

    return copy


class CompactRecorder:
    """Stands in for ``ops.compact.compact_indices``: calls it, and copies
    each call's mask, indices and count into rows of tables allocated
    before the run, so that every K6 call of a game run is held to the
    plain version after the run. The copies allocate nothing and keep the
    interpreter lock (``driver_copy``), so the game's frames keep their
    timing."""

    def __init__(self, fn, lanes: int, calls: int, dev):
        import torch

        self.fn = fn
        self.copy = driver_copy()
        self.masks = torch.empty((calls, lanes), dtype=torch.bool, device=dev)
        self.outs = torch.empty((calls, lanes), dtype=torch.int32, device=dev)
        self.counts = torch.empty(calls, dtype=torch.int32, device=dev)
        self.calls = []  # (lanes, size) of each call, in the tables' rows
        self.missed = 0  # calls past the tables' rows or wider than a row

    def __call__(self, mask, size, **kw):
        idx, count = self.fn(mask, size, **kw)
        k, n = len(self.calls), mask.shape[0]
        if (k >= self.counts.shape[0] or n > self.masks.shape[1]
                or size > self.outs.shape[1] or kw.get("starts") is not None):
            self.missed += 1
        else:
            self.copy(self.masks[k, :n], mask)
            self.copy(self.outs[k, :size], idx)
            self.copy(self.counts[k:k + 1], count)
            self.calls.append((n, size))
        return idx, count

    def check(self) -> dict:
        """Every recorded call against ``compact_indices_plain``."""
        import torch

        from voxelrs_tpu_torch.ops import compact

        bad = 0
        for k, (n, size) in enumerate(self.calls):
            pi, pc = compact.compact_indices_plain(self.masks[k, :n], size)
            bad += not (torch.equal(self.outs[k, :size], pi)
                        and torch.equal(self.counts[k:k + 1], pc))
        return dict(k6_calls=len(self.calls), k6_bad=bad,
                    k6_missed=self.missed,
                    k6_ok=bad == 0 and self.missed == 0
                    and len(self.calls) > 0)


def play_game(game, recorder):
    """Load the game's world, then play the scripted run with ``recorder``
    in place of the picker's kernel call, its frames taking turns between
    the one-call pick and the parent's round trip (``launch_and_copy``).
    Returns the run's numbers."""
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
    legacy = {k: [] for k in spans}  # each span: run in a launch-and-copy turn
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
            legacy[name].append(recorder.legacy)
            return r
        return run

    by_part = {}  # part of the run -> [(frame s, {span: s}, busy jobs)]
    gsvo = world.world_svo.graphics_svo
    modes = {"deferred": 0, "sun": 0, "beams": 0, "adaptive": 0}

    def frame(part):
        """One frame, timed from the call to the finished frame, then paced
        to 60 Hz as a display paces the game: the job threads stream chunks
        in the rest of the 1/60 s (the pause is not in the frame time)."""
        n0 = {k: len(v) for k, v in spans.items()}
        recorder.legacy = len(frame_s) % 2 == 1  # the two picks in turns
        busy = game.job_system.len()  # queued + running jobs
        t0 = time.perf_counter()
        img = game.step_frame(dt=1 / 60, render=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frame_s.append(t1 - t0)
        for k in modes:  # what the frame ran: its mode, beams, sun map
            modes[k] += bool(gsvo.last_frame.get(k)) if k != "deferred" \
                else gsvo.last_frame.get("mode") == "deferred"
        by_part.setdefault(part, []).append(
            (t1 - t0, {k: sum(v[n0[k]:]) for k, v in spans.items()}, busy))
        time.sleep(max(0.0, 1 / 60 - (t1 - t0)))
        return img

    for obj, attr, name, sync in timed:
        setattr(obj, attr, span(name, getattr(obj, attr), sync))
    svo_mod = sys.modules["voxelrs_tpu_torch.graphics.svo"]
    svo_mod.pick = recorder
    recorder.timed = True  # each pick's round trip under the job threads
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
        svo_mod.pick = recorder.pick
        recorder.timed = recorder.legacy = False
    out["run_s"] = ph.seconds
    out["frames"] = len(frame_s)
    out.update(deferred_frames=modes["deferred"], beam_frames=modes["beams"],
               sun_frames=modes["sun"], adaptive_frames=modes["adaptive"])
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

    def span_ms(name, side):
        xs = sorted(x for x, lg in zip(spans[name], legacy[name])
                    if lg == side)
        return dict(n=len(xs), mean=sum(xs) / max(1, len(xs)) * 1e3,
                    median=xs[len(xs) // 2] * 1e3 if xs else None)

    def picks_us(side):
        times = [(us, idle) for us, idle, lg in recorder.times if lg == side]
        rt = sorted(us for us, _ in times)
        return dict(
            picks=len(rt), median=rt[len(rt) // 2] if rt else None,
            p90=rt[int(0.9 * len(rt))] if rt else None,
            max=rt[-1] if rt else None,
            stream_busy_share=(sum(not idle for _, idle in times)
                               / max(1, len(times))))

    # the physics span a step (World.update_fixed runs one step a call), the
    # look ray's span and each pick of the run (Svo.raycast past its memo)
    # under the job threads: the one-call pick's frames, and the frames in
    # between, which picked through the parent's launch and copy
    for key, side in (("", False), ("_launch_and_copy", True)):
        out["physics_ms_per_step" + key] = span_ms("physics", side)
        out["look_ray_ms" + key] = span_ms("look ray", side)
        out["pick_under_load_us" + key] = picks_us(side)

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
        f"landed {landed}, edit {out['edit']} ok {out['edit_ok']}; "
        f"{out['deferred_frames']} frames deferred, {out['adaptive_frames']} "
        f"of them adaptive, {out['beam_frames']} with beams, "
        f"{out['sun_frames']} with a sun map")
    log(f"game frame ({fmt}; step_frame + synchronize, {game.args.width}x"
        f"{game.args.height}): median "
        f"{out['frame_ms_median']:.3f} ms, p90 {out['frame_ms_p90']:.3f} ms, "
        f"p99 {out['frame_ms_p99']:.3f} ms, "
        f"max {out['frame_ms_max']:.3f} ms; K5 {out['k5_per_frame']:.2f} "
        f"launches/frame, {out['physics_steps']} physics steps")
    for key, what in (("", "Svo.raycast's one native call"),
                      ("_launch_and_copy", "the parent's launch and copy, "
                       "the frames in between")):
        log(f"game picks ({fmt}; {what}, host clock, during the scripted "
            f"run with the job threads streaming): "
            f"{json.dumps(out['pick_under_load_us' + key])} us; the physics "
            f"span a step {json.dumps(out['physics_ms_per_step' + key])} ms;"
            f" the look ray's span {json.dumps(out['look_ray_ms' + key])} ms")
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

    from voxelrs_tpu_torch.ops import shading

    fmt = game.args.svo_format
    out, chains = k5_checks(game, recorder)

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
    with Phase(f"sun map (streamed world, {fmt})"):
        # the streaming engine builds the sun map on a thread once the world
        # is quiet: keep rendering (paced to 60 Hz) until it attaches
        hf = world.world_svo.heightfield
        t0 = time.perf_counter()
        waited = 0
        while not gsvo.last_frame.get("sun") and \
                time.perf_counter() - t0 < SUN_WAIT_S:
            game.step_frame(dt=1 / 60, render=True)
            torch.cuda.synchronize()
            waited += 1
            time.sleep(1 / 60)
        out.update(sun_wait_frames=waited,
                   sun_wait_s=time.perf_counter() - t0,
                   sun_attached=bool(gsvo.last_frame.get("sun")),
                   sun_build_s=[round(x, 3) for x in hf.sun_build_seconds],
                   sun_mb=(hf._sun[3].numel() * 2 / 1e6 if hf._sun else 0.0),
                   sun_shape=(tuple(hf._sun[3].shape) if hf._sun else None))
    log(f"sun map ({fmt}): attached {out['sun_attached']} after "
        f"{waited} more frames ({out['sun_wait_s']:.1f} s); builds "
        f"{out['sun_build_s']} s on its thread; table {out['sun_shape']}, "
        f"{out['sun_mb']:.1f} MB on the card")
    # the game's pyramid is larger than a tile block stages: its K7 tile
    # launch takes the instantiation that reads it from global memory
    held = Held(("k9_shadow_cells",) + SHADOW_HELD + BEAM_HELD)
    with Phase(f"deferred vs k3 and vs plain (streamed world, {fmt})"):
        p = world.world_svo.svo_params(world.render_params(W / H))
        fused = gsvo.render(p, W, H, mode="fused")
        with held:
            ctx = gsvo.beam_context(p, W, H)
            deferred = gsvo.render(p, W, H, beams=ctx, adaptive=False)
        info = dict(gsvo.last_frame)
        d = max_abs(deferred, fused)
        dp = max_abs(deferred, plain_deferred(gsvo, p, ctx))
    out["deferred_game_err"], out["deferred_game_plain_err"] = d, dp
    out["deferred_game_ok"] = d <= K3_MAX_ABS and dp <= K3_MAX_ABS
    log(f"deferred vs k3 on the streamed {fmt} buffer (final pose, "
        f"{json.dumps(info)}): max |d| {d:.3g}; vs the plain deferred frame "
        f"max |d| {dp:.3g} (tolerance {K3_MAX_ABS:g}); ok "
        f"{out['deferred_game_ok']}")

    with Phase(f"adaptive vs plain, three paths timed (streamed world, "
               f"{fmt})"):
        with held:
            adaptive_img = gsvo.render(p, W, H, beams=ctx)
            info = dict(gsvo.last_frame)
            # the games' branch while no sun map is attached: K7's floors
            gsvo.render(p, W, H, beams=ctx.without_sun())
        da = max_abs(adaptive_img, plain_adaptive(gsvo, p, ctx))
        # the final exact frame's first tile and K8 launches, timed below
        beam_calls = {n: held.spies[n].calls[:1] for n in BEAM_HELD}
        out["held"] = held.check()
        paths = {}
        for path, kw in (("adaptive", {}), ("exact", dict(adaptive=False)),
                         ("fused", dict(mode="fused"))):
            gsvo.render(p, W, H, beams=ctx, **kw)  # warm-up
            paths[path] = event_ms(lambda: gsvo.render(p, W, H, beams=ctx,
                                                       **kw))
    out["adaptive_game_err"], out["paths_ms"] = da, paths
    out["adaptive_game_ok"] = da <= K3_MAX_ABS and bool(info.get("adaptive"))
    log(f"k9 shadow cells, kd_shadow, kd_finish, k7_shadow, k7_tiles and "
        f"k8 vs their plain versions on every call of the final exact frame "
        f"and the final adaptive frame, with the sun map and without "
        f"({fmt}; bit for bit): {json.dumps(out['held'])}")
    if not held_ok(out["held"],
                   branch=() if out["sun_attached"] else ("k8",)):
        fail(f"K9's shadow cells, kd_shadow, kd_finish, K7's shadow or tile "
             f"floors or K8 disagree with their plain versions in the {fmt} "
             "game's final frames")
    log(f"adaptive vs its plain version on the streamed {fmt} buffer (final "
        f"pose, {json.dumps(info)}): max |d| {da:.3g} (tolerance "
        f"{K3_MAX_ABS:g}); ok {out['adaptive_game_ok']}; one frame each, "
        f"call to done, same buffer: {json.dumps(paths)} ms on {card}")

    with Phase(f"k7 tile floors and k8 alone (streamed world, {fmt})"):
        # the final exact frame's tile launch (its pyramid read from global
        # memory) and K8 launch (the game's map), each alone, at count 0
        # and against the parent's kernel; K8 in each row word its table
        # allows
        out["k7_tiles_call"] = launch_call("k7_tiles",
                                           *beam_calls["k7_tiles"][0])
        k8s = beam_calls["k8"]
        out["k8_call"] = launch_call("k8", *k8s[0]) if k8s else None
        out["k8_row_words"] = k8_widths(*k8s[0]) if k8s else None
    tc, kc, kw8 = out["k7_tiles_call"], out["k8_call"], out["k8_row_words"]
    log(f"k7 tile floors alone ({fmt} game, the final exact frame's launch, "
        f"{tc['tiles']} tiles, the pyramid {tc['pyramid_ints']} ints): "
        f"equal {tc['equal']}, {tc['ms']:.4f} ms, without the march "
        f"{tc['ms_no_march']:.4f}, the parent's "
        f"{(tc['parent'] or {}).get('ms')}; the longest march "
        f"{tc['march_max']} iterations ({tc['march_descents']} descents) "
        f"on {card}")
    if kc is not None:
        log(f"k8 alone ({fmt} game, the final exact frame's launch, "
            f"{kc['rays']} rays of {kc['lanes']}, {kc['rows_read']} rows): "
            f"equal {kc['equal'] and kw8['equal']}, {kc['ms']:.4f} ms, at "
            f"count 0 {kc['ms_count0']:.4f}, the parent's "
            f"{json.dumps(kc['parent'])}; bound {kc['bound'][0]:.5f} "
            f"({kc['bound'][1]}); {kw8['row_bytes']}-byte rows as 16- / 8- "
            f"/ 4-byte words (those the width allows), median [quartiles] of "
            f"{K8_WIDTH_ROUNDS} turns: {json.dumps(kw8['ms'])} ms on {card}")
    if not tc["equal"] or (kc is not None
                           and not (kc["equal"] and kw8["equal"])):
        fail(f"K7's tile floors or K8 alone disagree with their plain "
             f"versions in the {fmt} game")

    out.update(k5_timing(game, recorder, chains, card))
    return out


def k5_checks(game, recorder):
    """K5 on every batch ``recorder`` kept of a game run: the one-call
    pick's rows against the plain version and against the launch-and-copy
    path (``ops.picker.raycast``, then a copy), and every shape
    (K5_SHAPES) against the plain version. Returns the numbers and each
    batch's longest chain (the classic loop's steps) with its buffer."""
    import numpy as np
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import picker, traversal_csvo
    from voxelrs_tpu_torch.ops.traversal import MAX_STEPS, step_budget

    fmt = game.args.svo_format
    out = {}
    dev = game.world.world_svo.graphics_svo.device_buf.device
    csvo = fmt == "csvo"
    budget = (traversal_csvo.step_budget if csvo else step_budget)(MAX_STEPS)
    with Phase(f"k5 vs plain ({fmt})"):
        by_buffer = {}
        for key, scale, tasks, rows in recorder.batches:
            by_buffer.setdefault((key, scale), []).append((tasks, rows))
        bad = bad_old = 0
        bad_shape = {s_: 0 for s_ in K5_SHAPES}
        k5_err = 0.0
        chains = []  # (longest chain, buffer key, scale, tasks) a batch
        for (key, scale), items in by_buffer.items():
            buf = recorder.buffers[key]
            tasks = torch.from_numpy(np.concatenate([t for t, _ in items])
                                     ).to(dev)
            rows = torch.from_numpy(np.concatenate([r for _, r in items])
                                    ).to(dev)
            ref = picker.raycast_plain(buf, scale, tasks)
            bad += int((rows != ref).any(1).sum())
            k5_err = max(k5_err, float((rows - ref).abs().max()))
            bad_old += int((picker.raycast(buf, scale, tasks).cpu()
                            != rows.cpu()).any(1).sum())
            for seg in K5_SHAPES:
                kout = torch.empty_like(rows)
                st = torch.empty(len(tasks), dtype=torch.int32, device=dev)
                _build.launch_k5(buf, float(scale), tasks, budget, kout, st,
                                 segments=seg)
                bad_shape[seg] += int((kout != ref).any(1).sum())
                if seg == 1:  # the classic loop's steps: each batch's chain
                    at = 0
                    for t, _ in items:
                        chains.append((int(st[at:at + len(t)].max()), key,
                                       scale, t))
                        at += len(t)
    n_tasks = sum(t.shape[0] for _, _, t, _ in recorder.batches)
    out.update(k5_batches=len(recorder.batches), k5_tasks=n_tasks,
               k5_buffers=len(recorder.buffers), k5_bad=bad, k5_err=k5_err,
               k5_bad_vs_launch_and_copy=bad_old,
               k5_bad_shapes={str(k): v for k, v in bad_shape.items()},
               k5_ok=bad == 0 and bad_old == 0
               and not any(bad_shape.values())
               and len(recorder.batches) > 0)
    log(f"k5 vs plain ({fmt}): {len(recorder.batches)} batches, {n_tasks} "
        f"tasks, {len(recorder.buffers)} buffer states; the one-call "
        f"pick's tasks differing {bad} (max |d| {k5_err:.3g}), from the "
        f"launch-and-copy path's {bad_old}; each shape's (segments: tasks "
        f"differing) {json.dumps(out['k5_bad_shapes'])}; ok {out['k5_ok']}")

    return out, chains


def k5_timing(game, recorder, chains, card) -> dict:
    """K5's shapes and the parent's K5 on batches of the run (the last
    sweep, the last look ray, the batch of the longest chain), the shipped
    shape alone and at its fixed cost, the plain version, the wrapper's
    host time, and the pick's round trip with the game quiet."""
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import picker, traversal_csvo
    from voxelrs_tpu_torch.ops.traversal import MAX_STEPS, step_budget

    fmt = game.args.svo_format
    gsvo = game.world.world_svo.graphics_svo
    dev = gsvo.device_buf.device
    scale = float(gsvo.octree_scale)
    csvo = fmt == "csvo"
    budget = (traversal_csvo.step_budget if csvo else step_budget)(MAX_STEPS)
    out = {}
    with Phase(f"k5 timing ({fmt})"):
        # batches of the run: the last AABB sweep, the last look ray, and
        # the batch of the longest chain (the classic loop's steps); each
        # shape and the parent's K5 on the same inputs
        desc = gsvo.world()
        sweep = next(t for _, _, t, _ in reversed(recorder.batches)
                     if t.shape[0] >= 32)
        look = next(t for _, _, t, _ in reversed(recorder.batches)
                    if t.shape[0] == 8)
        longest = max(chains, key=lambda c: c[0])
        cases = {"sweep": (desc, scale, sweep), "look": (desc, scale, look),
                 "longest": (recorder.buffers[longest[1]], longest[2],
                             longest[3])}
        shapes = {}
        for label, (w, sc, t) in cases.items():
            tasks = torch.from_numpy(t).to(dev)
            n = tasks.shape[0]
            ref = picker.raycast_plain(w, sc, tasks)
            row = dict(tasks=n)
            for seg in K5_SHAPES:
                rows = torch.empty((n, 8), dtype=torch.float32, device=dev)
                steps = torch.empty(n, dtype=torch.int32, device=dev)
                _build.launch_k5(w, float(sc), tasks, budget, rows, steps,
                                 segments=seg)
                row[f"s{seg}"] = dict(
                    equal=bool(torch.equal(rows, ref)),
                    chain=int(steps.max()), steps=int(steps.sum()),
                    ms=[kernel_ms(lambda: _build.launch_k5(
                        w, float(sc), tasks, budget, rows, segments=seg))
                        for _ in range(3)])
            if PARENT is not None:
                prow = torch.empty((n, 8), dtype=torch.float32, device=dev)
                PARENT.launch_k5(w, float(sc), tasks, budget, prow)
                row["parent"] = dict(
                    equal=bool(torch.equal(prow, ref)),
                    ms=[kernel_ms(lambda: PARENT.launch_k5(
                        w, float(sc), tasks, budget, prow))
                        for _ in range(3)])
            shapes[label] = row
        tasks = torch.from_numpy(sweep).to(dev)
        n = tasks.shape[0]
        rows = torch.empty((n, 8), dtype=torch.float32, device=dev)
        steps = torch.empty(n, dtype=torch.int32, device=dev)
        _build.launch_k5(desc, scale, tasks, budget, rows, steps, segments=1)
        k5_steps, k5_chain = int(steps.sum()), int(steps.max())
        k5_ms = kernel_ms(lambda: _build.launch_k5(desc, scale, tasks,
                                                   budget, rows))
        # the launch's fixed cost: one task that starts outside the world
        # and leaves it
        one = torch.tensor([[1.0, -1e4, -1e4, -1e4, -1.0, 0.0, 0.0]],
                           device=dev)
        one_rows = torch.empty((1, 8), dtype=torch.float32, device=dev)
        one_steps = torch.empty(1, dtype=torch.int32, device=dev)
        _build.launch_k5(desc, scale, one, budget, one_rows, one_steps)
        k5_fixed_steps = int(one_steps)
        k5_fixed_ms = kernel_ms(lambda: _build.launch_k5(desc, scale, one,
                                                         budget, one_rows))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        picker.raycast_plain(desc, scale, tasks)
        b.record()
        b.synchronize()
        k5_plain_ms = a.elapsed_time(b)
        k5_host = host_us(lambda: picker.raycast(desc, scale, tasks))
        # the physics step's picker call (the world's Svo.raycast) with the
        # memo cleared, the game quiet: the serialization and one native
        # call (upload, K5, copy back, wait)
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
        # the pick alone (ops.picker.pick on the sweep's tasks), quiet
        pick_us = host_us(lambda: picker.pick(desc, scale, sweep,
                                              gsvo._pick_buffers))
    k5_bytes = n * (28 + 32) + k5_steps * (CSVO_BYTES_PER_STEP if csvo
                                           else BYTES_PER_STEP)
    k5_bound = bound(k5_bytes, k5_steps * OPS_PER_STEP)
    out.update(k5_ms=k5_ms, k5_plain_ms=k5_plain_ms, k5_host_us=k5_host,
               k5_round_trip_us=round_trip_us, k5_pick_us=pick_us,
               k5_bound=k5_bound, k5_steps=k5_steps, k5_chain=k5_chain,
               k5_n=n, k5_fixed_ms=k5_fixed_ms,
               k5_fixed_steps=k5_fixed_steps, k5_shapes=shapes)
    log(f"k5 alone ({fmt}; the last sweep: {n} tasks, {k5_steps} steps, its "
        f"longest task {k5_chain}; {KERNEL_REPS} back-to-back launches, the "
        f"shipped shape, {_build.K5_SEGMENTS} lanes a task): {k5_ms:.4f} "
        f"ms; its fixed cost (one task outside the world, {k5_fixed_steps} "
        f"steps) {k5_fixed_ms:.4f} ms; plain {k5_plain_ms:.1f} ms; wrapper "
        f"host time {k5_host:.1f} us; Svo.raycast round trip (serialize, "
        f"one native call: upload, K5, copy back, wait), the game quiet, "
        f"median {round_trip_us:.1f} us, ops.picker.pick alone "
        f"{pick_us:.1f} us; bound {k5_bound[0]:.3g} ms ({k5_bound[1]}) on "
        f"{card}")
    log(f"k5 shapes ({fmt}; segments a task: equal to the plain version, "
        f"the longest lane chain, steps, ms of 3 timings; the parent's K5 "
        f"on the same inputs): {json.dumps(shapes)} on {card}")
    if not all(r[f"s{seg}"]["equal"] for r in shapes.values()
               for seg in K5_SHAPES) or not all(
            r.get("parent", {}).get("equal", True) for r in shapes.values()):
        fail(f"a K5 shape disagrees with the plain version ({fmt})")
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
    global PARENT
    if "--parent" in sys.argv:
        import importlib

        load_parent(sys.argv[sys.argv.index("--parent") + 1])
        PARENT = importlib.import_module("parent_vx._build")
    with Phase("build"):
        # the parent's kernels (with --parent) build in a second nvcc
        # started beside this tree's
        errs = []

        def build_parent():
            try:
                PARENT.library()
            except Exception as exc:  # reported below
                errs.append(exc)

        th = threading.Thread(target=build_parent) if PARENT else None
        if th:
            th.start()
        _build.library()
        libs = native.loaded()
        if th:
            th.join()
    if errs:
        fail(f"the parent's kernels did not build: {errs[0]}")
    log(f"build: {_build.build_seconds:.2f} s (one nvcc call)"
        + ("" if PARENT is None else f"; the parent's kernels "
           f"{PARENT.build_seconds:.2f} s beside it"))
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    ptx = {"this tree": ptxas_of(_build.build_log)}
    if PARENT is not None:
        ptx["parent"] = ptxas_of(PARENT.build_log)
    for side, kernels_ptx in ptx.items():
        for name, info in kernels_ptx.items():
            log(f"ptxas {name} ({side}): {info}")
    sass = sass_widths()
    log(f"K9's, kd_shadow's, kd_finish's, k7_shadow's, K3's, k9j_trace's, "
        f"k9j_finalize's, K4's, K1's, K7 tiles' and K8's loads and stores in "
        f"the SASS by width "
        f"(cuobjdump -sass; instructions in the code): {json.dumps(sass)}")
    log(f"native serializers: loaded {libs}; g++ {' '.join(native.GXX_FLAGS)}"
        f", seconds {native.build_seconds}")
    if not all(libs.values()):
        fail("the native chunk serializers did not load")

    # ---- 2. world, in both formats, and its envelope ------------------------
    with Phase("world"):
        from voxelrs_tpu_torch.bench import build_world
        from voxelrs_tpu_torch.world.heightfield import opaque_lut_from_mask

        svo = Svo(new_registry(), capacity_mb=64, device="cuda")
        world, cworld, chunks, hf = build_world(
            opaque_lut=opaque_lut_from_mask(svo.translucent_block_mask))
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
    if "--kernels-only" in sys.argv:  # a quick comparison of shapes
        for side, build in [("this_tree", _build)] + (
                [] if PARENT is None else [("parent", PARENT)]):
            counts = sass_dump(build)
            log(f"SASS ({side}; cuobjdump -sass, instructions in the code, "
                f"not executions): the traversal loops of "
                f"{', '.join(SASS_LOOPS)} "
                f"{json.dumps((counts or {}).get('loops'))}; instructions a "
                f"kernel {json.dumps((counts or {}).get('instructions'))}")
        with Phase("translucent world"):
            tsvo = Svo(new_registry(), capacity_mb=64, device="cuda")
            tworld, tcworld, _n, thf, _info = build_translucent_world(
                opaque_lut_from_mask(tsvo.translucent_block_mask))
            tsvo.update(tworld)
            tcsvo = Svo(new_registry(), capacity_mb=64,
                        buffer_dtype=np.uint8, device="cuda")
            tcsvo.update(tcworld)
        slice_kernels_phase(dict(esvo=svo, csvo=csvo),
                            dict(esvo=tsvo, csvo=tcsvo), hf, thf, poses,
                            card)
        log("--kernels-only: the build and the shape comparison ran; no "
            "result")
        return 3

    # ---- 3-5. the renderer's path in ESVO: K1 and K3 ------------------------
    e = renderer_phase(svo, poses, card)

    # ---- 6. small frame against the repository's golden -------------------
    with Phase("golden"):
        gd = golden_check(repo)
    log(f"golden render_basic.npy: mean |d| {gd:.5f} (budget 0.015)")
    if not gd < 0.015:
        fail("golden frame over budget")

    # ---- 6b. the gather probe: P0 ------------------------------------------
    pe = probe_phase(card)

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
    # K4's and K1's time a step on the same rays (pose 0's primary rays,
    # judged; both take the same steps): the kernel's microseconds over
    # the mean ray's steps
    per_step = {}
    for key, r in (("k1", e), ("k4", c)):
        steps = r["trav_steps"] / (W * H)
        per_step[key] = r["trav_ms"] * 1e3 / steps
        if "trav_parent" in r:
            per_step[key + "_parent"] = r["trav_parent"]["ms"] * 1e3 / steps
    per_step["k4_over_k1"] = per_step["k4"] / per_step["k1"]
    if "k4_parent" in per_step:
        per_step["k4_over_k1_parent"] = (per_step["k4_parent"]
                                         / per_step["k1_parent"])
    c["us_per_step"] = per_step
    log(f"k4 and k1 a step on the same rays (pose 0's {W * H} judged "
        f"primary rays; steps {e['trav_steps']} / {c['trav_steps']}, "
        f"{e['trav_steps'] / (W * H):.2f} / {c['trav_steps'] / (W * H):.2f} "
        f"a ray): us a step of the mean ray {json.dumps(per_step)} on {card}")
    if "--renderer-only" in sys.argv:  # a quick comparison of K3's shapes
        log("--renderer-only: the build and the renderer phases ran; no "
            "result")
        return 3

    # ---- 8. the deferred frame per format: K6, K7, K8 --------------------
    de = deferred_phase(svo, hf, poses, card)
    dc = deferred_phase(csvo, hf, poses, card)

    # ---- 9. the adaptive frame per format: K9 ------------------------------
    ae = adaptive_phase(svo, hf, poses, card)
    ac = adaptive_phase(csvo, hf, poses, card)

    # ---- 10. the judged adaptive frame per format: K9-judged --------------
    with Phase("translucent world"):
        tsvo = Svo(new_registry(), capacity_mb=64, device="cuda")
        tworld, tcworld, tchunks, thf, tinfo = build_translucent_world(
            opaque_lut_from_mask(tsvo.translucent_block_mask))
        tsvo.update(tworld)
        tcsvo = Svo(new_registry(), capacity_mb=64, buffer_dtype=np.uint8,
                    device="cuda")
        tcsvo.update(tcworld)
    log(f"translucent world: {tchunks} chunks, depth {tsvo.depth}, "
        f"{tsvo.stats.used_bytes / 1e6:.2f} MB ESVO, "
        f"{tcsvo.stats.used_bytes / 1e6:.2f} MB CSVO; {json.dumps(tinfo)}")
    if tsvo.is_opaque() or tcsvo.is_opaque():
        fail("the translucent world holds no translucent block")
    je = judged_phase(tsvo, thf, poses, card)
    jc = judged_phase(tcsvo, thf, poses, card)

    # ---- 10b. the pose batch: K10 ------------------------------------------
    be = batch_phase(svo, csvo, tsvo, hf, poses, card)
    del tsvo, tcsvo

    # ---- 10c. with --parent: the frames against the parent's --------------
    pf = (parent_frames_phase(dict(esvo=world, csvo=cworld), hf,
                              dict(esvo=tworld, csvo=tcworld), thf, poses,
                              card)
          if PARENT is not None else None)
    del tworld, tcworld

    # ---- 11. the game loop's path, ESVO then CSVO: counts from 0 ----------
    ge, ce = game_phase("esvo", card)
    gc, cc = game_phase("csvo", card)

    # ---- 12. K6's card operations a call, from a profiler trace ------------
    with Phase("k6 launches"):
        k6l = k6_launch_phase(torch.device("cuda"))
    for name, r in k6l.items():
        log(f"k6 card operations a call ({name} mask, {r['lanes']} lanes; "
            f"torch.profiler): {r['launches']} {r['ops']}"
            + ("" if PARENT is None else f"; the parent's K6 "
               f"{r['parent_launches']} {r['parent_ops']}"))
        if r["launches"] is not None and r["launches"] > 2:
            fail(f"K6 ran {r['launches']} card operations a call (at most 2)")
    with Phase("k9, kd_primary, kd_shadow, kd_finish, k7_shadow, k3, "
               "k9j_trace and k8 launches"):
        k9l = launch_ops_phase({**ae.pop("launch_args"), "k3": e["k3_call"],
                                **je.pop("launch_args"),
                                "kd_primary": de.pop("primary_args"),
                                "k8": de.pop("k8_args")})
        dc.pop("primary_args")
        dc.pop("k8_args")
        ac.pop("launch_args")
        jc.pop("launch_args")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, r in k9l.items():
        log(f"{name} card operations a call (pose 0, esvo; torch.profiler): "
            f"{r['launches']} {r['ops']}, grids {json.dumps(r['grids'])}"
            + ("" if PARENT is None else f"; the parent's "
               f"{r['parent_launches']} {r['parent_ops']}, grids "
               f"{json.dumps(r['parent_grids'])}"))
        if r["launches"] is not None and r["launches"] > 1:
            fail(f"{name} ran {r['launches']} card operations a call")
        # a resident grid: at most the blocks the card's SMs hold at once
        # by their 2,048 threads each (occupancy may hold fewer)
        for g in (r["grids"] or []) if name in RESIDENT_LAUNCHES else []:
            cap = sms * (2048 // (g["block"][0] * g["block"][1]))
            if g["grid"][0] * g["grid"][1] > cap:
                fail(f"{name} launched {g['grid']} blocks of {g['block']}, "
                     f"more than the card holds at once ({cap})")

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
    held_runs = [d["held"] for d in (de, dc, ae, ac, je, jc, be, ce, cc)]

    def held_sum(name):
        hs = [h[name] for h in held_runs if name in h]
        return dict(calls=sum(h["calls"] for h in hs),
                    equal=all(h["equal"] for h in hs),
                    err=max(h["err"] for h in hs))

    def call_row(c):  # a launch_call / kd_shadow_call row, its bound in ms
        return {**{k: v for k, v in c.items() if k != "bound"},
                "bound_ms": c["bound"][0]}

    finish_held, k7_held = held_sum("kd_finish"), held_sum("k7_shadow")
    tiles_held, k8_held = held_sum("k7_tiles"), held_sum("k8")
    log(f"kd_finish and k7_shadow held to their plain versions on every "
        f"call of the deferred, adaptive and judged frames, the batch and "
        f"the games' final frames: {json.dumps(finish_held)}; "
        f"{json.dumps(k7_held)}; k7_tiles and k8 on every call of the "
        f"exact, adaptive, exact judged and judged adaptive frames and the "
        f"batch: {json.dumps(tiles_held)}; {json.dumps(k8_held)}")
    if not all(h["calls"] and h["equal"]
               for h in (finish_held, k7_held, tiles_held, k8_held)):
        fail("kd_finish, K7's shadow or tile floors or K8 was not held on "
             "every path")
    kernels = [
        dict(name="k1_traversal", route="cuda",
             source="voxelrs_tpu_torch/csrc/k1_traversal.cuh",
             replaces="voxelrs_tpu/ops/traversal.py:1087",
             launches=e["trav_launches"], max_abs_err=e["trav_err"],
             ms=e["trav_ms"], plain_ms=e["trav_plain_ms"],
             bound_ms=k1_bound[0], bound_by=k1_bound[1], library_ms=None,
             ok=e["trav_ok"], rays_differing=e["trav_diff"],
             wrapper_host_us=e["trav_host_us"],
             parent_ms=(e.get("trav_parent") or {}).get("ms"),
             steps=e["trav_steps"],
             ptxas={k: v.get("k1_traverse") for k, v in ptx.items()}),
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
             mean_abs_csvo_vs_esvo=vs_frame, frame_ms_csvo=c["frame_ms"],
             deferred_vs_k3=de["vs_k3"], deferred_vs_k3_csvo=dc["vs_k3"],
             deferred_vs_k3_game=ce["deferred_game_err"],
             deferred_vs_k3_game_csvo=cc["deferred_game_err"],
             poses_checked=e["k3_poses"], poses_checked_csvo=c["k3_poses"],
             parent_ms=(e.get("k3_parent") or {}).get("ms"),
             parent_ms_csvo=(c.get("k3_parent") or {}).get("ms"),
             steps_split=e["k3_split"], steps_split_csvo=c["k3_split"],
             ptxas={k: v.get("k3_frame_esvo") for k, v in ptx.items()},
             ptxas_csvo={k: v.get("k3_frame_csvo") for k, v in ptx.items()},
             launches_per_call=k9l["k3"]["launches"],
             launches_per_call_parent=k9l["k3"].get("parent_launches"),
             grids=k9l["k3"]["grids"],
             grids_parent=k9l["k3"].get("parent_grids")),
        dict(name="k4_csvo_traversal", route="cuda",
             source="voxelrs_tpu_torch/csrc/k4_csvo_traversal.cuh",
             replaces="voxelrs_tpu/ops/traversal_csvo.py:151",
             launches=c["trav_launches"], max_abs_err=c["trav_err"],
             ms=c["trav_ms"], plain_ms=c["trav_plain_ms"],
             bound_ms=k4_bound[0], bound_by=k4_bound[1], library_ms=None,
             ok=c["trav_ok"], rays_differing=c["trav_diff"], vs_k1=vs,
             wrapper_host_us=c["trav_host_us"],
             parent_ms=(c.get("trav_parent") or {}).get("ms"),
             us_per_step=c["us_per_step"], steps=c["trav_steps"],
             ptxas={k: v.get("k4_traverse_csvo") for k, v in ptx.items()},
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
             fixed_ms=ce["k5_fixed_ms"], fixed_steps=ce["k5_fixed_steps"],
             fixed_ms_csvo=cc["k5_fixed_ms"],
             fixed_is="one task that starts outside the world and leaves it",
             launches_csvo=gc["launches"]["k5_csvo"],
             ms_csvo=cc["k5_ms"], plain_ms_csvo=cc["k5_plain_ms"],
             bound_ms_csvo=cc["k5_bound"][0], bound_by_csvo=cc["k5_bound"][1],
             max_abs_err_csvo=cc["k5_err"], steps_csvo=cc["k5_steps"],
             batches_checked_csvo=cc["k5_batches"],
             launches_per_frame_csvo=gc["k5_per_frame"],
             svo_raycast_round_trip_us_csvo=cc["k5_round_trip_us"],
             segments=_build.K5_SEGMENTS, longest_task_steps=ce["k5_chain"],
             longest_task_steps_csvo=cc["k5_chain"],
             pick_us=ce["k5_pick_us"], pick_us_csvo=cc["k5_pick_us"],
             pick_under_load_us=ge["pick_under_load_us"],
             pick_under_load_us_csvo=gc["pick_under_load_us"],
             physics_ms_per_step=ge["physics_ms_per_step"],
             physics_ms_per_step_csvo=gc["physics_ms_per_step"],
             pick_under_load_us_launch_and_copy=ge[
                 "pick_under_load_us_launch_and_copy"],
             pick_under_load_us_launch_and_copy_csvo=gc[
                 "pick_under_load_us_launch_and_copy"],
             physics_ms_per_step_launch_and_copy=ge[
                 "physics_ms_per_step_launch_and_copy"],
             physics_ms_per_step_launch_and_copy_csvo=gc[
                 "physics_ms_per_step_launch_and_copy"],
             shapes=ce["k5_shapes"], shapes_csvo=cc["k5_shapes"],
             parent_ms=(ce["k5_shapes"]["sweep"].get("parent") or {}).get(
                 "ms"),
             ptxas={k: v.get("k5_picker_esvo") for k, v in ptx.items()},
             ptxas_csvo={k: v.get("k5_picker_csvo") for k, v in ptx.items()},
             bad_vs_launch_and_copy=ce["k5_bad_vs_launch_and_copy"]
             + cc["k5_bad_vs_launch_and_copy"]),
        dict(name="k6_compact", route="cuda",
             source="voxelrs_tpu_torch/csrc/k6_compact.cuh",
             replaces="voxelrs_tpu/ops/shading.py:313",
             launches=de["launches"]["k6"], max_abs_err=de["k6_err"],
             ms=de["k6_ms"], plain_ms=de["k6_plain_ms"],
             bound_ms=de["k6_bound"][0], bound_by=de["k6_bound"][1],
             library_ms=de["k6_library_ms"],
             ok=all(r["equal"] for r in (*de["k6"], *dc["k6"],
                                         *ae["k6_calls"], *ac["k6_calls"]))
             and ce["k6_ok"] and cc["k6_ok"],
             launches_per_call=k6l["frame"]["launches"],
             launches_per_call_parent=k6l["frame"].get("parent_launches"),
             parent_ms=de["k6"][0]["parent_ms"],
             fixed_ms=de["k6_fixed_ms"],
             ms_is="pose 0's hit mask, one call",
             calls_exact=de["k6"], calls_exact_csvo=dc["k6"],
             calls_adaptive=ae["k6_calls"], calls_adaptive_csvo=ac["k6_calls"],
             adaptive_frame=k6_summary(ae["k6_calls"]),
             adaptive_frame_csvo=k6_summary(ac["k6_calls"]),
             launches_csvo=dc["launches"]["k6"],
             max_abs_err_csvo=dc["k6_err"], ms_csvo=dc["k6_ms"],
             launches_game=ge["launches"]["k6"],
             launches_game_csvo=gc["launches"]["k6"],
             game_calls_checked=ce["k6_calls"],
             game_calls_checked_csvo=cc["k6_calls"]),
        dict(name="k7_beams", route="cuda",
             source="voxelrs_tpu_torch/csrc/k7_beams.cuh",
             replaces="voxelrs_tpu/ops/beams.py:137",
             launches=de["launches"]["k7"],
             max_abs_err=max(de["k7_tile_err"], de["k7_shadow_err"]),
             ms=de["k7_tile_ms"], plain_ms=de["k7_tile_plain_ms"],
             bound_ms=de["k7_tile_bound"][0], bound_by=de["k7_tile_bound"][1],
             library_ms=None,
             ok=all(d[k] for d in (de, dc) for k in ("k7_tile_ok",
                                                     "k7_shadow_ok"))
             and k7_held["equal"] and tiles_held["equal"],
             tiles_march_steps=de["k7_tile_steps"],
             tiles_march_max=de["k7_tiles"]["march_max"],
             tiles_march_max_descents=de["k7_tiles"]["march_descents"],
             ms_tiles_no_march=de["k7_tiles"]["ms_no_march"],
             parent_ms=(de["k7_tiles"]["parent"] or {}).get("ms"),
             parent_ms_csvo=(dc["k7_tiles"]["parent"] or {}).get("ms"),
             tiles_calls_checked=tiles_held["calls"],
             tiles_game_call=call_row(ce["k7_tiles_call"]),
             tiles_game_call_csvo=call_row(cc["k7_tiles_call"]),
             ptxas={k: {n: i for n, i in v.items()
                        if n.startswith("k7_tiles")}
                    for k, v in ptx.items()},
             tile_inf_share=de["tile_inf_share"],
             shadow_replaces="voxelrs_tpu/ops/beams.py:309",
             ms_shadow=de["k7_shadow_ms"],
             plain_ms_shadow=de["k7_shadow_plain_ms"],
             bound_ms_shadow=de["k7_shadow_bound"][0],
             bound_by_shadow=de["k7_shadow_bound"][1],
             shadow_rays=de["k7_shadow_rays"],
             shadow_march_steps=de["k7_shadow_steps"],
             shadow_inf_share=de["shadow_inf_share"],
             launches_tile=de["launches"]["k7_tile"],
             launches_csvo=dc["launches"]["k7"],
             ms_csvo=dc["k7_tile_ms"], ms_shadow_csvo=dc["k7_shadow_ms"],
             launches_game=ge["launches"]["k7"],
             launches_game_csvo=gc["launches"]["k7"],
             launches_shadow_game=ge["launches"]["k7_shadow"],
             launches_shadow_game_csvo=gc["launches"]["k7_shadow"],
             ms_shadow_count0=de["k7_shadow"]["ms_count0"],
             ms_shadow_count0_csvo=dc["k7_shadow"]["ms_count0"],
             parent_ms_shadow=(de["k7_shadow"]["parent"] or {}).get("ms"),
             parent_ms_shadow_count0=(de["k7_shadow"]["parent"]
                                      or {}).get("ms_count0"),
             shadow_exact_frame_call=call_row(de["k7_shadow"]),
             shadow_exact_frame_call_csvo=call_row(dc["k7_shadow"]),
             shadow_adaptive_passes=[call_row(c) for c in
                                     ae["k7_shadow"]["no_sun_map"]],
             shadow_adaptive_passes_csvo=[call_row(c) for c in
                                          ac["k7_shadow"]["no_sun_map"]],
             shadow_calls_checked=k7_held["calls"],
             shadow_launches_per_call=k9l["k7_shadow"]["launches"],
             shadow_launches_per_call_parent=k9l["k7_shadow"].get(
                 "parent_launches"),
             shadow_grids=k9l["k7_shadow"]["grids"],
             shadow_grids_parent=k9l["k7_shadow"].get("parent_grids")),
        dict(name="k8_sun", route="cuda",
             source="voxelrs_tpu_torch/csrc/k8_sun.cuh",
             replaces="voxelrs_tpu/ops/beams.py:379",
             launches=de["launches"]["k8"], max_abs_err=de["k8_err"],
             ms=de["k8_ms"], plain_ms=de["k8_plain_ms"],
             bound_ms=de["k8_bound"][0], bound_by=de["k8_bound"][1],
             library_ms=None,
             ok=de["k8_ok"] and dc["k8_ok"] and k8_held["equal"],
             rays=de["k8_rays"], certified_share=de["k8_certified_share"],
             ms_lit_floors=de["k8_lit_floors_ms"],
             ms_count0=de["k8"]["ms_count0"],
             ms_lit_floors_count0=de["k8_lit_floors"]["ms_count0"],
             parent_ms=(de["k8"]["parent"] or {}).get("ms"),
             parent_ms_count0=(de["k8"]["parent"] or {}).get("ms_count0"),
             parent_ms_lit_floors=(de["k8_lit_floors"]["parent"]
                                   or {}).get("ms"),
             exact_frame_call=call_row(de["k8"]),
             exact_frame_call_csvo=call_row(dc["k8"]),
             lit_floors_call=call_row(de["k8_lit_floors"]),
             row_words=de["k8_row_words"],
             game_call=ce["k8_call"] and call_row(ce["k8_call"]),
             game_call_csvo=cc["k8_call"] and call_row(cc["k8_call"]),
             game_row_words=ce["k8_row_words"],
             game_row_words_csvo=cc["k8_row_words"],
             calls_checked=k8_held["calls"],
             launches_per_call=k9l["k8"]["launches"],
             grids=k9l["k8"]["grids"],
             grids_parent=k9l["k8"].get("parent_grids"),
             ptxas={k: {n: i for n, i in v.items() if n.startswith("k8_sun")}
                    for k, v in ptx.items()},
             lit_floors_replaces="voxelrs_tpu/ops/beams.py:473",
             launches_csvo=dc["launches"]["k8"], ms_csvo=dc["k8_ms"],
             max_abs_err_csvo=dc["k8_err"],
             launches_game=ge["launches"]["k8"],
             launches_game_csvo=gc["launches"]["k8"]),
    ]
    # every held call of kd_shadow, kd_finish, K7's shadow floors and K9's
    # shadow cells (the deferred, adaptive and judged phases' frames, the
    # batch, the games' final frames), each equal to its plain version
    shadow_held = held_sum("kd_shadow")
    # the shadow stage: pose 0's exact frame call (kd_shadow_call) and the
    # adaptive frame's passes with and without the sun map
    shadow_extra = dict(
        plain_ms=de["kd_shadow"]["plain_ms"],
        plain_is="kd_shadow_plain on the same call's inputs",
        plain_ms_csvo=dc["kd_shadow"]["plain_ms"],
        ms_count0=de["kd_shadow"]["ms_count0"],
        ms_count0_csvo=dc["kd_shadow"]["ms_count0"],
        parent_ms=(de["kd_shadow"]["parent"] or {}).get("ms"),
        parent_ms_csvo=(dc["kd_shadow"]["parent"] or {}).get("ms"),
        exact_frame_call={k: v for k, v in de["kd_shadow"].items()
                          if k != "bound"},
        exact_frame_call_csvo={k: v for k, v in dc["kd_shadow"].items()
                               if k != "bound"},
        adaptive_passes={b: [{k: v for k, v in c.items() if k != "bound"}
                             for c in calls]
                         for b, calls in ae["kd_shadow"].items()},
        adaptive_passes_csvo={b: [{k: v for k, v in c.items()
                                   if k != "bound"} for c in calls]
                              for b, calls in ac["kd_shadow"].items()},
        calls_checked=shadow_held["calls"],
        launches_per_call=k9l["kd_shadow"]["launches"],
        launches_per_call_parent=k9l["kd_shadow"].get("parent_launches"))
    # the finishing stage: pose 0's exact frame call, the adaptive frame's
    # passes with and without the sun map, the batch's launches
    finish_extra = dict(
        replaces="voxelrs_tpu/ops/shading.py:2781",
        plain_ms=de["kd_finish"]["plain_ms"],
        plain_is="kd_finish_plain on the same call's inputs",
        plain_ms_csvo=dc["kd_finish"]["plain_ms"],
        ms_count0=de["kd_finish"]["ms_count0"],
        ms_count0_csvo=dc["kd_finish"]["ms_count0"],
        parent_ms=(de["kd_finish"]["parent"] or {}).get("ms"),
        parent_ms_count0=(de["kd_finish"]["parent"] or {}).get("ms_count0"),
        parent_ms_csvo=(dc["kd_finish"]["parent"] or {}).get("ms"),
        exact_frame_call=call_row(de["kd_finish"]),
        exact_frame_call_csvo=call_row(dc["kd_finish"]),
        adaptive_passes={b: [call_row(c) for c in calls]
                         for b, calls in ae["kd_finish"].items()},
        adaptive_passes_csvo={b: [call_row(c) for c in calls]
                              for b, calls in ac["kd_finish"].items()},
        batch=[call_row(c) for c in be["launch_runs"]["kd_finish"]],
        calls_checked=finish_held["calls"],
        launches_per_call=k9l["kd_finish"]["launches"],
        launches_per_call_parent=k9l["kd_finish"].get("parent_launches"),
        grids=k9l["kd_finish"]["grids"],
        grids_parent=k9l["kd_finish"].get("parent_grids"))
    # the primary stage: held call by call to kd_primary_plain on every
    # exact frame (opaque and judged, both formats) and the exact batch;
    # pose 0's exact frame call and the batch's launch, alone, against the
    # plain version and the parent's kernel
    primary_held = held_sum("kd_primary")

    def no_bound(c):
        return {k: v for k, v in c.items() if k != "bound"}

    primary_extra = dict(
        plain_ms=de["kd_primary"]["plain_ms"],
        plain_is="kd_primary_plain on the same call's inputs",
        plain_ms_csvo=dc["kd_primary"]["plain_ms"],
        parent_ms=(de["kd_primary"]["parent"] or {}).get("ms"),
        parent_ms_csvo=(dc["kd_primary"]["parent"] or {}).get("ms"),
        exact_frame_call=no_bound(de["kd_primary"]),
        exact_frame_call_csvo=no_bound(dc["kd_primary"]),
        batch=[no_bound(c) for c in be["launch_runs"]["kd_primary"]],
        calls_checked=primary_held["calls"],
        launches_per_call=k9l["kd_primary"]["launches"],
        launches_per_call_parent=k9l["kd_primary"].get("parent_launches"),
        grids=k9l["kd_primary"]["grids"],
        grids_parent=k9l["kd_primary"].get("parent_grids"),
        ptxas={k: v.get("kd_primary_esvo") for k, v in ptx.items()},
        ptxas_csvo={k: v.get("kd_primary_csvo") for k, v in ptx.items()})
    # the deferred frame's stages: held, together, to the plain deferred
    # frame (their plain version) on every pose, variant and game buffer;
    # the primary, shadow and finishing stages also call by call to their
    # own plain versions
    for st in STAGES:
        kernels.append(dict(
            name=f"kd_{st}", route="cuda",
            source="voxelrs_tpu_torch/csrc/kernels.cu",
            replaces="voxelrs_tpu/ops/shading.py:3722",
            launches=de["launches"][f"kd_{st}"],
            max_abs_err=max(*de["vs_plain"].values(),
                            ce["deferred_game_plain_err"]),
            ms=de["stages"]["ms"][st], plain_ms=de["plain_ms"],
            bound_ms=de["stages"]["bound"][st][0],
            bound_by=de["stages"]["bound"][st][1], library_ms=None,
            plain_is="the whole plain deferred frame (pose 0, beams and sun)",
            ok=all(d["vs_plain_ok"] for d in (de, dc))
            and ce["deferred_game_ok"] and cc["deferred_game_ok"],
            launches_csvo=dc["launches"][f"kd_{st}"],
            max_abs_err_csvo=max(*dc["vs_plain"].values(),
                                 cc["deferred_game_plain_err"]),
            ms_csvo=dc["stages"]["ms"][st], plain_ms_csvo=dc["plain_ms"],
            bound_ms_csvo=dc["stages"]["bound"][st][0],
            launches_game=ge["launches"][f"kd_{st}"],
            launches_game_csvo=gc["launches"][f"kd_{st}"]))
        if st in ("primary", "shadow", "finish"):
            held, extra = {"primary": (primary_held, primary_extra),
                           "shadow": (shadow_held, shadow_extra),
                           "finish": (finish_held, finish_extra)}[st]
            kernels[-1].update(
                extra, ok=kernels[-1]["ok"] and held["equal"]
                and held["calls"] > 0,
                max_abs_err=max(kernels[-1]["max_abs_err"], held["err"]))
    # K9: held to its plain versions on pose 0's own inputs, the adaptive
    # frame to its plain version on every pose, variant and game buffer;
    # "ms" sums the kernel's launches in one frame (pose 0), alone
    for k, rep in K9.items():
        kernels.append(dict(
            name=f"k9_{k}", route="cuda",
            source="voxelrs_tpu_torch/csrc/k9_adaptive.cuh", replaces=rep,
            launches=ae["launches"][f"k9_{k}"],
            max_abs_err=max(ae["k9"][k]["err"], ac["k9"][k]["err"]),
            ms=ae["k9"][k]["ms"], plain_ms=ae["k9"][k]["plain_ms"],
            bound_ms=ae[f"{k}_bound"][0], bound_by=ae[f"{k}_bound"][1],
            library_ms=None,
            ok=ae["k9"][k]["equal"] and ac["k9"][k]["equal"]
            and all(d["held"].get(f"k9_{k}", {}).get("equal", True)
                    for d in (ae, ac)),
            launches_per_frame=len(ae["k9"][k]["calls"]),
            ms_per_launch=[c["ms"] for c in ae["k9"][k]["calls"]],
            launches_csvo=ac["launches"][f"k9_{k}"], ms_csvo=ac["k9"][k]["ms"],
            plain_ms_csvo=ac["k9"][k]["plain_ms"],
            bound_ms_csvo=ac[f"{k}_bound"][0],
            launches_game=ge["launches"][f"k9_{k}"],
            launches_game_csvo=gc["launches"][f"k9_{k}"],
            **({} if k != "trace" else dict(
                per_launch=[dict(level=c["level"], ms=c["ms"], **c["launch"],
                                 parent=c["parent"])
                            for c in ae["k9"][k]["calls"]],
                per_launch_csvo=[dict(level=c["level"], ms=c["ms"],
                                      **c["launch"], parent=c["parent"])
                                 for c in ac["k9"][k]["calls"]])),
            **({} if k not in ("merge", "finalize") else dict(
                per_launch=[{f: c[f] for f in ("level", "ms", "ms_no_hits",
                                               "parent") if f in c}
                            for c in ae["k9"][k]["calls"]],
                per_launch_csvo=[{f: c[f] for f in ("level", "ms",
                                                    "ms_no_hits", "parent")
                                  if f in c} for c in ac["k9"][k]["calls"]],
                calls_checked=ae["held"][f"k9_{k}"]["calls"],
                calls_checked_csvo=ac["held"][f"k9_{k}"]["calls"],
                launches_per_call=k9l[f"k9_{k}"]["launches"],
                launches_per_call_parent=k9l[f"k9_{k}"].get(
                    "parent_launches"))),
            **({} if k != "shadow_cells" else dict(
                per_launch=[{f: c[f] for f in ("step", "hits", "ms",
                                               "ms_count0", "parent")}
                            for c in ae["k9"][k]["calls"]],
                per_launch_csvo=[{f: c[f] for f in ("step", "hits", "ms",
                                                    "ms_count0", "parent")}
                                 for c in ac["k9"][k]["calls"]],
                calls_checked=held_sum("k9_shadow_cells")["calls"],
                launches_per_call=k9l["k9_shadow_cells"]["launches"],
                launches_per_call_parent=k9l["k9_shadow_cells"].get(
                    "parent_launches"))),
            frame_vs_plain=max(*ae["vs_plain"].values(),
                               *ac["vs_plain"].values(),
                               ce["adaptive_game_err"],
                               cc["adaptive_game_err"])))
    # K9-judged: held to its plain versions on pose 0's own inputs of the
    # translucent scene, the judged frame to its plain version on every
    # pose; "ms" sums the kernel's launches in one frame (pose 0), alone
    for k, rep in K9J.items():
        kernels.append(dict(
            name=f"k9j_{k}", route="cuda",
            source="voxelrs_tpu_torch/csrc/k9_judged.cuh", replaces=rep,
            launches=je["launches"][f"k9j_{k}"],
            max_abs_err=max(je["k9j"][k]["err"], jc["k9j"][k]["err"]),
            ms=je["k9j"][k]["ms"], plain_ms=je["k9j"][k]["plain_ms"],
            bound_ms=je[f"{k}_bound"][0], bound_by=je[f"{k}_bound"][1],
            library_ms=None,
            ok=je["k9j"][k]["equal"] and jc["k9j"][k]["equal"]
            and held_sum(f"k9j_{k}")["equal"]
            and held_sum(f"k9j_{k}")["calls"] > 0,
            launches_per_frame=len(je["k9j"][k]["calls"]),
            ms_per_launch=[c["ms"] for c in je["k9j"][k]["calls"]],
            launches_csvo=jc["launches"][f"k9j_{k}"],
            ms_csvo=jc["k9j"][k]["ms"], plain_ms_csvo=jc["k9j"][k]["plain_ms"],
            bound_ms_csvo=jc[f"{k}_bound"][0],
            frame_vs_plain=max(je["vs_plain"], jc["vs_plain"]),
            **({} if k != "merge" else dict(
                calls_checked=held_sum("k9j_merge")["calls"],
                calls_checked_hole_fill=sum(
                    d["held_hole_fill"]["k9j_merge"]["calls"]
                    for d in (je, jc)),
                per_launch=[{f: c[f] for f in ("level", "ms", "parent")}
                            for c in je["k9j"][k]["calls"]],
                per_launch_csvo=[{f: c[f] for f in ("level", "ms", "parent")}
                                 for c in jc["k9j"][k]["calls"]],
                ptxas={s_: v.get("k9j_merge") for s_, v in ptx.items()})),
            **({} if k != "finalize" else dict(
                calls_checked=held_sum("k9j_finalize")["calls"],
                parent=je["k9j"][k]["calls"][0]["parent"],
                parent_csvo=jc["k9j"][k]["calls"][0]["parent"],
                ptxas={s_: v.get("k9j_finalize") for s_, v in ptx.items()},
                launches_per_call=k9l["k9j_finalize"]["launches"],
                launches_per_call_parent=k9l["k9j_finalize"].get(
                    "parent_launches"),
                grids=k9l["k9j_finalize"]["grids"])),
            **({} if k != "trace" else dict(
                calls_checked=held_sum("k9j_trace")["calls"],
                per_launch=[{f: v for f, v in c.items() if f != "equal"}
                            for c in je["k9j"][k]["calls"]],
                per_launch_csvo=[{f: v for f, v in c.items()
                                  if f != "equal"}
                                 for c in jc["k9j"][k]["calls"]],
                ptxas={s_: v.get("k9j_trace_esvo") for s_, v in ptx.items()},
                ptxas_csvo={s_: v.get("k9j_trace_csvo")
                            for s_, v in ptx.items()},
                launches_per_call=k9l["k9j_trace"]["launches"],
                launches_per_call_parent=k9l["k9j_trace"].get(
                    "parent_launches"),
                grids=k9l["k9j_trace"]["grids"],
                grids_parent=k9l["k9j_trace"].get("parent_grids")))))
    # K10: the opaque frame's stages with a pose dimension, each launched
    # once for the batch; K9's and K6's held to their plain versions on the
    # batch's own inputs, the stages (whose plain version is the plain
    # frame) through the plain frames of two poses; "ms" sums the kernel's
    # launches in one batch of the 5 poses, alone
    k10_src = dict(k9="voxelrs_tpu_torch/csrc/k9_adaptive.cuh",
                   k6="voxelrs_tpu_torch/csrc/k6_compact.cuh",
                   kd="voxelrs_tpu_torch/csrc/kernels.cu")
    for name, r in be["kernels"].items():
        bd = be["bounds"][name]
        kernels.append(dict(
            name="k10_" + ("k6_compact" if name == "k6" else name),
            route="cuda", source=k10_src[name[:2]],
            replaces="voxelrs_tpu/ops/shading.py:3580",
            launches=(be["launches_exact"] if name == "kd_primary"
                      else be["launches"])[name],
            max_abs_err=r.get("err", be["stage_err"]), ms=r["ms"],
            plain_ms=r.get("plain_ms", be["stage_plain_ms"]),
            bound_ms=bd[0], bound_by=bd[1],
            library_ms=be["k6_library_ms"] if name == "k6" else None,
            ok=r.get("equal", be["stage_err"] <= K3_MAX_ABS),
            poses=POSES, launches_per_batch=r["calls"],
            launches_one_frame=(be["launches_frame_exact"]
                                if name == "kd_primary"
                                else be["launches_frame"])[name],
            **({} if name != "k6" else dict(
                parent_ms=r["parent_ms"],
                launches_per_call=k6l["batch"]["launches"],
                launches_per_call_parent=k6l["batch"].get("parent_launches"),
                per_call=be["k6_calls"])),
            **({} if name not in be["launch_runs"] else dict(
                per_launch=be["launch_runs"][name])),
            **({} if "equal" in r else dict(
                plain_is="the plain frames of poses 0 and 3, adaptive "
                         "(exact for kd_primary)"))))
    # P0: each kind at its largest table, every configuration beside
    for kind in ("flat", "axis0", "axis1", "two_step"):
        runs = [r for r in pe["runs"] if r["kind"] == kind]
        big = max(runs, key=lambda r: r["rows"])
        kernels.append(dict(
            name=f"p0_gather_{kind}", route="cuda",
            source="voxelrs_tpu_torch/csrc/p0_gather.cuh",
            replaces="scripts/probes/pallas_probe.py:32",
            launches=sum(r["launches"] for r in runs),
            max_abs_err=max(r["err"] for r in runs), ms=big["ms"],
            plain_ms=big["plain_ms"], bound_ms=big["bound"][0],
            bound_by=big["bound"][1], library_ms=None,
            ok=all(r["equal"] for r in runs), rows=big["rows"],
            configs=[dict(rows=r["rows"], sub=r["sub"], ms=r["ms"],
                          g_gathers_per_s=r["g_gathers_per_s"],
                          plain_ms=r["plain_ms"], equal=r["equal"])
                     for r in runs]))
    for kd in kernels:
        if kd["name"].startswith("kd_"):
            st = kd["name"][3:]
            kd["launches_adaptive"] = ae["launches"][f"kd_{st}"]
            kd["launches_adaptive_csvo"] = ac["launches"][f"kd_{st}"]
            kd["launches_judged"] = je["launches"][f"kd_{st}"]
            kd["launches_judged_csvo"] = jc["launches"][f"kd_{st}"]
        elif kd["name"] in ("k6_compact", "k8_sun", "k9_shadow_cells"):
            key = {"k6_compact": "k6", "k8_sun": "k8",
                   "k9_shadow_cells": "k9_shadow_cells"}[kd["name"]]
            kd["launches_judged"] = je["launches"][key]
            kd["launches_judged_csvo"] = jc["launches"][key]
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s (budget {BUDGET_S} s)")
    game_keys = ("load_s", "serialize_chunk_ms_mean",
                 "serialize_chunk_ms_median", "serialize_chunk_n", "chunks",
                 "svo_leaves", "svo_mb", "depth", "frames", "frame_ms_median",
                 "frame_ms_p90", "frame_ms_p99", "frame_ms_max", "share",
                 "ms_per_frame", "k5_per_frame", "physics_steps", "parts",
                 "run_s", "launches", "deferred_frames", "beam_frames",
                 "sun_frames", "adaptive_frames")
    sun_keys = ("sun_wait_frames", "sun_wait_s", "sun_attached",
                "sun_build_s", "sun_mb", "sun_shape", "deferred_game_err",
                "deferred_game_plain_err", "adaptive_game_err", "paths_ms")
    log(json.dumps({"frame_ms": e["frame_ms"], "mrays_per_s": e["mrays"],
                    "frame_ms_csvo": c["frame_ms"],
                    "mrays_per_s_csvo": c["mrays"],
                    "deferred_frame_ms": de["frame_ms"],
                    "deferred_mrays_per_s": de["mrays"],
                    "deferred_frame_ms_csvo": dc["frame_ms"],
                    "deferred_mrays_per_s_csvo": dc["mrays"],
                    "deferred_host_us": de["host_us"],
                    "adaptive_frame_ms": ae["frame_ms"],
                    "adaptive_mrays_per_s": ae["mrays"],
                    "adaptive_frame_ms_csvo": ac["frame_ms"],
                    "adaptive_mrays_per_s_csvo": ac["mrays"],
                    "adaptive_times": ae["times"],
                    "adaptive_times_csvo": ac["times"],
                    "adaptive_host_us": ae["host_us"],
                    "adaptive_host_us_csvo": ac["host_us"],
                    "adaptive_branches": ae["branches"],
                    "adaptive_shares": ae["shares_pose0"],
                    "adaptive_shares_csvo": ac["shares_pose0"],
                    "judged_frame_ms": je["frame_ms"],
                    "judged_frame_ms_csvo": jc["frame_ms"],
                    "judged_times": je["times"],
                    "judged_times_csvo": jc["times"],
                    "judged_host_us": je["host_us"],
                    "judged_host_us_csvo": jc["host_us"],
                    "judged_traced_share": je["traced_share"],
                    "judged_traced_share_csvo": jc["traced_share"],
                    "judged_shares": je["shares_pose0"],
                    "judged_shares_csvo": jc["shares_pose0"],
                    "judged_branches": je["branches"],
                    "judged_vs_exact": je["vs_exact"],
                    "judged_vs_exact_csvo": jc["vs_exact"],
                    "judged_certificates_vs_traces": je[
                        "certificates_vs_traces"],
                    "judged_certificates_vs_traces_csvo": jc[
                        "certificates_vs_traces"],
                    "translucent_world": tinfo,
                    "batched_frame_ms": be["batched_frame_ms"],
                    "batch_seq_frame_ms": be["seq_frame_ms"],
                    "batch_piped_frame_ms": be["piped_frame_ms"],
                    "batched_piped_frame_ms": be["batched_piped_frame_ms"],
                    "batch_host_us": be["host_us"],
                    "batch_exact_batched_frame_ms": be[
                        "exact_batched_frame_ms"],
                    "batch_exact_seq_frame_ms": be["exact_seq_frame_ms"],
                    "batch_workspace_mb": be["workspace_mb"],
                    "batch_branches": be["branches"],
                    "frames_against_parent": pf,
                    "floored": de["floored"], "floored_csvo": dc["floored"],
                    "card": card, "build_s": _build.build_seconds,
                    "native_build_s": native.build_seconds, "total_s": total,
                    "game": {**{k: ge[k] for k in game_keys},
                             **{k: ce[k] for k in sun_keys}},
                    "game_csvo": {**{k: gc[k] for k in game_keys},
                                  **{k: cc[k] for k in sun_keys}}}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# the ESVO launches that trace with K1's cursor, and the arguments each
# writes (the _build launch functions' positions)
CURSOR_OUTS = {"k3": (4,), "kd_primary": (6, 7, 8), "kd_shadow": (11,),
               "k9_trace": (5,), "k9j_trace": (6,)}


def picker_tasks(ground, n, seed):
    """n picker tasks over the terrain, as the game casts them: half look
    rays (30 blocks, random directions) from 1.6 blocks above a point of
    ``ground`` (the hit positions of a frame's primary rays, numpy (m,
    3)), half axis-aligned AABB sweeps (10 blocks) from the corners of a
    player's box standing on one (feet on the block's top face)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    at = ground[rng.integers(0, len(ground), n)]
    half = n // 2
    o = at + (0.0, 1.6, 0.0)
    o[half:] = np.floor(at[half:]) + rng.choice(
        [0.1, 0.9], (n - half, 3)) * (1, 0, 1) + (0, 1, 0)
    d = rng.normal(size=(n, 3))
    d[half:] = np.eye(3)[rng.integers(0, 3, n - half)] * rng.choice(
        [-1.0, 1.0], (n - half, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    md = np.where(np.arange(n) < half, 30.0, 10.0)
    return torch.tensor(np.concatenate([md[:, None], o, d], 1),
                        dtype=torch.float32, device="cuda")


def slice_kernels_phase(svos, tsvos, hf, thf, poses, card) -> None:
    """``--kernels-only``, this slice: K1 on pose 0's judged primary rays,
    K5's shapes (K5_SHAPES) on 5 picker batches of 8 and of 32 tasks on
    the terrain pose 0 sees (``picker_tasks``), and the ESVO launches that
    trace with K1's cursor (K3, ``kd_primary``, ``kd_shadow``, K9's and
    K9-judged's traces; pose 0's own calls, spied), each equal to the
    parent's outputs (K1 and K5 to their plain versions too) and timed
    against the parent's kernel in turns (this tree, the parent,
    AB_ROUNDS // 2 times)."""
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import picker, shading, traversal
    from voxelrs_tpu_torch.ops.traversal import MAX_STEPS, step_budget

    rounds = max(1, AB_ROUNDS // 2)

    def turns(mine, parent):
        ms, pms = [], []
        for _ in range(rounds):
            ms.append(kernel_ms(mine))
            if parent is not None:
                pms.append(kernel_ms(parent))
        return ms, pms

    rows = {}
    sv = svos["esvo"]
    world, scale = sv.world(), float(sv.octree_scale)
    budget = step_budget(MAX_STEPS)
    # K1: pose 0's primary rays, judged, as the renderer phase times it
    ro, rd = primary_rays(sv, poses[0])
    B = ro.shape[0]
    alpha = shading.make_alpha_fn(sv.mips, sv.mat_tex)
    md = torch.full((B,), -1.0, dtype=torch.float32, device=sv.device)
    shapes = ((B, torch.float32), (B, torch.int32), (B, torch.int32),
              ((B, 3), torch.float32), ((B, 2), torch.float32),
              (B, torch.float32), (B, torch.bool), (B, torch.int32))
    outs = [torch.empty(sh, dtype=dt, device=sv.device) for sh, dt in shapes]
    pouts = [torch.empty_like(x) for x in outs]
    args = (world, scale, ro, rd, md, budget, 1, alpha.tables)
    _build.launch_k1(*args, *outs)
    ref = traversal.intersect_octree_plain(world, scale, ro, rd, -1.0, True,
                                           alpha)
    eq = all(torch.equal(o.long() & 0xFFFFFFFF if f == "value" else o,
                         getattr(ref, f))
             for o, f in zip(outs, ref._fields))
    plaunch = None
    if PARENT is not None:
        PARENT.launch_k1(*args, *pouts)
        eq = eq and all(bits_equal(a, b) for a, b in zip(outs, pouts))
        plaunch = lambda: PARENT.launch_k1(*args, *pouts)  # noqa: E731
    ms, pms = turns(lambda: _build.launch_k1(*args, *outs), plaunch)
    rows["k1 pose 0"] = dict(equal=eq, ms=ms, parent_ms=pms,
                             steps=int(outs[7].sum()))
    # K5's shapes on batches of 8 and 32 tasks on the terrain pose 0 sees
    ground = outs[3][outs[0] > 0].cpu().numpy()
    for fmt, s_ in svos.items():
        w, sc = s_.world(), float(s_.octree_scale)
        bud = _budget_of(s_)
        for i in range(len(poses)):
            for n in (8, 32):
                tasks = picker_tasks(ground, n, 100 * i + n)
                ref = picker.raycast_plain(w, sc, tasks)
                for seg in K5_SHAPES:
                    out = torch.empty((n, 8), dtype=torch.float32,
                                      device=s_.device)
                    st = torch.empty(n, dtype=torch.int32, device=s_.device)
                    _build.launch_k5(w, sc, tasks, bud, out, st, segments=seg)
                    pl = None
                    if PARENT is not None and seg == K5_SHAPES[0]:
                        pout = torch.empty_like(out)
                        PARENT.launch_k5(w, sc, tasks, bud, pout)
                        pl = lambda: PARENT.launch_k5(  # noqa: E731
                            w, sc, tasks, bud, pout)
                    ms, pms = turns(lambda: _build.launch_k5(
                        w, sc, tasks, bud, out, segments=seg), pl)
                    rows[f"k5 {fmt} batch {i} {n} tasks s{seg}"] = dict(
                        equal=bool(torch.equal(out, ref)), ms=ms,
                        parent_ms=pms, chain=int(st.max()))
    # the ESVO launches on K1's cursor: pose 0's calls, spied
    tv = tsvos["esvo"]
    sv.set_heightfield(hf)
    tv.set_heightfield(thf)
    renders = {"k3": lambda: sv.render(poses[0], W, H, mode="fused"),
               "kd_primary": lambda: sv.render(poses[0], W, H,
                                               adaptive=False),
               "kd_shadow": lambda: sv.render(poses[0], W, H,
                                              adaptive=False),
               "k9_trace": lambda: sv.render(poses[0], W, H),
               "k9j_trace": lambda: tv.render(poses[0], W, H)}
    for name, render in renders.items():
        with Spy(_build, f"launch_{name}") as sp:
            render()
        torch.cuda.synchronize()
        for j, (a, kw) in enumerate(sp.calls[:3]):
            mine = [x.clone() if k in CURSOR_OUTS[name] and x is not None
                    else x for k, x in enumerate(a)]
            theirs = [x.clone() if k in CURSOR_OUTS[name] and x is not None
                      else x for k, x in enumerate(a)]
            launch = getattr(_build, f"launch_{name}")
            launch(*mine, **kw)
            eq, pl = True, None
            if PARENT is not None:
                plib = getattr(PARENT, f"launch_{name}")
                plib(*theirs, **kw)
                eq = all(bits_equal(mine[k], theirs[k])
                         for k in CURSOR_OUTS[name] if mine[k] is not None)
                pl = lambda: plib(*theirs, **kw)  # noqa: E731
            ms, pms = turns(lambda: launch(*mine, **kw), pl)
            rows[f"{name} pose 0 call {j}"] = dict(equal=eq, ms=ms,
                                                   parent_ms=pms)
    for label, r in rows.items():
        log(f"{label}: equal {r['equal']}; this tree "
            f"{[round(x, 4) for x in r['ms']]} ms, the parent's "
            f"{[round(x, 4) for x in r['parent_ms']]} ms"
            + (f"; the longest lane {r['chain']} steps" if "chain" in r
               else "") + f" on {card}")
    log(json.dumps({"slice_kernels": rows, "card": card}))
    if not all(r["equal"] for r in rows.values()):
        fail("a launch of this slice disagrees with its plain version or "
             "the parent's")


def _budget_of(svo):
    """The picker's step budget in ``svo``'s format."""
    import numpy as np

    from voxelrs_tpu_torch.ops import traversal, traversal_csvo
    from voxelrs_tpu_torch.ops.traversal import MAX_STEPS

    return (traversal_csvo if svo.buffer_dtype == np.uint8
            else traversal).step_budget(MAX_STEPS)


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
            frames.append(svo.render(p, W, H, mode="fused"))
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
        # every bench pose, and pose 0 trilinear (VOXELRS_TRILINEAR=1)
        errs, bits = [], []
        for i, (p, tri) in enumerate([(p, False) for p in poses]
                                     + [(poses[0], True)]):
            os.environ["VOXELRS_TRILINEAR"] = "1" if tri else "0"
            try:
                k_img = svo.render(p, W, H, max_steps=1000, mode="fused")
                kw = svo.frame_kwargs(p, W, H, max_steps=1000)
                ms = event_ms(lambda: bits.append(shading.render_frame_plain(
                    world, svo.octree_scale, svo.mips, svo.mat_params,
                    svo.mat_tex, mip_mode=shading.mip_mode_from_env(),
                    **kw)))
            finally:
                os.environ.pop("VOXELRS_TRILINEAR", None)
            ref_img = bits.pop()
            errs.append(dict(pose=i if not tri else 0, trilinear=tri,
                             max_abs=max_abs(k_img, ref_img),
                             equal=bits_equal(k_img, ref_img)))
            if i == 0:
                img, d = k_img, (k_img - ref_img).abs()
                out["k3_plain_ms"] = ms
    out.update(k3_err=max(r["max_abs"] for r in errs),
               k3_mean_err=float(d.mean()), img=img, k3_poses=errs)
    out["k3_ok"] = out["k3_err"] <= K3_MAX_ABS
    log(f"k3 vs plain ({fmt}; the {len(poses)} bench poses and pose 0 "
        f"trilinear): {json.dumps(errs)}; pose 0 mean |d| "
        f"{out['k3_mean_err']:.3g}, pixels > 1e-3: "
        f"{int((d.amax(-1) > 1e-3).sum())}; max |d| {out['k3_err']:.3g} "
        f"(tolerance {K3_MAX_ABS:g}); plain {out['k3_plain_ms']:.1f} ms; "
        f"ok {out['k3_ok']}")
    if not out["k3_ok"]:
        fail(f"K3 disagrees with the plain frame ({fmt})")

    with Phase(f"timing ({fmt})"):
        for p in poses:  # warm-up
            svo.render(p, W, H, mode="fused")
        frame_ms = sorted(cuda_ms(lambda: svo.render(p, W, H, mode="fused"),
                                  REPS) for p in poses)
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
        if PARENT is not None:  # the parent's K1 / K4 on the same inputs,
            # in turns with this tree's (medians of AB_ROUNDS // 2 each)
            p_out = [torch.empty_like(x) for x in trav_out]
            p_launch = getattr(PARENT, "launch_k4" if csvo else "launch_k1")
            p_launch(*head, ro, rd, md, budget, 1, alpha.tables, *p_out)
            mine, theirs = [], []
            for _ in range(max(1, AB_ROUNDS // 2)):
                mine.append(kernel_ms(lambda: launch_fn(
                    *head, ro, rd, md, budget, 1, alpha.tables, *trav_out)))
                theirs.append(kernel_ms(lambda: p_launch(
                    *head, ro, rd, md, budget, 1, alpha.tables, *p_out)))
            out["trav_ms"] = sorted(mine)[len(mine) // 2]
            out["trav_parent"] = dict(
                equal=all(bits_equal(a, b) for a, b in zip(p_out, trav_out)),
                ms=sorted(theirs)[len(theirs) // 2], turns=dict(
                    this_tree=mine, parent=theirs))
        fp = shading.frame_params(mip_mode=shading.mip_mode_from_env(),
                                  csvo=csvo, **svo.frame_kwargs(poses[0], W, H))
        tables = svo.kernel_tables()
        k3_img = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
        out["k3_ms"] = kernel_ms(lambda: _build.launch_k3(world, scale, tables,
                                                          fp, k3_img))
        steps3 = torch.empty(W * H, dtype=torch.int32, device=dev)
        _build.launch_k3(world, scale, tables, fp, k3_img, steps3)
        out["k3_steps"] = int(steps3.sum())
        out["k3_call"] = ((world, scale, tables, fp, k3_img), {})
        if PARENT is not None:  # the parent's K3 on the same inputs
            p_img = torch.empty_like(k3_img)
            PARENT.launch_k3(world, scale, tables, fp, p_img)
            out["k3_parent"] = dict(
                equal=bits_equal(p_img, k3_img),
                ms=kernel_ms(lambda: PARENT.launch_k3(world, scale, tables,
                                                      fp, p_img)))
        # the wrappers' host time around those launches
        out["trav_host_us"] = host_us(lambda: query(ro, rd))
        out["k3_host_us"] = host_us(lambda: svo.render(poses[0], W, H,
                                                       mode="fused"))
    log(f"frame {W}x{H} ({fmt}; Svo.render, fused, K3; events from call to "
        f"finished frame): median {out['frame_ms']:.3f} ms/frame over "
        f"{len(poses)} poses x {REPS} runs, per-pose medians "
        f"{[round(x, 3) for x in frame_ms]}; {out['mrays']:.2f} Mrays/s "
        f"(primary + shadow, W*H*2/dt) on {card}")
    par, tpar = out.get("k3_parent"), out.get("trav_parent")
    log(f"kernels alone ({fmt}, pose 0, {KERNEL_REPS} back-to-back "
        f"launches): {kname} {out['trav_ms']:.4f} ms"
        + ("" if tpar is None else f" (the parent's {kname.upper()} "
           f"{tpar['ms']:.4f} ms, its hits equal {tpar['equal']}; turns "
           f"{json.dumps(tpar['turns'])})")
        + f", k3 {out['k3_ms']:.4f} "
        f"ms" + ("" if par is None else f" (the parent's K3 {par['ms']:.4f} "
                 f"ms, its frame equal {par['equal']})")
        + f"; wrapper host time (median of {HOST_REPS} calls): query "
        f"{out['trav_host_us']:.1f} us, Svo.render {out['k3_host_us']:.1f} us"
        f" on {card}")
    if par is not None and not par["equal"]:
        fail(f"the parent's K3 draws another frame ({fmt})")
    if tpar is not None and not tpar["equal"]:
        fail(f"the parent's {kname.upper()} gives other hits ({fmt})")

    with Phase(f"k3 steps, primary and shadow ({fmt})"):
        out["k3_split"] = k3_split(svo, poses, launch_fn, head)
    sp = out["k3_split"]
    log(f"k3 steps ({fmt}; a pixel's primary steps from {kname} on its ray, "
        f"its shadow steps the rest of K3's; warps of 32 pixels of a row "
        f"against K3's 4x8 tiles; the {len(poses)} bench poses): SIMD "
        f"efficiency {json.dumps(sp['simd_eff'])}, the shadow share of the "
        f"slowest 1% of tile warps' steps (the largest pose's) "
        f"{sp['shadow_share_slowest_warps_max']:.4f}; regroup the shadow "
        f"rays (shadow tiles under 0.6 or that share 0.3 or more): "
        f"{sp['regroup_rule']}; per pose " + json.dumps([dict(
            mean_primary=r["primary"]["tiles"]["mean"],
            mean_shadow=r["shadow"]["tiles"]["mean"],
            simd_eff={f"{ph}_{g}": r[ph][g]["simd_eff"]
                      for ph in ("primary", "shadow", "total")
                      for g in ("rows", "tiles")},
            shadow_share_slowest_warps=r["shadow_share_slowest_warps"],
            shadow_share_all_warps=r["shadow_share_all_warps"],
            slowest_warp_steps=r["slowest_warp_steps"])
            for r in sp["poses"]]) + f" on {card}")
    if not sp["split_ok"]:
        fail(f"K3's primary steps differ from {kname}'s on the same rays "
             f"({fmt})")
    return out


def k3_split(svo, poses, launch_fn, head) -> dict:
    """K3's traversal steps on each bench pose split into the primary ray's
    (K1 / K4 on the pixel's ray with K3's primary budget and judge) and the
    shadow ray's (K3's steps less those), grouped into warps two ways:
    32 pixels of a row (K3 before the tiles) and the 4x8 tiles K3 runs
    (``_build.tile_lanes``); per pose and summed over the poses, the
    primary and shadow phases' SIMD efficiency (``warp_stats``) and the
    shadow share of the slowest warps' steps: over the tile warps, a warp's
    longest primary plus its longest shadow ray (its two phases one after
    the other), the slowest 1% of warps by that sum. The rule of this
    kernel's design: regroup the shadow rays into full warps if the shadow
    phase's SIMD efficiency in tiles is under 0.6 or the shadow steps are
    0.3 or more of the slowest warps' steps."""
    import numpy as np
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import shading

    dev = svo.device_buf.device
    B = W * H
    tables = svo.kernel_tables()
    lanes = _build.tile_lanes(W, H, dev)
    on = lanes >= 0
    tile_wid = torch.empty(B, dtype=torch.long, device=dev)
    tile_wid[lanes[on]] = (torch.arange(lanes.shape[0], device=dev) // 32)[on]
    row_wid = torch.arange(B, device=dev) // 32
    md = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
    sums = {}
    per_pose = []
    split_ok = True
    for p in poses:
        fp = shading.frame_params(mip_mode=shading.mip_mode_from_env(),
                                  csvo=svo.buffer_dtype == np.uint8,
                                  **svo.frame_kwargs(p, W, H))
        img = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
        total = torch.empty(B, dtype=torch.int32, device=dev)
        _build.launch_k3(svo.world(), float(svo.octree_scale), tables, fp, img,
                         total)
        ro, rd = primary_rays(svo, p)
        t_out = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in (
            (B, torch.float32), (B, torch.int32), (B, torch.int32),
            ((B, 3), torch.float32), ((B, 2), torch.float32),
            (B, torch.float32), (B, torch.bool), (B, torch.int32))]
        launch_fn(*head, ro, rd, md, fp.primary_budget, 1, tables, *t_out)
        prim = t_out[7]
        shadow = total - prim
        split_ok &= bool((shadow >= 0).all()) and not bool(
            (shadow[t_out[0] < 0] != 0).any())
        r = {}
        for phase, st in (("primary", prim), ("shadow", shadow),
                          ("total", total)):
            r[phase] = dict(rows=warp_stats(st, row_wid),
                            tiles=warp_stats(st, tile_wid))
        nw = int(tile_wid.max()) + 1
        wmax = {ph: torch.zeros(nw, dtype=torch.long, device=dev)
                .scatter_reduce_(0, tile_wid, st.long(), "amax")
                for ph, st in (("primary", prim), ("shadow", shadow))}
        both = wmax["primary"] + wmax["shadow"]
        slow = torch.topk(both, max(1, nw // 100)).indices
        r["shadow_share_slowest_warps"] = float(
            wmax["shadow"][slow].sum() / both[slow].sum())
        r["shadow_share_all_warps"] = float(wmax["shadow"].sum()
                                            / both.sum())
        r["slowest_warp_steps"] = int(both.max())
        per_pose.append(r)
        for k in ("primary", "shadow"):
            for g in ("rows", "tiles"):
                a = sums.setdefault((k, g), [0, 0])
                a[0] += r[k][g]["lane_sum"]
                a[1] += r[k][g]["warp_max_sum"]
    eff = {f"{k}_{g}": v[0] / (32 * v[1]) if v[1] else None
           for (k, g), v in sums.items()}
    slow_share = max(r["shadow_share_slowest_warps"] for r in per_pose)
    regroup = (eff["shadow_tiles"] is not None and eff["shadow_tiles"] < 0.6
               ) or slow_share >= 0.3
    return dict(simd_eff=eff, shadow_share_slowest_warps_max=slow_share,
                regroup_rule=regroup, split_ok=split_ok, poses=per_pose)


class Spy:
    """Stands in for a module function: calls it and keeps copies of the
    tensors of each call's arguments (for the comparisons after a run),
    and with ``outs`` (argument positions) copies of those arguments after
    the call in ``self.outs``."""

    def __init__(self, module, name, outs=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls, self.outs, self.out_pos = [], [], outs

    def __enter__(self):
        import torch

        def run(*args, **kw):
            keep = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
            self.calls.append(([keep(a) for a in args],
                               {k: keep(v) for k, v in kw.items()}))
            r = self.fn(*args, **kw)
            if self.out_pos:
                self.outs.append([keep(args[i]) if i < len(args) else None
                                  for i in self.out_pos])
            return r

        setattr(self.module, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def deferred_counts():
    """Launch counts of the deferred frame's kernels (K9's too)."""
    from voxelrs_tpu_torch.ops import adaptive, beams, compact, shading

    return dict(**{f"k9_{k}": getattr(adaptive, f"launches_{k}") for k in K9},
                k6=compact.launches,
                k7=beams.launches_tile + beams.launches_shadow,
                k7_tile=beams.launches_tile,
                k7_shadow=beams.launches_shadow,
                k8=beams.launches_sun + beams.launches_sun_floors,
                k8_verdicts=beams.launches_sun,
                k8_lit_floors=beams.launches_sun_floors,
                **{f"kd_{s}": getattr(shading, f"launches_{s}")
                   for s in STAGES})


def zero_deferred_counts():
    from voxelrs_tpu_torch.ops import adaptive, beams, compact, shading

    for k in K9:
        setattr(adaptive, f"launches_{k}", 0)
    compact.launches = 0
    for s in STAGES:
        setattr(shading, f"launches_{s}", 0)
    beams.launches_tile = beams.launches_shadow = 0
    beams.launches_sun = beams.launches_sun_floors = 0


def event_ms(fn) -> float:
    """Milliseconds of one call of ``fn`` between two CUDA events."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def bits_equal(a, b) -> bool:
    """Equal bit for bit (float tensors compared as their words, so the
    uninitialized tails of workspace buffers compare equal to their
    copies even where they hold NaNs)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs(a, b) -> float:
    """max |a - b| with equal infinities counting 0 (floors, masks)."""
    import torch

    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def plain_deferred(svo, p, beams):
    """The plain deferred frame of pose ``p`` on ``svo``'s own tensors, with
    the inputs ``Svo.render`` gives the stages."""
    from voxelrs_tpu_torch.ops import shading

    return shading.render_frame_deferred_plain(
        svo.world(), svo.octree_scale, svo.mips, svo.mat_params, svo.mat_tex,
        **svo.frame_kwargs(p, W, H), opaque=svo.is_opaque(), beams=beams)


def plain_adaptive(svo, p, beams):
    """The plain adaptive frame of pose ``p`` on ``svo``'s own tensors, with
    the grids ``Svo.render`` takes."""
    from voxelrs_tpu_torch.ops import adaptive

    return adaptive.render_frame_adaptive_plain(
        svo.world(), svo.octree_scale, svo.mips, svo.mat_params, svo.mat_tex,
        **svo.frame_kwargs(p, W, H), beams=beams,
        levels=adaptive.adaptive_levels(W, H))


def thick_ray(img, fused, exact, levels: int) -> dict:
    """The adaptive frame against the exact frame (tests/test_render.py:
    162-182): the traced samples — the pixels of the coarsest grid, with
    the half grid (``levels`` 1) the even coordinates and the last row and
    column — equal the exact deferred frame's and are within 1e-6 of K3's;
    mean |d| and the share of pixels off by more than 1e-3 against K3's;
    and how many half-grid sample pixels differ from the exact frame (with
    the quarter grid some are fills, wrong at a feature smaller than a
    cell, in the JAX frame too)."""
    import torch

    from voxelrs_tpu_torch.ops import adaptive

    dev = img.device
    ids = adaptive.grid_pixel_ids(W, H, levels, dev)
    half = adaptive.grid_pixel_ids(W, H, 1, dev)
    flat = lambda a, i: a.reshape(-1, 4)[i]  # noqa: E731
    d = (img.double() - fused.double()).abs()
    return dict(samples_equal=bool(torch.equal(flat(img, ids),
                                               flat(exact, ids))),
                samples_vs_k3=max_abs(flat(img, ids), flat(fused, ids)),
                mean=float(d.mean()),
                off=float((d.amax(-1) > 1e-3).double().mean()),
                half_grid_samples_off=int((flat(img, half) != flat(exact, half))
                                          .any(-1).sum()))


def thick_ray_ok(st: dict) -> bool:
    return (st["samples_equal"] and st["samples_vs_k3"] <= K3_MAX_ABS
            and st["mean"] < 0.002 and st["off"] < 0.02)


def sky_pose(svo, p0):
    """Pose ``p0`` pitched up 10 degrees at a time until under
    SKY_HIT_SHARE of the pixels hit (the adaptive frame's hit count)."""
    import numpy as np

    from voxelrs_tpu_torch.graphics.svo import RenderParams

    f = np.asarray(p0.cam_fwd, np.float64)
    flat = np.array([f[0], 0.0, f[2]]) / np.hypot(f[0], f[2])
    pitch = np.arcsin(f[1])
    for deg in range(10, 90, 10):
        a = pitch + np.radians(deg)
        p = RenderParams(**{**p0.__dict__})
        p.cam_fwd = (np.cos(a) * flat + np.array([0.0, np.sin(a), 0.0])
                     ).astype(np.float32)
        svo.render(p, W, H)
        hits = int(svo._workspace.hcount)
        if hits < SKY_HIT_SHARE * W * H:
            return p, deg, hits
    fail("no pitched-up pose with few enough hits")


def adaptive_phase(svo, hf, poses, card) -> dict:
    """The adaptive thick-ray frame (``Svo.render``'s default at 1080p on
    an opaque world) on ``svo``'s format with the scene's envelope: counts
    from 0 over the 5 bench poses and a pitched-up one (the single-pass
    shadow branch); the frame against its plain version and the thick-ray
    budget of K3's frame on every pose in three variants; K9's kernels
    against their plain versions on pose 0's own inputs and its trace
    against K1 / K4; the kernels alone, the frame against the exact
    deferred and the fused frames, and the grids' shares."""
    import numpy as np
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import (adaptive, beams, compact, traversal,
                                       traversal_csvo)

    csvo = svo.buffer_dtype == np.uint8
    fmt = "csvo" if csvo else "esvo"
    dev = svo.device_buf.device
    B = W * H
    svo.set_heightfield(hf)
    levels = adaptive.adaptive_levels(W, H)
    out = {"levels": levels}
    with Phase(f"adaptive pitched-up pose ({fmt})"):
        sky, deg, sky_hits = sky_pose(svo, poses[0])
    poses6 = list(poses) + [sky]
    log(f"adaptive ({fmt}): pose 5 = pose 0 pitched up {deg} degrees, "
        f"{sky_hits} hit pixels ({sky_hits / B:.4f})")

    with Phase(f"adaptive main path ({fmt})"):
        zero_deferred_counts()
        frames, infos, marks = [], [], []
        held = Held(("k9_merge", "k9_finalize", "k9_shadow_cells")
                    + SHADOW_HELD + BEAM_HELD)
        with held:
            for p in poses6:
                frames.append(svo.render(p, W, H))
                infos.append(dict(svo.last_frame))
                ab = svo._workspace.adaptive(W, H, levels)
                marks.append((svo._workspace.hcount.clone(),
                              ab.dense.clone()))
        torch.cuda.synchronize()
        n = out["launches"] = deferred_counts()
    with Phase(f"k9 merge, finalize, shadow cells, kd_shadow, kd_finish "
               f"and k7_shadow vs plain, every call ({fmt})"):
        out["held"] = held.check()
        del held
    log(f"k9 merge, finalize, shadow cells (both steps), kd_shadow, "
        f"kd_finish, k7_shadow, k7_tiles and k8 vs their plain versions on "
        f"every call of the {len(poses6)} frames ({fmt}; bit for bit, the "
        f"finalize's sky within {K3_MAX_ABS:g}): {json.dumps(out['held'])}")
    if not held_ok(out["held"]):
        fail(f"K9's merge, finalize or shadow cells, kd_shadow, kd_finish, "
             f"K7's shadow or tile floors or K8 disagree with their plain "
             f"versions in the {fmt} adaptive frames")
    branches = [dict(hits=int(h), dense=bool(int(d)),
                     dense_rule=adaptive.dense_frame(int(h), B))
                for h, d in marks]
    out["branches"] = branches
    log(f"adaptive main path launches ({fmt}, {len(poses6)} poses): "
        f"{json.dumps(n)}; last frame {json.dumps(infos[-1])}")
    log(f"adaptive shadow branch per pose ({fmt}): " + ", ".join(
        f"pose {i}: {b['hits']} hits, "
        f"{'two-pass cells' if b['dense'] else 'single pass'}"
        for i, b in enumerate(branches)))
    if not all(n[f"k9_{k}"] for k in K9) or not (
            n["k6"] and n["k7"] and n["k8"] and n["kd_shade"]
            and n["kd_shadow"] and n["kd_finish"]) or n["kd_primary"]:
        fail(f"the {fmt} adaptive path launched another set of kernels")
    if not all(i.get("adaptive") and i.get("hierarchy") == levels - 1
               and i.get("opaque") and i.get("beams") and i.get("sun")
               for i in infos):
        fail(f"the {fmt} bench frame did not take the adaptive opaque "
             "branch with beams and the sun map")
    if any(b["dense"] != b["dense_rule"] for b in branches) \
            or branches[-1]["dense"]:
        fail(f"the {fmt} adaptive frame took the wrong shadow branch")
    for img in frames:
        if tuple(img.shape) != (H, W, 4) or not bool(torch.isfinite(img).all()):
            fail(f"{fmt} adaptive frame has the wrong shape or non-finite "
                 "values")

    with Phase(f"adaptive vs plain and vs k3 ({fmt})"):
        variants = ("beams_sun", "beams", "no_heightfield")
        errs = dict.fromkeys(variants, 0.0)
        stats, flat_stats = [], []
        for i, p in enumerate(poses6):
            fused = svo.render(p, W, H, mode="fused")
            exact = svo.render(p, W, H, adaptive=False)
            ctx = svo.beam_context(p, W, H)
            for name, b in zip(variants, (ctx, ctx.without_sun(), None)):
                img = svo.render(p, W, H, beams=b)
                ref = []
                ms = event_ms(lambda: ref.append(plain_adaptive(svo, p, b)))
                if i == 0 and name == "beams_sun":
                    out["plain_ms"] = ms
                errs[name] = max(errs[name], max_abs(img, ref[0]))
                if name == "beams_sun":
                    stats.append(thick_ray(img, fused, exact, levels))
            # the flat path (the half grid traced, VOXELRS_HIERARCHY=0)
            os.environ["VOXELRS_HIERARCHY"] = "0"
            try:
                flat = svo.render(p, W, H, beams=ctx)
            finally:
                del os.environ["VOXELRS_HIERARCHY"]
            flat_stats.append(thick_ray(flat, fused, exact, 1))
    out["vs_plain"], out["vs_exact"] = errs, stats
    out["vs_exact_flat"] = flat_stats
    out["vs_plain_ok"] = all(v <= K3_MAX_ABS for v in errs.values())
    out["vs_exact_ok"] = all(thick_ray_ok(st) for st in stats + flat_stats)
    log(f"adaptive vs its plain version ({fmt}, {len(poses6)} poses): max |d| "
        f"{json.dumps(errs)} (tolerance {K3_MAX_ABS:g}); ok "
        f"{out['vs_plain_ok']}; plain frame (pose 0, beams and sun map) "
        f"{out['plain_ms']:.1f} ms")
    log(f"adaptive vs the exact frame ({fmt}; the traced grid's pixels "
        f"equal to the exact deferred frame and within {K3_MAX_ABS:g} of "
        f"K3's, mean |d| < 0.002, under 2% of pixels off by 1e-3): "
        f"quarter grid (default) {json.dumps(stats)}; half grid "
        f"(VOXELRS_HIERARCHY=0) {json.dumps(flat_stats)}; ok "
        f"{out['vs_exact_ok']}")
    if not out["vs_plain_ok"]:
        fail(f"the {fmt} adaptive frame disagrees with its plain version")
    if not out["vs_exact_ok"]:
        fail(f"the {fmt} adaptive frame is outside the thick-ray budget")

    with Phase(f"k9 vs plain, alone ({fmt})"):
        p0 = poses[0]
        ctx = svo.beam_context(p0, W, H)
        spies = {k: Spy(adaptive, f"k9_{k}") for k in K9}
        spies["k6"] = Spy(compact, "compact_indices")
        for sp in spies.values():
            sp.__enter__()
        try:
            svo.render(p0, W, H, beams=ctx)
        finally:
            for sp in spies.values():
                sp.__exit__()
        torch.cuda.synchronize()
        k6_spy = spies.pop("k6")
        ncalls = {k: len(sp.calls) for k, sp in spies.items()}
        if ncalls != dict(trace=levels + 1, merge=levels, finalize=1,
                          shadow_cells=2):
            fail(f"the {fmt} adaptive frame ran K9 another way: {ncalls}")
        res = {k: dict(equal=True, err=0.0, ms=0.0, plain_ms=0.0, calls=[])
               for k in K9}

        def note(k, equal, err, ms, plain_ms, **info):
            r = res[k]
            r["equal"] &= bool(equal)
            r["err"] = max(r["err"], err)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["calls"].append(dict(equal=bool(equal), ms=ms, **info))

        # trace: every call (the coarsest grid, then each refine list), and
        # each against K1 / K4 on the same pixel rays from the same floors.
        # The bound reads the world once a frame, not once a launch: the
        # rays of a frame visit few of its nodes, and the world stays in L2
        # across the frame's trace launches.
        vs_k1 = dict.fromkeys(("t", "value", "face_id", "pos", "uv", "lod"),
                              0)
        trace_steps = trace_lanes = 0
        trace_bytes = svo.device_buf.numel() * 4
        for args, kw in spies["trace"].calls:
            world, scale, fp, tf, level, rec0 = args
            idx, cnt = kw.get("idx"), kw.get("count")
            outs = [rec0.clone() for _ in range(3)]
            adaptive.k9_trace(world, scale, fp, tf, level, outs[0], idx, cnt)
            pms = event_ms(lambda: adaptive.k9_trace_plain(
                world, scale, fp, tf, level, outs[1], idx, cnt))
            kms = kernel_ms(lambda: _build.launch_k9_trace(
                world, scale, fp, tf, level, outs[2], idx, cnt))
            lanes = (torch.arange(rec0.shape[0], device=dev) if idx is None
                     else idx[: int(cnt)].long())
            ids = adaptive.grid_pixel_ids(W, H, level, dev)[lanes]
            ro, rd = adaptive._frame_rays(fp, ids)
            fl = beams.pixel_floors_at(tf, ids, W)
            if csvo:
                k1 = traversal_csvo.intersect_octree_csvo(
                    world.words, scale, world.root_ptr, world.total_depth,
                    ro, rd, -1.0, False, t_floor=fl)
            else:
                k1 = traversal.intersect_octree(world, scale, ro, rd, -1.0,
                                                False, t_floor=fl)
            t_min, sc, px, py, pz, value, flags = adaptive._unpack(
                outs[0][lanes])
            c = traversal.make_ray_consts(scale, ro, rd, -1.0)
            fields = traversal.finalize_fields(
                c, sc, px, py, pz, t_min, (flags & 1) != 0, value)
            for f, a, b in zip(vs_k1, fields, (k1.t, k1.value, k1.face_id,
                                               k1.pos, k1.uv, k1.lod)):
                neq = a != b
                vs_k1[f] += int((neq.any(-1) if neq.dim() > 1 else neq).sum())
            steps = int(k1.steps.sum())
            trace_steps += steps
            trace_lanes += lanes.shape[0]
            trace_bytes += (lanes.shape[0] * 32 + tf.numel() * 4
                            + (0 if idx is None else lanes.shape[0] * 4 + 4))
            wl, hl = adaptive.grid_dims(W, H, level)[level]
            parent = parent_launch("k9_trace", args, kw, [outs[1]])
            note("trace", torch.equal(outs[0], outs[1])
                 and (parent is None or parent["equal"]),
                 max_abs(outs[0], outs[1]), kms, pms, level=level,
                 lanes=lanes.shape[0], steps=steps,
                 launch=trace_launch_stats(k1.steps, lanes, idx, wl, hl),
                 parent=parent)
        out["trace_vs_k1"] = dict(lanes=trace_lanes, differing=vs_k1,
                                  steps=trace_steps)
        out["trace_bound"] = bound(trace_bytes, trace_steps * OPS_PER_STEP
                                   + trace_lanes * OPS_K9_RAY)
        # merge: each level
        shares = {}
        merge_bytes = merge_ops = 0
        for args, _kw in spies["merge"].calls:
            scale, fp, level, lo, hi0, ref0 = args
            ko, kr = hi0.clone(), ref0.clone()
            adaptive.k9_merge(scale, fp, level, lo, ko, kr)
            po, pr = hi0.clone(), ref0.clone()
            pms = event_ms(lambda: adaptive.k9_merge_plain(
                scale, fp, level, lo, po, pr))
            to, tr = hi0.clone(), ref0.clone()
            kms = kernel_ms(lambda: _build.launch_k9_merge(
                scale, fp, level, lo, to, tr))
            wl, hl = adaptive.grid_dims(W, H, level)[level]
            g = adaptive.coarse_grid(wl, hl, dev)
            sample = g.sample_masks()[0]
            hit = (ko[:, 6] & 1) != 0
            h4 = g.up4((lo[:, 6] & 1) != 0)
            all4 = h4[0] & h4[1] & h4[2] & h4[3] & ~sample
            nl = ko.shape[0]
            shares[level] = dict(
                lanes=nl, samples=float(sample.double().mean()),
                filled=int((hit & ~sample & ~kr).sum()) / nl,
                refined=int(kr.sum()) / nl)
            merge_bytes += lo.shape[0] * 32 + nl * 33
            merge_ops += int(all4.sum()) * (OPS_K9_RAY + OPS_K9_FILL)
            parent = parent_launch("k9_merge", args, _kw, [po, pr])
            # the same launch on records that all miss: no lane fills
            lo0 = torch.zeros_like(lo)
            ms0 = kernel_ms(lambda: _build.launch_k9_merge(
                scale, fp, level, lo0, to, tr))
            note("merge", torch.equal(ko, po) and torch.equal(kr, pr)
                 and (parent is None or parent["equal"]),
                 max(max_abs(ko, po), max_abs(kr, pr)), kms, pms,
                 level=level, parent=parent, ms_no_hits=ms0)
        out["merge_bound"] = bound(merge_bytes, merge_ops)
        shares[levels] = dict(lanes=spies["trace"].calls[0][0][5].shape[0],
                              samples=1.0, filled=0.0, refined=0.0)
        out["shares_pose0"] = shares
        # finalize
        (scale, fp, frec, rec0, hit0, img0, np0, bp0), _kw = \
            spies["finalize"].calls[0]
        ko = [t.clone() for t in (rec0, hit0, img0, np0, bp0)]
        adaptive.k9_finalize(scale, fp, frec, *ko)
        po = [t.clone() for t in (rec0, hit0, img0, np0, bp0)]
        pms = event_ms(lambda: adaptive.k9_finalize_plain(scale, fp, frec,
                                                          *po))
        to = [t.clone() for t in (rec0, hit0, img0, np0, bp0)]
        kms = kernel_ms(lambda: _build.launch_k9_finalize(scale, fp, frec,
                                                          *to))
        hits = int(ko[1].sum())
        img_err = max_abs(ko[2], po[2])
        parent = parent_launch("k9_finalize", spies["finalize"].calls[0][0],
                               _kw, po)
        # the same launch on records that all miss: every pixel its sky
        frec0 = torch.zeros_like(frec)
        ms0 = kernel_ms(lambda: _build.launch_k9_finalize(scale, fp, frec0,
                                                          *to))
        note("finalize", all(bits_equal(a, b) for i, (a, b) in
                             enumerate(zip(ko, po)) if i != 2)
             and img_err <= K3_MAX_ABS
             and (parent is None or parent["equal"]), img_err, kms, pms,
             hits=hits, parent=parent, ms_no_hits=ms0)
        out["launch_args"] = {f"k9_{k}": spies[k].calls[
            0 if k in ("finalize", "shadow_cells") else -1]
            for k in ("merge", "finalize", "shadow_cells")}
        out["finalize_bound"] = bound(
            B * 32 + B * 36 + B + (B - hits) * 16 + 2 * B,
            B * OPS_K9_RAY + hits * OPS_K9_FINALIZE)
        # shadow cells: both steps; each launch also at a hit count of 0
        # (its fixed cost: the grid and the mask's zero tail) and, with
        # --parent, the parent's kernel. The bound reads each hit's index
        # and need, writes the whole mask, in step 1 each hit's pixel need
        # and the dense flag, in step 2 each hit's eight corner bytes.
        sc_bytes = 0
        for args, _kw in spies["shadow_cells"].calls:
            step, fp, rest = args[0], args[1], args[2:]
            ko = [t.clone() for t in rest]
            adaptive.k9_shadow_cells(step, fp, *ko)
            po = [t.clone() for t in rest]
            pms = event_ms(lambda: adaptive.k9_shadow_cells_plain(step, fp,
                                                                  *po))
            to = [t.clone() for t in rest]
            kms = kernel_ms(lambda: _build.launch_k9_shadow_cells(step, fp,
                                                                  *to))
            idle = zero_count(to, 1)
            ms0 = kernel_ms(lambda: _build.launch_k9_shadow_cells(step, fp,
                                                                  *idle))
            parent = parent_launch(
                "k9_shadow_cells", args, _kw,
                [po[i - 2] for i in LAUNCH_OUTS["k9_shadow_cells"]], 3)
            nh = int(rest[1])
            sc_bytes += (nh * (4 + 1) + rest[0].shape[0]
                         + (nh * 8 if step == 2 else nh + 4))
            if step == 2:
                # the interior candidates and the share whose verdict the
                # cells reused (the rest are the pass-2 mask)
                pix = rest[0][:nh].long()
                y, x = pix // W, pix % W
                interior = rest[2][:nh] & ~(((y % 2 == 0) | (y == H - 1))
                                            & ((x % 2 == 0) | (x == W - 1)))
                n_int = int(interior.sum())
                out["cells"] = dict(interior=n_int,
                                    pass2=int(ko[5][:nh].sum()),
                                    reused_share=1 - int(ko[5][:nh].sum())
                                    / max(n_int, 1))
            note("shadow_cells", all(bits_equal(a, b) for a, b in zip(ko, po))
                 and (parent is None or parent["equal"]),
                 max(max_abs(a, b) for a, b in zip(ko, po)), kms, pms,
                 step=step, hits=nh, ms_count0=ms0, parent=parent)
        out["shadow_cells_bound"] = bound(sc_bytes, 0)
        out["k6_calls"] = k6_calls(k6_spy.calls, dev)
    with Phase(f"kd_shadow, kd_finish and k7_shadow on the adaptive "
               f"frame's passes, with and without the sun map ({fmt})"):
        passes = shadow_passes(svo, poses[0])
        out["launch_args"].update(passes.pop("args"))
        out.update(passes)
        ksp = passes["kd_shadow"]
    for name in ("kd_finish", "k7_shadow"):
        for branch, calls in passes[name].items():
            for i, c in enumerate(calls):
                what = (f"{c['candidates']} candidates, {c['blocked']} "
                        "blocked" if name == "kd_finish" else
                        f"{c['rays']} rays of {c['lanes']} lanes, "
                        f"{c['march_steps']} march steps")
                log(f"{name} launch ({fmt}, pose 0's adaptive frame, "
                    f"{branch}, pass {i + 1}: {what}): equal to its plain "
                    f"version {c['equal']}; alone {c['ms']:.4f} ms, at "
                    f"count 0 {c['ms_count0']:.4f} ms, plain "
                    f"{c['plain_ms']:.2f} ms, bound {c['bound'][0]:.4g} ms "
                    f"({c['bound'][1]}); the parent's kernel "
                    f"{json.dumps(c['parent'])} on {card}")
    if not all(c["equal"] for n in ("kd_finish", "k7_shadow")
               for calls in passes[n].values() for c in calls) \
            or not all(passes["kd_finish"].values()) \
            or passes["k7_shadow"]["sun_map"] \
            or not passes["k7_shadow"]["no_sun_map"]:
        fail(f"kd_finish or K7's shadow floors disagree with their plain "
             f"versions, or ran on another branch, on the {fmt} adaptive "
             "frame's passes")
    for branch, calls in ksp.items():
        for i, c in enumerate(calls):
            log(f"kd_shadow launch ({fmt}, pose 0's adaptive frame, "
                f"{branch}, pass {i + 1}: {c['lanes']} traced, "
                f"{'sub-list' if c['sublist'] else 'every candidate'}, "
                f"{'floored' if c['floored'] else 'unfloored'}): "
                f"{json.dumps(c['launch'])}; equal to its plain version "
                f"{c['equal']}, hits vs {'k4' if csvo else 'k1'} differing "
                f"{c['vs_k1']}; alone {c['ms']:.4f} ms, at count 0 "
                f"{c['ms_count0']:.4f} ms, plain {c['plain_ms']:.2f} ms, "
                f"bound {c['bound'][0]:.4g} ms ({c['bound'][1]}); the "
                f"parent's kernel {json.dumps(c['parent'])} on {card}")
    if not all(c["equal"] and not c["vs_k1"] for calls in ksp.values()
               for c in calls) or not all(ksp.values()):
        fail(f"kd_shadow disagrees with its plain version or "
             f"{'K4' if csvo else 'K1'} on the {fmt} adaptive frame")
    out["k9"] = res
    out["k9_ok"] = all(r["equal"] for r in res.values()) and not any(
        out["trace_vs_k1"]["differing"].values())
    log_k6(f"adaptive frame ({fmt}, pose 0)", out["k6_calls"], card)
    for c in res["trace"]["calls"]:
        log(f"k9_trace launch ({fmt}, pose 0, level {c['level']}, "
            f"{'coarsest grid' if c['level'] == levels else 'refine list'}):"
            f" {json.dumps(c['launch'])}; alone {c['ms']:.4f} ms; the "
            f"parent's kernel {json.dumps(c['parent'])} on {card}")
    for k in ("merge", "finalize"):
        for c in res[k]["calls"]:
            log(f"k9_{k} launch ({fmt}, pose 0"
                + (f", level {c['level']}" if "level" in c else "")
                + f"): alone {c['ms']:.4f} ms, on records that all miss "
                f"{c['ms_no_hits']:.4f} ms; the parent's kernel "
                f"{json.dumps(c['parent'])} on {card}")
    for c in res["shadow_cells"]["calls"]:
        log(f"k9_shadow_cells launch ({fmt}, pose 0, step {c['step']}, "
            f"{c['hits']} hits): alone {c['ms']:.4f} ms, at a hit count of 0 "
            f"{c['ms_count0']:.4f} ms; the parent's kernel "
            f"{json.dumps(c['parent'])} on {card}")
    if not all(r["equal"] for r in out["k6_calls"]):
        fail(f"K6 disagrees with its plain version in the {fmt} adaptive "
             "frame")
    log(f"k9 trace vs {'k4' if csvo else 'k1'} ({fmt}, pose 0's {levels + 1} "
        f"traces: the coarsest grid, then each refine list; "
        f"{out['trace_vs_k1']['lanes']} lanes from the tile floors): rays "
        f"differing {json.dumps(out['trace_vs_k1']['differing'])}; "
        f"{out['trace_vs_k1']['steps']} steps")
    for k in K9:
        r = res[k]
        bd = out[f"{k}_bound"]
        log(f"k9_{k} vs plain ({fmt}, pose 0's own inputs, {len(r['calls'])} "
            f"launches a frame): equal {r['equal']} (max |d| {r['err']:.3g});"
            f" alone {r['ms']:.4f} ms a frame "
            f"({json.dumps([round(c['ms'], 4) for c in r['calls']])}), plain "
            f"{r['plain_ms']:.2f} ms, bound {bd[0]:.4g} ms ({bd[1]}) on {card}")
    log(f"adaptive grids ({fmt}, pose 0; per level: lanes, sample share, "
        f"filled share, refined = re-traced share): {json.dumps(shares)}; "
        f"shadow cells: {json.dumps(out.get('cells'))}")
    if not out["k9_ok"]:
        fail(f"a K9 kernel disagrees with its plain version or K1 ({fmt})")

    with Phase(f"adaptive timing ({fmt})"):
        for p in poses6:  # warm-up
            svo.render(p, W, H)
            svo.render(p, W, H, adaptive=False)
            svo.render(p, W, H, mode="fused")
        times = {}
        for path, kw in (("adaptive", {}), ("exact", dict(adaptive=False)),
                         ("fused", dict(mode="fused"))):
            ms = sorted(cuda_ms(lambda: svo.render(p, W, H, **kw), REPS)
                        for p in poses)
            times[path] = dict(median=ms[len(ms) // 2], poses=ms)
        out["host_us"] = host_us(lambda: svo.render(poses[0], W, H))
        torch.cuda.synchronize()
        rc = svo._workspace.adaptive(W, H, levels).rcounts.tolist()
    out["times"] = times
    out["frame_ms"] = times["adaptive"]["median"]
    out["mrays"] = B * 2 / (out["frame_ms"] / 1e3) / 1e6
    dims = adaptive.grid_dims(W, H, levels)
    out["refined_after_window"] = {
        k: dict(lanes=dims[k][0] * dims[k][1], refined=rc[k],
                share=rc[k] / (dims[k][0] * dims[k][1]))
        for k in range(levels)}
    log(f"adaptive frame {W}x{H} ({fmt}; Svo.render default, beams and sun "
        f"map; events from call to finished frame, median over the 5 bench "
        f"poses): adaptive {times['adaptive']['median']:.3f} ms, exact "
        f"deferred {times['exact']['median']:.3f} ms, fused (K3) "
        f"{times['fused']['median']:.3f} ms in the same run; per-pose "
        + json.dumps({k: [round(x, 3) for x in v['poses']]
                      for k, v in times.items()})
        + f"; host time of the adaptive call {out['host_us']:.1f} us; "
        f"refined lanes of the last timed frame (pose 0) "
        f"{json.dumps(out['refined_after_window'])}; on {card}")
    return out


def deferred_phase(svo, hf, poses, card) -> dict:
    """The deferred frame (``Svo.render``'s default mode) on ``svo``'s
    format with the scene's envelope: counts from 0 over one frame per pose;
    the frame against K3's fused frame with beams and the sun map, beams
    only and no heightfield on every pose; K6, K7 and K8 against their plain
    versions on pose 0's own inputs; K1 / K4 from the floors against their
    unfloored runs; the kernels alone and the frame, timed."""
    import numpy as np
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import (beams, compact, shading, traversal,
                                       traversal_csvo)

    csvo = svo.buffer_dtype == np.uint8
    fmt = "csvo" if csvo else "esvo"
    dev = svo.device_buf.device
    svo.set_heightfield(hf)
    out = {}
    with Phase(f"deferred main path ({fmt})"):
        zero_deferred_counts()
        with Held(("kd_primary",) + SHADOW_HELD + BEAM_HELD) as held:
            frames = [svo.render(p, W, H, adaptive=False) for p in poses]
        torch.cuda.synchronize()
        n = out["launches"] = deferred_counts()
        info = dict(svo.last_frame)
        out["held"] = held.check()
    log(f"deferred main path launches ({fmt}): {json.dumps(n)}; last frame "
        f"{json.dumps(info)}; sun map build {hf.sun_build_seconds} s host")
    log(f"kd_primary, kd_shadow, kd_finish, k7_shadow, k7_tiles and k8 vs "
        f"their plain versions on every call of the {len(poses)} frames "
        f"({fmt}; bit for bit, kd_primary's sky within {K3_MAX_ABS:g}): "
        f"{json.dumps(out['held'])}")
    if not held_ok(out["held"]):
        fail(f"kd_primary, kd_shadow, kd_finish, K7's shadow or tile floors "
             f"or K8 disagree with their plain versions in the {fmt} "
             "deferred frames")
    if not (n["k6"] and n["k7"] and n["k8"]
            and all(n[f"kd_{s}"] for s in STAGES)):
        fail(f"a kernel of the {fmt} deferred path was not launched")
    if not (info.get("opaque") and info.get("beams") and info.get("sun")):
        fail(f"the {fmt} bench frame did not take the opaque branch with "
             "beams and the sun map")
    for img in frames:
        if tuple(img.shape) != (H, W, 4) or not bool(torch.isfinite(img).all()):
            fail(f"{fmt} deferred frame has the wrong shape or non-finite "
                 "values")

    with Phase(f"deferred vs k3 and vs plain ({fmt})"):
        # every pose, in three variants: the stages against their plain
        # version (the plain deferred frame, same inputs and beam context)
        # and the frame against K3's fused frame
        variants = ("beams_sun", "beams", "no_heightfield")
        errs = dict.fromkeys(variants, 0.0)
        plain_errs = dict.fromkeys(variants, 0.0)
        held = Held(("kd_primary",) + SHADOW_HELD + BEAM_HELD)
        for i, p in enumerate(poses):
            fused = svo.render(p, W, H, mode="fused")
            with held:
                ctx = svo.beam_context(p, W, H)
            for name, b in zip(variants, (ctx, ctx.without_sun(), None)):
                with held:
                    img = svo.render(p, W, H, beams=b, adaptive=False)
                ref = []
                ms = event_ms(lambda: ref.append(plain_deferred(svo, p, b)))
                if i == 0 and name == "beams_sun":
                    out["plain_ms"] = ms
                errs[name] = max(errs[name], max_abs(img, fused))
                plain_errs[name] = max(plain_errs[name], max_abs(img, ref[0]))
        variants_held = held.check()
        out["held"] = held_merge(out["held"], variants_held)
    out["vs_k3"], out["vs_plain"] = errs, plain_errs
    log(f"kd_primary, kd_shadow, kd_finish, k7_shadow, k7_tiles and k8 vs "
        f"their plain versions on every call of the {len(poses)} poses' "
        f"three variants ({fmt}; bit for bit, kd_primary's sky within "
        f"{K3_MAX_ABS:g}): {json.dumps(variants_held)}")
    if not held_ok(variants_held, branch=()):
        fail(f"kd_primary, kd_shadow, kd_finish, K7's shadow or tile floors "
             f"or K8 disagree with their plain versions in the {fmt} "
             "deferred variants")
    out["vs_k3_ok"] = all(v <= K3_MAX_ABS for v in errs.values())
    out["vs_plain_ok"] = all(v <= K3_MAX_ABS for v in plain_errs.values())
    log(f"deferred vs k3 ({fmt}, {len(poses)} poses): max |d| "
        f"{json.dumps(errs)} (tolerance {K3_MAX_ABS:g}); ok {out['vs_k3_ok']}")
    log(f"deferred stages vs the plain deferred frame ({fmt}, "
        f"{len(poses)} poses): max |d| {json.dumps(plain_errs)} (tolerance "
        f"{K3_MAX_ABS:g}); ok {out['vs_plain_ok']}; plain frame (pose 0, "
        f"beams and sun map) {out['plain_ms']:.1f} ms")
    if not out["vs_k3_ok"]:
        fail(f"the {fmt} deferred frame disagrees with K3's fused frame")
    if not out["vs_plain_ok"]:
        fail(f"the {fmt} deferred stages disagree with their plain version")

    with Phase(f"k6 k7 k8 vs plain ({fmt})"):
        p0 = poses[0]
        with Spy(_build, "launch_k7_tiles") as k7t:
            ctx = svo.beam_context(p0, W, H)
        with Spy(compact, "compact_indices") as k6s, \
                Spy(_build, "launch_k8", LAUNCH_OUTS["k8"]) as k8l:
            svo.render(p0, W, H, beams=ctx, adaptive=False)
        with Spy(beams, "shadow_ray_floors") as k7s, \
                Spy(_build, "launch_k7_shadow") as k7l:
            svo.render(p0, W, H, beams=ctx.without_sun(),
                       adaptive=False)
        torch.cuda.synchronize()
        if len(k6s.calls) != 3 or len(k8l.calls) != 1 or len(k7s.calls) != 1 \
                or len(k7t.calls) != 1:
            fail(f"the {fmt} deferred frame's stages ran another way: "
                 f"{len(k6s.calls)} compactions, {len(k8l.calls)} K8, "
                 f"{len(k7s.calls)} K7 shadow, {len(k7t.calls)} K7 tile "
                 "calls")
        # K6 on the frame's own masks: hits, shadow candidates, uncertified
        k6 = k6_calls(k6s.calls, dev)
        k6_ms, k6_plain_ms, k6_library_ms, k6_bound = (
            k6[0]["ms"], k6[0]["plain_ms"], k6[0]["library_ms"],
            k6[0]["bound"])
        k6_fixed = k6_fixed_ms(dev)

        # K7 tile floors on pose 0: the frame's own launch (alone, without
        # its march, the plain version and the parent's kernel)
        k7tc = out["k7_tiles"] = launch_call("k7_tiles", *k7t.calls[0])
        floors = ctx.t_floor

        # K7 shadow floors on the frame's candidates (beams only)
        levels, offsets, nn, hmax, bounds, levels_e = ctx._dev
        sargs, skw = k7s.calls[0]
        # shadow_ray_floors(levels_e, h3d0, offsets, n, hmax, bounds, ro,
        # light_to, max_dst, idx=, count=)
        sro, light_to, smd = sargs[6], sargs[7], sargs[8]
        sidx, scount = skw["idx"], skw["count"]
        kf = beams.shadow_ray_floors(levels_e, levels[: nn * nn], offsets,
                                     nn, hmax, bounds, sro, light_to, smd,
                                     idx=sidx, count=scount)
        pf = beams.shadow_ray_floors_plain(
            levels_e, levels[: nn * nn], offsets, nn, hmax, bounds, sro,
            light_to, smd, idx=sidx, count=scount)
        sh_ok, sh_err = bool(torch.equal(kf, pf)), max_abs(kf, pf)
        # the frame's own launch: alone, at count 0, the parent's kernel
        k7c = out["k7_shadow"] = launch_call("k7_shadow", *k7l.calls[0])
        sh_ok = sh_ok and k7c["equal"]
        sh_ms, sh_plain_ms, sh_bound = k7c["ms"], k7c["plain_ms"], k7c["bound"]
        sh_steps, k_cand = k7c["march_steps"], k7c["rays"]

        # K8 on the frame's candidates (sun map): the frame's own launch
        # (verdicts and the lanes left to trace) and the lit floors on its
        # inputs, each alone, at count 0, plain and the parent's kernel
        vargs, vkw = k8l.calls[0]
        out["k8_args"] = k8l.calls[0]
        k8c = out["k8"] = launch_call("k8", vargs, vkw)
        out["k8_row_words"] = k8_widths(vargs, vkw)
        if not out["k8_row_words"]["equal"]:
            fail(f"K8 in another row word disagrees with its plain version "
                 f"({fmt})")
        largs = list(vargs[:7]) + [None, None, None,
                                   torch.empty(vargs[6], device=dev)]
        k8f = out["k8_lit_floors"] = launch_call("k8", largs, vkw)
        kl, kb = k8l.outs[0][:2]
        certified = float((kl | kb).sum()) / max(k8c["rays"], 1)
        sb = vargs[0]
    out.update(
        k6=k6, k6_fixed_ms=k6_fixed, k6_ok=all(c["equal"] for c in k6),
        k6_err=max(c["err"] for c in k6), k6_ms=k6_ms,
        k6_plain_ms=k6_plain_ms, k6_library_ms=k6_library_ms,
        k6_bound=k6_bound, k7_tile_ok=k7tc["equal"],
        k7_tile_err=k7tc["err"], k7_tile_ms=k7tc["ms"],
        k7_tile_plain_ms=k7tc["plain_ms"], k7_tile_bound=k7tc["bound"],
        k7_tile_steps=k7tc["march_steps"], k7_shadow_ok=sh_ok,
        k7_shadow_err=sh_err, k7_shadow_ms=sh_ms,
        k7_shadow_plain_ms=sh_plain_ms, k7_shadow_bound=sh_bound,
        k7_shadow_steps=sh_steps, k7_shadow_rays=k_cand,
        k8_ok=k8c["equal"] and k8f["equal"],
        k8_err=max(k8c["err"], k8f["err"]), k8_ms=k8c["ms"],
        k8_plain_ms=k8c["plain_ms"], k8_bound=k8c["bound"],
        k8_lit_floors_ms=k8f["ms"], k8_rays=k8c["rays"],
        k8_certified_share=certified,
        shadow_inf_share=float(torch.isinf(kf[:k_cand]).float().mean()),
        tile_inf_share=float(torch.isinf(ctx.tile_floors).float().mean()))
    log_k6(f"exact deferred frame ({fmt}, pose 0: hits, shadow candidates, "
           "uncertified)", k6, card)
    log(f"k6 alone, above its bytes: {json.dumps(k6_fixed)} ms (a 1-lane "
        f"mask; {W * H} lanes, none set, size 1) on {card}")
    log(f"k7 tile floors vs plain ({fmt}, pose 0's launch): equal "
        f"{k7tc['equal']} (max |d| {k7tc['err']:.3g}); {k7tc['tiles']} "
        f"tiles, {k7tc['march_steps']} march steps, the longest march "
        f"{k7tc['march_max']} iterations ({k7tc['march_descents']} of them "
        f"descents), +inf share {out['tile_inf_share']:.4f}; alone "
        f"{k7tc['ms']:.4f} ms, without its march (max_iters 0) "
        f"{k7tc['ms_no_march']:.4f} ms, plain {k7tc['plain_ms']:.2f} ms, "
        f"bound {k7tc['bound'][0]:.4g} ms ({k7tc['bound'][1]}); the "
        f"parent's kernel {json.dumps(k7tc['parent'])} on {card}")
    log(f"k7 shadow floors vs plain ({fmt}, {k_cand} candidates of "
        f"{k7c['lanes']} lanes): equal {sh_ok} (max |d| {sh_err:.3g}); "
        f"{sh_steps} march steps, +inf share "
        f"{out['shadow_inf_share']:.4f}; alone {sh_ms:.4f} ms, at count 0 "
        f"{k7c['ms_count0']:.4f} ms, plain {sh_plain_ms:.2f} ms, bound "
        f"{sh_bound[0]:.4g} ms ({sh_bound[1]}); the parent's kernel "
        f"{json.dumps(k7c['parent'])} on {card}")
    for label, c in (("verdicts and todo, the frame's launch", k8c),
                     ("lit floors on its inputs", k8f)):
        log(f"k8 {label} vs plain ({fmt}, {c['rays']} candidates of "
            f"{c['lanes']} lanes, table {tuple(sb.shape)} = "
            f"{sb.numel() * 2 / 1e6:.2f} MB, K {(sb.shape[1] - 76) // 2}, "
            f"rows of {sb.shape[1] * 2} bytes, {c['rows_read']} of them "
            f"read): equal {c['equal']} (max |d| "
            f"{c['err']:.3g}); certified share {certified:.4f}; alone "
            f"{c['ms']:.4f} ms, at count 0 {c['ms_count0']:.4f} ms, plain "
            f"{c['plain_ms']:.2f} ms, bound {c['bound'][0]:.4g} ms "
            f"({c['bound'][1]}); the parent's kernel "
            f"{json.dumps(c['parent'])} on {card}")
    log(f"k8, the frame's launch ({fmt}), its rows read as 16- / 8- / "
        f"4-byte words (those the width allows), median [quartiles] of "
        f"{K8_WIDTH_ROUNDS} turns: {json.dumps(out['k8_row_words']['ms'])} "
        f"ms on {card}")
    if not (out["k6_ok"] and out["k7_tile_ok"] and sh_ok and out["k8_ok"]):
        fail(f"K6, K7 or K8 disagrees with its plain version ({fmt})")

    with Phase(f"floored {'k4' if csvo else 'k1'} vs unfloored ({fmt})"):
        ro, rd = primary_rays(svo, poses[0])
        alpha = shading.make_alpha_fn(svo.mips, svo.mat_tex)
        w = svo.world()
        if csvo:
            q = lambda **k: traversal_csvo.intersect_octree_csvo(  # noqa: E731
                w.words, float(svo.octree_scale), w.root_ptr, w.total_depth,
                ro, rd, -1.0, True, alpha, **k)
        else:
            q = lambda **k: traversal.intersect_octree(  # noqa: E731
                w, float(svo.octree_scale), ro, rd, -1.0, True, alpha, **k)
        a, b = q(t_floor=floors), q()
        torch.cuda.synchronize()
        diff = {f: int((getattr(a, f) != getattr(b, f)).sum())
                for f in ("value", "face_id", "inside_voxel", "t")}
    out["floored"] = dict(rays=int(ro.shape[0]), differing=diff,
                          steps_floored=int(a.steps.sum()),
                          steps_unfloored=int(b.steps.sum()))
    out["floored_ok"] = not any(diff.values())
    log(f"floored vs unfloored ({fmt}, pose 0, {ro.shape[0]} primary rays): "
        f"differing {json.dumps(diff)}; steps {out['floored']['steps_floored']}"
        f" vs {out['floored']['steps_unfloored']} "
        f"({out['floored']['steps_floored'] / ro.shape[0]:.2f} vs "
        f"{out['floored']['steps_unfloored'] / ro.shape[0]:.2f} a ray)")
    if not out["floored_ok"]:
        fail(f"floored {fmt} traversal disagrees with the unfloored one")

    with Phase(f"deferred stages alone ({fmt})"):
        # each stage's launch on its own inputs from pose 0's frame (beams
        # and sun map), kept by spies on the launch wrappers
        spies = [Spy(_build, f"launch_kd_{s}") for s in STAGES]
        for sp in spies:
            sp.__enter__()
        try:
            svo.render(poses[0], W, H, adaptive=False)
        finally:
            for sp in spies:
                sp.__exit__()
        torch.cuda.synchronize()
        if any(len(sp.calls) != 1 for sp in spies):
            fail(f"the {fmt} deferred frame launched its stages another way")
        stage_ms = {s: kernel_ms(lambda sp=sp: sp.fn(*sp.calls[0][0],
                                                     **sp.calls[0][1]))
                    for s, sp in zip(STAGES, spies)}
        # the shadow stage's traced rays (the uncertified candidates):
        # their traversal steps from a traversal launch on the same rays,
        # the launch at count 0, its plain version and the parent's kernel
        ws = svo._workspace
        out["kd_shadow"] = kd_shadow_call(svo, spies[2].calls[0][0])
        shadow_steps = out["kd_shadow"]["steps"]
        # the finishing stage's launch: alone, at count 0, its plain
        # version and the parent's kernel
        out["kd_finish"] = launch_call("kd_finish", *spies[3].calls[0])
        # the primary stage's launch: alone, its plain version and the
        # parent's kernel; its rays' steps (K1 / K4 from the same floors,
        # the same cast) and K1 / K4 on the same rays unfloored
        out["kd_primary"] = primary_call(svo, *spies[0].calls[0])
        out["primary_args"] = spies[0].calls[0]
    ks, kfin, kp = out["kd_shadow"], out["kd_finish"], out["kd_primary"]
    log(f"kd_primary launch ({fmt}, pose 0's exact frame, {kp['hits']} "
        f"hits): equal to its plain version {kp['equal']} (max |d| "
        f"{kp['err']:.3g}); alone {kp['ms']:.4f} ms, plain "
        f"{kp['plain_ms']:.2f} ms; the parent's kernel "
        f"{json.dumps(kp['parent'])}; steps and warps from the floors "
        f"(rows of 32 pixels and 4x8 tiles) {json.dumps(kp['floored'])}; "
        f"{'k4' if csvo else 'k1'} on the same rays unfloored "
        f"{json.dumps(kp['unfloored'])}; ps a step: kd_primary "
        f"{kp['ps_per_step']:.3f}, parent "
        f"{kp['ps_per_step_parent'] or float('nan'):.3f}, "
        f"{'k4' if csvo else 'k1'} unfloored {kp['k1_ps_per_step']:.3f} on "
        f"{card}")
    if not kp["equal"]:
        fail(f"kd_primary disagrees with its plain version on the {fmt} "
             "exact frame")
    log(f"kd_finish launch ({fmt}, pose 0's exact frame: {kfin['candidates']} "
        f"candidates, {kfin['blocked']} blocked): equal to its plain version "
        f"{kfin['equal']}; alone {kfin['ms']:.4f} ms, at count 0 "
        f"{kfin['ms_count0']:.4f} ms, plain {kfin['plain_ms']:.2f} ms, bound "
        f"{kfin['bound'][0]:.4g} ms ({kfin['bound'][1]}); the parent's kernel "
        f"{json.dumps(kfin['parent'])} on {card}")
    if not kfin["equal"]:
        fail(f"kd_finish disagrees with its plain version on the {fmt} exact "
             "frame")
    log(f"kd_shadow launch ({fmt}, pose 0's exact frame, the sun map's "
        f"sub-list: {ks['lanes']} traced): {json.dumps(ks['launch'])}; "
        f"equal to its plain version {ks['equal']}, hits vs "
        f"{'k4' if csvo else 'k1'} differing {ks['vs_k1']}; alone "
        f"{ks['ms']:.4f} ms, at count 0 {ks['ms_count0']:.4f} ms, plain "
        f"{ks['plain_ms']:.2f} ms; the parent's kernel "
        f"{json.dumps(ks['parent'])} on {card}")
    if not ks["equal"] or ks["vs_k1"]:
        fail(f"kd_shadow disagrees with its plain version or "
             f"{'K4' if csvo else 'K1'} on the {fmt} exact frame")
    B = W * H
    hits, cand, traced = int(ws.hcount), int(ws.scount), int(ws.tcount)
    world_bytes = svo.device_buf.numel() * 4
    ntiles = -(-W // 8) * -(-H // 8)
    out["stages"] = dict(
        ms=stage_ms, hits=hits, candidates=cand, traced=traced,
        shadow_steps=shadow_steps,
        bound=dict(
            # tile floors in; hit records, hit mask and sky pixels out
            # (steps: K1 / K4 from the same floors, the same cast)
            primary=bound(world_bytes + ntiles * 4 + B * 36 + B
                          + (B - hits) * 16,
                          kp["floored"]["lane_sum"] * OPS_PER_STEP),
            # hit lanes and records in; colour, light, need, origin, pixel
            shade=bound(hits * (4 + 36 + 16 + 4 + 1 + 12 + 16),
                        hits * OPS_PER_PIXEL),
            # the traced lanes' indices and origins in, their verdicts out
            shadow=bound(world_bytes + traced * (4 + 4 + 12 + 1),
                         shadow_steps * OPS_PER_STEP),
            # candidates' indices and verdicts in; the blocked ones' pixel
            # index, colour and light in, their pixels out (launch_call)
            finish=out["kd_finish"]["bound"]))
    log(f"deferred stages alone ({fmt}, pose 0; {hits} hits, {cand} shadow "
        f"candidates, {traced} traced, {shadow_steps} shadow steps): "
        + ", ".join(f"{s} {stage_ms[s]:.4f} ms (bound "
                    f"{out['stages']['bound'][s][0]:.4g} ms, "
                    f"{out['stages']['bound'][s][1]})" for s in STAGES)
        + f" on {card}")

    with Phase(f"deferred timing ({fmt})"):
        for p in poses:  # warm-up
            svo.render(p, W, H, adaptive=False)
        frame_ms = sorted(cuda_ms(lambda: svo.render(p, W, H, adaptive=False),
                                   REPS)
                          for p in poses)
        out["frame_ms"] = frame_ms[len(frame_ms) // 2]
        out["frame_ms_poses"] = frame_ms
        out["mrays"] = W * H * 2 / (out["frame_ms"] / 1e3) / 1e6
        out["host_us"] = host_us(lambda: svo.render(poses[0], W, H,
                                                      adaptive=False))
    log(f"deferred frame {W}x{H} ({fmt}; Svo.render default mode, beams and "
        f"sun map; events from call to finished frame): median "
        f"{out['frame_ms']:.3f} ms/frame, per-pose medians "
        f"{[round(x, 3) for x in frame_ms]}; {out['mrays']:.2f} Mrays/s; "
        f"host time of the call {out['host_us']:.1f} us, on {card}")
    return out


def build_translucent_world(opaque_lut, seed: int = TRANSLUCENT_SEED):
    """``bench.py``'s procedural region (``build_world``: the same
    generator, chunks and distance-banded LOD) with three translucent
    materials placed from ``seed``: water up to a sea level in the valleys
    (the columns under the SEA_PERCENTILE-th percentile of the surface),
    GLASS_TOWERS 3 x 3 glass columns 12 voxels tall and CANOPIES leaf
    canopies (5 x 2 x 5 leaves on a 4-log trunk), on land in the part of
    the region the bench poses look at. Returns (ESVO world, CSVO world,
    chunk count, HeightField, a summary of what was placed)."""
    import numpy as np

    from voxelrs_tpu_torch.gamelogic import content as C
    from voxelrs_tpu_torch.gamelogic.worldgen import Generator, default_config
    from voxelrs_tpu_torch.systems.chunkloader import ChunkLoader
    from voxelrs_tpu_torch.world.chunk import ChunkPos
    from voxelrs_tpu_torch.world.csvo import Csvo, CsvoSerializedChunk
    from voxelrs_tpu_torch.world.esvo import Esvo, SerializedChunk
    from voxelrs_tpu_torch.world.heightfield import (HeightField,
                                                     chunk_column_tops,
                                                     chunk_solid_bases,
                                                     chunk_voxel_tops)
    from voxelrs_tpu_torch.world.octree import Position

    radius, n, top = 4, 256, 256
    gen = Generator(1, default_config())
    surf = np.zeros((n, n), np.int32)  # [x, z]: the grass voxel's y
    cols = {}
    for cx in range(2 * radius):
        for cz in range(2 * radius):
            cols[cx, cz] = gen.get_column(cx, cz)
            surf[cx * 32:(cx + 1) * 32, cz * 32:(cz + 1) * 32] = \
                cols[cx, cz].height_map
    # the generator's fill (Generator.generate_chunk), dense over the region
    y = np.arange(top, dtype=np.int32)[None, :, None]
    h = surf[:, None, :]
    vox = np.where(y > h, C.AIR, np.where(y >= h, C.GRASS, np.where(
        y >= h - 3, C.DIRT, C.STONE))).astype(np.uint8)
    sea = int(np.percentile(surf, SEA_PERCENTILE))
    wet = surf < sea
    water = (y > h) & (y <= sea) & wet[:, None, :]
    vox[water] = C.WATER
    rng = np.random.default_rng(seed)
    land = np.argwhere(~wet[40:150, 30:150]) + np.array([40, 30])
    placed = []
    for i, (x, z) in enumerate(land[rng.choice(len(land),
                                               GLASS_TOWERS + CANOPIES,
                                               replace=False)]):
        if i < GLASS_TOWERS:
            base = int(surf[x:x + 3, z:z + 3].max()) + 1
            box = vox[x:x + 3, base:base + 12, z:z + 3]
            box[box == C.AIR] = C.GLASS
            placed.append(("glass", int(x), base, int(z)))
        else:
            base = int(surf[x, z]) + 1
            vox[x, base:base + 4, z] = C.OAK_LOG
            box = vox[x - 2:x + 3, base + 4:base + 6, z - 2:z + 3]
            box[box == C.AIR] = C.OAK_LEAVES
            placed.append(("leaves", int(x), base, int(z)))
    svo, csvo, hf = Esvo(), Csvo(), HeightField()
    center = ChunkPos(radius, 2, radius)
    count = 0
    for cx in range(2 * radius):
        for cz in range(2 * radius):
            lod = ChunkLoader.calculate_lod(center, ChunkPos(cx, 0, cz))
            for cy in range(top // 32):
                v = vox[cx * 32:(cx + 1) * 32, cy * 32:(cy + 1) * 32,
                        cz * 32:(cz + 1) * 32].astype(np.uint32)
                # bench.py's chunks, and those the placements reach
                if not (cols[cx, cz].contains_chunk(cy)
                        or np.isin(v, (C.GLASS, C.OAK_LOG, C.OAK_LEAVES,
                                       C.WATER)).any()):
                    continue
                pos = ChunkPos(cx, cy, cz)
                sc = SerializedChunk.from_voxels(pos, v, lod)
                if not sc.has_data():
                    continue
                svo.set_leaf(Position(cx, cy, cz), sc, True)
                csvo.set_leaf(Position(cx, cy, cz),
                              CsvoSerializedChunk.from_voxels(pos, v, lod),
                              True)
                hf.set_chunk((cx, cy, cz), chunk_column_tops(v, lod),
                             vtops=chunk_voxel_tops(v, lod),
                             sbase=chunk_solid_bases(v, lod, opaque_lut))
                count += 1
    svo.serialize()
    csvo.serialize()
    info = dict(sea_level=sea, water_columns=int(wet.sum()),
                water_voxels=int(water.sum()), placed=placed)
    return svo, csvo, count, hf, info


def judged_counts():
    """Launch counts of the judged adaptive frame's kernels and those
    around them (``deferred_counts``)."""
    from voxelrs_tpu_torch.ops import adaptive_judged

    return dict(**{f"k9j_{k}": getattr(adaptive_judged, f"launches_{k}")
                   for k in K9J}, **deferred_counts())


def zero_judged_counts():
    from voxelrs_tpu_torch.ops import adaptive_judged

    for k in K9J:
        setattr(adaptive_judged, f"launches_{k}", 0)
    zero_deferred_counts()


def plain_judged(svo, p, beams, hole_fill=False):
    """The plain judged adaptive frame of pose ``p`` on ``svo``'s own
    tensors, with the grids ``Svo.render`` takes."""
    from voxelrs_tpu_torch.ops import adaptive, adaptive_judged

    return adaptive_judged.render_frame_adaptive_judged_plain(
        svo.world(), svo.octree_scale, svo.mips, svo.mat_params, svo.mat_tex,
        **svo.frame_kwargs(p, W, H), beams=beams,
        levels=adaptive.frame_levels(W, H, False), hole_fill=hole_fill)


def judged_phase(svo, hf, poses, card) -> dict:
    """The judged adaptive frame (``Svo.render``'s default at 1080p on a
    translucent world) on ``svo``'s format with the scene's envelope:
    counts from 0 over the 5 bench poses and a pitched-up one (the
    single-pass shadow branch); the frame against its plain version on
    every pose, against the exact judged frame within the thick-ray budget
    and against its beams-only variant (the sun map's certificates on the
    judged shadow rays against the floored judged traces); a pose with the
    hole fill; K9-judged's kernels against their plain versions on pose
    0's own inputs and its grid trace against K1 / K4 judged on the same
    rays; the kernels alone; the judged adaptive, exact judged and fused
    frames timed in one run, and the grids' shares."""
    import numpy as np
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import (adaptive, adaptive_judged, beams,
                                       traversal, traversal_csvo)

    aj = adaptive_judged
    csvo = svo.buffer_dtype == np.uint8
    fmt = "csvo" if csvo else "esvo"
    dev = svo.device_buf.device
    B = W * H
    svo.set_heightfield(hf)
    levels = adaptive.frame_levels(W, H, False)
    out = {"levels": levels}

    def buffers():
        return svo._workspace.adaptive(W, H, levels, aj.REC_WORDS)

    with Phase(f"judged pitched-up pose ({fmt})"):
        sky, deg, sky_hits = sky_pose(svo, poses[0])
    poses6 = list(poses) + [sky]
    log(f"judged ({fmt}): pose 5 = pose 0 pitched up {deg} degrees, "
        f"{sky_hits} hit pixels ({sky_hits / B:.4f})")

    with Phase(f"judged main path ({fmt})"):
        zero_judged_counts()
        frames, infos, marks = [], [], []
        with Held(("k9j_trace", "k9j_merge", "k9j_finalize",
                   "k9_shadow_cells") + SHADOW_HELD + BEAM_HELD) as held:
            for p in poses6:
                frames.append(svo.render(p, W, H))
                infos.append(dict(svo.last_frame))
                marks.append((svo._workspace.hcount.clone(),
                               buffers().dense.clone()))
        torch.cuda.synchronize()
        n = out["launches"] = judged_counts()
        out["held"] = held.check()
    log(f"k9j trace, k9j merge, k9j finalize, k9 shadow cells, kd_shadow "
        f"(judged rays), kd_finish, k7_shadow, k7_tiles and k8 vs their "
        f"plain versions on every call of the {len(poses6)} judged frames "
        f"({fmt}; bit for bit): {json.dumps(out['held'])}")
    if not held_ok(out["held"]):
        fail(f"K9-judged's trace, merge or finalize, K9's shadow cells, "
             f"kd_shadow, kd_finish, K7's shadow or tile floors or K8 "
             f"disagree with their plain versions in the {fmt} judged "
             "frames")
    branches = [dict(hits=int(h), dense=bool(int(d)),
                     dense_rule=adaptive.dense_frame(int(h), B))
                for h, d in marks]
    out["branches"] = branches
    log(f"judged main path launches ({fmt}, {len(poses6)} poses): "
        f"{json.dumps(n)}; last frame {json.dumps(infos[-1])}")
    log(f"judged shadow branch per pose ({fmt}): " + ", ".join(
        f"pose {i}: {b['hits']} hits, "
        f"{'two-pass cells' if b['dense'] else 'single pass'}"
        for i, b in enumerate(branches)))
    if not all(n[f"k9j_{k}"] for k in K9J) or not (
            n["k6"] and n["k8_verdicts"] and n["k9_shadow_cells"]
            and n["kd_shade"] and n["kd_shadow"] and n["kd_finish"]) \
            or n["kd_primary"] or n["k9_trace"] or n["k9_merge"] \
            or n["k9_finalize"]:
        fail(f"the {fmt} judged adaptive path launched another set of "
             "kernels")
    if not all(i.get("adaptive") and i.get("hierarchy") == levels - 1
               and i.get("opaque") is False and i.get("beams")
               and i.get("sun") for i in infos):
        fail(f"the {fmt} translucent frame did not take the judged adaptive "
             "frame with beams and the sun map")
    if any(b["dense"] != b["dense_rule"] for b in branches) \
            or branches[-1]["dense"] or not branches[0]["dense"]:
        fail(f"the {fmt} judged frame took the wrong shadow branch")
    for img in frames:
        if tuple(img.shape) != (H, W, 4) or not bool(torch.isfinite(img).all()):
            fail(f"{fmt} judged frame has the wrong shape or non-finite "
                 "values")

    with Phase(f"judged vs plain and vs exact ({fmt})"):
        err, stats, cert, exact_vs_k3 = 0.0, [], [], 0.0
        # the exact judged frames' primary stage, tile floors and K8's lit
        # floors, held on every call
        pheld = Held(("kd_primary",) + BEAM_HELD)
        for i, p in enumerate(poses6):
            fused = svo.render(p, W, H, mode="fused")
            with pheld:
                exact = svo.render(p, W, H, adaptive=False)
            # the exact judged frame is K3's, so the budget against K3
            # (thick_ray) is the budget against the exact frame
            exact_vs_k3 = max(exact_vs_k3, max_abs(exact, fused))
            ctx = svo.beam_context(p, W, H)
            img = svo.render(p, W, H, beams=ctx)
            ref = []
            ms = event_ms(lambda: ref.append(plain_judged(svo, p, ctx)))
            if i == 0:
                out["plain_ms"] = ms
            err = max(err, max_abs(img, ref[0]))
            stats.append(thick_ray(img, fused, exact, levels))
            # certificates against floored judged traces: the frame with
            # the beams only differs only where a certificate disagrees;
            # of those pixels, the ones where either frame is the exact
            # frame's (a shadow origin of a correct pixel)
            floored = svo.render(p, W, H, beams=ctx.without_sun())
            diff = (img != floored).any(-1)
            right = ~(img != exact).any(-1) | ~(floored != exact).any(-1)
            cert.append(dict(pixels=int(diff.sum()),
                             on_exact_pixels=int((diff & right).sum())))
        # one pose with the hole fill (VOXELRS_HOLE_FILL=1), K9-judged's
        # trace held on its every call
        os.environ["VOXELRS_HOLE_FILL"] = "1"
        try:
            ctx = svo.beam_context(poses[0], W, H)
            with Held(("k9j_trace", "k9j_merge",
                       "k9j_finalize")) as fill_held:
                fill = svo.render(poses[0], W, H, beams=ctx)
            fill_held = fill_held.check()
            out["held"] = held_merge(out["held"], fill_held)
            fill_ref = plain_judged(svo, poses[0], ctx, hole_fill=True)
            fused = svo.render(poses[0], W, H, mode="fused")
            with pheld:
                exact = svo.render(poses[0], W, H, adaptive=False)
        finally:
            del os.environ["VOXELRS_HOLE_FILL"]
        out["held"] = held_merge(out["held"], pheld.check())
        fill_err = max_abs(fill, fill_ref)
        fill_stats = thick_ray(fill, fused, exact, levels)
        fill_changed = int((fill != frames[0]).any(-1).sum())
    out["vs_plain"] = max(err, fill_err)
    out["held_hole_fill"] = fill_held
    out["vs_plain_ok"] = out["vs_plain"] <= K3_MAX_ABS and all(
        out["held"][k]["equal"] and out["held"][k]["calls"]
        for k in ("k9j_trace", "k9j_merge", "k9j_finalize", "kd_primary")
        + BEAM_HELD) and fill_held["k9j_merge"]["calls"] == levels
    out["vs_exact"], out["vs_exact_hole_fill"] = stats, fill_stats
    out["exact_vs_k3"] = exact_vs_k3
    out["vs_exact_ok"] = exact_vs_k3 <= K3_MAX_ABS and all(
        thick_ray_ok(st) for st in stats + [fill_stats])
    out["certificates_vs_traces"] = cert
    log(f"judged vs its plain version ({fmt}, {len(poses6)} poses and pose "
        f"0 with the hole fill): max |d| {err:.3g} / {fill_err:.3g} "
        f"(tolerance {K3_MAX_ABS:g}); k9j trace, merge and finalize held on "
        f"every call of the {len(poses6) + 1} frames "
        f"{json.dumps(out['held']['k9j_trace'])}, "
        f"{json.dumps(out['held']['k9j_merge'])}, "
        f"{json.dumps(out['held']['k9j_finalize'])} (with the hole fill: "
        f"{json.dumps(fill_held)}); kd_primary held on every call of the "
        f"{len(poses6) + 1} exact judged frames "
        f"{json.dumps(out['held']['kd_primary'])}; "
        f"ok {out['vs_plain_ok']}; plain frame (pose 0) "
        f"{out['plain_ms']:.1f} ms")
    log(f"judged vs the exact judged frame ({fmt}; the traced grid's pixels "
        f"equal to the exact frame's and within {K3_MAX_ABS:g} of K3's, "
        f"mean |d| < 0.002, under 2% of pixels off by 1e-3; the exact "
        f"judged frame within {exact_vs_k3:.3g} of K3's): "
        f"{json.dumps(stats)}; with the hole fill (pose 0, "
        f"{fill_changed} pixels changed) {json.dumps(fill_stats)}; ok "
        f"{out['vs_exact_ok']}")
    log(f"judged shadow rays, the sun map's certificates against the "
        f"floored judged traces ({fmt}; pixels differing per pose, and of "
        f"them those where a frame equals the exact frame): "
        f"{json.dumps(cert)}")
    if not out["vs_plain_ok"]:
        fail(f"the {fmt} judged frame disagrees with its plain version")
    if not out["vs_exact_ok"]:
        fail(f"the {fmt} judged frame is outside the thick-ray budget")

    with Phase(f"k9j vs plain, alone ({fmt})"):
        p0 = poses[0]
        ctx = svo.beam_context(p0, W, H)
        spies = {k: Spy(aj, f"k9j_{k}") for k in K9J}
        for sp in spies.values():
            sp.__enter__()
        try:
            svo.render(p0, W, H, beams=ctx)
        finally:
            for sp in spies.values():
                sp.__exit__()
        torch.cuda.synchronize()
        ncalls = {k: len(sp.calls) for k, sp in spies.items()}
        if ncalls != dict(trace=levels + 1, merge=levels, finalize=1):
            fail(f"the {fmt} judged frame ran K9-judged another way: "
                 f"{ncalls}")
        # the profiler's call: the pixels' refine list (its count on the
        # card, its size the grid's lanes)
        out["launch_args"] = {"k9j_trace": spies["trace"].calls[-1],
                              "k9j_finalize": spies["finalize"].calls[0]}
        res = {k: dict(equal=True, err=0.0, ms=0.0, plain_ms=0.0, calls=[])
               for k in K9J}

        def note(k, equal, err, ms, plain_ms, **info):
            r = res[k]
            r["equal"] &= bool(equal)
            r["err"] = max(r["err"], err)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["calls"].append(dict(equal=bool(equal), ms=ms, **info))

        # trace: every call, and each against K1 / K4 judged on the same
        # pixel rays from the same floors (the world counted once a frame)
        vs_k1 = dict.fromkeys(("t", "value", "face_id", "pos", "uv", "lod",
                               "inside_voxel"), 0)
        trace_steps = trace_lanes = 0
        trace_bytes = svo.device_buf.numel() * 4
        for args, kw in spies["trace"].calls:
            world, scale, tables, fp, tf, level, rec0 = args
            idx, cnt = kw.get("idx"), kw.get("count")
            outs = [rec0.clone() for _ in range(3)]
            aj.k9j_trace(world, scale, tables, fp, tf, level, outs[0], idx,
                         cnt)
            pms = event_ms(lambda: aj.k9j_trace_plain(
                world, scale, tables, fp, tf, level, outs[1], idx, cnt))
            kms = kernel_ms(lambda: _build.launch_k9j_trace(
                world, scale, tables, fp, tf, level, outs[2], idx, cnt))
            # a refine list's launch at a count of 0 (its fixed cost), and
            # the parent's kernel on the same inputs, held to the plain
            # records
            zero = None if cnt is None else torch.zeros_like(cnt)
            ms0 = None if zero is None else kernel_ms(
                lambda: _build.launch_k9j_trace(world, scale, tables, fp, tf,
                                                level, outs[2], idx, zero))
            par = None
            if PARENT is not None:
                po = rec0.clone()
                PARENT.launch_k9j_trace(world, scale, tables, fp, tf, level,
                                        po, idx, cnt)
                par = dict(equal=bool(torch.equal(po, outs[1])),
                           ms=kernel_ms(lambda: PARENT.launch_k9j_trace(
                               world, scale, tables, fp, tf, level, po, idx,
                               cnt)))
                if zero is not None:
                    par["ms_count0"] = kernel_ms(
                        lambda: PARENT.launch_k9j_trace(
                            world, scale, tables, fp, tf, level, po, idx,
                            zero))
            lanes = (torch.arange(rec0.shape[0], device=dev) if idx is None
                     else idx[: int(cnt)].long())
            ids = adaptive.grid_pixel_ids(W, H, level, dev)[lanes]
            ro, rd = adaptive._frame_rays(fp, ids)
            fl = beams.pixel_floors_at(tf, ids, W)
            if csvo:
                k1 = traversal_csvo.intersect_octree_csvo(
                    world.words, scale, world.root_ptr, world.total_depth,
                    ro, rd, -1.0, True, tables.alpha_fn, t_floor=fl)
            else:
                k1 = traversal.intersect_octree(world, scale, ro, rd, -1.0,
                                                True, tables.alpha_fn,
                                                t_floor=fl)
            r = outs[0][lanes]
            rf = r.view(torch.float32)
            fields = (rf[:, 0], r[:, 1].long() & 0xFFFFFFFF, r[:, 2],
                      rf[:, 3:6], rf[:, 6:8], rf[:, 8], r[:, 9] != 0)
            for f, a, b in zip(vs_k1, fields, (k1.t, k1.value, k1.face_id,
                                               k1.pos, k1.uv, k1.lod,
                                               k1.inside_voxel)):
                neq = a != b
                vs_k1[f] += int((neq.any(-1) if neq.dim() > 1 else neq).sum())
            steps = int(k1.steps.sum())
            trace_steps += steps
            trace_lanes += lanes.shape[0]
            trace_bytes += (lanes.shape[0] * aj.REC_WORDS * 4
                            + tf.numel() * 4
                            + (0 if idx is None else lanes.shape[0] * 4 + 4))
            wl, hl = adaptive.grid_dims(W, H, level)[level]
            note("trace", torch.equal(outs[0], outs[1])
                 and (par is None or par["equal"]),
                 max_abs(outs[0], outs[1]), kms, pms, level=level,
                 lanes=lanes.shape[0], steps=steps, ms_count0=ms0,
                 parent=par, grid=idx is None,
                 launch=trace_launch_stats(k1.steps, lanes, idx, wl, hl))
        out["trace_vs_k1"] = dict(lanes=trace_lanes, differing=vs_k1,
                                  steps=trace_steps)
        out["trace_bound"] = bound(trace_bytes, trace_steps * OPS_PER_STEP
                                   + trace_lanes * OPS_K9_RAY)
        out["traced_share"] = trace_lanes / B
        # merge: each level, as the frame ran it (hole fill off)
        shares = {}
        merge_bytes = merge_ops = 0
        for args, _kw in spies["merge"].calls:
            scale, tables, fp, level, lo, hi0, ref0, fill = args
            ko, kr = hi0.clone(), ref0.clone()
            aj.k9j_merge(scale, tables, fp, level, lo, ko, kr, fill)
            po, pr = hi0.clone(), ref0.clone()
            pms = event_ms(lambda: aj.k9j_merge_plain(
                scale, tables, fp, level, lo, po, pr, fill))
            to, tr = hi0.clone(), ref0.clone()
            kms = kernel_ms(lambda: _build.launch_k9j_merge(
                scale, tables, fp, level, fill, lo, to, tr))
            # with --parent, the parent's kernel on the same inputs, held
            # to the plain outputs
            par = None
            if PARENT is not None:
                qo, qr = hi0.clone(), ref0.clone()
                PARENT.launch_k9j_merge(scale, tables, fp, level, fill, lo,
                                        qo, qr)
                par = dict(equal=bool(torch.equal(qo, po)
                                      and torch.equal(qr, pr)),
                           ms=kernel_ms(lambda: PARENT.launch_k9j_merge(
                               scale, tables, fp, level, fill, lo, qo, qr)))
            wl, hl = adaptive.grid_dims(W, H, level)[level]
            g = adaptive.coarse_grid(wl, hl, dev)
            sample = g.sample_masks()[0]
            hit = ko.view(torch.float32)[:, 0] != -1.0
            h4 = g.up4(lo.view(torch.float32)[:, 0] != -1.0)
            all4 = h4[0] & h4[1] & h4[2] & h4[3] & ~sample
            nl = ko.shape[0]
            shares[level] = dict(
                lanes=nl, samples=float(sample.double().mean()),
                filled=int((hit & ~sample & ~kr).sum()) / nl,
                refined=int(kr.sum()) / nl)
            merge_bytes += lo.shape[0] * aj.REC_WORDS * 4 + nl * (
                aj.REC_WORDS * 4 + 1)
            merge_ops += int(all4.sum()) * (OPS_K9_RAY + OPS_K9J_FILL)
            note("merge", torch.equal(ko, po) and torch.equal(kr, pr)
                 and (par is None or par["equal"]),
                 max(max_abs(ko, po), max_abs(kr, pr)), kms, pms,
                 level=level, parent=par)
        out["merge_bound"] = bound(merge_bytes, merge_ops)
        shares[levels] = dict(lanes=spies["trace"].calls[0][0][6].shape[0],
                              samples=1.0, filled=0.0, refined=0.0)
        out["shares_pose0"] = shares
        # finalize
        (fp, frec, rec0, hit0, img0, np0, bp0), _kw = \
            spies["finalize"].calls[0]
        ko = [t.clone() for t in (rec0, hit0, img0, np0, bp0)]
        aj.k9j_finalize(fp, frec, *ko)
        po = [t.clone() for t in (rec0, hit0, img0, np0, bp0)]
        pms = event_ms(lambda: aj.k9j_finalize_plain(fp, frec, *po))
        to = [t.clone() for t in (rec0, hit0, img0, np0, bp0)]
        kms = kernel_ms(lambda: _build.launch_k9j_finalize(fp, frec, *to))
        hits = int(ko[1].sum())
        img_err = max_abs(ko[2], po[2])
        # with --parent, the parent's kernel on the same inputs, held to
        # the plain outputs
        par = parent_launch("k9j_finalize", (fp, frec, rec0, hit0, img0, np0,
                                             bp0), {}, po)
        note("finalize", all(bits_equal(a, b) for i, (a, b) in
                             enumerate(zip(ko, po)) if i != 2)
             and img_err <= K3_MAX_ABS and (par is None or par["equal"]),
             img_err, kms, pms, hits=hits, parent=par)
        out["finalize_bound"] = bound(
            B * 36 * 2 + B + (B - hits) * 16 + 2 * B,
            (B - hits) * (OPS_K9_RAY + OPS_SKY))
    out["k9j"] = res
    out["k9j_ok"] = all(r["equal"] for r in res.values()) and not any(
        out["trace_vs_k1"]["differing"].values())
    log(f"k9j trace vs {'k4' if csvo else 'k1'} judged ({fmt}, pose 0's "
        f"{levels + 1} traces; {out['trace_vs_k1']['lanes']} lanes from the "
        f"tile floors, {out['traced_share']:.4f} of the pixels): rays "
        f"differing {json.dumps(out['trace_vs_k1']['differing'])}; "
        f"{out['trace_vs_k1']['steps']} steps")
    for k in K9J:
        r = res[k]
        bd = out[f"{k}_bound"]
        log(f"k9j_{k} vs plain ({fmt}, pose 0's own inputs, "
            f"{len(r['calls'])} launches a frame): equal {r['equal']} (max "
            f"|d| {r['err']:.3g}); alone {r['ms']:.4f} ms a frame "
            f"({json.dumps([round(c['ms'], 4) for c in r['calls']])}), "
            f"plain {r['plain_ms']:.2f} ms, bound {bd[0]:.4g} ms ({bd[1]}) "
            f"on {card}")
    for c in res["merge"]["calls"]:
        log(f"k9j merge launch ({fmt}, pose 0, level {c['level']}): alone "
            f"{c['ms']:.4f} ms"
            + ("" if c["parent"] is None
               else f"; the parent's {json.dumps(c['parent'])}")
            + f" on {card}")
    fin = res["finalize"]["calls"][0]
    log(f"k9j finalize launch ({fmt}, pose 0, {fin['hits']} hit pixels): "
        f"alone {fin['ms']:.4f} ms"
        + ("" if fin["parent"] is None
           else f"; the parent's {json.dumps(fin['parent'])}") + f" on {card}")
    for c in res["trace"]["calls"]:
        log(f"k9j trace launch ({fmt}, pose 0, level {c['level']}, "
            f"{'the whole grid' if c['grid'] else 'a refine list'}): "
            f"{c['lanes']} lanes, alone {c['ms']:.4f} ms"
            + ("" if c["ms_count0"] is None
               else f", at count 0 {c['ms_count0']:.4f} ms")
            + ("" if c["parent"] is None else
               f"; the parent's {json.dumps(c['parent'])}")
            + f"; steps and warps (K1 / K4 on the same rays; warps of 32 "
            f"items, and of 4x8 tiles on the whole grid) "
            f"{json.dumps(c['launch'])} on {card}")
    log(f"judged grids ({fmt}, pose 0; per level: lanes, sample share, "
        f"filled share, refined = re-traced share): {json.dumps(shares)}")
    if not out["k9j_ok"]:
        fail(f"a K9-judged kernel disagrees with its plain version or K1 "
             f"({fmt})")

    with Phase(f"judged timing ({fmt})"):
        for p in poses:  # warm-up
            svo.render(p, W, H)
            svo.render(p, W, H, adaptive=False)
            svo.render(p, W, H, mode="fused")
        times = {}
        for path, kw in (("judged", {}), ("exact", dict(adaptive=False)),
                         ("fused", dict(mode="fused"))):
            ms = sorted(cuda_ms(lambda: svo.render(p, W, H, **kw), REPS)
                        for p in poses)
            times[path] = dict(median=ms[len(ms) // 2], poses=ms)
        out["host_us"] = host_us(lambda: svo.render(poses[0], W, H))
        torch.cuda.synchronize()
        rc = buffers().rcounts.tolist()
    out["times"] = times
    out["frame_ms"] = times["judged"]["median"]
    dims = adaptive.grid_dims(W, H, levels)
    out["refined_after_window"] = {
        k: dict(lanes=dims[k][0] * dims[k][1], refined=rc[k],
                share=rc[k] / (dims[k][0] * dims[k][1]))
        for k in range(levels)}
    log(f"judged frame {W}x{H} ({fmt}; Svo.render default on the "
        f"translucent scene, beams and sun map; events from call to "
        f"finished frame, median over the 5 bench poses): judged adaptive "
        f"{times['judged']['median']:.3f} ms, exact judged "
        f"{times['exact']['median']:.3f} ms, fused (K3) "
        f"{times['fused']['median']:.3f} ms in the same run; per-pose "
        + json.dumps({k: [round(x, 3) for x in v['poses']]
                      for k, v in times.items()})
        + f"; host time of the judged call {out['host_us']:.1f} us; "
        f"refined lanes of the last timed frame (pose 0) "
        f"{json.dumps(out['refined_after_window'])}; on {card}")
    return out


def workspace_mb(ws) -> float:
    """Megabytes of the tensors of a ``DeferredWorkspace`` and its adaptive
    buffers."""
    import torch

    def tensors(o):
        for v in vars(o).values():
            if isinstance(v, torch.Tensor):
                yield v
            elif isinstance(v, list):
                yield from (t for t in v if isinstance(t, torch.Tensor))

    total = sum(t.numel() * t.element_size() for t in tensors(ws))
    if ws._adaptive is not None:
        total += sum(t.numel() * t.element_size()
                     for t in tensors(ws._adaptive))
    return total / 1e6


def two_in_flight_ms(calls) -> float:
    """Mean milliseconds a call of ``calls`` (functions called in turn),
    issued with two in flight: the next is issued before the last is
    waited for (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ends = []
    start.record()
    for i, fn in enumerate(calls):
        fn()
        e = torch.cuda.Event()
        e.record()
        ends.append(e)
        if i >= 1:
            ends[i - 1].synchronize()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(calls)


def batch_trace_steps(svo, fp, cams, tf, level, lanes):
    """Traversal steps of each lane of a batched K9 trace (pose-major, in
    the order of ``lanes``), from K1 on the same pixel rays from the same
    floors, pose by pose."""
    import torch

    from voxelrs_tpu_torch.ops import adaptive, beams, shading, traversal

    dev = lanes.device
    w, h = adaptive.grid_dims(W, H, level)[level]
    n = w * h
    steps = []
    for q in range(cams.shape[0]):
        mine = lanes[(lanes >= q * n) & (lanes < (q + 1) * n)] - q * n
        if mine.numel() == 0:
            continue
        ids = adaptive.grid_pixel_ids(W, H, level, dev)[mine]
        ro, rd = adaptive._frame_rays(shading.pose_params(fp, cams, q), ids)
        k1 = traversal.intersect_octree(svo.world(), float(svo.octree_scale),
                                        ro, rd, -1.0, False,
                                        t_floor=beams.pixel_floors_at(
                                            tf[q], ids, W))
        steps.append(k1.steps)
    return torch.cat(steps) if steps else torch.zeros(0, device=dev)


def batch_phase(svo, csvo, tsvo, hf, poses, card) -> dict:
    """K10: ``Svo.render_batch`` (ESVO, the 5 bench poses at 1920x1080 with
    shadows, the envelope and pose 0's sun map shared): counts from 0 over
    one batch and one frame on the adaptive branch (the 1080p default) and
    on the exact one (``VOXELRS_ADAPTIVE=0``), equal apart from the
    per-pose tile floors; each pose's image against ``Svo.render`` of that
    pose given the shared sun map (max |d| 0) on both branches, the exact
    one against K3's; the batched K9 and K6 launches against their plain
    versions on the batch's own inputs (every pose) and the batched stages
    through the plain frames of poses 0 and 3; the CSVO and translucent
    renderers' None; the batch, sequential and two-in-flight frames and the
    host time of a batch call in one run, and the workspace's megabytes."""
    import numpy as np
    import torch

    from voxelrs_tpu_torch import _build
    from voxelrs_tpu_torch.ops import (adaptive, beams, compact, shading,
                                       traversal)

    dev = svo.device_buf.device
    N, B = len(poses), W * H
    svo.set_heightfield(hf)
    out = {}
    sun0 = svo.beam_context(poses[0], W, H)._sun
    if sun0 is None:
        fail("the bench scene has no sun map for the batch")

    def singles(**kw):
        return [svo.render(p, W, H, beams=svo.beam_context(
            p, W, H, shared_sun=sun0), **kw) for p in poses]

    def counted(fn):
        zero_deferred_counts()
        r = fn()
        torch.cuda.synchronize()
        return r, deferred_counts()

    levels = adaptive.adaptive_levels(W, H)
    with Phase("batch main path (esvo)"):
        svo.render_batch(poses, W, H)  # warm-up: workspace, tables
        held = Held(("k9_shadow_cells",) + SHADOW_HELD + BEAM_HELD)
        with held:
            imgs, nb = counted(lambda: svo.render_batch(poses, W, H))
        info = dict(svo.last_frame)
        ab = svo._batch_workspace._adaptive
        dense, hstart = ab.dense.tolist(), ab.hstart.tolist()
        hits_total = int(svo._batch_workspace.hcount)
        _, n1 = counted(lambda: svo.render(poses[0], W, H))
        os.environ["VOXELRS_ADAPTIVE"] = "0"
        pheld = Held(("kd_primary",))  # the exact branch's primary stage
        try:
            svo.render_batch(poses, W, H)
            with held, pheld:
                imgs_e, nbe = counted(lambda: svo.render_batch(poses, W, H))
            hits_total_e = int(svo._batch_workspace.hcount)
            with pheld:
                _, n1e = counted(lambda: svo.render(poses[0], W, H))
        finally:
            del os.environ["VOXELRS_ADAPTIVE"]
        out["workspace_mb"] = workspace_mb(svo._batch_workspace)
    with Phase("batch stages vs plain, every call (esvo)"):
        out["held"] = held_merge(held.check(), pheld.check())
    log(f"k9 shadow cells, kd_primary, kd_shadow, kd_finish, k7_shadow, "
        f"k7_tiles and k8 vs their plain versions on every call of the "
        f"adaptive and the exact batch and of the exact frame of pose 0 "
        f"(esvo, {N} poses, pose 0's sun map; bit for bit, kd_primary's sky "
        f"within {K3_MAX_ABS:g}): {json.dumps(out['held'])}")
    if not held_ok(out["held"]):
        fail("K9's shadow cells, kd_primary, kd_shadow, kd_finish, K7's "
             "shadow or tile floors or K8 disagree with their plain versions "
             "in the batch")
    hits = [(hstart + [hits_total])[q + 1] - hstart[q] for q in range(N)]
    out["launches"], out["launches_exact"] = nb, nbe
    out["launches_frame"], out["launches_frame_exact"] = n1, n1e
    out["branches"] = [dict(hits=h, dense=bool(d),
                            dense_rule=adaptive.dense_frame(h, B))
                       for h, d in zip(hits, dense)]
    log(f"batch main path (esvo, {N} poses, adaptive): launches "
        f"{json.dumps(nb)}; one frame {json.dumps(n1)}; exact branch "
        f"(VOXELRS_ADAPTIVE=0): batch {json.dumps(nbe)}, one frame "
        f"{json.dumps(n1e)}; {json.dumps(info)}; per-pose hits and dense "
        f"flags {json.dumps(out['branches'])}; workspace "
        f"{out['workspace_mb']:.1f} MB ({out['workspace_mb'] / N:.1f} MB a "
        f"pose)")
    for a, b, name in ((nb, n1, "adaptive"), (nbe, n1e, "exact")):
        if any(a[k] != b[k] for k in a if not k.startswith("k7")) \
                or a["k7_shadow"] != b["k7_shadow"] \
                or (a["k7_tile"], b["k7_tile"]) != (N, 1):
            fail(f"the {name} batch made other launches than one frame "
                 "(apart from its per-pose tile floors)")
    if not all(nb[f"k9_{k}"] for k in K9) or not (
            nb["k6"] and nb["k8"] and nb["kd_shade"] and nb["kd_shadow"]
            and nb["kd_finish"]) or nb["kd_primary"] or not (
            nbe["kd_primary"] and nbe["kd_shade"] and nbe["kd_shadow"]
            and nbe["kd_finish"]) or any(nbe[f"k9_{k}"] for k in K9):
        fail("the batch launched another set of kernels")
    if info.get("mode") != "batch" or not (info.get("adaptive")
                                           and info.get("sun")) \
            or info.get("hierarchy") != levels - 1:
        fail("the batch did not take the adaptive branch with the sun map")
    if any(b["dense"] != b["dense_rule"] for b in out["branches"]):
        fail("a pose of the batch took the wrong shadow branch")
    for im in (imgs, imgs_e):
        if tuple(im.shape) != (N, H, W, 4) or not bool(
                torch.isfinite(im).all()):
            fail("the batch has the wrong shape or non-finite values")

    with Phase("batch vs single frames and k3 (esvo)"):
        vs_single = [max_abs(imgs[q], s) for q, s in enumerate(singles())]
        os.environ["VOXELRS_ADAPTIVE"] = "0"
        try:
            vs_single_e = [max_abs(imgs_e[q], s)
                           for q, s in enumerate(singles())]
        finally:
            del os.environ["VOXELRS_ADAPTIVE"]
        vs_k3 = [max_abs(imgs_e[q], svo.render(p, W, H, mode="fused"))
                 for q, p in enumerate(poses)]
        none = dict(csvo=csvo.render_batch(poses, W, H) is None,
                    translucent=tsvo.render_batch(poses, W, H) is None)
    out["vs_single"], out["vs_single_exact"], out["vs_k3"] = (
        vs_single, vs_single_e, vs_k3)
    out["none"] = none
    log(f"batch vs Svo.render of each pose given pose 0's sun map (esvo; "
        f"max |d|, must be 0): adaptive {vs_single}, exact {vs_single_e}; "
        f"the exact batch vs K3's frames: {vs_k3} (tolerance "
        f"{K3_MAX_ABS:g}); None for the CSVO and translucent renderers: "
        f"{json.dumps(none)}")
    if any(vs_single) or any(vs_single_e):
        fail("a pose of the batch differs from its own frame")
    if not all(v <= K3_MAX_ABS for v in vs_k3):
        fail("the exact batch disagrees with K3's frames")
    if not all(none.values()):
        fail("render_batch did not return None where the JAX package does")

    with Phase("k10 kernels vs plain, alone (esvo)"):
        names = [f"k9_{k}" for k in K9]
        spies = {k: Spy(adaptive, k) for k in names}
        spies["k6"] = Spy(compact, "compact_indices")
        spies.update({f"kd_{s}": Spy(_build, f"launch_kd_{s}")
                      for s in STAGES if s != "primary"})
        for sp in spies.values():
            sp.__enter__()
        try:
            svo.render_batch(poses, W, H)
        finally:
            for sp in spies.values():
                sp.__exit__()
        os.environ["VOXELRS_ADAPTIVE"] = "0"
        try:
            with Spy(_build, "launch_kd_primary") as prim:
                svo.render_batch(poses, W, H)
        finally:
            del os.environ["VOXELRS_ADAPTIVE"]
        spies["kd_primary"] = prim
        torch.cuda.synchronize()
        res = {}
        runs = {name: [] for name in names if name in LAUNCH_OUTS}  # alone
        for name in names:
            r = res[name] = dict(equal=True, err=0.0, ms=0.0, plain_ms=0.0,
                                 calls=len(spies[name].calls))
            for args, kw in spies[name].calls:
                kargs = [a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args]
                pargs = [a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args]
                targs = [a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args]
                spies[name].fn(*kargs, **kw)
                plain = getattr(adaptive, f"{name}_plain")
                pms = event_ms(lambda: plain(*pargs, **kw))
                launch = getattr(_build, f"launch_{name}")
                kms = kernel_ms(lambda: launch(*targs, **kw))
                pairs = [(a, b) for a, b in zip(kargs, pargs)
                         if isinstance(a, torch.Tensor)]
                errs = [max_abs(a, b) for a, b in pairs]
                # the finalize's sky: within 1e-6 (acosf); all else equal
                eq = all(bits_equal(a, b) or (name == "k9_finalize"
                                              and a.dtype == torch.float32
                                              and e <= K3_MAX_ABS)
                         for (a, b), e in zip(pairs, errs))
                if name in LAUNCH_OUTS:
                    parent = parent_launch(
                        name, args, kw, [pargs[i] for i in LAUNCH_OUTS[name]])
                    runs[name].append(dict(
                        ms=kms, parent=parent,
                        **({"k9_finalize": {},
                            "k9_shadow_cells": dict(step=args[0]),
                            "k9_trace": dict(level=args[4])}.get(
                                name, dict(level=args[2])))))
                    eq &= parent is None or parent["equal"]
                r["equal"] &= eq
                r["err"] = max(r["err"], *errs)
                r["ms"] += kms
                r["plain_ms"] += pms
        trace_runs = runs["k9_trace"]
        k6_rows = k6_calls(spies["k6"].calls, dev)
        sm = k6_summary(k6_rows)
        res["k6"] = dict(equal=sm["equal"], err=sm["err"], ms=sm["ms"],
                         plain_ms=sm["plain_ms"], calls=sm["calls"],
                         parent_ms=sm["parent_ms"])
        out["k6_calls"] = k6_rows
        # the stages alone (spied launch arguments replayed); the shadow
        # stage's launches also at count 0 and through the parent's kernel
        for s in STAGES:
            sp = spies[f"kd_{s}"]
            res[f"kd_{s}"] = dict(calls=len(sp.calls), ms=sum(
                kernel_ms(lambda a=a, k=k: sp.fn(*a, **k))
                for a, k in sp.calls))
        runs["kd_shadow"] = []
        for args, kw in spies["kd_shadow"].calls:
            tr = args[11].clone()
            shading.kd_shadow_plain(*args[:11], tr)
            count_pos = 7 if args[8] is None else 9
            idle = zero_count(args, count_pos)
            runs["kd_shadow"].append(dict(
                ms=kernel_ms(lambda: _build.launch_kd_shadow(*args, **kw)),
                ms_count0=kernel_ms(lambda: _build.launch_kd_shadow(*idle,
                                                                    **kw)),
                parent=parent_launch("kd_shadow", args, kw, [tr],
                                     count_pos)))
        runs["kd_finish"] = [launch_call("kd_finish", a, kw)
                             for a, kw in spies["kd_finish"].calls]
        runs["kd_primary"] = [launch_call("kd_primary", a, kw)
                              for a, kw in spies["kd_primary"].calls]
        # the stages' plain version: the plain frames of poses 0 and 3
        kws = [svo.frame_kwargs(p, W, H) for p in poses]
        tf = torch.stack([svo.beam_context(p, W, H).tile_floors
                          for p in poses])
        ctx0 = svo.beam_context(poses[0], W, H)
        pick = (0, 3)

        def plain_frames(lv):
            k0 = kws[0]
            return shading.render_frames_opaque_batch_plain(
                svo.world(), svo.octree_scale, svo.mips, svo.mat_params,
                svo.mat_tex, tuple(np.stack([kws[q][k] for q in pick]) for k
                                   in ("cam_pos", "cam_right", "cam_up",
                                       "cam_fwd")),
                k0["fov_y_rad"], k0["aspect"], k0["ambient"],
                k0["light_dir"], k0["shadow_distance"],
                np.full(3, np.nan, np.float32), width=W, height=H,
                render_shadows=True, beams_shared=ctx0,
                t_floor_stack=tf[list(pick)].contiguous(), levels=lv)

        box = []
        stage_plain_ms = event_ms(lambda: box.append(plain_frames(levels)))
        stage_err = max(max_abs(imgs[q], box[0][i])
                        for i, q in enumerate(pick))
        ex = plain_frames(0)
        stage_err = max(stage_err, *(max_abs(imgs_e[q], ex[i])
                                     for i, q in enumerate(pick)))
        # bounds, from this run's inputs
        world_bytes = svo.device_buf.numel() * 4
        ntiles = -(-W // 8) * -(-H // 8)
        tr_bytes, tr_ops = world_bytes, 0
        for i, (args, kw) in enumerate(spies["k9_trace"].calls):
            _w, _s, fp, tfl, level, rec0 = args
            idx, cnt, cams = kw.get("idx"), kw.get("count"), kw["cams"]
            lanes = (torch.arange(rec0.shape[0], device=dev) if idx is None
                     else idx[: int(cnt)].long())
            steps = batch_trace_steps(svo, fp, cams, tfl, level, lanes)
            wl, hl = adaptive.grid_dims(W, H, level)[level]
            trace_runs[i]["launch"] = trace_launch_stats(steps, lanes, idx,
                                                           wl, hl)
            tr_ops += (int(steps.sum()) * OPS_PER_STEP
                       + lanes.shape[0] * OPS_K9_RAY)
            tr_bytes += (lanes.shape[0] * 32 + N * ntiles * 4
                         + (0 if idx is None else lanes.shape[0] * 4 + 4))
        mg_bytes = mg_ops = 0
        for args, _kw in spies["k9_merge"].calls:
            _s, _fp, level, lo, hi0, _r = args
            wl, hl = adaptive.grid_dims(W, H, level)[level]
            g = adaptive.coarse_grid(wl, hl, dev)
            sample = g.sample_masks()[0]
            nlo = lo.shape[0] // N
            for q in range(N):
                h4 = g.up4((lo[q * nlo:(q + 1) * nlo, 6] & 1) != 0)
                mg_ops += int((h4[0] & h4[1] & h4[2] & h4[3]
                               & ~sample).sum()) * (OPS_K9_RAY + OPS_K9_FILL)
            mg_bytes += lo.shape[0] * 32 + hi0.shape[0] * 33
        fin_hits = hits_total
        cells_bytes = 0
        for args, _kw in spies["k9_shadow_cells"].calls:
            nh = int(args[3])
            cells_bytes += nh * (4 + 1 + 1 + 1) + (nh * 8 if args[0] == 2
                                                   else 4 * N)
        # each mask read once, every slot of its padded output, its count
        # and starts written once (as one frame's K6 is counted)
        k6_bytes = sum(int(a[0].shape[0]) + int(a[1]) * 4 + 4
                       + (4 * N if k.get("starts") is not None else 0)
                       for a, k in spies["k6"].calls)
        # the shadow stage's traced rays and their steps (K1 from the same
        # origins and floors)
        sh_bytes, sh_ops = 0, 0
        light = None
        for args, _kw in spies["kd_shadow"].calls:
            (_w, _s, _t, _fp, _am, sro, sidx, scount, tidx, tcount, floors,
             _tr) = args
            c = (tidx[: int(tcount)].long() if tidx is not None
                 else torch.arange(int(scount), device=dev))
            origins = sro[sidx[c].long()].contiguous()
            if light is None:
                light = -torch.as_tensor(np.asarray(kws[0]["light_dir"],
                                                    np.float32), device=dev)
            srd = light.expand(origins.shape).contiguous()
            st = traversal.intersect_octree(
                svo.world(), float(svo.octree_scale), origins, srd, -1.0,
                False, t_floor=None if floors is None else floors[c])
            sh_ops += int(st.steps.sum()) * OPS_PER_STEP
            sh_bytes += world_bytes + c.shape[0] * (4 + 4 + 12 + 1)
        # the exact branch's primary: every pixel of every pose from its
        # tile floors
        pr_ops = 0
        for q, p in enumerate(poses):
            ro, rd = primary_rays(svo, p)
            k1 = traversal.intersect_octree(
                svo.world(), float(svo.octree_scale), ro, rd, -1.0, False,
                t_floor=beams.pixel_floors(tf[q], width=W, height=H))
            pr_ops += int(k1.steps.sum()) * OPS_PER_STEP
        NB = N * B
        out["bounds"] = dict(
            k9_trace=bound(tr_bytes, tr_ops),
            k9_merge=bound(mg_bytes, mg_ops),
            k9_finalize=bound(NB * 32 + NB * 36 + NB + (NB - fin_hits) * 16
                              + 2 * NB, NB * OPS_K9_RAY
                              + fin_hits * OPS_K9_FINALIZE),
            k9_shadow_cells=bound(cells_bytes, 0),
            k6=bound(k6_bytes, 0),
            # tile floors in; hit records, hit mask and sky pixels out
            kd_primary=bound(world_bytes + N * ntiles * 4 + NB * 37
                             + (NB - hits_total_e) * 16, pr_ops),
            kd_shade=bound(fin_hits * (4 + 36 + 16 + 4 + 1 + 12 + 16),
                           fin_hits * OPS_PER_PIXEL),
            kd_shadow=bound(sh_bytes, sh_ops),
            # each launch's own (launch_call)
            kd_finish=(sum(r["bound"][0] for r in runs["kd_finish"]),
                       "bytes"))
        # K6's library yardstick: torch.nonzero plus the pad on each of the
        # batch's masks, timed as the kernel is, summed
        out["k6_library_ms"] = sm["library_ms"]
    out["kernels"], out["stage_plain_ms"], out["stage_err"] = (
        res, stage_plain_ms, stage_err)
    out["launch_runs"] = runs
    log_k6(f"batch (esvo, {N} poses)", k6_rows, card)
    for c in trace_runs:
        log(f"k9_trace launch (batch, esvo, {N} poses, level {c['level']}):"
            f" {json.dumps(c['launch'])}; alone {c['ms']:.4f} ms; the "
            f"parent's kernel {json.dumps(c['parent'])} on {card}")
    for name in ("k9_merge", "k9_finalize", "k9_shadow_cells", "kd_primary",
                 "kd_shadow", "kd_finish"):
        for c in runs[name]:
            log(f"{name} launch (batch, esvo, {N} poses"
                + (f", level {c['level']}" if "level" in c else "")
                + (f", step {c['step']}" if "step" in c else "")
                + f"): alone {c['ms']:.4f} ms"
                + (f", at count 0 {c['ms_count0']:.4f} ms"
                   if "ms_count0" in c else "")
                + f"; the parent's kernel {json.dumps(c['parent'])} on "
                f"{card}")
    out["ok"] = all(r.get("equal", True) for r in res.values()) \
        and stage_err <= K3_MAX_ABS \
        and all(c["equal"] for c in runs["kd_primary"])
    for name, r in res.items():
        bd = out["bounds"][name]
        log(f"k10 {name} (esvo, the batch's {r['calls']} launches, {N} "
            f"poses): " + (f"equal to its plain version {r['equal']} (max "
                           f"|d| {r['err']:.3g}), plain {r['plain_ms']:.2f} "
                           "ms, " if "equal" in r else "")
            + f"alone {r['ms']:.4f} ms, bound {bd[0]:.4g} ms ({bd[1]}) on "
            f"{card}")
    log(f"k10 stages vs their plain version (the plain frames of poses "
        f"{list(pick)}, adaptive and exact): max |d| {stage_err:.3g} "
        f"(tolerance {K3_MAX_ABS:g}); plain adaptive frames "
        f"{stage_plain_ms:.1f} ms")
    if not out["ok"]:
        fail("a batched kernel disagrees with its plain version")

    with Phase("batch timing (esvo)"):
        for p in poses:  # warm-up
            svo.render(p, W, H)
        svo.render_batch(poses, W, H)
        batch_ms = sorted(cuda_ms(lambda: svo.render_batch(poses, W, H), 1)
                          / N for _ in range(REPS))
        seq = sorted(cuda_ms(lambda: svo.render(p, W, H), REPS)
                     for p in poses)
        piped = two_in_flight_ms([lambda p=p: svo.render(p, W, H)
                                  for p in poses] * REPS)
        batch_piped = two_in_flight_ms(
            [lambda: svo.render_batch(poses, W, H)] * REPS) / N
        out["host_us"] = host_us(lambda: svo.render_batch(poses, W, H))
        os.environ["VOXELRS_ADAPTIVE"] = "0"
        try:
            svo.render_batch(poses, W, H)
            exact_batch_ms = sorted(
                cuda_ms(lambda: svo.render_batch(poses, W, H), 1) / N
                for _ in range(REPS))[REPS // 2]
            exact_seq = sorted(cuda_ms(lambda: svo.render(p, W, H), REPS)
                               for p in poses)[N // 2]
        finally:
            del os.environ["VOXELRS_ADAPTIVE"]
    out["batched_frame_ms"] = batch_ms[REPS // 2]
    out["seq_frame_ms"] = seq[N // 2]
    out["piped_frame_ms"] = piped
    out["batched_piped_frame_ms"] = batch_piped
    out["exact_batched_frame_ms"] = exact_batch_ms
    out["exact_seq_frame_ms"] = exact_seq
    log(f"batch timing (esvo, {N} poses at {W}x{H}, CUDA events): "
        f"batched_frame_ms {out['batched_frame_ms']:.3f} ms a pose (the "
        f"batch {out['batched_frame_ms'] * N:.3f} ms; per run "
        f"{[round(x, 3) for x in batch_ms]}; two batches in flight "
        f"{batch_piped:.3f} ms a pose), sequential frames "
        f"{out['seq_frame_ms']:.3f} ms, two in flight {piped:.3f} ms; "
        f"host time of one batch call {out['host_us']:.1f} us; exact "
        f"branch: batched {exact_batch_ms:.3f} ms a pose, sequential "
        f"{exact_seq:.3f} ms, in the same run on {card}")
    return out


def probe_phase(card) -> dict:
    """P0: the gather probe's entry point over every configuration, counted
    from 0 (the probe's own timing: median of 5), then each configuration's
    kernel against its plain version bit for bit on the probe's table and
    a random one, the plain version timed."""
    import torch

    from voxelrs_tpu_torch.probes import gather_probe as gp

    out = {}
    with Phase("probe main path"):
        gp.launches = 0
        runs = []
        for kind, rows, sub in gp.probe_configs():
            c0 = gp.launches
            runs.append(gp.run(kind, rows, sub, card))
            runs[-1]["launches"] = gp.launches - c0
        torch.cuda.synchronize()
        out["launches"] = gp.launches
    with Phase("probe vs plain"):
        for r in runs:
            seeds = gp.random_words((r["sub"], 128), seed=3, high=1 << 30,
                                    device="cuda")
            eq, err = True, 0.0
            for tbl in (gp.arange_table(r["rows"], "cuda"),
                        gp.random_words((r["rows"], 128), seed=r["rows"],
                                        device="cuda")):
                k = gp.gather_probe(tbl, seeds, r["kind"])
                box = []
                pms = event_ms(lambda: box.append(gp.gather_probe_plain(
                    tbl, seeds, r["kind"])))
                eq &= bool(torch.equal(k, box[0]))
                err = max(err, float((k.long() - box[0].long()).abs().max()))
            r.update(equal=eq, err=err, plain_ms=pms,
                     bound=bound(r["sub"] * 128 * gp.N_STEPS * 4, 0))
    out["runs"] = runs
    out["ok"] = all(r["equal"] for r in runs)
    log(f"probe (P0, {out['launches']} launches over "
        f"{len(runs)} configurations): " + "; ".join(
            f"{r['kind']} rows {r['rows']}: {r['ms']:.4f} ms, "
            f"{r['g_gathers_per_s']:.3f} G gathers/s, equal {r['equal']}, "
            f"plain {r['plain_ms']:.1f} ms" for r in runs) + f" on {card}")
    if not out["ok"]:
        fail("the gather probe disagrees with its plain version")
    return out


def game_phase(fmt: str, card):
    """``Game(GameArgs(svo_format=fmt))`` at its defaults: counts from 0,
    the load and the scripted run, then ``check_game``. Returns the run's
    and the checks' numbers."""
    import torch

    from voxelrs_tpu_torch.gamelogic.game import Game, GameArgs
    from voxelrs_tpu_torch.ops import (compact, picker, shading, traversal,
                                       traversal_csvo)

    recorder = PickerRecorder(picker.pick)
    k6rec = CompactRecorder(compact.compact_indices, W * H, GAME_K6_CALLS,
                            "cuda")
    compact.compact_indices = k6rec
    traversal.launches = traversal_csvo.launches = 0
    shading.launches = shading.launches_csvo = 0
    picker.launches = picker.launches_csvo = 0
    zero_deferred_counts()
    game = Game(GameArgs(render_distance=GAME_RENDER_DISTANCE,
                         svo_format=fmt))
    try:
        try:
            g = play_game(game, recorder)
        finally:
            compact.compact_indices = k6rec.fn
        torch.cuda.synchronize()
        n = g["launches"] = dict(
            k5=picker.launches, k3=shading.launches,
            k5_csvo=picker.launches_csvo, k3_csvo=shading.launches_csvo,
            k1=traversal.launches, k4=traversal_csvo.launches,
            **deferred_counts())
        log(f"game path launches ({fmt}): {json.dumps(n)} (k1 and k4 run "
            f"inside the deferred stages and k5 here)")
        # the game renders 1080p: the adaptive frame (K9 in place of the
        # primary stage)
        if not (n["k5"] and n["k6"] and n["k7"]
                and all(n[f"kd_{s}"] for s in STAGES[1:])
                and all(n[f"k9_{k}"] for k in K9)):
            fail(f"a kernel of the {fmt} game's path was not launched")
        if g["adaptive_frames"] != g["frames"]:
            fail(f"the {fmt} game rendered frames other than adaptive ones")
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
        with Phase(f"k6 vs plain, every call of the game run ({fmt})"):
            k6c = k6rec.check()
        log(f"k6 vs plain ({fmt} game run): {k6c['k6_calls']} calls, "
            f"{k6c['k6_bad']} differing, {k6c['k6_missed']} not recorded; "
            f"ok {k6c['k6_ok']}")
        if not k6c["k6_ok"]:
            fail(f"K6 disagrees with its plain version in the {fmt} game")
        c = check_game(game, recorder, card)
        c.update(k6c)
    finally:
        game.shutdown()
    del recorder, k6rec  # the buffer and mask copies
    if not c["k5_ok"]:
        fail(f"K5 disagrees with its plain version ({fmt})")
    if not c["k3_game_ok"]:
        fail(f"K3 disagrees with the plain frame on the streamed {fmt} buffer")
    if not c["deferred_game_ok"]:
        fail(f"the deferred frame disagrees with K3's or with its plain "
             f"version on the streamed {fmt} buffer")
    if not c["adaptive_game_ok"]:
        fail(f"the adaptive frame disagrees with its plain version on the "
             f"streamed {fmt} buffer")
    return g, c


def bound(n_bytes: int, n_ops: int):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and float operations over the fp32 peak."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


if __name__ == "__main__":
    sys.exit(main())
