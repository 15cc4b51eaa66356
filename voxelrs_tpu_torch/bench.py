"""Renderer benchmark of voxelrs_tpu_torch on one CUDA card.

    python3 -m voxelrs_tpu_torch.bench [--svo-format esvo|csvo]

The procedural scene of the JAX package's ``bench.py`` (:59-138):
``Generator(1, default_config())``, 8x8 chunk columns with the streaming
engine's distance-banded LOD, 72 chunks, depth 8 (6.51 MB of ESVO), its
terrain envelope (``world.heightfield.HeightField``) attached, and the 5
camera poses flying over the terrain. Each pose renders at 1920x1080 with
shadows in the default (deferred) mode, which at this size is the JAX
package's adaptive thick-ray frame (K9: a quarter-resolution trace filled
and refined onto the pixels): the beam pre-pass (K7), the sun
certificates (K8) and the compactions (K6) around the traversal. The
exact deferred frame (``adaptive=False``) is timed beside it in the same
run.

Measured with CUDA events: the sequential frame (one frame at a time, from
the call to the finished frame) and the pipelined frame (two frames in
flight: the next frame is issued before the previous one is waited for;
the frame has no host round trip inside). Prints one JSON line with
``Mrays_per_sec_1080p_shadows`` = W*H*2 / frame time (a primary and a
shadow ray a pixel; the better of the two modes), ``seq_frame_ms``,
``piped_frame_ms``, the path that ran (``mode`` "adaptive" or "deferred",
``hierarchy``), the exact deferred frame's ``exact_seq_frame_ms`` and
``exact_piped_frame_ms``, ``batched_frame_ms`` (the 5 poses rendered by
``Svo.render_batch``, K10: every stage launched once for the batch; CUDA
events around the whole batch, milliseconds a pose, as the JAX bench's
:238-274; the Mrays/s line takes the best of the sequential, pipelined and
batched frames, as it does), the card's name and power limit. The JAX bench's
Minecraft-world scene is not carried over: it needs the reference's
bundled world, which the repository does not hold.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

W, H = 1920, 1080
FRAMES = 5
REPS = 3  # timed passes over the poses, after one warm-up pass


def build_world(radius: int = 4, opaque_lut=None):
    """The JAX bench.py's procedural region in both formats, with its
    envelope: (ESVO world, CSVO world, chunk count, HeightField)."""
    from .gamelogic.worldgen import Generator, default_config
    from .systems.chunkloader import ChunkLoader
    from .world.chunk import Chunk, ChunkPos
    from .world.csvo import Csvo, CsvoSerializedChunk
    from .world.esvo import Esvo, SerializedChunk
    from .world.heightfield import (HeightField, chunk_column_tops,
                                    chunk_solid_bases, chunk_voxel_tops)
    from .world.octree import Position

    gen = Generator(1, default_config())
    svo, csvo, hf = Esvo(), Csvo(), HeightField()
    center = ChunkPos(radius, 2, radius)
    count = 0
    for cx in range(radius * 2):
        for cz in range(radius * 2):
            col = gen.get_column(cx, cz)
            # distance-banded LOD exactly like the streaming engine
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
                hf.set_chunk((cx, cy, cz),
                             chunk_column_tops(chunk.voxels, lod),
                             vtops=chunk_voxel_tops(chunk.voxels, lod),
                             sbase=chunk_solid_bases(chunk.voxels, lod,
                                                     opaque_lut))
                count += 1
    svo.serialize()
    csvo.serialize()
    return svo, csvo, count, hf


def poses(width: int = W, height: int = H):
    """The 5 camera poses of the JAX bench.py's procedural scene."""
    from .graphics.svo import RenderParams

    fwd = np.array([0.55, -0.35, 0.76], np.float32)
    fwd /= np.linalg.norm(fwd)
    base = RenderParams(cam_pos=np.array([16.0, 95.0, -20.0], np.float32),
                        cam_fwd=fwd, aspect_ratio=width / height,
                        fov_y_rad=np.radians(80.0), render_shadows=True,
                        shadow_distance=300.0)
    out = []
    for i in range(FRAMES):
        p = RenderParams(**{**base.__dict__})
        p.cam_pos = base.cam_pos + np.array([2.0 * i, 0.0, 1.5 * i],
                                            np.float32)
        out.append(p)
    return out


def scene(svo_format: str = "esvo", device=None):
    """(graphics Svo with the envelope attached, chunk count)."""
    from .gamelogic.content import new_registry
    from .graphics.svo import Svo
    from .world.heightfield import opaque_lut_from_mask

    dtype = np.uint32 if svo_format == "esvo" else np.uint8
    svo = Svo(new_registry(), capacity_mb=64, buffer_dtype=dtype,
              device=device)
    world, cworld, count, hf = build_world(
        opaque_lut=opaque_lut_from_mask(svo.translucent_block_mask))
    svo.update(world if svo_format == "esvo" else cworld)
    svo.set_heightfield(hf)
    return svo, count


def measure(render, frames) -> tuple[float, float]:
    """(sequential, pipelined) milliseconds a frame, CUDA events: the
    median of the sequential frames, and the mean frame of 2 in flight."""
    import torch

    for p in frames:  # warm-up: builds, first sun map, caches
        render(p)
    torch.cuda.synchronize()
    seq = []
    for _ in range(REPS):
        for p in frames:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            render(p)
            b.record()
            b.synchronize()
            seq.append(a.elapsed_time(b))
    seq.sort()
    n = REPS * len(frames)
    start = torch.cuda.Event(enable_timing=True)
    ends = []
    start.record()
    for i in range(n):
        render(frames[i % len(frames)])
        e = torch.cuda.Event()
        e.record()
        ends.append(e)
        if i >= 1:
            ends[i - 1].synchronize()  # two frames in flight
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    return seq[len(seq) // 2], start.elapsed_time(end) / n


def measure_batch(svo, frames) -> float | None:
    """Milliseconds a pose of ``Svo.render_batch`` over ``frames``: CUDA
    events around each whole batch, waited for before the next (as the
    JAX bench reads each batch back), the mean of REPS batches after one
    warm-up; None where the batch does not run."""
    import torch

    if svo.render_batch(frames, W, H) is None:
        return None
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        svo.render_batch(frames, W, H)
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / (REPS * len(frames))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--svo-format", choices=("esvo", "csvo"), default="esvo")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    svo, chunks = scene(args.svo_format)
    frames = poses()
    print(f"# world: {chunks} chunks, depth {svo.depth}, "
          f"{svo.stats.used_bytes / 1e6:.2f} MB {args.svo_format.upper()}",
          file=sys.stderr)
    seq, piped = measure(lambda p: svo.render(p, W, H), frames)
    ran = dict(svo.last_frame)
    exact_seq, exact_piped = measure(
        lambda p: svo.render(p, W, H, adaptive=False), frames)
    batched = measure_batch(svo, frames)
    best = min(t for t in (seq, piped, batched) if t is not None)
    card = card_line()
    name, _, limit = card.partition(",")
    print(json.dumps({
        "metric": "Mrays_per_sec_1080p_shadows",
        "Mrays_per_sec_1080p_shadows": W * H * 2 / (best / 1e3) / 1e6,
        "unit": "Mrays/s", "scene": "procedural",
        "mode": "adaptive" if ran.get("adaptive") else "deferred",
        "hierarchy": ran.get("hierarchy"),
        "svo_format": args.svo_format, "seq_frame_ms": seq,
        "piped_frame_ms": piped, "exact_seq_frame_ms": exact_seq,
        "exact_piped_frame_ms": exact_piped, "batched_frame_ms": batched,
        "sun_map": bool(ran.get("sun")),
        "card": name.strip(), "power_limit": limit.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
