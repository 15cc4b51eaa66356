"""Headless game loop: fixed-timestep physics (250 Hz) + per-frame
streaming/render, with the reference's player setup and CLI.
Mirrors reference: src/gamelogic/game.rs:19-159 + src/main.rs:73-142 —
frames render to tensors and the loop is drivable by scripts (benchmarks,
tests) or a step() API.

Counterpart: voxelrs_tpu/gamelogic/game.py, with the same CLI flags and
defaults:

    python -m voxelrs_tpu_torch.gamelogic.game --frames 30

Each frame streams chunks (loader events, worldgen and serialization on the
job threads, delta uploads), casts the look ray (kernel K5 on the card),
runs the fixed-step physics (one K5 cast per step while the player moves)
and, when asked, renders the deferred frame (the JAX package's default
mode, with the world's heightfield: K6, K7 and K8 around the traversal on
the card). The physics catch-up is capped at
``max_physics_steps_per_frame`` = 8 steps a frame, as in the JAX package;
the reference clamps the accumulator at 1 s (250 steps, game.rs:130).

``GameArgs.device`` (None = the card) places the renderer; the tests pass
"cpu", which runs the plain versions of the kernels. ``--svo-format csvo``
streams the world as CSVO (the reference's default format), rendered and
picked over kernel K4's traversal (K5 in its CSVO instantiation).
The Minecraft world import (``--mc-world``) is not ported: it raises.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..systems.jobs import JobSystem
from ..systems.physics import AABBDef, Entity
from . import benchmark
from .gameplay import Gameplay, Input
from .world import World

PHYSICS_HZ = 250.0


@dataclass
class GameArgs:
    mc_world: Optional[str] = None
    player_pos: tuple = (-24.0, 80.0, 174.0)
    player_euler_rot: tuple = (0.0, -90.0, 0.0)  # degrees
    # reference: --detach-input starts with detached controls (the cursor
    # stays ungrabbed, main.rs:89-91). Headless builds have no cursor; the
    # flag is kept for CLI parity and exposed to scripted callers.
    detach_input: bool = False
    render_distance: int = 20
    fov: float = 72.0
    render_shadows: bool = True
    no_lod: bool = False
    gpu_buffer_size_mb: float = 800.0
    width: int = 1920
    height: int = 1080
    benchmark_mode: bool = False
    texture_dir: Optional[str] = None
    # SVO serialization format: "esvo" | "csvo" (reference: the
    # use-esvo/use-csvo cargo features)
    svo_format: str = "esvo"
    workers: int = max(1, (os.cpu_count() or 2) - 1)
    # catch-up bound of the fixed-step accumulator (see the module
    # docstring)
    max_physics_steps_per_frame: int = 8
    # the renderer's device: None = the card ("cuda"), or "cpu"
    device: Optional[str] = None


class Game:
    def __init__(self, args: GameArgs):
        if args.mc_world is not None:
            raise NotImplementedError(
                "--mc-world: the Minecraft world import is not ported yet")
        self.args = args
        self.job_system = JobSystem(args.workers)
        try:
            self.world = World(
                self.job_system,
                fov_y_deg=args.fov,
                render_shadows=args.render_shadows,
                loading_radius=args.render_distance,
                no_lod=args.no_lod,
                gpu_size_mb=args.gpu_buffer_size_mb,
                benchmark_mode=args.benchmark_mode,
                texture_dir=args.texture_dir,
                svo_format=args.svo_format,
                device=args.device,
            )
        except BaseException:
            self.job_system.stop()  # no worker thread outlives a failed start
            raise
        rot = [math.radians(r) for r in args.player_euler_rot]
        self.player = Entity(
            position=np.asarray(args.player_pos, np.float32),
            aabb_def=AABBDef(
                np.array([-0.4, -1.7, -0.4], np.float32),
                np.array([0.8, 1.8, 0.8], np.float32),
            ),
        )
        self.player.euler_rotation[:] = rot
        self.player.caps.flying = True
        self.gameplay = Gameplay()
        self.input = Input()
        self._accumulator = 0.0
        self._last_frame_time: Optional[float] = None

    # -- loop ----------------------------------------------------------------------

    def step_frame(self, dt: Optional[float] = None, render: bool = False,
                   width: int = 0, height: int = 0):
        """Advance one frame: streaming update + fixed-step physics (+render).

        Returns the rendered (H, W, 4) tensor when ``render`` is True."""
        now = time.perf_counter()
        if dt is None:
            dt = 0.0 if self._last_frame_time is None else now - self._last_frame_time
        self._last_frame_time = now

        # update: input -> gameplay -> streaming
        self.gameplay.handle_movement(self.input, self.player, dt)
        self.world.update(self.player)
        self.gameplay.update_look_ray(self.world.world_svo, self.player)
        self.gameplay.handle_hotbar(self.input)
        self.gameplay.handle_voxel_placement(self.input, self.world, self.player)
        self.world.selected_voxel = (
            np.floor(self.gameplay.looking_at.pos)
            if self.gameplay.looking_at is not None
            else None
        )
        self.input.clear_frame()

        # fixed-timestep physics at 250 Hz (reference: game.rs:91,106-139)
        fixed_dt = 1.0 / PHYSICS_HZ
        cap = self.args.max_physics_steps_per_frame * fixed_dt
        self._accumulator = min(self._accumulator + dt, cap)
        while self._accumulator >= fixed_dt:
            self.world.update_fixed(self.player, fixed_dt)
            self._accumulator -= fixed_dt

        img = None
        if render:
            w = width or self.args.width
            h = height or self.args.height
            img = self.world.render(w, h)

        if dt > 0:
            benchmark.push_frame(1.0 / dt, dt * 1e3)
        benchmark.push_svo_bytes(self.world.world_svo.get_stats().used_bytes)
        return img

    def wait_for_world(self, timeout: float = 300.0, render_every: int = 0,
                       width: int = 320, height: int = 240) -> bool:
        """Run frames until the whole world is loaded + serialized
        (the in-game benchmark's 'all chunks loaded' condition).

        Between frames the loop waits, up to one 60 Hz frame, for the job
        threads to drain their queue. A frame here is a few hundred
        microseconds of Python that never blocks, and a loop of them holds
        the interpreter lock against the job threads: on the H100 machine
        such a loop had 1,441 of the 1,886 chunks of the radius-20 world
        after 300 s (chip_smoke.py). The JAX package's frames block on the
        device instead."""
        deadline = time.time() + timeout
        frame = 0
        while time.time() < deadline:
            if frame:
                self.job_system.wait_until_processed(1 / 60)
            render = render_every > 0 and frame % render_every == 0
            self.step_frame(render=render, width=width, height=height)
            if self.args.benchmark_mode and self.world.all_chunks_rendered:
                return True
            if not self.args.benchmark_mode and not (
                self.world.storage.has_pending_jobs()
                or self.world.world_generator.has_pending_jobs()
                or self.world.world_svo.has_pending_jobs()
                or self.world.world.has_changed_chunks()
            ):
                return True
            frame += 1
        return False

    def debug_stats(self) -> dict:
        """Live engine stats (the reference's imgui debug windows —
        fps/jobs/memory plots, chunk + SVO byte counts — as a dict;
        reference: game.rs:196-326)."""
        m = benchmark.collect()
        svo_stats = self.world.world_svo.get_stats()
        return {
            "fps": m["fps"],
            "frame_time_ms": m["frame_time_ms"],
            "jobs_pending": self.job_system.len(),
            "chunks_loaded": len(self.world.world.chunks),
            "chunks_borrowed": len(self.world.world._borrowed),
            "chunk_slot_pool": {
                "used": self.world.slot_pool.used_count(),
                "allocated": self.world.slot_pool.allocated_count(),
                "bytes": self.world.slot_pool.allocated_bytes(),
            },
            "svo": {
                "used_bytes": svo_stats.used_bytes,
                "capacity_bytes": svo_stats.capacity_bytes,
                "depth": svo_stats.depth,
            },
            "player": {
                "position": [float(v) for v in self.player.position],
                "grounded": self.player.state.is_grounded,
                "flying": self.player.caps.flying,
            },
        }

    def shutdown(self) -> None:
        self.job_system.clear()
        self.job_system.wait_until_processed(10)
        self.job_system.stop()


def parse_args(argv=None) -> GameArgs:
    """CLI with the reference's flags (reference: src/main.rs:73-115)."""
    p = argparse.ArgumentParser(description="voxelrs_tpu_torch engine")
    p.add_argument("--pos", nargs=3, type=float, default=[-24, 80, 174])
    p.add_argument("--rot", nargs=3, type=float, default=[0, -90, 0])
    p.add_argument("--render-distance", type=int, default=20)
    p.add_argument("--fov", type=float, default=72.0)
    p.add_argument("--render-shadows", type=lambda s: s != "false", default=True)
    p.add_argument("--no-lod", action="store_true")
    p.add_argument("--detach-input", action="store_true",
                   help="start with detached controls (reference parity; "
                        "headless builds have no cursor to grab)")
    p.add_argument("--mc-world", type=str, default=None)
    p.add_argument("--gpu-buffer-size", type=float, default=800.0)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--svo-format", choices=["esvo", "csvo"], default="esvo",
                   help="SVO serialization format (the reference's "
                        "use-esvo/use-csvo cargo features)")
    p.add_argument("--frames", type=int, default=0, help="run N frames then exit")
    a = p.parse_args(argv)
    args = GameArgs(
        mc_world=a.mc_world,
        player_pos=tuple(a.pos),
        player_euler_rot=tuple(a.rot),
        render_distance=a.render_distance,
        fov=a.fov,
        render_shadows=a.render_shadows,
        no_lod=a.no_lod,
        detach_input=a.detach_input,
        gpu_buffer_size_mb=a.gpu_buffer_size,
        width=a.width,
        height=a.height,
        benchmark_mode=a.benchmark,
        svo_format=a.svo_format,
    )
    args._frames = a.frames  # type: ignore[attr-defined]
    return args


def main(argv=None) -> None:
    import torch

    args = parse_args(argv)
    game = Game(args)
    try:
        frames = getattr(args, "_frames", 0) or 60
        game.wait_for_world(render_every=0)
        for _ in range(frames):
            game.step_frame(render=True)
            torch.cuda.synchronize()
        benchmark.print_json()
    finally:
        game.shutdown()


if __name__ == "__main__":
    main()
