"""Gameplay: movement, looking, block break/place/pick
(reference: src/gamelogic/gameplay.rs:19-255).

Input is an abstract event state (scriptable for headless benchmarks):
``Input`` carries level state (keys down, mouse delta) and edge state
(pressed-once keys/buttons), mirroring src/core/input.rs.

Copied from voxelrs_tpu/gamelogic/gameplay.py:37-176. The look ray is one
picker cast a frame (``Svo.raycast``, kernel K5 on the card)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..graphics.picker import PickerBatch, PickerBatchResult
from ..systems.physics import Entity
from . import content

FLY_SPEED = 60.0
WALK_SPEED = 9.0
SPRINT_FACTOR = 1.5
JUMP_SPEED = 13.0
MOUSE_SENSITIVITY = 0.002
LOOK_RAY_DISTANCE = 30.0

HOTBAR = [
    content.GRASS,
    content.DIRT,
    content.STONE,
    content.STONE_BRICKS,
    content.GLASS,
]


@dataclass
class Input:
    keys_down: set = field(default_factory=set)  # e.g. {"w", "a", "shift"}
    keys_pressed: set = field(default_factory=set)  # edge-triggered
    buttons_pressed: set = field(default_factory=set)  # {1, 2, 3}
    mouse_delta: tuple = (0.0, 0.0)

    def clear_frame(self) -> None:
        self.keys_pressed = set()
        self.buttons_pressed = set()
        self.mouse_delta = (0.0, 0.0)


class Gameplay:
    def __init__(self) -> None:
        self.selected_block = content.GRASS
        self.looking_at = None  # RayResult or None
        # jump edge-detection latch (reference: gameplay.rs:121-145)
        self.was_grounded = False
        self.is_jumping = False

    # -- camera / movement -------------------------------------------------------

    def handle_movement(self, input: Input, player: Entity, dt_frame: float) -> None:
        """Update rotation from mouse delta and velocity from WASD
        (reference: gameplay.rs:100-159)."""
        dx, dy = input.mouse_delta
        if abs(dx) > 0.01:
            player.euler_rotation[1] += dx * MOUSE_SENSITIVITY  # yaw
        if abs(dy) > 0.01:
            player.euler_rotation[0] -= dy * MOUSE_SENSITIVITY  # pitch
            limit = math.pi / 2 - 0.01
            player.euler_rotation[0] = float(
                np.clip(player.euler_rotation[0], -limit, limit)
            )

        fwd = player.get_forward()
        flat_fwd = np.array([fwd[0], 0.0, fwd[2]], np.float32)
        n = np.linalg.norm(flat_fwd)
        if n > 0:
            flat_fwd /= n
        right = np.cross(flat_fwd, np.array([0.0, 1.0, 0.0], np.float32))

        direction = np.zeros(3, np.float32)
        if "w" in input.keys_down:
            direction += flat_fwd
        if "s" in input.keys_down:
            direction -= flat_fwd
        if "a" in input.keys_down:
            direction -= right
        if "d" in input.keys_down:
            direction += right

        # flying -> FLY_SPEED; else shift sprints (reference: gameplay.rs:84-90)
        if player.caps.flying:
            speed = FLY_SPEED
        elif "shift" in input.keys_down:
            speed = WALK_SPEED * SPRINT_FACTOR
        else:
            speed = WALK_SPEED
        n = np.linalg.norm(direction)
        if n > 0:
            direction = direction / n * speed

        player.velocity[0] = direction[0]
        player.velocity[2] = direction[2]

        if player.caps.flying:
            self.is_jumping = False
            self.was_grounded = False
            player.velocity[1] = 0.0
            if "space" in input.keys_down:
                player.velocity[1] = speed
            if "shift" in input.keys_down:
                player.velocity[1] = -speed
        else:
            # jump latch: holding space does not autojump; a jump fires only
            # while grounded-last-frame and not already mid-jump
            # (reference: gameplay.rs:133-145)
            is_grounded = player.state.is_grounded
            if "space" in input.keys_down and self.was_grounded:
                if not self.is_jumping:
                    self.is_jumping = True
                    player.velocity[1] = JUMP_SPEED
            elif is_grounded:
                self.is_jumping = False
            self.was_grounded = is_grounded

        if "f" in input.keys_pressed:
            player.caps.flying = not player.caps.flying

    # -- voxel interaction ------------------------------------------------------------

    def update_look_ray(self, raycaster, player: Entity) -> None:
        """Cast the look ray each frame (reference: gameplay.rs:161-174)."""
        batch = PickerBatch()
        result = PickerBatchResult()
        batch.add_ray(player.position, player.get_forward(), LOOK_RAY_DISTANCE)
        raycaster.raycast(batch, result)
        hit = result.rays[0]
        self.looking_at = hit if hit.did_hit() else None

    def handle_hotbar(self, input: Input) -> None:
        for i in range(1, 6):
            if str(i) in input.keys_pressed:
                self.selected_block = HOTBAR[i - 1]

    def handle_voxel_placement(self, input: Input, world, player: Entity) -> None:
        """Break (button 1) / place (button 2) / pick (button 3)
        (reference: gameplay.rs:188-233)."""
        if self.looking_at is None:
            return
        hit = self.looking_at

        if 1 in input.buttons_pressed:
            x, y, z = (int(math.floor(v)) for v in hit.pos)
            world.set_block(x, y, z, content.AIR)

        if 3 in input.buttons_pressed:
            x, y, z = (int(math.floor(v)) for v in hit.pos)
            block = world.world.get_block(x, y, z)
            if block != content.AIR:
                self.selected_block = block

        if 2 in input.buttons_pressed:
            target = hit.pos + hit.normal
            x, y, z = (int(math.floor(v)) for v in target)
            if not self._overlaps_player(player, x, y, z):
                world.set_block(x, y, z, self.selected_block)

    @staticmethod
    def _overlaps_player(player: Entity, x: int, y: int, z: int) -> bool:
        """Reject placements intersecting the player's AABB
        (reference: gameplay.rs:208-222)."""
        lo = player.position + player.aabb_def.offset
        hi = lo + player.aabb_def.extents
        return (
            x + 1 > lo[0] and x < hi[0]
            and y + 1 > lo[1] and y < hi[1]
            and z + 1 > lo[2] and z < hi[2]
        )
