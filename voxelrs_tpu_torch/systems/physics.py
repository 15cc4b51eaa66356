"""AABB-sweep physics over raycast results
(reference: src/systems/physics.rs:11-214).

Entities expand to picker AABB batches; per-axis velocities clamp against
the returned swept distances. The ``Raycaster`` protocol abstracts the SVO
so tests can inject a mock.

Copied from voxelrs_tpu/systems/physics.py:1-137.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Protocol

import numpy as np

from ..graphics.picker import Aabb, AabbResult, PickerBatch, PickerBatchResult

EPSILON = 0.0005


@dataclass
class EntityCapabilities:
    wall_clip: bool = False
    flying: bool = False
    gravity: float = 60.0
    max_fall_velocity: float = 100.0


@dataclass
class EntityState:
    is_grounded: bool = False


@dataclass
class AABBDef:
    offset: np.ndarray
    extents: np.ndarray


@dataclass
class Entity:
    position: np.ndarray
    aabb_def: AABBDef
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    euler_rotation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    caps: EntityCapabilities = field(default_factory=EntityCapabilities)
    state: EntityState = field(default_factory=EntityState)

    def get_forward(self) -> np.ndarray:
        pitch, yaw = self.euler_rotation[0], self.euler_rotation[1]
        f = np.array(
            [
                math.cos(yaw) * math.cos(pitch),
                math.sin(pitch),
                math.sin(yaw) * math.cos(pitch),
            ],
            np.float32,
        )
        return f / np.linalg.norm(f)


class Raycaster(Protocol):
    def raycast(self, batch: PickerBatch, result: PickerBatchResult) -> None: ...


class Physics:
    def __init__(self) -> None:
        self._batch = PickerBatch()
        self._result = PickerBatchResult()

    def step(self, delta_time: float, raycaster: Raycaster, entity: Entity) -> None:
        self.step_many(delta_time, raycaster, [entity])

    def step_many(self, delta_time: float, raycaster: Raycaster,
                  entities: list[Entity]) -> None:
        # zero-motion early-out: a flying entity with zero velocity neither
        # moves nor needs grounded detection (grounded is always False when
        # flying, reference: physics.rs:150-152) — its sweep results would
        # be unused, so skip the device round-trip entirely
        live = [
            e for e in entities
            if not (e.caps.flying and not e.velocity.any())
        ]
        live_ids = {id(e) for e in live}
        for e in entities:
            if id(e) not in live_ids:
                e.state = EntityState(is_grounded=False)
        if not live:
            return
        self._batch.reset()
        self._result.reset()
        for e in live:
            self._batch.add_aabb(Aabb.new(e.position, e.aabb_def.offset, e.aabb_def.extents))
        raycaster.raycast(self._batch, self._result)
        for e, res in zip(live, self._result.aabbs):
            self._update_entity(e, res, delta_time)

    @staticmethod
    def _update_entity(entity: Entity, result: AabbResult, dt: float) -> None:
        caps = entity.caps
        if not caps.flying:
            entity.velocity[1] -= caps.gravity * dt
            if entity.velocity[1] < 0.0:
                entity.velocity[1] = max(entity.velocity[1], -caps.max_fall_velocity)

        velocity = entity.velocity * dt

        entity.state = EntityState(
            is_grounded=(
                not caps.flying
                and (result.neg[1] + velocity[1]) < 0.02
                and result.neg[1] != -1.0
            )
        )
        if entity.state.is_grounded and entity.velocity[1] < 0.0:
            entity.velocity[1] = 0.0

        if not caps.flying:
            if not caps.wall_clip:
                velocity[0] = Physics._apply_axial(velocity[0], result.pos[0], result.neg[0])
                velocity[2] = Physics._apply_axial(velocity[2], result.pos[2], result.neg[2])
            velocity[1] = Physics._apply_axial(velocity[1], result.pos[1], result.neg[1])

        entity.position = entity.position + velocity

    @staticmethod
    def _apply_axial(speed: float, dst_pos: float, dst_neg: float) -> float:
        """Clamp axis speed against the swept distance
        (reference: physics.rs:171-184)."""
        dst = dst_pos if speed > 0.0 else dst_neg
        if dst == -1.0:
            return speed
        if dst < 2.0 * EPSILON:
            return 0.0
        if abs(speed) > dst:
            return (dst - EPSILON) * math.copysign(1.0, speed)
        return speed
