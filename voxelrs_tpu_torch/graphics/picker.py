"""Picker ray/AABB batching (reference: src/graphics/svo_picker.rs:8-299).

AABBs expand into up to 3 rays per lattice corner, 2 per edge, 1 per face
point over ``ceil(extents)`` subdivisions; results fold back into per-axis
min positive/negative sweep distances (-1 = no hit).

Copied from voxelrs_tpu/graphics/picker.py:17-157 (numpy only). The device
side of the picker is ``ops/picker.py`` (kernel K5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_PICKER_TASK_DST = 10.0


@dataclass
class Ray:
    pos: np.ndarray
    dir: np.ndarray
    max_dst: float


@dataclass
class RayResult:
    dst: float = -1.0
    inside_voxel: bool = False
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    normal: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))

    def did_hit(self) -> bool:
        return self.dst != -1.0


@dataclass
class Aabb:
    pos: np.ndarray
    offset: np.ndarray
    extents: np.ndarray

    @staticmethod
    def new(pos, offset, extents) -> "Aabb":
        return Aabb(
            np.asarray(pos, np.float32),
            np.asarray(offset, np.float32),
            np.asarray(extents, np.float32),
        )

    def _blocks_per_axis(self):
        return [int(np.ceil(e)) for e in self.extents]

    def _iter_task_points(self):
        """Yield (point, dir) for every ray this AABB expands into, in the
        exact nesting/order of the reference (x, y, z loops; axis loop)."""
        bpa = self._blocks_per_axis()
        step = [self.extents[i] / bpa[i] if bpa[i] else 0.0 for i in range(3)]
        for x in range(bpa[0] + 1):
            for y in range(bpa[1] + 1):
                for z in range(bpa[2] + 1):
                    axes = (x, y, z)
                    for i in range(3):
                        v = axes[i]
                        if v != 0 and v != bpa[i]:
                            continue
                        d = np.zeros(3, np.float32)
                        d[i] = -1.0 if v == 0 else 1.0
                        point = np.array(
                            [x * step[0], y * step[1], z * step[2]], np.float32
                        )
                        yield self.pos + self.offset + point, d, i, v

    def generate_picker_tasks(self) -> list[tuple]:
        return [
            (MAX_PICKER_TASK_DST, p, d) for p, d, _, _ in self._iter_task_points()
        ]

    def parse_picker_results(self, dsts: np.ndarray) -> tuple["AabbResult", int]:
        """Fold per-ray distances into per-axis pos/neg minima."""
        result = AabbResult()
        refs = np.full(6, -1.0, np.float32)  # [x+, x-, y+, y-, z+, z-]
        idx = 0
        for _, _, i, v in self._iter_task_points():
            dst = dsts[idx]
            idx += 1
            if dst == -1.0:
                continue
            ref = i * 2 + (1 if v == 0 else 0)
            refs[ref] = dst if refs[ref] == -1.0 else min(refs[ref], dst)
        result.pos = np.array([refs[0], refs[2], refs[4]], np.float32)
        result.neg = np.array([refs[1], refs[3], refs[5]], np.float32)
        return result, idx


@dataclass
class AabbResult:
    neg: np.ndarray = field(default_factory=lambda: np.full(3, -1.0, np.float32))
    pos: np.ndarray = field(default_factory=lambda: np.full(3, -1.0, np.float32))


class PickerBatch:
    def __init__(self) -> None:
        self.rays: list[Ray] = []
        self.aabbs: list[Aabb] = []

    def reset(self) -> None:
        self.rays.clear()
        self.aabbs.clear()

    def add_ray(self, pos, dir, max_dst: float) -> None:
        self.rays.append(
            Ray(np.asarray(pos, np.float32), np.asarray(dir, np.float32), max_dst)
        )

    def add_aabb(self, aabb: Aabb) -> None:
        self.aabbs.append(aabb)

    def serialize_tasks(self) -> np.ndarray:
        """All tasks as an (N, 7) array [max_dst, pos.xyz, dir.xyz]."""
        tasks = [(r.max_dst, r.pos, r.dir) for r in self.rays]
        for aabb in self.aabbs:
            tasks.extend(aabb.generate_picker_tasks())
        if not tasks:
            return np.zeros((0, 7), np.float32)
        out = np.empty((len(tasks), 7), np.float32)
        for i, (m, p, d) in enumerate(tasks):
            out[i, 0] = m
            out[i, 1:4] = p
            out[i, 4:7] = d
        return out

    def deserialize_results(self, dst_arr, inside_arr, pos_arr, normal_arr,
                            result: "PickerBatchResult") -> None:
        offset = 0
        for _ in self.rays:
            result.rays.append(
                RayResult(
                    dst=float(dst_arr[offset]),
                    inside_voxel=bool(inside_arr[offset]),
                    pos=np.asarray(pos_arr[offset]),
                    normal=np.asarray(normal_arr[offset]),
                )
            )
            offset += 1
        for aabb in self.aabbs:
            res, consumed = aabb.parse_picker_results(dst_arr[offset:])
            result.aabbs.append(res)
            offset += consumed


class PickerBatchResult:
    def __init__(self) -> None:
        self.rays: list[RayResult] = []
        self.aabbs: list[AabbResult] = []

    def reset(self) -> None:
        self.rays.clear()
        self.aabbs.clear()
