"""Chunk loading policy: emits Load/Unload/LodChange events when the target
position crosses a chunk boundary, for a cylindrical radius around it.
Mirrors reference: src/systems/chunkloader.rs:8-143 (LOD distance bands:
0-6 → 5, 7-12 → 4, 13-19 → 3, else 2; events sorted by distance).

Copied from voxelrs_tpu/systems/chunkloader.py:1-106."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from ..world.chunk import ChunkPos


@dataclass(frozen=True, order=True)
class ChunkEvent:
    kind: str  # "load" | "unload" | "lod"
    pos: ChunkPos
    lod: int = 0


def load(pos: ChunkPos, lod: int) -> ChunkEvent:
    return ChunkEvent("load", pos, lod)


def unload(pos: ChunkPos) -> ChunkEvent:
    return ChunkEvent("unload", pos)


def lod_change(pos: ChunkPos, lod: int) -> ChunkEvent:
    return ChunkEvent("lod", pos, lod)


class ChunkLoader:
    def __init__(self, radius: int, start_y: int, end_y: int):
        assert start_y < end_y
        self.radius = radius
        self.start_y = start_y
        self.end_y = end_y
        self.last_pos: Optional[ChunkPos] = None
        self.loaded_chunks: dict[ChunkPos, int] = {}

    def get_radius(self) -> int:
        return self.radius

    def set_radius(self, radius: int) -> None:
        self.radius = radius
        self.last_pos = None  # force a full recheck next update

    @staticmethod
    def calculate_lod(center: ChunkPos, pos: ChunkPos) -> int:
        """Serialization LOD of the chunk at ``pos`` seen from ``center``:
        full detail (5) within 6 chunks, then one level less per band."""
        d = int(math.sqrt(pos.dst_2d_sq(center)))
        if d <= 6:
            return 5
        if d <= 12:
            return 4
        if d <= 19:
            return 3
        return 2

    def update(self, x: float, y: float, z: float) -> list[ChunkEvent]:
        events: list[ChunkEvent] = []
        current = ChunkPos.from_block_pos(int(x), int(y), int(z))
        if self.last_pos == current:
            return events
        self.last_pos = current

        r = self.radius
        for dx in range(-r, r + 1):
            for dz in range(-r, r + 1):
                if dx * dx + dz * dz > r * r:
                    continue
                col = ChunkPos(current.x + dx, 0, current.z + dz)
                lod = self.calculate_lod(current, col)
                for cy in range(self.start_y, self.end_y):
                    dy = cy - current.y
                    if dy < -r or dy > r:
                        continue
                    pos = ChunkPos(col.x, cy, col.z)
                    old = self.loaded_chunks.get(pos)
                    if old is not None:
                        if old != lod:
                            events.append(lod_change(pos, lod))
                            self.loaded_chunks[pos] = lod
                    else:
                        events.append(load(pos, lod))
                        self.loaded_chunks[pos] = lod

        # unload chunks that fell outside the radius
        r_sq = r * r
        for pos in list(self.loaded_chunks.keys()):
            dx = abs(pos.x - current.x)
            dy = abs(pos.y - current.y)
            dz = abs(pos.z - current.z)
            if dy > r or dx * dx + dz * dz > r_sq:
                del self.loaded_chunks[pos]
                events.append(unload(pos))

        events.sort(key=lambda e: e.pos.dst_sq(current))
        return events

    def is_loaded(self, pos: ChunkPos) -> bool:
        return pos in self.loaded_chunks

    def add_loaded_chunk(self, pos: ChunkPos, lod: int) -> None:
        self.loaded_chunks[pos] = lod
