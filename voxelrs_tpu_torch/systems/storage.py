"""World persistence: the Storage protocol and NopStorage (regenerate
everything). Mirrors reference: src/systems/storage.rs:13-48.

Counterpart: voxelrs_tpu/systems/storage.py:1-52. The Minecraft Anvil import
(``MinecraftStorage`` :55, with ``utils/mcanvil.py``) is not ported yet, so
the game here always runs the procedural world.
"""

from __future__ import annotations

from typing import Optional, Protocol

from ..world.chunk import Chunk, ChunkPos


class Storage(Protocol):
    def load(self, pos: ChunkPos, lod: int) -> None: ...

    def get_load_results(self, limit: int) -> list["LoadResult"]: ...

    def has_pending_jobs(self) -> bool: ...


class LoadResult:
    """Either a loaded chunk or a miss (miss → the generator takes over)."""

    __slots__ = ("pos", "lod", "chunk")

    def __init__(self, pos: ChunkPos, lod: int, chunk: Optional[Chunk]):
        self.pos = pos
        self.lod = lod
        self.chunk = chunk


class NopStorage:
    """Persistence disabled: every load misses so chunks regenerate
    (reference: storage.rs:20-48)."""

    def __init__(self) -> None:
        self._pending: list[LoadResult] = []

    def load(self, pos: ChunkPos, lod: int) -> None:
        self._pending.append(LoadResult(pos, lod, None))

    def get_load_results(self, limit: int) -> list[LoadResult]:
        out = self._pending[:limit]
        del self._pending[: len(out)]
        return out

    def has_pending_jobs(self) -> bool:
        return bool(self._pending)
