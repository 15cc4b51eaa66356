"""World: chunk map with change tracking and a borrow protocol.

Chunks can be temporarily *borrowed* — ownership moves to a background
serialization job; returning the chunk is a no-op if the slot was overridden
or removed in the meantime. Mirrors reference: src/world/world.rs:14-208.

Copied from voxelrs_tpu/world/world.py:16-153 (numpy only); this package
imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from .chunk import BlockId, Chunk, ChunkPos, NO_BLOCK


class BorrowedChunk:
    """Wrapper holding a chunk whose ownership left the world temporarily."""

    __slots__ = ("chunk", "was_dropped")

    def __init__(self, chunk: Chunk):
        self.chunk: Optional[Chunk] = chunk
        self.was_dropped = False

    @property
    def pos(self) -> ChunkPos:
        return self.chunk.pos

    @property
    def lod(self) -> int:
        return self.chunk.lod

    def take(self) -> Optional[Chunk]:
        self.was_dropped = True
        chunk, self.chunk = self.chunk, None
        return chunk

    def drop(self) -> None:
        self.was_dropped = True
        self.chunk = None


class World:
    """Collection of chunks keyed by position, with a changed-chunk queue."""

    def __init__(self, storage_pool=None) -> None:
        self.chunks: dict[ChunkPos, Chunk] = {}
        self._changed_set: set[ChunkPos] = set()
        self._changed_queue: deque[ChunkPos] = deque()
        self._borrowed: dict[ChunkPos, BorrowedChunk] = {}
        # optional ChunkSlotPool: voxel storage of dropped chunks returns here
        # (reference: src/world/memory.rs pooled-storage semantics)
        self.storage_pool = storage_pool

    def _release_storage(self, chunk: Optional[Chunk]) -> None:
        if chunk is not None and self.storage_pool is not None:
            self.storage_pool.release(chunk.voxels)

    def _mark_changed(self, pos: ChunkPos) -> None:
        if pos not in self._changed_set:
            self._changed_set.add(pos)
            self._changed_queue.append(pos)

    def mark_all_chunks_as_changed(self) -> None:
        for pos in list(self.chunks.keys()):
            self._mark_changed(pos)

    def has_changed_chunks(self) -> bool:
        return bool(self._changed_set)

    def has_borrowed_chunks(self) -> bool:
        return bool(self._borrowed)

    def set_chunk(self, chunk: Chunk) -> None:
        pos = chunk.pos
        self.set_chunk_unchanged(chunk)
        self._mark_changed(pos)

    def set_chunk_unchanged(self, chunk: Chunk) -> None:
        # forget any borrow so the stale chunk cannot be returned; its storage
        # is released when the rejected borrow comes back (return_chunk)
        self._borrowed.pop(chunk.pos, None)
        old = self.chunks.get(chunk.pos)
        if old is not None and old is not chunk and old.voxels is not chunk.voxels:
            self._release_storage(old)
        self.chunks[chunk.pos] = chunk

    def remove_chunk(self, pos: ChunkPos) -> None:
        # a chunk out on loan may still be read by a background serializer;
        # its storage is reclaimed when the borrow is rejected in return_chunk
        self._borrowed.pop(pos, None)
        self._release_storage(self.chunks.pop(pos, None))
        self._mark_changed(pos)

    def get_chunk(self, pos: ChunkPos) -> Optional[Chunk]:
        return self.chunks.get(pos)

    def get_chunk_mut(self, pos: ChunkPos) -> Optional[Chunk]:
        """Mutable access; marks the position as changed even if untouched."""
        self._mark_changed(pos)
        return self.chunks.get(pos)

    def borrow_chunk(self, pos: ChunkPos) -> Optional[BorrowedChunk]:
        chunk = self.chunks.pop(pos, None)
        if chunk is None:
            return None
        borrowed = BorrowedChunk(chunk)
        self._borrowed[pos] = borrowed
        return borrowed

    def return_chunk(self, borrowed: BorrowedChunk) -> None:
        """Return a borrow; no-op if the slot was overridden/removed meanwhile.
        Must NOT mark the chunk changed (that would create a feedback loop)."""
        if borrowed.chunk is None:
            return
        pos = borrowed.chunk.pos
        if self._borrowed.get(pos) is not borrowed:
            # slot overridden/removed while on loan: the serializer is done
            # with the array now, so storage can finally go back to the pool
            self._release_storage(borrowed.take())
            return
        del self._borrowed[pos]
        self.chunks[pos] = borrowed.take()

    def get_block(self, x: int, y: int, z: int) -> BlockId:
        pos = ChunkPos.from_block_pos(x, y, z)
        chunk = self.chunks.get(pos)
        if chunk is None:
            return NO_BLOCK
        return chunk.get_block(x & 31, y & 31, z & 31)

    def set_block(self, x: int, y: int, z: int, block: BlockId) -> bool:
        pos = ChunkPos.from_block_pos(x, y, z)
        chunk = self.chunks.get(pos)
        if chunk is None:
            return False
        chunk.set_block(x & 31, y & 31, z & 31, block)
        self._mark_changed(pos)
        return True

    def get_changed_chunks(self, limit: int) -> list[ChunkPos]:
        # drop borrow records whose chunks were consumed/abandoned
        for pos in [p for p, b in self._borrowed.items() if b.was_dropped]:
            del self._borrowed[pos]

        changed: list[ChunkPos] = []
        for _ in range(limit):
            if not self._changed_queue:
                break
            pos = self._changed_queue.popleft()
            self._changed_set.discard(pos)
            changed.append(pos)
        return changed
