"""Generation on the job threads: wraps a ChunkGenerator behind the job system
(reference: src/systems/worldgen.rs:7-74). Chunks are only allocated when
the generator is interested in the position.

Copied from voxelrs_tpu/systems/worldgen.py (``Generator`` :19).
"""

from __future__ import annotations

from typing import Protocol

from ..world.chunk import Chunk, ChunkPos, ChunkSlotPool
from .jobs import ChunkProcessor, JobSystem


class ChunkGenerator(Protocol):
    def is_interested_in(self, pos: ChunkPos) -> bool: ...

    def generate_chunk(self, chunk: Chunk) -> None: ...


class Generator:
    def __init__(self, job_system: JobSystem, chunk_generator: ChunkGenerator,
                 slot_pool: ChunkSlotPool | None = None):
        self.generator = chunk_generator
        self.processor: ChunkProcessor[Chunk] = ChunkProcessor(job_system)
        self.slot_pool = slot_pool or ChunkSlotPool()

    def enqueue_chunk(self, pos: ChunkPos, lod: int) -> None:
        def produce() -> Chunk | None:
            if not self.generator.is_interested_in(pos):
                return None
            chunk = Chunk(pos, lod, self.slot_pool.allocate())
            self.generator.generate_chunk(chunk)
            return chunk

        self.processor.enqueue(pos, False, produce)

    def dequeue_chunk(self, pos: ChunkPos) -> None:
        self.processor.dequeue(pos)

    def get_generated_chunks(self, limit: int) -> list[Chunk]:
        return [
            r.value for r in self.processor.get_results(limit) if r.value is not None
        ]

    def has_pending_jobs(self) -> bool:
        return self.processor.has_pending()
