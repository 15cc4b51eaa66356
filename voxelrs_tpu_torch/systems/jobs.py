"""Job scheduler: worker threads draining a prioritized queue with
cancellation, panic isolation, and per-chunk dedup.

Host-side analogue of the reference's thread-pool runtime
(reference: src/systems/jobs.rs:17-385). Bulk per-chunk *compute* belongs on
the device in batches; this scheduler covers host-side work — serialization,
storage decode, generation dispatch — while keeping the reference semantics:
a prioritized two-lane queue, cancellation tokens, exception isolation, and
``ChunkProcessor``'s dedup-by-position (re-enqueue cancels the prior job)
with a bounded non-blocking result drain.

Copied from voxelrs_tpu/systems/jobs.py (``JobSystem`` :45,
``ChunkProcessor`` :134), but for ``ChunkProcessor.has_pending``, which
stops at the first live job.
"""

from __future__ import annotations

import queue
import threading
import traceback
from dataclasses import dataclass, field
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class JobHandle:
    """Cancellation token for an enqueued job (reference: jobs.rs:32-40)."""

    __slots__ = ("_cancelled",)

    def __init__(self) -> None:
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    def is_cancelled(self) -> bool:
        return self._cancelled


@dataclass
class _Job:
    exec_fn: Callable[[], None]
    handle: JobHandle = field(default_factory=JobHandle)


class JobSystem:
    """N worker threads over a two-lane (prioritized / normal) queue."""

    def __init__(self, worker_count: int):
        self._prioritized: queue.SimpleQueue = queue.SimpleQueue()
        self._normal: queue.SimpleQueue = queue.SimpleQueue()
        self._wakeup = threading.Semaphore(0)
        self._stop = False
        self._inflight = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True, name=f"job-{i}")
            for i in range(max(1, worker_count))
        ]
        for w in self._workers:
            w.start()

    # -- queue ops -------------------------------------------------------------

    def push(self, prioritize: bool, exec_fn: Callable[[], None]) -> JobHandle:
        job = _Job(exec_fn)
        with self._lock:
            self._inflight += 1
        (self._prioritized if prioritize else self._normal).put(job)
        self._wakeup.release()
        return job.handle

    def clear(self) -> None:
        """Drop all queued (not yet running) jobs."""
        for q in (self._prioritized, self._normal):
            while True:
                try:
                    job = q.get_nowait()
                except queue.Empty:
                    break
                job.handle.cancel()
                with self._lock:
                    self._inflight -= 1
                    self._idle.notify_all()

    def len(self) -> int:
        with self._lock:
            return self._inflight

    def wait_until_processed(self, timeout: float = 30.0) -> bool:
        """Block until all queued + running jobs finished."""
        with self._idle:
            return self._idle.wait_for(lambda: self._inflight == 0, timeout)

    def stop(self) -> None:
        self._stop = True
        for _ in self._workers:
            self._wakeup.release()
        for w in self._workers:
            w.join(timeout=5)

    # -- workers -----------------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            self._wakeup.acquire()
            if self._stop:
                return
            job: Optional[_Job] = None
            try:
                job = self._prioritized.get_nowait()
            except queue.Empty:
                try:
                    job = self._normal.get_nowait()
                except queue.Empty:
                    continue
            try:
                if not job.handle.is_cancelled():
                    job.exec_fn()
            except Exception:  # panic isolation (reference: jobs.rs:163-167)
                traceback.print_exc()
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._idle.notify_all()


@dataclass
class ChunkResult(Generic[T]):
    pos: object  # ChunkPos
    value: T


class ChunkProcessor(Generic[T]):
    """Per-ChunkPos job dedup + result channel
    (reference: jobs.rs:289-385).

    Results are generation-tagged per position: a result produced by a job
    that was re-enqueued or cancelled in the meantime is STALE and must not
    be delivered (it would displace the fresh job's result). Dropped values
    are handed to ``on_drop`` so owners can reclaim resources they carry
    (borrowed chunks, pool slots)."""

    def __init__(self, job_system: JobSystem, on_drop=None):
        self.job_system = job_system
        self._chunk_jobs: dict = {}
        self._gen: dict = {}
        self._results: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._on_drop = on_drop

    def enqueue(self, pos, prioritize: bool, produce_fn: Callable[[], T]) -> None:
        """Enqueue work for ``pos``; a pending job for the same position is
        cancelled first."""
        self.dequeue(pos)
        with self._lock:
            gen = self._gen.get(pos, 0) + 1
            self._gen[pos] = gen

        def run() -> None:
            value = produce_fn()
            self._results.put((ChunkResult(pos, value), gen))

        handle = self.job_system.push(prioritize, run)
        with self._lock:
            self._chunk_jobs[pos] = handle

    def dequeue(self, pos) -> None:
        with self._lock:
            handle = self._chunk_jobs.pop(pos, None)
        if handle is not None:
            handle.cancel()

    def get_results(self, limit: int) -> list[ChunkResult[T]]:
        results: list[ChunkResult[T]] = []
        while len(results) < limit:
            try:
                r, gen = self._results.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                handle = self._chunk_jobs.get(r.pos)
                fresh = (gen == self._gen.get(r.pos)
                         and handle is not None
                         and not handle.is_cancelled())
                if fresh:
                    del self._chunk_jobs[r.pos]
            if fresh:
                results.append(r)
            elif self._on_drop is not None:
                # cancelled/stale results are dropped — let the owner
                # reclaim whatever the value carries
                self._on_drop(r.value)
        return results

    def has_pending(self) -> bool:
        """True while any non-cancelled job or unconsumed result exists
        (with lazy cleanup of cancelled entries, reference: jobs.rs:360-378).

        The scan stops at the first live job, so a frame that polls a
        queue of thousands of jobs pays for the cancelled entries in front
        of it, not for the whole queue; the JAX package scans every entry on
        every call."""
        if not self._results.empty():
            return True
        with self._lock:
            stale = []
            live = False
            for p, h in self._chunk_jobs.items():
                if not h.is_cancelled():
                    live = True
                    break
                stale.append(p)
            for p in stale:
                del self._chunk_jobs[p]
            return live
