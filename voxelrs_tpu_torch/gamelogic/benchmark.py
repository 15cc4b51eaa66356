"""Benchmark metrics collection: fps/frame-time samplers, named duration
traces with avg/median ring buffers, JSON dump.
Mirrors reference: src/gamelogic/benchmark.rs:9-210.

Copied from voxelrs_tpu/gamelogic/benchmark.py.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque


class Samples:
    """Fixed-capacity ring buffer with avg/median."""

    def __init__(self, capacity: int):
        self.samples: deque[float] = deque(maxlen=capacity)

    def add(self, value: float) -> None:
        self.samples.append(value)

    def avg(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    def median(self) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[len(s) // 2]

    def reset(self) -> None:
        self.samples.clear()


_fps = Samples(1000)
_frame_time = Samples(1000)
_max_svo_bytes = 0
_traces: dict[str, Samples] = {}
_lock = threading.Lock()


def push_frame(fps: float, frame_time_ms: float) -> None:
    _fps.add(fps)
    _frame_time.add(frame_time_ms)


def reset_fps() -> None:
    _fps.reset()
    _frame_time.reset()


def push_svo_bytes(used_bytes: int) -> None:
    global _max_svo_bytes
    _max_svo_bytes = max(_max_svo_bytes, used_bytes)


class Trace:
    def __init__(self, name: str):
        self.name = name
        self.start = time.perf_counter()


def start_trace(name: str) -> Trace:
    return Trace(name)


def stop_trace(trace: Trace) -> None:
    dt = time.perf_counter() - trace.start
    with _lock:
        _traces.setdefault(trace.name, Samples(5000)).add(dt)


def trace(name: str, fn):
    t = start_trace(name)
    result = fn()
    stop_trace(t)
    return result


def trace_if(name: str, fn, cond_fn):
    """Record the duration only when ``cond_fn(result)`` holds
    (reference: benchmark.rs:169-182)."""
    t = start_trace(name)
    result = fn()
    if cond_fn(result):
        stop_trace(t)
    return result


def collect() -> dict:
    with _lock:
        return {
            "fps": {"avg": _fps.avg(), "med": _fps.median()},
            "frame_time_ms": {"avg": _frame_time.avg(), "med": _frame_time.median()},
            "svo_size_mb": _max_svo_bytes / 1e6,
            "traces": {
                name: {"avg": s.avg(), "med": s.median(), "n": len(s.samples)}
                for name, s in _traces.items()
            },
        }


def print_json() -> None:
    print(json.dumps(collect()))


def reset_all() -> None:
    global _max_svo_bytes
    with _lock:
        reset_fps()
        _traces.clear()
        _max_svo_bytes = 0
