"""The gather probe P0: how fast the card gathers words from a table, for
the access patterns a traversal uses.

    python -m voxelrs_tpu_torch.probes.gather_probe [kinds]

Counterpart: scripts/probes/pallas_probe.py (``make_kernel`` :32, ``run``
:68 with ``pl.pallas_call`` :73), the JAX package's only Pallas kernel,
which measured the same against a table held in a TPU core's VMEM. The
same configurations (each kind at rows 512, 4096 and 16384 of 128 u32
words, ``axis1`` at 512 only; ``sub`` 8 seed rows of 128 lanes; 512
steps), the same arithmetic, the median of 5 timed calls and the same
printed line (milliseconds, G gathers/s), with the card's name and power
limit beside it. ``kinds`` is a comma-separated subset of ``axis1``,
``axis0``, ``two_step``, ``flat`` (the JAX default order).

Every step each lane (i, j) XORs one gathered word into its accumulator
and advances its index by the LCG ``idx * 1664525 + 1013904223`` (u32
wrap): ``flat`` gathers ``tbl[idx % (rows * 128)]``; ``axis0``
``tbl[idx % rows, j]``; ``axis1`` ``tbl[i, idx % 128]``; ``two_step``
``tbl[r[i, c], c]`` with ``r = (idx % total) >> 7`` and ``c = (idx %
total) & 127`` — the probe's ``take_along_axis`` twice, which reads the
row index of the lane at column ``c``, not the lane's own, so it is not
``flat``.

``gather_probe`` launches the kernel (``csrc/p0_gather.cuh``, one
instantiation per kind) for CUDA tensors and counts its launches; for CPU
tensors it runs ``gather_probe_plain``, which holds the u32 words in int64
masked to 32 bits. At 8 seed rows the launch is 1,024 threads, so on the
H100's 132 SMs it measures the latency of a chain of dependent gathers,
not the card's gather bandwidth. Needs a CUDA card to time; exits
non-zero without one.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import _build
from ..ops.bits import U32_MASK, u32_to_i32

N_STEPS = 512
KINDS = _build.P0_KINDS
DEFAULT_KINDS = ("axis1", "axis0", "two_step", "flat")  # the JAX order
ROWS = (512, 4096, 16384)
SUB = 8
REPS = 5
LCG_A, LCG_C = 1664525, 1013904223

launches = 0  # P0 launches by gather_probe (the wrapper below)


def probe_configs(kinds=DEFAULT_KINDS) -> list:
    """[(kind, rows, sub)] of the JAX probe's ``__main__``."""
    return [(kind, rows, SUB) for kind in kinds for rows in ROWS
            if not (kind == "axis1" and rows != 512)]


def arange_table(rows: int, device=None) -> torch.Tensor:
    """The JAX probe's table: words 0 .. rows * 128 - 1, (rows, 128)."""
    return torch.arange(rows * 128, dtype=torch.int32,
                        device=device).reshape(rows, 128)


def random_words(shape, seed: int, high: int = 1 << 32,
                 device=None) -> torch.Tensor:
    """u32 words below ``high`` from ``seed`` (numpy), as int32 bits: the
    probe's seeds (``high`` 2^30) or a random table."""
    a = np.random.default_rng(seed).integers(0, high, shape, dtype=np.uint64)
    return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)


def gather_probe_plain(tbl, seeds, kind: str,
                       steps: int = N_STEPS) -> torch.Tensor:
    """The probe's function in plain PyTorch: ``tbl`` (rows, 128) and
    ``seeds`` (sub, 128) int32 tensors of u32 words → the (sub, 128)
    accumulators as int32 words."""
    if kind not in KINDS:
        raise ValueError(f"gather probe: unknown kind {kind!r}")
    t = tbl.to(torch.int64) & U32_MASK
    rows = t.shape[0]
    total = rows * 128
    idx = seeds.to(torch.int64) & U32_MASK
    sub = idx.shape[0]
    flat = t.reshape(-1)
    cols = torch.arange(128, device=t.device)
    acc = torch.zeros_like(idx)
    for _ in range(steps):
        if kind == "flat":
            v = flat[idx % total]
        elif kind == "axis0":
            v = t[idx % rows, cols]
        elif kind == "axis1":
            v = t[:sub].gather(1, idx % 128)
        else:
            addr = idx % total
            v = t[addr >> 7, cols].gather(1, addr & 127)
        acc = acc ^ v
        idx = (idx * LCG_A + LCG_C) & U32_MASK
    return u32_to_i32(acc)


def gather_probe(tbl, seeds, kind: str,
                 steps: int = N_STEPS) -> torch.Tensor:
    """``gather_probe_plain``'s function: the plain version for CPU tensors,
    P0's kernel for CUDA tensors."""
    if not tbl.is_cuda:
        return gather_probe_plain(tbl, seeds, kind, steps)
    global launches
    if kind not in KINDS:
        raise ValueError(f"gather probe: unknown kind {kind!r}")
    for name, a in (("tbl", tbl), ("seeds", seeds)):
        if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != 128 \
                or not a.is_contiguous() or a.device != tbl.device:
            raise ValueError(f"{name}: expected a contiguous (n, 128) int32 "
                             f"tensor on {tbl.device}")
    if kind == "axis1" and seeds.shape[0] > tbl.shape[0]:
        raise ValueError("axis1 reads row i of the table for seed row i")
    out = torch.empty_like(seeds)
    if seeds.shape[0]:
        _build.launch_p0(kind, tbl, seeds, steps, out)
        launches += 1
    return out


def run(kind: str, rows: int, sub: int, card: str, device="cuda") -> dict:
    """One configuration as the JAX probe's ``run``: the table, random
    seeds below 2^30, a first call (the build, on the first), then the
    median of 5 calls (CUDA events around each launch); prints its line."""
    tbl = arange_table(rows, device)
    seeds = random_words((sub, 128), seed=rows + KINDS.index(kind),
                         high=1 << 30, device=device)
    t0 = time.perf_counter()
    gather_probe(tbl, seeds, kind)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ts = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        gather_probe(tbl, seeds, kind)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ms = float(np.median(ts))
    rate = sub * 128 * N_STEPS / (ms / 1e3)
    print(f"{kind:9s} rows={rows:6d} ({rows * 512 // 1024:6d}KB) "
          f"sub={sub:3d}: {ms:8.4f} ms  -> {rate / 1e9:7.3f} G gathers/s  "
          f"(first call {first_s:.2f}s) on {card}", flush=True)
    return dict(kind=kind, rows=rows, sub=sub, ms=ms,
                g_gathers_per_s=rate / 1e9, first_call_s=first_s)


def main(argv=None) -> int:
    from ..bench import card_line

    argv = sys.argv[1:] if argv is None else argv
    kinds = argv[0].split(",") if argv else list(DEFAULT_KINDS)
    if any(k not in KINDS for k in kinds):
        print(f"gather_probe: kinds are {', '.join(KINDS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({card})", flush=True)
    for kind, rows, sub in probe_configs(kinds):
        run(kind, rows, sub, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
