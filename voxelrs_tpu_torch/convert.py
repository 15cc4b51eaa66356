"""Carry a JAX-side renderer state across to this package.

``svo_state_from_jax`` takes the JAX package's world buffer and texture and
material tables as numpy arrays (for example ``np.asarray(svo.device_buf)``
and ``np.asarray(m) for m in svo.mips``) and returns this package's tensors
on ``device``; ``csvo_buffer_from_jax`` carries a CSVO world (the JAX
``Svo.device_buf`` words, ``root_ptr`` and ``depth``) across as a
``CsvoBuffer``; ``beam_state_from_jax`` carries the JAX
``HeightField.device()`` tuple and ``sun_map`` tuple across, so the beam
and sun-certificate functions of both packages run on identical tables.
Data here plays the part weights play in a model port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .ops.traversal_csvo import CsvoBuffer, check_words


class SvoState(NamedTuple):
    descriptors: torch.Tensor  # (N,) int32 holding the u32 words
    octree_scale: float
    mips: tuple  # of (T, h, w, 4) float32
    mat_params: torch.Tensor  # (V, 2) float32
    mat_tex: torch.Tensor  # (V, 6 or 9) int32


def svo_state_from_jax(descriptors, octree_scale, mips, mat_params, mat_tex,
                       device=None) -> SvoState:
    """Tensors of this package from the JAX package's numpy arrays. The
    u32 buffer keeps its bits (viewed as int32); every table keeps its
    values, layout and dtype."""
    dev = resolve_device(device)
    desc = np.ascontiguousarray(np.asarray(descriptors))
    if desc.dtype != np.uint32 or desc.ndim != 1:
        raise ValueError(f"descriptors: expected a 1-d uint32 array, got "
                         f"{desc.dtype} {desc.shape}")

    def tensor(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=dev)  # a copy

    return SvoState(
        descriptors=torch.tensor(desc.view(np.int32), device=dev),
        octree_scale=float(np.float32(octree_scale)),
        mips=tuple(tensor(m, np.float32) for m in mips),
        mat_params=tensor(mat_params, np.float32),
        mat_tex=tensor(mat_tex, np.int32),
    )


def csvo_buffer_from_jax(words, root_ptr, total_depth,
                         device=None) -> CsvoBuffer:
    """A ``CsvoBuffer`` from the JAX package's CSVO world: its
    ``Svo.device_buf`` (the node stream after the 4-byte prefix as uint32
    words), ``root_ptr`` and ``depth``. The words keep their bits."""
    w = np.ascontiguousarray(np.asarray(words))
    if w.dtype != np.uint32 or w.ndim != 1:
        raise ValueError(f"words: expected a 1-d uint32 array, got "
                         f"{w.dtype} {w.shape}")
    buf = CsvoBuffer(torch.tensor(w.view(np.int32),
                                  device=resolve_device(device)),
                     int(root_ptr), int(total_depth))
    check_words(*buf)
    return buf


def beam_state_from_jax(dev, sun=None, device=None):
    """(envelope tuple, sun tuple or None) of this package from the JAX
    package's ``HeightField.device()`` tuple ``(levels, offsets, n, hmax,
    bounds, levels_exact)`` and ``sun_map`` tuple ``(table, n1, d_len, d,
    origin)``, arrays as numpy arrays: the pyramids as int32 tensors, the
    bounds as a float32 tensor, the u16 table as an int16 tensor of the
    same bits, ``d_len``, ``d`` and ``origin`` as host float32 values — the
    layout of ``world.heightfield.HeightField`` here."""
    d = resolve_device(device)
    lv_d, offsets, n, hmax, bounds, lv_e = dev

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32).reshape(-1), device=d)

    env = (i32(lv_d), tuple(int(o) for o in offsets), int(n), int(hmax),
           torch.tensor(np.asarray(bounds, np.float32), device=d), i32(lv_e))
    if sun is None:
        return env, None
    table, n1, d_len, dvec, origin = sun
    table = np.ascontiguousarray(np.asarray(table))
    if table.dtype != np.uint16 or table.ndim != 2:
        raise ValueError(f"sun table: expected a 2-d uint16 array, got "
                         f"{table.dtype} {table.shape}")
    return env, (torch.tensor(table.view(np.int16), device=d), int(n1),
                 np.float32(d_len), np.asarray(dvec, np.float32),
                 np.asarray(origin, np.float32))
