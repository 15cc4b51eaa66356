"""The host C++ chunk serializers (ESVO and CSVO), loaded with ctypes and
built with ``g++`` at first use.

Counterpart: voxelrs_tpu/native/__init__.py (loader :25-140) with copies of
its two sources. Each library is built into
``voxelrs_tpu_torch/_build/native/<sha256 of source and flags>/`` (a
directory that .gitignore lists), never beside the sources: the build
writes a temporary name and renames it, so a cut build leaves nothing
half-written. A ``ctypes.CDLL`` call releases the interpreter lock, so the
job threads serialize chunks in parallel with each other and with the frame
loop; the loader's lock keeps two threads from building at once.

Every function has a numpy fallback (``world.esvo_dense.serialize_dense_chunk``,
``world.csvo.serialize_dense_csvo``) that gives the same bytes; when a
library cannot be built or loaded the callers take it and the loader says
so once. ``loaded()`` tells a caller (``chip_smoke.py``) which libraries
are in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build", "native")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_libs: dict = {}
build_seconds: dict = {}  # name -> seconds of its g++ run (absent: reused)


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(_HERE, f"{name}.cpp"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def _build(name: str, so: str) -> None:
    import time

    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    subprocess.run(["g++", *GXX_FLAGS, os.path.join(_HERE, f"{name}.cpp"),
                    "-o", tmp], check=True, capture_output=True,
                   timeout=BUILD_TIMEOUT_S)
    build_seconds[name] = time.perf_counter() - t0
    os.replace(tmp, so)


def _get(name: str, configure) -> Optional[ctypes.CDLL]:
    """The loaded library ``<name>.cpp`` (built on first use), or None when
    it cannot be built or loaded; ``configure(lib)`` declares prototypes."""
    if name in _libs:
        return _libs[name]
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        try:
            so = _lib_path(name)
            if not os.path.exists(so):
                _build(name, so)
            lib = ctypes.CDLL(so)
            configure(lib)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"voxelrs_tpu_torch.native: {name} unavailable ({e}); "
                  "using the numpy serializer", flush=True)
            lib = None
        _libs[name] = lib
    return lib


def _cfg_esvo(lib):
    P32, P8 = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8)
    lib.esvo_serialize_chunk.restype = ctypes.c_uint32
    lib.esvo_serialize_chunk.argtypes = [P32, ctypes.c_int, P32,
                                         ctypes.c_uint32, P8]


def _cfg_csvo(lib):
    P32, P8 = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8)
    lib.csvo_serialize_chunk.restype = ctypes.c_uint32
    lib.csvo_serialize_chunk.argtypes = [P32, ctypes.c_int, P8,
                                         ctypes.c_uint32, P32,
                                         ctypes.c_uint32, P32, P8]


def esvo_lib() -> Optional[ctypes.CDLL]:
    return _get("esvo_native", _cfg_esvo)


def csvo_lib() -> Optional[ctypes.CDLL]:
    return _get("csvo_native", _cfg_csvo)


def loaded() -> dict:
    """{library name: True if built and loaded} for both serializers."""
    return {"esvo_native": esvo_lib() is not None,
            "csvo_native": csvo_lib() is not None}


def _p(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def serialize_chunk_native(voxels: np.ndarray, lod: int):
    """Native ESVO chunk serialization; returns (buffer, (child_mask,
    leaf_mask, depth)), or None when the library is unavailable or the
    output overflowed (the caller then takes the numpy path)."""
    lib = esvo_lib()
    if lib is None:
        return None
    vox = np.ascontiguousarray(voxels, dtype=np.uint32)
    # worst case: every voxel present => sum_{l=0..4} 8^l blocks * 12 words
    cap = 4681 * 12 + 16
    out = np.empty(cap, np.uint32)
    meta = np.zeros(3, np.uint8)
    n = lib.esvo_serialize_chunk(_p(vox, ctypes.c_uint32), int(lod),
                                 _p(out, ctypes.c_uint32), cap,
                                 _p(meta, ctypes.c_uint8))
    if n == 0xFFFFFFFF:
        return None
    return out[:n].copy(), (int(meta[0]), int(meta[1]), int(meta[2]))


def serialize_csvo_native(voxels: np.ndarray, lod: int):
    """Native CSVO chunk serialization; returns (node bytes, materials,
    effective cut) with node bytes and materials None for an empty chunk,
    or None when the library is unavailable or the output overflowed."""
    lib = csvo_lib()
    if lib is None:
        return None
    vox = np.ascontiguousarray(voxels, dtype=np.uint32)
    # a full chunk has 4681 nodes; internal ones take <= 2 + 8*4 bytes
    node_cap = 1 << 17
    out = np.empty(node_cap, np.uint8)
    mats = np.empty(32768, np.uint32)
    mat_len = np.zeros(1, np.uint32)
    cut = np.zeros(1, np.uint8)
    n = lib.csvo_serialize_chunk(_p(vox, ctypes.c_uint32), int(lod),
                                 _p(out, ctypes.c_uint8), node_cap,
                                 _p(mats, ctypes.c_uint32), 32768,
                                 _p(mat_len, ctypes.c_uint32),
                                 _p(cut, ctypes.c_uint8))
    if n == 0xFFFFFFFF:
        return None
    if n == 0:
        return None, None, int(cut[0])
    return out[:n].copy(), mats[: int(mat_len[0])].copy(), int(cut[0])
