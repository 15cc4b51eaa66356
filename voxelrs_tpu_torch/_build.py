"""Build and bind the CUDA kernels (K1, K3, K4, K5, K6, K7, K8, the
deferred frame's stages, K9, K9-judged and P0; K10 is the opaque frame's
stages with a pose dimension): one ``nvcc`` call, a plain C interface,
``ctypes``.

At first use ``library()`` compiles ``csrc/kernels.cu`` into
``_build/<sha256 of sources and flags>/libvoxelrs_kernels.so`` (a directory
that .gitignore lists) and loads it. A finished library is reused; the build
writes to a temporary name and renames, so an interrupted build leaves no
partial library and no lock behind. Nothing here includes PyTorch's headers:
pointers and the stream cross as ``ctypes.c_void_p`` integers.

The library is loaded as a ``ctypes.PyDLL``: its entry points only
enqueue work, so they run holding the interpreter lock instead of giving
it up and waiting for it again behind the job threads. Each launch
function checks the C entry point's return value
(``cudaGetLastError()`` after the launch) and raises if it is not 0. None of
them synchronises. K3 and K5 take the world as an ESVO buffer (an int32
tensor) or a CSVO world (``(words, root_ptr, total_depth)``, as
``ops.traversal_csvo.CsvoBuffer``) and launch that format's instantiation;
so do the deferred stages that trace (``launch_kd_primary``,
``launch_kd_shadow``, ``launch_k9_trace``, ``launch_k9j_trace``); each
refuses CSVO words off a 16-byte word (``csvo_words``). Optional
pointers (a floor, an index list, a count) cross as None for "absent".
The opaque frame's stages take ``cams`` — None for one frame, or the (N,
12) float32 cameras of a pose batch (K10), whose lanes are pose-major —
and the batch's sizes follow from their outputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("csrc/kernels.cu", "csrc/k1_traversal.cuh",
            "csrc/k4_csvo_traversal.cuh", "csrc/k6_compact.cuh",
            "csrc/k7_beams.cuh", "csrc/k8_sun.cuh", "csrc/k9_adaptive.cuh",
            "csrc/k9_judged.cuh", "csrc/p0_gather.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 180
LIB_NAME = "libvoxelrs_kernels.so"

_lib = None
# nvcc's output (with the -Xptxas -v register/spill lines), kept beside the
# library as build.log, and read from there when a finished library is
# reused
build_log = ""
build_seconds = 0.0  # 0.0 when a finished library was reused

MAX_LEVELS = 8
MAX_BEAM_LEVELS = 16  # envelope pyramid levels (csrc/k7_beams.cuh)
K6_TILE = 8192  # mask lanes of a K6 tile (csrc/k6_compact.cuh)
HIT_WORDS = 9  # words of a deferred hit record (kernels.cu HitRec)
# lanes casting a task in a pick (kernels.cu K5_SEGMENTS, which a pick
# uses): 32 beat 1 and 8 on the games' sweeps and longest chains (PERF.md §6)
K5_SEGMENTS = 32
K9_WORDS = 8  # words of a K9 record (k9_adaptive.cuh K9Rec)
K9J_WORDS = 16  # words of a K9-judged record (k9_judged.cuh K9JRec)


class TexTables(ctypes.Structure):
    """Mirror of ``vx::TexTables`` (csrc/k1_traversal.cuh)."""

    _fields_ = [
        ("atlas", ctypes.c_void_p),
        ("level_h", ctypes.c_int * MAX_LEVELS),
        ("level_w", ctypes.c_int * MAX_LEVELS),
        ("level_off", ctypes.c_int * MAX_LEVELS),
        ("n_levels", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("mat_tex", ctypes.c_void_p),
        ("mat_rows", ctypes.c_int),
        ("mat_cols", ctypes.c_int),
        ("mat_params", ctypes.c_void_p),
        ("pair_color", ctypes.c_void_p),
        ("pair_normal", ctypes.c_void_p),
        ("pair_cap", ctypes.c_int),
    ]


_F3 = ctypes.c_float * 3


class FrameParams(ctypes.Structure):
    """Mirror of ``vx::FrameParams`` (csrc/kernels.cu)."""

    _fields_ = [
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("render_shadows", ctypes.c_int),
        ("primary_budget", ctypes.c_int), ("shadow_budget", ctypes.c_int),
        ("trilinear", ctypes.c_int),
        ("cam_pos", _F3), ("right", _F3), ("up", _F3), ("fwd", _F3),
        ("aspect", ctypes.c_float), ("tan_half", ctypes.c_float),
        ("ambient", ctypes.c_float), ("shadow_distance", ctypes.c_float),
        ("light_dir", _F3), ("highlight", _F3),
        ("sky", _F3), ("horizon", _F3),
    ]


class BeamParams(ctypes.Structure):
    """Mirror of ``vx::BeamParams`` (csrc/k7_beams.cuh)."""

    _fields_ = [
        ("offsets", ctypes.c_int * MAX_BEAM_LEVELS),
        ("n_levels", ctypes.c_int), ("n", ctypes.c_int),
        ("hmax", ctypes.c_float), ("max_iters", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("cam_pos", _F3), ("right", _F3), ("up", _F3), ("fwd", _F3),
        ("tan_half", ctypes.c_float), ("aspect", ctypes.c_float),
        ("max_dst", ctypes.c_float),
        ("near_h", ctypes.c_float * 25), ("near_base", ctypes.c_float * 2),
    ]


class SunParams(ctypes.Structure):
    """Mirror of ``vx::SunParams`` (csrc/k8_sun.cuh)."""

    _fields_ = [
        ("n1", ctypes.c_int), ("width", ctypes.c_int),
        ("d_len", ctypes.c_float), ("margin", ctypes.c_float), ("d", _F3),
        ("origin", ctypes.c_float * 2),
    ]


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_digest() -> str:
    h = hashlib.sha256()
    for rel in _SOURCES:
        with open(os.path.join(_HERE, rel), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    out_dir = os.path.join(_HERE, "_build", source_digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "build.log")
    if os.path.exists(lib_path) and os.path.exists(log_path):
        with open(log_path) as f:  # the reused library's own build
            build_log = f.read()
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = os.path.join(out_dir, f".{LIB_NAME}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_HERE, "csrc", "kernels.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        with open(tmp + ".log", "w") as f:
            f.write(build_log)
        os.replace(tmp + ".log", log_path)
        os.replace(tmp, lib_path)
    # PyDLL: a launch is a microseconds-long enqueue, so the calls keep the
    # interpreter lock; a CDLL call releases it, and under the game's busy
    # job threads each re-acquisition can wait a switch interval (5 ms)
    _lib = bind(ctypes.PyDLL(lib_path))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and return types of every entry point of ``lib``
    (a library built from csrc/kernels.cu) and return it."""
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.vx_k1_traverse.argtypes = [P, LL, F, P, P, P, I, I, I, P,
                                   P, P, P, P, P, P, P, P, P, P]
    lib.vx_k1_traverse.restype = I
    lib.vx_k3_frame.argtypes = [P, LL, F, P, P, P, P, P, P]
    lib.vx_k3_frame.restype = I
    lib.vx_k5_picker.argtypes = [P, LL, F, P, I, I, I, P, P, P]
    lib.vx_k5_picker.restype = I
    lib.vx_k5_pick.argtypes = [P, LL, F, P, P, I, I, P, P, P]
    lib.vx_k5_pick.restype = I
    U = ctypes.c_uint
    lib.vx_k4_traverse.argtypes = [P, LL, F, U, I, P, P, P, I, I, I, P,
                                   P, P, P, P, P, P, P, P, P, P]
    lib.vx_k4_traverse.restype = I
    lib.vx_k3_frame_csvo.argtypes = [P, LL, F, U, I, P, P, P, P, P, P]
    lib.vx_k3_frame_csvo.restype = I
    lib.vx_k5_picker_csvo.argtypes = [P, LL, F, U, I, P, I, I, I, P, P, P]
    lib.vx_k5_picker_csvo.restype = I
    lib.vx_k5_pick_csvo.argtypes = [P, LL, F, U, I, P, P, I, I, P, P, P]
    lib.vx_k5_pick_csvo.restype = I
    for name, args in (
            ("vx_k6_compact", [P, I, I, P, P, P, U, I, P, P]),
            ("vx_k7_tiles", [P, P, P, P, P]),
            ("vx_k7_shadow", [P, P, P, P, P, P, P, P, I, P, P]),
            ("vx_k8_sun", [P, P, P, P, P, P, I, P, P, P, P, P]),
            ("vx_kd_primary", [P, LL, F, P, P, P, I, I, P, I, P, P, P, P]),
            ("vx_kd_primary_csvo", [P, LL, F, U, I, P, P, P, I, I, P, I, P,
                                    P, P, P]),
            ("vx_kd_shade", [P, P, P, P, P, I, P, P, P, P, P, P, P]),
            ("vx_kd_shadow", [P, LL, F, P, P, I, P, P, P, P, P, P, I, P, P]),
            ("vx_kd_shadow_csvo", [P, LL, F, U, I, P, P, I, P, P, P, P, P, P,
                                   I, P, P]),
            ("vx_kd_finish", [P, P, P, P, I, P, P, P, P, P, P, P, P]),
            ("vx_k9_trace", [P, LL, F, P, P, P, I, I, P, P, I, I, P, P]),
            ("vx_k9_trace_csvo", [P, LL, F, U, I, P, P, P, I, I, P, P, I, I,
                                  P, P]),
            ("vx_k9_merge", [F, P, P, I, I, P, P, P, P]),
            ("vx_k9_finalize", [F, P, P, I, P, P, P, P, P, P, P]),
            ("vx_k9_shadow_cells", [I, P, P, P, P, I, I, P, P, P, P, P, P,
                                    P, P, P]),
            ("vx_k9j_trace", [P, LL, F, P, P, P, I, I, P, P, I, P, P]),
            ("vx_k9j_trace_csvo", [P, LL, F, U, I, P, P, P, I, I, P, P, I,
                                   P, P]),
            ("vx_k9j_merge", [F, P, P, I, I, P, P, P, P, P]),
            ("vx_k9j_finalize", [P, P, P, P, P, P, P, P]),
            ("vx_p0_gather", [I, P, I, P, I, I, P, P])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = I
    return lib


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_aligned(name, t, nbytes: int = 16):
    """Refuse a tensor that a kernel moves in ``nbytes``-byte words from
    its first element: at an address that is not a multiple of ``nbytes``
    the words fault on the card or miss lanes."""
    off = t.data_ptr() % nbytes
    if off:
        raise ValueError(f"{name}: expected a {nbytes}-byte aligned tensor "
                         f"(a view at byte {off} of a {nbytes}-byte word)")


_FLAGS = (torch.bool, torch.uint8)


def csvo_words(world):
    """None for an ESVO buffer; for a CSVO world its ``(words, root_ptr,
    total_depth)``, refusing ``words`` off a 16-byte word, the launch
    contract of the CSVO kernels (``ops.traversal_csvo.check_words``)."""
    if isinstance(world, torch.Tensor):
        return None
    words, root_ptr, depth = world
    check_aligned("words", words)
    return words, root_ptr, depth


def _check_words(name, t, dtypes, lanes: int, nbytes: int):
    """Refuse a 1-d array that a kernel reads in ``nbytes``-byte words
    from lane 0 over ``lanes`` lanes."""
    if t.dtype not in dtypes or t.dim() != 1 or t.shape[0] < lanes \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-d "
                         f"{'/'.join(map(str, dtypes))} tensor of >= {lanes} "
                         "lanes")
    check_aligned(name, t, nbytes)


def _check_pixels(name, t):
    """Refuse what a kernel cannot move as 4-float pixels (16-byte
    words)."""
    if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() % 4:
        raise ValueError(f"{name}: expected a contiguous float32 tensor of "
                         "4-float pixels")
    check_aligned(name, t)


def check_kd_finish(sidx, color, blk, todo, traced, img):
    """Refuse what ``kd_finish``'s kernel cannot take: it reads a
    thread's 4 candidate slots of the list's ``sidx.shape[0]`` as one
    16-byte word of ``sidx`` and one 4-byte word of each flag array
    (``traced``, and ``blk`` and ``todo`` where given), gathers a colour
    and writes a pixel of ``img`` as 16-byte words."""
    size = sidx.shape[0]
    _check_words("sidx", sidx, (torch.int32,), size, 16)
    if (blk is None) != (todo is None):
        raise ValueError("blk, todo: expected both or neither")
    for name, t in (("traced", traced), ("blk", blk), ("todo", todo)):
        if t is not None:
            _check_words(name, t, _FLAGS, size, 4)
    _check_pixels("color", color)
    _check_pixels("img", img)


def launch_k1(desc, octree_scale, ro, rd, max_dst, budget, alpha_mode,
              tables, t, value, face, pos, uv, lod, inside, steps,
              t_floor=None):
    """Launch K1 on the current stream (inputs checked by the caller);
    ``t_floor`` None or the (B,) float32 entry floors."""
    lib = library()
    tex = None if tables is None else ctypes.byref(tables.struct)
    err = lib.vx_k1_traverse(
        _ptr(desc), desc.shape[0], octree_scale, _ptr(ro), _ptr(rd),
        _ptr(max_dst), ro.shape[0], budget, alpha_mode, tex, _ptr(t),
        _ptr(value), _ptr(face), _ptr(pos), _ptr(uv), _ptr(lod), _ptr(inside),
        _ptr(steps), _ptr(t_floor), _stream(desc.device))
    _raise_on(err, "K1 (vx_k1_traverse)")


def tile_lanes(width: int, height: int, device=None):
    """The lane of each work item of a launch over a ``width`` x ``height``
    grid in 4x8 tiles a warp (csrc/kernels.cu ``tile_lane`` with no list:
    K3's pixels, K9's and K9-judged's grid traces), -1 past the grid's last
    row or column; item m runs in warp m // 32. Its length is the launch's
    item count (csrc/kernels.cu ``tile_items``)."""
    tx, ty = -(-width // 8), -(-height // 4)
    m = torch.arange(tx * ty * 32, device=device)
    t, lane = m // 32, m % 32
    y = t // tx * 4 + lane // 8
    x = t % tx * 8 + lane % 8
    return torch.where((y < height) & (x < width), y * width + x,
                       torch.full_like(m, -1))


def check_k3(img, steps=None):
    """Refuse what K3 cannot write: it stores each pixel of ``img`` as one
    16-byte word from pixel 0, and each pixel's steps into ``steps`` (None,
    or a contiguous int32 tensor of a lane a pixel)."""
    _check_pixels("img", img)
    if steps is not None and (steps.dtype != torch.int32
                              or not steps.is_contiguous()
                              or steps.numel() * 4 != img.numel()):
        raise ValueError("steps: expected a contiguous int32 tensor of a "
                         "lane a pixel")


_k3_tiles = {}  # (device, stream) -> K3's tile counters


def k3_tiles(device) -> torch.Tensor:
    """K3's tile counters for the current stream of ``device``: 2 int32,
    zeroed when allocated. A launch's warps take their tiles from them and
    its last warp sets them back to 0; a stream runs its launches one after
    another, so each stream has its own."""
    key = (device, _stream(device).value)
    if key not in _k3_tiles:
        _k3_tiles[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _k3_tiles[key]


def launch_k3(world, octree_scale, tables, params: FrameParams, img,
              steps=None):
    """Launch K3 on the current stream, the ESVO or the CSVO instantiation
    by ``world`` (the world and tables checked by the caller; ``img``, its
    (H, W, 4) float32 frame, here: ``check_k3``), its tiles taken from the
    stream's counters (``k3_tiles``). ``steps``, a diagnostic no wrapper
    passes, is None or a contiguous (H*W,) int32 tensor that receives each
    pixel's traversal steps, primary plus shadow."""
    check_k3(img, steps)
    csvo = csvo_words(world)
    lib = library()
    tail = (ctypes.byref(tables.struct), ctypes.byref(params),
            _ptr(k3_tiles(img.device)), _ptr(img), _ptr(steps))
    if csvo is None:
        err = lib.vx_k3_frame(_ptr(world), world.shape[0], octree_scale,
                              *tail, _stream(world.device))
    else:
        words, root_ptr, depth = csvo
        err = lib.vx_k3_frame_csvo(_ptr(words), words.shape[0], octree_scale,
                                   root_ptr, depth, *tail,
                                   _stream(words.device))
    _raise_on(err, "K3 (vx_k3_frame)")


def launch_k4(words, octree_scale, root_ptr, total_depth, ro, rd, max_dst,
              budget, alpha_mode, tables, t, value, face, pos, uv, lod,
              inside, steps, t_floor=None):
    """Launch K4 on the current stream (inputs checked by the caller;
    ``words`` refused off a 16-byte word, as ``csvo_words`` refuses it);
    ``t_floor`` None or the (B,) float32 entry floors."""
    check_aligned("words", words)
    lib = library()
    tex = None if tables is None else ctypes.byref(tables.struct)
    err = lib.vx_k4_traverse(
        _ptr(words), words.shape[0], octree_scale, root_ptr, total_depth,
        _ptr(ro), _ptr(rd), _ptr(max_dst), ro.shape[0], budget, alpha_mode,
        tex, _ptr(t), _ptr(value), _ptr(face), _ptr(pos), _ptr(uv), _ptr(lod),
        _ptr(inside), _ptr(steps), _ptr(t_floor), _stream(words.device))
    _raise_on(err, "K4 (vx_k4_traverse)")


def launch_k5(world, octree_scale, tasks, budget, out, steps=None,
              segments=K5_SEGMENTS):
    """Launch K5 on the current stream (inputs checked by the caller), the
    ESVO or the CSVO instantiation by ``world``: ``tasks`` (n >= 1, 7)
    float32, ``out`` (n, 8) float32, ``segments`` lanes casting each task
    (1-32; csrc/kernels.cu ``k5_picker_kernel``; a pick casts with
    ``K5_SEGMENTS``, the other counts are timed and tested only).
    ``steps``, a diagnostic no wrapper passes, is None or a contiguous (n,)
    int32 tensor that receives each task's chain: the steps of its longest
    lane, plus the whole ray's where lane 0 cast it after all."""
    if not 1 <= segments <= 32:
        raise ValueError(f"segments: expected 1-32 lanes a task, got "
                         f"{segments}")
    csvo = csvo_words(world)
    lib = library()
    tail = (_ptr(tasks), tasks.shape[0], budget, segments, _ptr(out),
            _ptr(steps))
    if csvo is None:
        err = lib.vx_k5_picker(_ptr(world), world.shape[0], octree_scale,
                               *tail, _stream(world.device))
    else:
        words, root_ptr, depth = csvo
        err = lib.vx_k5_picker_csvo(_ptr(words), words.shape[0],
                                    octree_scale, root_ptr, depth, *tail,
                                    _stream(words.device))
    _raise_on(err, "K5 (vx_k5_picker)")


def check_k5_pick(world, n, host_tasks, dev_tasks, dev_rows, host_rows):
    """Refuse what one pick (``launch_k5_pick``) cannot take: every buffer
    a contiguous float32 tensor of at least ``n`` (>= 1) rows, the tasks'
    7 floats a row and the rows' 8, the two device buffers on the world's
    device and the two host buffers in host memory. It reads only a
    tensor's attributes, so it keeps the interpreter lock; that the host
    buffers are pinned is ``check_pinned``'s, once (a pageable buffer
    would make the copies synchronous, not wrong)."""
    if n < 1:
        raise ValueError(f"n: expected at least 1 task, got {n}")
    dev = (world if isinstance(world, torch.Tensor) else world[0]).device
    for name, x, width in (("host_tasks", host_tasks, 7),
                           ("dev_tasks", dev_tasks, 7),
                           ("dev_rows", dev_rows, 8),
                           ("host_rows", host_rows, 8)):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.numel() < width * n):
            raise ValueError(f"{name}: expected a contiguous float32 tensor "
                             f"of >= {n} rows of {width}")
    for name, x, want in (("dev_tasks", dev_tasks, dev),
                          ("dev_rows", dev_rows, dev),
                          ("host_tasks", host_tasks, torch.device("cpu")),
                          ("host_rows", host_rows, torch.device("cpu"))):
        if x.device != want:
            raise ValueError(f"{name}: on {x.device}, expected {want}")


def check_pinned(name, t):
    """Refuse a host buffer that is not in pinned memory."""
    if t.device.type != "cpu" or not t.is_pinned():
        raise ValueError(f"{name}: expected a tensor in pinned host memory")


def launch_k5_pick(world, octree_scale, n, budget, host_tasks, dev_tasks,
                   dev_rows, host_rows):
    """One pick in one native call on the current stream of the world's
    device (``check_k5_pick``): the first ``n`` tasks of ``host_tasks``
    (pinned: ``check_pinned``) go to ``dev_tasks``, K5 casts them into
    ``dev_rows`` (``K5_SEGMENTS`` lanes a task), and their rows are in
    ``host_rows`` when it returns. The library is a ``ctypes.PyDLL``, so
    the call keeps the interpreter lock from the upload to the rows."""
    check_k5_pick(world, n, host_tasks, dev_tasks, dev_rows, host_rows)
    csvo = csvo_words(world)
    lib = library()
    tail = (_ptr(host_tasks), _ptr(dev_tasks), n, budget, _ptr(dev_rows),
            _ptr(host_rows))
    if csvo is None:
        err = lib.vx_k5_pick(_ptr(world), world.shape[0], octree_scale,
                             *tail, _stream(world.device))
    else:
        words, root_ptr, depth = csvo
        err = lib.vx_k5_pick_csvo(_ptr(words), words.shape[0], octree_scale,
                                  root_ptr, depth, *tail,
                                  _stream(words.device))
    _raise_on(err, "K5 (vx_k5_pick)")


def k6_blocks(n: int) -> int:
    """K6's scratch length in int32 words for an ``n``-lane mask: the tile
    counter, a spare word, 8-byte alignment and one 64-bit status word per
    tile of K6_TILE lanes (the mask may start at any byte). The scratch is
    zeroed when it is allocated and then used by K6 alone."""
    return 4 + 2 * max(1, -(-(n + 15) // K6_TILE))


_k6_epoch = 0  # the last K6 call's epoch (1..2^30-1, its status words' tag)


def launch_k6(mask, size, out, count, scratch, starts=None):
    """Launch K6 (one kernel) on the current stream: ``mask`` (n,) bool,
    ``out`` (size,) int32, ``count`` (1,) int32, ``scratch``
    (>= k6_blocks(n),) int32, zeroed when allocated; ``starts`` None or
    (m,) int32, m dividing n, which receives the rank of every (n / m)-th
    lane. Each call tags its status words with a new epoch, so the status
    words of an earlier call on the same scratch read as not ready."""
    global _k6_epoch
    _k6_epoch = _k6_epoch % ((1 << 30) - 1) + 1
    seg = 0 if starts is None else mask.shape[0] // starts.shape[0]
    err = library().vx_k6_compact(_ptr(mask), mask.shape[0], size, _ptr(out),
                                  _ptr(count), _ptr(scratch), _k6_epoch, seg,
                                  _ptr(starts), _stream(mask.device))
    _raise_on(err, "K6 (vx_k6_compact)")


def launch_k7_tiles(levels, bounds, params: BeamParams, out):
    """Launch K7's tile kernel: ``out`` (nty, ntx) float32."""
    err = library().vx_k7_tiles(_ptr(levels), _ptr(bounds),
                                ctypes.byref(params), _ptr(out),
                                _stream(levels.device))
    _raise_on(err, "K7 (vx_k7_tiles)")


def check_k7_shadow(out):
    """Refuse an output K7's shadow kernel cannot take: it writes the
    pads of ``out`` as 16-byte words from lane 0."""
    if out.dtype != torch.float32 or out.dim() != 1 \
            or not out.is_contiguous():
        raise ValueError("out: expected a contiguous (k,) float32 tensor")
    check_aligned("out", out)


def launch_k7_shadow(levels_e, h3d0, bounds, params: BeamParams, ro, max_dst,
                     idx, count, out):
    """Launch K7's shadow kernel: ``out`` (k,) float32 (its lanes),
    whose pads it writes as 16-byte words; ``max_dst`` None = all
    unbounded."""
    check_k7_shadow(out)
    err = library().vx_k7_shadow(
        _ptr(levels_e), _ptr(h3d0), _ptr(bounds), ctypes.byref(params),
        _ptr(ro), _ptr(max_dst), _ptr(idx), _ptr(count), out.shape[0],
        _ptr(out), _stream(ro.device))
    _raise_on(err, "K7 (vx_k7_shadow)")


def check_k8(sb_words, k, lit, blk, todo, floors):
    """Refuse what K8's kernel cannot take: it reads the sun table
    ``sb_words`` in 4-byte (or wider) words from its first row, and writes
    the pads of each output that is not None (``lit``/``blk``/``todo``
    flags, ``floors`` float32, >= ``k`` lanes) as 16-byte words from lane
    0."""
    if sb_words.dtype != torch.int16 or sb_words.dim() != 2 \
            or sb_words.shape[1] % 2 or not sb_words.is_contiguous():
        raise ValueError("sb_words: expected a contiguous (rows, 76+2K) "
                         "int16 tensor")
    check_aligned("sb_words", sb_words, 4)
    for name, t in (("lit", lit), ("blk", blk), ("todo", todo)):
        if t is not None:
            _check_words(name, t, _FLAGS, k, 16)
    if floors is not None:
        _check_words("floors", floors, (torch.float32,), k, 16)


def launch_k8(sb_words, params: SunParams, ro, max_dst, idx, count, k, lit,
              blk, todo, floors):
    """Launch K8 over ``k`` lanes: each of ``lit``/``blk``/``todo`` ((k,)
    bool) and ``floors`` ((k,) float32) is None or receives its output,
    on a 16-byte word (``check_k8``); ``max_dst`` None = all
    unbounded."""
    check_k8(sb_words, k, lit, blk, todo, floors)
    err = library().vx_k8_sun(
        _ptr(sb_words), ctypes.byref(params), _ptr(ro), _ptr(max_dst),
        _ptr(idx), _ptr(count), k, _ptr(lit), _ptr(blk), _ptr(todo),
        _ptr(floors), _stream(ro.device))
    _raise_on(err, "K8 (vx_k8_sun)")


def _poses(cams) -> int:
    return 1 if cams is None else cams.shape[0]


def check_kd_primary(rec, hit, img):
    """Refuse what ``kd_primary``'s kernel cannot take: it stores a
    block's hit records ``rec`` and flags ``hit`` as 16-byte words from
    lane 0, and a miss's pixel of ``img`` as one 16-byte word."""
    for name, t in (("rec", rec), ("hit", hit), ("img", img)):
        check_aligned(name, t)


def launch_kd_primary(world, octree_scale, tables, params: FrameParams,
                      alpha_mode, tf, rec, hit, img, cams=None):
    """The deferred frame's primary stage: ``tf`` None or the (nty, ntx)
    tile floors ((N, nty, ntx) for a batch), ``rec`` (N*H*W, 9) int32 hit
    records, ``hit`` (N*H*W,) bool, ``img`` (N, H, W, 4) float32 (its sky
    pixels); N = 1 and ``cams`` None for one frame. Refuses views its
    kernel's words cannot take (``check_kd_primary``)."""
    check_kd_primary(rec, hit, img)
    csvo = csvo_words(world)
    lib = library()
    ntx = 0 if tf is None else tf.shape[-1]
    tail = (ctypes.byref(tables.struct), ctypes.byref(params), _ptr(cams),
            _poses(cams), alpha_mode, _ptr(tf), ntx, _ptr(rec), _ptr(hit),
            _ptr(img))
    if csvo is None:
        err = lib.vx_kd_primary(_ptr(world), world.shape[0], octree_scale,
                                *tail, _stream(world.device))
    else:
        words, root_ptr, depth = csvo
        err = lib.vx_kd_primary_csvo(_ptr(words), words.shape[0],
                                     octree_scale, root_ptr, depth, *tail,
                                     _stream(words.device))
    _raise_on(err, "deferred primary (vx_kd_primary)")


def launch_kd_shade(tables, params: FrameParams, hidx, hcount, rec, color, ds,
                    need, sro, img, cams=None):
    """The deferred frame's shading stage over the compacted hit lanes
    (of all the poses of ``cams``)."""
    err = library().vx_kd_shade(
        ctypes.byref(tables.struct), ctypes.byref(params), _ptr(cams),
        _ptr(hidx), _ptr(hcount), hidx.shape[0], _ptr(rec), _ptr(color),
        _ptr(ds), _ptr(need), _ptr(sro), _ptr(img), _stream(img.device))
    _raise_on(err, "deferred shade (vx_kd_shade)")


def launch_kd_shadow(world, octree_scale, tables, params: FrameParams,
                     alpha_mode, sro, sidx, scount, tidx, tcount, floors,
                     traced):
    """The deferred frame's shadow trace over the candidates (or, with
    ``tidx``, their uncertified sub-list); ``floors`` None or per
    candidate."""
    csvo = csvo_words(world)
    lib = library()
    tail = (ctypes.byref(tables.struct), ctypes.byref(params), alpha_mode,
            _ptr(sro), _ptr(sidx), _ptr(scount), _ptr(tidx), _ptr(tcount),
            _ptr(floors), sidx.shape[0], _ptr(traced))
    if csvo is None:
        err = lib.vx_kd_shadow(_ptr(world), world.shape[0], octree_scale,
                               *tail, _stream(world.device))
    else:
        words, root_ptr, depth = csvo
        err = lib.vx_kd_shadow_csvo(_ptr(words), words.shape[0],
                                    octree_scale, root_ptr, depth, *tail,
                                    _stream(words.device))
    _raise_on(err, "deferred shadow (vx_kd_shadow)")


def launch_kd_finish(params: FrameParams, hidx, sidx, scount, color, ds, blk,
                     todo, traced, img, blkp=None):
    """The deferred frame's last stage: the blocked candidates' colour
    (``blk``/``todo``: K8's certificates and the lanes left to trace, or
    None when every candidate was traced); ``blkp`` None or the (H*W,)
    bool pixel-space verdicts it writes (K9's first shadow pass). Refuses
    views its kernel's words cannot take (``check_kd_finish``)."""
    check_kd_finish(sidx, color, blk, todo, traced, img)
    err = library().vx_kd_finish(
        ctypes.byref(params), _ptr(hidx), _ptr(sidx), _ptr(scount),
        sidx.shape[0], _ptr(color), _ptr(ds), _ptr(blk), _ptr(todo),
        _ptr(traced), _ptr(img), _ptr(blkp), _stream(img.device))
    _raise_on(err, "deferred finish (vx_kd_finish)")


def launch_k9_trace(world, octree_scale, params: FrameParams, tf, level, out,
                    idx=None, count=None, cams=None):
    """K9's trace of grid level ``level`` into its (n, 8) int32 records
    ``out`` (N times the level's lanes): every lane, or the refine list
    ``idx`` ((size,) int32) up to its device ``count``; ``tf`` None or the
    (nty, ntx) tile floors ((N, nty, ntx) for a batch); ``cams`` None
    (one pose) or the (N, ...) cameras of a batch."""
    csvo = csvo_words(world)
    lib = library()
    size = out.shape[0] if idx is None else idx.shape[0]
    ntx = 0 if tf is None else tf.shape[-1]
    n_poses = 1 if cams is None else cams.shape[0]
    tail = (ctypes.byref(params), _ptr(cams), _ptr(tf), ntx, level,
            _ptr(idx), _ptr(count), size, n_poses, _ptr(out))
    if csvo is None:
        err = lib.vx_k9_trace(_ptr(world), world.shape[0], octree_scale,
                              *tail, _stream(world.device))
    else:
        words, root_ptr, depth = csvo
        err = lib.vx_k9_trace_csvo(_ptr(words), words.shape[0], octree_scale,
                                   root_ptr, depth, *tail,
                                   _stream(words.device))
    _raise_on(err, "K9 trace (vx_k9_trace)")


def launch_k9_merge(octree_scale, params: FrameParams, level, lo, hi, refine,
                    cams=None):
    """K9's merge of the records ``lo`` of level + 1 onto level ``level``:
    ``hi`` (n, 8) int32, ``refine`` (n,) bool (n: N times the level's
    lanes)."""
    err = library().vx_k9_merge(octree_scale, ctypes.byref(params),
                                _ptr(cams), _poses(cams), level, _ptr(lo),
                                _ptr(hi), _ptr(refine), _stream(hi.device))
    _raise_on(err, "K9 merge (vx_k9_merge)")


def launch_k9_finalize(octree_scale, params: FrameParams, frec, rec, hit, img,
                       needp, blkp, cams=None):
    """K9's finalize of the pixel records ``frec`` into the deferred hit
    records ``rec`` (N*H*W, 9), ``hit`` and the sky of ``img``; clears
    ``needp``/``blkp`` ((N*H*W,) bool)."""
    err = library().vx_k9_finalize(octree_scale, ctypes.byref(params),
                                   _ptr(cams), _poses(cams), _ptr(frec),
                                   _ptr(rec), _ptr(hit), _ptr(img),
                                   _ptr(needp), _ptr(blkp), _stream(img.device))
    _raise_on(err, "K9 finalize (vx_k9_finalize)")


def launch_k9_shadow_cells(step, params: FrameParams, hidx, hcount, need,
                           needp, blkp, mask, dense, color, ds, img,
                           hstart=None):
    """K9's shadow cells, ``step`` 1 (pass-1 mask, needp, the dense flags)
    or 2 (the corner reuse and the pass-2 mask), over the compacted hit
    lanes ``hidx`` up to ``hcount``; ``hstart`` None (one frame) or the
    (N,) int32 first hit lane of each pose of a batch."""
    err = library().vx_k9_shadow_cells(
        step, ctypes.byref(params), _ptr(hidx), _ptr(hcount), _ptr(hstart),
        1 if hstart is None else hstart.shape[0], hidx.shape[0],
        _ptr(need), _ptr(needp), _ptr(blkp), _ptr(mask), _ptr(dense),
        _ptr(color), _ptr(ds), _ptr(img), _stream(img.device))
    _raise_on(err, "K9 shadow cells (vx_k9_shadow_cells)")


def launch_k9j_trace(world, octree_scale, tables, params: FrameParams, tf,
                     level, out, idx=None, count=None):
    """K9-judged's trace of grid level ``level`` into its (n, 16) int32
    records ``out``, which it stores as 16-byte words (refused off one):
    every lane, or the refine list ``idx`` ((size,) int32) up to its device
    ``count``; ``tf`` None or the (nty, ntx) tile floors; ``tables`` the
    texture tables the alpha judge reads."""
    check_aligned("out", out)
    csvo = csvo_words(world)
    lib = library()
    size = out.shape[0] if idx is None else idx.shape[0]
    ntx = 0 if tf is None else tf.shape[1]
    tail = (ctypes.byref(tables.struct), ctypes.byref(params), _ptr(tf), ntx,
            level, _ptr(idx), _ptr(count), size, _ptr(out))
    if csvo is None:
        err = lib.vx_k9j_trace(_ptr(world), world.shape[0], octree_scale,
                               *tail, _stream(world.device))
    else:
        words, root_ptr, depth = csvo
        err = lib.vx_k9j_trace_csvo(_ptr(words), words.shape[0],
                                    octree_scale, root_ptr, depth, *tail,
                                    _stream(words.device))
    _raise_on(err, "K9-judged trace (vx_k9j_trace)")


def check_k9j_merge(lo, hi):
    """Refuse what K9-judged's merge kernel cannot take: it loads the
    records ``lo`` and stores ``hi`` as 16-byte words from their first
    record."""
    check_aligned("lo", lo)
    check_aligned("hi", hi)


def launch_k9j_merge(octree_scale, tables, params: FrameParams, level,
                     hole_fill, lo, hi, refine):
    """K9-judged's merge of the records ``lo`` of level + 1 onto level
    ``level``: ``hi`` (n, 16) int32, ``refine`` (n,) bool; the hole table
    is ``tables.hole``. Refuses views its kernel's words cannot take
    (``check_k9j_merge``)."""
    check_k9j_merge(lo, hi)
    err = library().vx_k9j_merge(
        octree_scale, ctypes.byref(tables.struct), ctypes.byref(params),
        level, int(bool(hole_fill)), _ptr(tables.hole), _ptr(lo), _ptr(hi),
        _ptr(refine), _stream(hi.device))
    _raise_on(err, "K9-judged merge (vx_k9j_merge)")


def launch_k9j_finalize(params: FrameParams, frec, rec, hit, img, needp,
                        blkp):
    """K9-judged's finalize of the pixel records ``frec`` into the deferred
    hit records ``rec`` (H*W, 9), ``hit`` and the sky of ``img``; clears
    ``needp``/``blkp`` ((H*W,) bool). Its kernel moves each of them as
    16-byte words from its first element, so a view off one is refused."""
    for name, t in (("frec", frec), ("rec", rec), ("hit", hit), ("img", img),
                    ("needp", needp), ("blkp", blkp)):
        check_aligned(name, t)
    err = library().vx_k9j_finalize(ctypes.byref(params), _ptr(frec),
                                    _ptr(rec), _ptr(hit), _ptr(img),
                                    _ptr(needp), _ptr(blkp),
                                    _stream(img.device))
    _raise_on(err, "K9-judged finalize (vx_k9j_finalize)")


P0_KINDS = ("flat", "axis0", "axis1", "two_step")  # csrc/p0_gather.cuh


def launch_p0(kind, tbl, seeds, steps, out):
    """P0, the gather probe: ``tbl`` (rows, 128) and ``seeds`` / ``out``
    (sub, 128) int32 tensors of u32 words, ``kind`` one of P0_KINDS."""
    err = library().vx_p0_gather(P0_KINDS.index(kind), _ptr(tbl),
                                 tbl.shape[0], _ptr(seeds), seeds.shape[0],
                                 steps, _ptr(out), _stream(tbl.device))
    _raise_on(err, "P0 (vx_p0_gather)")
