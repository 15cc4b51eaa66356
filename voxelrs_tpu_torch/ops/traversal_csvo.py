"""CSVO ray traversal: the plain PyTorch version and the wrapper of kernel K4.

Counterpart: voxelrs_tpu/ops/traversal_csvo.py::intersect_octree_csvo
(:151-567), the classic loop over the byte-compressed node stream
(reference: assets/shaders/svo.csvo.glsl): the Laine–Karras PUSH, ADVANCE
and POP of ``ops/traversal.py`` over unaligned byte reads from the u32 word
buffer (:194-215), the 2-bit pointer-size header decode (:216-228), the
child pointer by node depth (``read_next_ptr`` :229), the per-chunk
material section (``read_leaf`` :271) resolved when a pointer crosses into
a chunk blob, and a node depth packed beside the pointer
(``ptr | depth << 27``) and restored from the stack on POP.

The plain version steps a ``(B,)`` ray batch together, lane-masked, as the
JAX classic loop does, each operation rounded on its own; it serves the CPU
and the comparisons on the card, where it equals K4 field for field. On a
CUDA tensor ``intersect_octree_csvo`` launches K4
(``csrc/k4_csvo_traversal.cuh``), one thread per ray with the stack in
registers. The JAX package's opaque cast runs its CSVO push engine
(:569-1172), TPU structure this package does not carry: both give the same
hits for rays that finish within the step budget.

Unsigned 32-bit words and byte pointers are held in int64 tensors masked to
32 bits, as in ``ops/traversal.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import _build
from .bits import U32_MASK
from .traversal import MAX_STEPS, TraversalResult, _check, trace

# ptr | depth << 27 packing limits the CSVO byte stream to 128 MiB
DEPTH_SHIFT = 27
PTR_MASK = (1 << DEPTH_SHIFT) - 1
MAX_STREAM_BYTES = 1 << DEPTH_SHIFT
INVALID_PTR = 0xFFFFFFFF
# the JAX classic loop runs this many steps per loop iteration
# (``unroll=2``); a ray's step budget is max_steps rounded up to it
UNROLL = 2

f32, i64 = torch.float32, torch.int64


class CsvoBuffer(NamedTuple):
    """A CSVO world on the device: the node byte stream after the 4-byte
    root-offset prefix as u32 words (held in an int32 tensor), the root
    node's byte offset in that stream and the world depth."""

    words: torch.Tensor
    root_ptr: int
    total_depth: int


def step_budget(max_steps: int) -> int:
    """Steps a CSVO ray may take: the JAX classic loop runs ``UNROLL``
    steps per iteration while ``it < max_steps``."""
    return -(-max_steps // UNROLL) * UNROLL


def _popcount(x):
    """Set bits of each 32-bit word (SWAR, exact on int64)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32_MASK) >> 24


def _i32(x):
    """The int32 value (as int64) of the low 32 bits of ``x``."""
    x = x & U32_MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


class CsvoReader:
    """The plain traversal's reads of a CSVO byte stream
    (svo.csvo.glsl:25-133), for ``traversal.traversal_step``. A node cursor
    is ``(pd, mat_ptr, pre_leaf)``: the stack word ptr | depth << 27, the
    current chunk's material section and the last lnode (depth 2) visited.
    A word index past the end reads the last word, as the JAX gather clamps
    it."""

    def __init__(self, words: torch.Tensor, root_ptr: int, total_depth: int):
        self.words = words
        self.last = words.shape[0] - 1
        self.pd0 = (int(root_ptr) & PTR_MASK) | ((int(total_depth)
                                                  << DEPTH_SHIFT) & U32_MASK)

    def root(self, B: int, device) -> tuple:
        def full(v):
            return torch.full((B,), v, dtype=i64, device=device)

        return full(self.pd0), full(INVALID_PTR), full(INVALID_PTR)

    def probe(self, node, octant_idx, active):
        """(is_child, is_leaf, node, (child pointer, crossed)) of child
        ``octant_idx``; the cursor remembers an lnode visited while
        ``active``."""
        pd, mat_ptr, pre_leaf = node
        ptr, depth = pd & PTR_MASK, pd >> DEPTH_SHIFT
        next_ptr, crossed = self.read_next_ptr(ptr, depth, octant_idx)
        is_child = next_ptr != INVALID_PTR
        pre_leaf = torch.where(active & (depth == 2), ptr, pre_leaf)
        return (is_child, is_child & (depth < 2), (pd, mat_ptr, pre_leaf),
                (next_ptr, crossed))

    def leaf_value(self, node, octant_idx):
        pd, mat_ptr, pre_leaf = node
        return self.read_leaf(mat_ptr, pre_leaf, pd & PTR_MASK, octant_idx)

    def push(self, node, octant_idx, carry, want_push) -> tuple:
        """The cursor after descending into the child ``probe`` found where
        ``want_push``. A pointer with bit 31 crosses into a chunk blob:
        [lod u8][material bytes u32][materials][nodes]
        (svo.csvo.glsl:397-409)."""
        pd, mat_ptr, pre_leaf = node
        next_ptr, crossed = carry
        blob_lod = self.read_byte(next_ptr)
        blob_mat_bytes = self.read_u32((next_ptr + 1) & U32_MASK)
        crossed_nodes = (next_ptr + 5 + blob_mat_bytes) & U32_MASK
        depth = torch.where(crossed, blob_lod, (pd >> DEPTH_SHIFT) - 1)
        ptr = torch.where(crossed, crossed_nodes, next_ptr)
        pushed = (ptr & PTR_MASK) | (((depth & U32_MASK) << DEPTH_SHIFT)
                                     & U32_MASK)
        return (torch.where(want_push, pushed, pd),
                torch.where(crossed & want_push, (next_ptr + 5) & U32_MASK,
                            mat_ptr),
                pre_leaf)

    def word(self, i):
        return self.words[torch.clamp(i, max=self.last)]

    def read_u32(self, bp):
        mod = bp & 3
        lo = self.word(bp >> 2)
        hi = self.word((bp >> 2) + 1)
        sh = mod * 8
        return torch.where(mod == 0, lo,
                           ((lo >> sh) | (hi << (32 - sh))) & U32_MASK)

    def read_u16(self, bp):
        return self.read_u32(bp) & 0xFFFF

    def read_byte(self, bp):
        return (self.word(bp >> 2) >> ((bp & 3) * 8)) & 0xFF

    def read_next_ptr(self, ptr, depth, idx):
        """(child pointer or INVALID_PTR, crossed into a chunk blob) of
        child ``idx`` of the node at byte ``ptr`` of kind ``depth``
        (svo.csvo.glsl:53-116)."""
        # internal nodes (depth > 3): u16 header of 2-bit pointer widths
        header16 = self.read_u16(ptr)
        tag = (header16 >> (idx * 2)) & 3
        off_internal = torch.zeros_like(header16)
        ptr_bytes = torch.zeros_like(header16)
        for k in range(8):
            width = (1 << ((header16 >> (2 * k)) & 3)) >> 1
            off_internal = off_internal + torch.where(k < idx, width, 0)
            ptr_bytes = ptr_bytes + width
        raw = self.read_u32((ptr + 2 + off_internal) & U32_MASK)
        width_mask = torch.where(tag >= 3, U32_MASK,
                                 (1 << (((1 << tag) >> 1) * 8)) - 1)
        raw = raw & width_mask
        crossed = (tag == 3) & ((raw & (1 << 31)) != 0)
        internal_ptr = torch.where(crossed, raw ^ (1 << 31),
                                   (ptr + 2 + ptr_bytes + raw) & U32_MASK)
        # byte-masked nodes (depth <= 3): pre-leaf (3) and lnode (2, 1)
        header8 = self.read_byte(ptr)
        bit_set = (header8 >> idx) & 1
        rank = _popcount(header8 & ((1 << idx) - 1))
        n_children = _popcount(header8)
        pre_off = self.read_byte((ptr + 1 + rank) & U32_MASK)
        pre_ptr = (ptr + 1 + n_children + pre_off) & U32_MASK
        leaf_ptr = (ptr + 3 + rank) & U32_MASK
        byte_ptr = torch.where(depth == 3, pre_ptr, leaf_ptr)

        internal = depth > 3
        nxt = torch.where(internal, internal_ptr, byte_ptr)
        valid = torch.where(internal, tag != 0, bit_set != 0)
        return torch.where(valid, nxt, INVALID_PTR), crossed & internal

    def read_leaf(self, mat_ptr, pre_leaf, ptr, idx):
        """Material of leaf bit ``idx`` of the leaf byte at ``ptr``: the
        leaves before it in its lnode index the chunk's material section
        (svo.csvo.glsl:119-133)."""
        mat_off = self.read_u16((pre_leaf + 1) & U32_MASK)
        bit_mark = _i32(_i32(ptr - (pre_leaf + 3)) * 8 + idx)
        m0 = torch.where(bit_mark >= 32, U32_MASK,
                         (1 << torch.clamp(bit_mark, 0, 31)) - 1)
        v0 = self.read_u32((pre_leaf + 3) & U32_MASK) & m0
        over = _i32(bit_mark - 32)
        m1 = torch.where(over >= 32, U32_MASK,
                         (1 << torch.clamp(over, 0, 31)) - 1)
        m1 = torch.where(over <= 0, 0, m1)
        v1 = self.read_u32((pre_leaf + 7) & U32_MASK) & m1
        preceding = _popcount(v0) + _popcount(v1)
        return self.read_u32((mat_ptr + mat_off * 4 + preceding * 4)
                             & U32_MASK)


def intersect_octree_csvo_plain(words, octree_scale, root_ptr, total_depth,
                                ro, rd, max_dst, cast_translucent: bool,
                                alpha_fn: Optional[Callable] = None,
                                max_steps: int = MAX_STEPS,
                                t_floor: Optional[torch.Tensor] = None
                                ) -> TraversalResult:
    """The plain PyTorch CSVO traversal (the JAX classic loop,
    lane-masked), floored as ``ops.traversal.init_state`` floors it."""
    reader = CsvoReader(words.to(i64) & U32_MASK, root_ptr, total_depth)
    return trace(reader, octree_scale, ro, rd, max_dst,
                 alpha_fn if cast_translucent else None,
                 step_budget(max_steps), t_floor)


# ---------------------------------------------------------------------------
# Kernel K4
# ---------------------------------------------------------------------------

launches = 0  # K4 launches by intersect_octree_csvo (the wrapper below)


def check_words(words: torch.Tensor, root_ptr: int, total_depth: int):
    """Raise unless ``words`` is a contiguous 1-d int32 word buffer that
    starts on a 16-byte word and the root pointer and depth fit the
    stack's ``ptr | depth << 27``. Every CSVO launch path runs it. The
    16-byte start is the launch contract of the CSVO kernels
    (``_build.csvo_words``); ``Svo.device_buf``, a fresh allocation,
    meets it."""
    if words.dtype != torch.int32 or words.dim() != 1 \
            or words.shape[0] < 1 or not words.is_contiguous():
        raise ValueError("words: expected a contiguous 1-d int32 buffer")
    _build.check_aligned("words", words)
    if not 0 <= int(root_ptr) < MAX_STREAM_BYTES or \
            not 0 <= int(total_depth) < 32:
        raise ValueError(f"root_ptr {root_ptr} / total_depth {total_depth}"
                         " outside the ptr | depth << 27 packing")


def intersect_octree_csvo(words: torch.Tensor, octree_scale, root_ptr,
                          total_depth, ro, rd, max_dst,
                          cast_translucent: bool,
                          alpha_fn: Optional[Callable] = None,
                          max_steps: int = MAX_STEPS,
                          t_floor: Optional[torch.Tensor] = None
                          ) -> TraversalResult:
    """Trace a batch of rays through the CSVO byte stream.

    Args:
      words: (N,) int32 — the node byte stream after the 4-byte root-offset
        prefix, as little-endian u32 words.
      octree_scale: 2^-total_depth.
      root_ptr: byte offset of the root node inside the stream.
      total_depth: world depth (root levels + chunk lod).
      Everything else as ``ops.traversal.intersect_octree``; ``max_steps``
      is rounded up to a multiple of 2 as the JAX loop rounds it;
      ``t_floor`` the per-ray entry floors (``ops.traversal.init_state``).

    On the CPU this is the plain version; on CUDA tensors it launches K4.
    """
    if not words.is_cuda:
        return intersect_octree_csvo_plain(words, octree_scale, root_ptr,
                                           total_depth, ro, rd, max_dst,
                                           cast_translucent, alpha_fn,
                                           max_steps, t_floor)
    from .shading import AlphaFn

    global launches
    dev = words.device
    B = ro.shape[0]
    check_words(words, root_ptr, total_depth)
    _check("ro", ro, f32, (B, 3), dev)
    _check("rd", rd, f32, (B, 3), dev)
    md = torch.as_tensor(max_dst, dtype=f32, device=dev).expand(B).contiguous()
    if t_floor is not None:
        _check("t_floor", t_floor, f32, (B,), dev)
    judge = alpha_fn if cast_translucent else None
    if judge is not None and not isinstance(judge, AlphaFn):
        raise TypeError("K4 judges texel alpha with make_alpha_fn's sampler "
                        "only; pass alpha_fn=make_alpha_fn(mips, mat_tex)")
    tables = judge.tables if judge is not None else None
    if tables is not None and tables.atlas.device != dev:
        raise ValueError(f"alpha_fn tables on {tables.atlas.device}, "
                         f"expected {dev}")
    alpha_mode = 0 if judge is None else (2 if judge.exact else 1)

    t = torch.empty(B, dtype=f32, device=dev)
    value = torch.empty(B, dtype=torch.int32, device=dev)
    face = torch.empty(B, dtype=torch.int32, device=dev)
    pos = torch.empty((B, 3), dtype=f32, device=dev)
    uv = torch.empty((B, 2), dtype=f32, device=dev)
    lod = torch.empty(B, dtype=f32, device=dev)
    inside = torch.empty(B, dtype=torch.bool, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        _build.launch_k4(words, float(octree_scale), int(root_ptr),
                         int(total_depth), ro, rd, md, step_budget(max_steps),
                         alpha_mode, tables, t, value, face, pos, uv, lod,
                         inside, steps, t_floor)
        launches += 1
    return TraversalResult(t, value.to(i64) & U32_MASK, face, pos, uv, lod,
                           inside, steps)
