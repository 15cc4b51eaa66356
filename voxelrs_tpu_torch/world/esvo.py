"""ESVO — the Laine–Karras-style GPU SVO serialization format.

Binary format (reference: src/world/hds/esvo.rs:74-101): each serialized
octant occupies 12 u32 words:

- words 0..3 (header): per child idx, a 16-bit slot
  ``(child_mask << 8) | leaf_mask`` describing that *child octant's* own
  children. Child idx 0,1 share word 0 (low/high 16 bits), etc. Slots of
  leaf children stay zero.
- words 4..11 (body): per child idx, either the leaf value (u32), or a
  pointer to the child octant — relative pointers carry bit 31 and are
  offsets from the pointer's own word position; absolute pointers (chunk
  boundaries) index the full buffer.

A 5-u32 preamble wraps the root: word 0 = root child_mask << 8, word 4 =
absolute pointer to the root block (reference: esvo.rs:134,179-188).

``serialize_octant`` walks an ``Octree`` depth-first in child-idx order with
LOD clamping; ``Esvo`` manages the world-root octree over serialized chunk
blobs inside a ``RangeBuffer``, replaying a change-set so chunks serialize
once and move by pointer swap (reference: esvo.rs:237-276,439-512).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Protocol

import numpy as np

from .octree import LeafId, Octree, Position, pick_leaf_for_lod
from .rangebuf import RangeBuffer

# The reference uses a 5-word preamble (esvo.rs:134). We pad it to a full
# 12-word block so that EVERY block in the buffer — preamble included — is
# 12-u32 aligned: the traversal kernel then fetches a whole octant
# (header + body) with a single row gather. Words 5..11 are zero; the
# logical layout (word 0 = root child_mask << 8, word 4 = absolute root
# pointer) is unchanged.
PREAMBLE_LENGTH_IN_U32 = 12
RELATIVE_PTR_BIT = 1 << 31

# id under which the serialized root block lives in the RangeBuffer
_ROOT_ID = (1 << 64) - 1


@dataclass(frozen=True)
class SerializationResult:
    """Masks + depth describing one serialized octant
    (reference: esvo.rs:32-44)."""

    child_mask: int
    leaf_mask: int
    depth: int


EMPTY_RESULT = SerializationResult(0, 0, 0)


class Serializable(Protocol):
    def unique_id(self) -> int: ...

    def serialize(self, dst: list[int], lod: int) -> SerializationResult: ...


@dataclass
class ChildEncodeParams:
    parent_id: int
    idx: int
    result: "MutResult"
    dst_offset: int  # start of the parent's 12-word block inside dst
    dst: list[int]
    content: object


class MutResult:
    """Mutable accumulator matching SerializationResult."""

    __slots__ = ("child_mask", "leaf_mask", "depth")

    def __init__(self) -> None:
        self.child_mask = 0
        self.leaf_mask = 0
        self.depth = 0

    def freeze(self) -> SerializationResult:
        return SerializationResult(self.child_mask, self.leaf_mask, self.depth)


def serialize_octant(
    octree: Octree,
    octant_id: int,
    dst: list[int],
    lod: int,
    child_encoder: Callable[[ChildEncodeParams], None],
) -> SerializationResult:
    """Depth-first serialization of one octant into ``dst`` (u32 ints).

    For every ``lod > 0`` the recursion depth is clamped to it; when the clamp
    hits, a representative leaf is picked from the truncated subtree.
    Reference: esvo.rs:439-512.
    """
    start = len(dst)
    dst.extend([0] * 12)

    result = MutResult()
    octant = octree.octants[octant_id]

    for idx in range(8):
        child = octant.children[idx]
        if child is None:
            continue

        result.child_mask |= 1 << idx

        is_leaf = child[0] == "l"
        if is_leaf or lod == 1:
            content = child[1] if is_leaf else None
            if content is None and child[0] == "o":
                content = pick_leaf_for_lod(octree, octree.octants[child[1]])
            if content is None:
                continue
            child_encoder(
                ChildEncodeParams(
                    parent_id=octant_id,
                    idx=idx,
                    result=result,
                    dst_offset=start,
                    dst=dst,
                    content=content,
                )
            )
        else:
            child_id = child[1]
            child_lod = lod - 1 if lod > 0 else 0
            child_offset = len(dst) - start
            child_result = serialize_octant(octree, child_id, dst, child_lod, child_encoder)

            mask = (child_result.child_mask << 8) | child_result.leaf_mask
            if idx % 2 != 0:
                mask <<= 16
            dst[start + idx // 2] |= mask

            rel = child_offset - 4 - idx
            assert rel & RELATIVE_PTR_BIT == 0, "relative pointer too large"
            dst[start + 4 + idx] = rel | RELATIVE_PTR_BIT

            result.depth = max(result.depth, child_result.depth + 1)

    return result.freeze()


def serialize_block_octree(octree: Octree, lod: int) -> tuple[np.ndarray, SerializationResult]:
    """Serialize an octree of plain u32 block ids (a chunk's content).

    The leaf encoder writes the value into the body and flags the parent's
    leaf mask; leaves have static depth 1 (reference: esvo.rs:369-383).
    """
    if octree.root is None:
        return np.zeros(0, dtype=np.uint32), EMPTY_RESULT

    dst: list[int] = []

    def encode(params: ChildEncodeParams) -> None:
        params.result.leaf_mask |= 1 << params.idx
        params.dst[params.dst_offset + 4 + params.idx] = int(params.content)
        params.result.depth = 1

    result = serialize_octant(octree, octree.root, dst, lod, encode)
    return np.asarray(dst, dtype=np.uint32), result


def _hash_pos(x: int, y: int, z: int) -> int:
    """Deterministic 64-bit id for a chunk position (unique-id for the
    RangeBuffer; the reference hashes ChunkPos, esvo.rs:357-360)."""
    h = 0xCBF29CE484222325
    for v in (x & 0xFFFFFFFF, y & 0xFFFFFFFF, z & 0xFFFFFFFF):
        h ^= v
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class SerializedChunk:
    """A chunk serialized to its ESVO blob at construction time.

    Holds the blob until first inserted into the world SVO, then drops it —
    afterwards the chunk is referenced by absolute pointer only
    (reference: esvo.rs:342-413).
    """

    def __init__(
        self,
        pos,
        buffer: Optional[np.ndarray],
        result: SerializationResult,
        lod: int = 5,
        borrowed_chunk=None,
    ):
        self.pos = pos
        self.lod = lod
        self.buffer = buffer if (buffer is not None and result.depth > 0) else None
        self.result = result
        self.borrowed_chunk = borrowed_chunk
        # bitmask over block values present (bit 63 = "unknown/overflow");
        # lets the renderer prove a world contains no translucent blocks
        self.value_mask = ~0

    @staticmethod
    def from_octree(pos, octree: Octree, lod: int, borrowed_chunk=None) -> "SerializedChunk":
        buf, result = serialize_block_octree(octree, lod)
        return SerializedChunk(pos, buf, result, lod, borrowed_chunk)

    @staticmethod
    def from_voxels(pos, voxels: np.ndarray, lod: int, borrowed_chunk=None) -> "SerializedChunk":
        """Serialize a dense chunk with the native (C++) serializer, or,
        where it is unavailable, the vectorized numpy one (the same
        bytes)."""
        from ..native import serialize_chunk_native

        native = serialize_chunk_native(voxels, lod)
        if native is not None:
            buf, (cm, lm, depth) = native
            result = SerializationResult(cm, lm, depth)
        else:
            from .esvo_dense import serialize_dense_chunk

            buf, result = serialize_dense_chunk(voxels, lod)
        sc = SerializedChunk(pos, buf, result, lod, borrowed_chunk)
        mask = 0
        for v in np.unique(voxels):
            mask |= 1 << min(int(v), 63)
        sc.value_mask = mask
        return sc

    def unique_id(self) -> int:
        return _hash_pos(self.pos.x, self.pos.y, self.pos.z)

    def has_data(self) -> bool:
        return self.buffer is not None

    def take_borrowed_chunk(self):
        chunk, self.borrowed_chunk = self.borrowed_chunk, None
        return chunk

    def serialize(self, dst: list[int], _lod: int) -> SerializationResult:
        if self.buffer is not None:
            dst.extend(int(v) for v in self.buffer)
            self.buffer = None  # free for reuse; see esvo.rs:406-409
        return self.result


@dataclass(frozen=True)
class LeafInfo:
    buf_offset: int  # u32 offset inside the RangeBuffer
    serialization: SerializationResult


class Esvo:
    """World SVO: an octree whose leaves are SerializedChunk blobs, flattened
    into one traversal-ready u32 buffer.

    The root octree re-serializes fully on change with relative pointers;
    chunk blobs serialize once and are indexed with absolute pointers, making
    chunk moves O(1) pointer swaps (reference: esvo.rs:102-199,235-339).
    """

    def __init__(self, capacity: int = 0):
        self.octree = Octree()
        self.change_set: dict[tuple, bool] = {}  # insertion-ordered set
        self.buffer = RangeBuffer(capacity, dtype=np.uint32)
        self.leaf_info: dict[int, LeafInfo] = {}
        self.root_info: Optional[LeafInfo] = None
        # monotone OR of inserted leaves' value masks (reset only on clear)
        self.value_mask = 0

    # -- octree-facing ops (WorldSvo trait, src/world/hds/common.rs:3-15) ----

    def clear(self) -> None:
        self.octree.reset()
        self.change_set.clear()
        self.buffer.clear()
        self.leaf_info.clear()
        self.root_info = None
        self.value_mask = 0

    def set_leaf(self, pos: Position, leaf: SerializedChunk, serialize: bool) -> tuple[LeafId, object]:
        uid = leaf.unique_id()
        self.value_mask |= getattr(leaf, "value_mask", ~0)
        leaf_id, prev = self.octree.set_leaf(pos, leaf)
        if serialize or uid not in self.leaf_info:
            self.change_set[("add", uid, leaf_id)] = True
        return leaf_id, prev

    def move_leaf(self, leaf: LeafId, to_pos: Position) -> tuple[LeafId, object]:
        return self.octree.move_leaf(leaf, to_pos)

    def remove_leaf(self, leaf: LeafId) -> object:
        value = self.octree.remove_leaf_by_id(leaf)
        if value is not None:
            self.change_set[("remove", value.unique_id(), None)] = True
        return value

    def get_leaf(self, pos: Position):
        return self.octree.get_leaf(pos)

    # -- serialization --------------------------------------------------------

    def serialize(self) -> None:
        """Replay the change set (serialize added chunks / free removed ones),
        then rebuild the root octree block. Reference: esvo.rs:237-276."""
        if self.octree.root is None:
            return

        changes = list(self.change_set.keys())
        self.change_set.clear()
        for kind, uid, leaf_id in changes:
            if kind == "add":
                child = self.octree.octants[leaf_id.parent].children[leaf_id.idx]
                if child is None or child[0] != "l":
                    continue
                content: SerializedChunk = child[1]
                tmp: list[int] = []
                result = content.serialize(tmp, 0)
                if result.depth > 0:
                    offset = self.buffer.insert(uid, np.asarray(tmp, dtype=np.uint32))
                    self.leaf_info[uid] = LeafInfo(offset, result)
            else:
                self.buffer.remove(uid)
                self.leaf_info.pop(uid, None)

        tmp = []
        result = self._serialize_root(tmp)
        offset = self.buffer.insert(_ROOT_ID, np.asarray(tmp, dtype=np.uint32))
        self.root_info = LeafInfo(offset, result)

    def _serialize_root(self, dst: list[int]) -> SerializationResult:
        def encode(params: ChildEncodeParams) -> None:
            content: SerializedChunk = params.content
            info = self.leaf_info.get(content.unique_id())
            if info is None:
                return
            mask = (info.serialization.child_mask << 8) | info.serialization.leaf_mask
            if params.idx % 2 != 0:
                mask <<= 16
            params.dst[params.dst_offset + params.idx // 2] |= mask
            params.dst[params.dst_offset + 4 + params.idx] = (
                info.buf_offset + PREAMBLE_LENGTH_IN_U32
            )
            params.result.depth = max(params.result.depth, info.serialization.depth + 1)

        return serialize_octant(self.octree, self.octree.root, dst, 0, encode)

    def depth(self) -> int:
        return self.root_info.serialization.depth if self.root_info else 0

    def size_in_bytes(self) -> int:
        return self.buffer.size_in_bytes()

    def size_in_u32(self) -> int:
        return self.buffer.size

    # -- buffer export ---------------------------------------------------------

    def _preamble(self) -> np.ndarray:
        info = self.root_info
        pre = np.zeros(PREAMBLE_LENGTH_IN_U32, dtype=np.uint32)
        pre[0] = np.uint32(info.serialization.child_mask << 8)
        pre[4] = np.uint32(info.buf_offset + PREAMBLE_LENGTH_IN_U32)
        return pre

    def write_to(self, dst: np.ndarray) -> int:
        """Write preamble + full buffer into ``dst`` (u32 array).
        Returns the number of u32 written. Reference: esvo.rs:291-305."""
        if self.root_info is None:
            return 0
        pre = self._preamble()
        n = self.buffer.size
        dst[:PREAMBLE_LENGTH_IN_U32] = pre
        dst[PREAMBLE_LENGTH_IN_U32 : PREAMBLE_LENGTH_IN_U32 + n] = self.buffer.data[:n]
        return PREAMBLE_LENGTH_IN_U32 + n

    def write_changes_to(self, dst: np.ndarray, reset: bool = True) -> list[tuple[int, int]]:
        """Copy only updated ranges into ``dst`` (which must be the same buffer
        previously filled by write_to / earlier change writes). Returns the list
        of (start, length) u32 ranges written (preamble range included) so the
        caller can mirror exactly those to the device.
        Reference: esvo.rs:310-339."""
        if self.root_info is None or not self.buffer.updated_ranges:
            return []
        written: list[tuple[int, int]] = [(0, PREAMBLE_LENGTH_IN_U32)]
        dst[:PREAMBLE_LENGTH_IN_U32] = self._preamble()
        for r in self.buffer.updated_ranges:
            assert r.start + r.length <= len(dst) - PREAMBLE_LENGTH_IN_U32, (
                f"dst too small: len={len(dst)} range=({r.start},{r.length})"
            )
            dst[
                PREAMBLE_LENGTH_IN_U32 + r.start : PREAMBLE_LENGTH_IN_U32 + r.start + r.length
            ] = self.buffer.data[r.start : r.start + r.length]
            written.append((PREAMBLE_LENGTH_IN_U32 + r.start, r.length))
        if reset:
            self.buffer.updated_ranges.clear()
        return written
