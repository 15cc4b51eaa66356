"""CSVO — byte-compressed SVO format after Mados et al. "Clustered Sparse
Voxel Octrees" (reference: src/world/hds/csvo.rs).

Node kinds by remaining depth:
- depth 1 (leaf node): one byte — the 8-bit leaf mask; leaf values go to a
  per-chunk material array instead of the node stream.
- depth 2 ("lnode"): [mask u8][material-section offset u16 LE, if any
  children][child leaf nodes].
- depth 3 (pre-leaf): [mask u8][u8 running offset per child][child blobs].
- depth ≥ 4 (internal): [u16 LE header of 2-bit pointer-size tags per child]
  [1/2/4-byte LE relative offsets][child blobs].

Chunk blob layout: [lod u8][material_bytes u32 LE][materials u32 LE each]
[node bytes] (reference: csvo.rs:216-233). The world root tree uses the
internal-node encoding; at its bottom, children are 4-byte absolute pointers
into the buffer with bit 31 set (reference: csvo.rs:68-139).
Buffer prefix written to the device: [root_offset u32 LE][bytes…].

Counterpart: voxelrs_tpu/world/csvo.py (``_pyramids`` :35,
``serialize_dense_csvo`` :83, ``CsvoSerializedChunk`` :140, ``Csvo``
:194-328), copied; ``from_voxels`` tries this package's native serializer
first (``native.serialize_csvo_native``), as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .esvo_dense import _morton_perm, _PICK_ORDER
from .octree import LeafId, Octree, Position
from .rangebuf import RangeBuffer

CHUNK_DEPTH = 5
_ROOT_ID = (1 << 64) - 1


def _pyramids(voxels: np.ndarray):
    """(occupancy, representative) pyramids in Morton order, levels 0..5."""
    vox_m = voxels.reshape(-1)[_morton_perm(CHUNK_DEPTH)].astype(np.uint32)
    occ = [None] * (CHUNK_DEPTH + 1)
    rep = [None] * (CHUNK_DEPTH + 1)
    occ[CHUNK_DEPTH] = vox_m != 0
    rep[CHUNK_DEPTH] = vox_m
    for lvl in range(CHUNK_DEPTH - 1, -1, -1):
        o = occ[lvl + 1].reshape(-1, 8)
        r = rep[lvl + 1].reshape(-1, 8)
        occ[lvl] = o.any(axis=1)
        chosen = np.zeros(o.shape[0], dtype=np.uint32)
        taken = np.zeros(o.shape[0], dtype=bool)
        for c in _PICK_ORDER:
            sel = o[:, c] & ~taken
            chosen = np.where(sel, r[:, c], chosen)
            taken |= o[:, c]
        rep[lvl] = chosen
    return occ, rep


def _encode_internal(children: list[tuple[int, bytes]]) -> bytes:
    """Internal node: u16 tag header + variable-width relative offsets
    (reference: csvo.rs:508-543)."""
    header_mask = 0
    offsets = []
    running = 0
    for _, data in children:
        offsets.append(running)
        running += len(data)
    ptr_bytes = bytearray()
    for (idx, _), off in zip(children, offsets):
        tag = (max(off, 1).bit_length() - 1) // 8 + 1
        header_mask |= tag << (idx * 2)
        if tag == 1:
            ptr_bytes.append(off & 0xFF)
        elif tag == 2:
            ptr_bytes += off.to_bytes(2, "little")
        else:
            assert off & (1 << 31) == 0
            ptr_bytes += off.to_bytes(4, "little")
    out = bytearray(header_mask.to_bytes(2, "little"))
    out += ptr_bytes
    for _, data in children:
        out += data
    return bytes(out)


def serialize_dense_csvo(
    voxels: np.ndarray, lod: int = 0
) -> tuple[Optional[np.ndarray], Optional[list[int]], int]:
    """Serialize a dense (32,32,32) chunk into CSVO node bytes + materials.
    Returns (node_bytes | None, materials | None, effective_lod)."""
    assert voxels.shape == (32, 32, 32)
    cut = lod if 1 <= lod <= CHUNK_DEPTH else CHUNK_DEPTH
    occ, rep = _pyramids(voxels)
    if not occ[0][0]:
        return None, None, cut

    materials: list[int] = []

    def node(lvl: int, m: int) -> bytes:
        depth = cut - lvl
        if depth == 1:
            mask = 0
            for c in range(8):
                if occ[lvl + 1][8 * m + c]:
                    mask |= 1 << c
                    materials.append(int(rep[lvl + 1][8 * m + c]))
            return bytes([mask])

        if depth == 2:
            material_offset = len(materials)
            mask = 0
            blobs = bytearray()
            for c in range(8):
                if occ[lvl + 1][8 * m + c]:
                    mask |= 1 << c
                    blobs += node(lvl + 1, 8 * m + c)
            out = bytearray([mask])
            if mask:
                out += material_offset.to_bytes(2, "little")
            out += blobs
            return bytes(out)

        children = [
            (c, node(lvl + 1, 8 * m + c)) for c in range(8) if occ[lvl + 1][8 * m + c]
        ]
        if depth == 3:
            out = bytearray([0] + [0] * len(children))
            running = 0
            for i, (c, data) in enumerate(children):
                out[0] |= 1 << c
                out[1 + i] = running
                running += len(data)
            for _, data in children:
                out += data
            return bytes(out)

        return _encode_internal(children)

    blob = node(0, 0)
    return np.frombuffer(blob, np.uint8).copy(), materials, cut


class CsvoSerializedChunk:
    """Chunk serialized to CSVO node bytes + material array
    (reference: csvo.rs:393-555)."""

    def __init__(self, pos, voxels: Optional[np.ndarray], lod: int,
                 borrowed_chunk=None):
        from .esvo import _hash_pos

        self.pos = pos
        self.pos_hash = _hash_pos(pos.x, pos.y, pos.z)
        self.borrowed_chunk = borrowed_chunk
        # bitmask over block values present (bit 63 = unknown/overflow);
        # lets the renderer prove a world contains no translucent blocks
        self.value_mask = ~0
        if voxels is not None:
            from ..native import serialize_csvo_native

            native = serialize_csvo_native(voxels, lod)
            if native is not None:
                buffer, materials, _eff = native
            else:
                buffer, materials, _eff = serialize_dense_csvo(voxels, lod)
            self.buffer = buffer
            self.materials = materials
            self.lod = lod if lod != 0 else CHUNK_DEPTH
            mask = 0
            for v in np.unique(voxels):
                mask |= 1 << min(int(v), 63)
            self.value_mask = mask
        else:
            self.buffer = None
            self.materials = None
            self.lod = lod

    @staticmethod
    def from_voxels(pos, voxels, lod, borrowed_chunk=None):
        return CsvoSerializedChunk(pos, voxels, lod, borrowed_chunk)

    def unique_id(self) -> int:
        return self.pos_hash

    def has_data(self) -> bool:
        return self.buffer is not None and self.materials is not None

    def take_borrowed_chunk(self):
        chunk, self.borrowed_chunk = self.borrowed_chunk, None
        return chunk


@dataclass(frozen=True)
class LeafInfo:
    buf_offset: int  # byte offset


class Csvo:
    """World SVO in the compressed byte format
    (reference: csvo.rs:28-313)."""

    def __init__(self, capacity: int = 0):
        self.octree = Octree()
        self.change_set: dict[tuple, bool] = {}
        self.child_depth = 0
        self.buffer = RangeBuffer(capacity, dtype=np.uint8)
        self.leaf_info: dict[int, LeafInfo] = {}
        self.root_info: Optional[LeafInfo] = None
        self.value_mask = 0  # union of serialized leaves' value masks

    def clear(self) -> None:
        self.octree.reset()
        self.change_set.clear()
        self.child_depth = 0
        self.buffer.clear()
        self.leaf_info.clear()
        self.root_info = None
        self.value_mask = 0

    def set_leaf(self, pos: Position, leaf: CsvoSerializedChunk, serialize: bool):
        uid = leaf.pos_hash
        leaf_id, prev = self.octree.set_leaf(pos, leaf)
        if serialize or uid not in self.leaf_info:
            self.change_set[("add", uid, leaf_id)] = True
        return leaf_id, prev

    def move_leaf(self, leaf: LeafId, to_pos: Position):
        return self.octree.move_leaf(leaf, to_pos)

    def remove_leaf(self, leaf: LeafId):
        value = self.octree.remove_leaf_by_id(leaf)
        if value is not None:
            self.change_set[("remove", value.pos_hash, None)] = True
        return value

    def get_leaf(self, pos: Position):
        return self.octree.get_leaf(pos)

    def serialize(self) -> None:
        if self.octree.root is None:
            return
        changes = list(self.change_set.keys())
        self.change_set.clear()
        for kind, uid, leaf_id in changes:
            if kind == "add":
                child = self.octree.octants[leaf_id.parent].children[leaf_id.idx]
                if child is None or child[0] != "l":
                    continue
                content: CsvoSerializedChunk = child[1]
                self.child_depth = max(self.child_depth, content.lod)
                if content.buffer is None:
                    continue
                self.value_mask |= getattr(content, "value_mask", ~0)
                materials = content.materials
                blob = bytearray([content.lod])
                blob += (len(materials) * 4).to_bytes(4, "little")
                blob += np.asarray(materials, np.uint32).astype(
                    "<u4").tobytes()
                blob += content.buffer.tobytes()
                offset = self.buffer.insert(uid, np.frombuffer(bytes(blob), np.uint8))
                self.leaf_info[uid] = LeafInfo(offset)
                content.buffer = None
                content.materials = None
            else:
                self.buffer.remove(uid)
                self.leaf_info.pop(uid, None)

        root_bytes = self._serialize_root(self.octree.root, self.octree.depth())
        offset = self.buffer.insert(_ROOT_ID, np.frombuffer(root_bytes, np.uint8))
        self.root_info = LeafInfo(offset)

    def _serialize_root(self, octant_id: int, depth: int) -> bytes:
        """Root octree over chunk blobs; bottom children become 4-byte
        absolute pointers with bit 31 (reference: csvo.rs:68-139)."""
        octant = self.octree.octants[octant_id]
        children: list[tuple[int, bytes]] = []
        for idx in range(8):
            child = octant.children[idx]
            if child is None:
                continue
            if depth == 1:
                if child[0] == "l":
                    info = self.leaf_info.get(child[1].pos_hash)
                    if info is not None:
                        assert info.buf_offset & (1 << 31) == 0
                        ptr = info.buf_offset | (1 << 31)
                        children.append((idx, ptr.to_bytes(4, "little")))
                continue
            assert child[0] == "o", "octree leaves must be at a uniform level"
            children.append((idx, self._serialize_root(child[1], depth - 1)))

        if depth == 1:
            header_mask = 0
            out = bytearray()
            for idx, ptr in children:
                header_mask |= 3 << (idx * 2)
                out += ptr
            return header_mask.to_bytes(2, "little") + bytes(out)
        return _encode_internal(children)

    def depth(self) -> int:
        return self.octree.depth() + self.child_depth

    def size_in_bytes(self) -> int:
        return self.buffer.size

    def write_to(self, dst: np.ndarray) -> int:
        """[root byte-offset u32 LE][buffer bytes] (reference: csvo.rs:262-277)."""
        if self.root_info is None:
            return 0
        dst[:4] = np.frombuffer(
            self.root_info.buf_offset.to_bytes(4, "little"), np.uint8
        )
        n = self.buffer.size
        dst[4 : 4 + n] = self.buffer.data[:n]
        return 4 + n

    def write_changes_to(self, dst: np.ndarray, reset: bool = True):
        if self.root_info is None or not self.buffer.updated_ranges:
            return []
        written = [(0, 4)]
        dst[:4] = np.frombuffer(
            self.root_info.buf_offset.to_bytes(4, "little"), np.uint8
        )
        for r in self.buffer.updated_ranges:
            dst[4 + r.start : 4 + r.start + r.length] = self.buffer.data[
                r.start : r.start + r.length
            ]
            written.append((4 + r.start, r.length))
        if reset:
            self.buffer.updated_ranges.clear()
        return written
