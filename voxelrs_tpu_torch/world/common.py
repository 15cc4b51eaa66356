"""Format-agnostic world-SVO interface (reference: src/world/hds/common.rs:3-15).

Both Esvo and Csvo implement this surface; systems.worldsvo drives either
through it (the reference switches implementations with cargo features).

Counterpart: voxelrs_tpu/world/common.py (a copy)."""

from __future__ import annotations

from abc import ABC, abstractmethod


class WorldSvo(ABC):
    @abstractmethod
    def clear(self) -> None: ...

    @abstractmethod
    def set_leaf(self, pos, leaf, serialize: bool): ...

    @abstractmethod
    def move_leaf(self, leaf_id, to_pos): ...

    @abstractmethod
    def remove_leaf(self, leaf_id): ...

    @abstractmethod
    def get_leaf(self, pos): ...

    @abstractmethod
    def serialize(self) -> None: ...

    @abstractmethod
    def depth(self) -> int: ...

    @abstractmethod
    def size_in_bytes(self) -> int: ...

    @abstractmethod
    def write_to(self, dst) -> int: ...

    @abstractmethod
    def write_changes_to(self, dst, reset: bool = True): ...


def register_implementations() -> None:
    from .csvo import Csvo
    from .esvo import Esvo

    WorldSvo.register(Esvo)
    WorldSvo.register(Csvo)


register_implementations()
