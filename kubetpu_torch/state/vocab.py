# Port copy of kubetpu/state/vocab.py, verbatim apart from this note (no JAX in it).
"""String interning tables.

Every string the kernels care about (label keys, label values, topology keys,
namespaces, image names, port triples, selector signatures) is interned to a
dense int id on the host so that device tensors contain only integers. This
replaces the reference's pervasive map[string]string comparisons with integer
gathers — the TPU never sees a string.
"""

from __future__ import annotations

from typing import Hashable, Iterable


class Vocab:
    """Monotonic string→id intern table (ids are stable across updates)."""

    __slots__ = ("_to_id", "_to_str")

    def __init__(self) -> None:
        self._to_id: dict[Hashable, int] = {}
        self._to_str: list[Hashable] = []

    def intern(self, s: Hashable) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._to_str)
            self._to_id[s] = i
            self._to_str.append(s)
        return i

    def get(self, s: Hashable, default: int = -1) -> int:
        return self._to_id.get(s, default)

    def lookup(self, i: int) -> Hashable:
        return self._to_str[i]

    def intern_all(self, items: Iterable[Hashable]) -> list[int]:
        return [self.intern(s) for s in items]

    def __len__(self) -> int:
        return len(self._to_str)

    def __contains__(self, s: Hashable) -> bool:
        return s in self._to_id
