"""Indexable dataset combinators for HDR-Synth training (the port's copy of
``singlehdr_tpu.data.datasets``).

Same algebra as the reference's abstractions (dataset.py:60-154) — a sized
``__getitem__`` protocol with zip (``ZipDataset``) and Cartesian product
(``ProductDataset``, index decomposed by div/mod so the virtual length is the
product of member lengths) — expressed as small standalone classes returning
tuples instead of flattened lists.
"""

from __future__ import annotations

from typing import Any, Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class SizedDataset(Protocol):
    def __getitem__(self, idx: int) -> Any: ...

    def __len__(self) -> int: ...


def _as_tuple(x: Any) -> Tuple[Any, ...]:
    return tuple(x) if isinstance(x, tuple) else (x,)


class ZipDataset:
    """Aligns datasets of equal length; item i is the concatenation of the
    members' items (reference CatDataset, dataset.py:93-113)."""

    def __init__(self, members: Sequence[SizedDataset]):
        self._members = list(members)
        lengths = {len(m) for m in self._members}
        if len(lengths) != 1:
            raise ValueError(f"ZipDataset members differ in length: {lengths}")
        self._len = lengths.pop()

    def __getitem__(self, idx: int) -> Tuple[Any, ...]:
        out: Tuple[Any, ...] = ()
        for m in self._members:
            out += _as_tuple(m[idx])
        return out

    def __len__(self) -> int:
        return self._len


class ProductDataset:
    """Cartesian product of datasets; len = prod(lens); index decomposed by
    successive div/mod (reference MergeDataset, dataset.py:116-138)."""

    def __init__(self, members: Sequence[SizedDataset]):
        self._members = list(members)
        self._len = 1
        for m in self._members:
            self._len *= len(m)

    def __getitem__(self, idx: int) -> Tuple[Any, ...]:
        if not 0 <= idx < self._len:
            raise IndexError(idx)
        out: Tuple[Any, ...] = ()
        for m in self._members:
            idx, local = divmod(idx, len(m))
            out += _as_tuple(m[local])
        return out

    def __len__(self) -> int:
        return self._len


class CachedDataset:
    """Materializes a dataset into RAM once (reference MemDataset,
    dataset.py:141-154), lazily per index."""

    def __init__(self, inner: SizedDataset, eager: bool = False):
        self._inner = inner
        self._cache: dict[int, Any] = {}
        if eager:
            for i in range(len(inner)):
                self._cache[i] = inner[i]

    def __getitem__(self, idx: int) -> Any:
        if idx not in self._cache:
            self._cache[idx] = self._inner[idx]
        return self._cache[idx]

    def __len__(self) -> int:
        return len(self._inner)


class ArrayDataset:
    """Wraps an array-like so each row is an item."""

    def __init__(self, array):
        self._array = array

    def __getitem__(self, idx: int):
        return self._array[idx]

    def __len__(self) -> int:
        return len(self._array)
