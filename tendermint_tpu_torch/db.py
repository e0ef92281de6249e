"""Ordered key-value store: the interface and its in-memory backend.

Counterpart: tendermint_tpu/db/__init__.py (DB and MemDB; the tm-db
interface the reference builds its stores on). Iteration is ascending
byte order over [start, end); reverse_iterator walks the same range
backwards. The light store (light/store.py) is its only user so far.
"""

from __future__ import annotations

import abc
import bisect
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class DB(abc.ABC):
    @abc.abstractmethod
    def get(self, key: bytes) -> Optional[bytes]: ...

    @abc.abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abc.abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abc.abstractmethod
    def iterator(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]: ...

    @abc.abstractmethod
    def reverse_iterator(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]: ...

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def write_batch(self, ops: List[Tuple[str, bytes, Optional[bytes]]]) -> None:
        """ops are ("set", key, value) or ("delete", key, None)."""
        for op, k, v in ops:
            if op == "set":
                self.set(k, v)  # type: ignore[arg-type]
            elif op == "delete":
                self.delete(k)
            else:
                raise ValueError(f"unknown batch op {op}")

    def close(self) -> None:
        pass


class MemDB(DB):
    """In-memory ordered map (tm-db memdb)."""

    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []
        self._mtx = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._mtx:
            return self._data.get(bytes(key))

    def set(self, key: bytes, value: bytes) -> None:
        key = bytes(key)
        with self._mtx:
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = bytes(value)

    def delete(self, key: bytes) -> None:
        key = bytes(key)
        with self._mtx:
            if key in self._data:
                del self._data[key]
                del self._keys[bisect.bisect_left(self._keys, key)]

    def _range(self, start: Optional[bytes], end: Optional[bytes]) -> List[bytes]:
        with self._mtx:
            lo = bisect.bisect_left(self._keys, start) if start is not None else 0
            hi = bisect.bisect_left(self._keys, end) if end is not None else len(self._keys)
            return self._keys[lo:hi]

    def iterator(self, start=None, end=None):
        for k in self._range(start, end):
            v = self.get(k)
            if v is not None:
                yield k, v

    def reverse_iterator(self, start=None, end=None):
        for k in reversed(self._range(start, end)):
            v = self.get(k)
            if v is not None:
                yield k, v
