"""Persistent KV store with op-log forwarding.

Reference: `oramacore_lib::generic_kv::KV` — persistent KV with commit and
a write-operation callback for write→read replication of system prompts,
tools and training sets (write/mod.rs:252-264, read/mod.rs:256-261).

The port's copy of `oramacore_tpu/storage/kv.py`, with the same names and
behaviour. Its file is tagged JSON (`files.atomic_write_packed`) in
place of msgpack.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from .files import atomic_write_packed, read_packed


class KV:
    def __init__(
        self,
        path: str,
        on_write: Optional[Callable[[str, Optional[Any]], None]] = None,
    ):
        """`on_write(key, value_or_None)` forwards mutations (None=delete)
        into the op log when configured (write side only)."""
        self.path = path
        self._on_write = on_write
        self._lock = threading.RLock()
        self._data: Dict[str, Any] = read_packed(path, default={}) or {}
        self._dirty = False

    def insert(self, key: str, value: Any, forward: bool = True) -> None:
        with self._lock:
            self._data[key] = value
            self._dirty = True
        if forward and self._on_write:
            self._on_write(key, value)

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._data.get(key)

    def remove(self, key: str, forward: bool = True) -> Optional[Any]:
        with self._lock:
            old = self._data.pop(key, None)
            self._dirty = old is not None or self._dirty
        if forward and self._on_write:
            self._on_write(key, None)
        return old

    def scan_prefix(self, prefix: str) -> List[Tuple[str, Any]]:
        with self._lock:
            return [(k, v) for k, v in self._data.items() if k.startswith(prefix)]

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._data.keys())

    def commit(self) -> None:
        with self._lock:
            if not self._dirty:
                return
            atomic_write_packed(self.path, self._data)
            self._dirty = False
