"""Atomic file helpers (reference: oramacore_lib::fs::BufferedFile).

The port's copy of `oramacore_tpu/storage/files.py`. The JAX module's
msgpack pair (`atomic_write_msgpack` / `read_msgpack`) becomes a JSON
pair, `atomic_write_packed` / `read_packed`, since the port does without
`msgpack`. msgpack keeps what JSON cannot: map keys that are not strings
(read back with `strict_map_key=False`) and bytes. `pack_json` tags those
so that `unpack_json` restores them: a dict with a non-str key becomes
`{"\\u0000map": [[key, value], ...]}` and bytes become
`{"\\u0000bytes": "<base64>"}`. Tuples come back as lists, as they do
from msgpack; floats round-trip exactly (`repr`), NaN and inf included.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
from typing import Any

_MAP_TAG = "\x00map"
_BYTES_TAG = "\x00bytes"


def atomic_write_bytes(path: str, data: bytes) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj).encode())


def read_json(path: str, default: Any = None) -> Any:
    if not os.path.exists(path):
        return default
    with open(path, "r") as fh:
        return json.load(fh)


def _tag(obj: Any) -> Any:
    if isinstance(obj, dict):
        if all(isinstance(k, str) for k in obj):
            return {k: _tag(v) for k, v in obj.items()}
        return {_MAP_TAG: [[k, _tag(v)] for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return [_tag(v) for v in obj]
    if isinstance(obj, (bytes, bytearray)):
        return {_BYTES_TAG: base64.b64encode(bytes(obj)).decode("ascii")}
    return obj


def _untag(obj: Any) -> Any:
    if isinstance(obj, dict):
        if len(obj) == 1:
            if _MAP_TAG in obj:
                return {_hashable(k): _untag(v) for k, v in obj[_MAP_TAG]}
            if _BYTES_TAG in obj:
                return base64.b64decode(obj[_BYTES_TAG])
        return {k: _untag(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_untag(v) for v in obj]
    return obj


def _hashable(key: Any) -> Any:
    # a tuple key comes back as a list; msgpack gives it back as a tuple
    return tuple(key) if isinstance(key, list) else key


def pack_json(obj: Any) -> bytes:
    """`obj` as JSON bytes, with non-str map keys and bytes tagged."""
    return json.dumps(_tag(obj), separators=(",", ":")).encode()


def unpack_json(raw: bytes) -> Any:
    return _untag(json.loads(raw))


def atomic_write_packed(path: str, obj: Any) -> None:
    atomic_write_bytes(path, pack_json(obj))


def read_packed(path: str, default: Any = None) -> Any:
    if not os.path.exists(path):
        return default
    with open(path, "rb") as fh:
        return unpack_json(fh.read())


# Snapshot compression is OPT-IN (ORAMACORE_COMPRESS_SNAPSHOTS=1): the
# reference writes raw bincode dumps, and zlib was ~25%% of read-side
# commit time at 10k docs (zlib 2.5s + fsync/write 3s vs 6s of merge).
def savez_snapshot(fh, **arrays):
    import numpy as np

    if os.environ.get("ORAMACORE_COMPRESS_SNAPSHOTS", "0") == "1":
        np.savez_compressed(fh, **arrays)
    else:
        np.savez(fh, **arrays)
