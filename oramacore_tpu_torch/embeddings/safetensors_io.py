"""A reader and a writer of the safetensors format, by hand (the card's
machine has no `safetensors` package).

A file is an 8-byte little-endian header length N, N bytes of a JSON
header, then the raw little-endian tensor data. The header maps each
tensor name to `{"dtype", "shape", "data_offsets": [begin, end]}`, with
the offsets relative to the end of the header; the optional
`__metadata__` entry (string to string) is skipped.

F32, F16, BF16, I64 and I32 are read. numpy has no bfloat16, so BF16
comes back from `load_numpy` as float32 (a bf16 value widens to f32
exactly: its 16 bits are the f32's high half) and from `load_torch` as
torch.bfloat16, both through the raw uint16 bits. A truncated file, a
bad header, offsets that overlap, run past the end or disagree with the
shape and dtype raise ValueError.

`save_numpy` writes F32, I64 and I32 arrays with `{"format": "pt"}` as
the metadata (the loaders of `transformers` refuse a file without it),
the header padded with spaces to a multiple of 8 bytes, as the format's
own writer pads it.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Tuple

import numpy as np
import torch

# dtype tag -> (numpy dtype of the raw little-endian data, item size)
_DTYPES = {
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
}
# a header longer than this is refused before it is read (the format's
# own readers cap it at 100 MB)
MAX_HEADER = 100_000_000


def _entries(blob: bytes) -> Tuple[Dict[str, dict], memoryview]:
    """The checked header entries (without `__metadata__`) and the data
    section of a safetensors file's bytes."""
    if len(blob) < 8:
        raise ValueError(f"safetensors: {len(blob)} bytes, no header length")
    (n,) = struct.unpack("<Q", blob[:8])
    if n > MAX_HEADER or 8 + n > len(blob):
        raise ValueError(f"safetensors: header of {n} bytes does not fit in "
                         f"a file of {len(blob)}")
    try:
        header = json.loads(blob[8:8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"safetensors: bad JSON header: {e}") from e
    if not isinstance(header, dict):
        raise ValueError("safetensors: the header is not a JSON object")
    data = memoryview(blob)[8 + n:]
    entries = {k: v for k, v in header.items() if k != "__metadata__"}
    spans = []
    for name, e in entries.items():
        if not (isinstance(e, dict)
                and {"dtype", "shape", "data_offsets"} <= set(e)
                and isinstance(e["shape"], list)
                and isinstance(e["data_offsets"], list)
                and len(e["data_offsets"]) == 2):
            raise ValueError(f"safetensors: bad entry {name!r}: {e!r}")
        dt = _DTYPES.get(e["dtype"])
        if dt is None:
            raise ValueError(f"safetensors: {name}: unsupported dtype "
                             f"{e['dtype']!r}")
        shape = e["shape"]
        begin, end = e["data_offsets"]
        if not all(isinstance(s, int) and s >= 0 for s in shape):
            raise ValueError(f"safetensors: {name}: bad shape {shape}")
        if not (isinstance(begin, int) and isinstance(end, int)
                and 0 <= begin <= end <= len(data)):
            raise ValueError(f"safetensors: {name}: offsets [{begin}, {end}] "
                             f"outside the {len(data)} data bytes")
        want = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if end - begin != want:
            raise ValueError(f"safetensors: {name}: {end - begin} bytes for "
                             f"shape {shape} of {e['dtype']} ({want})")
        spans.append((begin, end, name))
    spans.sort()
    for (_, end0, a), (begin1, _, b) in zip(spans, spans[1:]):
        if begin1 < end0:
            raise ValueError(f"safetensors: {a} and {b} overlap")
    return entries, data


def _raw(path: str) -> Dict[str, Tuple[str, np.ndarray]]:
    with open(path, "rb") as f:
        blob = f.read()
    entries, data = _entries(blob)
    out = {}
    for name, e in entries.items():
        begin, end = e["data_offsets"]
        arr = np.frombuffer(data[begin:end], dtype=_DTYPES[e["dtype"]])
        out[name] = (e["dtype"], arr.reshape(e["shape"]))
    return out


def load_numpy(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the file as a native-endian numpy array that owns
    its memory; BF16 as float32 (exact)."""
    out = {}
    for name, (tag, arr) in _raw(path).items():
        if tag == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.astype(arr.dtype.newbyteorder("="), copy=True)
    return out


def load_torch(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file as a CPU torch tensor; BF16 as
    torch.bfloat16."""
    out = {}
    for name, (tag, arr) in _raw(path).items():
        arr = arr.astype(arr.dtype.newbyteorder("="), copy=True)
        if tag == "BF16":
            out[name] = torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16)
        else:
            out[name] = torch.from_numpy(arr)
    return out


# numpy dtype -> tag, for the writer
_TAGS = {np.dtype("float32"): "F32", np.dtype("int64"): "I64",
         np.dtype("int32"): "I32"}


def save_numpy(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write the arrays (float32, int64 or int32; any byte order) as one
    safetensors file, in name order, little-endian."""
    header: Dict[str, dict] = {"__metadata__": {"format": "pt"}}
    blobs, offset = [], 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        tag = _TAGS.get(arr.dtype.newbyteorder("="))
        if tag is None:
            raise ValueError(f"safetensors: {name}: cannot write {arr.dtype}")
        data = np.ascontiguousarray(arr, dtype=_DTYPES[tag]).tobytes()
        header[name] = {"dtype": tag, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
