"""Native (C++) host components of the port, bound with ctypes (the
port's copy of oramacore_tpu/native/__init__.py's bindings).

- `tokenizer.cpp`: the English tokenizer + Porter2 stemmer, the ingest
  hot loop for ASCII texts (`utils/tokenizer.TextParser`).
- `hash_encode.cpp`: the feature-hashing text encoder of the hash-backed
  embedding models, for ASCII texts (`embeddings._hash_backend`).
- `live_accum.cpp`: the live-layer posting accumulator of `StringIndex`
  (`NativeLiveAccum`).

Each library is built by `_build.py` at first use. Unlike the JAX
package's loaders, which return None and let callers go to Python, a
failed build or load raises here: a fallback would hide that the native
route never ran. `ROUTES` counts, for each of the three, the texts (or
field values) that took the native route and those that took the Python
one, which is the route of non-ASCII text and the semantic oracle.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from . import _build

ROUTES = {
    "tokenizer": {"native": 0, "python": 0},
    "hash_encode": {"native": 0, "python": 0},
    "live_accum": {"native": 0, "python": 0},
}


def reset_routes() -> None:
    for counts in ROUTES.values():
        for route in counts:
            counts[route] = 0


# ---------------------------------------------------------------------------
# Tokenizer + Porter2 (tokenizer.cpp)
# ---------------------------------------------------------------------------

def _bind_tokenizer(lib) -> None:
    lib.tokenize_and_stem.argtypes = [ctypes.c_char_p]
    lib.tokenize_and_stem.restype = ctypes.c_void_p
    lib.stem_word.argtypes = [ctypes.c_char_p]
    lib.stem_word.restype = ctypes.c_void_p
    lib.free_result.argtypes = [ctypes.c_void_p]
    lib.free_result.restype = None
    lib.tokenize_and_stem_wire.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.tokenize_and_stem_wire.restype = ctypes.c_void_p


def load_tokenizer():
    return _build.load("tokenizer", _bind_tokenizer)


def native_tokenize_and_stem(lib, text: str) -> List[Tuple[str, List[str]]]:
    """Call the native tokenizer; returns tokenize_and_stem-shaped output."""
    ptr = lib.tokenize_and_stem(text.encode("utf-8"))
    try:
        raw = ctypes.string_at(ptr).decode("utf-8", errors="replace")
    finally:
        lib.free_result(ptr)
    out: List[Tuple[str, List[str]]] = []
    for line in raw.splitlines():
        if not line:
            continue
        token, _, stem = line.partition("\t")
        out.append((token, [stem] if stem else []))
    return out


def native_tokenize_wire(lib, text: str) -> Tuple[int, str]:
    """(n_surface_tokens, packed op-body payload): the writer's wire
    format produced in one native pass (no per-token Python objects)."""
    n = ctypes.c_int64(0)
    ptr = lib.tokenize_and_stem_wire(text.encode("utf-8"), ctypes.byref(n))
    try:
        raw = ctypes.string_at(ptr).decode("utf-8", errors="replace")
    finally:
        lib.free_result(ptr)
    return int(n.value), raw


def native_stem(lib, word: str) -> str:
    ptr = lib.stem_word(word.encode("utf-8"))
    try:
        return ctypes.string_at(ptr).decode("utf-8", errors="replace")
    finally:
        lib.free_result(ptr)


# ---------------------------------------------------------------------------
# Hash embedding encoder (hash_encode.cpp): blake2b-8 + splitmix64 in C++,
# the interpreter lock released for the whole batch; embeddings.hash_encode
# is the oracle (within 1e-6 after the L2 normalization).
# ---------------------------------------------------------------------------

def _bind_hash_encoder(lib) -> None:
    lib.he_encode_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
    ]
    lib.he_encode_batch.restype = ctypes.c_int32


def load_hash_encoder():
    return _build.load("hash_encode", _bind_hash_encoder)


def native_hash_encode_batch(lib, texts, dim: int) -> np.ndarray:
    """float32[n, dim] L2-normalized hash embeddings for ASCII texts
    (callers send non-ASCII texts to the Python oracle)."""
    blobs = [t.encode() for t in texts]
    offs = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offs[1:])
    concat = b"".join(blobs)
    out = np.empty((len(blobs), dim), np.float32)
    lib.he_encode_batch(
        concat, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(blobs), dim,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


# ---------------------------------------------------------------------------
# Live-layer accumulator (live_accum.cpp): the bump loop of index_text
# ---------------------------------------------------------------------------

def _bind_live_accum(lib) -> None:
    lib.la_new.argtypes = []
    lib.la_new.restype = ctypes.c_void_p
    lib.la_free.argtypes = [ctypes.c_void_p]
    lib.la_free.restype = None
    lib.la_index_field.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.la_index_field.restype = ctypes.c_int64
    lib.la_delete_doc.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.la_delete_doc.restype = ctypes.c_int64
    lib.la_n_rows.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.la_n_rows.restype = ctypes.c_int64
    lib.la_n_terms.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.la_n_terms.restype = ctypes.c_int64
    lib.la_export_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.la_export_rows.restype = None
    lib.la_term_names.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.la_term_names.restype = ctypes.c_void_p
    lib.la_free_buf.argtypes = [ctypes.c_void_p]
    lib.la_free_buf.restype = None
    lib.la_clear.argtypes = [ctypes.c_void_p]
    lib.la_clear.restype = None


def load_live_accum():
    return _build.load("live_accum", _bind_live_accum)


class NativeLiveAccum:
    """Per-StringIndex handle over the C++ live accumulator."""

    __slots__ = ("_lib", "_h", "_path_ids", "_paths")

    def __init__(self, lib):
        self._lib = lib
        self._h = ctypes.c_void_p(lib.la_new())
        self._path_ids = {}
        self._paths = []

    def __del__(self):
        try:
            if self._h:
                self._lib.la_free(self._h)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def path_id(self, path: str) -> int:
        pid = self._path_ids.get(path)
        if pid is None:
            pid = len(self._paths)
            self._path_ids[path] = pid
            self._paths.append(path)
        return pid

    def index_packed(self, path: str, doc_id: int, payload: str,
                     index_bigrams: bool) -> int:
        """Payload is already in the wire format (token := surface
        [\\x01 variant]*, joined by \\x02), built once by the writer at
        tokenize time and passed straight through the op body."""
        data = payload.encode()
        return self._lib.la_index_field(
            self._h, self.path_id(path), doc_id, data, len(data),
            1 if index_bigrams else 0,
        )

    def delete_doc(self, doc_id: int) -> int:
        return self._lib.la_delete_doc(self._h, doc_id)

    def live_paths(self):
        return [
            p for p in self._paths
            if self._lib.la_n_rows(self._h, self._path_ids[p]) > 0
        ]

    def n_terms(self, path: str) -> int:
        pid = self._path_ids.get(path)
        if pid is None:
            return 0
        return int(self._lib.la_n_terms(self._h, pid))

    def n_rows(self, path: str) -> int:
        pid = self._path_ids.get(path)
        if pid is None:
            return 0
        return int(self._lib.la_n_rows(self._h, pid))

    def rows(self, path: str):
        """(doc int64[n], tid int64[n], tf f64[n], etf f64[n], names) or
        None when the path has no live rows."""
        pid = self._path_ids.get(path)
        if pid is None:
            return None
        n = int(self._lib.la_n_rows(self._h, pid))
        if n == 0:
            return None
        doc = np.empty(n, np.int64)
        tid = np.empty(n, np.int32)
        tf = np.empty(n, np.float32)
        etf = np.empty(n, np.float32)
        self._lib.la_export_rows(
            self._h, pid,
            doc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            etf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        ln = ctypes.c_int64(0)
        buf = self._lib.la_term_names(self._h, pid, ctypes.byref(ln))
        try:
            raw = ctypes.string_at(buf, ln.value)
        finally:
            self._lib.la_free_buf(buf)
        names = raw.decode("utf-8", errors="replace").split("\n")[:-1]
        return (
            doc, tid.astype(np.int64), tf.astype(np.float64),
            etf.astype(np.float64), names,
        )

    def clear(self):
        self._lib.la_clear(self._h)
        self._path_ids.clear()
        self._paths.clear()
