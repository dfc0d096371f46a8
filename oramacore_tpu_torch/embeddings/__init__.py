"""Embeddings service: model registry, chunking, intents, backends
(counterpart of oramacore_tpu/embeddings/__init__.py, whose names and
behaviour it keeps).

- `MODELS`: the registry, every entry with its backend key as in the JAX
  package, so one `ModelInfo` means the same thing in both.
- `chunk_text`: whitespace-token chunks of `seq_len` with 2% overlap,
  which make multi-vector documents.
- `Intent.QUERY` / `Intent.PASSAGE` prefixes of the E5 models, and the
  E5 score rescale carried as model metadata.
- `EmbeddingsService.calculate_embeddings`: the per-model backend key
  `"<backend>:<name>"` wins, then the shared key, then `hash`.

Backends:
- `hash`: the deterministic feature-hashing encoder (no weights): ASCII
  texts through the native C++ encoder (`native/hash_encode.cpp`),
  others through the Python `hash_encode`, bit-equal to the JAX
  package's.
- `flax:<name>` / `flax`: the BERT encoder of `encoder.py` on an explicit
  device (`register_torch_backend`, `register_torch_backend_lazy`,
  `register_bundled_checkpoints` for `SemanticBase` and `SemanticMini`).
  Its attention is the hand-written kernel of `ops/attention.py`; the
  weights load through `safetensors_io.py` and the text through
  `wordpiece.py`, so neither `transformers` nor `safetensors` is needed.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Intent(str, Enum):
    QUERY = "query"
    PASSAGE = "passage"


@dataclass(frozen=True)
class ModelInfo:
    name: str
    dim: int
    seq_len: int = 512
    overlap: float = 0.02            # 2% chunk overlap (embeddings.rs:39-67)
    intent_prefixes: Optional[Tuple[str, str]] = None  # (query, passage)
    score_rescale: Optional[Tuple[float, float]] = None
    backend: str = "hash"


# Registry mirroring the reference's 8 models (python/embeddings.rs:12-93)
# plus the self-contained builtin default.
MODELS: Dict[str, ModelInfo] = {}


def register_model(info: ModelInfo) -> None:
    MODELS[info.name] = info


_E5_PREFIX = ("query: ", "passage: ")

for _info in [
    ModelInfo("builtin-minihash-384", 384, 512),
    ModelInfo("builtin-minihash-768", 768, 512),
    ModelInfo("BGESmall", 384, 512, backend="flax"),
    ModelInfo("BGEBase", 768, 512, backend="flax"),
    ModelInfo("BGELarge", 1024, 512, backend="flax"),
    ModelInfo("JinaEmbeddingsV2BaseCode", 768, 512, backend="flax"),
    ModelInfo("MultilingualE5Small", 384, 512, intent_prefixes=_E5_PREFIX,
              score_rescale=(0.7, 1.0), backend="flax"),
    ModelInfo("MultilingualE5Base", 768, 512, intent_prefixes=_E5_PREFIX,
              score_rescale=(0.7, 1.0), backend="flax"),
    ModelInfo("MultilingualE5Large", 1024, 512, intent_prefixes=_E5_PREFIX,
              score_rescale=(0.7, 1.0), backend="flax"),
    ModelInfo("MultilingualMiniLML12V2", 384, 128, backend="flax"),
    # The checkpoints bundled in models/semantic-{mini,base};
    # encoder.register_bundled_checkpoints binds them lazily by name.
    ModelInfo("SemanticMini", 128, 64, backend="flax"),
    ModelInfo("SemanticBase", 256, 64, backend="flax"),
]:
    register_model(_info)

DEFAULT_MODEL = "builtin-minihash-384"

_TOKEN_RE = re.compile(r"\S+")


def chunk_text(text: str, seq_len: int, overlap: float) -> List[str]:
    """Split text into whitespace-token chunks of `seq_len` tokens with
    `overlap` fractional overlap (reference: 2%)."""
    tokens = _TOKEN_RE.findall(text)
    if len(tokens) <= seq_len:
        return [text] if text else []
    step = max(1, int(seq_len * (1.0 - overlap)))
    chunks = []
    for start in range(0, len(tokens), step):
        window = tokens[start : start + seq_len]
        if not window:
            break
        chunks.append(" ".join(window))
        if start + seq_len >= len(tokens):
            break
    return chunks


# ---------------------------------------------------------------------------
# Hash backend: deterministic feature-hashing encoder
# ---------------------------------------------------------------------------

_WORD_RE = re.compile(r"[a-z0-9]+")


def _hash64(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "little"
    )


def _hash_sign_idx(data: str, dim: int) -> Tuple[int, float]:
    h = _hash64(data)
    return h % dim, 1.0 if (h >> 63) & 1 else -1.0


_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _mix64(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array (vectorized bigram
    hashing: word bigrams are too diverse to cache, and per-bigram
    blake2b was the single hottest line of writer-side ingest)."""
    h = h ^ (h >> np.uint64(30))
    h = h * _MIX1
    h = h ^ (h >> np.uint64(27))
    h = h * _MIX2
    return h ^ (h >> np.uint64(31))


class _HashEncoderCache:
    """Feature cache so repeated tokens hash once."""

    def __init__(self):
        self._cache: Dict[Tuple[str, int], Tuple[int, float]] = {}
        # word -> (bucket idx array, weighted sign array) for the word's
        # own feature + its char trigrams, so encoding is np.add.at's
        # instead of per-trigram Python loops (the ingest hot spot)
        self._word_cache: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]] = {}

    def feat(self, s: str, dim: int) -> Tuple[int, float]:
        key = (s, dim)
        v = self._cache.get(key)
        if v is None:
            v = _hash_sign_idx(s, dim)
            if len(self._cache) < 2_000_000:
                self._cache[key] = v
        return v

    def word_feats(
        self, w: str, dim: int
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """(bucket idxs, weighted signs, word h64) — the h64 seeds the
        vectorized bigram mix in hash_encode."""
        key = (w, dim)
        v = self._word_cache.get(key)
        if v is None:
            idx = [0] * (1 + max(len(w) - 2, 0))
            val = [0.0] * len(idx)
            h = _hash64("w:" + w)
            idx[0] = h % dim
            val[0] = 1.0 if (h >> 63) & 1 else -1.0
            for j in range(len(w) - 2):
                i2, s2 = _hash_sign_idx("c:" + w[j : j + 3], dim)
                idx[j + 1] = i2
                val[j + 1] = 0.35 * s2
            v = (np.asarray(idx, np.int64), np.asarray(val, np.float32), h)
            if len(self._word_cache) < 1_000_000:
                self._word_cache[key] = v
        return v


_HASH_CACHE = _HashEncoderCache()


def hash_encode(text: str, dim: int) -> np.ndarray:
    """Encode text as a bag of word + word-bigram + char-trigram features
    hashed into `dim` buckets with random signs; L2-normalized."""
    vec = np.zeros(dim, np.float32)
    words = _WORD_RE.findall(text.lower())
    if not words:
        return vec
    parts_i = []
    parts_v = []
    hs = np.empty(len(words), np.uint64)
    for k, w in enumerate(words):
        i, v, h = _HASH_CACHE.word_feats(w, dim)
        parts_i.append(i)
        parts_v.append(v)
        hs[k] = h
    if len(words) > 1:
        # word-bigram features: one vectorized splitmix64 over the cached
        # word hashes (asymmetric combine so "a b" != "b a")
        hb = _mix64(hs[:-1] * _GOLDEN + hs[1:])
        parts_i.append((hb % np.uint64(dim)).astype(np.int64))
        parts_v.append(
            np.where(
                (hb >> np.uint64(63)).astype(bool),
                np.float32(0.5),
                np.float32(-0.5),
            )
        )
    # bincount is the fast dense scatter-add here (np.add.at's buffered
    # fancy indexing measured ~3x slower at these sizes)
    vec = np.bincount(
        np.concatenate(parts_i),
        weights=np.concatenate(parts_v),
        minlength=dim,
    ).astype(np.float32)
    n = float(np.linalg.norm(vec))
    if n > 0:
        vec /= n
    return vec


# ---------------------------------------------------------------------------
# Service
# ---------------------------------------------------------------------------

Backend = Callable[[Sequence[str], ModelInfo], List[np.ndarray]]

_BACKENDS: Dict[str, Backend] = {}


def register_backend(name: str, fn: Backend) -> None:
    _BACKENDS[name] = fn


def _hash_backend(texts: Sequence[str], info: ModelInfo) -> List[np.ndarray]:
    """ASCII texts through the native C++ batch encoder in one call (the
    interpreter lock released), every other text through the Python
    `hash_encode`: the JAX package's split. The two agree within 1e-6;
    a native library that does not build or load raises."""
    from ..native import ROUTES, load_hash_encoder, native_hash_encode_batch

    lib = load_hash_encoder()
    out: List[Optional[np.ndarray]] = [None] * len(texts)
    ascii_idx = []
    ascii_texts = []
    for i, t in enumerate(texts):
        if t.isascii():
            ascii_idx.append(i)
            ascii_texts.append(t)
        else:
            out[i] = hash_encode(t, info.dim)
    ROUTES["hash_encode"]["native"] += len(ascii_texts)
    ROUTES["hash_encode"]["python"] += len(texts) - len(ascii_texts)
    if ascii_texts:
        mat = native_hash_encode_batch(lib, ascii_texts, info.dim)
        for k, i in enumerate(ascii_idx):
            out[i] = mat[k]
    return out  # type: ignore[return-value]


register_backend("hash", _hash_backend)


class EmbeddingsService:
    """calculate_embeddings(texts, intent, model) → per-text chunk vectors.

    Reference bridge: python/embeddings.rs:164 `calculate_embeddings`.
    """

    def __init__(self, default_model: str = DEFAULT_MODEL):
        self.default_model = default_model

    def model_info(self, model: Optional[str]) -> ModelInfo:
        name = model or self.default_model
        info = MODELS.get(name)
        if info is None:
            raise ValueError(f"unknown embedding model: {name}")
        return info

    def calculate_embeddings(
        self,
        texts: Sequence[str],
        intent: Intent,
        model: Optional[str] = None,
    ) -> List[List[np.ndarray]]:
        info = self.model_info(model)
        # per-model checkpoint binding wins over the shared backend
        # (reference keeps a per-model registry, embeddings/models.py)
        backend = (
            _BACKENDS.get(f"{info.backend}:{info.name}")
            or _BACKENDS.get(info.backend)
            or _BACKENDS["hash"]
        )

        all_chunks: List[str] = []
        spans: List[Tuple[int, int]] = []
        for text in texts:
            chunks = chunk_text(text, info.seq_len, info.overlap)
            if info.intent_prefixes:
                prefix = (
                    info.intent_prefixes[0]
                    if intent == Intent.QUERY
                    else info.intent_prefixes[1]
                )
                chunks = [prefix + c for c in chunks]
            start = len(all_chunks)
            all_chunks.extend(chunks)
            spans.append((start, len(chunks)))

        vectors = backend(all_chunks, info) if all_chunks else []
        out: List[List[np.ndarray]] = []
        for start, n in spans:
            out.append(vectors[start : start + n])
        return out
