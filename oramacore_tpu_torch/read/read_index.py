"""Per-index read state: string + filter + vector storages, op apply.

Reference: read/index/mod.rs — `Index` (:107): per-field storage maps,
deleted-doc set, OMC log (:172-179), aliases (:112-118), search-store
snapshots (:404), structural vs data ops (:1246,:1436), commit (:466-719).

The port's copy of `oramacore_tpu/read/read_index.py`, with the same
names and behaviour. The one difference: the port's `VectorIndex` lives
on a device, so `ReadIndex` and `ReadIndex.load` take the read side's
`device` and pass it on.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Set

import numpy as np

from ..embeddings import MODELS
from ..index.filter_fields import (
    FilterFields,
    load_filter_fields,
    save_filter_fields,
)
from ..index.string_index import StringIndex, load_string_index, save_string_index
from ..index.vector_index import (
    VectorIndex,
    VectorIndexConfig,
    load_vector_index,
    save_vector_index,
)
from ..storage.files import atomic_write_json, read_json
from ..types import Locale
from ..utils.tokenizer import NLPService


_READ_INDEX_UIDS = __import__("itertools").count(1)


class ReadIndex:
    def __init__(self, index_id: str, locale: str, embedding_model: str,
                 nlp: NLPService, device):
        # process-unique id for executor-level device caches (omc arrays
        # are keyed on (uid, omc_version); version alone collides across
        # index objects)
        self.uid = next(_READ_INDEX_UIDS)
        self.index_id = index_id
        self.locale = locale
        self.embedding_model = embedding_model
        self.nlp = nlp
        self.device = device
        self.string = StringIndex()
        self.filters = FilterFields()
        self.vector: Optional[VectorIndex] = None
        # internal doc id -> user id (for hit assembly) + membership
        self.doc_user_ids: Dict[int, str] = {}
        self.user_to_internal: Dict[str, int] = {}
        self.deleted: Set[int] = set()
        self.omc: Dict[int, float] = {}
        self.max_doc_id = -1
        # declared field types (from create_field ops): path -> type
        self.field_types: Dict[str, str] = {}
        # per-field BM25F params (weight, b) from index config
        self.field_params: Dict[str, Any] = {}
        # op-log offset included in this index's committed structures
        # (reference offset-N snapshot dirs, read/index/mod.rs:466-719)
        self.committed_offset = 0
        # data ops applied since the last save (skip clean snapshots)
        self.dirty = True
        # metadata captured atomically in commit_memory for the next save
        # (saving live dicts during concurrent op application would race)
        self._meta_snapshot: Optional[Dict[str, Any]] = None
        # dense OMC multiplier cache for the fused kernels (ADVICE r1:
        # OMC must apply BEFORE device top-k, not to the candidate set)
        self.omc_version = 0
        self._omc_arr: Optional[np.ndarray] = None
        # tombstone-mask cache + monotonic version (bumped on EVERY
        # deleted-set mutation incl. resurrection discards, so the key
        # never aliases two different masks)
        self.tombstone_version = 0
        self._alive_mask_cache: Optional[tuple] = None
        # presence (exists AND alive) version + mask cache: match-all
        # searches page/count/facet over a vectorized bool[cap] instead
        # of an O(corpus) python dict (empty-term browse at scale)
        self.presence_version = 0
        self._present_mask_cache: Optional[tuple] = None

    # ------------------------------------------------------------------

    @property
    def parser(self):
        return self.nlp.get_parser(Locale.parse(self.locale))

    def document_count(self) -> int:
        return len(self.doc_user_ids)

    def alive_doc_ids(self):
        """Internal ids of live (non-tombstoned) docs — the match-all set
        for empty-term searches (reference test_fulltext_empty_term)."""
        if not self.deleted:
            return list(self.doc_user_ids)
        return [d for d in self.doc_user_ids if d not in self.deleted]

    def cap(self) -> int:
        return max(self.max_doc_id + 1, 1)

    def _ensure_vector(self, dim: int):
        if self.vector is None:
            info = MODELS.get(self.embedding_model)
            rescale = info.score_rescale if info else None
            self.vector = VectorIndex(
                VectorIndexConfig(
                    dim=dim, model=self.embedding_model, score_rescale=rescale
                ),
                self.device,
            )

    # ------------------------------------------------------------------
    # Op application (reference update_structure / update_data)
    # ------------------------------------------------------------------

    def apply_create_field(self, body: Dict[str, Any]):
        self.dirty = True
        self.field_types[body["path"]] = body["type"]
        if body["type"] in ("string", "string[]"):
            self.string.ensure_field(body["path"])

    def apply_index_document(self, body: Dict[str, Any]):
        self.dirty = True
        doc_id = int(body["doc_id"])
        user_id = body["user_id"]
        self.max_doc_id = max(self.max_doc_id, doc_id)
        self.doc_user_ids[doc_id] = user_id
        self.user_to_internal[user_id] = doc_id
        if doc_id in self.deleted:
            self.deleted.discard(doc_id)
            self.tombstone_version += 1
        self.presence_version += 1
        for path, packed in (body.get("strings_packed") or {}).items():
            self.string.index_text_packed(
                doc_id, path, int(packed[0]), packed[1]
            )
        for path, parsed in (body.get("strings") or {}).items():
            # legacy (pre-packed) op format: durable logs written by
            # older builds carry per-token [surface, variants] lists
            self.string.index_text(
                doc_id, path, [(t, list(v)) for t, v in parsed]
            )
        for path, values in (body.get("numbers") or {}).items():
            self.filters.number(path).insert(doc_id, values)
        for path, value in (body.get("bools") or {}).items():
            self.filters.bool_(path).insert(doc_id, value)
        for path, values in (body.get("string_filters") or {}).items():
            self.filters.string(path).insert(doc_id, values)
        for path, latlon in (body.get("geos") or {}).items():
            self.filters.geo(path).insert(doc_id, latlon[0], latlon[1])
        for path, values in (body.get("dates") or {}).items():
            for v in values:
                self.filters.date(path).insert(doc_id, v)
        omc = body.get("omc")
        if omc is not None:
            self.omc[doc_id] = float(omc)
            self.omc_version += 1
            self._omc_arr = None

    def apply_index_embedding(self, body: Dict[str, Any]):
        vectors = [np.asarray(v, np.float32) for v in body["vectors"]]
        if not vectors:
            return
        self._ensure_vector(len(vectors[0]))
        doc_id = int(body["doc_id"])
        if doc_id in self.deleted or doc_id not in self.doc_user_ids:
            # late embedding for an already-deleted doc: skip
            return
        self.dirty = True
        self.vector.insert(doc_id, vectors)

    def apply_delete_documents(self, body: Dict[str, Any]):
        self.dirty = True
        for d in body["doc_ids"]:
            d = int(d)
            user = self.doc_user_ids.pop(d, None)
            if user is not None:
                self.user_to_internal.pop(user, None)
            if d not in self.deleted:
                self.deleted.add(d)
                self.tombstone_version += 1
            self.presence_version += 1
            self.string.delete_doc_live(d)
            self.filters.delete_doc_live(d)
            if self.vector is not None:
                self.vector.delete_doc_live(d)
            if self.omc.pop(d, None) is not None:
                self.omc_version += 1
                self._omc_arr = None

    # ------------------------------------------------------------------
    # Masks
    # ------------------------------------------------------------------

    def alive_mask(self) -> Optional[np.ndarray]:
        """None when no tombstones (all committed docs alive).

        Cached by (cap, tombstone_version); the version bumps on every
        deleted-set mutation (delete, resurrection discard, commit
        clear), so the key never aliases two different masks. Callers
        treat the array as read-only; the identity stability also lets
        batch paths detect a shared tombstone-only mask across queries
        by `is`."""
        if not self.deleted:
            return None
        key = (self.cap(), self.tombstone_version)
        cached = self._alive_mask_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        mask = np.ones(self.cap(), bool)
        for d in self.deleted:
            if d < len(mask):
                mask[d] = False
        self._alive_mask_cache = (key, mask)
        return mask

    def present_mask(self) -> np.ndarray:
        """bool[cap]: docs that EXIST in this index and are alive — the
        match-all set (empty-term searches, reference
        fulltext_search.rs test_fulltext_empty_term / bugs.rs
        test_bug_1). Cached by (cap, presence_version); callers treat
        it as read-only. Doc ids are collection-global, so an index's
        id space has gaps — membership comes from doc_user_ids, not
        from the cap range."""
        key = (self.cap(), self.presence_version)
        cached = self._present_mask_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        mask = np.zeros(self.cap(), bool)
        if self.doc_user_ids:
            ids = np.fromiter(
                self.doc_user_ids.keys(), np.int64, len(self.doc_user_ids)
            )
            mask[ids[ids < len(mask)]] = True
        if self.deleted:
            for d in self.deleted:
                if d < len(mask):
                    mask[d] = False
        self._present_mask_cache = (key, mask)
        return mask

    def omc_array(self) -> Optional[np.ndarray]:
        """Dense f32[cap] OMC multipliers (1.0 default), cached until the
        omc map changes. Must be read under the state read lock."""
        if not self.omc:
            return None
        cap = self.cap()
        arr = self._omc_arr
        if arr is None or len(arr) < cap:
            arr = np.ones(cap, np.float32)
            for d, m in self.omc.items():
                if d < cap:
                    arr[d] = m
            self._omc_arr = arr
        return arr

    def combined_mask(self, filter_mask: Optional[np.ndarray]) -> Optional[np.ndarray]:
        alive = self.alive_mask()
        if alive is None:
            return filter_mask
        if filter_mask is None:
            return alive
        return alive & filter_mask

    # ------------------------------------------------------------------
    # Commit / load (offset-N snapshot dirs)
    # ------------------------------------------------------------------

    def commit_memory(self, offset: int) -> None:
        """Merge live layers into the committed structures and capture a
        consistent metadata snapshot. MUST run under the read side's state
        WRITE lock: it mutates structures concurrent searches read
        (StringIndex live dicts, tombstones, filter columns)."""
        self.string.commit(self.deleted)
        self.filters.commit(self.deleted)
        if self.vector is not None:
            self.vector.commit(self.deleted)
        self.deleted.clear()
        self.tombstone_version += 1
        self.committed_offset = offset
        self.dirty = False
        self._meta_snapshot = {
            "index_id": self.index_id,
            "locale": self.locale,
            "embedding_model": self.embedding_model,
            "field_types": dict(self.field_types),
            "field_params": dict(self.field_params),
            "doc_user_ids": {str(k): v for k, v in self.doc_user_ids.items()},
            "omc": {str(k): v for k, v in self.omc.items()},
            "max_doc_id": self.max_doc_id,
            "vector_dim": self.vector.config.dim if self.vector else None,
            "committed_offset": offset,
            "phrase": self.string.index_bigrams,
        }

    def save(self, dir_path: str) -> None:
        """Persist the committed state into an offset-N generation dir and
        atomically repoint CURRENT (reference read/index/mod.rs:466-719
        offset dirs). File I/O only — safe outside the state lock (only
        commit_memory mutates committed structures, and commits are
        serialized). Keeps the previous generation for crash recovery."""
        meta = self._meta_snapshot
        assert meta is not None, "save() requires a prior commit_memory()"
        offset = int(meta["committed_offset"])
        gen_dir = os.path.join(dir_path, f"offset-{offset}")
        os.makedirs(gen_dir, exist_ok=True)
        save_string_index(self.string, os.path.join(gen_dir, "string"))
        save_filter_fields(self.filters, os.path.join(gen_dir, "filters"))
        if self.vector is not None:
            save_vector_index(self.vector, os.path.join(gen_dir, "vector"))
        atomic_write_json(os.path.join(gen_dir, "index.json"), meta)
        atomic_write_json(
            os.path.join(dir_path, "CURRENT.json"), {"offset": offset}
        )
        # GC: keep the current generation + the newest previous one
        import shutil

        gens = sorted(
            int(n.split("-", 1)[1])
            for n in os.listdir(dir_path)
            if n.startswith("offset-") and n.split("-", 1)[1].isdigit()
        )
        keep = {offset}
        older = [g for g in gens if g < offset]
        if older:
            keep.add(older[-1])
        for g in gens:
            if g not in keep:
                shutil.rmtree(
                    os.path.join(dir_path, f"offset-{g}"), ignore_errors=True
                )

    def commit(self, dir_path: str, offset: int = 0):
        """Convenience: commit_memory + save (single-threaded callers)."""
        self.commit_memory(offset)
        self.save(dir_path)

    @classmethod
    def load(cls, dir_path: str, nlp: NLPService,
             device) -> Optional["ReadIndex"]:
        # resolve the current generation dir; fall back to the newest
        # loadable generation, then to the legacy flat layout
        candidates: List[str] = []
        cur = read_json(os.path.join(dir_path, "CURRENT.json"))
        if cur and "offset" in cur:
            candidates.append(os.path.join(dir_path, f"offset-{cur['offset']}"))
        if os.path.isdir(dir_path):
            gens = sorted(
                (
                    int(n.split("-", 1)[1])
                    for n in os.listdir(dir_path)
                    if n.startswith("offset-") and n.split("-", 1)[1].isdigit()
                ),
                reverse=True,
            )
            candidates.extend(
                os.path.join(dir_path, f"offset-{g}") for g in gens
            )
        candidates.append(dir_path)  # legacy flat layout
        meta = None
        for cand in candidates:
            meta = read_json(os.path.join(cand, "index.json"))
            if meta:
                dir_path = cand
                break
        if not meta:
            return None
        idx = cls(
            meta["index_id"], meta.get("locale", "english"),
            meta.get("embedding_model", "builtin-minihash-384"), nlp, device,
        )
        idx.committed_offset = int(meta.get("committed_offset", 0))
        idx.dirty = False
        idx.string.index_bigrams = bool(meta.get("phrase", True))
        idx.field_types = dict(meta.get("field_types", {}))
        idx.field_params = dict(meta.get("field_params", {}))
        idx.doc_user_ids = {int(k): v for k, v in meta.get("doc_user_ids", {}).items()}
        idx.user_to_internal = {v: k for k, v in idx.doc_user_ids.items()}
        idx.omc = {int(k): float(v) for k, v in meta.get("omc", {}).items()}
        idx.max_doc_id = meta.get("max_doc_id", -1)
        idx.string = load_string_index(os.path.join(dir_path, "string"))
        idx.filters = load_filter_fields(os.path.join(dir_path, "filters"))
        dim = meta.get("vector_dim")
        if dim:
            info = MODELS.get(idx.embedding_model)
            rescale = info.score_rescale if info else None
            idx.vector = load_vector_index(
                os.path.join(dir_path, "vector"),
                VectorIndexConfig(dim=dim, model=idx.embedding_model, score_rescale=rescale),
                device,
            )
        return idx

    def stats(self) -> Dict[str, Any]:
        return {
            "id": self.index_id,
            "document_count": self.document_count(),
            "fields": self.field_types,
            "locale": self.locale,
            "embedding_model": self.embedding_model,
            "string_info": self.string.info(),
            "vector_rows": self.vector.n_rows() if self.vector else 0,
        }
