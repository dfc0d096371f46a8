"""Write side (ingest): CQRS command side.

Reference: src/collection_manager/sides/write/ — WriteSide facade
(mod.rs:151: auth, collection/index CRUD, insert/delete/update documents,
reindex, temp index + atomic replace_index, commit loop, embedding loop),
CollectionsWriter, per-index field discovery (index/mod.rs:589), doc-id
map (doc_id_storage.rs:11), embedding queue (embedding.rs:126).

All mutations leave this side only as serialized `Operation`s on the op
log; the write side NEVER calls the read side (SURVEY §1).

The port's copy of `oramacore_tpu/write/__init__.py`, with the same names
and behaviour, built on the port's op bodies (`doc_op.build_doc_op`,
`doc_op.embedding_text`) and embedding queue
(`embedding_queue.EmbeddingQueue`, whose sink sends each `index_embedding`
body to the op log). The doc-id maps are tagged JSON files
(`storage.files.atomic_write_packed`) in place of msgpack.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import OramacoreConfig
from ..embeddings import DEFAULT_MODEL, EmbeddingsService
from ..oplog import Operation, OperationSender
from ..storage.docstore import DocumentStore
from ..storage.files import (
    atomic_write_json,
    atomic_write_packed,
    read_json,
    read_packed,
)
from ..storage.kv import KV
from ..types import ApiKey, CollectionId, IndexId, Locale
from ..utils.flatten import (
    OMC_FIELD,
    flatten_document,
    infer_field_type,
    string_values,
)
from ..utils.tokenizer import NLPService
from .doc_op import build_doc_op, embedding_text
from .embedding_queue import EmbeddingQueue


def generate_doc_id() -> str:
    """cuid2-style random id for documents missing `id`
    (reference ensure_document_id, write/mod.rs:813-815)."""
    return "d" + secrets.token_hex(12)


class WriteError(Exception):
    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


@dataclass
class WriteIndex:
    """Per-index write state: field registry + doc-id map."""

    index_id: str
    locale: str = "english"
    embedding_model: str = DEFAULT_MODEL
    embedding_fields: List[str] = dc_field(default_factory=list)  # source paths; [] = all strings
    automatic_embeddings: bool = True
    # per-field BM25F params: path -> {"weight": w, "b": b}
    # (reference BM25FFieldParams, bm25.rs:49-63)
    field_params: Dict[str, Dict[str, float]] = dc_field(default_factory=dict)
    # discovered field types: path -> type string
    field_types: Dict[str, str] = dc_field(default_factory=dict)
    # user doc id -> internal dense id. NOT in info.json: serialized as
    # its own file ONLY when dirty (the round-1 build re-wrote
    # the full map as JSON on every commit — O(N) per commit at 1M docs)
    doc_id_map: Dict[str, int] = dc_field(default_factory=dict)
    is_temp: bool = False
    # runtime index a temp index was created from: claim-limit counting
    # excludes its docs (they are replaced at promotion — reference
    # write/mod.rs:788 "temp + all_runtime - linked_runtime <= max")
    source_index: Optional[str] = None
    created_at: float = dc_field(default_factory=time.time)
    doc_map_dirty: bool = True
    # LLM auto-selection of embedding properties attempted (run once)
    auto_select_done: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {
            "index_id": self.index_id,
            "locale": self.locale,
            "embedding_model": self.embedding_model,
            "embedding_fields": self.embedding_fields,
            "automatic_embeddings": self.automatic_embeddings,
            "field_params": self.field_params,
            "field_types": self.field_types,
            "is_temp": self.is_temp,
            "source_index": self.source_index,
            "created_at": self.created_at,
            "auto_select_done": self.auto_select_done,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "WriteIndex":
        return cls(
            index_id=d["index_id"],
            locale=d.get("locale", "english"),
            embedding_model=d.get("embedding_model", DEFAULT_MODEL),
            embedding_fields=list(d.get("embedding_fields", [])),
            automatic_embeddings=d.get("automatic_embeddings", True),
            field_params=dict(d.get("field_params", {})),
            field_types=dict(d.get("field_types", {})),
            # legacy info.json carried the map inline
            doc_id_map={k: int(v) for k, v in d.get("doc_id_map", {}).items()},
            is_temp=d.get("is_temp", False),
            source_index=d.get("source_index"),
            created_at=d.get("created_at", time.time()),
            auto_select_done=d.get("auto_select_done", False),
        )


@dataclass
class WriteCollection:
    collection_id: str
    read_api_key: str
    write_api_key: str
    description: Optional[str] = None
    default_locale: str = "english"
    embedding_model: str = DEFAULT_MODEL
    indexes: Dict[str, WriteIndex] = dc_field(default_factory=dict)
    next_doc_id: int = 0
    mcp_description: Optional[str] = None

    def alloc_doc_id(self) -> int:
        v = self.next_doc_id
        self.next_doc_id += 1
        return v

    def to_json(self) -> Dict[str, Any]:
        return {
            "collection_id": self.collection_id,
            "read_api_key": self.read_api_key,
            "write_api_key": self.write_api_key,
            "description": self.description,
            "default_locale": self.default_locale,
            "embedding_model": self.embedding_model,
            "indexes": {k: v.to_json() for k, v in self.indexes.items()},
            "next_doc_id": self.next_doc_id,
            "mcp_description": self.mcp_description,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "WriteCollection":
        c = cls(
            collection_id=d["collection_id"],
            read_api_key=d["read_api_key"],
            write_api_key=d["write_api_key"],
            description=d.get("description"),
            default_locale=d.get("default_locale", "english"),
            embedding_model=d.get("embedding_model", DEFAULT_MODEL),
            next_doc_id=d.get("next_doc_id", 0),
            mcp_description=d.get("mcp_description"),
        )
        c.indexes = {
            k: WriteIndex.from_json(v) for k, v in d.get("indexes", {}).items()
        }
        return c


@dataclass
class InsertStats:
    inserted: int = 0
    replaced: int = 0
    failed: int = 0

    def to_json(self):
        return {
            "inserted": self.inserted,
            "replaced": self.replaced,
            "failed": self.failed,
        }


class WriteSide:
    """The command side. All state mutations emit ops."""

    def __init__(
        self,
        config: OramacoreConfig,
        op_sender: OperationSender,
        embeddings: EmbeddingsService,
        nlp: NLPService,
        sync_embeddings: bool = False,
    ):
        self.config = config
        self.op_sender = op_sender
        self.embeddings = embeddings
        self.nlp = nlp
        self.data_dir = os.path.join(config.data_dir, "writer")
        os.makedirs(self.data_dir, exist_ok=True)
        self.master_api_key = config.auth.master_api_key
        self.collections: Dict[str, WriteCollection] = {}
        self._lock = threading.RLock()
        self.doc_storage = DocumentStore(os.path.join(self.data_dir, "docstore"))
        self.kv = KV(
            os.path.join(self.data_dir, "kv.json"),
            on_write=self._forward_kv,
        )
        self.embedding_queue = EmbeddingQueue(
            embeddings,
            self._send_embedding,
            batch_limit=config.writer_side.embedding_queue_limit,
            synchronous=sync_embeddings,
        )
        self._ops_since_commit = 0
        # sandboxed hook runtime, attached by build_orama
        self.hooks_runtime = None
        # LLM-backed automatic embedding-property selector, attached by
        # the AI service (reference AutomaticEmbeddingsSelector): takes a
        # sample document dict, returns property paths to embed
        self.embeddings_selector = None
        # ingest tokenization pool: the native tokenizer releases the GIL,
        # so batches tokenize in parallel across cores
        from concurrent.futures import ThreadPoolExecutor

        self._tokenize_pool = ThreadPoolExecutor(
            max_workers=min(os.cpu_count() or 4, 16),
            thread_name_prefix="tokenize",
        )
        self._load()

    def _send_embedding(self, collection_id: str, body: Dict[str, Any]):
        self.op_sender.send(
            Operation(kind="index_embedding", collection=collection_id,
                      body=body)
        )

    # ------------------------------------------------------------------
    # Auth
    # ------------------------------------------------------------------

    def check_master_key(self, key: Optional[str]):
        if self.master_api_key and key != self.master_api_key:
            raise WriteError("invalid master api key", 401)

    def check_write_key(
        self,
        collection_id: str,
        key: Optional[str],
        *,
        target_index: Optional[str] = None,
        incoming: int = 0,
    ) -> WriteCollection:
        """ApiKey or JWT bearer (reference write auth: DashboardClaims,
        types.rs:576, with doc-count claim limitations).

        Claim-limited inserts pass the target index + incoming count so
        the limit applies to the POST-insert total; a temp index's count
        excludes its linked runtime index (those docs are replaced at
        promotion — reference write/mod.rs:781-800)."""
        coll = self.collections.get(collection_id)
        if coll is None:
            raise WriteError(f"collection {collection_id!r} not found", 404)
        if key in (coll.write_api_key, self.master_api_key):
            return coll
        jwt_manager = getattr(self, "jwt_manager", None)
        if key and jwt_manager is not None and jwt_manager.looks_like_jwt(key):
            try:
                claims = jwt_manager.dashboard_claims(key)
            except Exception as e:  # noqa: BLE001
                raise WriteError(f"invalid jwt: {e}", 401)
            if claims.collection_id not in (None, collection_id):
                raise WriteError("jwt not valid for this collection", 401)
            if claims.claim_limitations is not None:
                limit = claims.claim_limitations
                target = coll.indexes.get(target_index) if target_index else None
                runtime_total = sum(
                    len(i.doc_id_map)
                    for i in coll.indexes.values() if not i.is_temp
                )
                if target is not None and target.is_temp:
                    # temp + all_runtime - linked_runtime <= max
                    current = runtime_total + len(target.doc_id_map)
                    src = (
                        coll.indexes.get(target.source_index)
                        if target.source_index else None
                    )
                    if src is not None:
                        current -= len(src.doc_id_map)
                else:
                    current = runtime_total
                if current + incoming > limit:
                    raise WriteError(
                        f"document limit exceeded: {limit} docs", 403
                    )
            return coll
        raise WriteError("invalid write api key", 401)

    # ------------------------------------------------------------------
    # Collection / index CRUD
    # ------------------------------------------------------------------

    def create_collection(
        self,
        master_key: Optional[str],
        collection_id: str,
        *,
        read_api_key: Optional[str] = None,
        write_api_key: Optional[str] = None,
        description: Optional[str] = None,
        language: Optional[str] = None,
        embedding_model: Optional[str] = None,
        mcp_description: Optional[str] = None,
    ) -> WriteCollection:
        self.check_master_key(master_key)
        CollectionId(collection_id)  # validate
        with self._lock:
            if collection_id in self.collections:
                raise WriteError(f"collection {collection_id!r} already exists", 409)
            coll = WriteCollection(
                collection_id=collection_id,
                read_api_key=read_api_key or secrets.token_urlsafe(24),
                write_api_key=write_api_key or secrets.token_urlsafe(24),
                description=description,
                default_locale=Locale.parse(language).value,
                embedding_model=embedding_model
                or self.config.writer_side.default_embedding_model,
                mcp_description=mcp_description,
            )
            self.collections[collection_id] = coll
        self.op_sender.send(
            Operation(
                kind="create_collection",
                collection=collection_id,
                body={
                    "read_api_key": coll.read_api_key,
                    "write_api_key": coll.write_api_key,
                    "description": description,
                    "default_locale": coll.default_locale,
                    "embedding_model": coll.embedding_model,
                    "mcp_description": mcp_description,
                },
            )
        )
        self._count_op()
        return coll

    def delete_collection(self, master_key: Optional[str], collection_id: str):
        self.check_master_key(master_key)
        with self._lock:
            coll = self.collections.pop(collection_id, None)
        if coll is None:
            return False
        # drop stored docs
        all_ids = [i for idx in coll.indexes.values() for i in idx.doc_id_map.values()]
        self.doc_storage.remove(all_ids)
        self.op_sender.send(
            Operation(kind="delete_collection", collection=collection_id)
        )
        self._count_op()
        return True

    def list_collections(self, master_key: Optional[str]) -> List[Dict[str, Any]]:
        self.check_master_key(master_key)
        return [self.collection_stats(c) for c in self.collections.values()]

    def collection_stats(self, coll: WriteCollection) -> Dict[str, Any]:
        return {
            "id": coll.collection_id,
            "description": coll.description,
            "default_locale": coll.default_locale,
            "document_count": sum(
                len(i.doc_id_map) for i in coll.indexes.values() if not i.is_temp
            ),
            "indexes": [
                {
                    "id": i.index_id,
                    "document_count": len(i.doc_id_map),
                    "is_temp": i.is_temp,
                    "fields": i.field_types,
                }
                for i in coll.indexes.values()
            ],
        }

    def create_index(
        self,
        collection_id: str,
        write_key: Optional[str],
        index_id: str,
        *,
        embedding_model: Optional[str] = None,
        embedding_fields: Optional[List[str]] = None,
        is_temp: bool = False,
        copy_from: Optional[str] = None,
        locale: Optional[str] = None,
        field_params: Optional[Dict[str, Dict[str, float]]] = None,
        phrase: bool = True,
    ) -> WriteIndex:
        coll = self.check_write_key(collection_id, write_key)
        IndexId(index_id)
        with self._lock:
            if index_id in coll.indexes:
                raise WriteError(f"index {index_id!r} already exists", 409)
            idx = WriteIndex(
                index_id=index_id,
                locale=locale or coll.default_locale,
                embedding_model=embedding_model or coll.embedding_model,
                embedding_fields=embedding_fields or [],
                is_temp=is_temp,
                field_params=field_params or {},
            )
            if locale is None and copy_from and copy_from in coll.indexes:
                src = coll.indexes[copy_from]
                idx.locale = src.locale
            coll.indexes[index_id] = idx
        self.op_sender.send(
            Operation(
                kind="create_index",
                collection=collection_id,
                body={
                    "index": index_id,
                    "locale": idx.locale,
                    "embedding_model": idx.embedding_model,
                    "is_temp": is_temp,
                    "field_params": idx.field_params,
                    # adjacency shadow-term indexing for phrase capability
                    # (~1 extra posting per token occurrence); disable per
                    # index when phrase search isn't needed
                    "phrase": bool(phrase),
                },
            )
        )
        self._count_op()
        return idx

    def delete_index(self, collection_id: str, write_key: Optional[str], index_id: str):
        coll = self.check_write_key(collection_id, write_key)
        with self._lock:
            idx = coll.indexes.pop(index_id, None)
        if idx is None:
            return False
        self.doc_storage.remove(idx.doc_id_map.values())
        self.op_sender.send(
            Operation(
                kind="delete_index",
                collection=collection_id,
                body={"index": index_id},
            )
        )
        self._count_op()
        return True

    # ------------------------------------------------------------------
    # Document ingestion — hot loop #1 (SURVEY §3.2)
    # ------------------------------------------------------------------

    def insert_documents(
        self,
        collection_id: str,
        index_id: str,
        write_key: Optional[str],
        docs: Sequence[Dict[str, Any]],
    ) -> InsertStats:
        coll = self.check_write_key(
            collection_id, write_key,
            target_index=index_id, incoming=len(docs),
        )
        idx = coll.indexes.get(index_id)
        if idx is None:
            raise WriteError(f"index {index_id!r} not found", 404)
        stats = InsertStats()
        ops: List[Operation] = []
        embed_jobs: List[Tuple[str, str, int, str, str]] = []
        parser = self.nlp.get_parser(Locale.parse(idx.locale))
        # TransformDocumentBeforeSave hook (reference write/mod.rs:817-879)
        hook_code = self.kv.get(f"hook:{collection_id}:TransformDocumentBeforeSave")
        if hook_code and self.hooks_runtime is not None:
            transformed = []
            for doc in docs:
                out = self.hooks_runtime.exec_hook(
                    collection_id, "TransformDocumentBeforeSave", hook_code, doc
                )
                if isinstance(out, dict):
                    # id must not change (reference :855-871)
                    if doc.get("id") is not None and out.get("id") != doc.get("id"):
                        out["id"] = doc["id"]
                    transformed.append(out)
                else:
                    transformed.append(doc)
            docs = transformed

        # pre-tokenize every unique string value in parallel (memoized;
        # the native tokenizer releases the GIL during execution)
        unique_texts: List[str] = []
        seen_texts = set()
        for doc in docs:
            if not isinstance(doc, dict):
                continue
            for value in flatten_document(doc).values():
                for text in string_values(value):
                    if text and text not in seen_texts:
                        seen_texts.add(text)
                        unique_texts.append(text)
        if len(unique_texts) > 8:
            if (os.cpu_count() or 1) > 1:
                packed_list = list(
                    self._tokenize_pool.map(
                        parser.tokenize_and_stem_packed, unique_texts
                    )
                )
            else:
                # single-core host: the pool is pure futures/lock
                # overhead (the GIL-releasing native tokenizer can't
                # overlap with anything)
                packed_list = [
                    parser.tokenize_and_stem_packed(t) for t in unique_texts
                ]
            token_cache = dict(zip(unique_texts, packed_list))
        else:
            token_cache = {}

        # automatic embedding-property selection (reference
        # write/index/mod.rs:589 path → AutomaticEmbeddingsSelector LLM
        # call on field discovery): when the index is in automatic mode
        # with no explicit embedding_fields and an LLM-backed selector is
        # attached, ask it ONCE which properties carry semantic text
        if (idx.automatic_embeddings and not idx.embedding_fields
                and not getattr(idx, "auto_select_done", False)
                and self.embeddings_selector is not None):
            sample = next((d for d in docs if isinstance(d, dict)), None)
            if sample is not None:
                try:
                    chosen = self.embeddings_selector(sample) or []
                    flat_sample = flatten_document(dict(sample))
                    valid = [
                        p for p in chosen
                        if p in flat_sample and string_values(flat_sample[p])
                    ]
                    if valid:
                        idx.embedding_fields = valid
                        logging.getLogger("oramacore_tpu.write").info(
                            "auto-selected embedding properties for "
                            "%s/%s: %s", collection_id, index_id, valid,
                        )
                except Exception:  # noqa: BLE001 — fall back to all strings
                    pass
                idx.auto_select_done = True

        for doc in docs:
            if not isinstance(doc, dict):
                stats.failed += 1
                continue
            doc = dict(doc)
            user_id = doc.get("id")
            if user_id is None or not isinstance(user_id, str) or not user_id:
                user_id = generate_doc_id()
                doc["id"] = user_id
            replaced = user_id in idx.doc_id_map
            if replaced:
                old = idx.doc_id_map[user_id]
                ops.append(
                    Operation(
                        kind="delete_documents",
                        collection=collection_id,
                        body={"index": index_id, "doc_ids": [old]},
                    )
                )
                self.doc_storage.remove([old])
                stats.replaced += 1
            else:
                stats.inserted += 1
            internal = coll.alloc_doc_id()
            idx.doc_id_map[user_id] = internal
            idx.doc_map_dirty = True

            raw = json.dumps(doc).encode()
            self.doc_storage.insert(internal, raw)

            flat = flatten_document(doc)
            self._discover_fields(collection_id, idx, flat, ops)
            body = self._build_doc_op(
                idx, parser, internal, user_id, flat, doc, token_cache
            )
            body["index"] = index_id
            ops.append(
                Operation(kind="index_document", collection=collection_id, body=body)
            )
            # embeddings: async queue — submitted AFTER the index ops batch
            # so index_embedding ops always follow their index_document op
            # in the stream (matching the reference's async embedding loop
            # ordering, write/embedding.rs:126)
            text = self._embedding_text(idx, flat)
            if text:
                embed_jobs.append(
                    (collection_id, index_id, internal, idx.embedding_model, text)
                )
        self.op_sender.send_batch(ops)
        self.embedding_queue.submit_many(embed_jobs)
        self._count_op(len(ops))
        return stats

    def _discover_fields(
        self,
        collection_id: str,
        idx: WriteIndex,
        flat: Dict[str, Any],
        ops: List[Operation],
    ):
        """Automatic field discovery (reference add_fields_if_needed,
        write/index/mod.rs:589)."""
        for path, value in flat.items():
            if path == "id" or path == OMC_FIELD:
                continue
            t = infer_field_type(value)
            if t is None:
                continue
            known = idx.field_types.get(path)
            if known is None:
                idx.field_types[path] = t
                ops.append(
                    Operation(
                        kind="create_field",
                        collection=collection_id,
                        body={"index": idx.index_id, "path": path, "type": t},
                    )
                )

    def _build_doc_op(
        self,
        idx: WriteIndex,
        parser,
        internal: int,
        user_id: str,
        flat: Dict[str, Any],
        raw_doc: Dict[str, Any],
        token_cache: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Tokenize + type per-field values → op payload. The write side
        does the tokenization (reference fields.rs:715); the read side
        applies pre-parsed values."""
        return build_doc_op(idx.field_types, parser, internal, user_id,
                            flat, raw_doc, token_cache)

    def _embedding_text(self, idx: WriteIndex, flat: Dict[str, Any]) -> str:
        """Compose the text to embed per DocumentFields semantics
        (types.rs:519-524): explicit properties or all string fields."""
        return embedding_text(flat, idx.embedding_fields,
                              idx.automatic_embeddings)

    def delete_documents(
        self,
        collection_id: str,
        index_id: str,
        write_key: Optional[str],
        user_ids: Sequence[str],
    ) -> int:
        coll = self.check_write_key(collection_id, write_key)
        idx = coll.indexes.get(index_id)
        if idx is None:
            raise WriteError(f"index {index_id!r} not found", 404)
        internal: List[int] = []
        for uid in user_ids:
            d = idx.doc_id_map.pop(uid, None)
            if d is not None:
                internal.append(d)
                idx.doc_map_dirty = True
        if internal:
            self.doc_storage.remove(internal)
            self.op_sender.send(
                Operation(
                    kind="delete_documents",
                    collection=collection_id,
                    body={"index": index_id, "doc_ids": internal},
                )
            )
            self._count_op()
        return len(internal)

    def update_documents(
        self,
        collection_id: str,
        index_id: str,
        write_key: Optional[str],
        docs: Sequence[Dict[str, Any]],
    ) -> InsertStats:
        """Upsert semantics == insert (replacement detected by doc-id map)."""
        return self.insert_documents(collection_id, index_id, write_key, docs)

    def list_documents(
        self,
        collection_id: str,
        write_key: Optional[str],
        index_ids: Optional[Sequence[str]] = None,
    ) -> List[Dict[str, Any]]:
        """Every document of the collection (optionally restricted to
        index_ids), hydrated from the write-side doc storage — the
        reference's list_document facade (write/mod.rs:1256-1286,
        POST /v1/collections/list)."""
        coll = self.check_write_key(collection_id, write_key)
        want = set(index_ids) if index_ids is not None else None
        ids: List[int] = []
        for iid, idx in coll.indexes.items():
            if idx.is_temp:
                continue
            if want is not None and iid not in want:
                continue
            ids.extend(idx.doc_id_map.values())
        ids.sort()
        blobs = self.doc_storage.get_documents_by_ids(ids)
        return [json.loads(blobs[d]) for d in ids if d in blobs]

    # ------------------------------------------------------------------
    # Reindex & index replacement (SURVEY §3.6)
    # ------------------------------------------------------------------

    def create_temporary_index(
        self,
        collection_id: str,
        write_key: Optional[str],
        source_index_id: str,
        temp_index_id: Optional[str] = None,
        embedding_model: Optional[str] = None,
        locale: Optional[str] = None,
    ) -> WriteIndex:
        coll = self.check_write_key(collection_id, write_key)
        if source_index_id not in coll.indexes:
            raise WriteError(f"index {source_index_id!r} not found", 404)
        tid = temp_index_id or f"{source_index_id}-temp-{secrets.token_hex(4)}"
        idx = self.create_index(
            collection_id,
            write_key,
            tid,
            embedding_model=embedding_model,
            is_temp=True,
            copy_from=source_index_id,
            locale=locale,
        )
        idx.source_index = source_index_id
        return idx

    def replace_index(
        self,
        collection_id: str,
        write_key: Optional[str],
        target_index_id: str,
        temp_index_id: str,
        reason: str = "IndexResynced",
    ):
        """Atomically promote temp index to the runtime id. The read side
        keeps the temp id as an alias so in-flight embedding ops still land
        (reference read/index/mod.rs:112-118,864)."""
        coll = self.check_write_key(collection_id, write_key)
        with self._lock:
            temp = coll.indexes.get(temp_index_id)
            if temp is None:
                raise WriteError(f"temp index {temp_index_id!r} not found", 404)
            old = coll.indexes.pop(target_index_id, None)
            if old is not None:
                self.doc_storage.remove(old.doc_id_map.values())
            temp.is_temp = False
            coll.indexes[target_index_id] = temp
            del coll.indexes[temp_index_id]
            temp.index_id = target_index_id
        self.op_sender.send(
            Operation(
                kind="replace_index",
                collection=collection_id,
                body={
                    "target": target_index_id,
                    "temp": temp_index_id,
                    "reason": reason,
                },
            )
        )
        self._count_op()

    def reindex(
        self,
        collection_id: str,
        write_key: Optional[str],
        *,
        language: Optional[str] = None,
        embedding_model: Optional[str] = None,
    ):
        """Rebuild every runtime index through a temp index + replace
        (reference write/mod.rs:494-639)."""
        coll = self.check_write_key(collection_id, write_key)
        if language:
            coll.default_locale = Locale.parse(language).value
        if embedding_model:
            coll.embedding_model = embedding_model
        runtime = [i for i in list(coll.indexes.values()) if not i.is_temp]
        for idx in runtime:
            temp = self.create_temporary_index(
                collection_id, write_key, idx.index_id,
                embedding_model=embedding_model,
                locale=coll.default_locale,
            )
            # stream docs from storage in batches (write/mod.rs:544-547)
            ids = sorted(idx.doc_id_map.values())
            blobs = self.doc_storage.get_documents_by_ids(ids)
            docs = [json.loads(blobs[d]) for d in ids if d in blobs]
            for i in range(0, len(docs), 50):
                self.insert_documents(
                    collection_id, temp.index_id, write_key, docs[i : i + 50]
                )
            self.replace_index(
                collection_id, write_key, idx.index_id, temp.index_id,
                reason="CollectionReindexed",
            )

    def gc_temp_indexes(self, max_age_seconds: float = 12 * 3600):
        """Drop stale temporary indexes (reference cleanup loop,
        write/mod.rs:1731)."""
        now = time.time()
        for coll in list(self.collections.values()):
            for idx in list(coll.indexes.values()):
                if idx.is_temp and now - idx.created_at > max_age_seconds:
                    self.delete_index(
                        coll.collection_id, coll.write_api_key, idx.index_id
                    )

    # ------------------------------------------------------------------
    # KV forwarding (system prompts / tools / training sets replication)
    # ------------------------------------------------------------------

    def _forward_kv(self, key: str, value: Optional[Any]):
        self.op_sender.send(
            Operation(
                kind="kv_insert" if value is not None else "kv_delete",
                body={"key": key, "value": value},
            )
        )

    # ------------------------------------------------------------------
    # Hooks / merchandising / values — stored write-side, replicated
    # ------------------------------------------------------------------

    def set_hook(self, collection_id: str, write_key: Optional[str], name: str, code: str):
        self.check_write_key(collection_id, write_key)
        self.kv.insert(f"hook:{collection_id}:{name}", code, forward=False)
        self.op_sender.send(
            Operation(
                kind="hook_insert",
                collection=collection_id,
                body={"name": name, "code": code},
            )
        )
        self._count_op()

    def delete_hook(self, collection_id: str, write_key: Optional[str], name: str):
        self.check_write_key(collection_id, write_key)
        self.kv.remove(f"hook:{collection_id}:{name}", forward=False)
        self.op_sender.send(
            Operation(
                kind="hook_delete", collection=collection_id, body={"name": name}
            )
        )
        self._count_op()

    def list_hooks(self, collection_id: str, write_key: Optional[str]) -> Dict[str, str]:
        self.check_write_key(collection_id, write_key)
        prefix = f"hook:{collection_id}:"
        return {k[len(prefix):]: v for k, v in self.kv.scan_prefix(prefix)}

    def insert_pin_rule(self, collection_id: str, write_key: Optional[str], rule: Dict[str, Any]):
        self.check_write_key(collection_id, write_key)
        self.kv.insert(f"pinrule:{collection_id}:{rule['id']}", rule, forward=False)
        self.op_sender.send(
            Operation(kind="pin_rule_insert", collection=collection_id, body=rule)
        )
        self._count_op()

    def delete_pin_rule(self, collection_id: str, write_key: Optional[str], rule_id: str):
        self.check_write_key(collection_id, write_key)
        self.kv.remove(f"pinrule:{collection_id}:{rule_id}", forward=False)
        self.op_sender.send(
            Operation(
                kind="pin_rule_delete", collection=collection_id, body={"id": rule_id}
            )
        )
        self._count_op()

    def list_pin_rules(self, collection_id: str, write_key: Optional[str]) -> List[Dict[str, Any]]:
        self.check_write_key(collection_id, write_key)
        return [v for _, v in self.kv.scan_prefix(f"pinrule:{collection_id}:")]

    def insert_shelf(self, collection_id: str, write_key: Optional[str], shelf: Dict[str, Any]):
        self.check_write_key(collection_id, write_key)
        self.kv.insert(f"shelf:{collection_id}:{shelf['id']}", shelf, forward=False)
        self.op_sender.send(
            Operation(kind="shelf_insert", collection=collection_id, body=shelf)
        )
        self._count_op()

    def delete_shelf(self, collection_id: str, write_key: Optional[str], shelf_id: str):
        self.check_write_key(collection_id, write_key)
        self.kv.remove(f"shelf:{collection_id}:{shelf_id}", forward=False)
        self.op_sender.send(
            Operation(
                kind="shelf_delete", collection=collection_id, body={"id": shelf_id}
            )
        )
        self._count_op()

    def list_shelves(self, collection_id: str, write_key: Optional[str]) -> List[Dict[str, Any]]:
        self.check_write_key(collection_id, write_key)
        return [v for _, v in self.kv.scan_prefix(f"shelf:{collection_id}:")]

    def set_value(self, collection_id: str, write_key: Optional[str], key: str, value: str):
        self.check_write_key(collection_id, write_key)
        self.kv.insert(f"value:{collection_id}:{key}", value, forward=False)
        self.op_sender.send(
            Operation(
                kind="value_set",
                collection=collection_id,
                body={"key": key, "value": value},
            )
        )
        self._count_op()

    def delete_value(self, collection_id: str, write_key: Optional[str], key: str):
        self.check_write_key(collection_id, write_key)
        self.kv.remove(f"value:{collection_id}:{key}", forward=False)
        self.op_sender.send(
            Operation(
                kind="value_delete", collection=collection_id, body={"key": key}
            )
        )
        self._count_op()

    def list_values(self, collection_id: str, write_key: Optional[str]) -> Dict[str, str]:
        self.check_write_key(collection_id, write_key)
        prefix = f"value:{collection_id}:"
        return {k[len(prefix):]: v for k, v in self.kv.scan_prefix(prefix)}

    def regenerate_read_api_key(self, collection_id: str, master_key: Optional[str]) -> str:
        self.check_master_key(master_key)
        coll = self.collections.get(collection_id)
        if coll is None:
            raise WriteError(f"collection {collection_id!r} not found", 404)
        coll.read_api_key = secrets.token_urlsafe(24)
        self.op_sender.send(
            Operation(
                kind="update_read_api_key",
                collection=collection_id,
                body={"read_api_key": coll.read_api_key},
            )
        )
        self._count_op()
        return coll.read_api_key

    # ------------------------------------------------------------------
    # Commit / load (SURVEY §5.4)
    # ------------------------------------------------------------------

    def _count_op(self, n: int = 1):
        self._ops_since_commit += n
        if self._ops_since_commit >= self.config.writer_side.insert_batch_commit_size:
            self.commit()

    def _doc_map_path(self, cid: str, iid: str) -> str:
        safe = lambda s: s.replace("/", "_")  # noqa: E731
        return os.path.join(
            self.data_dir, "doc_maps", safe(cid), safe(iid) + ".json"
        )

    def commit(self):
        with self._lock:
            self.doc_storage.commit()
            self.kv.commit()
            # doc-id maps persist per index, one file each, ONLY when dirty —
            # info.json stays O(schema), not O(corpus)
            for cid, coll in self.collections.items():
                for iid, idx in coll.indexes.items():
                    if idx.doc_map_dirty:
                        # insert_documents fills the map without this
                        # lock: write a copy (taken whole under the GIL)
                        # and clear the flag first, so an insert that
                        # lands meanwhile marks it dirty again
                        idx.doc_map_dirty = False
                        atomic_write_packed(
                            self._doc_map_path(cid, iid), dict(idx.doc_id_map)
                        )
            atomic_write_json(
                os.path.join(self.data_dir, "info.json"),
                {
                    "v": 2,
                    "offset": self.op_sender.offset,
                    "collections": {
                        k: v.to_json() for k, v in self.collections.items()
                    },
                },
            )
            self._ops_since_commit = 0

    def _load(self):
        info = read_json(os.path.join(self.data_dir, "info.json"))
        if info:
            # resume op numbering from the persisted offset so a
            # restarted in-memory channel's fresh ops are NOT deduped
            # as replays by a reader that committed up to that offset
            # (reference seeds the in-memory AtomicU64 the same way,
            # operation/mod.rs:188-193; durable transports resume from
            # their own stream and ignore this)
            resume = getattr(self.op_sender, "resume_from", None)
            if resume is not None and info.get("offset"):
                resume(int(info["offset"]))
            self.collections = {
                k: WriteCollection.from_json(v)
                for k, v in info.get("collections", {}).items()
            }
            for cid, coll in self.collections.items():
                for iid, idx in coll.indexes.items():
                    if not idx.doc_id_map:  # v2: map lives in its own file
                        m = read_packed(
                            self._doc_map_path(cid, iid), default=None
                        )
                        if m:
                            idx.doc_id_map = {
                                str(k): int(v) for k, v in m.items()
                            }
                        idx.doc_map_dirty = False
                    else:
                        # legacy v1: the map came inline from info.json —
                        # keep it DIRTY so the first v2 commit writes the
                        # per-index file (marking it clean here would
                        # drop the map entirely at the next commit)
                        idx.doc_map_dirty = True

    def stop(self):
        self.embedding_queue.stop()
        self._tokenize_pool.shutdown(wait=False)
        self.commit()
