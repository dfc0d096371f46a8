"""Paged append-only document blob store — the zebo equivalent.

Reference: `zebo::Zebo<1_000_000, PAGE_SIZE, DocumentId>` used by
write/document_storage.rs:7-22 and read/document_storage.rs:240.
Documents are raw JSON blobs addressed by internal DocumentId; pages are
append-only files with an in-memory (persisted) index mapping
doc_id -> (page, offset, length). Removal is a tombstone in the index;
page space is reclaimed by a compaction pass.

The port's copy of `oramacore_tpu/storage/docstore.py`, with the same names and
behaviour. Its index file is tagged JSON (`index.json`,
`files.atomic_write_packed`) in place of `index.msgpack`.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from .files import atomic_write_packed, read_packed

DOCS_PER_PAGE = 1_000_000
MAX_PAGE_BYTES = 512 * 1024 * 1024


class DocumentStore:
    """Append-only paged blob store keyed by dense internal doc ids."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._lock = threading.RLock()
        # doc_id -> (page_no, offset, length)
        self._index: Dict[int, Tuple[int, int, int]] = {}
        self._page_no = 0
        self._page_fh = None
        self._page_bytes = 0
        self._page_docs = 0
        self._load()

    # ------------------------------------------------------------------

    def _page_path(self, page_no: int) -> str:
        return os.path.join(self.data_dir, f"page-{page_no:06d}.bin")

    def _index_path(self) -> str:
        return os.path.join(self.data_dir, "index.json")

    def _load(self) -> None:
        raw = read_packed(self._index_path(), default=None)
        if raw:
            self._index = {int(k): tuple(v) for k, v in raw["index"].items()}
            self._page_no = raw["page_no"]
            self._page_docs = raw.get("page_docs", 0)
        path = self._page_path(self._page_no)
        self._page_bytes = os.path.getsize(path) if os.path.exists(path) else 0

    def _open_page(self):
        if self._page_fh is None:
            self._page_fh = open(self._page_path(self._page_no), "ab")
        return self._page_fh

    def _roll_page_if_needed(self):
        if self._page_docs >= DOCS_PER_PAGE or self._page_bytes >= MAX_PAGE_BYTES:
            if self._page_fh:
                self._page_fh.close()
                self._page_fh = None
            self._page_no += 1
            self._page_bytes = 0
            self._page_docs = 0

    # ------------------------------------------------------------------

    def insert(self, doc_id: int, blob: bytes) -> None:
        with self._lock:
            self._roll_page_if_needed()
            fh = self._open_page()
            offset = self._page_bytes
            fh.write(blob)
            fh.flush()
            self._index[doc_id] = (self._page_no, offset, len(blob))
            self._page_bytes += len(blob)
            self._page_docs += 1

    def insert_many(self, items: Iterable[Tuple[int, bytes]]) -> None:
        for doc_id, blob in items:
            self.insert(doc_id, blob)

    def get(self, doc_id: int) -> Optional[bytes]:
        with self._lock:
            loc = self._index.get(doc_id)
        if loc is None:
            return None
        page_no, offset, length = loc
        with open(self._page_path(page_no), "rb") as fh:
            fh.seek(offset)
            return fh.read(length)

    def get_documents_by_ids(self, doc_ids: Iterable[int]) -> Dict[int, bytes]:
        out: Dict[int, bytes] = {}
        # group by page to read each page once
        by_page: Dict[int, List[Tuple[int, int, int]]] = {}
        with self._lock:
            for d in doc_ids:
                loc = self._index.get(d)
                if loc:
                    by_page.setdefault(loc[0], []).append((d, loc[1], loc[2]))
        for page_no, entries in by_page.items():
            path = self._page_path(page_no)
            if not os.path.exists(path):
                continue
            with open(path, "rb") as fh:
                for d, offset, length in sorted(entries, key=lambda e: e[1]):
                    fh.seek(offset)
                    out[d] = fh.read(length)
        return out

    def remove(self, doc_ids: Iterable[int]) -> None:
        with self._lock:
            for d in doc_ids:
                self._index.pop(d, None)

    def __contains__(self, doc_id: int) -> bool:
        with self._lock:
            return doc_id in self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def iter_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._index.keys())

    def iter_all(self, batch: int = 1000) -> Iterator[List[Tuple[int, bytes]]]:
        """Stream all docs in id order (used by reindex, write/mod.rs:544)."""
        ids = self.iter_ids()
        for i in range(0, len(ids), batch):
            chunk = ids[i : i + batch]
            blobs = self.get_documents_by_ids(chunk)
            yield [(d, blobs[d]) for d in chunk if d in blobs]

    # ------------------------------------------------------------------

    def commit(self) -> None:
        with self._lock:
            if self._page_fh:
                self._page_fh.flush()
                os.fsync(self._page_fh.fileno())
            atomic_write_packed(
                self._index_path(),
                {
                    "index": {str(k): list(v) for k, v in self._index.items()},
                    "page_no": self._page_no,
                    "page_docs": self._page_docs,
                },
            )

    def compact(self) -> None:
        """Rewrite pages dropping removed docs (space reclaim)."""
        with self._lock:
            items = sorted(self._index.items())
            if self._page_fh:
                self._page_fh.close()
                self._page_fh = None
            old_pages = [
                f for f in os.listdir(self.data_dir) if f.startswith("page-")
            ]
            new_index: Dict[int, Tuple[int, int, int]] = {}
            page_no, page_bytes, page_docs = 0, 0, 0
            fh = open(os.path.join(self.data_dir, "compact-000000.bin"), "wb")
            for doc_id, _ in items:
                blob = self.get(doc_id)
                if blob is None:
                    continue
                if page_docs >= DOCS_PER_PAGE or page_bytes >= MAX_PAGE_BYTES:
                    fh.close()
                    page_no += 1
                    page_bytes, page_docs = 0, 0
                    fh = open(
                        os.path.join(self.data_dir, f"compact-{page_no:06d}.bin"),
                        "wb",
                    )
                new_index[doc_id] = (page_no, page_bytes, len(blob))
                fh.write(blob)
                page_bytes += len(blob)
                page_docs += 1
            fh.close()
            for f in old_pages:
                os.unlink(os.path.join(self.data_dir, f))
            for f in sorted(os.listdir(self.data_dir)):
                if f.startswith("compact-"):
                    os.rename(
                        os.path.join(self.data_dir, f),
                        os.path.join(self.data_dir, f.replace("compact-", "page-")),
                    )
            self._index = new_index
            self._page_no = page_no
            self._page_bytes = page_bytes
            self._page_docs = page_docs
            self.commit()
