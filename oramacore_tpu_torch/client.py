"""Python client SDK for the oramacore_tpu HTTP API.

The reference ships a JS SDK (`@orama/core`) with an SSE parser
(client/js/sse-parser/); this is the equivalent client for this build:
collection/index management, document CRUD, search, and streaming
answer/NLP-query sessions via the bundled SSE parser. Synchronous
(urllib-based, zero extra deps) — suitable for scripts and tests.

The port's copy of `oramacore_tpu/client.py`, with the same names and
behaviour.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
from typing import Any, Dict, Iterator, List, Optional


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


def parse_sse_stream(fh) -> Iterator[Dict[str, Any]]:
    """Incremental SSE parser: yields JSON payloads of `data:` events
    (reference client/js/sse-parser)."""
    buffer = b""
    while True:
        chunk = fh.read(1024)
        if not chunk:
            break
        buffer += chunk
        while b"\n\n" in buffer:
            raw_event, buffer = buffer.split(b"\n\n", 1)
            for line in raw_event.split(b"\n"):
                line = line.strip()
                if not line.startswith(b"data:"):
                    continue
                payload = line[5:].strip()
                if payload == b"[DONE]":
                    return
                try:
                    yield json.loads(payload)
                except json.JSONDecodeError:
                    continue


class _Http:
    def __init__(self, base_url: str, api_key: Optional[str] = None,
                 timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.timeout = timeout

    def _request(self, method: str, path: str, body: Any = None,
                 api_key: Optional[str] = None, stream: bool = False):
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        key = api_key or self.api_key
        if key:
            headers["Authorization"] = f"Bearer {key}"
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise ApiError(e.code, msg) from e
        if stream:
            return resp
        payload = resp.read()
        if not payload:
            return None
        ctype = resp.headers.get("Content-Type", "")
        if "json" in ctype:
            return json.loads(payload)
        return payload.decode(errors="replace")

    def get(self, path, api_key=None):
        return self._request("GET", path, api_key=api_key)

    def post(self, path, body=None, api_key=None, stream=False):
        return self._request("POST", path, body, api_key, stream)


class CollectionClient:
    def __init__(self, http: _Http, collection_id: str,
                 read_api_key: Optional[str] = None,
                 write_api_key: Optional[str] = None):
        self._http = http
        self.id = collection_id
        self.read_api_key = read_api_key
        self.write_api_key = write_api_key

    # -- admin ------------------------------------------------------------

    def create_index(self, index_id: str, embeddings: Optional[Dict] = None):
        body = {"id": index_id}
        if embeddings:
            body["embeddings"] = embeddings
        return self._http.post(
            f"/v1/collections/{self.id}/indexes/create", body,
            api_key=self.write_api_key,
        )

    def insert_documents(self, index_id: str, docs: List[Dict[str, Any]]):
        return self._http.post(
            f"/v1/collections/{self.id}/indexes/{index_id}/insert", docs,
            api_key=self.write_api_key,
        )

    def upsert_documents(self, index_id: str, docs: List[Dict[str, Any]]):
        return self._http.post(
            f"/v1/collections/{self.id}/indexes/{index_id}/documents/upsert",
            docs, api_key=self.write_api_key,
        )

    def delete_documents(self, index_id: str, ids: List[str]):
        return self._http.post(
            f"/v1/collections/{self.id}/indexes/{index_id}/delete",
            {"document_ids": ids}, api_key=self.write_api_key,
        )

    def reindex(self, **kwargs):
        return self._http.post(
            f"/v1/collections/{self.id}/reindex", kwargs,
            api_key=self.write_api_key,
        )

    # -- search ------------------------------------------------------------

    def search(self, params: Dict[str, Any]):
        return self._http.post(
            f"/v1/collections/{self.id}/search", params,
            api_key=self.read_api_key,
        )

    def stats(self):
        return self._http.get(
            f"/v1/collections/{self.id}/stats", api_key=self.read_api_key
        )

    def filterable_fields(self):
        return self._http.get(
            f"/v1/collections/{self.id}/filterable_fields",
            api_key=self.read_api_key,
        )

    def batch_get(self, ids: List[str]):
        return self._http.post(
            f"/v1/collections/{self.id}/documents/batch-get", {"ids": ids},
            api_key=self.read_api_key,
        )

    def list_documents(self, index_ids: Optional[List[str]] = None):
        """Every document of the collection (write-key auth; reference
        POST /v1/collections/list)."""
        body: Dict[str, Any] = {"id": self.id}
        if index_ids is not None:
            body["index_ids"] = index_ids
        return self._http.post(
            "/v1/collections/list", body, api_key=self.write_api_key,
        )

    # -- AI -----------------------------------------------------------------

    def answer_stream(self, interaction: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        resp = self._http.post(
            f"/v1/collections/{self.id}/answer", interaction,
            api_key=self.read_api_key, stream=True,
        )
        return parse_sse_stream(resp)

    def answer(self, interaction: Dict[str, Any]) -> str:
        """Convenience: collect the streamed answer text."""
        return "".join(
            ev["token"]
            for ev in self.answer_stream(interaction)
            if ev.get("type") == "answer_token"
        )

    def nlp_query_stream(self, query: str) -> Iterator[Dict[str, Any]]:
        resp = self._http.post(
            f"/v1/collections/{self.id}/generate/nlp_query", {"query": query},
            api_key=self.read_api_key, stream=True,
        )
        return parse_sse_stream(resp)

    def suggestions(self, messages: List[Dict[str, str]], count: int = 3):
        return self._http.post(
            f"/v1/collections/{self.id}/suggestions",
            {"messages": messages, "count": count},
            api_key=self.read_api_key,
        )

    # -- merchandising / hooks / values ---------------------------------------

    def insert_pin_rule(self, rule: Dict[str, Any]):
        return self._http.post(
            f"/v1/collections/{self.id}/merchandising/pin_rules/insert", rule,
            api_key=self.write_api_key,
        )

    def insert_shelf(self, shelf: Dict[str, Any]):
        return self._http.post(
            f"/v1/collections/{self.id}/merchandising/shelves/insert", shelf,
            api_key=self.write_api_key,
        )

    def set_hook(self, name: str, code: str):
        return self._http.post(
            f"/v1/collections/{self.id}/hooks/set",
            {"name": name, "code": code}, api_key=self.write_api_key,
        )

    def set_value(self, key: str, value: str):
        return self._http.post(
            f"/v1/collections/{self.id}/values/set",
            {"key": key, "value": value}, api_key=self.write_api_key,
        )


class OramaCoreTPU:
    """Top-level client. `master_api_key` unlocks admin operations."""

    def __init__(self, base_url: str, master_api_key: Optional[str] = None,
                 timeout: float = 60.0):
        self._http = _Http(base_url, master_api_key, timeout)
        self.master_api_key = master_api_key

    def health(self) -> bool:
        try:
            self._http.get("/health")
            return True
        except (ApiError, OSError):
            return False

    def create_collection(self, collection_id: str, **kwargs) -> CollectionClient:
        out = self._http.post(
            "/v1/collections/create", {"id": collection_id, **kwargs}
        )
        return CollectionClient(
            self._http, collection_id,
            read_api_key=out["read_api_key"],
            write_api_key=out["write_api_key"],
        )

    def collection(self, collection_id: str, read_api_key: Optional[str] = None,
                   write_api_key: Optional[str] = None) -> CollectionClient:
        return CollectionClient(
            self._http, collection_id, read_api_key, write_api_key
        )

    def list_collections(self):
        return self._http.get("/v1/collections")

    def delete_collection(self, collection_id: str):
        return self._http.post(f"/v1/collections/{collection_id}/delete", {})

    def analytics(self):
        return self._http.get("/v1/analytics")
