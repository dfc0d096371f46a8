"""The write side's batched embedding queue (the port's copy of
`EmbeddingQueue`, oramacore_tpu/write/__init__.py; reference
write/embedding.rs:126).

Jobs `(collection, index, doc_id, model, text)` accumulate; a worker
thread takes them in batches of at most `batch_limit` (100, the write
side's `embedding_queue_limit`), groups each batch by model, computes the
vectors with one `calculate_embeddings(..., Intent.PASSAGE, model)` call a
model, and emits one `index_embedding` body a document to `sink`. With
`synchronous=True` the caller's thread does the work.

The JAX queue sends each body to the op log as an `Operation`; the op
log imports `msgpack`, which the port does without, so here
`sink(collection, body)` receives the same body. As in the JAX queue, a
batch whose embedding fails is logged and skipped; `failed_batches`
counts them. `flush_and_wait` returns once the queue is empty AND no
batch is in flight (the JAX version returns while its last batch may
still be computing).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..embeddings import EmbeddingsService, Intent

logger = logging.getLogger("oramacore_tpu_torch.write.embedding_queue")

Job = Tuple[str, str, int, str, str]  # (collection, index, doc, model, text)
Sink = Callable[[str, Dict], None]


class EmbeddingQueue:
    def __init__(
        self,
        embeddings: EmbeddingsService,
        sink: Sink,
        batch_limit: int = 100,
        synchronous: bool = False,
    ):
        self._embeddings = embeddings
        self._sink = sink
        self._batch_limit = batch_limit
        self._synchronous = synchronous
        self._queue: List[Job] = []
        self._in_flight = 0           # jobs taken by the worker, not done
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._wake = threading.Event()
        self._stop = False
        self.batches = 0
        self.failed_batches = 0
        self.seconds = 0.0            # time spent computing and emitting
        self._thread: Optional[threading.Thread] = None
        if not synchronous:
            self._thread = threading.Thread(
                target=self._loop, name="embedding-queue", daemon=True
            )
            self._thread.start()

    def submit(self, collection: str, index: str, doc_id: int, model: str,
               text: str):
        if self._synchronous:
            self._process([(collection, index, doc_id, model, text)])
            return
        with self._lock:
            self._queue.append((collection, index, doc_id, model, text))
        self._wake.set()

    def submit_many(self, jobs: Sequence[Job]):
        """Enqueue a whole insert batch at once; in synchronous mode the
        backend sees one calculate_embeddings call a `batch_limit` slice."""
        if not jobs:
            return
        if self._synchronous:
            for i in range(0, len(jobs), self._batch_limit):
                self._process(list(jobs[i: i + self._batch_limit]))
            return
        with self._lock:
            self._queue.extend(jobs)
        self._wake.set()

    def _loop(self):
        while not self._stop:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            while True:
                with self._lock:
                    batch = self._queue[: self._batch_limit]
                    del self._queue[: len(batch)]
                    self._in_flight += len(batch)
                if not batch:
                    break
                failed = False
                try:
                    self._process(batch)
                except Exception:  # noqa: BLE001 — log and skip the batch
                    logger.exception("embedding batch of %d jobs failed",
                                     len(batch))
                    failed = True
                finally:
                    with self._lock:
                        self._in_flight -= len(batch)
                        self.failed_batches += failed
                        self._idle.notify_all()

    def _process(self, batch: Sequence[Job]):
        t0 = time.perf_counter()
        by_model: Dict[str, List[Tuple[str, str, int, str]]] = {}
        for coll, index, doc, model, text in batch:
            by_model.setdefault(model, []).append((coll, index, doc, text))
        for model, items in by_model.items():
            texts = [t for (_, _, _, t) in items]
            vecs = self._embeddings.calculate_embeddings(
                texts, Intent.PASSAGE, model)
            for (coll, index, doc, _), chunks in zip(items, vecs):
                if not chunks:
                    continue
                self._sink(coll, {
                    "index": index,
                    "doc_id": doc,
                    "model": model,
                    "vectors": [c.astype("float32").tolist() for c in chunks],
                })
        self.batches += 1
        self.seconds += time.perf_counter() - t0

    def flush_and_wait(self, timeout: float = 30.0) -> bool:
        """Wait until every submitted job is done (emitted, or in a
        failed batch); False if `timeout` seconds pass first."""
        if self._synchronous:
            return True
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._queue or self._in_flight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._wake.set()
                self._idle.wait(min(left, 0.05))
        return True

    def stop(self):
        self._stop = True
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=5)
