"""The port's exported histograms that the shipped dashboard reads are
fed: `answer_time_seconds` once per `/answer` stream, however it ends,
and `embedding_calculation_time_seconds` once per embedding batch (the
queue's own `batches` / `seconds` beside it). On the CPU, with stand-ins
for the answer machine, the analytics holder and the response."""

import asyncio
from types import SimpleNamespace
from unittest import mock

from oramacore_tpu_torch import metrics
from oramacore_tpu_torch.ai import service as port_service
from oramacore_tpu_torch.embeddings import EmbeddingsService
from oramacore_tpu_torch.write.embedding_queue import EmbeddingQueue


def _count(hist) -> int:
    entry = hist._data.get(())
    return entry[2] if entry else 0


class _Response:
    """The transport's StreamResponse surface that answer_sse uses; a
    write after `fail_after` writes raises as a dropped client does."""

    fail_after = None

    def __init__(self, headers):
        self.writes = []

    async def prepare(self, request):
        return None

    async def write(self, data):
        if self.fail_after is not None and len(self.writes) >= self.fail_after:
            raise ConnectionError("client went away")
        self.writes.append(data)


class _Machine:
    async def run_stream(self, interaction, planned):
        for tok in ("It ", "is."):
            yield {"type": "answer_token", "token": tok}


def _service():
    svc = object.__new__(port_service.AIService)
    svc._check_read = lambda coll, key: None
    svc._answer_machine = lambda coll, key: _Machine()
    svc.llm = None
    svc.read_side = SimpleNamespace(analytics=mock.MagicMock())
    return svc


def test_answer_time_observed_once_per_stream(monkeypatch):
    monkeypatch.setattr(port_service.web, "StreamResponse", _Response)
    svc = _service()
    interaction = SimpleNamespace(
        interaction_id="i", conversation_id="c", visitor_id="v",
        query="which lamp?", system_prompt_id=None)
    request = SimpleNamespace(headers={})
    before = _count(metrics.ANSWER_TIME)
    resp = asyncio.run(svc.answer_sse(request, "coll", "key", interaction,
                                      planned=False))
    assert resp.writes[-1] == b"data: [DONE]\n\n"
    assert _count(metrics.ANSWER_TIME) == before + 1
    monkeypatch.setattr(_Response, "fail_after", 1)
    resp = asyncio.run(svc.answer_sse(request, "coll", "key", interaction,
                                      planned=True))
    assert len(resp.writes) == 1
    assert _count(metrics.ANSWER_TIME) == before + 2
    assert metrics.ANSWER_TIME._data[()][1] > 0


def test_embedding_time_observed_once_per_batch():
    got = []
    q = EmbeddingQueue(EmbeddingsService(), lambda coll, body: got.append(body),
                       batch_limit=4, synchronous=True)
    before = _count(metrics.EMBEDDING_CALCULATION_TIME)
    q.submit_many([("c", "i", d, "builtin-minihash-384", f"text {d}")
                   for d in range(10)])
    assert len(got) == 10 and q.batches == 3 and q.seconds > 0
    assert _count(metrics.EMBEDDING_CALCULATION_TIME) == before + 3
