"""The port's AI service over HTTP (`oramacore_tpu_torch.ai.service` on
the port's `ApiServer`), on the CPU.

- Every body of `tests/test_ai_http.py` runs against the port: its
  `ai_http_test` harness rebound to the port's engine (`build_orama` on
  the CPU), `AIService` and `ApiServer`, served by `PortTestServer` and
  reached through `PortTestClient` (`tests/test_torch_server.py`), with
  the suite's own aiohttp LLM mock.
- A differential test: one seeded script of AI requests (answers in
  every search mode, planned answers, NLP queries, OpenAI chat with and
  without streaming and tools, MCP, suggestions, titles, tools, system
  prompts, training sets, an auto-mode search) goes to the JAX server
  and to the port's, each with its own mock of the same script. SSE
  event types and order, streamed tokens, JSON bodies and the bodies the
  mock received (byte for byte: the same prompts) must agree;
  `search_results` by `rs_hits_errors`' rules.
- The port's LLM mock (`benches/llm_mock.py`) through the port's client.
- The port's `main()` with an LLM configured answers `/answer`.
- The hook-log SSE streams what a hook prints.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from oramacore_tpu import config as jax_config
from oramacore_tpu import runtime as jax_runtime
from oramacore_tpu import server as jax_server
from oramacore_tpu.ai import service as jax_service
from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch import server as port_server
from oramacore_tpu_torch.ai import llms
from oramacore_tpu_torch.ai import service as port_service
from oramacore_tpu_torch.benches import llm_mock

from . import test_ai_http as http_suite
from .ai_mock import MockLLMServer
from .test_torch_ai_layer import cpu_build_orama, port_globals, port_modules
from .test_torch_server import (
    PortTestClient,
    PortTestServer,
    _docs,
    _hits_errors,
    _json_errors,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BODIES = sorted(n for n, f in vars(http_suite).items()
                if n.startswith("test_") and callable(f)
                and getattr(f, "__module__", None) == http_suite.__name__)


def _jax_side_reached(*a, **kw):
    raise AssertionError("a port test body reached the JAX package")


def test_every_body_of_test_ai_http_is_run():
    assert len(BODIES) == 13, BODIES


@pytest.mark.parametrize("name", BODIES)
def test_ai_http_on_port(name, monkeypatch):
    g = port_globals(http_suite)  # before sys.modules points at the port
    mods = dict(port_modules(), **{"oramacore_tpu.server": port_server})
    for mod_name, mod in mods.items():
        monkeypatch.setitem(sys.modules, mod_name, mod)
    monkeypatch.setattr(jax_runtime, "build_orama", _jax_side_reached)
    assert g["AIService"] is port_service.AIService
    assert g["build_orama"] is cpu_build_orama
    # the rebound bodies and helpers share `g`: these reach them too
    g["ApiServer"] = port_server.ApiServer
    g["TestServer"] = PortTestServer
    g["TestClient"] = PortTestClient
    g[name]()


# ---------------------------------------------------------------------------
# the same AI requests to both servers
# ---------------------------------------------------------------------------

MASTER = "ai-diff-master"
RK, WK = "ai-diff-read", "ai-diff-write"
TOOL_CALL = ('TOOL_CALL [{"id": "call_1", "type": "function", "function": '
             '{"name": "lookup", "arguments": "{\\"sku\\": \\"K-7\\"}"}}]')
DIFF_SCRIPT = [
    ("You route a user message", '{"strategy": "simple"}'),
    ("independent search intents",
     '{"queries": ["racing games under 30", "puzzle games"]}'),
    ("choose which collection properties",
     '{"selections": [{"query": "racing games under 30", "properties": '
     '["title", "price", "genre"]}, {"query": "puzzle games", '
     '"properties": ["title"]}]}'),
    ("compose executable search parameters",
     '{"searches": [{"term": "racing"}, {"term": "puzzle quest"}]}'),
    ("classify a search query", '{"mode": "hybrid"}'),
    ("what is the weather", TOOL_CALL),
    ("use the lookup tool", TOOL_CALL),
    ("suggested queries", '["dragon quest", "space station"]'),
    ("title for a conversation", "Dragon games"),
    ("used as training data", '["dragon", "fast racer", "ghost manor"]'),
    ("generate related search queries", '["castle hero", "night storm"]'),
    ("grounded question-answering assistant",
     "The dragon quest costs 42 and the castle hero is on sale."),
]


def _ai_script(seed=16):
    """(label, method, path, body, key) of the differential run; a label
    starting with `wait` is sent until its answer counts every document."""
    rng = np.random.default_rng(seed)
    words = ("red blue green fast slow quest dungeon dragon racer kart "
             "space station tactics empire soccer league ghost manor night "
             "castle hero legend storm island").split()
    c = "/v1/collections/diff"
    out = [
        ("create", "POST", "/v1/collections/create",
         {"id": "diff", "read_api_key": RK, "write_api_key": WK}, MASTER),
        ("index", "POST", f"{c}/indexes/create", {"id": "main"}, WK),
        ("insert", "POST", f"{c}/indexes/main/insert",
         _docs(np.random.default_rng(17), 240), WK),
        ("wait all", "POST", f"{c}/search", {"term": "", "limit": 1}, RK),
        ("sp insert", "POST", f"{c}/system_prompts/insert",
         {"id": "sp1", "name": "terse", "prompt": "Answer in one line."}, WK),
        ("sp get", "POST", f"{c}/system_prompts/get", {"id": "sp1"}, RK),
        ("sp all", "POST", f"{c}/system_prompts/all", {}, RK),
        ("default prompt", "POST",
         f"{c}/generate/get_default_system_prompt", {}, RK),
        ("tool insert", "POST", f"{c}/tools/insert", {
            "id": "lookup", "description": "Look a product up by sku",
            "parameters": {"type": "object", "properties": {
                "sku": {"type": "string"}}},
            "code": "def lookup(args):\n    return {'sku': args['sku'], "
                    "'stock': 3}\n"}, WK),
        ("tools all", "POST", f"{c}/tools/all", {}, RK),
        ("tools run", "POST", f"{c}/tools/run", {"messages": [
            {"role": "user", "content": "use the lookup tool for K-7"}]}, RK),
    ]
    for i in range(6):
        q = " ".join(rng.choice(words, size=int(rng.integers(1, 3))))
        mode = ("fulltext", "hybrid", "vector")[i % 3]
        body = {"interactionID": f"a{i}", "query": f"{q} games?",
                "searchMode": mode, "min_similarity": 0.1,
                "max_documents": 4 + i}
        if i % 2:
            body["related"] = {"howMany": 2}
        out.append((f"answer {mode} {i}", "POST", f"{c}/answer", body, RK))
    out += [
        ("planned answer", "POST", f"{c}/planned_answer",
         {"interactionID": "p1",
          "query": "racing games under 30 and some puzzle games"}, RK),
        ("nlp query", "POST", f"{c}/generate/nlp_query",
         {"query": "racing games under 30 and some puzzle games"}, RK),
        ("chat", "POST", "/v1/diff/openai/chat/completions",
         {"model": "m", "messages": [
             {"role": "user", "content": "dragon quest price?"}]}, RK),
        ("chat stream", "POST", "/v1/diff/openai/chat/completions",
         {"model": "mock/m", "stream": True,
          "stream_options": {"include_usage": True},
          "messages": [{"role": "system", "content": "Be terse."},
                       {"role": "user", "content": "ghost manor?"}]}, RK),
        ("chat tools", "POST", "/v1/diff/openai/chat/completions",
         {"model": "m", "tools": [{"type": "function", "function": {
             "name": "lookup", "parameters": {"type": "object"}}}],
          "messages": [{"role": "user",
                        "content": "what is the weather in rome"}]}, RK),
        ("chat no user", "POST", "/v1/diff/openai/chat/completions",
         {"model": "m", "messages": [{"role": "system", "content": "x"}]},
         RK),
        ("mcp init", "POST", f"{c}/mcp",
         {"jsonrpc": "2.0", "id": 1, "method": "initialize"}, RK),
        ("mcp list", "POST", f"{c}/mcp",
         {"jsonrpc": "2.0", "id": 2, "method": "tools/list"}, RK),
        ("mcp search", "POST", f"{c}/mcp",
         {"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {
             "name": "search", "arguments": {
                 "term": "dragon castle", "where": {"price": {"lt": 60}}}}},
         RK),
        ("mcp nlp", "POST", f"{c}/mcp",
         {"jsonrpc": "2.0", "id": 4, "method": "tools/call", "params": {
             "name": "nlp_search", "arguments": {
                 "query": "racing games under 30"}}}, RK),
        ("suggestions", "POST", f"{c}/suggestions",
         {"messages": [{"role": "user", "content": "dragons"}]}, RK),
        ("title", "POST", f"{c}/title",
         {"messages": [{"role": "user", "content": "dragons"}]}, RK),
        ("ts generate", "POST",
         f"{c}/training_sets/queries_generator/generate", {"count": 3}, WK),
        ("ts get", "POST", f"{c}/training_sets/queries_generator/get", {},
         RK),
        ("auto search", "POST", f"{c}/search",
         {"term": "dragon quest", "mode": "auto", "similarity": 0.1}, RK),
        ("answer bad key", "POST", f"{c}/answer", {"query": "x"}, "bad"),
    ]
    return out


def _events(text):
    return [json.loads(line[len("data: "):]) for line in text.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def _stable(payload):
    """An OpenAI answer without its per-call id and clock."""
    if isinstance(payload, dict) and str(payload.get("id", "")).startswith(
            "chatcmpl-"):
        return {k: v for k, v in payload.items() if k not in ("id",
                                                              "created")}
    return payload


async def _drive_ai(client, script):
    out = {}
    for label, method, path, body, key in script:
        headers = {"Authorization": f"Bearer {key}"}
        for _ in range(500 if label.startswith("wait") else 1):
            resp = await client.request(method, path, json=body,
                                        headers=headers)
            text = await resp.text()
            if not label.startswith("wait"):
                break
            if resp.status == 200 and json.loads(text)["count"] == 240:
                break
            await asyncio.sleep(0.02)
        if resp.headers.get("Content-Type", "").startswith(
                "text/event-stream"):
            payload = ("sse", [_stable(e) for e in _events(text)],
                       text.rstrip().endswith("data: [DONE]"))
        else:
            try:
                payload = _stable(json.loads(text))
            except json.JSONDecodeError:
                payload = text
        out[label] = (resp.status, payload)
    return out


def _sse_errors(a, b, label):
    if [e.get("type", e.get("object")) for e in a] != \
            [e.get("type", e.get("object")) for e in b]:
        return [f"{label}: events {[e.get('type') for e in b]} vs "
                f"{[e.get('type') for e in a]}"]
    errs = []
    for i, (x, y) in enumerate(zip(a, b)):
        if x.get("type", "").endswith("search_results"):
            errs += _hits_errors(x["results"], y["results"],
                                 f"{label}[{i}] {x['type']}")
            if {k: v for k, v in x.items() if k != "results"} != \
                    {k: v for k, v in y.items() if k != "results"}:
                errs.append(f"{label}[{i}]: {y} vs {x}")
        elif x != y:
            errs.append(f"{label}[{i}]: {json.dumps(y)[:300]} vs "
                        f"{json.dumps(x)[:300]}")
    return errs


def _mcp_text(payload):
    """An MCP tools/call answer with its text content parsed."""
    try:
        content = payload["result"]["content"][0]
        return {**payload, "result": {**payload["result"], "content": [
            {**content, "text": json.loads(content["text"])}]}}
    except (KeyError, TypeError, IndexError):
        return payload


def test_jax_and_port_ai_servers_answer_a_script_alike():
    script = _ai_script()

    async def run():
        jmock, pmock = MockLLMServer(DIFF_SCRIPT, default=""), \
            MockLLMServer(DIFF_SCRIPT, default="")
        await jmock.start()
        await pmock.start()
        with tempfile.TemporaryDirectory() as jt, \
                tempfile.TemporaryDirectory() as pt:
            jcfg, pcfg = jax_config.OramacoreConfig(), \
                port_config.OramacoreConfig()
            for cfg, tmp, mock in ((jcfg, jt, jmock), (pcfg, pt, pmock)):
                cfg.data_dir = tmp
                cfg.auth.master_api_key = MASTER
                cfg.writer_side.insert_batch_commit_size = 10_000_000
                cfg.reader_side.insert_batch_commit_size = 10_000_000
                cfg.ai.remote_llms = [{"name": "mock", "url": mock.url,
                                       "model": "m"}]
            jorama = jax_runtime.build_orama(jcfg, sync_embeddings=True)
            jai = jax_service.AIService(jcfg, jorama.write_side,
                                        jorama.read_side)
            jsrv = jax_server.ApiServer(jcfg, jorama.write_side,
                                        jorama.read_side, jai)
            porama = cpu_build_orama(pcfg, sync_embeddings=True)
            pai = port_service.AIService(pcfg, porama.write_side,
                                         porama.read_side)
            psrv = port_server.ApiServer(pcfg, porama.write_side,
                                         porama.read_side, pai)
            jc = TestClient(TestServer(jsrv.app))
            pc = PortTestClient(PortTestServer(psrv.app))
            await jc.start_server()
            await pc.start_server()
            try:
                ja = await _drive_ai(jc, script)
                pa = await _drive_ai(pc, script)
            finally:
                await jc.close()
                await pc.close()
                await jai.llm.close()
                jorama.stop()
                porama.stop()
        await jmock.stop()
        await pmock.stop()
        return ja, pa, jmock.requests, pmock.requests

    ja, pa, jreq, preq = asyncio.run(run())
    bad = []
    for label, *_ in script:
        (js, jb), (ps, pb) = ja[label], pa[label]
        if js != ps:
            bad.append(f"{label}: status {ps} vs {js} ({pb!r:.300} vs "
                       f"{jb!r:.300})")
        elif isinstance(jb, tuple):
            if not isinstance(pb, tuple):
                bad.append(f"{label}: {pb!r:.200} is no SSE answer")
            else:
                bad += _sse_errors(jb[1], pb[1], label)
                if jb[2] != pb[2]:
                    bad.append(f"{label}: [DONE] {pb[2]} vs {jb[2]}")
        elif label.startswith("mcp"):
            bad += _json_errors(_mcp_text(jb), _mcp_text(pb), label)
        else:
            bad += _json_errors(jb, pb, label)
    assert not bad, bad[:20]
    # the mock saw the same requests, byte for byte
    assert len(preq) == len(jreq)
    for i, (a, b) in enumerate(zip(jreq, preq)):
        assert json.dumps(b) == json.dumps(a), (i, json.dumps(b)[:400],
                                                json.dumps(a)[:400])

    # the script reached what it names
    for i, mode in enumerate(("fulltext", "hybrid", "vector")):
        ev = ja[f"answer {mode} {i}"][1][1]
        res = next(e for e in ev if e["type"] == "search_results")
        assert res["results"], mode
        tokens = "".join(e["token"] for e in ev if e["type"] == "answer_token")
        assert tokens.strip() == DIFF_SCRIPT[-1][1]
    assert any(e["type"] == "related_queries" for e in ja["answer hybrid 1"][1][1])
    planned = ja["planned answer"][1][1]
    tracked = next(e for e in planned if e.get("state") ==
                   "tracked_queries_generated")
    first = tracked["data"]["searches"][0]
    assert first["where"]["price"] == {"lte": 30.0}
    assert first["where"]["genre"] == "racing"
    assert ja["tools run"][1]["results"][0]["result"] == {"sku": "K-7",
                                                         "stock": 3}
    assert ja["chat tools"][1]["choices"][0]["finish_reason"] == "tool_calls"
    assert ja["chat no user"][0] == 400 and ja["answer bad key"][0] == 401
    assert json.loads(ja["mcp search"][1]["result"]["content"][0]["text"]
                      )["count"] > 0
    assert ja["ts get"][1]["data"] == ["dragon", "fast racer", "ghost manor"]
    assert len(jreq) > 40
    # the auto-mode search asked the mock and ran as the hybrid it chose
    assert any("classify a search query" in json.dumps(r["messages"])
               for r in jreq)


# ---------------------------------------------------------------------------
# the port's LLM mock, through the port's client
# ---------------------------------------------------------------------------

def test_llm_mock_through_the_port_client():
    async def run():
        mock = llm_mock.MockLLMServer(
            [("weather", 'TOOL_CALL [{"id": "c", "type": "function", '
                         '"function": {"name": "w", "arguments": "{}"}}]'),
             ("stream me", "one two three")],
            default="plain answer")
        await mock.start()
        try:
            svc = llms.LLMService(llms.LLMProviderConfig("mock", mock.url,
                                                         "m"),
                                  backoff_base_s=0.01)
            assert (await svc.chat([{"role": "user", "content": "hi"}])
                    )["content"] == "plain answer"
            toks = [t async for t in svc.chat_stream(
                [{"role": "user", "content": "stream me"}])]
            assert toks == ["one ", "two ", "three "]
            calls = await svc.execute_tools(
                [{"role": "user", "content": "weather?"}],
                [{"type": "function", "function": {"name": "w"}}])
            assert calls[0]["function"]["name"] == "w"
            # without tools a TOOL_CALL script is plain content
            msg = await svc.chat([{"role": "user", "content": "weather?"}])
            assert msg["content"].startswith("TOOL_CALL ")
            mock.fail_first = len(mock.requests) + 2
            assert (await svc.chat([{"role": "user", "content": "x"}])
                    )["content"] == "plain answer"
            assert len(mock.requests) == 7
            assert mock.requests[1]["stream"] is True
            assert mock.requests[2]["tools"][0]["function"]["name"] == "w"
        finally:
            await mock.stop()

    asyncio.run(run())


# ---------------------------------------------------------------------------
# the port's main() with an LLM
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _MockThread:
    """The port's LLM mock on an event loop of its own thread."""

    def __init__(self, script):
        self.mock = llm_mock.MockLLMServer(script)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.mock.start(),
                                         self.loop).result(10)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.mock.stop(),
                                         self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _http(port, path, body, key, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Authorization": f"Bearer {key}",
                 "Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers, resp.read().decode()


def test_port_main_with_an_llm_answers(tmp_path):
    mock = _MockThread([
        ("You route a user message", '{"strategy": "simple"}'),
        ("rewrite a conversational message", "amber lamp"),
        ("grounded question-answering assistant", "It is the amber one."),
    ])
    port = _free_port()
    cfg = {"data_dir": str(tmp_path / "data"),
           "http": {"host": "127.0.0.1", "port": port},
           "auth": {"master_api_key": "main-master"},
           "ai": {"remote_llms": [{"name": "mock", "url": mock.mock.url,
                                   "model": "m"}]}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "oramacore_tpu_torch.server", "--config",
         str(tmp_path / "config.json"), "--device", "cpu"], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.time()
        while True:
            try:
                status, _, _ = _http(port, "/v1/collections/create", {
                    "id": "m", "read_api_key": "mr", "write_api_key": "mw"},
                    "main-master", timeout=5)
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()
                assert time.time() - t0 < 120, "the server did not start"
                time.sleep(0.2)
        assert status == 201
        _http(port, "/v1/collections/m/indexes/create", {"id": "main"}, "mw")
        _http(port, "/v1/collections/m/indexes/main/insert",
              [{"id": "1", "title": "amber lamp"}], "mw")
        for _ in range(300):
            _, _, text = _http(port, "/v1/collections/m/search",
                               {"term": "amber"}, "mr")
            if json.loads(text)["count"] == 1:
                break
            time.sleep(0.05)
        status, headers, text = _http(
            port, "/v1/collections/m/answer",
            {"interactionID": "i", "query": "which lamp?",
             "searchMode": "fulltext"}, "mr")
        assert status == 200
        assert headers["content-type"] == "text/event-stream"
        events = _events(text)
        res = next(e for e in events if e["type"] == "search_results")
        assert res["results"][0]["document"]["title"] == "amber lamp"
        assert "".join(e["token"] for e in events
                       if e["type"] == "answer_token").strip() == \
            "It is the amber one."
        assert "amber lamp" in json.dumps(mock.mock.requests[-1])
    finally:
        proc.terminate()
        out, err = proc.communicate(timeout=60)
        mock.close()
    assert proc.returncode == 0, err
    assert "no AI service" not in err, err


# ---------------------------------------------------------------------------
# the hook-log SSE
# ---------------------------------------------------------------------------

def test_hook_logs_reach_a_waiting_subscriber_from_another_thread():
    """A hook run on a thread (as search hooks run on the executor) wakes
    the subscriber's event loop at once: the entry is handed over through
    the loop, not put on its queue from the thread."""
    from oramacore_tpu_torch.ai.hooks import HooksRuntime

    rt = HooksRuntime()

    async def run():
        q = rt.subscribe_logs("c")
        t = threading.Thread(target=rt.exec_hook, args=(
            "c", "hook", "def hook(x):\n    print('from a thread')\n"
            "    return x\n", {}))
        t0 = time.perf_counter()
        t.start()
        try:
            entry = await asyncio.wait_for(q.get(), 10)
        finally:
            t.join(30)
        rt.unsubscribe_logs("c", q)
        return entry, time.perf_counter() - t0, t.is_alive()

    entry, took, alive = asyncio.run(run())
    assert entry == {"level": "stdout", "hook": "hook",
                     "message": "from a thread"}
    assert took < 8 and not alive


def test_hook_log_sse_streams_what_a_hook_prints(tmp_path):
    """A BeforeSearch hook that prints: its line arrives on the
    collection's `/logs` stream, served from the runtime that runs the
    hooks (the AI service's, attached to both sides)."""
    from .test_torch_client import LiveServer

    srv = LiveServer(tmp_path)
    try:
        ai = port_service.AIService(srv.orama.config, srv.orama.write_side,
                                    srv.orama.read_side)
        assert srv.orama.read_side.hooks_runtime is ai.hooks_runtime
        assert srv.orama.write_side.hooks_runtime is ai.hooks_runtime
        srv.server.ai = ai
        port = srv.server.port
        from .test_torch_client import MASTER as master

        _http(port, "/v1/collections/create", {
            "id": "h", "read_api_key": "hr", "write_api_key": "hw"}, master)
        _http(port, "/v1/collections/h/hooks/set", {
            "name": "BeforeSearch",
            "code": "def BeforeSearch(inp):\n"
                    "    print('rewriting', inp['term'])\n"
                    "    return inp\n"}, "hw")
        for _ in range(300):  # the read side applies the create and hook
            coll = srv.orama.read_side.collections.get("h")
            if coll is not None and coll.hooks.get("BeforeSearch"):
                break
            time.sleep(0.02)
        conn = socket.create_connection(("127.0.0.1", port), timeout=30)
        conn.sendall(b"GET /v1/collections/h/logs?api-key=hr HTTP/1.1\r\n"
                     b"Host: x\r\n\r\n")
        buf = b""
        while b"text/event-stream" not in buf or b"\r\n\r\n" not in buf:
            buf += conn.recv(4096)
        _http(port, "/v1/collections/h/search", {"term": "zebra"}, "hr")
        t0 = time.time()
        while b"rewriting zebra" not in buf:
            assert time.time() - t0 < 30, buf
            buf += conn.recv(4096)
        conn.close()
        line = next(ln for ln in buf.decode().splitlines()
                    if "rewriting zebra" in ln)
        entry = json.loads(line[line.index("{"):])
        assert entry == {"level": "stdout", "hook": "BeforeSearch",
                         "message": "rewriting zebra"}
    finally:
        srv.close()


def test_server_stop_ends_an_open_hook_log_stream(tmp_path):
    """`ApiServer.stop()` with a `/logs` stream still open (its handler
    waiting on the hook-log queue): the handler is cancelled and awaited,
    the client sees the connection close, and no task is left pending on
    the server's loop."""
    from .test_torch_client import LiveServer

    srv = LiveServer(tmp_path, ai=True)
    try:
        from .test_torch_client import MASTER as master

        port = srv.server.port
        _http(port, "/v1/collections/create", {
            "id": "h", "read_api_key": "hr", "write_api_key": "hw"}, master)
        for _ in range(300):
            if "h" in srv.orama.read_side.collections:
                break
            time.sleep(0.02)
        conn = socket.create_connection(("127.0.0.1", port), timeout=30)
        conn.sendall(b"GET /v1/collections/h/logs?api-key=hr HTTP/1.1\r\n"
                     b"Host: x\r\n\r\n")
        buf = b""
        while b"text/event-stream" not in buf or b"\r\n\r\n" not in buf:
            buf += conn.recv(4096)

        async def pending():
            return [t for t in asyncio.all_tasks()
                    if t is not asyncio.current_task()]

        assert asyncio.run_coroutine_threadsafe(
            pending(), srv.loop).result(10)  # the stream's handler
        asyncio.run_coroutine_threadsafe(srv.server.stop(),
                                         srv.loop).result(10)
        assert asyncio.run_coroutine_threadsafe(
            pending(), srv.loop).result(10) == []
        while True:  # the rest of the stream, then the close
            chunk = conn.recv(4096)
            if not chunk:
                break
        conn.close()
        assert srv.orama.read_side.hooks_runtime._log_subs.get(
            "h", []) == []
    finally:
        srv.close()
