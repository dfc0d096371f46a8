"""The port's API server (`oramacore_tpu_torch.server`) on the CPU.

- Every body of `tests/test_http_api.py` runs against the port's server
  on a real socket, through `PortTestClient`: the shape of aiohttp's
  `TestClient` (`post` / `get` / `put` giving `.status`, `.json()`,
  `.text()`) over an `aiohttp.ClientSession`. The bodies' own module is
  imported under another name, so pytest collects its tests only where
  they live. `test_auth_rejection` runs as a copy that first waits until
  the read side serves the new collection with its read key (see
  `auth_rejection_after_the_create`).
- A differential test: one seeded request script goes to the JAX server
  (aiohttp's test server) and to the port's; statuses and JSON bodies
  must agree, hits by `rs_hits_errors`' rules.
- The transport's edges: keep-alive, percent-encoded captures, the body
  limit, an SSE route.
"""

from __future__ import annotations

import asyncio
import http.client
import inspect
import json
import sys
import tempfile
import types

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from oramacore_tpu import config as jax_config
from oramacore_tpu import runtime as jax_runtime
from oramacore_tpu import server as jax_server
from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch import runtime as port_runtime
from oramacore_tpu_torch import server as port_server
from oramacore_tpu_torch.server import transport

from . import test_http_api as http_suite

MASTER = http_suite.MASTER


def _cpu_build_orama(config, **kwargs):
    kwargs.setdefault("device", "cpu")
    return port_runtime.build_orama(config, **kwargs)


class PortTestServer:
    """aiohttp's TestServer for the port: serves an Application of
    `server/transport.py` on 127.0.0.1, in the caller's event loop."""

    def __init__(self, app):
        self.app = app
        self.site = None

    async def start_server(self):
        self.site = await transport.serve(self.app, "127.0.0.1", 0)

    async def close(self):
        if self.site is not None:
            await self.site.close()


class PortTestClient:
    """aiohttp's TestClient over the port's server: paths are relative
    to its socket, answers are aiohttp ClientResponses read whole."""

    def __init__(self, server: PortTestServer):
        self.server = server
        self.session = None

    async def start_server(self):
        await self.server.start_server()
        self.session = aiohttp.ClientSession()

    def _url(self, path):
        return f"http://127.0.0.1:{self.server.site.port}{path}"

    async def request(self, method, path, **kwargs):
        resp = await self.session.request(method, self._url(path), **kwargs)
        await resp.read()
        return resp

    async def get(self, path, **kwargs):
        return await self.request("GET", path, **kwargs)

    async def post(self, path, **kwargs):
        return await self.request("POST", path, **kwargs)

    async def put(self, path, **kwargs):
        return await self.request("PUT", path, **kwargs)

    async def close(self):
        if self.session is not None:
            await self.session.close()
        await self.server.close()


def _port_config(tmp):
    cfg = port_config.OramacoreConfig()
    cfg.data_dir = tmp
    cfg.auth.master_api_key = MASTER
    cfg.writer_side.insert_batch_commit_size = 10_000_000
    cfg.reader_side.insert_batch_commit_size = 10_000_000
    return cfg


def _waiting_for_the_op_log(orama):
    """`test_http_api.wait_search`, then a wait until the read side has
    applied every op the write side sent. The suite's wait covers the
    document ops only: an insert's `index_embedding` ops follow them on
    the log, and a vector search sent right after the first full-text
    hit may reach the read side before them (the JAX package applies the
    log in the same order)."""

    async def wait_search(client, cid, key, payload, min_count=1,
                          attempts=300):
        await http_suite.wait_search(client, cid, key, payload, min_count,
                                     attempts)
        for _ in range(attempts):
            if orama.read_side.live_offset >= orama.write_side.op_sender.offset:
                break
            await asyncio.sleep(0.02)
        return await http_suite.wait_search(client, cid, key, payload,
                                            min_count, attempts)

    return wait_search


def run_on_port(body):
    """`tests/test_http_api.py`'s `http_test` with the port's engine and
    server in place of the JAX ones; the body's `wait_search` also waits
    for the op log (`_waiting_for_the_op_log`)."""

    async def run():
        with tempfile.TemporaryDirectory() as tmp:
            cfg = _port_config(tmp)
            orama = _cpu_build_orama(cfg, sync_embeddings=True,
                                     start_consumer=True)
            server = port_server.ApiServer(cfg, orama.write_side,
                                           orama.read_side)
            g = dict(body.__globals__)
            g["wait_search"] = _waiting_for_the_op_log(orama)
            rebound = types.FunctionType(body.__code__, g, body.__name__,
                                         body.__defaults__, body.__closure__)
            tc = PortTestClient(PortTestServer(server.app))
            await tc.start_server()
            try:
                await rebound(tc)
            finally:
                await tc.close()
                orama.stop()

    asyncio.run(run())


def _body_of(wrapper):
    """The async body that `http_test` wraps."""
    cell = wrapper.__code__.co_freevars.index("fn")
    return wrapper.__closure__[cell].cell_contents


def _suite_cases():
    out = []
    for name, f in sorted(vars(http_suite).items()):
        if name.startswith("test_") and inspect.isfunction(f) \
                and f.__module__ == http_suite.__name__:
            out.append(name)
    return out


CASES = _suite_cases()


async def auth_rejection_after_the_create(client):
    """`test_http_api.test_auth_rejection` with one wait added: the read
    side answers 404 for a collection whose create it has not applied
    yet, before it looks at the key (`ReadSide.check_read_key`, the JAX
    package's order, kept by the port), so the bad key goes out once the
    read key is served."""
    auth = http_suite.auth
    keys = await http_suite.create_coll(client, "c2")
    for _ in range(300):
        resp = await client.post(
            "/v1/collections/c2/search", json={"term": "x"},
            headers=auth(keys["read_api_key"]),
        )
        if resp.status == 200:
            break
        await asyncio.sleep(0.02)
    assert resp.status == 200
    resp = await client.post(
        "/v1/collections/create", json={"id": "nope"}, headers=auth("bad")
    )
    assert resp.status == 401
    resp = await client.post(
        "/v1/collections/c2/indexes/main/insert",
        json=[{"id": "1"}],
        headers=auth("bad"),
    )
    assert resp.status == 401
    resp = await client.post(
        "/v1/collections/c2/search", json={"term": "x"}, headers=auth("bad")
    )
    assert resp.status == 401
    resp = await client.post(
        f"/v1/collections/c2/search?api-key={keys['read_api_key']}",
        json={"term": "x"},
    )
    assert resp.status == 200


def test_every_body_of_test_http_api_is_run():
    assert len(CASES) == 15, CASES
    assert "test_auth_rejection" in CASES


@pytest.mark.parametrize("name", CASES)
def test_http_api_on_port(name, monkeypatch):
    fn = getattr(http_suite, name)
    if name == "test_auth_rejection":
        run_on_port(auth_rejection_after_the_create)
        return
    if "fn" in fn.__code__.co_freevars:  # an @http_test body
        run_on_port(_body_of(fn))
        return
    # a plain test that builds its own engine and server: its imports
    # and aiohttp's test classes point at the port for the case
    rt = types.ModuleType("oramacore_tpu_torch_cpu_runtime")
    rt.build_orama = _cpu_build_orama
    for mod_name, mod in (("oramacore_tpu.config", port_config),
                          ("oramacore_tpu.runtime", rt),
                          ("oramacore_tpu.server", port_server)):
        monkeypatch.setitem(sys.modules, mod_name, mod)
    g = dict(fn.__globals__)
    g["TestServer"] = PortTestServer
    g["TestClient"] = PortTestClient
    body = types.FunctionType(fn.__code__, g, fn.__name__)
    monkeypatch.setattr(jax_runtime, "build_orama", _jax_side_reached)
    body()


def _jax_side_reached(*a, **kw):
    raise AssertionError("a port test body reached the JAX package")


# ---------------------------------------------------------------------------
# the same requests to both servers
# ---------------------------------------------------------------------------

RK, WK = "diff-read-key", "diff-write-key"
GENRES = ["action", "puzzle", "racing", "strategy", "sports", "horror"]
WORDS = ("red blue green fast slow quest dungeon dragon racer kart space "
         "station tactics empire soccer league ghost manor night castle "
         "hero legend storm island").split()


def _docs(rng, n):
    docs = []
    for i in range(n):
        words = rng.choice(WORDS, size=int(rng.integers(2, 6)))
        docs.append({
            "id": str(i),
            "title": " ".join(words),
            "description": " ".join(rng.choice(WORDS, size=8)),
            "genre": GENRES[int(rng.integers(len(GENRES)))],
            "price": int(rng.integers(5, 80)),
            "tags": [str(t) for t in rng.choice(WORDS, size=2, replace=False)],
            "available": bool(rng.integers(2)),
        })
    return docs


def _script(seed=17):
    """(label, method, path, body, key) of the differential run; `body`
    is a JSON value or raw bytes; a label starting with `wait` is sent
    until its answer counts every document."""
    rng = np.random.default_rng(seed)
    docs = _docs(rng, 240)
    c = "/v1/collections/diff"
    out = [
        ("create", "POST", "/v1/collections/create",
         {"id": "diff", "read_api_key": RK, "write_api_key": WK}, MASTER),
        ("index", "POST", f"{c}/indexes/create", {"id": "main"}, WK),
        ("insert 1", "POST", f"{c}/indexes/main/insert", docs[:120], WK),
        ("insert 2", "POST", f"{c}/indexes/main/insert",
         {"documents": docs[120:]}, WK),
        ("wait all", "POST", f"{c}/search", {"term": "", "limit": 1}, RK),
        ("pin", "POST", f"{c}/merchandising/pin_rules/insert", {
            "id": "promo",
            "conditions": [{"pattern": "promo", "anchoring": "contains"}],
            "consequence": {"promote": [{"doc_id": "7", "position": 0}]}},
         WK),
        ("value", "POST", f"{c}/values/set", {"key": "k", "value": "v"}, WK),
        ("hook set", "POST", f"{c}/hooks/set",
         {"name": "BeforeAnswer", "code": "def hook(x):\n    return x\n"}, WK),
        ("wait all 2", "POST", f"{c}/search", {"term": "", "limit": 1}, RK),
    ]
    ranges = [{"from": 0, "to": 30}, {"from": 30, "to": 60},
              {"from": 60, "to": 90}]
    kinds = [
        lambda q: {"term": q},
        lambda q: {"term": q, "limit": 5, "offset": 3},
        lambda q: {"term": q, "where": {"price": {"between": [20, 50]}}},
        lambda q: {"term": q, "where": {"genre": "racing"}},
        lambda q: {"term": q, "where": {"available": True,
                                        "price": {"lt": 40}}},
        lambda q: {"term": q, "facets": {"genre": {},
                                         "price": {"ranges": ranges}}},
        lambda q: {"term": q, "sortBy": {"property": "price",
                                         "order": "asc"}},
        lambda q: {"term": q, "sortBy": {"property": "price",
                                         "order": "desc"}, "limit": 20},
        lambda q: {"term": q, "groupBy": {"properties": ["genre"],
                                          "maxResults": 2}},
        lambda q: {"term": q, "tolerance": 1},
        lambda q: {"term": q, "exact": True},
        lambda q: {"term": "promo " + q},
        lambda q: {"term": q, "mode": "vector", "similarity": 0.1},
        lambda q: {"term": q, "mode": "hybrid", "similarity": 0.1},
        lambda q: {"term": q, "properties": ["title"]},
        lambda q: {"term": q, "boost": {"title": 2.0}},
    ]
    for i in range(40):
        q = " ".join(rng.choice(WORDS, size=int(rng.integers(1, 3))))
        out.append((f"search {i}", "POST", f"{c}/search",
                    kinds[i % len(kinds)](q), RK))
    out += [
        ("batch", "POST", f"{c}/search/batch", {"searches": [
            {"term": w} for w in WORDS[:8]] + [
            {"term": "dragon", "where": {"genre": "action"}}]}, RK),
        ("stats", "GET", f"{c}/stats", None, RK),
        ("filterable", "GET", f"{c}/filterable_fields", None, RK),
        ("batch-get", "POST", f"{c}/documents/batch-get",
         {"ids": ["1", "5", "999"]}, RK),
        ("pin ids", "GET", f"{c}/merchandising/pin_rules/ids", None, WK),
        ("value get", "GET", f"{c}/values/get/k", None, WK),
        ("value list", "GET", f"{c}/values/list", None, WK),
        ("value missing", "GET", f"{c}/values/get/nope", None, WK),
        ("hook list", "GET", f"{c}/hooks/list", None, WK),
        ("hook delete", "POST", f"{c}/hooks/delete",
         {"name": "BeforeAnswer"}, WK),
        ("hook list 2", "POST", f"{c}/hooks/list", {}, WK),
        ("action", "POST", f"{c}/actions/execute",
         {"name": "Search", "context": json.dumps({"term": "dragon"})}, RK),
        ("bad read key", "POST", f"{c}/search", {"term": "x"}, "bad"),
        ("bad write key", "POST", f"{c}/indexes/main/insert", [{"id": "z"}],
         "bad"),
        ("bad master key", "POST", "/v1/collections/create", {"id": "q"},
         "bad"),
        ("long key", "POST", f"{c}/search", {"term": "x"}, "x" * 65),
        ("no key", "POST", f"{c}/search", {"term": "x"}, None),
        ("malformed", "POST", f"{c}/search", b"{not json", RK),
        ("empty body", "POST", f"{c}/search", b"", RK),
        ("unknown collection", "POST", "/v1/collections/nope/search",
         {"term": "x"}, RK),
        ("unknown route", "GET", "/v1/nowhere", None, RK),
        ("wrong method", "GET", f"{c}/search", None, RK),
        ("ai route", "POST", f"{c}/answer", {"query": "x"}, RK),
        ("delete docs", "POST", f"{c}/indexes/main/delete",
         {"document_ids": ["1", "2"]}, WK),
        ("health", "GET", "/health", None, None),
        ("list", "GET", "/v1/collections", None, MASTER),
    ]
    return out


def _hits_errors(a, b, label, rtol=1e-4, tie_rtol=1e-5):
    """`chip_smoke.rs_hits_errors` on JSON hits: scores within rtol, ids
    equal outside runs of near-tied scores, equal documents."""
    if len(a) != len(b):
        return [f"{label}: {len(b)} hits vs {len(a)}"]
    errs = []
    sa = np.array([h["score"] for h in a], np.float64)
    sb = np.array([h["score"] for h in b], np.float64)
    if not np.allclose(sb, sa, rtol=rtol, atol=1e-7):
        errs.append(f"{label}: scores {sb[:5]} vs {sa[:5]}")
    i, n = 0, len(a)
    while i < n:
        j = i + 1
        while j < n and abs(sa[j] - sa[i]) <= tie_rtol * max(abs(sa[i]), 1e-30):
            j += 1
        ia, ib = [h["id"] for h in a[i:j]], [h["id"] for h in b[i:j]]
        if j < n and sorted(ia) != sorted(ib):
            errs.append(f"{label}: ranks {i}-{j - 1} {ib} vs {ia}")
        i = j
    docs = {h["id"]: (h["document"], h.get("index_id")) for h in a}
    errs += [f"{label}: document of {h['id']}" for h in b
             if h["id"] in docs
             and docs[h["id"]] != (h["document"], h.get("index_id"))]
    return errs


def _json_errors(a, b, label):
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{label}: keys {sorted(b)} vs {sorted(a)}"]
        errs = []
        for k in a:
            if k == "hits":
                errs += _hits_errors(a[k], b[k], f"{label}.hits")
            elif k == "groups":
                la = [g["values"] for g in a[k]]
                lb = [g["values"] for g in b[k]]
                if la != lb:
                    errs.append(f"{label}.groups: {lb} vs {la}")
                else:
                    for ga, gb in zip(a[k], b[k]):
                        errs += _hits_errors(ga["result"], gb["result"],
                                             f"{label}.groups{ga['values']}")
            else:
                errs += _json_errors(a[k], b[k], f"{label}.{k}")
        return errs
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{label}: {len(b)} items vs {len(a)}"]
        return [e for i, (x, y) in enumerate(zip(a, b))
                for e in _json_errors(x, y, f"{label}[{i}]")]
    if a != b:
        return [f"{label}: {b!r} vs {a!r}"]
    return []


async def _drive(client, script):
    out = {}
    for label, method, path, body, key in script:
        headers = {} if key is None else {"Authorization": f"Bearer {key}"}
        kwargs = {"headers": headers}
        if isinstance(body, bytes):
            kwargs["data"] = body
        elif body is not None:
            kwargs["json"] = body
        for _ in range(500 if label.startswith("wait") else 1):
            resp = await client.request(method, path, **kwargs)
            text = await resp.text()
            if not label.startswith("wait"):
                break
            if resp.status == 200 and json.loads(text)["count"] == 240:
                break
            await asyncio.sleep(0.02)
        try:
            payload = json.loads(text)
        except json.JSONDecodeError:
            payload = text
        out[label] = (resp.status, payload)
    return out


def test_jax_and_port_servers_answer_a_script_alike():
    script = _script()

    async def run():
        with tempfile.TemporaryDirectory() as jt, \
                tempfile.TemporaryDirectory() as pt:
            jcfg = jax_config.OramacoreConfig()
            jcfg.data_dir = jt
            jcfg.auth.master_api_key = MASTER
            jcfg.writer_side.insert_batch_commit_size = 10_000_000
            jcfg.reader_side.insert_batch_commit_size = 10_000_000
            jorama = jax_runtime.build_orama(jcfg, sync_embeddings=True)
            jsrv = jax_server.ApiServer(jcfg, jorama.write_side,
                                        jorama.read_side)
            pcfg = _port_config(pt)
            porama = _cpu_build_orama(pcfg, sync_embeddings=True)
            psrv = port_server.ApiServer(pcfg, porama.write_side,
                                         porama.read_side)
            jc = TestClient(TestServer(jsrv.app))
            pc = PortTestClient(PortTestServer(psrv.app))
            await jc.start_server()
            await pc.start_server()
            try:
                ja = await _drive(jc, script)
                pa = await _drive(pc, script)
            finally:
                await jc.close()
                await pc.close()
                jorama.stop()
                porama.stop()
        return ja, pa

    ja, pa = asyncio.run(run())
    bad = []
    n_hits = 0
    for label, *_ in script:
        (js, jb), (ps, pb) = ja[label], pa[label]
        if js != ps:
            bad.append(f"{label}: status {ps} vs {js} ({pb!r:.200} vs "
                       f"{jb!r:.200})")
            continue
        if label in ("list",):
            jb = [{k: v for k, v in x.items() if k != "created_at"}
                  for x in jb]
            pb = [{k: v for k, v in x.items() if k != "created_at"}
                  for x in pb]
        bad += _json_errors(jb, pb, label)
        if isinstance(jb, dict):
            n_hits += len(jb.get("hits", []))
    assert not bad, bad[:20]
    # the script reached what it names
    assert ja["stats"][1]["document_count"] == 240
    assert n_hits > 200
    assert ja["search 11"][1]["hits"][0]["id"] == "main:7"  # pinned
    assert "facets" in ja["search 5"][1] and "groups" in ja["search 8"][1]
    assert {ja[k][0] for k in ("bad read key", "bad write key",
                               "bad master key", "long key")} == {401}
    assert (ja["malformed"][0], ja["unknown route"][0],
            ja["wrong method"][0], ja["ai route"][0]) == (400, 404, 405, 503)


# ---------------------------------------------------------------------------
# the transport's edges
# ---------------------------------------------------------------------------

@pytest.fixture()
def live_port(tmp_path):
    from .test_torch_client import LiveServer

    srv = LiveServer(tmp_path, master=MASTER)
    yield srv.server.port, srv.orama
    srv.close()


def _call(conn, method, path, body=None, key=MASTER, headers=None):
    h = {"Authorization": f"Bearer {key}", **(headers or {})}
    data = body if isinstance(body, bytes) or body is None \
        else json.dumps(body).encode()
    if data is not None:
        h["Content-Type"] = "application/json"
    conn.request(method, path, body=data, headers=h)
    resp = conn.getresponse()
    return resp.status, resp.read(), resp


def test_keep_alive_serves_200_requests_on_one_connection(live_port):
    port, _ = live_port
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    status, body, _ = _call(conn, "POST", "/v1/collections/create",
                            {"id": "ka", "read_api_key": "r",
                             "write_api_key": "w"})
    assert status == 201
    sock = conn.sock
    for i in range(199):
        if i % 2:
            status, body, resp = _call(conn, "GET", "/health")
            assert body == b"OK"
        else:
            status, body, resp = _call(conn, "GET", "/v1/collections/ka",
                                       key=MASTER)
            assert json.loads(body)["id"] == "ka"
        assert status == 200
        assert resp.getheader("connection") == "keep-alive"
        assert conn.sock is sock  # never reopened
    conn.close()


def test_percent_encoded_capture(live_port):
    port, orama = live_port
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    status, _, _ = _call(conn, "POST", "/v1/collections/create",
                         {"id": "a.b~c", "read_api_key": "r",
                          "write_api_key": "w"})
    assert status == 201
    coll = "/v1/collections/%61.b%7Ec"
    status, body, _ = _call(conn, "GET", coll)
    assert status == 200 and json.loads(body)["id"] == "a.b~c"
    key = "two words/é"
    status, _, _ = _call(conn, "POST", coll + "/values/set",
                         {"key": key, "value": "v"}, key="w")
    assert status == 200
    # a `/` encoded inside a capture stays in it
    status, body, _ = _call(conn, "GET", coll + "/values/get/"
                            "two%20words%2F%C3%A9", key="w")
    assert status == 200 and json.loads(body) == {"key": key, "value": "v"}
    status, _, _ = _call(conn, "GET", coll + "/values/get/two%20words/x",
                         key="w")
    assert status == 404


def test_body_over_the_limit_gives_413(live_port, monkeypatch):
    port, _ = live_port
    monkeypatch.setattr(transport, "MAX_BODY_BYTES", 1024)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    status, body, resp = _call(conn, "POST", "/v1/collections/create",
                               {"id": "x" * 2000})
    assert status == 413 and b"1024" in body
    assert resp.getheader("connection") == "close"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    status, _, _ = _call(conn, "POST", "/v1/collections/create",
                         {"id": "small"})
    assert status == 201


def test_chunked_and_expect_continue_bodies(live_port):
    """A chunked request body is read whole; `Expect: 100-continue` gets
    its interim answer before the body is read."""
    port, orama = live_port
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    parts = [b'{"id": "chu', b'nked", "read_api_key": "r", ',
             b'"write_api_key": "w"}']
    conn.request("POST", "/v1/collections/create", body=iter(parts),
                 headers={"Authorization": f"Bearer {MASTER}",
                          "Content-Type": "application/json"},
                 encode_chunked=True)
    resp = conn.getresponse()
    assert (resp.status, json.loads(resp.read())["id"]) == (201, "chunked")
    status, body, _ = _call(conn, "POST", "/v1/collections/create",
                            {"id": "continued"},
                            headers={"Expect": "100-continue"})
    assert status == 201 and json.loads(body)["id"] == "continued"
    assert {"chunked", "continued"} <= set(orama.write_side.collections)
    # HEAD is served by the GET route, without a body
    conn.request("HEAD", "/health")
    resp = conn.getresponse()
    assert (resp.status, resp.read()) == (200, b"")


def test_sse_route_streams(live_port):
    port, _ = live_port
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    _call(conn, "POST", "/v1/collections/create",
          {"id": "s", "read_api_key": "r", "write_api_key": "w"})
    for _ in range(300):  # the read side applies the create
        status, _, _ = _call(conn, "POST", "/v1/collections/s/search",
                             {"term": "x"}, key="r")
        if status == 200:
            break
    status, body, resp = _call(conn, "GET", "/v1/collections/s/logs", key="r")
    assert status == 200
    assert resp.getheader("content-type") == "text/event-stream"
    assert resp.getheader("transfer-encoding") == "chunked"
    assert body == b": no hooks runtime\n\n"
    # the connection stays usable after a streamed answer
    status, body, _ = _call(conn, "GET", "/health")
    assert (status, body) == (200, b"OK")
