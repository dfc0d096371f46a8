"""The port's client (`oramacore_tpu_torch.client`) and hurl runner
(`oramacore_tpu_torch.utils.hurl`) against the port's server on a real
socket, on the CPU.

- `tests/test_client_sdk.py`'s body with the port's client;
- `tests/test_hurl_http.py`'s parser and runner units with the port's
  runner, then `tests/hurl/api-test.hurl`, `search-paths.hurl`, and
  `kv-actions-test.hurl` twice: up to its first `system_prompts` entry on
  a server without an AI service, and whole on one with the port's
  `AIService` (no LLM configured, as `tests/test_hurl_http.py` serves it
  on the JAX side).
"""

from __future__ import annotations

import asyncio
import os
import threading

import pytest

from oramacore_tpu_torch import client as port_client
from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch import server as port_server
from oramacore_tpu_torch.ai.service import AIService
from oramacore_tpu_torch.utils import hurl as port_hurl

from . import test_client_sdk as sdk_suite
from . import test_hurl_http as hurl_suite
from .test_torch_auth import cpu_build_orama, rebound_suite

MASTER = "port-client-master"
HURL_DIR = os.path.join(os.path.dirname(__file__), "hurl")


class LiveServer:
    """The port's ApiServer with a CPU engine on 127.0.0.1, served from an
    event loop on its own thread."""

    def __init__(self, data_dir, master=MASTER, ai=False):
        cfg = port_config.OramacoreConfig()
        cfg.data_dir = str(data_dir)
        cfg.auth.master_api_key = master
        cfg.http.host, cfg.http.port = "127.0.0.1", 0
        cfg.writer_side.insert_batch_commit_size = 10_000_000
        cfg.reader_side.insert_batch_commit_size = 10_000_000
        self.orama = cpu_build_orama(cfg, sync_embeddings=True,
                                     start_consumer=True)
        ai_service = AIService(cfg, self.orama.write_side,
                               self.orama.read_side) if ai else None
        self.server = port_server.ApiServer(cfg, self.orama.write_side,
                                            self.orama.read_side, ai_service)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.server.start(),
                                         self.loop).result(10)
        self.url = f"http://127.0.0.1:{self.server.port}"

    def close(self):
        asyncio.run_coroutine_threadsafe(self.server.stop(),
                                         self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.orama.stop()


SDK_BODIES = rebound_suite(sdk_suite, {
    "OramaCoreTPU": port_client.OramaCoreTPU,
    "ApiError": port_client.ApiError,
})


@pytest.fixture()
def sdk_server(tmp_path):
    srv = LiveServer(tmp_path, master=sdk_suite.MASTER)
    yield srv.url
    srv.close()


@pytest.mark.parametrize("name", sorted(SDK_BODIES))
def test_client_sdk_on_port(name, sdk_server):
    SDK_BODIES[name](sdk_server)


HURL_UNITS = rebound_suite(hurl_suite, {
    "HurlError": port_hurl.HurlError,
    "jsonpath_get": port_hurl.jsonpath_get,
    "parse_hurl": port_hurl.parse_hurl,
    "run_hurl": port_hurl.run_hurl,
    "run_hurl_file": port_hurl.run_hurl_file,
})
UNIT_NAMES = sorted(n for n in HURL_UNITS
                    if "live_server" not in HURL_UNITS[n].__code__.co_varnames)


def test_every_body_is_run():
    assert len(SDK_BODIES) == 1
    assert UNIT_NAMES == ["test_jsonpath_subset", "test_parse_hurl_entries",
                          "test_run_hurl_asserts_and_captures"]


@pytest.mark.parametrize("name", UNIT_NAMES)
def test_hurl_units_on_port(name):
    HURL_UNITS[name]()


@pytest.fixture(scope="module")
def hurl_server(tmp_path_factory):
    srv = LiveServer(tmp_path_factory.mktemp("hurl"))
    yield srv.url
    srv.close()


def kv_actions_before_the_ai_service() -> str:
    """kv-actions-test.hurl up to its first system_prompts entry."""
    with open(os.path.join(HURL_DIR, "kv-actions-test.hurl")) as fh:
        lines = fh.read().splitlines()
    first = next(i for i, line in enumerate(lines)
                 if line.split(" ", 1)[0] in ("GET", "POST", "PUT")
                 and "/system_prompts/" in line)
    return "\n".join(lines[:first]) + "\n"


@pytest.mark.parametrize("script", ["api-test.hurl", "search-paths.hurl"])
def test_hurl_script_on_port(script, hurl_server):
    out = port_hurl.run_hurl_file(os.path.join(HURL_DIR, script),
                                  {"base_url": hurl_server,
                                   "master_key": MASTER})
    assert out["base_url"] == hurl_server


def test_hurl_kv_actions_up_to_the_ai_routes_on_port(hurl_server):
    text = kv_actions_before_the_ai_service()
    entries = port_hurl.parse_hurl(text)
    assert len(entries) > 10 and not any("system_prompts" in e.url
                                         for e in entries)
    port_hurl.run_hurl(text, {"base_url": hurl_server, "master_key": MASTER})


@pytest.fixture(scope="module")
def hurl_ai_server(tmp_path_factory):
    srv = LiveServer(tmp_path_factory.mktemp("hurl-ai"), ai=True)
    yield srv.url
    srv.close()


def test_hurl_kv_actions_whole_on_port(hurl_ai_server):
    """kv-actions-test.hurl to its end: values, hooks, pin rules, shelves,
    system prompts, tools and actions."""
    with open(os.path.join(HURL_DIR, "kv-actions-test.hurl")) as fh:
        entries = port_hurl.parse_hurl(fh.read())
    assert any("/system_prompts/" in e.url for e in entries)
    assert any("/tools/" in e.url for e in entries)
    out = port_hurl.run_hurl_file(os.path.join(HURL_DIR,
                                               "kv-actions-test.hurl"),
                                  {"base_url": hurl_ai_server,
                                   "master_key": MASTER})
    assert out["base_url"] == hurl_ai_server
