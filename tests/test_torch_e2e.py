"""The JAX package's end-to-end suites, run against the port on the CPU.

The bodies of `tests/test_e2e_search.py` and `tests/test_search_behaviors.py`
run unchanged, one parametrised case per body, against `PortTestContext`:
the fluent API of `tests/utils.py` (`TestContext`, `TestCollectionClient`,
`TestIndexClient`) over the port's `build_orama(device="cpu")`. The suites'
modules are imported under other names, so pytest collects their tests only
where they live.

A body names the JAX package in its own imports (`from oramacore_tpu.types
import SearchParams`, `from oramacore_tpu.index import search_exec`, ...)
and calls `TestContext` from its module's globals. For the time of one case
those names point at the port: the body gets a copy of its module's globals
with `TestContext` and `ids_of` replaced, and `sys.modules` (and the
`oramacore_tpu.index` package attribute) maps each JAX module a body
imports to its port counterpart. `oramacore_tpu.runtime` maps to a module
whose `build_orama` runs on the CPU, as every port test does.
"""

from __future__ import annotations

import inspect
import shutil
import sys
import tempfile
import threading
import types
from typing import Any, Dict, List, Optional

import pytest

import oramacore_tpu.index as jax_index_pkg
import oramacore_tpu.read as jax_read
import oramacore_tpu.write as jax_write
from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch import oplog as port_oplog
from oramacore_tpu_torch import read as port_read
from oramacore_tpu_torch import runtime as port_runtime
from oramacore_tpu_torch import types as port_types
from oramacore_tpu_torch.ai import hooks as port_hooks
from oramacore_tpu_torch.index import search_exec as port_search_exec

from . import test_e2e_search as e2e_suite
from . import test_search_behaviors as behaviors_suite

MASTER_KEY = "master-key-test"


def _cpu_build_orama(config, **kwargs):
    kwargs.setdefault("device", "cpu")
    return port_runtime.build_orama(config, **kwargs)


class PortTestContext:
    """`tests/utils.py`'s TestContext over the port's runtime (CPU)."""

    def __init__(self, data_dir: Optional[str] = None, llm_resolve_mode=None):
        self._pump_lock = threading.Lock()
        self._own_dir = data_dir is None
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="oramacore-port-")
        self.config = self._make_config(self.data_dir)
        self.orama = _cpu_build_orama(
            self.config, sync_embeddings=True, start_consumer=False,
            llm_resolve_mode=llm_resolve_mode,
        )
        self._n = 0

    @staticmethod
    def _make_config(data_dir: str):
        cfg = port_config.OramacoreConfig()
        cfg.data_dir = data_dir
        cfg.auth.master_api_key = MASTER_KEY
        cfg.writer_side.insert_batch_commit_size = 10_000_000
        cfg.reader_side.insert_batch_commit_size = 10_000_000
        return cfg

    @property
    def writer(self):
        return self.orama.write_side

    @property
    def reader(self):
        return self.orama.read_side

    def pump(self):
        with self._pump_lock:
            self.orama.write_side.embedding_queue.flush_and_wait()
            return self.orama.read_side.pump()

    def create_collection(self, **kwargs) -> "PortCollectionClient":
        self._n += 1
        cid = kwargs.pop("collection_id", f"coll-{self._n}")
        coll = self.writer.create_collection(MASTER_KEY, cid, **kwargs)
        self.pump()
        return PortCollectionClient(self, cid, coll.write_api_key,
                                    coll.read_api_key)

    def commit_all(self):
        self.pump()
        self.writer.commit()
        self.reader.commit(force=True)

    def reload(self) -> "PortTestContext":
        self.commit_all()
        self.orama.stop()
        new = PortTestContext.__new__(PortTestContext)
        new._pump_lock = threading.Lock()
        new._own_dir = self._own_dir
        new.data_dir = self.data_dir
        new.config = self._make_config(self.data_dir)
        new.orama = _cpu_build_orama(new.config, sync_embeddings=True,
                                     start_consumer=False)
        new._n = self._n
        return new

    def close(self):
        self.orama.stop()
        if self._own_dir:
            shutil.rmtree(self.data_dir, ignore_errors=True)


class PortCollectionClient:
    def __init__(self, ctx: PortTestContext, collection_id: str,
                 write_key: str, read_key: str):
        self.ctx = ctx
        self.collection_id = collection_id
        self.write_key = write_key
        self.read_key = read_key
        self._n = 0

    def create_index(self, index_id: Optional[str] = None, **kwargs):
        self._n += 1
        iid = index_id or f"index-{self._n}"
        self.ctx.writer.create_index(self.collection_id, self.write_key, iid,
                                     **kwargs)
        self.ctx.pump()
        return PortIndexClient(self, iid)

    def search(self, params: Dict[str, Any]):
        self.ctx.pump()
        return self.ctx.reader.search(
            self.collection_id, self.read_key,
            port_types.SearchParams.from_json(params),
        )

    def stats(self):
        return self.ctx.reader.collection_stats(self.collection_id,
                                                self.read_key)


class PortIndexClient:
    def __init__(self, coll: PortCollectionClient, index_id: str):
        self.coll = coll
        self.index_id = index_id

    def insert_documents(self, docs: List[Dict[str, Any]]):
        stats = self.coll.ctx.writer.insert_documents(
            self.coll.collection_id, self.index_id, self.coll.write_key, docs
        )
        self.coll.ctx.pump()
        return stats

    def delete_documents(self, user_ids: List[str]):
        n = self.coll.ctx.writer.delete_documents(
            self.coll.collection_id, self.index_id, self.coll.write_key,
            user_ids,
        )
        self.coll.ctx.pump()
        return n

    def insert_pin_rule(self, rule: Dict[str, Any]):
        self.coll.ctx.writer.insert_pin_rule(
            self.coll.collection_id, self.coll.write_key, rule
        )
        self.coll.ctx.pump()


def ids_of(result) -> List[str]:
    return [h.id.split(":", 1)[1] for h in result.hits]


# the bodies this port cannot run, each with its reason (none since the
# hooks runtime and the secrets service were ported)
EXCLUDED: Dict[str, str] = {}


def _bodies(module) -> List[str]:
    return sorted(n for n, f in vars(module).items()
                  if n.startswith("test_") and inspect.isfunction(f)
                  and f.__module__ == module.__name__)


def _port_modules() -> Dict[str, types.ModuleType]:
    rt = types.ModuleType("oramacore_tpu_torch_cpu_runtime")
    rt.build_orama = _cpu_build_orama
    rt.Orama = port_runtime.Orama
    return {
        "oramacore_tpu.types": port_types,
        "oramacore_tpu.config": port_config,
        "oramacore_tpu.read": port_read,
        "oramacore_tpu.oplog": port_oplog,
        "oramacore_tpu.runtime": rt,
        "oramacore_tpu.index.search_exec": port_search_exec,
        "oramacore_tpu.ai.hooks": port_hooks,
    }


def _jax_side_reached(*a, **kw):
    raise AssertionError("a port test body reached the JAX package")


def _run_against_port(module, name: str, monkeypatch, tmp_path):
    fn = getattr(module, name)
    g = dict(fn.__globals__)
    g["TestContext"] = PortTestContext
    if "ids_of" in g:
        g["ids_of"] = ids_of
    body = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)
    for mod_name, mod in _port_modules().items():
        monkeypatch.setitem(sys.modules, mod_name, mod)
    monkeypatch.setattr(jax_index_pkg, "search_exec", port_search_exec)
    # a body that reached the JAX package's read or write side would not
    # be testing the port: make that fail loudly
    for cls, meth in ((jax_read.ReadSide, "_search_locked"),
                      (jax_read.ReadSide, "search_batch"),
                      (jax_write.WriteSide, "insert_documents")):
        monkeypatch.setattr(cls, meth, _jax_side_reached)
    args = {}
    params = inspect.signature(fn).parameters
    ctx = None
    if "ctx" in params:
        ctx = args["ctx"] = PortTestContext()
    if "tmp_path" in params:
        args["tmp_path"] = tmp_path
    try:
        body(**args)
    finally:
        if ctx is not None:
            ctx.close()


E2E = [n for n in _bodies(e2e_suite) if n not in EXCLUDED]
BEHAVIORS = _bodies(behaviors_suite)


def test_every_body_runs_or_is_excluded_with_a_reason():
    assert len(_bodies(e2e_suite)) == 43 and len(BEHAVIORS) == 28
    assert set(EXCLUDED) <= set(_bodies(e2e_suite))
    assert all(len(reason) > 40 for reason in EXCLUDED.values())


@pytest.mark.parametrize("name", E2E)
def test_e2e_search_on_port(name, monkeypatch, tmp_path):
    _run_against_port(e2e_suite, name, monkeypatch, tmp_path)


@pytest.mark.parametrize("name", BEHAVIORS)
def test_search_behaviors_on_port(name, monkeypatch, tmp_path):
    _run_against_port(behaviors_suite, name, monkeypatch, tmp_path)
