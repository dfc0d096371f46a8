"""The port's hooks runtime (`oramacore_tpu_torch.ai.hooks`) on the CPU.

The bodies of `tests/test_hooks_sandbox.py` run on the port's
`HooksRuntime` (their `oramacore_tpu.ai.hooks` and `oramacore_tpu.config`
imports, and `tests.utils.TestContext`, point at the port for the case).
Then the three hook sites of the engine (TransformDocumentBeforeSave on
the write side, BeforeSearch and TransformDocumentAfterSearch on the read
side) run the same hooks on the same documents through both packages,
whose answers must agree.
"""

from __future__ import annotations

import sys

import pytest

from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch.ai import hooks as port_hooks
from oramacore_tpu_torch.types import SearchParams

from . import test_hooks_sandbox as sandbox_suite
from . import utils as jax_utils
from .test_torch_auth import rebound_suite
from .test_torch_e2e import PortTestContext

SANDBOX_BODIES = rebound_suite(sandbox_suite,
                               {"HooksRuntime": port_hooks.HooksRuntime})


def test_every_sandbox_body_is_run():
    assert len(SANDBOX_BODIES) == 9


@pytest.mark.parametrize("name", sorted(SANDBOX_BODIES))
def test_hooks_sandbox_on_port(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "oramacore_tpu.ai.hooks", port_hooks)
    monkeypatch.setitem(sys.modules, "oramacore_tpu.config", port_config)
    monkeypatch.setattr(jax_utils, "TestContext", PortTestContext)
    SANDBOX_BODIES[name]()


def test_the_prelude_imports_only_the_standard_library():
    """A hook's interpreter starts from `-I` and the prelude: no torch, no
    package of this repo."""
    rt = port_hooks.HooksRuntime()
    out = rt.exec_hook("c", "hook", (
        "import sys\n"
        "def hook(x):\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                  ('torch', 'numpy', 'oramacore_tpu_torch',\n"
        "                   'oramacore_tpu', 'jax'))\n"), {})
    assert out == []


HOOKS = {
    "TransformDocumentBeforeSave": (
        "def TransformDocumentBeforeSave(doc):\n"
        "    doc['title'] = doc['title'] + ' saved'\n"
        "    doc['n2'] = doc.get('n', 0) * 2\n"
        "    doc['id'] = 'changed'  # the id may not change\n"
        "    return doc\n"),
    "BeforeSearch": (
        "def BeforeSearch(inp):\n"
        "    return {'term': inp['term'].replace('dragon', 'castle'),\n"
        "            'limit': 3}\n"),
    "TransformDocumentAfterSearch": (
        "def TransformDocumentAfterSearch(doc):\n"
        "    doc['seen'] = True\n"
        "    doc.pop('secret_field', None)\n"
        "    return doc\n"),
}

DOCS = [{"id": str(i),
         "title": ["dragon quest", "castle night", "saved castle"][i % 3]
         + f" {i}",
         "n": i, "secret_field": "x"} for i in range(12)]


def _run(ctx):
    coll = ctx.create_collection()
    idx = coll.create_index()
    for name, code in HOOKS.items():
        ctx.writer.set_hook(coll.collection_id, coll.write_key, name, code)
    ctx.pump()
    idx.insert_documents(DOCS)
    out = {}
    for term in ("dragon", "castle", "saved"):
        r = coll.search({"term": term, "limit": 10})
        out[term] = (r.count, [(h.id, round(h.score, 5), h.document)
                               for h in r.hits])
    out["stored"] = ctx.reader.batch_get_documents(
        coll.collection_id, coll.read_key, ["0", "1"])
    out["hooks"] = ctx.writer.list_hooks(coll.collection_id, coll.write_key)
    return out


def test_hook_sites_agree_with_jax():
    jctx = jax_utils.TestContext()
    pctx = PortTestContext()
    try:
        j, p = _run(jctx), _run(pctx)
    finally:
        jctx.close()
        pctx.close()
    assert p == j
    # the hooks did what they say: BeforeSearch rewrote the term and the
    # limit, the documents were transformed before saving and after
    count, hits = p["dragon"]
    assert len(hits) == 3 and all("castle" in d["title"] for _, _, d in hits)
    assert all(d["seen"] and "secret_field" not in d for _, _, d in hits)
    assert p["stored"]["0"]["title"] == "dragon quest 0 saved"
    assert p["stored"]["1"]["n2"] == 2 and p["stored"]["1"]["id"] == "1"
    assert p["hooks"] == HOOKS


def test_set_hook_replicates_and_runs_after_a_restart(tmp_path):
    ctx = PortTestContext(data_dir=str(tmp_path))
    try:
        coll = ctx.create_collection()
        idx = coll.create_index()
        ctx.writer.set_hook(coll.collection_id, coll.write_key,
                            "TransformDocumentAfterSearch",
                            HOOKS["TransformDocumentAfterSearch"])
        idx.insert_documents(DOCS[:3])
        assert coll.search({"term": "dragon"}).hits[0].document["seen"]
        ctx = ctx.reload()
        r = ctx.reader.search(coll.collection_id, coll.read_key,
                              SearchParams.from_json({"term": "dragon"}))
        assert r.hits[0].document["seen"]
    finally:
        ctx.close()
