"""The port's runtime parts on the CPU: the op log's file-stream transport,
the storage files, the config and the refusals of `build_orama`, the read
side and the write side for what the port does not have yet.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from oramacore_tpu_torch.config import (
    OramacoreConfig,
    config_from_dict,
    load_config,
)
from oramacore_tpu_torch.oplog import (
    FileStreamTransport,
    InMemoryTransport,
    Operation,
    channel_creator,
)
from oramacore_tpu_torch.runtime import build_orama
from oramacore_tpu_torch.storage.docstore import DocumentStore
from oramacore_tpu_torch.storage.files import (
    atomic_write_packed,
    pack_json,
    read_packed,
    unpack_json,
)
from oramacore_tpu_torch.storage.kv import KV


def _cfg(tmp_path, **sections) -> OramacoreConfig:
    cfg = OramacoreConfig()
    cfg.data_dir = str(tmp_path / "data")
    cfg.auth.master_api_key = "m"
    for k, v in sections.items():
        setattr(cfg, k, v)
    return cfg


def _write_side_ops(tmp_path):
    """Every op kind the port's write side emits, from one scripted
    session over an in-memory channel (embeddings computed inline)."""
    from oramacore_tpu_torch.embeddings import EmbeddingsService
    from oramacore_tpu_torch.utils.tokenizer import NLPService
    from oramacore_tpu_torch.write import WriteSide

    t = InMemoryTransport()
    rx = t.receiver()
    ws = WriteSide(_cfg(tmp_path), t.sender(), EmbeddingsService(),
                   NLPService(), sync_embeddings=True)
    c = ws.create_collection("m", "c")
    wk = c.write_api_key
    ws.create_index("c", wk, "i")
    docs = [
        {"id": "1", "title": "Ünïcode café — naïve fox", "price": 3.25,
         "tags": ["red", "blue"], "n": [1, 2.5], "ok": True,
         "when": "2024-03-01T10:00:00Z", "at": {"lat": 45.5, "lon": 9.25},
         "_omc": 1.5},
        {"id": "2", "title": "plain text", "price": 7},
    ]
    ws.insert_documents("c", "i", wk, docs)
    ws.update_documents("c", "i", wk, [{"id": "2", "title": "changed"}])
    ws.delete_documents("c", "i", wk, ["1"])
    tmp = ws.create_temporary_index("c", wk, "i", temp_index_id="i-tmp")
    ws.insert_documents("c", tmp.index_id, wk, [{"id": "3", "title": "t"}])
    ws.replace_index("c", wk, "i", "i-tmp")
    ws.insert_pin_rule("c", wk, {"id": "r", "conditions": [
        {"pattern": "fox", "anchoring": "is"}], "consequence": {"promote": [
            {"doc_id": "2", "position": 0}]}})
    ws.delete_pin_rule("c", wk, "r")
    ws.insert_shelf("c", wk, {"id": "s", "doc_ids": ["2"]})
    ws.delete_shelf("c", wk, "s")
    ws.set_value("c", wk, "k", "v")
    ws.delete_value("c", wk, "k")
    ws.regenerate_read_api_key("c", "m")
    ws.delete_hook("c", wk, "BeforeSearch")
    ws.kv.insert("prompt:1", {"text": "x", "n": {1: "int key"}})
    ws.kv.remove("prompt:1")
    ws.create_index("c", wk, "j")
    ws.delete_index("c", wk, "j")
    ws.delete_collection("m", "c")
    ws.stop()
    return [op for _, op in rx.drain()]


def test_every_op_kind_round_trips_the_file_stream(tmp_path):
    ops = _write_side_ops(tmp_path)
    kinds = {op.kind for op in ops}
    assert kinds >= {
        "create_collection", "create_index", "create_field",
        "index_document", "index_embedding", "delete_documents",
        "replace_index", "pin_rule_insert", "pin_rule_delete",
        "shelf_insert", "shelf_delete", "value_set", "value_delete",
        "update_read_api_key", "hook_delete", "kv_insert", "kv_delete",
        "delete_index", "delete_collection"}, kinds
    t = FileStreamTransport(str(tmp_path / "log" / "ops.bin"))
    tx = t.sender()
    assert tx.send_batch(ops[:5]) == 5
    for op in ops[5:]:
        tx.send(op)
    tx.close()
    got = [op for _, op in t.receiver().drain()]
    assert got == ops
    # the strings' control separators survive, byte for byte
    packed = [op.body["strings_packed"] for op in ops
              if op.kind == "index_document"]
    assert any("\x02" in p[1] or "\x01" in p[1]
               for body in packed for p in body.values())
    # f32 vectors bit for bit
    for a, b in zip(ops, got):
        if a.kind == "index_embedding":
            va = np.asarray(a.body["vectors"], np.float32)
            vb = np.asarray(b.body["vectors"], np.float32)
            assert va.tobytes() == vb.tobytes()
    # the kv op's nested int key stays an int
    kv = next(op for op in got if op.kind == "kv_insert")
    assert kv.body["value"]["n"] == {1: "int key"}
    # a reader resuming from an offset sees only the later ops
    tail = [op for _, op in t.receiver(start_offset=7).drain()]
    assert tail == ops[7:]


def test_operation_bytes_keep_what_msgpack_keeps():
    body = {"doc_id": 7, "m": {3: [1.5, float("inf")], (1, 2): "t"},
            "b": b"\x00\xff", "s": "a\x01b\x02c", "nan": float("nan")}
    op = Operation.from_bytes(Operation("k", "c", body).to_bytes())
    assert op.body["m"] == {3: [1.5, float("inf")], (1, 2): "t"}
    assert op.body["b"] == b"\x00\xff" and op.body["s"] == "a\x01b\x02c"
    assert np.isnan(op.body["nan"])
    assert unpack_json(pack_json([(1, 2), {"x": None}])) == [[1, 2],
                                                            {"x": None}]


def test_int_keys_survive_docstore_and_kv_reload(tmp_path):
    ds = DocumentStore(str(tmp_path / "ds"))
    ds.insert_many([(i, json.dumps({"i": i}).encode()) for i in range(5)])
    ds.remove([2])
    ds.commit()
    ds2 = DocumentStore(str(tmp_path / "ds"))
    assert ds2.iter_ids() == [0, 1, 3, 4]
    assert all(isinstance(k, int) for k in ds2._index)
    assert json.loads(ds2.get(3)) == {"i": 3}
    kv = KV(str(tmp_path / "kv.json"))
    kv.insert("a", {1: "one", "2": [3, {4: 5}]})
    kv.commit()
    assert KV(str(tmp_path / "kv.json")).get("a") == {1: "one",
                                                      "2": [3, {4: 5}]}
    atomic_write_packed(str(tmp_path / "m.json"), {7: 8})
    assert read_packed(str(tmp_path / "m.json")) == {7: 8}
    assert read_packed(str(tmp_path / "absent.json"), default=3) == 3


_CONFIG = {
    "data_dir": "/srv/data",
    "http": {"port": 9090},
    "writer_side": {"insert_batch_commit_size": 123,
                    "output": {"type": "file-stream", "path": "/tmp/o"}},
    "reader_side": {"pruning": "on", "pruned_min_docs": 10},
    "ai": {"embeddings_model": "SemanticMini"},
    "log": {"console_level": "debug"},
    "log_levels": {"x": "warn"},
}
_ENV = {"ORAMACORE_HTTP_PORT": "7070",
        "ORAMACORE_READER_SIDE_COMMIT_INTERVAL": "2.5",
        "ORAMACORE_ROLE": "reader"}


def _as_dict(cfg):
    import dataclasses

    return json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


@pytest.mark.parametrize("source", ["dict", "json_file"])
def test_config_parse_equals_jax(source, tmp_path, monkeypatch):
    """The port parses a dict or a JSON file, with the env overrides, into
    what the JAX package's load_config gives for the same values (JSON is
    YAML, so the JAX loader reads the same file)."""
    from oramacore_tpu import config as jax_config

    path = tmp_path / "config.json"
    path.write_text(json.dumps(_CONFIG))
    for k, v in _ENV.items():
        monkeypatch.setenv(k, v)
    want = _as_dict(jax_config.load_config(str(path)))
    got = (config_from_dict(_CONFIG) if source == "dict"
           else load_config(str(path)))
    assert _as_dict(got) == want
    assert got.http.port == 7070
    # "_" splits every env key, so a two-word section name is not reached
    # (the same in both packages)
    assert got.reader_side.commit_interval == 60.0
    assert got.role == "reader" and got.reader_side.pruning == "on"
    assert _CONFIG["http"] == {"port": 9090}  # the caller's dict unchanged


def test_config_defaults_equal_jax():
    from oramacore_tpu import config as jax_config

    assert _as_dict(OramacoreConfig()) == _as_dict(jax_config.OramacoreConfig())


def test_build_orama_without_a_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_orama(_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_orama(_cfg(tmp_path), device="cuda")


def test_unported_features_raise(tmp_path):
    """Nothing build_orama once refused is left: the mesh is switched
    off here, with fewer devices than shards, as the JAX read side does. JWT providers, a secrets provider, hook settings and the
    tcp-stream op log are built and attached."""
    from oramacore_tpu_torch.ai.hooks import HooksRuntime
    from oramacore_tpu_torch.auth import JwtManager
    from oramacore_tpu_torch.config import (
        HooksConfig,
        JwtProviderConfig,
        ReaderSideConfig,
        SecretsConfig,
    )
    from oramacore_tpu_torch.utils.secrets import SecretsService

    cases = [
        (dict(reader_side=ReaderSideConfig(sharded_shards=1 << 20)), None),
        ({}, "jwt"),
        (dict(secrets=SecretsConfig(provider="local", path="x")), "secrets"),
        (dict(hooks=HooksConfig(allow_js=True, execution_timeout_ms=1500,
                                deny_domains=["a.example"])), "hooks"),
    ]
    for sections, what in cases:
        cfg = _cfg(tmp_path / (what or "mesh"), **sections)
        if what == "jwt":
            cfg.auth.jwt_providers = [JwtProviderConfig(issuer="i")]
        o = build_orama(cfg, device="cpu", start_consumer=False)
        try:
            if what is None:
                # more shards than this host has devices: switched off
                # with a warning, as the JAX read side does
                assert o.read_side.sharded_mesh is None
            if what == "jwt":
                assert isinstance(o.read_side.jwt_manager, JwtManager)
                assert o.write_side.jwt_manager is o.read_side.jwt_manager
            if what == "secrets":
                assert isinstance(o.read_side.secrets_service, SecretsService)
            rt = o.read_side.hooks_runtime
            assert isinstance(rt, HooksRuntime)
            assert o.write_side.hooks_runtime is rt
            if what == "hooks":
                assert (rt.allow_js, rt.execution_timeout_s,
                        rt.deny_domains) == (True, 1.5, ["a.example"])
        finally:
            o.stop()
    sender, _ = channel_creator({"type": "tcp-stream", "path": str(
        tmp_path / "ops"), "host": "127.0.0.1", "port": 0})
    assert sender.tcp_server.port > 0
    sender.tcp_server.close()
    sender.close()
    _, factory = channel_creator({"type": "tcp-stream", "port": 1})
    assert callable(factory)
    with pytest.raises(ValueError):
        channel_creator({"type": "carrier-pigeon"})


def test_enough_devices_for_the_mesh_raise(tmp_path, monkeypatch):
    """With as many CUDA devices as shards the read side once refused the
    mesh; it now builds it over the distinct devices, as the JAX read
    side builds it from `jax.devices()`, and `mesh_devices` names them
    instead (a device may repeat)."""
    import oramacore_tpu_torch.read as port_read
    from oramacore_tpu_torch.config import ReaderSideConfig

    monkeypatch.setattr(port_read, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = _cfg(tmp_path, reader_side=ReaderSideConfig(sharded_shards=4))
    from oramacore_tpu_torch.embeddings import EmbeddingsService
    from oramacore_tpu_torch.utils.tokenizer import NLPService

    _, rx = channel_creator(None)
    rs = port_read.ReadSide(cfg, rx, EmbeddingsService(), NLPService(),
                            device="cuda")
    assert rs.sharded_mesh.devices == [torch.device("cuda", i)
                                       for i in range(4)]
    rs = port_read.ReadSide(cfg, rx, EmbeddingsService(), NLPService(),
                            device="cuda",
                            mesh_devices=[torch.device("cpu")] * 4)
    assert rs.sharded_mesh.devices == [torch.device("cpu")] * 4


def test_set_hook_raises_and_stores_nothing(tmp_path):
    """set_hook (once refused) stores the hook, sends it on the op log and
    the read side runs it; a bad write key is still refused and stores
    nothing."""
    from oramacore_tpu_torch.types import SearchParams
    from oramacore_tpu_torch.write import WriteError

    o = build_orama(_cfg(tmp_path), device="cpu", sync_embeddings=True,
                    start_consumer=False)
    c = o.write_side.create_collection("m", "c")
    o.write_side.create_index("c", c.write_api_key, "i")
    o.write_side.insert_documents("c", "i", c.write_api_key,
                                  [{"id": "1", "t": "alpha"}])
    n_before = o.write_side.op_sender.offset
    with pytest.raises(WriteError):
        o.write_side.set_hook("c", "bad key", "BeforeSearch", "x")
    assert o.write_side.op_sender.offset == n_before
    code = ("def TransformDocumentAfterSearch(doc):\n"
            "    doc['hooked'] = True\n    return doc\n")
    o.write_side.set_hook("c", c.write_api_key,
                          "TransformDocumentAfterSearch", code)
    assert o.write_side.op_sender.offset == n_before + 1
    assert o.write_side.list_hooks("c", c.write_api_key) == {
        "TransformDocumentAfterSearch": code}
    o.read_side.pump()
    assert o.read_side.collections["c"].hooks == {
        "TransformDocumentAfterSearch": code}
    r = o.read_side.search("c", c.read_api_key,
                           SearchParams.from_json({"term": "alpha"}))
    assert r.hits[0].document == {"id": "1", "t": "alpha", "hooked": True}
    o.stop()


def test_snapshot_files_carry_no_msgpack(tmp_path):
    """What the port writes to disk is JSON and npz: a commit's files
    load in a process without msgpack."""
    o = build_orama(_cfg(tmp_path), device="cpu", sync_embeddings=True,
                    start_consumer=False)
    c = o.write_side.create_collection("m", "c")
    o.write_side.create_index("c", c.write_api_key, "i")
    o.write_side.insert_documents("c", "i", c.write_api_key,
                                  [{"id": "1", "t": "a b", "n": 1}])
    o.write_side.kv.insert("prompt", {"text": "p"})
    o.read_side.pump()
    o.write_side.commit()
    o.read_side.commit(force=True)
    o.stop()
    names = []
    for root, _, files in os.walk(tmp_path / "data"):
        names += files
    assert not [n for n in names if "msgpack" in n], names
    assert "string.meta.json" in names and "filters.meta.json" in names
    assert "index.json" in names and "kv.json" in names


def test_commit_while_inserts_land(tmp_path):
    """The server's maintenance thread commits while requests insert:
    WriteSide.commit never fails on a doc-id map that grows under it, and
    the map on disk holds every document once the inserts are done."""
    import threading

    from oramacore_tpu_torch.storage.files import read_packed

    o = build_orama(_cfg(tmp_path), device="cpu", start_consumer=False)
    ws = o.write_side
    c = ws.create_collection("m", "c")
    ws.create_index("c", c.write_api_key, "i")
    errors, done = [], threading.Event()

    def commits():
        while not done.is_set():
            try:
                ws.commit()
            except Exception as e:  # noqa: BLE001 — collected and asserted
                errors.append(e)

    t = threading.Thread(target=commits)
    t.start()
    try:
        for b in range(20):
            ws.insert_documents("c", "i", c.write_api_key, [
                {"id": f"{b}-{i}", "n": i} for i in range(500)])
    finally:
        done.set()
        t.join()
    ws.commit()
    assert not errors, errors[:3]
    on_disk = read_packed(ws._doc_map_path("c", "i"), default=None)
    assert len(on_disk) == 10_000
    o.stop()


def test_a_runtime_keeps_its_devices_encoders(tmp_path):
    """`build_orama` binds the bundled encoders for its device. A second
    runtime built in the same process for another device (as a CPU
    reference runtime beside the card's) binds the same names for the
    CPU, but the first runtime's service keeps the backend bound to its
    own device: its query embeddings stay where it runs."""
    from oramacore_tpu_torch import embeddings as temb

    saved = dict(temb._BACKENDS)
    try:
        calls = []

        def on_the_card(texts, info):
            calls.append(len(texts))
            return [np.zeros(info.dim, np.float32) for _ in texts]

        temb.register_backend("flax:SemanticBase", on_the_card,
                              device=torch.device("cuda"))
        card_side = temb.EmbeddingsService(device=torch.device("cuda"))
        cpu = build_orama(_cfg(tmp_path), device="cpu",
                          start_consumer=False)
        try:
            assert cpu.read_side.embeddings.device == "cpu"
            on_cpu = temb._BACKENDS[("flax:SemanticBase", "cpu")]
            assert on_cpu is not on_the_card
            assert cpu.read_side.embeddings._backend(
                "flax:SemanticBase") is on_cpu
            card_side.calculate_embeddings(["a query"], temb.Intent.QUERY,
                                           "SemanticBase")
            assert calls == [1]
            # a service of no device takes the last binding, as before
            assert temb.EmbeddingsService()._backend(
                "flax:SemanticBase") is on_cpu
        finally:
            cpu.stop()
    finally:
        temb._BACKENDS.clear()
        temb._BACKENDS.update(saved)


def test_a_card_service_never_takes_another_devices_binding(tmp_path):
    """A CPU runtime binds a name (SemanticMini) that the card's runtime
    never bound: the card's service does not take the CPU-bound encoder
    for it. It takes only bindings of its own device or of none, so the
    name falls through to the hash backend, as an unbound name does."""
    from oramacore_tpu_torch import embeddings as temb

    saved = dict(temb._BACKENDS)
    try:
        for key in [k for k in temb._BACKENDS if k[0].startswith("flax")]:
            del temb._BACKENDS[key]
        card_side = temb.EmbeddingsService(device=torch.device("cuda"))
        cpu = build_orama(_cfg(tmp_path), device="cpu",
                          start_consumer=False)
        try:
            assert ("flax:SemanticMini", "cpu") in temb._BACKENDS
            assert card_side._backend("flax:SemanticMini") is None
            assert card_side._backend("flax") is None
            assert card_side._backend("hash") is temb._hash_backend
            used = []
            real = temb._BACKENDS[("hash", None)]
            temb._BACKENDS[("hash", None)] = lambda texts, info: (
                used.append(info.name) or real(texts, info))
            out = card_side.calculate_embeddings(
                ["a query"], temb.Intent.QUERY, "SemanticMini")
            assert used == ["SemanticMini"] and len(out[0]) == 1
        finally:
            cpu.stop()
    finally:
        temb._BACKENDS.clear()
        temb._BACKENDS.update(saved)
