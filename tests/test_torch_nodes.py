"""Multi-node deployments of the port on the CPU: the TCP op log
(`oramacore_tpu_torch.oplog`: `TcpLogServer`, `TcpOperationReceiver`,
the `tcp-stream` branch of `channel_creator`) and writer / reader nodes.

The bodies of `tests/test_tcp_oplog.py` and `tests/test_multi_node.py`
run with the port's names in their globals, and
`tests/test_durability_kill9.py`'s scenario runs with a port reader in
the subprocess (`PORT_READER_SCRIPT`) that is killed with SIGKILL
mid-stream, restarted, and must converge to the in-process control
reader's answer.
"""

from __future__ import annotations

import pytest

from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch import oplog as port_oplog
from oramacore_tpu_torch import types as port_types

from . import test_durability_kill9 as kill9_suite
from . import test_multi_node as multi_node_suite
from . import test_tcp_oplog as tcp_suite
from .test_torch_auth import cpu_build_orama, rebound_suite

PORT_NAMES = {
    "OramacoreConfig": port_config.OramacoreConfig,
    "build_orama": cpu_build_orama,
    "SearchParams": port_types.SearchParams,
    "Operation": port_oplog.Operation,
    "TcpLogServer": port_oplog.TcpLogServer,
    "TcpOperationReceiver": port_oplog.TcpOperationReceiver,
    "FileStreamSender": port_oplog.FileStreamSender,
}

TCP_BODIES = rebound_suite(tcp_suite, PORT_NAMES)
MULTI_NODE_BODIES = rebound_suite(multi_node_suite, PORT_NAMES)

# the subprocess reader of test_durability_kill9.py, on the port (no jax)
PORT_READER_SCRIPT = r"""
import json, os, sys, time
sys.path.insert(0, {repo!r})
from oramacore_tpu_torch.config import OramacoreConfig
from oramacore_tpu_torch.runtime import build_orama
from oramacore_tpu_torch.types import SearchParams

data_dir, port, status_file = sys.argv[1], int(sys.argv[2]), sys.argv[3]
cfg = OramacoreConfig()
cfg.data_dir = data_dir
cfg.role = "reader"
cfg.reader_side.input = {{
    "type": "tcp-stream", "host": "127.0.0.1", "port": port,
}}
cfg.reader_side.insert_batch_commit_size = 200  # commit often mid-stream
node = build_orama(cfg, device="cpu", start_consumer=True)
r = node.read_side
assert not any(m == "jax" or m.startswith(("jax.", "oramacore_tpu."))
               for m in sys.modules)
while True:
    status = {{"count": 0, "offset": int(r.committed_offset), "hits": None}}
    try:
        coll = r.collections.get("c")
        if coll is not None:
            status["count"] = coll.document_count()
            out = r.search(
                "c", sys.argv[4],
                SearchParams.from_json({{"term": "alpha beta", "limit": 10}}),
            )
            status["hits"] = [[h.id, round(h.score, 6)] for h in out.hits]
            status["total"] = out.count
    except Exception as e:  # noqa: BLE001
        status["error"] = str(e)
    tmp = status_file + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(status, fh)
    os.replace(tmp, status_file)
    time.sleep(0.1)
"""

KILL9_BODIES = rebound_suite(kill9_suite, {
    **PORT_NAMES, "READER_SCRIPT": PORT_READER_SCRIPT})


def test_every_body_is_run():
    assert (len(TCP_BODIES), len(MULTI_NODE_BODIES), len(KILL9_BODIES)) \
        == (4, 1, 1)


@pytest.mark.parametrize("name", sorted(TCP_BODIES))
def test_tcp_oplog_on_port(name, tmp_path):
    TCP_BODIES[name](tmp_path)


@pytest.mark.parametrize("name", sorted(MULTI_NODE_BODIES))
def test_multi_node_on_port(name, tmp_path):
    MULTI_NODE_BODIES[name](tmp_path)


@pytest.mark.parametrize("name", sorted(KILL9_BODIES))
def test_durability_kill9_on_port(name, tmp_path):
    KILL9_BODIES[name](tmp_path)


def test_channel_creator_tcp_stream(tmp_path):
    """The writer's branch serves its file over TCP on the port it was
    given (0: a free one); the reader's branch gives a receiver factory
    and a sender that refuses to send."""
    sender, rx_factory = port_oplog.channel_creator({
        "type": "tcp-stream", "path": str(tmp_path / "ops"),
        "host": "127.0.0.1", "port": 0})
    try:
        server = sender.tcp_server
        assert server.port > 0
        sender.send(port_oplog.Operation("kv_insert", None,
                                         {"key": "a", "value": {1: "x"}}))
        ro, factory = port_oplog.channel_creator({
            "type": "tcp-stream", "host": "127.0.0.1", "port": server.port})
        with pytest.raises(RuntimeError):
            ro.send(port_oplog.Operation("kv_insert"))
        assert ro.offset == 0
        rx = factory(0)
        off, op = rx.recv(timeout=5.0)
        # the frame carries the port's tagged JSON: an int map key survives
        assert off == 1 and op.body == {"key": "a", "value": {1: "x"}}
        rx.close()
    finally:
        sender.tcp_server.close()
        sender.close()
