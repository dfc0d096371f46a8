"""Operation log — the only write→read communication channel.

Reference: src/collection_manager/sides/operation/ — `WriteOperation`
(op.rs:311), `OperationSender`/`OperationReceiver` with monotonic
`Offset(u64)` (mod.rs:16-110), two transports (in-memory mpsc
mod.rs:240-263; RabbitMQ streams rabbit.rs with reconnect + replay).

This build keeps the same contract: every mutation is a serialized
operation with a monotonic offset; the read side applies ops
idempotently (skip offset <= committed). Transports:

- InMemoryTransport: single-process deque (the test/default backend —
  identical semantics to the durable one, mirroring how the reference
  tests multi-node logic in one process, SURVEY §4).
- FileStreamTransport: durable append-only framed stream on shared
  storage; a reader tails from its committed offset — the multi-node
  replication backend (RabbitMQ-streams equivalent).

The port's copy of `oramacore_tpu/oplog/__init__.py`, with the same
names and behaviour, apart from two things. A frame holds tagged JSON
(`storage.files.pack_json`) in place of msgpack, so an op body survives
the stream exactly: int map keys, strings with control separators and
f32 vectors carried as float lists (each f32 is a double in JSON, read
back as the same double). The TCP transport (`tcp-stream`, multi-node)
carries those same frames.
"""

from __future__ import annotations

import os
import struct
import threading
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..storage.files import pack_json, unpack_json


# ---------------------------------------------------------------------------
# Operation model
# ---------------------------------------------------------------------------

@dataclass
class Operation:
    """A replicated mutation. `kind` selects the handler; `body` is a
    JSON-able dict. Kinds mirror the reference enum (op.rs:311):

    collection: create_collection, delete_collection
    index:      create_index, delete_index, replace_index, create_temp_index
    field:      create_field
    documents:  index_document, delete_documents, index_embedding
    doc store:  insert_document_storage, delete_document_storage
    kv:         kv_insert, kv_delete
    hooks:      hook_insert, hook_delete
    merch:      pin_rule_insert, pin_rule_delete, shelf_insert, shelf_delete
    values:     value_set, value_delete
    """

    kind: str
    collection: Optional[str] = None
    body: Dict[str, Any] = dc_field(default_factory=dict)

    def to_bytes(self) -> bytes:
        return pack_json({"k": self.kind, "c": self.collection, "b": self.body})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Operation":
        d = unpack_json(raw)
        return cls(kind=d["k"], collection=d.get("c"), body=d.get("b") or {})

    def type_id(self) -> str:
        return self.kind


Offset = int


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class OperationSender:
    def send(self, op: Operation) -> Offset:
        raise NotImplementedError

    def send_batch(self, ops: List[Operation]) -> Offset:
        last = 0
        for op in ops:
            last = self.send(op)
        return last

    @property
    def offset(self) -> Offset:
        raise NotImplementedError


class OperationReceiver:
    def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[Offset, Operation]]:
        raise NotImplementedError

    def drain(self) -> Iterator[Tuple[Offset, Operation]]:
        while True:
            item = self.recv(timeout=0)
            if item is None:
                return
            yield item


class InMemoryTransport:
    """Single-process transport: one sender, N receivers each with an
    independent cursor (so writer+reader in one process share it).

    Ops pass as OBJECTS, no serde — matching the reference's in-memory
    channel (operation/mod.rs tokio mpsc sends WriteOperation values;
    only the RabbitMQ transport bincode-serializes). Contract: neither
    side mutates an op body after send (measured: round-tripping every
    op through a serializer cost ~40% of read-side apply throughput)."""

    def __init__(self):
        self._log: List[Operation] = []
        # absolute offset of the last op in the log; `_base` is the
        # absolute offset BEFORE the first op in `_log` (ops below it
        # predate this process — the reference seeds its in-memory
        # AtomicU64 from the writer's persisted offset the same way,
        # operation/mod.rs:188-193, so a restarted reader's replay
        # dedup lines up with fresh ops)
        self._offset = 0
        self._base = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def resume_from(self, offset: Offset) -> None:
        """Continue numbering after a restart (before any send)."""
        with self._cond:
            if not self._log and offset > self._offset:
                self._offset = offset
                self._base = offset

    def sender(self) -> "InMemorySender":
        return InMemorySender(self)

    def receiver(self, start_offset: Offset = 0) -> "InMemoryReceiver":
        return InMemoryReceiver(self, start_offset)


class InMemorySender(OperationSender):
    def __init__(self, transport: InMemoryTransport):
        self._t = transport

    def send(self, op: Operation) -> Offset:
        with self._t._cond:
            self._t._log.append(op)
            self._t._offset += 1
            self._t._cond.notify_all()
            return self._t._offset

    @property
    def offset(self) -> Offset:
        with self._t._lock:
            return self._t._offset

    def resume_from(self, offset: Offset) -> None:
        self._t.resume_from(offset)


class InMemoryReceiver(OperationReceiver):
    def __init__(self, transport: InMemoryTransport, start_offset: Offset):
        self._t = transport
        self._cursor = start_offset  # offsets are 1-based; cursor = last seen

    def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[Offset, Operation]]:
        with self._t._cond:
            # ops at or below the base predate this process (already
            # committed by the reader that asked to start there)
            if self._cursor < self._t._base:
                self._cursor = self._t._base
            if self._cursor >= self._t._offset:
                if timeout == 0:
                    return None
                if not self._t._cond.wait_for(
                    lambda: self._cursor < self._t._offset, timeout=timeout
                ):
                    return None
            op = self._t._log[self._cursor - self._t._base]
            self._cursor += 1
            return self._cursor, op


_FRAME = struct.Struct("<QI")  # offset u64, length u32


class FileStreamTransport:
    """Durable framed op stream for multi-process writer→reader."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def sender(self) -> "FileStreamSender":
        return FileStreamSender(self.path, fsync=self.fsync)

    def receiver(self, start_offset: Offset = 0) -> "FileStreamReceiver":
        return FileStreamReceiver(self.path, start_offset)


class FileStreamSender(OperationSender):
    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._offset = 0
        # recover last offset by scanning frames
        if os.path.exists(path):
            for off, _ in _iter_frames(path):
                self._offset = off
        self._fh = open(path, "ab")

    def send(self, op: Operation) -> Offset:
        data = op.to_bytes()
        with self._lock:
            self._offset += 1
            self._fh.write(_FRAME.pack(self._offset, len(data)))
            self._fh.write(data)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            return self._offset

    def send_batch(self, ops: List[Operation]) -> Offset:
        """One flush + (optional) one fsync for the whole batch."""
        if not ops:
            return self.offset
        with self._lock:
            for op in ops:
                data = op.to_bytes()
                self._offset += 1
                self._fh.write(_FRAME.pack(self._offset, len(data)))
                self._fh.write(data)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            return self._offset

    @property
    def offset(self) -> Offset:
        with self._lock:
            return self._offset

    def close(self):
        self._fh.close()


def _iter_frames(path: str, from_offset: Offset = 0):
    with open(path, "rb") as fh:
        while True:
            header = fh.read(_FRAME.size)
            if len(header) < _FRAME.size:
                return
            off, length = _FRAME.unpack(header)
            data = fh.read(length)
            if len(data) < length:
                return  # truncated tail (crash mid-write): ignore
            if off > from_offset:
                yield off, data


class FileStreamReceiver(OperationReceiver):
    """Tails the framed stream with a PERSISTENT handle (the round-1
    implementation reopened + reseeked the file on every recv)."""

    def __init__(self, path: str, start_offset: Offset):
        self.path = path
        self._cursor = start_offset
        self._pos = 0  # byte position AFTER the last consumed frame
        self._fh = None

    def _handle(self):
        if self._fh is None:
            if not os.path.exists(self.path):
                return None
            self._fh = open(self.path, "rb")
            self._fh.seek(self._pos)
        return self._fh

    def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[Offset, Operation]]:
        fh = self._handle()
        if fh is None:
            return None
        while True:
            header = fh.read(_FRAME.size)
            if len(header) < _FRAME.size:
                fh.seek(self._pos)  # partial frame: retry from a clean pos
                return None
            off, length = _FRAME.unpack(header)
            data = fh.read(length)
            if len(data) < length:
                fh.seek(self._pos)
                return None
            self._pos = fh.tell()
            if off <= self._cursor:
                continue
            self._cursor = off
            return off, Operation.from_bytes(data)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# Networked transport: TCP tail of the durable file stream.
#
# Reference analog: RabbitMQ streams (operation/rabbit.rs) — an HA
# producer whose log survives restarts, consumers that start from a
# stored offset, and reconnect with exponential backoff on both sides
# (rabbit.rs:37-90 resend-unconfirmed; read/mod.rs:1219-1249 consumer
# reconnect). Here the WRITER owns the durable framed file (single
# producer — the op log has exactly one writer by design) and serves it
# over TCP: a consumer connects, sends its start offset, and the server
# streams frames from that offset onward, tailing the file for new ops.
# Reconnection is trivially safe: the consumer re-requests from its
# cursor and the read side's offset dedup absorbs any overlap
# (at-least-once delivery).
# ---------------------------------------------------------------------------

_HELLO = struct.Struct("<Q")  # consumer start offset


class TcpLogServer:
    """Serves a FileStream op log to TCP consumers (writer side)."""

    def __init__(self, path: str, host: str = "127.0.0.1", port: int = 0):
        import socket

        self.path = path
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self._stop = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="oplog-tcp-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self):
        import socket

        while not self._stop:
            try:
                self._sock.settimeout(0.5)
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve_client, args=(conn,),
                name="oplog-tcp-client", daemon=True,
            ).start()

    def _serve_client(self, conn):
        import socket
        import time as _time

        try:
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            conn.settimeout(10.0)
            hello = b""
            while len(hello) < _HELLO.size:
                chunk = conn.recv(_HELLO.size - len(hello))
                if not chunk:
                    return
                hello += chunk
            (start_offset,) = _HELLO.unpack(hello)
            conn.settimeout(None)
            rx = FileStreamReceiver(self.path, start_offset)
            while not self._stop:
                item_raw = rx.recv(timeout=0)
                if item_raw is None:
                    _time.sleep(0.02)  # tail: wait for new frames
                    continue
                off, op = item_raw
                data = op.to_bytes()
                conn.sendall(_FRAME.pack(off, len(data)) + data)
        except (OSError, ValueError):
            pass  # consumer gone; it will reconnect and re-request
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass


class TcpOperationReceiver(OperationReceiver):
    """Consumer side: connects to a TcpLogServer, requests frames from
    its cursor, reconnects with exponential backoff on failure."""

    BACKOFF_INITIAL = 0.1
    BACKOFF_MAX = 10.0

    def __init__(self, host: str, port: int, start_offset: Offset = 0):
        self.host = host
        self.port = port
        self._cursor = start_offset
        self._sock = None
        self._buf = b""
        self._backoff = self.BACKOFF_INITIAL

    def _connect(self) -> bool:
        import socket

        try:
            s = socket.create_connection((self.host, self.port), timeout=2.0)
            s.sendall(_HELLO.pack(self._cursor))
            s.settimeout(0.05)
            self._sock = s
            self._buf = b""
            self._backoff = self.BACKOFF_INITIAL
            return True
        except OSError:
            return False

    def _disconnect(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf = b""

    def recv(self, timeout: Optional[float] = None) -> Optional[Tuple[Offset, Operation]]:
        import socket
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            if self._sock is None:
                if not self._connect():
                    # exponential backoff (rabbit.rs reconnect semantics)
                    wait = self._backoff
                    self._backoff = min(self._backoff * 2, self.BACKOFF_MAX)
                    if deadline is not None and (
                        timeout == 0 or _time.monotonic() + wait > deadline
                    ):
                        return None
                    _time.sleep(wait)
                    continue
            # parse a whole frame from the buffer if available
            if len(self._buf) >= _FRAME.size:
                off, length = _FRAME.unpack(self._buf[: _FRAME.size])
                if len(self._buf) >= _FRAME.size + length:
                    data = self._buf[_FRAME.size:_FRAME.size + length]
                    self._buf = self._buf[_FRAME.size + length:]
                    if off <= self._cursor:
                        continue  # overlap after reconnect: dedup
                    self._cursor = off
                    return off, Operation.from_bytes(data)
            try:
                chunk = self._sock.recv(65536)
                if not chunk:  # server closed: reconnect
                    self._disconnect()
                    continue
                self._buf += chunk
            except socket.timeout:
                if deadline is not None and _time.monotonic() >= deadline:
                    return None
                if timeout == 0:
                    return None
            except OSError:
                self._disconnect()

    def close(self):
        self._disconnect()


class _ReadOnlySender(OperationSender):
    def send(self, op: Operation) -> Offset:
        raise RuntimeError(
            "this node consumes a remote op log; it cannot produce ops"
        )

    @property
    def offset(self) -> Offset:
        return 0


def channel_creator(config: Dict[str, Any]):
    """Build (sender, receiver_factory) from config — reference
    operation/mod.rs:232 channel_creator."""
    cfg = config or {}
    kind = cfg.get("type", "in-memory")
    if kind == "in-memory":
        t = InMemoryTransport()
        return t.sender(), t.receiver
    if kind == "file-stream":
        t = FileStreamTransport(cfg["path"], fsync=bool(cfg.get("fsync")))
        return t.sender(), t.receiver
    if kind == "tcp-stream":
        if "path" in cfg:
            # producer node: durable local file + TCP tail server
            t = FileStreamTransport(cfg["path"], fsync=bool(cfg.get("fsync")))
            server = TcpLogServer(
                cfg["path"], cfg.get("host", "127.0.0.1"),
                int(cfg.get("port", 0)),
            )
            sender = t.sender()
            sender.tcp_server = server  # keep it alive / expose the port
            return sender, t.receiver
        # consumer node: remote tail with reconnect/backoff
        def receiver_factory(start_offset: Offset = 0):
            return TcpOperationReceiver(
                cfg.get("host", "127.0.0.1"), int(cfg["port"]), start_offset
            )

        return _ReadOnlySender(), receiver_factory
    raise ValueError(f"unknown op-log transport: {kind}")
