"""Logging subscriber stack — the tracing-subscriber analog.

Reference: bin/oramacore.rs:101-155 builds a compact console layer + an
optional JSON file layer + an optional sentry (error reporting) layer,
with per-module level filters from config (LogConfig lib.rs:47-72,
config.yaml `log.levels`).

Python equivalent: `setup_logging(LogConfig)` installs
- a compact console handler at `console_level`
- an optional JSON-lines file handler (one structured record per line:
  ts/level/logger/message/exception) at `file_level`
- an optional error-reporting handler (sentry analog): ERROR+ records
  append to an error log file and, when a webhook is configured, POST to
  it on a background thread with capped queueing (never blocks the
  caller)
- per-module level filters: {"oramacore_tpu_torch.read": "debug", ...}

The port's copy of `oramacore_tpu/utils/logs.py`, with the same names and
behaviour; `LogConfig` lives in the port's `config.py`.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import traceback
from typing import Optional

from ..config import LogConfig

_LEVELS = {
    "trace": logging.DEBUG,  # python has no TRACE; map down
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def _level(name: str) -> int:
    return _LEVELS.get(str(name).lower(), logging.INFO)


class JsonLinesHandler(logging.Handler):
    """One structured JSON record per line."""

    def __init__(self, path: str, level: int = logging.INFO):
        super().__init__(level)
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", buffering=1)
        self._lock2 = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry = {
                "ts": round(record.created, 3),
                "level": record.levelname.lower(),
                "logger": record.name,
                "message": record.getMessage(),
            }
            if record.exc_info and record.exc_info[0] is not None:
                entry["exception"] = "".join(
                    traceback.format_exception(*record.exc_info)
                )[-4000:]
            with self._lock2:
                self._fh.write(json.dumps(entry) + "\n")
        except Exception:  # noqa: BLE001  (logging must never throw)
            pass

    def close(self):
        try:
            self._fh.close()
        finally:
            super().close()


class ErrorReportHandler(logging.Handler):
    """Sentry-analog error reporting: ERROR+ records go to a dedicated
    error file and optionally to a webhook (async, bounded queue)."""

    def __init__(self, error_file: Optional[str], webhook: Optional[str]):
        super().__init__(logging.ERROR)
        self._file_handler = (
            JsonLinesHandler(error_file, logging.ERROR) if error_file else None
        )
        self._webhook = webhook
        self._q: "queue.Queue" = queue.Queue(maxsize=256)
        self._worker = None
        if webhook:
            self._worker = threading.Thread(
                target=self._pump, name="error-report", daemon=True
            )
            self._worker.start()

    def _pump(self):
        import urllib.request

        while True:
            entry = self._q.get()
            if entry is None:
                return
            try:
                req = urllib.request.Request(
                    self._webhook,
                    data=json.dumps(entry).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                urllib.request.urlopen(req, timeout=5).close()
            except Exception:  # noqa: BLE001
                time.sleep(1.0)  # backoff; drop on persistent failure

    def emit(self, record: logging.LogRecord) -> None:
        if self._file_handler is not None:
            self._file_handler.emit(record)
        if self._webhook:
            try:
                self._q.put_nowait({
                    "level": record.levelname.lower(),
                    "logger": record.name,
                    "message": record.getMessage(),
                    "ts": record.created,
                })
            except queue.Full:
                pass


def setup_logging(cfg: LogConfig) -> None:
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)  # handlers filter
    # console layer (compact)
    console = logging.StreamHandler()
    console.setLevel(_level(cfg.console_level))
    console.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).1s %(name)s %(message)s",
                          datefmt="%H:%M:%S")
    )
    root.addHandler(console)
    # JSON file layer
    if cfg.file_path:
        root.addHandler(JsonLinesHandler(cfg.file_path, _level(cfg.file_level)))
    # error reporting layer
    if cfg.error_file or cfg.error_webhook:
        root.addHandler(ErrorReportHandler(cfg.error_file, cfg.error_webhook))
    # per-module filters
    for module, lvl in (cfg.levels or {}).items():
        logging.getLogger(module).setLevel(_level(lvl))
