"""Instrumented locks: name+reason on every acquisition.

Reference: src/lock.rs (OramaAsyncLock :21, OramaAsyncMutex :130,
OramaSyncLock :188) — the debugging substrate for contention/deadlocks:
each acquisition carries a static name and a reason string; slow
acquisitions are logged with both.

The port's copy of `oramacore_tpu/utils/locks.py`, with the same names and
behaviour.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager

logger = logging.getLogger("oramacore_tpu.locks")

SLOW_ACQUIRE_S = 1.0
SLOW_HOLD_S = 5.0


class InstrumentedLock:
    """RLock wrapper; acquire with `with lock.acquire("reason"):`."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    @contextmanager
    def acquire(self, reason: str):
        t0 = time.perf_counter()
        self._lock.acquire()
        waited = time.perf_counter() - t0
        if waited > SLOW_ACQUIRE_S:
            logger.warning(
                "lock %r slow acquire (%.2fs) for %r", self.name, waited, reason
            )
        t1 = time.perf_counter()
        try:
            yield
        finally:
            held = time.perf_counter() - t1
            self._lock.release()
            if held > SLOW_HOLD_S:
                logger.warning(
                    "lock %r held %.2fs for %r", self.name, held, reason
                )


class InstrumentedRWLock:
    """Read-write lock with named acquisitions (OramaAsyncLock analog)."""

    def __init__(self, name: str):
        self.name = name
        self._readers = 0
        self._lock = threading.Lock()
        self._no_readers = threading.Condition(self._lock)
        self._writer = threading.Lock()

    @contextmanager
    def read(self, reason: str):
        t0 = time.perf_counter()
        with self._writer:  # writers block new readers
            with self._lock:
                self._readers += 1
        if time.perf_counter() - t0 > SLOW_ACQUIRE_S:
            logger.warning(
                "rwlock %r slow read acquire for %r", self.name, reason
            )
        try:
            yield
        finally:
            with self._lock:
                self._readers -= 1
                if self._readers == 0:
                    self._no_readers.notify_all()

    @contextmanager
    def write(self, reason: str):
        t0 = time.perf_counter()
        self._writer.acquire()
        with self._lock:
            while self._readers > 0:
                self._no_readers.wait()
        if time.perf_counter() - t0 > SLOW_ACQUIRE_S:
            logger.warning(
                "rwlock %r slow write acquire for %r", self.name, reason
            )
        try:
            yield
        finally:
            self._writer.release()
