"""Webhook notifier with retries (reference: read/notify.rs:23 —
e.g. index-replaced notifications).

The port's copy of `oramacore_tpu/read/notify.py`, with the same names and
behaviour.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Any, Dict, Optional

logger = logging.getLogger("oramacore_tpu.notify")


class Notifier:
    def __init__(self, url: Optional[str], max_retries: int = 3,
                 backoff_base_s: float = 0.5):
        self.url = url
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s

    def notify(self, event: str, payload: Dict[str, Any]) -> None:
        """Fire-and-forget with background retries."""
        if not self.url:
            return
        body = json.dumps({"event": event, **payload}).encode()
        threading.Thread(
            target=self._send, args=(body,), daemon=True
        ).start()

    def _send(self, body: bytes) -> None:
        for attempt in range(self.max_retries):
            try:
                req = urllib.request.Request(
                    self.url, data=body,
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=10) as resp:
                    if 200 <= resp.status < 300:
                        return
            except Exception as e:  # noqa: BLE001
                logger.warning("notify attempt %d failed: %s", attempt + 1, e)
            time.sleep(self.backoff_base_s * (2 ** attempt))
        logger.error("notification dropped after %d retries", self.max_retries)
