"""Accelerator overload detection — the LocalGPUManager equivalent.

Reference: src/ai/gpu.rs (:17,:63,:83) — NVML polling gating the answer
flow toward remote LLM providers. Here the accelerator is the card used
as the SEARCH data plane (LLM serving is an external process), so overload
is defined as sustained host/search pressure: a pluggable probe
combining load average and an EWMA of recent search latency.

The port's copy of `oramacore_tpu/ai/accelerator.py`; `has_accelerator`
asks `torch.cuda` where the JAX module asks `jax.devices()`.
"""

from __future__ import annotations

import os
import time
from typing import Optional


class AcceleratorManager:
    def __init__(
        self,
        load_threshold_per_cpu: float = 2.0,
        latency_threshold_ms: float = 2000.0,
    ):
        self.load_threshold_per_cpu = load_threshold_per_cpu
        self.latency_threshold_ms = latency_threshold_ms
        self._lat_ewma_ms = 0.0
        self._last = 0.0

    def has_accelerator(self) -> bool:
        import torch

        return torch.cuda.is_available() and torch.cuda.device_count() > 0

    def record_search_latency(self, ms: float) -> None:
        self._lat_ewma_ms = 0.9 * self._lat_ewma_ms + 0.1 * ms

    def is_overloaded(self) -> bool:
        """True → route LLM calls to remote providers
        (reference gpu.rs:63-118; answer.rs HandleGPUOverload)."""
        now = time.time()
        if now - self._last < 1.0:
            pass  # cheap enough to always compute
        self._last = now
        try:
            load1, _, _ = os.getloadavg()
            ncpu = os.cpu_count() or 1
            if load1 / ncpu > self.load_threshold_per_cpu:
                return True
        except OSError:
            pass
        return self._lat_ewma_ms > self.latency_threshold_ms
