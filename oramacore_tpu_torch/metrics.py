"""Prometheus metrics: counters + histograms with labels, text exposition.

Reference: `metrics` facade + PrometheusBuilder (lib.rs:156-166, scraped
at /metrics api/mod.rs:33); label structs and histogram/counter pairs
(src/metrics/). Buckets follow the reference quantile intent.

The port's copy of `oramacore_tpu/metrics.py`, with the same names and
behaviour.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, labels: Dict[str, str] | None = None, by: float = 1.0):
        key = _label_key(labels or {})
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def expose(self) -> List[str]:
        out = [f"# TYPE {self.name} counter"]
        with self._lock:
            if not self._values:
                out.append(f"{self.name} 0")
            for key, v in self._values.items():
                out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str = "", buckets: Sequence[float] = _BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        self._data: Dict[Tuple, List] = {}  # key -> [bucket_counts, sum, count]
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Dict[str, str] | None = None):
        key = _label_key(labels or {})
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                entry = self._data[key] = [[0] * len(self.buckets), 0.0, 0]
            for i, b in enumerate(self.buckets):
                if value <= b:
                    entry[0][i] += 1
            entry[1] += value
            entry[2] += 1

    def expose(self) -> List[str]:
        out = [f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, (counts, total, n) in self._data.items():
                cum = 0
                for b, c in zip(self.buckets, counts):
                    cum += c
                    out.append(
                        f"{self.name}_bucket{_fmt_labels(key, f'le=\"{b}\"')} {cum}"
                    )
                out.append(f"{self.name}_bucket{_fmt_labels(key, 'le=\"+Inf\"')} {n}")
                out.append(f"{self.name}_sum{_fmt_labels(key)} {total}")
                out.append(f"{self.name}_count{_fmt_labels(key)} {n}")
        return out


class Registry:
    def __init__(self):
        self._metrics: List = []

    def counter(self, name: str, help_: str = "") -> Counter:
        c = Counter(name, help_)
        self._metrics.append(c)
        return c

    def histogram(self, name: str, help_: str = "") -> Histogram:
        h = Histogram(name, help_)
        self._metrics.append(h)
        return h

    def expose(self) -> str:
        lines: List[str] = []
        for m in self._metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# metric instances mirroring the reference's set (src/metrics/)
SEARCH_CALCULATION_TIME = REGISTRY.histogram(
    "search_calculation_time_seconds",
    "Search latency (labels: collection/mode/has_filter/has_facet)",
)
DOCUMENTS_INSERTION_TIME = REGISTRY.histogram(
    "documents_insertion_time_seconds", "Document batch insert latency"
)
OPERATION_COUNT = REGISTRY.counter(
    "operation_count", "Ops applied by the read side"
)
COMMIT_TIME = REGISTRY.histogram("commit_time_seconds", "Commit latency")
EMBEDDING_CALCULATION_TIME = REGISTRY.histogram(
    "embedding_calculation_time_seconds", "Embedding batch latency"
)
ANSWER_TIME = REGISTRY.histogram("answer_time_seconds", "Answer flow latency")
HTTP_REQUESTS = REGISTRY.counter("http_requests_total", "HTTP requests")
BATCH_FALLBACKS = REGISTRY.counter(
    "search_batch_fallbacks_total",
    "Batched searches that fell back to per-query execution, by reason",
)
RANGE_TRUNCATIONS = REGISTRY.counter(
    "query_range_truncations_total",
    "Query tokens whose matched posting ranges exceeded the per-token cap "
    "and were truncated (closest-match-first ordering retains the best)",
)
