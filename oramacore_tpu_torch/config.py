"""Typed configuration of the port: a JSON file or a dict merged with
ORAMACORE_* env vars.

The port's copy of `oramacore_tpu/config.py`: the same dataclasses,
defaults and environment overrides. It reads JSON (`load_config`) or a
dict (`config_from_dict`) in place of YAML, since the port does without
`yaml`; `LogConfig` is the JAX `utils/logs.py` dataclass, copied here.

Reference: `OramacoreConfig` (lib.rs:141-150), `load_config`
(bin/oramacore.rs:17-36; env separator `_`), config.yaml annotated example.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class HttpConfig:
    host: str = "0.0.0.0"
    port: int = 8080
    allow_cors: bool = True
    with_prometheus: bool = True


@dataclass
class WriterSideConfig:
    output: Dict[str, Any] = field(default_factory=lambda: {"type": "in-memory"})
    # commit after this many insert ops (reference insert_batch_commit_size)
    insert_batch_commit_size: int = 5000
    # seconds between periodic commits (reference commit_interval)
    commit_interval: float = 60.0
    javascript_queue_limit: int = 500
    default_embedding_model: str = "builtin-minihash-384"
    embedding_queue_limit: int = 2000


@dataclass
class ReaderSideConfig:
    input: Dict[str, Any] = field(default_factory=lambda: {"type": "in-memory"})
    insert_batch_commit_size: int = 5000
    commit_interval: float = 60.0
    # per-collection commit thresholds (read/mod.rs:100-113)
    operation_threshold: int = 10000
    time_threshold: float = 300.0
    analytics_enabled: bool = True
    notifier_url: Optional[str] = None
    # DEPRECATED and harmful since the v3 doc-sorted slab layout: the
    # cap now keeps an arbitrary lowest-doc-id prefix (recall collapses
    # on capped terms; a loud warning is logged at boot). Use `pruning`
    # below — it bounds device work AND rescores candidates exactly.
    impact_cap: Optional[int] = None
    # pruned two-phase scoring (ops/pruned.py: impact-prefix candidates +
    # exact candidate rescore — no dense doc-space accumulators):
    #   "auto" engage once the corpus exceeds pruned_min_docs;
    #   "on" always (tests); "off" never.
    # Filtered searches (where-filters and tombstone alive-masks) ride
    # the pruned kernels too (single-device): the mask gathers into
    # nomination + rescore with exact filtered-df IDF, and a filter
    # selecting <= PRUNED_CANDIDATES docs becomes the candidate set
    # itself (results AND counts exact).
    # Otherwise match counts on the pruned path are union-probability
    # ESTIMATES (the exact count needs a full aggregation) unless
    # pruned_exact_counts (or per-search "exactCount": true) opts into
    # the exact counting dispatch — one extra device call that sorts the
    # batch's postings (ops/pruned.py pruned_exact_counts).
    pruning: str = "auto"
    pruned_min_docs: int = 2_000_000
    pruned_exact_counts: bool = False
    # doc-id-sharded search over a device mesh: number of shards
    # (devices) to spread each index over. 0/1 = single-device. Requires
    # that many devices; the fused fulltext path dispatches to the
    # shard_map step with collective df + top-k merge (SURVEY §5.8).
    sharded_shards: int = 0


@dataclass
class AIConfig:
    # OpenAI-compatible LLM endpoint (vLLM or remote)
    llm_host: Optional[str] = None
    llm_port: Optional[int] = None
    llm_model: str = "Qwen/Qwen2.5-3B-Instruct"
    llm_api_key: str = ""
    remote_llms: List[Dict[str, Any]] = field(default_factory=list)
    embeddings_model: str = "builtin-minihash-384"
    # local HF-format checkpoint dir for the flax TPU encoder backend
    # (zero-egress environments must have weights on disk already);
    # when set, build_orama registers the 'flax' backend from it
    embeddings_model_path: Optional[str] = None
    # per-model checkpoint dirs: {"BGESmall": "/path", ...} — each binds
    # its registry entry only (reference embeddings/models.py registry);
    # entries here win over the shared embeddings_model_path backend
    embeddings_model_paths: Dict[str, str] = field(default_factory=dict)


@dataclass
class JwtProviderConfig:
    issuer: str = ""
    audience: str = ""
    jwks_url: Optional[str] = None
    hs256_secret: Optional[str] = None


@dataclass
class AuthConfig:
    master_api_key: Optional[str] = None
    jwt_providers: List[JwtProviderConfig] = field(default_factory=list)


@dataclass
class SecretsConfig:
    provider: str = "none"   # none | local | http | aws
    path: Optional[str] = None       # local provider JSON file
    region: Optional[str] = None     # aws provider
    url: Optional[str] = None        # http provider base URL
    token: Optional[str] = None      # http provider bearer token
    key_pattern: str = "{collection}"
    ttl_s: float = 300.0


@dataclass
class HooksConfig:
    allowed_domains: List[str] = field(default_factory=list)
    deny_domains: List[str] = field(default_factory=list)
    evaluation_timeout_ms: int = 2000
    execution_timeout_ms: int = 5000
    # JS hooks run under `node` WITHOUT the seccomp + brokered-fetch
    # sandbox the Python harness gets (no V8 isolate pool in this stack;
    # the reference uses orama-js-pool/Deno). Default-deny: operators
    # must opt in explicitly, accepting the weaker JS isolation.
    allow_js: bool = False


@dataclass
class LogConfig:
    console_level: str = "info"
    # per-module level filters (reference LogConfig lib.rs:47-72)
    levels: Dict[str, str] = field(default_factory=dict)
    # JSON-lines structured log file (reference file layer)
    file_path: Optional[str] = None
    file_level: str = "info"
    # error reporting (sentry analog): local error log + optional webhook
    error_file: Optional[str] = None
    error_webhook: Optional[str] = None


@dataclass
class OramacoreConfig:
    data_dir: str = "./.data"
    http: HttpConfig = field(default_factory=HttpConfig)
    writer_side: WriterSideConfig = field(default_factory=WriterSideConfig)
    reader_side: ReaderSideConfig = field(default_factory=ReaderSideConfig)
    ai: AIConfig = field(default_factory=AIConfig)
    auth: AuthConfig = field(default_factory=AuthConfig)
    hooks: HooksConfig = field(default_factory=HooksConfig)
    secrets: SecretsConfig = field(default_factory=SecretsConfig)
    log: LogConfig = field(default_factory=LogConfig)
    log_levels: Dict[str, str] = field(default_factory=dict)  # legacy alias
    # run roles: both | writer | reader (reference cargo features)
    role: str = "both"


def _apply_env(cfg: Dict[str, Any], prefix: str = "ORAMACORE") -> None:
    """ORAMACORE_SECTION_KEY=value overrides (reference env merge)."""
    for key, value in os.environ.items():
        if not key.startswith(prefix + "_"):
            continue
        parts = key[len(prefix) + 1 :].lower().split("_")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                break
        else:
            node[parts[-1]] = _coerce(value)


def _coerce(v: str) -> Any:
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _build(dc, data: Dict[str, Any]):
    import dataclasses

    kwargs = {}
    for f in dataclasses.fields(dc):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            kwargs[f.name] = _build(f.type, v)
        else:
            kwargs[f.name] = v
    return dc(**kwargs)


_SECTIONS = {
    "http": HttpConfig,
    "writer_side": WriterSideConfig,
    "reader_side": ReaderSideConfig,
    "ai": AIConfig,
    "auth": AuthConfig,
    "hooks": HooksConfig,
    "secrets": SecretsConfig,
}


def load_config(path: Optional[str] = None) -> OramacoreConfig:
    """The config of a JSON file (`path`, else $CONFIG_PATH; none or a
    missing file gives the defaults), with the env overrides."""
    path = path or os.environ.get("CONFIG_PATH")
    raw: Dict[str, Any] = {}
    if path and os.path.exists(path):
        with open(path) as fh:
            raw = json.load(fh) or {}
    return config_from_dict(raw)


def config_from_dict(raw: Optional[Dict[str, Any]]) -> OramacoreConfig:
    """The config of a dict shaped as the YAML / JSON file, with the
    ORAMACORE_* env overrides applied on top (the dict is not changed)."""
    raw = json.loads(json.dumps(raw or {}))
    _apply_env(raw)
    cfg = OramacoreConfig()
    for key, cls in _SECTIONS.items():
        if key in raw and isinstance(raw[key], dict):
            setattr(cfg, key, _build(cls, raw[key]))
    for scalar in ("data_dir", "role"):
        if scalar in raw:
            setattr(cfg, scalar, raw[scalar])
    if "log_levels" in raw:
        cfg.log_levels = dict(raw["log_levels"])
    if "log" in raw and isinstance(raw["log"], dict):
        cfg.log = _build(LogConfig, raw["log"])
    if "auth" in raw and isinstance(raw["auth"], dict):
        provs = raw["auth"].get("jwt_providers") or []
        cfg.auth.jwt_providers = [_build(JwtProviderConfig, p) for p in provs]
    return cfg
