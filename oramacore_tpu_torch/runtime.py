"""Runtime bootstrap: builds the writer/reader pair wired by the op log.

Reference: `build_orama` (lib.rs:190) — LLM service, NLP service,
channel pair, WriteSide, ReadSide; graceful shutdown with final commits
(lib.rs:178-185). A process can host the writer, the reader, or both
(reference cargo features writer/reader; config `role`).

The port's copy of `oramacore_tpu/runtime.py`. `build_orama` takes the
device the read side and the text encoders run on: "cuda" unless the
caller asks for "cpu" (as the tests do); "cuda" without a card raises
(`resolve_device`), nothing carries on on the CPU. In place of the JAX
package's device bootstrap and flax registration it binds the bundled
checkpoints through `embeddings.encoder.register_bundled_checkpoints`.
As in the JAX package it builds the JWT manager (`auth.py`), the secrets
service (`utils/secrets.py`) and the sandboxed hooks runtime
(`ai/hooks.py`) and attaches them to both sides.
"""

from __future__ import annotations

from typing import Optional

from . import resolve_device
from .config import OramacoreConfig
from .embeddings import EmbeddingsService
from .oplog import channel_creator
from .read import ReadSide
from .utils.tokenizer import NLPService
from .write import WriteSide


class Orama:
    def __init__(
        self,
        config: OramacoreConfig,
        write_side: Optional[WriteSide],
        read_side: Optional[ReadSide],
    ):
        self.config = config
        self.write_side = write_side
        self.read_side = read_side
        self._stop_event = None
        self._maintenance = None

    def start_maintenance(self):
        """Periodic commit + temp-index GC loops (reference write/mod.rs:
        321-342 commit loop, :1731 temp-index cleanup; read/mod.rs:334)."""
        import threading

        if self._maintenance is not None:
            return
        self._stop_event = threading.Event()

        def loop():
            interval = min(
                self.config.writer_side.commit_interval,
                self.config.reader_side.commit_interval,
            )
            last_commit = 0.0
            last_gc = 0.0
            import time as _t

            while not self._stop_event.wait(timeout=1.0):
                now = _t.time()
                if now - last_commit >= interval:
                    last_commit = now
                    try:
                        if self.write_side:
                            self.write_side.commit()
                        if self.read_side:
                            self.read_side.commit()
                    except Exception:  # noqa: BLE001
                        import traceback

                        traceback.print_exc()
                if self.write_side and now - last_gc >= 3600:
                    last_gc = now
                    try:
                        self.write_side.gc_temp_indexes()
                    except Exception:  # noqa: BLE001
                        pass

        self._maintenance = threading.Thread(
            target=loop, name="maintenance", daemon=True
        )
        self._maintenance.start()

    def stop(self):
        if self._stop_event is not None:
            self._stop_event.set()
        if self._maintenance is not None:
            self._maintenance.join(timeout=5)
            self._maintenance = None
        if self.write_side:
            self.write_side.stop()
        if self.read_side:
            self.read_side.stop()


def build_orama(
    config: OramacoreConfig,
    *,
    device="cuda",
    sync_embeddings: bool = False,
    start_consumer: bool = True,
    llm_resolve_mode=None,
) -> Orama:
    device = resolve_device(device)
    from .embeddings.encoder import (
        register_bundled_checkpoints,
        register_torch_backend,
    )

    embeddings = EmbeddingsService(config.ai.embeddings_model, device=device)
    # bundled in-image trained checkpoints: SemanticBase and SemanticMini
    # bind lazily (any collection can select `embedding_model:
    # SemanticBase` out of the box); explicit config paths bind after
    # them, so a mapped name wins
    register_bundled_checkpoints(device)
    if config.ai.embeddings_model_path:
        register_torch_backend(config.ai.embeddings_model_path,
                               device=device)
    for _name, _path in (config.ai.embeddings_model_paths or {}).items():
        register_torch_backend(_path, model_name=_name, device=device)
    nlp = NLPService()

    jwt_manager = None
    if config.auth.jwt_providers:
        from .auth import JwtManager, JwtProvider

        jwt_manager = JwtManager(
            [
                JwtProvider(
                    issuer=p.issuer, audience=p.audience,
                    hs256_secret=p.hs256_secret, jwks_url=p.jwks_url,
                )
                for p in config.auth.jwt_providers
            ]
        )

    secrets_service = None
    if config.secrets.provider != "none":
        from .utils.secrets import SecretsService, make_provider

        kind = config.secrets.provider
        if kind == "aws":
            provider = make_provider(
                "aws", region=config.secrets.region or "us-east-1"
            )
        elif kind == "http":
            provider = make_provider(
                "http", url=config.secrets.url or "",
                token=config.secrets.token,
            )
        else:
            provider = make_provider("local", path=config.secrets.path)
        secrets_service = SecretsService(
            provider, ttl_s=config.secrets.ttl_s,
            key_pattern=config.secrets.key_pattern,
        )

    role = config.role
    write_side = None
    read_side = None

    if role in ("both", "writer"):
        sender, receiver_factory = channel_creator(config.writer_side.output)
        write_side = WriteSide(
            config, sender, embeddings, nlp, sync_embeddings=sync_embeddings
        )
        if role == "both":
            read_side = ReadSide(
                config, receiver_factory, embeddings, nlp,
                llm_resolve_mode=llm_resolve_mode, device=device,
            )
    if role == "reader":
        _, receiver_factory = channel_creator(config.reader_side.input)
        read_side = ReadSide(
            config, receiver_factory, embeddings, nlp,
            llm_resolve_mode=llm_resolve_mode, device=device,
        )

    # the sandboxed hook runtime needs no LLM — attach it unconditionally
    # (the reference builds its JS pool per collection regardless of AI
    # config, read/collection.rs:180-185)
    from .ai.hooks import HooksRuntime

    hooks_runtime = HooksRuntime(
        execution_timeout_s=config.hooks.execution_timeout_ms / 1000.0,
        allowed_domains=config.hooks.allowed_domains,
        deny_domains=config.hooks.deny_domains,
        allow_js=config.hooks.allow_js,
    )

    for side in (write_side, read_side):
        if side is not None:
            side.jwt_manager = jwt_manager
            side.secrets_service = secrets_service
            side.hooks_runtime = hooks_runtime
    if read_side is not None and start_consumer:
        read_side.start()
    return Orama(config, write_side, read_side)
