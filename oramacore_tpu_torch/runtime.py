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
What the port does not have yet it refuses rather than ignores, each
naming its ROADMAP.md §1 item: JWT providers, a secrets provider, and
hooks settings other than the defaults (the hooks runtime).
"""

from __future__ import annotations

from typing import Optional

from . import resolve_device
from .config import HooksConfig, OramacoreConfig
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


def _refuse_unported(config: OramacoreConfig) -> None:
    """Raise for a configured feature the port cannot serve yet, so that
    no auth provider or hook setting is silently ignored."""
    if config.auth.jwt_providers:
        raise NotImplementedError(
            "auth.jwt_providers: JWT auth is not ported yet (ROADMAP.md "
            "§1, 'JWT and secrets')"
        )
    if config.secrets.provider != "none":
        raise NotImplementedError(
            f"secrets.provider={config.secrets.provider!r}: the secrets "
            "service is not ported yet (ROADMAP.md §1, 'JWT and secrets')"
        )
    if config.hooks != HooksConfig():
        raise NotImplementedError(
            "hooks settings other than the defaults: the hooks runtime "
            "is not ported yet (ROADMAP.md §1, 'the hooks runtime')"
        )


def build_orama(
    config: OramacoreConfig,
    *,
    device="cuda",
    sync_embeddings: bool = False,
    start_consumer: bool = True,
    llm_resolve_mode=None,
) -> Orama:
    _refuse_unported(config)
    device = resolve_device(device)
    from .embeddings.encoder import (
        register_bundled_checkpoints,
        register_torch_backend,
    )

    embeddings = EmbeddingsService(config.ai.embeddings_model)
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

    if read_side is not None and start_consumer:
        read_side.start()
    return Orama(config, write_side, read_side)
