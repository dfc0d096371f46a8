"""oramacore_tpu_torch — the PyTorch / CUDA port of oramacore_tpu.

This package runs the full-text (BM25F), vector and hybrid search paths,
and the text encoder that embeds passages and queries for them
(`embeddings/`), on an NVIDIA Hopper card, and the ingest text pipeline
that feeds them on the host: the text parser (`utils/tokenizer.py`), the
write side's op bodies and embedding queue (`write/`) and three native
C++ libraries (`native/`: tokenizer, hash encoder, live accumulator).

Around them runs the system's own entry point, as in the JAX package:
`runtime.build_orama(config, device="cuda")` wires the write side
(`write.WriteSide`: collections, indexes, documents, pin rules, values,
commit) to the read side (`read.ReadSide`: op apply, filters, facets,
sort, group, pin rules, hydration, `search` and `search_batch`, commit
and snapshots) through the op log (`oplog/`: in-memory, file-stream and
tcp-stream), with `config.py` (YAML through `utils/yaml_subset.py`),
`storage/` (JSON in place of msgpack), `index/filter_fields.py`, JWT
auth (`auth.py`), secrets (`utils/secrets.py`) and the sandboxed hooks
runtime (`ai/hooks.py`). The HTTP server (`server/`: `python -m
oramacore_tpu_torch.server --config <yaml>`) serves it, and `client.py`
and `utils/hurl.py` talk to the server. The AI service (`ai/`: RAG
answers and planned answers over SSE, NLP queries, the OpenAI-compatible
chat, MCP, tools, system prompts and training sets) answers the server's
AI routes through an OpenAI-compatible LLM, reached by its own HTTP
client (`ai/llms.py`).

It mirrors the layout of `oramacore_tpu` (so
`oramacore_tpu_torch/ops/bm25.py` is the counterpart of
`oramacore_tpu/ops/bm25.py`) and is held against that package in the
tests: the same numpy inputs go through the JAX function and its port.

It imports nothing of the JAX package: neither `jax` nor any
`oramacore_tpu` module, even one that does not import jax. What it needs
from such a module it keeps as its own copy (`index/string_index.py` is
the host index).

Every executor takes an explicit `device`. There is no "CUDA if present"
default: a CUDA device on a host without CUDA raises (`require_cuda`), and
`build_orama` runs on "cuda" unless the caller asks for "cpu".
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def require_cuda() -> None:
    """Raise unless a CUDA card is usable, and pin f32 matmuls to full f32.

    The assignment products of the shared path (`ops/bm25.py`) are f32
    matmuls whose results feed exact match counts and scores compared
    at 1e-5; TF32 keeps about three decimal digits, so it is switched
    off here and checked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "oramacore_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("could not disable TF32 matmuls")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("could not pin f32 matmul precision to 'highest'")


def resolve_device(device) -> torch.device:
    """The executors' device argument as a torch.device; a CUDA device
    runs `require_cuda` first, so it never silently lands on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
