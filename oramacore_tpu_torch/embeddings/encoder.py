"""The BERT-family text encoder in PyTorch (counterpart of
oramacore_tpu/embeddings/flax_encoder.py).

`BertEncoder` carries the math of the JAX package's `bert_forward`
(`flax_encoder.py:69-119`): token + position + `type_emb[0]`
embeddings, LayerNorm (biased variance, eps 1e-12), then per layer the
fused Q/K/V projection, the attention (`ops/attention.py`'s
`EncoderAttention`: the hand-written kernels, forward and backward, on
the card, their plain versions on the CPU, where any head width runs; on
the card a head width outside {16, 32, 64, 128} raises, as the kernels'
wrappers do), the output projection
and LayerNorm, a tanh-approximated GELU feed-forward (JAX's default,
where HF BERT uses the exact erf) and LayerNorm; then the mean over the
attended tokens (denominator clamped at 1e-9) and the L2 norm (clamped at
1e-9). The products are f32 `torch.matmul` with TF32 off
(`require_cuda`).

Weights come from the JAX package's parameter dict (`params_from_jax`,
the layout of `_convert_bert_weights`, numpy arrays) or from a
checkpoint's `model.safetensors` by its HF key names
(`state_from_safetensors`; `state_to_hf` is its inverse, for the
trainer's save). Parameters are frozen; `set_trainable` lets a trainer
take their gradients. `TorchTextEncoder(model_path, device)` reads
a checkpoint directory (`config.json`, `vocab.txt`,
`tokenizer_config.json`, `model.safetensors`) and pads each batch to the
JAX encoder's buckets: L to `min(round_up_pow2(L, 16), max_len)`, B to a
power of two, `max_len = min(max_position_embeddings, 512)`.

Backends register under the JAX package's keys (`flax:<model name>`, or
`flax` for every flax-backed model). A checkpoint whose files are missing
leaves the hash backend in place, as in the JAX package; any other
failure (a kernel that does not build or launch, a CUDA error, a bad
file) raises.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.attention import (
    HEAD_DIMS,
    EncoderAttention,
    encoder_attention_plain,
)
from ..ops.bm25 import round_up_pow2
from . import safetensors_io
from .wordpiece import WordPieceTokenizer

logger = logging.getLogger("oramacore_tpu_torch.embeddings.encoder")

LN_EPS = 1e-12
MAX_SEQ = 512
# the checkpoints bundled in the repository, bound by registry name
BUNDLED = (("SemanticBase", "semantic-base"), ("SemanticMini", "semantic-mini"))
MODELS_DIR = Path(__file__).resolve().parents[2] / "models"
# forward layers on CPU tensors whose head width the attention kernel
# does not take (outside HEAD_DIMS), sent to encoder_attention_plain; on
# the card such a width goes to the kernel's wrapper, which raises
PLAIN_WIDTH_CALLS = {"encoder_attention_plain": 0}

# a layer's tensors in the JAX parameter dict, after the fused q/k/v
_LAYER = ("o_w", "o_b", "attn_ln_g", "attn_ln_b", "ffn_w1", "ffn_b1",
          "ffn_w2", "ffn_b2", "ffn_ln_g", "ffn_ln_b")
# HF key (under encoder.layer.<i>.) -> (JAX name, transposed)
_HF_LAYER = {
    "attention.self.query.weight": ("q_w", True),
    "attention.self.query.bias": ("q_b", False),
    "attention.self.key.weight": ("k_w", True),
    "attention.self.key.bias": ("k_b", False),
    "attention.self.value.weight": ("v_w", True),
    "attention.self.value.bias": ("v_b", False),
    "attention.output.dense.weight": ("o_w", True),
    "attention.output.dense.bias": ("o_b", False),
    "attention.output.LayerNorm.weight": ("attn_ln_g", False),
    "attention.output.LayerNorm.bias": ("attn_ln_b", False),
    "intermediate.dense.weight": ("ffn_w1", True),
    "intermediate.dense.bias": ("ffn_b1", False),
    "output.dense.weight": ("ffn_w2", True),
    "output.dense.bias": ("ffn_b2", False),
    "output.LayerNorm.weight": ("ffn_ln_g", False),
    "output.LayerNorm.bias": ("ffn_ln_b", False),
}
_HF_EMB = {
    "embeddings.word_embeddings.weight": "tok_emb",
    "embeddings.position_embeddings.weight": "pos_emb",
    "embeddings.token_type_embeddings.weight": "type_emb",
    "embeddings.LayerNorm.weight": "emb_ln_g",
    "embeddings.LayerNorm.bias": "emb_ln_b",
}


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The port's state (a flat dict of f32 CPU tensors, `BertEncoder`'s
    state_dict names) from the JAX package's parameter dict: the nested
    dict of `_convert_bert_weights`, weights as (in, out), as numpy
    arrays. q/k/v weights and biases are concatenated along the output
    axis for the fused projection."""
    state = {k: _f32(params[k]) for k in
             ("tok_emb", "pos_emb", "type_emb", "emb_ln_g", "emb_ln_b")}
    for i, layer in enumerate(params["layers"]):
        p = f"layers.{i}."
        state[p + "qkv_w"] = torch.cat(
            [_f32(layer[k]) for k in ("q_w", "k_w", "v_w")], dim=1)
        state[p + "qkv_b"] = torch.cat(
            [_f32(layer[k]) for k in ("q_b", "k_b", "v_b")], dim=0)
        for k in _LAYER:
            state[p + k] = _f32(layer[k])
    return state


def state_from_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The port's state from a BERT checkpoint's `model.safetensors`
    (a `BertModel`'s HF key names; `pooler.*` is not read)."""
    raw = safetensors_io.load_numpy(path)
    missing = [k for k in _HF_EMB if k not in raw]
    if missing:
        raise ValueError(f"{path}: no BERT embeddings ({missing})")
    params: Dict = {name: raw[k] for k, name in _HF_EMB.items()}
    params["layers"] = []
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in raw:
        layer = {}
        for k, (name, transposed) in _HF_LAYER.items():
            a = raw[f"encoder.layer.{i}.{k}"]
            layer[name] = a.T if transposed else a
        params["layers"].append(layer)
        i += 1
    if not params["layers"]:
        raise ValueError(f"{path}: no BERT layers")
    return params_from_jax(params)


def state_to_hf(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of `state_from_safetensors`: the port's state as f32
    numpy arrays under a `BertModel`'s HF key names (torch `Linear`
    layout, (out, in)), the fused q/k/v split back into query, key and
    value. No `pooler.*` key: the port has no pooler."""
    def a(t):
        return np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)

    out = {k: a(state[name]) for k, name in _HF_EMB.items()}
    n_layers = len({k.split(".")[1] for k in state if k.startswith("layers.")})
    for i in range(n_layers):
        p = f"layers.{i}."
        layer = {k: state[p + k] for k in _LAYER}
        D = state[p + "qkv_w"].shape[0]
        for j, n in enumerate("qkv"):
            layer[f"{n}_w"] = state[p + "qkv_w"][:, j * D:(j + 1) * D]
            layer[f"{n}_b"] = state[p + "qkv_b"][j * D:(j + 1) * D]
        for k, (name, transposed) in _HF_LAYER.items():
            t = layer[name]
            out[f"encoder.layer.{i}.{k}"] = a(t.T if transposed else t)
    return out


class BertLayer(nn.Module):
    def __init__(self, D: int, F_: int):
        super().__init__()
        shapes = dict(qkv_w=(D, 3 * D), qkv_b=(3 * D,), o_w=(D, D), o_b=(D,),
                      attn_ln_g=(D,), attn_ln_b=(D,), ffn_w1=(D, F_),
                      ffn_b1=(F_,), ffn_w2=(F_, D), ffn_b2=(D,),
                      ffn_ln_g=(D,), ffn_ln_b=(D,))
        for name, shape in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape), requires_grad=False))


class BertEncoder(nn.Module):
    """BERT forward of the JAX package's `bert_forward`; see the module
    doc. `forward(input_ids, attention_mask)` -> f32[B, D] unit rows."""

    def __init__(self, vocab: int, max_pos: int, n_types: int, D: int,
                 F_: int, n_layers: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        # the kernels with their gradient; a check of the card's f32
        # forward against an f64 copy sets the copy's to
        # encoder_attention_plain
        self.attention = EncoderAttention.apply
        for name, shape in dict(tok_emb=(vocab, D), pos_emb=(max_pos, D),
                                type_emb=(n_types, D), emb_ln_g=(D,),
                                emb_ln_b=(D,)).items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape), requires_grad=False))
        self.layers = nn.ModuleList(BertLayer(D, F_) for _ in range(n_layers))

    @classmethod
    def from_state(cls, state: Dict[str, torch.Tensor],
                   n_heads: int) -> "BertEncoder":
        n_layers = len({k.split(".")[1] for k in state
                        if k.startswith("layers.")})
        vocab, D = state["tok_emb"].shape
        F_ = state["layers.0.ffn_w1"].shape[1]
        model = cls(vocab, state["pos_emb"].shape[0],
                    state["type_emb"].shape[0], D, F_, n_layers, n_heads)
        model.load_state_dict(state, strict=True)
        return model.eval()

    def set_trainable(self, on: bool = True) -> "BertEncoder":
        """Every parameter takes (or stops taking) a gradient."""
        for p in self.parameters():
            p.requires_grad_(on)
        return self

    def _ln(self, x, g, b):
        return F.layer_norm(x, (x.shape[-1],), g, b, eps=LN_EPS)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        B, L = input_ids.shape
        x = (self.tok_emb[input_ids] + self.pos_emb[None, :L]
             + self.type_emb[0][None, None, :])
        x = self._ln(x, self.emb_ln_g, self.emb_ln_b)
        mask32 = attention_mask.to(torch.int32).contiguous()
        plain_width = (x.device.type == "cpu"
                       and x.shape[-1] // self.n_heads not in HEAD_DIMS)
        attend = encoder_attention_plain if plain_width else self.attention
        for layer in self.layers:
            qkv = torch.matmul(x, layer.qkv_w) + layer.qkv_b
            if plain_width:
                PLAIN_WIDTH_CALLS["encoder_attention_plain"] += 1
            ctx = attend(qkv, mask32, self.n_heads)
            x = self._ln(x + torch.matmul(ctx, layer.o_w) + layer.o_b,
                         layer.attn_ln_g, layer.attn_ln_b)
            ffn = F.gelu(torch.matmul(x, layer.ffn_w1) + layer.ffn_b1,
                         approximate="tanh")
            x = self._ln(x + torch.matmul(ffn, layer.ffn_w2) + layer.ffn_b2,
                         layer.ffn_ln_g, layer.ffn_ln_b)
        mask = attention_mask[:, :, None].to(x.dtype)
        pooled = (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1),
                                                     min=1e-9)
        return pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-9)


def bucket_shape(B: int, L: int, max_len: int) -> Tuple[int, int]:
    """(Bb, Lb) the JAX encoder pads a tokenized (B, L) batch to."""
    return round_up_pow2(B, 1), min(round_up_pow2(L, 16), max_len)


class TorchTextEncoder:
    """Batched mean-pooled BERT encoder of a checkpoint directory on an
    explicit device (`"cpu"` or `"cuda"`; CUDA runs `require_cuda`)."""

    def __init__(self, model_path: str, device):
        self.device = resolve_device(device)
        with open(os.path.join(model_path, "config.json"),
                  encoding="utf-8") as f:
            cfg = json.load(f)
        self.n_heads = int(cfg["num_attention_heads"])
        self.dim = int(cfg["hidden_size"])
        self.max_len = min(int(cfg["max_position_embeddings"]), MAX_SEQ)
        self.tokenizer = WordPieceTokenizer.from_pretrained(model_path)
        state = state_from_safetensors(
            os.path.join(model_path, "model.safetensors"))
        self.model = BertEncoder.from_state(state, self.n_heads).to(
            self.device)

    def tokenize(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, mask) int64[Bb, Lb]: the batch tokenized (padded to its
        longest with [PAD]) and then to its bucket with id 0 and mask 0,
        as the JAX encoder pads."""
        ids, mask = self.tokenizer(list(texts), self.max_len)
        B, L = ids.shape
        Bb, Lb = bucket_shape(B, L, self.max_len)
        ids_p = np.zeros((Bb, Lb), np.int64)
        mask_p = np.zeros((Bb, Lb), np.int64)
        ids_p[:B, :L] = ids[:, :Lb]
        mask_p[:B, :L] = mask[:, :Lb]
        return ids_p, mask_p

    @torch.inference_mode()
    def forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """f32[Bb, D] unit vectors of a padded batch, on the device."""
        return self.model(torch.from_numpy(ids).to(self.device),
                          torch.from_numpy(mask).to(self.device))

    def encode(self, texts: Sequence[str]) -> List[np.ndarray]:
        if not texts:
            return []
        out = self.forward(*self.tokenize(texts))[:len(texts)].cpu().numpy()
        return list(out)


_ENCODERS: Dict[Tuple[str, str], TorchTextEncoder] = {}


def load_torch_encoder(model_path: str, device) -> Optional[TorchTextEncoder]:
    """Load (and cache per path and device) an encoder; None when the
    checkpoint's files are missing. Every other error raises."""
    key = (os.path.abspath(model_path), str(torch.device(device)))
    enc = _ENCODERS.get(key)
    if enc is None:
        try:
            enc = TorchTextEncoder(model_path, device)
        except FileNotFoundError as e:
            logger.warning("encoder checkpoint missing at %s: %s",
                           model_path, e)
            return None
        _ENCODERS[key] = enc
    return enc


def register_torch_backend(model_path: str, model_name: Optional[str] = None,
                           *, device) -> bool:
    """Register the encoder of a local checkpoint as an embeddings backend:
    for one registry entry with `model_name` (key `flax:<name>`), else
    for every flax-backed model (key `flax`). False (the hash backend
    stays) when the checkpoint's files are missing."""
    enc = load_torch_encoder(model_path, device)
    if enc is None:
        return False
    from . import MODELS, register_backend

    def backend(texts, info):
        return enc.encode(list(texts))

    if model_name is None:
        register_backend("flax", backend)
        return True
    info = MODELS.get(model_name)
    if info is not None and info.dim != enc.dim:
        logger.warning("checkpoint %s has hidden size %s but model %s "
                       "expects %s-d vectors; registering anyway",
                       model_path, enc.dim, model_name, info.dim)
    register_backend(f"flax:{model_name}", backend)
    return True


def register_torch_backend_lazy(model_path: str, model_name: str, *,
                                device) -> None:
    """Bind a registry entry to a local checkpoint without loading it: the
    encoder loads at the first embedding request for that model. A
    request falls back to the hash backend while the checkpoint's files
    are missing; any other load error raises."""
    from . import _hash_backend, register_backend

    def backend(texts, info):
        enc = load_torch_encoder(model_path, device)
        if enc is None:
            return _hash_backend(texts, info)
        return enc.encode(list(texts))

    register_backend(f"flax:{model_name}", backend)


def register_bundled_checkpoints(device) -> List[str]:
    """Bind `SemanticBase` and `SemanticMini` lazily to the checkpoints in
    `models/`, as the JAX package's engine does at boot
    (`runtime.py:129-142`). Returns the names bound."""
    bound = []
    for name, sub in BUNDLED:
        if (MODELS_DIR / sub).is_dir():
            register_torch_backend_lazy(str(MODELS_DIR / sub), name,
                                        device=device)
            bound.append(name)
    return bound
