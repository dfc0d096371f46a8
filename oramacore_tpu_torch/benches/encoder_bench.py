"""Inputs of the encoder's checks on the card: the attention kernel's
cases and the ingest corpus of `chip_smoke.py` phase 14.

- `ATTENTION_CASES`: the shapes the encoder gives `encoder_attention`
  with the bundled checkpoints (SemanticBase: H=8, hd=32; SemanticMini:
  H=4, hd=32; at B=1024, the largest `encode` batch phase 14 runs, and at
  the query buckets), BGEBase's geometry (H=12, hd=64, L up to 512, whose
  checkpoint is not in the repository), BGESmall's (H=12, hd=32 at
  L=512, the registry's head width 32 at full length) and the edge
  cases: batch rows whose mask is all zero (a power-of-two batch's
  padding) and L=1.
- `attention_inputs`: seeded f32 qkv and an int32 key mask for a case;
  every row attends a prefix of its keys, of a length drawn in [1, L],
  and the case's last `padded` rows attend nothing.
- `passages`: the phase's corpus, made from a seed: 8-64 words each, drawn
  by a zipf law over the words of a checkpoint's `vocab.txt`, with 5% of
  words out of the vocabulary.
"""

from __future__ import annotations

import numpy as np
import torch

ATTENTION_CASES = {
    "SemanticBase B=1024 L=64": dict(B=1024, L=64, H=8, hd=32, padded=0),
    "SemanticBase B=1024 L=16": dict(B=1024, L=16, H=8, hd=32, padded=0),
    "SemanticMini B=1024 L=64": dict(B=1024, L=64, H=4, hd=32, padded=0),
    "BGEBase B=8 L=128": dict(B=8, L=128, H=12, hd=64, padded=0),
    "BGEBase B=8 L=512": dict(B=8, L=512, H=12, hd=64, padded=0),
    "SemanticBase B=128 L=32, 28 padded rows": dict(B=128, L=32, H=8, hd=32,
                                                    padded=28),
    "SemanticBase B=1 L=16": dict(B=1, L=16, H=8, hd=32, padded=0),
    "SemanticBase B=2 L=1, 1 padded row": dict(B=2, L=1, H=8, hd=32,
                                               padded=1),
    "BGEBase B=4 L=77, 1 padded row": dict(B=4, L=77, H=12, hd=64, padded=1),
    "BGESmall B=8 L=512": dict(B=8, L=512, H=12, hd=32, padded=0),
}


def attention_inputs(case: dict, seed: int, device) -> tuple:
    """(qkv f32[B, L, 3D], mask int32[B, L]) of a case, from a seed."""
    B, L, H, hd = case["B"], case["L"], case["H"], case["hd"]
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, L, 3 * H * hd)).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    lens[0] = L
    if case["padded"]:
        lens[B - case["padded"]:] = 0
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    return (torch.from_numpy(qkv).to(device),
            torch.from_numpy(mask).to(device))


def attention_reference(qkv: torch.Tensor, mask: torch.Tensor,
                        n_heads: int) -> torch.Tensor:
    """The f64 reference of `encoder_attention`: its plain version on qkv
    in f64, except in batch rows whose mask is all zero. There f64 keeps
    the scores apart under the -1e9 (its ulp at 1e9 is 1.2e-7), so its
    softmax still weighs keys by score; the f32 math of JAX and of the
    kernel rounds every score to -1e9 and weighs them equally, so those
    rows get the mean of V, in f64."""
    from ..ops.attention import encoder_attention_plain

    ref = encoder_attention_plain(qkv.double(), mask, n_heads)
    dead = (mask > 0).sum(dim=1) == 0
    if dead.any():
        D = qkv.shape[2] // 3
        ref[dead] = qkv[dead][:, :, 2 * D:].double().mean(
            dim=1, keepdim=True).expand(-1, qkv.shape[1], -1)
    return ref


ZIPF_A = 1.1   # exponent of the words' zipf law, over vocabulary order
OOV = 0.05     # share of made-up words
_OOV_LETTERS = "bcdfghjklmnpqrstvwxz"


def passages(words, n: int, seed: int = 14, n_words=(8, 64)) -> list:
    """n passages of n_words[0] to n_words[1] words (8-64 by default;
    queries take 2-4): in-vocabulary words by a zipf law over
    `words` (rank order is the vocabulary's), and with probability OOV
    a made-up word of 4-9 consonants, which no bundled vocabulary
    holds."""
    rng = np.random.default_rng(seed)
    words = np.asarray(list(words), dtype=object)
    p = 1.0 / np.arange(1, len(words) + 1) ** ZIPF_A
    lens = rng.integers(n_words[0], n_words[1] + 1, n)
    total = int(lens.sum())
    picks = words[rng.choice(len(words), total, p=p / p.sum())]
    made = np.nonzero(rng.random(total) < OOV)[0]
    letters = np.asarray(list(_OOV_LETTERS))[
        rng.integers(0, len(_OOV_LETTERS), (len(made), 9))]
    sizes = rng.integers(4, 10, len(made))
    for i, row, k in zip(made, letters, sizes):
        picks[i] = "".join(row[:k])
    ends = np.cumsum(lens)
    return [" ".join(picks[e - k:e]) for e, k in zip(ends, lens)]


def vocab_words(vocab_path: str) -> list:
    """The whole words of a vocab.txt: no special token, no `##` piece."""
    with open(vocab_path, encoding="utf-8") as f:
        toks = [line.rstrip("\n") for line in f]
    return [t for t in toks if t and not t.startswith("[")
            and not t.startswith("##")]
