"""The port of `scripts/train_semantic_encoder_tpu.py`: contrastive
training of a 6-layer, 256-wide text encoder through the serving math.

    python -m oramacore_tpu_torch.train.semantic_encoder_tpu \
        [--steps 1200] [--batch 256] [--layers 6] [--dim 256] [--heads 8] \
        [--inter 1024] [--max-len 64] [--lr 6e-4] \
        [--out build/trained/semantic-base-tpu] [--device cuda|cpu]

It runs on the card unless `--device cpu` is given, and refuses an
`--out` under `models/` (`semantic_encoder.check_out_dir`).

The step, the schedule, AdamW and the save are `semantic_encoder`'s
(`SemanticTrainer`, `warmup_cosine_decay`, `save_checkpoint`); this
module holds what the script does otherwise:
- The word lists: the v1 script's `CONCEPTS` and `FILLER`
  (`scripts/train_semantic_encoder.py:31-65`, four forms a concept)
  merged with the script's `CONCEPTS_EXTRA` (`:47-80`), as its
  `all_concepts` (`:83-86`); pairs are drawn over `sorted(merged)`.
- `sample_pair` (`:89-110`): 3-6 concepts, each realized by one of its
  first four forms, with 0-2 fillers inserted (the position drawn before
  the filler).
- The batches (`:284-292`): `np.random.default_rng(0)`, all a-sides then
  all b-sides, tokenized to exactly `SEQ` = 32 tokens, over the vocabulary
  of `build_tokenizer` on the merged concepts (five specials, the sorted
  words, then `FILLER`).
- The init (`init_params`, `:114-152`): Xavier-normal dense weights (std
  `(2 / (fan_in + fan_out)) ** 0.5`), zero biases, normal(0.02) token and
  position embeddings, a zero `type_emb`, unit LayerNorm gains; drawn in
  the script's order from a seeded `torch.Generator`, not `jax.random`
  (the tests start both packages from JAX's `init_params`).
- The loss (`:307-320`): one `BertEncoder` forward of the (2B, L) batch;
  logits = a b^T / 0.05 of its halves, the mean of the two
  cross-entropies, and the pair accuracy.
- The schedule's lengths (`:298-305`): warm-up `min(100, steps // 10)`
  (0 below 10 steps, where optax's schedule starts at the peak), decay
  over `steps`.
- The probes (`:342-359`): raise `TrainingFailed` unless cos(car,
  automobile) > cos(car, doctor) + 0.2 and cos(walk, stroll) > cos(walk,
  rain) + 0.2; after the save, the checkpoint reloaded in
  `TorchTextEncoder` must pass the first again (`:361-374`).
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..embeddings import wordpiece
from ..embeddings.encoder import TorchTextEncoder
from . import semantic_encoder as se

# concept -> surface forms: the v1 script's lists (`CONCEPTS`, :31-64)
CONCEPTS_V1 = {
    "vehicle": ["car", "automobile", "vehicle", "auto"],
    "home": ["house", "home", "residence", "dwelling"],
    "doctor": ["doctor", "physician", "medic", "clinician"],
    "buy": ["buy", "purchase", "acquire", "obtain"],
    "fast": ["fast", "quick", "rapid", "speedy"],
    "big": ["big", "large", "huge", "enormous"],
    "cold": ["cold", "chilly", "freezing", "frosty"],
    "food": ["food", "meal", "cuisine", "dish"],
    "money": ["money", "cash", "currency", "funds"],
    "happy": ["happy", "glad", "joyful", "cheerful"],
    "road": ["road", "street", "avenue", "highway"],
    "child": ["child", "kid", "youngster", "minor"],
    "work": ["work", "job", "occupation", "employment"],
    "smart": ["smart", "clever", "intelligent", "bright"],
    "storm": ["storm", "tempest", "squall", "gale"],
    "boat": ["boat", "ship", "vessel", "craft"],
    "teacher": ["teacher", "instructor", "tutor", "educator"],
    "song": ["song", "tune", "melody", "track"],
    "fight": ["fight", "battle", "combat", "clash"],
    "tired": ["tired", "weary", "exhausted", "fatigued"],
    "book": ["book", "novel", "volume", "tome"],
    "light": ["light", "lamp", "glow", "beam"],
    "water": ["water", "aqua", "liquid", "fluid"],
    "friend": ["friend", "companion", "buddy", "pal"],
    "old": ["old", "ancient", "aged", "antique"],
    "small": ["small", "tiny", "little", "miniature"],
    "strong": ["strong", "sturdy", "powerful", "robust"],
    "wind": ["wind", "breeze", "gust", "draft"],
    "shoe": ["shoe", "sneaker", "boot", "footwear"],
    "phone": ["phone", "handset", "mobile", "cellphone"],
    "garden": ["garden", "yard", "lawn", "plot"],
    "cheap": ["cheap", "inexpensive", "affordable", "budget"],
}
# the script's second concept tier (`CONCEPTS_EXTRA`, :47-80)
CONCEPTS_EXTRA = {
    "angry": ["angry", "furious", "irate", "livid"],
    "begin": ["begin", "start", "commence", "initiate"],
    "end": ["end", "finish", "conclude", "terminate"],
    "sad": ["sad", "unhappy", "sorrowful", "gloomy"],
    "rich": ["rich", "wealthy", "affluent", "prosperous"],
    "poor": ["poor", "broke", "destitute", "impoverished"],
    "beautiful": ["beautiful", "pretty", "gorgeous", "lovely"],
    "ugly": ["ugly", "hideous", "unsightly", "grotesque"],
    "dark": ["dark", "dim", "murky", "shadowy"],
    "loud": ["loud", "noisy", "deafening", "thunderous"],
    "quiet": ["quiet", "silent", "hushed", "muted"],
    "wet": ["wet", "damp", "soaked", "moist"],
    "dry": ["dry", "arid", "parched", "dehydrated"],
    "hot": ["hot", "scorching", "sweltering", "blazing"],
    "danger": ["danger", "peril", "hazard", "threat"],
    "safe": ["safe", "secure", "protected", "sheltered"],
    "walk": ["walk", "stroll", "amble", "saunter"],
    "run": ["run", "sprint", "dash", "jog"],
    "talk": ["talk", "speak", "converse", "chat"],
    "look": ["look", "gaze", "stare", "glance"],
    "eat": ["eat", "consume", "devour", "ingest"],
    "sleep": ["sleep", "slumber", "doze", "nap"],
    "think": ["think", "ponder", "contemplate", "reflect"],
    "make": ["make", "build", "construct", "create"],
    "break": ["break", "shatter", "fracture", "smash"],
    "help": ["help", "assist", "aid", "support"],
    "error": ["error", "mistake", "fault", "blunder"],
    "idea": ["idea", "notion", "concept", "thought"],
    "place": ["place", "location", "spot", "site"],
    "trip": ["trip", "journey", "voyage", "expedition"],
    "rain": ["rain", "drizzle", "downpour", "shower"],
    "hill": ["hill", "mound", "knoll", "rise"],
}
# the v1 script's `FILLER` (:65), the same 96 words as v2's
FILLER = se.FILLER

SEQ = 32   # the script's fixed train-time length (`L`, :282)
PROBES = ["car", "automobile", "doctor", "walk", "stroll", "rain"]
DEFAULT_OUT = se.DEFAULT_OUT.parent / "semantic-base-tpu"


def all_concepts() -> Dict[str, List[str]]:
    """The script's `all_concepts`: v1's concepts, then the extra tier."""
    merged = dict(CONCEPTS_V1)
    merged.update(CONCEPTS_EXTRA)
    return merged


CONCEPTS = all_concepts()


@dataclass(frozen=True)
class TpuTrainConfig(se.TrainConfig):
    """The script's flags and their defaults (`:249-262`); `seq` is its
    fixed L and `max_len` the position table's rows."""
    steps: int = 1200
    batch: int = 256
    seq: int = SEQ
    layers: int = 6
    hidden: int = 256
    heads: int = 8
    ffn: int = 1024
    lr: float = 6e-4
    max_len: int = 64

    @property
    def warmup(self) -> int:
        return min(100, self.steps // 10)

    @property
    def decay_steps(self) -> int:
        return self.steps


def vocab_tokens() -> List[str]:
    """The vocabulary of `build_tokenizer` over the merged concepts."""
    words = sorted({w for g in CONCEPTS.values() for w in g}) + FILLER
    return list(wordpiece.SPECIAL_TOKENS) + words


def sample_pair(rng, concepts, names):
    """Two texts over the SAME concept sequence, independently realized
    (a copy of the script's `sample_pair`)."""
    k = rng.integers(3, 7)
    seq = rng.choice(len(names), size=k, replace=False)

    def realize():
        words = [concepts[names[c]][rng.integers(0, 4)] for c in seq]
        for _ in range(rng.integers(0, 3)):
            words.insert(
                rng.integers(0, len(words) + 1),
                FILLER[rng.integers(0, len(FILLER))],
            )
        return " ".join(words)

    return realize(), realize()


def init_state(cfg: TpuTrainConfig, vocab: int,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Initial weights (`BertEncoder`'s state names, f32 CPU tensors) in
    the scheme and draw order of the script's `init_params`."""
    D, FF = cfg.hidden, cfg.ffn

    def normal(*shape, std):
        return torch.randn(shape, generator=generator) * std

    def dense(fan_in, fan_out):
        return normal(fan_in, fan_out, std=(2.0 / (fan_in + fan_out)) ** 0.5)

    state = {"tok_emb": normal(vocab, D, std=0.02),
             "pos_emb": normal(cfg.max_len, D, std=0.02),
             "type_emb": torch.zeros(2, D), "emb_ln_g": torch.ones(D),
             "emb_ln_b": torch.zeros(D)}
    for i in range(cfg.layers):
        p = f"layers.{i}."
        q, k, v, o = (dense(D, D) for _ in range(4))
        state[p + "qkv_w"] = torch.cat([q, k, v], dim=1)
        state[p + "qkv_b"] = torch.zeros(3 * D)
        state[p + "o_w"] = o
        state[p + "o_b"] = torch.zeros(D)
        state[p + "attn_ln_g"] = torch.ones(D)
        state[p + "attn_ln_b"] = torch.zeros(D)
        state[p + "ffn_w1"] = dense(D, FF)
        state[p + "ffn_b1"] = torch.zeros(FF)
        state[p + "ffn_w2"] = dense(FF, D)
        state[p + "ffn_b2"] = torch.zeros(D)
        state[p + "ffn_ln_g"] = torch.ones(D)
        state[p + "ffn_ln_b"] = torch.zeros(D)
    return state


def probe_cosines(v: np.ndarray) -> Dict[str, float]:
    """The script's probe cosines of the unit vectors of `PROBES`."""
    return {"car~automobile": float(v[0] @ v[1]),
            "car~doctor": float(v[0] @ v[2]),
            "walk~stroll": float(v[3] @ v[4]),
            "walk~rain": float(v[3] @ v[5])}


class TpuScriptTrainer(se.SemanticTrainer):
    """`SemanticTrainer` with the script's word lists, sampler, init,
    single-forward loss and probes."""

    def vocab(self) -> List[str]:
        return vocab_tokens()

    def concept_names(self) -> List[str]:
        return sorted(CONCEPTS)

    def initial_state(self, vocab: int, generator: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
        return init_state(self.cfg, vocab, generator)

    def next_batch(self) -> tuple:
        """(ids, mask) of the next step, int64[2B, SEQ] on the device: the
        B pairs' a-sides, then their b-sides."""
        pairs = [sample_pair(self.rng, CONCEPTS, self.names)
                 for _ in range(self.cfg.batch)]
        return self.tokenize([p[0] for p in pairs] + [p[1] for p in pairs])

    def loss(self, ids, mask) -> tuple:
        emb = self.model(ids, mask)
        B = emb.shape[0] // 2
        return se.info_nce(emb[:B], emb[B:])

    def validate(self) -> Dict[str, float]:
        """The script's probes of both tiers: raise TrainingFailed unless
        each synonym beats its cross-concept word by more than 0.2."""
        cos = probe_cosines(self.embed(PROBES))
        check_probes(cos)
        return cos


def check_probes(cos: Dict[str, float], tiers: Sequence[tuple] = (
        ("car~automobile", "car~doctor"), ("walk~stroll", "walk~rain"))):
    for syn, cross in tiers:
        if not cos[syn] > cos[cross] + 0.2:
            raise se.TrainingFailed(
                f"training failed to separate concepts: {cos}")


def reload_check(out: Path, device) -> Dict[str, float]:
    """The saved checkpoint in `TorchTextEncoder`: its probe cosines,
    raising TrainingFailed unless cos(car, automobile) > cos(car, doctor)
    + 0.2 (the script's round trip)."""
    enc = TorchTextEncoder(str(out), device)
    cos = probe_cosines(np.stack(enc.encode(PROBES)))
    check_probes(cos, (("car~automobile", "car~doctor"),))
    return cos


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    d = TpuTrainConfig()
    for flag, name in (("steps", "steps"), ("batch", "batch"),
                       ("layers", "layers"), ("dim", "hidden"),
                       ("heads", "heads"), ("inter", "ffn"),
                       ("max-len", "max_len")):
        ap.add_argument(f"--{flag}", dest=name, type=int,
                        default=getattr(d, name))
    ap.add_argument("--lr", type=float, default=d.lr)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = se.check_out_dir(args.out)
    cfg = TpuTrainConfig(**{k: getattr(args, k) for k in (
        "steps", "batch", "layers", "hidden", "heads", "ffn", "lr",
        "max_len")})
    t0 = time.perf_counter()
    trainer = TpuScriptTrainer(cfg, args.device)
    n_par = sum(p.numel() for p in trainer.model.parameters())
    print(f"device {trainer.device}; {cfg.layers}L x {cfg.hidden}d x "
          f"{cfg.heads}h ({n_par / 1e6:.2f}M params), B={cfg.batch} pairs "
          f"at L={cfg.seq}", flush=True)
    trainer.run(log_every=50, log=lambda s: print(s, flush=True))
    try:
        cos = trainer.validate()
    except se.TrainingFailed as e:   # as the script's assert: no save
        print(f"{e} ({cfg.steps} steps); nothing saved", file=sys.stderr)
        return 1
    print("  ".join(f"cos({k.replace('~', ', ')})={c:.3f}"
                    for k, c in cos.items()), flush=True)
    trainer.save(out)
    print(f"saved checkpoint to {out}", flush=True)
    cos = reload_check(out, trainer.device)
    print(f"TorchTextEncoder round-trip OK: cos(car, automobile)="
          f"{cos['car~automobile']:.3f} cos(car, doctor)="
          f"{cos['car~doctor']:.3f} ({time.perf_counter() - t0:.1f} s in "
          f"all)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
