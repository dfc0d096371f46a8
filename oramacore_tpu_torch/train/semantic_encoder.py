"""The port of `scripts/train_semantic_encoder_v2.py`: contrastive
training of the SemanticBase text encoder through the serving math.

    python -m oramacore_tpu_torch.train.semantic_encoder \
        [--steps 1500] [--batch 64] [--seq 16] [--layers 4] [--hidden 256] \
        [--heads 8] [--ffn 1024] [--lr 1e-3] \
        [--out build/trained/semantic-base] [--device cuda|cpu]

It runs on the card unless `--device cpu` is given, and refuses an
`--out` under `models/` (the bundled checkpoints, which
`embeddings/golden_semantic.npz` pins).

What it keeps of the script, which the port does not import:
- `CONCEPTS`, `FILLER` and `sample_pair` (`:42-109`, `:126`) as copies,
  and the batch builder of its `make_batch` closure (`:317-346`, here
  `make_batch`): the same draws from the same `np.random.default_rng`,
  the discarded `sample_pair` of the hard-negative branch, the
  `len(a_texts) + 2 <= batch` test and the final truncation included.
- The vocabulary of `build_tokenizer` (`:112`): the five specials, the
  sorted words of `CONCEPTS`, then `FILLER`; texts tokenized to exactly
  `seq` tokens (`padding="max_length"`, `:311-315`).
- The loss of `loss_fn` (`:283-301`): z = `BertEncoder` (mean-pooled,
  L2-normalized) of both sides, logits = za zb^T / TEMP (a division, as
  JAX divides), the mean of the two cross-entropies, and the pair
  accuracy.
- The optimizer of `:274-280`: AdamW (b1 0.9, b2 0.999, eps 1e-8, weight
  decay 0.01 on every parameter, LayerNorm gains included, as optax's
  `adamw` without a mask) over `warmup_cosine_decay`, which equals
  `optax.warmup_cosine_decay_schedule(0, lr, warmup, steps)`. The rate of
  an update is the schedule at the count of updates before it, so the
  first update has rate 0, as in optax. Here it is `torch.optim.AdamW`
  with its `lr` set before each update.
- The validation probes (`:361-374`), which raise (`TrainingFailed`)
  when cos(car, automobile) <= cos(car, doctor) + 0.2.
- The save (`:185-232`): a checkpoint directory that `TorchTextEncoder`
  and the JAX package's `FlaxTextEncoder` load: `config.json` with the
  keys of `models/semantic-base/config.json`, `model.safetensors` with a
  `BertModel`'s key names (the pooler, which neither encoder reads, as
  zeros), and the tokenizer files.

What differs: the initial weights come from a seeded `torch.Generator` in
the scheme of `init_params` (`:150-183`; normal(0.02) weights and
embeddings, zero biases, unit LayerNorm gains), not from `jax.random`;
the tests start both from JAX's `init_params` instead.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..embeddings import safetensors_io, wordpiece
from ..embeddings.encoder import MODELS_DIR, BertEncoder, state_to_hf

# concept -> surface forms (the script's word lists, `:42-108`). Two texts
# are positives iff they realize the SAME concept sequence through
# independently drawn forms.
CONCEPTS = {
    "vehicle": ["car", "automobile", "vehicle", "auto", "sedan", "motorcar"],
    "home": ["house", "home", "residence", "dwelling", "abode", "household"],
    "doctor": ["doctor", "physician", "medic", "clinician", "practitioner"],
    "buy": ["buy", "purchase", "acquire", "obtain", "procure"],
    "fast": ["fast", "quick", "rapid", "speedy", "swift", "brisk"],
    "big": ["big", "large", "huge", "enormous", "giant", "massive"],
    "cold": ["cold", "chilly", "freezing", "frosty", "icy"],
    "food": ["food", "meal", "cuisine", "dish", "fare"],
    "money": ["money", "cash", "currency", "funds", "capital"],
    "happy": ["happy", "glad", "joyful", "cheerful", "delighted"],
    "road": ["road", "street", "avenue", "highway", "boulevard", "lane"],
    "child": ["child", "kid", "youngster", "minor", "juvenile"],
    "work": ["work", "job", "occupation", "employment", "profession"],
    "smart": ["smart", "clever", "intelligent", "bright", "brainy"],
    "storm": ["storm", "tempest", "squall", "gale", "cyclone"],
    "boat": ["boat", "ship", "vessel", "craft", "ferry"],
    "teacher": ["teacher", "instructor", "tutor", "educator", "lecturer"],
    "song": ["song", "tune", "melody", "track", "ballad", "anthem"],
    "fight": ["fight", "battle", "combat", "clash", "skirmish", "duel"],
    "tired": ["tired", "weary", "exhausted", "fatigued", "drained"],
    "book": ["book", "novel", "volume", "tome", "paperback"],
    "light": ["light", "lamp", "glow", "beam", "lantern"],
    "water": ["water", "aqua", "liquid", "fluid"],
    "friend": ["friend", "companion", "buddy", "pal", "comrade", "ally"],
    "old": ["old", "ancient", "aged", "antique", "elderly", "vintage"],
    "small": ["small", "tiny", "little", "miniature", "petite", "compact"],
    "strong": ["strong", "sturdy", "powerful", "robust", "mighty"],
    "wind": ["wind", "breeze", "gust", "draft", "zephyr"],
    "shoe": ["shoe", "sneaker", "boot", "footwear", "loafer"],
    "phone": ["phone", "handset", "mobile", "cellphone", "smartphone"],
    "garden": ["garden", "yard", "lawn", "plot", "grove"],
    "cheap": ["cheap", "inexpensive", "affordable", "budget", "bargain"],
    # --- v2 additions ---
    "sad": ["sad", "unhappy", "sorrowful", "gloomy", "mournful"],
    "angry": ["angry", "furious", "irate", "enraged", "livid"],
    "start": ["start", "begin", "commence", "initiate", "launch"],
    "stop": ["stop", "halt", "cease", "terminate", "quit"],
    "talk": ["talk", "speak", "converse", "chat", "discuss"],
    "walk": ["walk", "stroll", "hike", "march", "amble"],
    "look": ["look", "glance", "gaze", "stare", "peek"],
    "loud": ["loud", "noisy", "deafening", "thunderous", "booming"],
    "quiet": ["quiet", "silent", "hushed", "muted", "still"],
    "beautiful": ["beautiful", "gorgeous", "stunning", "lovely", "pretty"],
    "ugly": ["ugly", "hideous", "unsightly", "grotesque"],
    "rich": ["rich", "wealthy", "affluent", "prosperous", "opulent"],
    "poor": ["poor", "destitute", "impoverished", "needy", "broke"],
    "hot": ["hot", "scorching", "sweltering", "blazing", "torrid"],
    "wet": ["wet", "damp", "soaked", "moist", "drenched"],
    "dry": ["dry", "arid", "parched", "dehydrated"],
    "danger": ["danger", "hazard", "peril", "threat", "risk"],
    "safe": ["safe", "secure", "protected", "sheltered"],
    "doctor2": ["nurse", "caregiver", "paramedic", "orderly"],
    "law": ["law", "statute", "regulation", "ordinance", "decree"],
    "crime": ["crime", "offense", "felony", "misdeed", "violation"],
    "forest": ["forest", "woods", "woodland", "grove2", "thicket"],
    "mountain": ["mountain", "peak", "summit", "ridge", "alp"],
    "river": ["river", "stream", "creek", "brook", "tributary"],
    "city": ["city", "town", "metropolis", "municipality", "borough"],
    "war": ["war", "conflict", "warfare", "hostilities", "campaign"],
    "peace": ["peace", "truce", "armistice", "harmony", "calm"],
    "animal": ["animal", "creature", "beast", "critter", "fauna"],
    "plant": ["plant", "flora", "vegetation", "shrub", "herb"],
    "sick": ["sick", "ill", "unwell", "ailing", "infirm"],
    "healthy": ["healthy", "fit", "well", "hale", "sound"],
    "funny": ["funny", "hilarious", "amusing", "comical", "witty"],
}
FILLER = [f"filler{i:03d}" for i in range(96)]

# the script seeds default_rng(0) and PRNGKey(0)
SEED = 0
TEMP = 0.05
WEIGHT_DECAY = 0.01
MAX_POS = 64
PROBES = ["car", "automobile", "doctor", "storm", "nurse", "paramedic"]
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "trained" / \
    "semantic-base"


class TrainingFailed(RuntimeError):
    """The validation probes did not separate the concepts."""


@dataclass(frozen=True)
class TrainConfig:
    """The script's flags and their defaults (SemanticBase)."""
    steps: int = 1500
    batch: int = 64
    seq: int = 16
    layers: int = 4
    hidden: int = 256
    heads: int = 8
    ffn: int = 1024
    lr: float = 1e-3

    @property
    def warmup(self) -> int:
        return min(100, max(1, self.steps // 10))

    @property
    def decay_steps(self) -> int:
        return max(self.steps, self.warmup + 1)


def vocab_tokens() -> List[str]:
    """The vocabulary of the script's `build_tokenizer`, in id order."""
    words = sorted({w for g in CONCEPTS.values() for w in g}) + FILLER
    return list(wordpiece.SPECIAL_TOKENS) + words


def sample_pair(rng, names):
    """Two texts realizing the SAME concept sequence through independently
    drawn surface forms (plus filler noise), and the sequence (a copy of
    the script's `sample_pair`, `:126-147`)."""
    k = rng.integers(3, 6)
    seq = rng.choice(len(names), size=k, replace=False)

    def realize(s):
        words = [
            CONCEPTS[names[c]][rng.integers(0, len(CONCEPTS[names[c]]))]
            for c in s
        ]
        for _ in range(rng.integers(0, 2)):
            words.insert(
                rng.integers(0, len(words) + 1),
                FILLER[rng.integers(0, len(FILLER))],
            )
        return " ".join(words)

    return realize(seq), realize(seq), seq


def make_batch(rng, names, batch: int) -> Tuple[List[str], List[str]]:
    """(a_texts, b_texts) of one step: the script's `make_batch` (`:317-
    346`) before tokenization. 3/4 independent pairs and 1/4 hard-negative
    triples: the one-concept-swapped sibling joins both sides as its own
    (self-pair) row."""
    a_texts, b_texts = [], []
    for _ in range(batch):
        ta, tb, seq = sample_pair(rng, names)
        if rng.random() < 0.25 and len(a_texts) + 2 <= batch:
            swapped = seq.copy()
            pos = rng.integers(0, len(swapped))
            choices = [c for c in range(len(names)) if c not in swapped]
            swapped[pos] = choices[rng.integers(0, len(choices))]
            sample_pair(rng, names)   # drawn and discarded, as the script
            tneg = " ".join(
                CONCEPTS[names[c]][rng.integers(0, len(CONCEPTS[names[c]]))]
                for c in swapped
            )
            a_texts += [ta, tneg]
            b_texts += [tb, tneg]
        else:
            a_texts.append(ta)
            b_texts.append(tb)
    return a_texts[:batch], b_texts[:batch]


def warmup_cosine_decay(step: int, peak: float, warmup: int,
                        decay_steps: int) -> float:
    """`optax.warmup_cosine_decay_schedule(0.0, peak, warmup,
    decay_steps)` at `step`, in f32 in optax's order of operations: a
    linear ramp from 0 over `warmup` steps, then peak * 0.5 (1 + cos(pi t
    / T)) with t = min(step - warmup, T), T = decay_steps - warmup (end
    value 0). The cosine is f64's rounded to f32, where XLA's f32 cosine
    is off by an ulp at some arguments."""
    f32 = np.float32
    if step < warmup:
        frac = f32(1) - f32(min(max(step, 0), warmup)) / f32(warmup)
        return float(f32(-peak) * frac + f32(peak))
    T = decay_steps - warmup
    t = f32(min(step - warmup, T))
    arg = f32(np.pi) * t / f32(T)
    cos = f32(0.5) * (f32(1) + f32(np.cos(np.float64(arg))))
    return float(f32(peak) * cos)


def init_state(cfg: TrainConfig, vocab: int,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Initial weights (`BertEncoder`'s state names, f32 CPU tensors) in
    the scheme of the script's `init_params`: embeddings and weights
    normal with std 0.02, biases zero, LayerNorm gains one; drawn in the
    script's order from `generator`."""
    D, FF = cfg.hidden, cfg.ffn

    def norm(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    state = {"tok_emb": norm(vocab, D), "pos_emb": norm(MAX_POS, D),
             "type_emb": norm(2, D), "emb_ln_g": torch.ones(D),
             "emb_ln_b": torch.zeros(D)}
    for i in range(cfg.layers):
        p = f"layers.{i}."
        q, k, v = norm(D, D), norm(D, D), norm(D, D)
        state[p + "qkv_w"] = torch.cat([q, k, v], dim=1)
        state[p + "qkv_b"] = torch.zeros(3 * D)
        state[p + "o_w"] = norm(D, D)
        state[p + "o_b"] = torch.zeros(D)
        state[p + "attn_ln_g"] = torch.ones(D)
        state[p + "attn_ln_b"] = torch.zeros(D)
        state[p + "ffn_w1"] = norm(D, FF)
        state[p + "ffn_b1"] = torch.zeros(FF)
        state[p + "ffn_w2"] = norm(FF, D)
        state[p + "ffn_b2"] = torch.zeros(D)
        state[p + "ffn_ln_g"] = torch.ones(D)
        state[p + "ffn_ln_b"] = torch.zeros(D)
    return state


def info_nce(za: torch.Tensor, zb: torch.Tensor) -> tuple:
    """(loss, pair accuracy) of the script's `loss_fn`: logits = za zb^T
    / TEMP (a 0-d tensor divisor divides, as JAX does), the mean of the
    row and column cross-entropies against the diagonal."""
    logits = (za @ zb.T) / torch.tensor(TEMP, dtype=za.dtype,
                                        device=za.device)
    labels = torch.arange(logits.shape[0], device=za.device)
    loss = (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2
    acc = (logits.argmax(dim=1) == labels).to(za.dtype).mean()
    return loss, acc


class SemanticTrainer:
    """One training run on an explicit device: the batches from
    `np.random.default_rng(SEED)`, the model from `state` (or
    `initial_state` with a generator seeded by `SEED`).

    A trainer of another script's recipe (`semantic_encoder_tpu`)
    subclasses it and overrides what differs: `vocab`, `concept_names`,
    `initial_state`, `next_batch`, `loss` and `validate`."""

    def __init__(self, cfg: TrainConfig, device,
                 state: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokens = self.vocab()
        self.tokenizer = wordpiece.WordPieceTokenizer(
            {t: i for i, t in enumerate(self.tokens)})
        self.names = self.concept_names()
        self.rng = np.random.default_rng(SEED)
        if state is None:
            state = self.initial_state(len(self.tokens),
                                       torch.Generator().manual_seed(SEED))
        self.model = BertEncoder.from_state(state, cfg.heads).to(
            self.device).set_trainable(True)
        self.opt = torch.optim.AdamW(
            self.model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=WEIGHT_DECAY)
        self.updates = 0

    def vocab(self) -> List[str]:
        return vocab_tokens()

    def concept_names(self) -> List[str]:
        return list(CONCEPTS)

    def initial_state(self, vocab: int, generator: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
        return init_state(self.cfg, vocab, generator)

    def lr(self) -> float:
        """The rate of the next update (the schedule at the count of
        updates before it)."""
        return warmup_cosine_decay(self.updates, self.cfg.lr,
                                   self.cfg.warmup, self.cfg.decay_steps)

    def tokenize(self, texts: Sequence[str]) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        """(ids, mask) int64[B, seq] on the device, padded to seq."""
        ids, mask = self.tokenizer(list(texts), self.cfg.seq,
                                   padding="max_length")
        return tuple(self._upload(a) for a in (ids, mask))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        # from pinned memory, so the host does not wait for the copy
        return t.pin_memory().to(self.device, non_blocking=True)

    def next_batch(self) -> tuple:
        """(ids_a, m_a, ids_b, m_b) of the next step."""
        a, b = make_batch(self.rng, self.names, self.cfg.batch)
        return self.tokenize(a) + self.tokenize(b)

    def loss(self, ids_a, m_a, ids_b, m_b) -> tuple:
        return info_nce(self.model(ids_a, m_a), self.model(ids_b, m_b))

    def step(self, batch) -> tuple:
        """One update on `batch`: (loss, accuracy) as 0-d device tensors
        (reading them waits for the step)."""
        for group in self.opt.param_groups:
            group["lr"] = self.lr()
        self.opt.zero_grad(set_to_none=True)
        loss, acc = self.loss(*batch)
        loss.backward()
        self.opt.step()
        self.updates += 1
        return loss.detach(), acc.detach()

    def run(self, steps: Optional[int] = None, log_every: int = 100,
            log: Callable[[str], None] = print,
            on_step: Optional[Callable[[], None]] = None) -> List[tuple]:
        """`steps` updates (the config's by default), logging loss and
        pair accuracy every `log_every` steps and at the last, as the
        script logs; returns [(step, loss, acc, seconds)] of the logged
        steps. `on_step` runs after each update (a timer's mark)."""
        steps = self.cfg.steps if steps is None else steps
        logged, t0 = [], time.perf_counter()
        for i in range(steps):
            loss, acc = self.step(self.next_batch())
            if on_step is not None:
                on_step()
            if i % log_every == 0 or i == steps - 1:
                row = (i, float(loss), float(acc), time.perf_counter() - t0)
                logged.append(row)
                log(f"step {row[0]}: loss={row[1]:.4f} pair-acc={row[2]:.3f} "
                    f"({row[3]:.1f}s)")
        return logged

    @torch.inference_mode()
    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Unit vectors of texts tokenized as the training batches are."""
        return self.model(*self.tokenize(texts)).cpu().numpy()

    def validate(self) -> Dict[str, float]:
        """The script's probes: raise TrainingFailed unless
        cos(car, automobile) > cos(car, doctor) + 0.2."""
        v = self.embed(PROBES)
        cos = {"car~automobile": float(v[0] @ v[1]),
               "car~doctor": float(v[0] @ v[2]),
               "nurse~paramedic": float(v[4] @ v[5])}
        if not cos["car~automobile"] > cos["car~doctor"] + 0.2:
            raise TrainingFailed(f"training failed to separate concepts: "
                                 f"{cos}")
        return cos

    def save(self, out_dir) -> Path:
        """The checkpoint directory (see the module doc)."""
        return save_checkpoint(self.model.state_dict(), out_dir,
                               self.cfg.heads, self.tokens)


def config_json(state: Dict[str, torch.Tensor], n_heads: int,
                vocab: int) -> dict:
    """config.json of a checkpoint, with the keys (and the fixed values)
    of `models/semantic-base/config.json`."""
    D = state["tok_emb"].shape[1]
    return {
        "architectures": ["BertModel"],
        "attention_probs_dropout_prob": 0.1,
        "classifier_dropout": None,
        "dtype": "float32",
        "hidden_act": "gelu",
        "hidden_dropout_prob": 0.1,
        "hidden_size": int(D),
        "initializer_range": 0.02,
        "intermediate_size": int(state["layers.0.ffn_w1"].shape[1]),
        "layer_norm_eps": 1e-12,
        "max_position_embeddings": int(state["pos_emb"].shape[0]),
        "model_type": "bert",
        "num_attention_heads": int(n_heads),
        "num_hidden_layers": len({k.split(".")[1] for k in state
                                  if k.startswith("layers.")}),
        "pad_token_id": 0,
        "position_embedding_type": "absolute",
        "transformers_version": "4.57.6",
        "type_vocab_size": int(state["type_emb"].shape[0]),
        "use_cache": True,
        "vocab_size": int(vocab),
    }


def check_out_dir(out_dir) -> Path:
    """The output directory, resolved; ValueError when it is `models/` or
    lies under it."""
    out = Path(out_dir).resolve()
    models = MODELS_DIR.resolve()
    if out == models or models in out.parents:
        raise ValueError(f"refusing to write {out}: it lies under {models}, "
                         f"whose checkpoints golden_semantic.npz pins")
    return out


def save_checkpoint(state: Dict[str, torch.Tensor], out_dir, n_heads: int,
                    tokens: Sequence[str]) -> Path:
    """Write config.json, model.safetensors and the tokenizer files of
    `state` into `out_dir` (refused under `models/`)."""
    out = check_out_dir(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tensors = state_to_hf(state)
    D = state["tok_emb"].shape[1]
    tensors["pooler.dense.weight"] = np.zeros((D, D), np.float32)
    tensors["pooler.dense.bias"] = np.zeros(D, np.float32)
    safetensors_io.save_numpy(str(out / "model.safetensors"), tensors)
    with open(out / "config.json", "w", encoding="utf-8") as f:
        json.dump(config_json(state, n_heads, len(tokens)), f, indent=2)
        f.write("\n")
    wordpiece.save_pretrained(str(out), tokens)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    defaults = TrainConfig()
    for name in ("steps", "batch", "seq", "layers", "hidden", "heads", "ffn"):
        ap.add_argument(f"--{name}", type=int, default=getattr(defaults, name))
    ap.add_argument("--lr", type=float, default=defaults.lr)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = check_out_dir(args.out)
    cfg = TrainConfig(**{k: getattr(args, k) for k in (
        "steps", "batch", "seq", "layers", "hidden", "heads", "ffn",
        "lr")})
    trainer = SemanticTrainer(cfg, args.device)
    n_par = sum(p.numel() for p in trainer.model.parameters())
    print(f"device {trainer.device}; {cfg.layers}L x {cfg.hidden}d x "
          f"{cfg.heads}h ({n_par / 1e6:.2f}M params)", flush=True)
    trainer.run(log=lambda s: print(s, flush=True))
    cos = trainer.validate()
    print("  ".join(f"cos({k.replace('~', ', ')})={c:.3f}"
                    for k, c in cos.items()), flush=True)
    trainer.save(out)
    print(f"saved checkpoint to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
