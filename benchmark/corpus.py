"""Corpus generator: a configuration file's text and vectors, from a seed.

One general generator serves every configuration; what differs lives in
the configuration's JSON file (`configs/<name>.json`):

- `text`: `n_docs` documents of one field. A document's words are
  log-normal (`words_per_doc` mean, `words_sigma` in log space); its
  tokens after stop words are `tokens_per_word` of its words (at least
  one), each drawn with replacement from a Zipf-Mandelbrot vocabulary of
  `vocab` terms, p(rank r) ~ 1 / (r + zipf_q) ** zipf_s. A term's id is
  its rank. Repeats give tf > 1, so a document holds somewhat fewer
  distinct terms than tokens.
- `vectors` (optional): one `dim`-wide vector per document from a
  mixture of `centers` unit-norm centres, each row a centre plus
  N(0, sigma^2) noise per coordinate (the pattern of the repo's 10M-row
  hybrid generator, `mixture_rows`). Rows are raw: the system normalises
  them as it ingests, and the reference does so again on its own.

Everything is drawn on `device` with `torch.Generator`s seeded from the
run's seed and a stream name, in a few large calls, so a seed gives the
same corpus on the same kind of device. The corpus is the raw material
both sides get: the token table (doc, term) and the vectors. Nothing
here imports the system under test.

Postings the corpus holds (one per distinct (doc, term)) and each term's
document frequency are counted here too: the traffic draws query terms in
proportion to df, and the roofline counts the postings a batch must read.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# term strings: a fixed-width base-36 code, so the payloads are built by
# array operations and not term by term
_ALPHABET = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyz", np.uint8)
SEP = 0x02  # the index's wire separator between tokens


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of one run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def term_width(vocab: int) -> int:
    return max(1, math.ceil(math.log(max(vocab, 2), 36)))


def term_codes(vocab: int) -> np.ndarray:
    """uint8[vocab, width]: the characters of each term id's string."""
    w = term_width(vocab)
    ids = np.arange(vocab, dtype=np.int64)
    digits = np.empty((vocab, w), np.int64)
    for j in range(w - 1, -1, -1):
        digits[:, j] = ids % 36
        ids //= 36
    return _ALPHABET[digits]


def term_strings(vocab: int) -> list:
    """The term string of every term id, as the index and the queries
    carry it."""
    codes = term_codes(vocab)
    return [bytes(row).decode("ascii") for row in codes]


def zipf_cdf(vocab: int, s: float, q: float, device) -> torch.Tensor:
    r = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = (r + q) ** (-s)
    cdf = torch.cumsum(p, 0)
    return cdf / cdf[-1]


@dataclass
class TextCorpus:
    n_docs: int
    vocab: int
    field: str
    n_tokens: np.ndarray     # int64[n_docs]: tokens after stop words (flen)
    offsets: np.ndarray      # int64[n_docs + 1]: doc d's tokens at [o[d], o[d+1])
    tokens: np.ndarray       # int32[total]: term id of each token, by doc
    df: np.ndarray           # int64[vocab]: documents holding each term
    n_postings: int          # distinct (doc, term) pairs


@dataclass
class VectorCorpus:
    dim: int
    rows: np.ndarray         # f32[n_docs, dim], raw (not normalised)
    centers: torch.Tensor    # f32[centers, dim] on the device, unit norm
    sigma: float


def make_text(cfg: dict, seed: int, device) -> TextCorpus:
    t = cfg["text"]
    n, vocab = int(t["n_docs"]), int(t["vocab"])
    g = generator(seed, "text", device)
    sig = float(t["words_sigma"])
    mu = math.log(float(t["words_per_doc"])) - sig * sig / 2
    words = torch.empty(n, dtype=torch.float64, device=device)
    words.log_normal_(mu, sig, generator=g)
    ntok = torch.clamp(torch.round(words * float(t["tokens_per_word"])), min=1)
    ntok = ntok.to(torch.int64)
    total = int(ntok.sum())
    cdf = zipf_cdf(vocab, float(t["zipf_s"]), float(t["zipf_q"]), device)
    u = torch.rand(total, dtype=torch.float64, device=device, generator=g)
    tokens = torch.searchsorted(cdf, u).clamp_(max=vocab - 1).to(torch.int32)
    doc = torch.repeat_interleave(
        torch.arange(n, device=device, dtype=torch.int64), ntok)
    pairs = torch.unique(doc * vocab + tokens.to(torch.int64))
    df = torch.bincount(pairs % vocab, minlength=vocab)
    offsets = np.zeros(n + 1, np.int64)
    ntok_h = ntok.cpu().numpy()
    np.cumsum(ntok_h, out=offsets[1:])
    return TextCorpus(
        n_docs=n, vocab=vocab, field=str(t.get("field", "body")),
        n_tokens=ntok_h, offsets=offsets, tokens=tokens.cpu().numpy(),
        df=df.cpu().numpy().astype(np.int64), n_postings=int(pairs.numel()),
    )


def payloads(corpus: TextCorpus):
    """Each document's field as the index's packed wire payload (tokens
    joined by \\x02, no variants), yielded in doc order."""
    codes = term_codes(corpus.vocab)
    w = codes.shape[1]
    cells = np.empty((len(corpus.tokens), w + 1), np.uint8)
    cells[:, :w] = codes[corpus.tokens]
    cells[:, w] = SEP
    buf = cells.tobytes()
    step = w + 1
    off = corpus.offsets * step
    for d in range(corpus.n_docs):
        yield buf[off[d]:off[d + 1] - 1].decode("ascii")


def mixture_centers(cfg_vec: dict, seed: int, device) -> torch.Tensor:
    g = generator(seed, "centers", device)
    c = torch.randn((int(cfg_vec["centers"]), int(cfg_vec["dim"])),
                    generator=g, device=device)
    return c / torch.linalg.norm(c, dim=1, keepdim=True)


def mixture_rows(centers: torch.Tensor, n: int, sigma: float,
                 g: torch.Generator) -> torch.Tensor:
    """n raw rows of the mixture: a centre plus N(0, sigma^2) noise."""
    pick = torch.randint(0, centers.shape[0], (n,), generator=g,
                         device=centers.device)
    return centers[pick] + sigma * torch.randn(
        (n, centers.shape[1]), generator=g, device=centers.device)


def make_vectors(cfg: dict, seed: int, device) -> Optional[VectorCorpus]:
    v = cfg.get("vectors")
    if not v:
        return None
    centers = mixture_centers(v, seed, device)
    sigma = float(v["sigma"])
    rows = mixture_rows(centers, int(cfg["text"]["n_docs"]), sigma,
                        generator(seed, "rows", device))
    return VectorCorpus(dim=int(v["dim"]), rows=rows.cpu().numpy(),
                        centers=centers, sigma=sigma)

