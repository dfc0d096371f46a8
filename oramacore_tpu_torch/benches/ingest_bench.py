"""The ingest corpus of `chip_smoke.py` phase 15 and the ingest loop
that phase and `tests/test_torch_ingest.py` run.

- `vocabulary`: English-like words from a seed: pronounceable stems,
  each with the suffixes of `SUFFIXES` ("", -s, -es, -ed, -ing, -ation,
  -ness, -ly, -ful), so Porter2 has work on most tokens.
- `documents`: JSON documents shaped like the reference's games bench: a
  `title` of 2-8 words, a `description` of 8-64 words, a `genre` of
  `GENRES`, a float `price` and a string `id`. Words follow a zipf law
  over the vocabulary in a seeded order; about 2% of the documents carry
  one non-ASCII word (accented Latin or a CJK run), so both routes of the
  tokenizer and of the hash encoder run.
- `queries`: 1-4 words, each a stem with one of the suffixes or with
  `QUERY_SUFFIX`, which no document holds, so those words match through
  their stem only ("walkingly" finds "walks").
- `ingest`: documents through `flatten_document`, the index's field-type
  discovery and `build_doc_op` into `StringIndex.index_text_packed`, and
  their embedding text into an `EmbeddingQueue`, in insert batches as
  the write side takes them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..embeddings import DEFAULT_MODEL
from ..utils.flatten import OMC_FIELD, flatten_document, infer_field_type
from ..write.doc_op import build_doc_op, embedding_text

SUFFIXES = ("", "s", "es", "ed", "ing", "ation", "ness", "ly", "ful")
QUERY_SUFFIX = "ingly"
ZIPF_A = 1.0
NON_ASCII = 0.02            # share of documents with a non-ASCII word
NON_ASCII_WORDS = ("café", "naïve", "résumé", "señor", "Ångström", "façade",
                   "crème brûlée", "über", "東京", "北京大学", "日本語の本",
                   "게임")
GENRES = tuple(f"{a} {b}" for a in ("action", "puzzle", "racing", "strategy")
               for b in ("adventure", "arcade", "platformer", "shooter",
                         "simulation", "sports", "survival", "tactics"))
TEXT_FIELDS = ("title", "description")

_ONSETS = ("b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "r",
           "s", "t", "v", "w", "st", "tr", "pl", "gr", "br", "ch", "sh", "th",
           "cl", "fr", "sp")
_VOWELS = ("a", "e", "i", "o", "u", "ai", "ea", "ou", "oo")
_CODAS = ("", "n", "r", "l", "st", "nd", "rk", "mp", "t", "ck", "ll", "ng")


def vocabulary(n_words: int = 50_000, seed: int = 15):
    """(words, stems): `n_words` distinct words, stem x suffix, in a
    seeded order (the zipf rank order), and the stems they come from."""
    rng = np.random.default_rng(seed)
    stems: List[str] = []
    seen_stems, words = set(), {}
    while len(words) < n_words:
        parts = []
        for _ in range(int(rng.integers(1, 3))):
            parts += [_ONSETS[rng.integers(len(_ONSETS))],
                      _VOWELS[rng.integers(len(_VOWELS))],
                      _CODAS[rng.integers(len(_CODAS))]]
        stem = "".join(parts)
        if stem in seen_stems:
            continue
        seen_stems.add(stem)
        stems.append(stem)
        for suf in SUFFIXES:
            words.setdefault(stem + suf, None)
    words = list(words)[:n_words]
    order = rng.permutation(len(words))
    return [words[i] for i in order], stems


def _zipf_picks(rng, n_items: int, total: int) -> np.ndarray:
    cdf = np.cumsum(1.0 / np.arange(1, n_items + 1) ** ZIPF_A)
    return np.minimum(np.searchsorted(cdf, rng.random(total) * cdf[-1]),
                      n_items - 1)


def documents(n: int, seed: int = 15, words: Optional[Sequence[str]] = None
              ) -> List[Dict]:
    """n JSON documents of the games bench's shape (see the module doc)."""
    rng = np.random.default_rng(seed)
    if words is None:
        words = vocabulary(seed=seed)[0]
    words = np.asarray(words, dtype=object)
    n_title = rng.integers(2, 9, n)
    n_desc = rng.integers(8, 65, n)
    lens = np.stack([n_title, n_desc], 1).reshape(-1)
    picks = words[_zipf_picks(rng, len(words), int(lens.sum()))]
    ends = np.cumsum(lens)
    texts = [" ".join(picks[e - k:e]) for e, k in zip(ends, lens)]
    odd = set(np.nonzero(rng.random(n) < NON_ASCII)[0].tolist())
    genre = rng.integers(0, len(GENRES), n)
    price = np.round(rng.uniform(0.0, 80.0, n), 2)
    docs = []
    for d in range(n):
        title, desc = texts[2 * d], texts[2 * d + 1]
        if d in odd:
            w = desc.split(" ")
            w.insert(int(rng.integers(0, len(w) + 1)),
                     NON_ASCII_WORDS[rng.integers(len(NON_ASCII_WORDS))])
            desc = " ".join(w)
        docs.append({"id": f"g{d}", "title": title, "description": desc,
                     "genre": GENRES[genre[d]], "price": float(price[d])})
    return docs


def queries(stems: Sequence[str], n: int, seed: int = 16) -> List[str]:
    """n query strings of 1-4 words: a stem by a zipf law over `stems`
    with a suffix of SUFFIXES, or (one word in eight) QUERY_SUFFIX."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 5, n)
    picks = _zipf_picks(rng, len(stems), int(lens.sum()))
    sufs = SUFFIXES + (QUERY_SUFFIX,)
    p = np.full(len(sufs), 7 / 8 / len(SUFFIXES))
    p[-1] = 1 / 8
    suf = rng.choice(len(sufs), len(picks), p=p)
    qwords = [stems[s] + sufs[k] for s, k in zip(picks, suf)]
    ends = np.cumsum(lens)
    return [" ".join(qwords[e - k:e]) for e, k in zip(ends, lens)]


def discover_fields(field_types: Dict[str, str], flat: Dict) -> None:
    """The write side's automatic field discovery: each new path of a
    flattened document but `id` and `_omc` gets the type of its value."""
    for path, value in flat.items():
        if path not in ("id", OMC_FIELD) and path not in field_types:
            t = infer_field_type(value)
            if t is not None:
                field_types[path] = t


def ingest(docs: Sequence[Dict], parser, index, queue,
           field_types: Dict[str, str], insert_batch: int = 1024, model: str = DEFAULT_MODEL,
           fields: Sequence[str] = TEXT_FIELDS) -> Dict[str, float]:
    """Each document, as the write side and the read side take an insert:
    flatten, discover new fields into `field_types`, build the op body
    (the parser's packed tokens), index `fields` of it into `index` (a
    `StringIndex`) with `index_text_packed`, and submit its embedding text
    to `queue` once per insert batch. Document i gets internal id i.
    Returns the host seconds of building
    the op bodies, of indexing them and of submitting, and the surface
    tokens indexed."""
    t_ops = t_index = t_submit = 0.0
    tokens = 0
    for lo in range(0, len(docs), insert_batch):
        jobs = []
        t0 = time.perf_counter()
        bodies = []
        for d, doc in enumerate(docs[lo:lo + insert_batch], lo):
            flat = flatten_document(doc)
            discover_fields(field_types, flat)
            bodies.append(build_doc_op(field_types, parser, d, str(doc["id"]),
                                       flat, doc))
            text = embedding_text(flat)
            if text:
                jobs.append(("c", "i", d, model, text))
        t1 = time.perf_counter()
        for body in bodies:
            for path in fields:
                n_tok, payload = body["strings_packed"][path]
                index.index_text_packed(body["doc_id"], path, n_tok, payload)
                tokens += n_tok
        t2 = time.perf_counter()
        queue.submit_many(jobs)
        t_ops += t1 - t0
        t_index += t2 - t1
        t_submit += time.perf_counter() - t2
    return dict(ops_s=t_ops, index_s=t_index, submit_s=t_submit,
                tokens=float(tokens))
