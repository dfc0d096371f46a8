"""Traffic generator: a traffic file's batches, from a seed.

One general generator reads every traffic mix (`traffic/<name>.json`):

- `kind`: `fulltext` (token lists) or `hybrid` (token lists plus one
  query vector and one similarity threshold a query);
- `batch` queries a batch, top `k`, a closed loop of one client;
- `terms_min`..`terms_max` terms a query, uniform; each query's terms are
  distinct and drawn in proportion to their document frequency in the
  corpus (`draws` candidates a query, the first distinct ones kept), so
  popular terms recur within a batch as in real query sets;
- `similarity`: the hybrid's vector threshold, the same for every query;
- `pool_batches` distinct batches are drawn in set-up; a window that
  outlasts them starts the pool again;
- `warmup_batches` run before the window on batches of their own (drawn
  after the pool); `trace_batches` whole batches make the traced window;
- `check_queries`: how many answered queries of the window the reference
  checks (a sample drawn from the seed, with the query of most terms).

Query vectors come from the configuration's mixture, as the precomputed
query embeddings of a deployment would, L2-normalised in f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .corpus import TextCorpus, VectorCorpus, generator, mixture_rows


@dataclass
class Pool:
    terms: np.ndarray              # int32[P, B, terms_max], -1 padded
    n_terms: np.ndarray            # int32[P, B]
    vectors: Optional[np.ndarray]  # f32[P, B, dim] unit norm, or None
    similarity: Optional[float]

    @property
    def n_batches(self) -> int:
        return self.terms.shape[0]


def draw_terms(df: np.ndarray, n_queries: int, tmin: int, tmax: int,
               draws: int, g: torch.Generator, device):
    """(terms int32[Q, tmax] -1 padded, n int32[Q]): each query's distinct
    terms, drawn with probability proportional to df."""
    w = torch.as_tensor(df, dtype=torch.float64, device=device)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((n_queries, draws), dtype=torch.float64, device=device,
                   generator=g)
    ids = torch.searchsorted(cdf, u).clamp_(max=len(df) - 1)
    want = torch.randint(tmin, tmax + 1, (n_queries, 1), device=device,
                         generator=g)
    srt, order = torch.sort(ids, dim=1, stable=True)
    first_sorted = torch.ones_like(srt, dtype=torch.bool)
    first_sorted[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first = torch.zeros_like(first_sorted).scatter_(1, order, first_sorted)
    rank = torch.cumsum(first.to(torch.int64), dim=1)
    keep = first & (rank <= want)
    slot = torch.where(keep, rank - 1, torch.full_like(rank, tmax))
    out = torch.full((n_queries, tmax + 1), -1, dtype=torch.int64,
                     device=device)
    out.scatter_(1, slot, torch.where(keep, ids, -1))
    return (out[:, :tmax].to(torch.int32).cpu().numpy(),
            keep.sum(dim=1).to(torch.int32).cpu().numpy())


def query_vectors(vec: VectorCorpus, n: int, g: torch.Generator):
    q = mixture_rows(vec.centers, n, vec.sigma, g)
    return (q / torch.linalg.norm(q, dim=1, keepdim=True)).cpu().numpy()


def make_pool(traffic: dict, text: TextCorpus, vec: Optional[VectorCorpus],
              seed: int, device, n_batches: Optional[int] = None) -> Pool:
    """The pool's batches, then the warm-up batches after them."""
    B = int(traffic["batch"])
    P = int(n_batches if n_batches is not None else traffic["pool_batches"])
    P += int(traffic.get("warmup_batches", 0))
    tmin, tmax = int(traffic["terms_min"]), int(traffic["terms_max"])
    g = generator(seed, "traffic", device)
    terms, n = draw_terms(text.df, P * B, tmin, tmax,
                          int(traffic.get("draws", 16)), g, device)
    vectors = sim = None
    if traffic["kind"] == "hybrid":
        if vec is None:
            raise ValueError("a hybrid mix needs a configuration with vectors")
        gv = generator(seed, "query_vectors", device)
        vectors = query_vectors(vec, P * B, gv).reshape(P, B, vec.dim)
        sim = float(traffic["similarity"])
    return Pool(terms=terms.reshape(P, B, tmax), n_terms=n.reshape(P, B),
                vectors=vectors, similarity=sim)


class Batches:
    """The window's batches in order (the pool, then the pool again),
    and the warm-up batches kept after the pool."""

    def __init__(self, pool: Pool, n_pool: int, vocab_strings: List[str]):
        self.pool = pool
        self.n_pool = n_pool
        self.voc = vocab_strings

    def tokens(self, slot: int) -> List[List[str]]:
        voc = self.voc
        terms, n = self.pool.terms[slot], self.pool.n_terms[slot]
        return [[voc[t] for t in row[:k]] for row, k in zip(terms.tolist(),
                                                             n.tolist())]

    def slot_of(self, i: int) -> int:
        """Pool slot of window batch i."""
        return i % self.n_pool

    def warmup_slots(self) -> range:
        return range(self.n_pool, self.pool.n_batches)
