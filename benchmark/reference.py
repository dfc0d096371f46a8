"""Plain reference: exact BM25F, exact flat cosine and min-max fusion over
every document, in float64 PyTorch, from the raw corpus the generator made.

It imports nothing of the system under test and takes nothing the system
made: it counts term frequencies and field lengths from the token table,
normalises the raw vectors and rounds them to bf16 itself.

The arithmetic is the documented semantics of the system (OramaCore's
bm25.rs and token_score.rs, one field, weight 1):

    idf(t)   = ln(1 + (N - df_t + 0.5) / (df_t + 0.5))
    ntf      = tf / ((1 - b) + b * flen / avg_flen)       k1 = 1.2, b = 0.75
    score(d) = sum over the query's terms of idf(t) (k1 + 1) ntf / (k1 + ntf)

A document matches when it holds one of the query's terms. The vector
side: each row is L2-normalised in float32 as the index does on insert
(x / max(||x||, 1e-12), numpy's norm along the row), rounded to bf16 as
the flat tier stores it; the query is rounded to bf16 as the flat tier
rounds it. A document's vector score is its cosine where that reaches the
query's threshold, else 0. Fusion (token_score.rs:357-422): both score
sets share one span, the larger of the two maxima (min folded from 0), and
a document's fused score is (bm25 + vector) / span; it matches where
either side does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

K1 = 1.2
B_FIELD = 0.75
NORM_BLOCK = 65536


def normalize_rows_f32(rows: np.ndarray) -> np.ndarray:
    """Each row over max(its norm, 1e-12), in float32, block by block."""
    out = np.empty_like(rows, dtype=np.float32)
    for s in range(0, len(rows), NORM_BLOCK):
        blk = np.asarray(rows[s:s + NORM_BLOCK], np.float32)
        n = np.linalg.norm(blk, axis=-1, keepdims=True)
        out[s:s + NORM_BLOCK] = blk / np.maximum(n, 1e-12)
    return out


class Reference:
    """The reference over one corpus: postings counted from the token
    table, and the bf16 rows where the corpus has vectors."""

    def __init__(self, n_docs: int, vocab: int, n_tokens: np.ndarray,
                 tokens: np.ndarray, rows: Optional[np.ndarray], device):
        dev = torch.device(device)
        self.dev = dev
        self.n = int(n_docs)
        counts = torch.as_tensor(n_tokens, dtype=torch.int64, device=dev)
        doc = torch.repeat_interleave(
            torch.arange(self.n, device=dev, dtype=torch.int64), counts)
        term = torch.as_tensor(tokens, device=dev).to(torch.int64)
        pairs, tf = torch.unique(term * self.n + doc, return_counts=True)
        self.p_term = pairs // self.n
        self.p_doc = pairs % self.n
        self.p_tf = tf.to(torch.float64)
        self.t_start = torch.searchsorted(
            self.p_term, torch.arange(vocab + 1, device=dev)).cpu().numpy()
        self.flen = counts.to(torch.float64)
        self.avg = float(self.flen.sum()) / max(self.n, 1)
        self.rows = None
        if rows is not None:
            self.rows = torch.as_tensor(normalize_rows_f32(rows), device=dev) \
                .to(torch.bfloat16).to(torch.float64)

    def bm25(self, terms: Sequence[int]) -> torch.Tensor:
        """f64[N] scores of one query's terms, 0 where no term matches."""
        s = torch.zeros(self.n, dtype=torch.float64, device=self.dev)
        for t in terms:
            a, b = int(self.t_start[t]), int(self.t_start[t + 1])
            if a == b:
                continue
            d = self.p_doc[a:b]
            ntf = self.p_tf[a:b] / ((1.0 - B_FIELD)
                                    + B_FIELD * self.flen[d] / self.avg)
            df = float(b - a)
            idf = np.log1p((self.n - df + 0.5) / (df + 0.5))
            s.index_add_(0, d, idf * (K1 + 1.0) * ntf / (K1 + ntf))
        return s

    def cosine(self, queries: np.ndarray) -> torch.Tensor:
        """f64[Q, N] cosines of bf16 queries with the bf16 rows."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.dev)
        q = q.to(torch.bfloat16).to(torch.float64)
        return q @ self.rows.T

    def scores(self, terms_list: List[Sequence[int]],
               queries: Optional[np.ndarray] = None,
               similarity: Optional[float] = None):
        """Per query: (lo f64[N], hi f64[N], n_lo, n_hi), -inf where a
        document does not match. For full text lo == hi and n_lo == n_hi.
        For hybrid, a cosine within `sim_slack` of the threshold (or of 0)
        may fall on either side of it in float32, so lo leaves such a
        vector score out, hi keeps it, and the match count lies between
        n_lo and n_hi."""
        out = []
        sims = self.cosine(queries) if queries is not None else None
        for i, terms in enumerate(terms_list):
            ft = self.bm25(terms)
            if sims is None:
                m = ft > 0
                s = torch.where(m, ft, -torch.inf)
                n = int(m.sum())
                out.append((s, s, n, n))
                continue
            c = sims[i]
            slack = sim_slack(self.rows.shape[1])
            keep_lo = (c >= similarity + slack) & (c > slack)
            keep_hi = (c >= similarity - slack) & (c > -slack)
            vc_hi = torch.where(keep_hi, c.clamp(min=0.0), 0.0)
            hi = max(float(ft.max()), float(vc_hi.max()))
            span = hi if hi > 0 else 1.0
            vc_lo = torch.where(keep_lo, c, 0.0)
            m_lo, m_hi = (ft > 0) | keep_lo, (ft > 0) | keep_hi
            out.append((
                torch.where(m_lo | m_hi, (ft + vc_lo) / span, -torch.inf),
                torch.where(m_hi, (ft + vc_hi) / span, -torch.inf),
                int(m_lo.sum()), int(m_hi.sum()),
            ))
        return out


def sim_slack(dim: int) -> float:
    """Bound on |f32 dot - exact dot| of two unit bf16 vectors of `dim`
    terms (products exact in f32; a sum of dim terms in any order loses
    at most dim * 2^-24 of sum |x_i y_i| <= 1.01)."""
    return dim * 2.0 ** -24 * 1.01
