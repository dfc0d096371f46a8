"""Multi-device scale-out: doc-id-sharded search over a device mesh (the
port of `oramacore_tpu/parallel/__init__.py`).

One logical index SHARDS its postings and vectors by doc id across the
devices of a mesh; each shard scores its slice locally and a collective
top-k merge joins them:

    mesh axes: ('q', 'd') - queries data-parallel over 'q',
                            documents sharded over 'd'
    per shard:  BM25F over the local postings shard (the
                `score_ranges_accumulate` kernel), cosine products over
                the local vector shard, local top-k
    collective: psum of each token's df (global IDF), all_gather of the
                per-shard top-k over 'd', final top-k

`parallel/mesh.py` is the mesh itself (a shard a thread, collectives at
a barrier); `parallel/engine.py` installs the mesh under a real
committed index (`ShardedStringExec`, `ShardedBatchExec`), which the
read side builds when `reader_side.sharded_shards` > 1. This module
keeps JAX's standalone step on toy shapes (`make_sharded_search_step`,
`make_toy_sharded_index`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.bm25 import K1, _idf
from ..ops.hybrid import _scatter_max
from ..ops.score_windows import score_ranges_accumulate
from ..ops.vector import _bf16, top_k_by_key
from .mesh import Sharded, ShardMesh, default_devices

__all__ = [
    "GridMesh", "ShardMesh", "Sharded", "ShardedIndexArrays", "build_mesh",
    "default_devices", "make_sharded_search_step", "make_toy_sharded_index",
]


class ShardedIndexArrays(NamedTuple):
    """One logical index laid out as [n_shards, ...] stacked shards.

    Postings within shard s reference LOCAL doc slots [0, cap); the
    global doc id is doc_base[s] + local slot (range partitioning)."""

    p_doc: torch.Tensor       # int32[D, P] local doc slot per posting
    p_tf: torch.Tensor        # f32[D, P]
    p_flen: torch.Tensor      # f32[D, P]
    vec_matrix: torch.Tensor  # bf16[D, N, dim] L2-normalized vector rows
    vec_doc: torch.Tensor     # int32[D, N] local doc slot per row
    vec_valid: torch.Tensor   # bool[D, N]
    doc_base: torch.Tensor    # int32[D] global doc-id base per shard


class GridMesh:
    """A (q, d) grid: n_q rows, each a `ShardMesh` of n_d shards."""

    def __init__(self, devices: Sequence, n_q: int, n_d: int):
        self.shape = {"q": n_q, "d": n_d}
        self.rows = [ShardMesh(devices[i * n_d:(i + 1) * n_d])
                     for i in range(n_q)]


def build_mesh(n_q: int, n_d: int, devices: Optional[Sequence] = None
               ) -> GridMesh:
    devices = list(devices) if devices is not None else default_devices()
    assert len(devices) >= n_q * n_d, (
        f"need {n_q * n_d} devices, have {len(devices)}"
    )
    return GridMesh(devices, n_q, n_d)


def _local_bm25(ax, p_doc, p_tf, p_flen, starts, lens, weights, avg,
                n_docs, *, lr: int, cap: int):
    """(B, cap) BM25 of the shard's postings: windows of lr postings from
    each start (clamped to [0, P - lr], as `lax.dynamic_slice` clamps),
    the first `lens` of them kept, b = 0.75; df psum'd over the mesh."""
    B, T, _NR = starts.shape
    P = p_doc.shape[0]
    st = starts.clamp(0, max(P - lr, 0)).to(torch.int32)
    ln = lens.clamp(0, lr).to(torch.int32)
    fb = torch.full_like(weights, 0.75)
    scores = torch.zeros((B, cap), dtype=torch.float32, device=p_doc.device)
    for t in range(T):
        acc = torch.zeros((B, cap), dtype=torch.float32, device=p_doc.device)
        score_ranges_accumulate(
            p_doc, p_tf, p_tf, p_flen, st[:, t].contiguous(),
            ln[:, t].contiguous(), weights[:, t].contiguous(),
            fb[:, t].contiguous(), avg[:, t].contiguous(), acc,
            exact=False, max_len=lr,
        )
        present = acc > 0.0
        # df is GLOBAL across shards: collective sum over 'd'
        df = ax.psum(present.sum(dim=1, dtype=torch.float32)).clamp(min=1.0)
        sat = _idf(n_docs, df)[:, None] * (K1 + 1.0) * acc / (K1 + acc)
        scores += sat.masked_fill_(~present, 0.0)
    return scores


def make_sharded_search_step(mesh: GridMesh, *, lr: int, cap: int, k: int):
    """The sharded hybrid search step for a fixed shape bucket.

    Inputs (global shapes):
      postings slabs  [D, P]           sharded over 'd'
      vec matrix      [D, N, dim]      sharded over 'd'
      starts/lens/weights/avg  [B, T, NR]  split over 'q'
      queries         [B, dim]         split over 'q'
      n_docs          total corpus size (for IDF)
      alpha           fulltext / vector mix
    Output: (doc_ids int32[B, k], scores f32[B, k]) global top-k."""
    n_q, D = mesh.shape["q"], mesh.shape["d"]

    def shard_fn(ax, p_doc, p_tf, p_flen, vec_matrix, vec_doc, vec_valid,
                 base, starts, lens, weights, avg, queries, n_docs, alpha):
        bm25 = _local_bm25(ax, p_doc, p_tf, p_flen, starts, lens, weights,
                           avg, n_docs, lr=lr, cap=cap)        # (B, cap)
        # vector scores scattered onto the same local doc space
        sims = _bf16(queries) @ vec_matrix.float().T          # (B, N)
        sims = sims.masked_fill(~vec_valid[None, :], 0.0)
        rows = torch.where(vec_valid, vec_doc, cap).long()
        vec_scores = _scatter_max(sims, rows.expand_as(sims), cap)
        combined = alpha * bm25 + (1.0 - alpha) * vec_scores
        local_vals, local_idx = top_k_by_key(combined, k)    # (B, k)
        local_ids = local_idx.to(torch.int32) + base
        # collective top-k merge: gather every shard's candidates
        B = combined.shape[0]
        flat_vals = ax.all_gather(local_vals, axis=1).reshape(B, D * k)
        flat_ids = ax.all_gather(local_ids, axis=1).reshape(B, D * k)
        vals, sel = top_k_by_key(flat_vals, k)
        return flat_ids.gather(1, sel), vals

    def step(p_doc, p_tf, p_flen, vec_matrix, vec_doc, vec_valid, doc_base,
             starts, lens, weights, avg, queries, n_docs, alpha):
        B = starts.shape[0]
        if B % n_q:
            raise ValueError(f"batch {B} does not split over {n_q} rows")
        bq = B // n_q
        ids, vals = [], []
        for r, row in enumerate(mesh.rows):
            q = slice(r * bq, (r + 1) * bq)
            rep = [row.replicate(a[q]) for a in
                   (starts, lens, weights, avg, queries)]
            out = row.run(
                shard_fn,
                *(row.shard(a) for a in (p_doc, p_tf, p_flen, vec_matrix,
                                         vec_doc, vec_valid, doc_base)),
                *rep, float(n_docs), float(alpha),
            )
            ids.append(out[0][0].cpu())
            vals.append(out[0][1].cpu())
        return torch.cat(ids), torch.cat(vals)

    return step


def make_toy_sharded_index(
    n_shards: int, postings_per_shard: int, rows_per_shard: int,
    cap: int, dim: int, seed: int = 0,
) -> ShardedIndexArrays:
    """Tiny synthetic sharded index for dry runs and tests (JAX's, draw
    for draw)."""
    rng = np.random.default_rng(seed)
    D = n_shards
    p_doc = rng.integers(0, cap, (D, postings_per_shard)).astype(np.int32)
    p_tf = rng.integers(1, 4, (D, postings_per_shard)).astype(np.float32)
    p_flen = rng.integers(5, 50, (D, postings_per_shard)).astype(np.float32)
    mat = rng.normal(size=(D, rows_per_shard, dim)).astype(np.float32)
    mat /= np.maximum(np.linalg.norm(mat, axis=-1, keepdims=True), 1e-9)
    vec_doc = rng.integers(0, cap, (D, rows_per_shard)).astype(np.int32)
    vec_valid = np.ones((D, rows_per_shard), bool)
    doc_base = (np.arange(D) * cap).astype(np.int32)
    return ShardedIndexArrays(
        p_doc=torch.from_numpy(p_doc),
        p_tf=torch.from_numpy(p_tf),
        p_flen=torch.from_numpy(p_flen),
        vec_matrix=torch.from_numpy(mat).to(torch.bfloat16),
        vec_doc=torch.from_numpy(vec_doc),
        vec_valid=torch.from_numpy(vec_valid),
        doc_base=torch.from_numpy(doc_base),
    )

