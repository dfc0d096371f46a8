"""Per-field vector storage: live host buffer + committed device matrix
(counterpart of oramacore_tpu/index/vector_index.py).

Multi-vector documents map to several matrix rows sharing a doc id; a
doc's score is the max over its rows (and over several query targets).
Flat exact search runs over a bf16 slab on the device (ops/vector.py).
Past IVF_MIN_ROWS committed rows, commit builds the IVF layout: k-means
centroids, rows packed by cluster and quantized to int8 per row, probe
units of `window` rows; a search scans the top-nprobe units and reranks
its candidates against the f32 host rows.

The host parts are the JAX module's numpy code. The device parts are
torch: the Lloyd steps sum bf16-rounded sample rows into f32 with
`index_add_` (the JAX module uses one-hot matmuls, as the TPU has no fast
scatter), so centroids agree with the JAX ones only within f32 rounding.
Every index takes an explicit `device`.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.bm25 import round_up_pow2
from ..ops.vector import (
    _bf16,
    flat_cosine_topk,
    flat_cosine_topk_filtered,
    ivf_int8_topk,
    l2_normalize,
)

IVF_MIN_ROWS = 2_000_000
IVF_NPROBE = 32

_ASSIGN_STEP = 262144  # rows assigned to centroids per device product
_LLOYD_ITERS = 8


@dataclass
class VectorIndexConfig:
    dim: int
    model: str = "builtin-minihash-384"
    score_rescale: Optional[Tuple[float, float]] = None  # e.g. E5 (0.7, 1.0)


def _lloyd_step(sample: torch.Tensor, cen: torch.Tensor, lb: int):
    """One Lloyd iteration over the first (len // lb) * lb sample rows, in
    blocks of lb: bf16 dots pick each row's centroid (first maximum, as
    jnp.argmax), the bf16-rounded rows are summed per centroid in f32, and
    the means are L2-normalized; a centroid with no rows stays."""
    c, dim = cen.shape
    cb = _bf16(cen)
    sums = torch.zeros((c, dim), dtype=torch.float32, device=cen.device)
    cnt = torch.zeros(c, dtype=torch.float32, device=cen.device)
    for i in range(max(len(sample) // lb, 1)):
        rows = _bf16(sample[i * lb:(i + 1) * lb])
        a = torch.argmax(rows @ cb.T, dim=1)
        sums.index_add_(0, a, rows)
        cnt += torch.bincount(a, minlength=c)
    new = torch.where(cnt[:, None] > 0, sums / cnt.clamp(min=1.0)[:, None], cen)
    return new / torch.linalg.norm(new, dim=1, keepdim=True).clamp(min=1e-9)


class VectorIndex:
    _UIDS = itertools.count(1)

    def __init__(self, config: VectorIndexConfig, device):
        # process-unique id: executor device caches key on (uid, _gen)
        self.uid = next(VectorIndex._UIDS)
        self.config = config
        self.device = resolve_device(device)
        self._live_rows: List[np.ndarray] = []
        self._live_docs: List[int] = []
        # committed rows live in a capacity-doubling backing buffer, so
        # commits during a long ingest append in amortized O(live);
        # _committed_matrix / _committed_docs are exact-length views
        self._buf_matrix = np.zeros((0, config.dim), np.float32)
        self._buf_docs = np.zeros(0, np.int32)
        self._n_committed = 0
        # device slab cache, and the host copy of its row -> doc ids
        self._dev: Optional[Tuple] = None
        self._docs_h: Optional[np.ndarray] = None
        self._dev_gen = -1
        self._gen = 0
        self._doc2row_dev = None
        # IVF state (built at commit when large enough)
        self._ivf: Optional[dict] = None

    @classmethod
    def from_jax_state(cls, committed_matrix: np.ndarray,
                       committed_docs: np.ndarray, ivf: Optional[dict],
                       config: VectorIndexConfig, device) -> "VectorIndex":
        """An index holding the committed state of an
        `oramacore_tpu.index.vector_index.VectorIndex` (its
        `_committed_matrix`, `_committed_docs` and `_ivf` numpy arrays):
        it searches exactly the layout the JAX index searches."""
        vidx = cls(config, device)
        vidx._committed_matrix = committed_matrix
        vidx._committed_docs = committed_docs
        if ivf is not None:
            vidx._ivf = {
                key: (int(val) if key == "window" else np.array(val))
                for key, val in ivf.items()
            }
        vidx._gen += 1
        return vidx

    @property
    def _committed_matrix(self) -> np.ndarray:
        return self._buf_matrix[: self._n_committed]

    @_committed_matrix.setter
    def _committed_matrix(self, arr: np.ndarray) -> None:
        self._buf_matrix = np.ascontiguousarray(arr, np.float32)
        self._n_committed = len(self._buf_matrix)

    @property
    def _committed_docs(self) -> np.ndarray:
        return self._buf_docs[: self._n_committed]

    @_committed_docs.setter
    def _committed_docs(self, arr: np.ndarray) -> None:
        self._buf_docs = np.ascontiguousarray(arr, np.int32)

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def insert(self, doc_id: int, vectors: Sequence[np.ndarray]) -> None:
        for v in vectors:
            v = np.asarray(v, np.float32).reshape(-1)
            if v.shape[0] != self.config.dim:
                raise ValueError(
                    f"dim mismatch: got {v.shape[0]}, want {self.config.dim}"
                )
            self._live_rows.append(l2_normalize(v))
            self._live_docs.append(doc_id)
        self._gen += 1

    def delete_doc_live(self, doc_id: int) -> None:
        keep = [i for i, d in enumerate(self._live_docs) if d != doc_id]
        if len(keep) != len(self._live_docs):
            self._live_rows = [self._live_rows[i] for i in keep]
            self._live_docs = [self._live_docs[i] for i in keep]
            self._gen += 1

    def n_rows(self) -> int:
        return len(self._committed_docs) + len(self._live_docs)

    def commit(self, deleted: Optional[set] = None) -> None:
        m = len(self._live_docs)
        n = self._n_committed
        # does any delete actually touch this field's rows?
        drop_c = drop_l = None
        live_docs = np.asarray(self._live_docs, np.int32) if m else None
        if deleted:
            dd = np.fromiter(deleted, np.int32, len(deleted))
            if n:
                drop_c = np.isin(self._buf_docs[:n], dd)
                if not drop_c.any():
                    drop_c = None
            if m:
                drop_l = np.isin(live_docs, dd)
                if not drop_l.any():
                    drop_l = None
        if not m and drop_c is None:
            return  # nothing to fold in: committed state + IVF stand
        if drop_c is not None or drop_l is not None:
            # rebuild without the deleted rows (delete/merge path)
            parts_m = [
                self._buf_matrix[:n][~drop_c] if drop_c is not None
                else self._buf_matrix[:n]
            ]
            parts_d = [
                self._buf_docs[:n][~drop_c] if drop_c is not None
                else self._buf_docs[:n]
            ]
            if m:
                lm = np.stack(self._live_rows)
                if drop_l is not None:
                    lm, live_docs = lm[~drop_l], live_docs[~drop_l]
                parts_m.append(lm)
                parts_d.append(live_docs)
            self._committed_matrix = np.concatenate(parts_m)
            self._committed_docs = np.concatenate(parts_d)
        else:
            # append-only fast path: amortized O(live) per commit
            need = n + m
            if need > len(self._buf_docs):
                cap = max(need, 2 * len(self._buf_docs), 1024)
                nm = np.zeros((cap, self.config.dim), np.float32)
                nm[:n] = self._buf_matrix[:n]
                nd = np.zeros(cap, np.int32)
                nd[:n] = self._buf_docs[:n]
                self._buf_matrix, self._buf_docs = nm, nd
            self._buf_matrix[n:need] = np.stack(self._live_rows)
            self._buf_docs[n:need] = live_docs
            self._n_committed = need
        self._live_rows, self._live_docs = [], []
        self._gen += 1
        self._ivf = None
        if self._n_committed >= IVF_MIN_ROWS:
            self._build_ivf()

    # ------------------------------------------------------------------
    # IVF build (host sampling and packing, device k-means and assignment)
    # ------------------------------------------------------------------

    def _build_ivf(self, n_centroids: Optional[int] = None) -> None:
        """Large-corpus layout: per-row symmetric INT8 quantization + rows
        PACKED by k-means cluster with SUB-BLOCK probe units: a cluster
        larger than the window splits into several units sharing its
        centroid (a window overrunning into the next cluster just scores
        extra valid candidates)."""
        mat = self._committed_matrix
        n = len(mat)
        c = n_centroids or max(64, int(np.sqrt(n)))
        rng = np.random.default_rng(0)
        sample_idx = rng.choice(n, min(n, c * 64), replace=False)
        sample = np.ascontiguousarray(mat[sample_idx])
        centroids = sample[rng.choice(len(sample), c, replace=False)].copy()
        sample_dev = torch.from_numpy(sample).to(self.device)
        cen = torch.from_numpy(centroids).to(self.device)
        lb = min(16384, len(sample))
        for _ in range(_LLOYD_ITERS):
            cen = _lloyd_step(sample_dev, cen, lb)
        centroids = cen.cpu().numpy()
        del sample_dev

        # assign ALL rows (device products, chunked)
        assign = np.empty(n, np.int32)
        cen_b = _bf16(cen)
        for s in range(0, n, _ASSIGN_STEP):
            rows = _bf16(torch.from_numpy(mat[s:s + _ASSIGN_STEP]).to(self.device))
            assign[s:s + _ASSIGN_STEP] = (
                torch.argmax(rows @ cen_b.T, dim=1).cpu().numpy()
            )

        # pack rows by cluster; quantize int8 per row (vectorized host)
        order = np.argsort(assign, kind="stable")
        packed = np.ascontiguousarray(mat[order])
        amax = np.abs(packed).max(axis=1)
        scales = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
        q = np.clip(
            np.round(packed / scales[:, None]), -127, 127
        ).astype(np.int8)
        docs = self._committed_docs[order].astype(np.int32)

        # probe units: cluster sub-blocks of `window` rows sharing the
        # cluster centroid — big clusters get proportionally many probes
        counts = np.bincount(assign, minlength=c)
        starts = np.zeros(c + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        window = int(min(
            2048, round_up_pow2(max(int(2 * max(counts.mean(), 1)), 128), 128)
        ))
        window = min(window, int(round_up_pow2(max(n // 2, 1), 1)))
        window = max(min(window, n), 1)
        unit_starts, unit_cluster = [], []
        for ci in range(c):
            cnt = int(counts[ci])
            st = int(starts[ci])
            for j in range(0, max(cnt, 0), window):
                unit_starts.append(st + j)
                unit_cluster.append(ci)
        self._ivf = {
            "q": q,
            "scales": scales,
            "docs": docs,
            "unit_cen": np.ascontiguousarray(centroids[unit_cluster]),
            "unit_starts": np.asarray(unit_starts, np.int32),
            "window": window,
            # packed row -> original committed row, for the f32 rerank
            "perm": order.astype(np.int64),
        }
        self._gen += 1

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _device_slab(self):
        """(matrix, row_doc, row_valid | scales, centroids, unit starts,
        is_ivf) on the device. Flat: bf16[N_pad, dim] rows (N padded to a
        chunk multiple), int32 docs, bool valid. IVF (no live rows): int8
        rows, int32 docs, f32 scales, f32 unit centroids, int32 starts."""
        if self._dev_gen != self._gen:
            self._dev = None  # free the stale slab before the upload
            if self._ivf is not None and not self._live_rows:
                self._docs_h = self._ivf["docs"]
                self._dev = (
                    self._to_dev(self._ivf["q"]),          # int8[N, D]
                    self._to_dev(self._ivf["docs"]),       # int32[N]
                    self._to_dev(self._ivf["scales"]),     # f32[N]
                    self._to_dev(self._ivf["unit_cen"].astype(np.float32)),
                    self._to_dev(self._ivf["unit_starts"]),
                    True,
                )
            else:
                parts_m = [self._committed_matrix]
                parts_d = [self._committed_docs]
                if self._live_rows:
                    parts_m.append(np.stack(self._live_rows))
                    parts_d.append(np.asarray(self._live_docs, np.int32))
                n = sum(len(d) for d in parts_d)
                chunk = self._chunk_for(n)
                n_pad = max(chunk, round_up_pow2(max(n, 1), chunk))
                # rows are rounded to bf16 on the device, one part at a
                # time, so no f32 copy of the whole slab is made there
                matrix = torch.zeros((n_pad, self.config.dim),
                                     dtype=torch.bfloat16, device=self.device)
                r = 0
                for part in parts_m:
                    for s in range(0, len(part), _ASSIGN_STEP):
                        blk = part[s:s + _ASSIGN_STEP]
                        matrix[r:r + len(blk)] = self._to_dev(blk).to(torch.bfloat16)
                        r += len(blk)
                docs = np.zeros(n_pad, np.int32)
                docs[:n] = np.concatenate(parts_d)
                valid = np.zeros(n_pad, bool)
                valid[:n] = True
                self._docs_h = docs
                self._dev = (
                    matrix, self._to_dev(docs), self._to_dev(valid),
                    None, None, False,
                )
            self._dev_gen = self._gen
        return self._dev

    def flat_device_rows(self):
        """(matrix bf16[N, dim], row_doc i32[N], row_valid bool[N]) device
        tensors for the fused hybrid path, or None in IVF mode."""
        matrix, row_doc, row_valid, _c, _s, is_ivf = self._device_slab()
        if is_ivf:
            return None
        return matrix, row_doc, row_valid

    def int8_device_rows(self):
        """Int8/IVF layout for the fused hybrid path: (mat_i8, scales,
        row_doc, unit_cen, unit_starts, window, nprobe), or None when not
        in IVF mode."""
        mat, row_doc, scales, centroids, starts, is_ivf = self._device_slab()
        if not is_ivf:
            return None
        nprobe = min(IVF_NPROBE, int(centroids.shape[0]))
        return (
            mat, scales, row_doc, centroids, starts,
            int(self._ivf["window"]), nprobe,
        )

    def int8_doc2row(self, cap: int):
        """doc id -> packed int8 row (device int32[cap+1], -1 = no vector)
        for the pruned hybrid's candidate rescore. Multi-vector docs keep
        ONE representative row (last write wins)."""
        if self._ivf is None:
            return None
        key = (self._gen, cap)
        cached = self._doc2row_dev
        if cached is not None and cached[0] == key:
            return cached[1]
        arr = np.full(cap + 1, -1, np.int32)
        docs = self._ivf["docs"]
        sel = docs < cap
        arr[docs[sel]] = np.arange(len(docs), dtype=np.int32)[sel]
        dev = self._to_dev(arr)
        self._doc2row_dev = (key, dev)
        return dev

    @staticmethod
    def _chunk_for(n: int) -> int:
        if n <= 8192:
            return 1024
        if n <= 262144:
            return 16384
        return 65536

    def _topk_rows(self, q: np.ndarray, limit: int,
                   filter_mask: Optional[np.ndarray]):
        """One batched device search over already-normalized query rows
        q f32[B, dim]: returns (vals f32[B, k] — f32-reranked in IVF mode,
        rows i32[B, k], row_doc host array)."""
        matrix, row_doc, row_valid, centroids, starts, is_ivf = (
            self._device_slab()
        )
        n = int(matrix.shape[0])
        k = min(round_up_pow2(max(limit * 4, 16), 16), n)
        q_dev = self._to_dev(q.astype(np.float32))

        if is_ivf:
            # int8 packed path: filters push down by zeroing the per-row
            # scale (scale 0 == invalid row in the scan)
            scales = row_valid  # f32[N] in the int8 layout
            if filter_mask is not None:
                fm = self._to_dev(filter_mask)
                mask_rows = fm[row_doc.clamp(0, len(filter_mask) - 1).long()]
                scales = torch.where(mask_rows, scales, 0.0)
            nprobe = min(IVF_NPROBE, int(centroids.shape[0]))
            vals, rows = ivf_int8_topk(
                q_dev, matrix, scales, centroids, starts,
                k=k, nprobe=nprobe, window=self._ivf["window"],
            )
        else:
            chunk = n if n < 1024 else self._chunk_for(n)
            if n % chunk:
                chunk = n
            if filter_mask is not None:
                vals, rows = flat_cosine_topk_filtered(
                    q_dev, matrix, row_doc, self._to_dev(filter_mask),
                    row_valid, k=k, chunk=chunk,
                )
            else:
                vals, rows = flat_cosine_topk(
                    q_dev, matrix, row_valid, k=k, chunk=chunk
                )

        vals = vals.cpu().numpy()
        rows = rows.cpu().numpy()
        row_doc_h = self._docs_h  # the host copy: no (N,) copy per search

        if is_ivf:
            # f32 RERANK of the candidates: int8 quantization only picks
            # the candidate set (4x over-retrieval); final scores come
            # from the original committed f32 rows
            perm = self._ivf["perm"]
            mat_h = self._committed_matrix
            for bi in range(vals.shape[0]):
                # never resurrect filtered-out / padding slots (NEG_INF)
                valid = (rows[bi] >= 0) & (vals[bi] > -1e29)
                if not valid.any():
                    continue
                orig = perm[rows[bi][valid]]
                exact = mat_h[orig] @ q[bi]
                vals[bi][valid] = exact.astype(np.float32)
        return vals, rows, row_doc_h

    def _absorb_rows(self, out: Dict[int, float], vals_b, rows_b,
                     doc_lookup, similarity: float) -> None:
        rescale = self.config.score_rescale
        for vi in range(len(vals_b)):
            s = float(vals_b[vi])
            r = int(rows_b[vi])
            if r < 0 or s <= -1e29:
                continue
            if rescale is not None:
                lo, hi = rescale
                s = (s - lo) / (hi - lo)
                s = min(max(s, 0.0), 1.0)
            if s < similarity:
                continue
            d = int(doc_lookup[r])
            if s > out.get(d, -1.0):
                out[d] = s

    def search(
        self,
        targets: Sequence[np.ndarray],   # query vectors (multi-chunk query)
        limit: int,
        similarity: float,
        filter_mask: Optional[np.ndarray] = None,  # bool[cap] over doc ids
        cap: Optional[int] = None,
    ) -> Dict[int, float]:
        """doc -> score (max over rows & targets), score >= similarity."""
        if self.n_rows() == 0 or not targets:
            return {}
        q = np.stack([
            l2_normalize(np.asarray(t, np.float32).reshape(-1))
            for t in targets
        ])
        vals, rows, row_doc_h = self._topk_rows(q, limit, filter_mask)
        out: Dict[int, float] = {}
        for bi in range(vals.shape[0]):
            self._absorb_rows(out, vals[bi], rows[bi], row_doc_h, similarity)
        return out

    def search_many(
        self,
        queries: np.ndarray,             # f32[B, dim], one vector per query
        limit: int,
        similarities: Sequence[float],
    ) -> List[Dict[int, float]]:
        """B independent single-vector queries in one device search (the
        batched-search API tier; no per-query filters here)."""
        B = len(queries)
        if self.n_rows() == 0 or B == 0:
            return [{} for _ in range(B)]
        q = l2_normalize(np.asarray(queries, np.float32))
        vals, rows, row_doc_h = self._topk_rows(q, limit, None)
        outs: List[Dict[int, float]] = []
        for bi in range(B):
            out: Dict[int, float] = {}
            self._absorb_rows(
                out, vals[bi], rows[bi], row_doc_h, similarities[bi]
            )
            outs.append(out)
        return outs


# ---------------------------------------------------------------------------
# Persistence: the JAX package's snapshot keys (matrix, docs, dim), so a
# snapshot either package writes loads in the other
# ---------------------------------------------------------------------------

def save_vector_index(vidx: VectorIndex, path_prefix: str) -> None:
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    tmp = path_prefix + ".npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(
            fh,
            matrix=vidx._committed_matrix,
            docs=vidx._committed_docs,
            dim=np.asarray([vidx.config.dim]),
        )
    os.replace(tmp, path_prefix + ".npz")


def load_vector_index(path_prefix: str, config: VectorIndexConfig,
                      device) -> VectorIndex:
    vidx = VectorIndex(config, device)
    p = path_prefix + ".npz"
    if os.path.exists(p):
        with np.load(p) as arrays:
            vidx._committed_matrix = arrays["matrix"]
            vidx._committed_docs = arrays["docs"]
        vidx._gen += 1
        if len(vidx._committed_docs) >= IVF_MIN_ROWS:
            vidx._build_ivf()
    return vidx
