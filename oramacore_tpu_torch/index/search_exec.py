"""Executors of the dense BM25F path (counterpart of
oramacore_tpu/index/search_exec.py).

They pad query plans into fixed-shape descriptor arrays on the host, keep
the posting slab and the champion / OMC / filter arrays cached on the
device, and run the scoring functions of `ops/bm25.py`. Every executor
takes an explicit `device`; a CUDA device on a host without CUDA raises.

The host-side helpers (`host_bm25_reference`, `_PlanBatch`,
`analyze_shared_batch`, `pack_shared_class`) are numpy code copied from
the JAX module, whose import pulls in jax.

`StringSearchTopK` also runs the fused sort-by and group-by searches
(`search_topk_sorted`, `search_topk_grouped`); `SharedBatchExecutor`
inherits them, which is the read side's batched sorted route.

`HybridSearchTopK` runs the fused hybrid (BM25F + vector) search over a
flat vector slab (`search_topk_hybrid`) or the int8 IVF layout
(`search_topk_hybrid_int8`), from the tuples of
`index/vector_index.py`'s `flat_device_rows` / `int8_device_rows`.
`SharedBatchExecutor.search_topk_shared` takes the same tuples
(`vec_rows`, `vec_rows_int8`) for its batched hybrid tails, and times its
stages as spans of `utils/trace.py` under one `exec.shared` root:
`exec.analyze`, `exec.pack`, `exec.drain` (while a profiler records),
`exec.upload`, `exec.score` and `exec.tail` (these two with CUDA events
while a profiler records) and `exec.download`.

`PrunedPlanMixin.search_topk_pruned` runs the pruned full-text tier
(ops/pruned.py) on plans built with `with_prefix=True`; `HybridSearchTopK`
derives from it, as in the JAX package. The mixin also counts facets over
a pruned plan (`facet_counts_pruned`, with the exact match count of the
same reps in `facet_match_count`; multi-valued columns come as
`pair_table`s), and `HybridSearchTopK.search_topk_hybrid_int8_pruned` is
the pruned hybrid over the int8 IVF layout.

The read side (`read/__init__.py`, `ReadSide.search` and `search_batch`)
builds these executors on its device and drives them as the JAX read side
drives the JAX ones: `HybridSearchTopK` per index, one
`SharedBatchExecutor` for batches. The AI service's answer, autoquery and
MCP machines (`ai/`) reach them through `ReadSide.search`, so a RAG
answer's retrieval runs these executors on the card.

With `reader_side.sharded_shards` > 1 the read side runs the same
searches through `parallel/engine.py` instead (`ShardedStringExec`,
`ShardedBatchExec`): each index partitioned by doc id over a mesh, each
shard running these ops (`ops/bm25.py`, `ops/pruned.py`,
`ops/facet_hist.py`, with `axis=` for the df, count and histogram sums)
on its slice, and one top-k merge.

The vectors these executors search come from the port's text encoder
(`embeddings/encoder.py`), which the port also trains
(`train/semantic_encoder.py`: the contrastive loop of
`scripts/train_semantic_encoder_v2.py`; `train/semantic_encoder_tpu.py`:
that of `scripts/train_semantic_encoder_tpu.py`, at 6 layers and width
256; both with the attention's forward and backward kernels on the
card); a trained checkpoint loads through `load_torch_encoder` like a
bundled one. The terms they score come from the text parser
(`utils/tokenizer.py`), which stems 14 languages with the port's own
Snowball stemmers (`utils/snowball.py`) on the card as on the CPU.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .string_index import DEFAULT_B, QueryPlan, StringIndex

from .. import resolve_device
from ..utils.trace import span, tracing
from ..ops.bm25 import (
    MAX_RANGE_LEN,
    NEG_F32,
    PostingsDevice,
    bm25_score_batch,
    bm25_search_grouped_packed,
    bm25_search_sorted_packed,
    bm25_search_topk_packed,
    bm25_shared_champions,
    bm25_shared_champions_masked,
    bm25_shared_partial,
    bm25_shared_partial_masked,
    finalize_topk,
    round_up_pow2,
)
from ..ops.facet_hist import facet_hist, facet_hist_multi, row_ptr_table
from ..ops.hybrid import (
    hybrid_finalize_topk,
    hybrid_finalize_topk_int8,
    hybrid_search_topk_packed,
    hybrid_search_topk_packed_int8,
)
from ..ops.pruned import (
    estimate_match_count,
    pack_mask_bits,
    pruned_exact_counts,
    pruned_fulltext_topk,
    pruned_fulltext_topk_bs,
    pruned_hybrid_match_reps,
    pruned_hybrid_topk_int8,
    pruned_hybrid_topk_int8_bs,
    pruned_match_reps,
)

HYBRID_INT8_CANDIDATES = 256  # V: IVF candidate rows per hybrid query

_MISS = object()


class DeviceLru:
    """Bounded keyed LRU for device-resident tensors, safe under
    concurrent searches. `group` maps a key to a stale-group id:
    inserting a key purges other keys of the same group first (stale
    generations of one index can never be queried again)."""

    def __init__(self, maxsize: int, group=None):
        self._d: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()
        self.maxsize = maxsize
        self._group = group

    def get(self, key):
        """Cached value, or the module-level _MISS sentinel."""
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
            return _MISS

    def put(self, key, value):
        with self._lock:
            if self._group is not None:
                g = self._group(key)
                for k in [
                    k for k in self._d
                    if k != key and self._group(k) == g
                ]:
                    del self._d[k]
            self._d[key] = value
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
        return value


class StringSearchExecutor:
    """Caches device slabs and executes batched BM25F scoring."""

    # one executor can serve several indexes, so the caches hold a few
    MAX_CACHED_SLABS = 4

    def __init__(self, device):
        self.device = resolve_device(device)
        # one thread uploads a missing slab; concurrent searches on the
        # same fresh generation wait instead of uploading it twice
        self._build_lock = threading.Lock()
        self._slabs = DeviceLru(
            self.MAX_CACHED_SLABS, group=lambda k: k[0]
        )  # (uid, generation) -> PostingsDevice
        # committed portion: stable between commits, so a live-layer
        # generation bump uploads only the live rows
        self._comms = DeviceLru(
            self.MAX_CACHED_SLABS, group=lambda k: k[0]
        )  # (uid, committed_key) -> PostingsDevice | None

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _get_device_slab(self, index: StringIndex) -> PostingsDevice:
        # keyed on (index uid, slab generation): generation alone collides
        # across indexes, and id() of a freed array can be recycled
        comm, live, ck = index.slab_split()
        gen = (index.uid, index.generation)  # read AFTER the slab build
        cached = self._slabs.get(gen)
        if cached is not _MISS:
            return cached
        with self._build_lock:
            cached = self._slabs.get(gen)
            if cached is not _MISS:
                return cached
            ckey = (index.uid, ck)
            comm_dev = self._comms.get(ckey)
            if comm_dev is _MISS:
                comm_dev = (
                    PostingsDevice.from_numpy(comm, self.device, pad=0)
                    if comm is not None else None
                )
                self._comms.put(ckey, comm_dev)
            parts = [comm_dev] if comm_dev is not None else []
            if live is not None:
                parts.append(PostingsDevice.from_numpy(live, self.device, pad=0))
            # MAX_RANGE_LEN trailing zeros: no range reads past the end
            empty = (np.zeros(0, np.int32),) + (np.zeros(0, np.float32),) * 3
            parts.append(PostingsDevice.from_numpy(empty, self.device))
            return self._slabs.put(gen, PostingsDevice.concat(parts))

    def score(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        exact: bool = False,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Score B queries; returns (scores f32[B, cap], matched f32[B, cap])
        as numpy arrays. Champion slots of the plans are not used."""
        slab = self._get_device_slab(index)
        pb = _PlanBatch(plans, n_docs, cap, doc_masks)
        scores, matched = bm25_score_batch(
            *slab,
            self._to_dev(pb.starts), self._to_dev(pb.lens),
            self._to_dev(pb.weights), self._to_dev(pb.field_b),
            self._to_dev(pb.avg_flen), self._to_dev(pb.nd),
            None if pb.masks is None else self._to_dev(pb.masks),
            lr=pb.LRb, exact=exact, cap=pb.capb,
        )
        return (
            scores[: pb.B, :cap].cpu().numpy(),
            matched[: pb.B, :cap].cpu().numpy(),
        )


# ---------------------------------------------------------------------------
# Host reference scorer (numpy): the parity oracle for the device path.
# Mirrors the reference algorithm literally (bm25.rs + token_score.rs).
# ---------------------------------------------------------------------------

def host_bm25_reference(
    index: StringIndex,
    tokens: Sequence[str],
    properties: Sequence[str],
    boost: Dict[str, float],
    n_docs: float,
    threshold: Optional[float] = None,
    exact: bool = False,
    tolerance: Optional[int] = None,
    k1: float = 1.2,
    doc_mask: Optional[np.ndarray] = None,
) -> Dict[int, float]:
    p_doc, p_tf, p_etf, p_flen = index.slab()
    scores: Dict[int, float] = {}
    masks: Dict[int, int] = {}

    for term_index, token in enumerate(tokens):
        # collect contributions across fields
        contribs: Dict[int, float] = {}
        for path in properties:
            stats = index.field_stats(path)
            if stats.doc_count == 0:
                continue
            w = boost.get(path, 1.0)
            avg = stats.avg_len or 1.0
            tol = 0 if exact else tolerance
            for (start, length) in index._match_terms(path, token, tol):
                for p in range(start, start + length):
                    tf = float(p_etf[p] if exact else p_tf[p])
                    if tf <= 0:
                        continue
                    if doc_mask is not None and not doc_mask[int(p_doc[p])]:
                        continue
                    flen = float(p_flen[p])
                    ntf = tf / (1.0 - 0.75 + 0.75 * flen / avg)
                    d = int(p_doc[p])
                    contribs[d] = contribs.get(d, 0.0) + w * ntf
        if not contribs:
            continue
        df = max(len(contribs), 1)
        idf = float(np.log1p((n_docs - df + 0.5) / (df + 0.5)))
        for d, s in contribs.items():
            term_score = idf * (k1 + 1.0) * s / (k1 + s)
            scores[d] = scores.get(d, 0.0) + term_score
            masks[d] = masks.get(d, 0) | (1 << term_index)

    if threshold is not None:
        thr = int(np.floor(len(tokens) * threshold))
        scores = {
            d: s
            for d, s in scores.items()
            if bin(masks.get(d, 0)).count("1") >= thr
        }
    return scores


class _PlanBatch:
    """Padded descriptor arrays for a batch of plans (host side)."""

    __slots__ = ("starts", "lens", "weights", "field_b", "avg_flen", "nd",
                 "masks", "LRb", "capb", "B", "ch_idx", "ch_w", "has_champ")

    def __init__(self, plans, n_docs, cap, doc_masks=None):
        B = len(plans)
        Bb = round_up_pow2(B, 1)
        T = max(p.starts.shape[0] for p in plans)
        Tb = round_up_pow2(T, 1)
        NR = max(p.starts.shape[1] for p in plans)
        NRb = round_up_pow2(NR, 1)
        LR = max(p.max_range_len for p in plans)
        self.LRb = round_up_pow2(LR, 8)
        self.capb = round_up_pow2(cap, 128)
        self.B = B
        self.starts = np.zeros((Bb, Tb, NRb), np.int32)
        self.lens = np.zeros((Bb, Tb, NRb), np.int32)
        self.weights = np.zeros((Bb, Tb, NRb), np.float32)
        self.field_b = np.full((Bb, Tb, NRb), 0.75, np.float32)
        self.avg_flen = np.ones((Bb, Tb, NRb), np.float32)
        self.nd = np.ones((Bb,), np.float32)
        # (Bb, capb) filter masks, built only when a query has one: at
        # B=64, cap=2^20 an all-true array alone costs tens of ms of host
        self.masks = None
        if doc_masks is not None and any(m is not None for m in doc_masks):
            self.masks = np.ones((Bb, self.capb), bool)
        # champion slots (heavy-term dense rows)
        self.has_champ = any(p.champ_idx is not None for p in plans)
        if self.has_champ:
            NC = max(
                p.champ_idx.shape[1] for p in plans
                if p.champ_idx is not None
            )
            NCb = round_up_pow2(NC, 1)
            self.ch_idx = np.full((Bb, Tb, NCb), -1, np.int32)
            self.ch_w = np.zeros((Bb, Tb, NCb), np.float32)
        else:
            self.ch_idx = self.ch_w = None
        for i, p in enumerate(plans):
            t, r = p.starts.shape
            self.starts[i, :t, :r] = p.starts
            self.lens[i, :t, :r] = p.lens
            self.weights[i, :t, :r] = p.weights
            self.field_b[i, :t, :r] = p.field_b
            self.avg_flen[i, :t, :r] = p.avg_flen
            self.nd[i] = max(float(n_docs[i]), 1.0)
            if self.has_champ and p.champ_idx is not None:
                tc, nc = p.champ_idx.shape
                self.ch_idx[i, :tc, :nc] = p.champ_idx
                self.ch_w[i, :tc, :nc] = p.champ_w
            if doc_masks is not None and doc_masks[i] is not None:
                m = doc_masks[i]
                self.masks[i, : len(m)] = m
                self.masks[i, len(m):] = False


class StringSearchTopK(StringSearchExecutor):
    """Fused path: scoring + threshold + OMC + top-k on the device; only
    (B, k) values / ids come back."""

    @staticmethod
    def _omc_group(key):
        # omc_key is (index uid, omc version): stale versions of the
        # same index can never be requested again
        omc_key, _capb = key
        if isinstance(omc_key, tuple) and len(omc_key) == 2:
            return ("omc", omc_key[0])
        return ("omc", omc_key)

    def __init__(self, device):
        super().__init__(device)
        # OMC multipliers, keyed on (version, capb)
        self._omc_dev = DeviceLru(
            2 * self.MAX_CACHED_SLABS, group=self._omc_group
        )
        # champion matrices, keyed on (uid, generation, capb)
        self._champ_dev = DeviceLru(
            self.MAX_CACHED_SLABS, group=lambda k: k[0]
        )
        # filter masks, keyed on (caller key, capb); the group strips the
        # trailing version so a put purges the stale version
        self._fmask_dev = DeviceLru(
            2 * self.MAX_CACHED_SLABS,
            group=lambda k: (
                k[0][:-1] if isinstance(k[0], tuple) else k[0]
            ),
        )

    def _get_device_champs(self, index: StringIndex, capb: int):
        key = (index.uid, index.generation, capb)
        cached = self._champ_dev.get(key)
        if cached is not _MISS:
            return cached
        mat = index._champ_matrix
        if mat is None:
            return None
        padded = np.zeros((mat.shape[0], capb), np.float32)
        padded[:, : min(mat.shape[1], capb)] = mat[:, :capb]
        return self._champ_dev.put(key, self._to_dev(padded))

    def _get_device_omc(self, omc: np.ndarray, omc_key, capb: int):
        key = (omc_key, capb) if omc_key is not None else None
        if key is not None:
            cached = self._omc_dev.get(key)
            if cached is not _MISS:
                return cached
        arr = np.ones((capb,), np.float32)
        arr[: min(len(omc), capb)] = omc[:capb]
        dev = self._to_dev(arr)
        if key is not None:
            self._omc_dev.put(key, dev)
        return dev

    def _get_device_fmask(self, mask: np.ndarray, mask_key, capb: int):
        """Filter mask as f32[capb] on the device (1.0 = doc allowed; the
        padding beyond cap stays 0 so padded doc ids never match)."""
        key = (mask_key, capb) if mask_key is not None else None
        if key is not None:
            cached = self._fmask_dev.get(key)
            if cached is not _MISS:
                return cached
        arr = np.zeros((capb,), np.float32)
        n = min(len(mask), capb)
        arr[:n] = mask[:n]
        dev = self._to_dev(arr)
        if key is not None:
            self._fmask_dev.put(key, dev)
        return dev

    def search_topk(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        exact: bool = False,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
        thresholds: Optional[Sequence[float]] = None,  # distinct-token counts
        omc: Optional[np.ndarray] = None,              # f32[<=cap]
        omc_key=None,                                  # cache key (version)
        with_bitmap: bool = False,                     # + packed match bits
    ) -> Tuple[np.ndarray, ...]:
        pb, args, has_mask, has_omc = self._fused_args(
            index, plans, n_docs, cap, doc_masks, thresholds, omc, omc_key
        )
        champs_dev, ch_idx, ch_w = self._champ_args(index, pb)
        out = bm25_search_topk_packed(
            *args, champs_dev, ch_idx, ch_w,
            lr=pb.LRb, exact=exact, cap=pb.capb,
            k=min(round_up_pow2(k, 8), pb.capb),
            has_mask=has_mask, has_omc=has_omc,
            has_champ=champs_dev is not None, with_bitmap=with_bitmap,
        )
        return self._results(out, pb, k, cap, with_bitmap)

    def _champ_args(self, index, pb):
        """(champion rows, per-slot rows, weights) on the device, or three
        Nones when no plan has a champion slot or the index has no
        champion rows."""
        champs_dev = (
            self._get_device_champs(index, pb.capb) if pb.has_champ else None
        )
        if champs_dev is None:
            return None, None, None
        return champs_dev, self._to_dev(pb.ch_idx), self._to_dev(pb.ch_w)

    @staticmethod
    def _results(out, pb, k: int, cap: int, with_bitmap: bool):
        """(vals, ids, counts) of the B real queries as numpy; with_bitmap
        appends the packed match set unpacked to bool[B, cap]."""
        vals, idx, counts = out[:3]
        res = (
            vals[: pb.B, :k].cpu().numpy(),
            idx[: pb.B, :k].cpu().numpy(),
            counts[: pb.B].cpu().numpy(),
        )
        if with_bitmap:
            bits = out[3][: pb.B].cpu().numpy()
            return res + (np.unpackbits(bits, axis=1)[:, :cap].astype(bool),)
        return res

    def _fused_args(self, index, plans, n_docs, cap, doc_masks, thresholds,
                    omc, omc_key, similarities=None):
        """Device arguments shared by the fused searches: (plan batch,
        (*slab, idesc, fdesc, scalars, mask, omc), has_mask, has_omc). The
        scalars hold n_docs and thresholds, then the similarities of the
        hybrid searches when given."""
        slab = self._get_device_slab(index)
        pb = _PlanBatch(plans, n_docs, cap, doc_masks)
        idesc = np.stack([pb.starts, pb.lens])
        fdesc = np.stack([pb.weights, pb.field_b, pb.avg_flen])
        rows = 2 if similarities is None else 3
        scalars = np.zeros((rows, pb.starts.shape[0]), np.float32)
        scalars[0] = pb.nd
        if thresholds is not None:
            for i, t in enumerate(thresholds):
                scalars[1, i] = t or 0.0
        if similarities is not None:
            scalars[2, : len(similarities)] = similarities
        has_mask = pb.masks is not None
        has_omc = omc is not None
        args = (
            *slab,
            self._to_dev(idesc), self._to_dev(fdesc), self._to_dev(scalars),
            self._to_dev(pb.masks) if has_mask else None,
            self._get_device_omc(omc, omc_key, pb.capb) if has_omc else None,
        )
        return pb, args, has_mask, has_omc

    def _get_device_svals(self, vals: np.ndarray, present: np.ndarray,
                          svals_key, capb: int):
        """Sort column as f32[capb] on the device, NaN where the doc lacks
        the field (and in the padding). Cached by the caller's version
        key, so the column is uploaded once per mutation."""
        key = (svals_key, capb) if svals_key is not None else None
        if key is not None:
            cached = self._fmask_dev.get(key)
            if cached is not _MISS:
                return cached
        arr = np.full((capb,), np.nan, np.float32)
        n = min(len(vals), capb)
        arr[:n] = vals[:n].astype(np.float32)
        arr[:n][~present[:n]] = np.nan
        dev = self._to_dev(arr)
        if key is not None:
            dev = self._fmask_dev.put(key, dev)
        return dev

    def search_topk_sorted(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        sort_vals: np.ndarray,      # f64[cap] column values
        sort_present: np.ndarray,   # bool[cap]
        svals_key,                  # device-cache key (None = no cache)
        desc: bool,
        exact: bool = False,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key=None,
    ) -> Tuple[List[List[Tuple[int, float]]], np.ndarray]:
        """Fused sort-by search (ops/bm25.py bm25_search_sorted_packed):
        per query, a ranked [(doc, score)] list in sort-field order —
        with-field matches by (value, doc), then fieldless matches by
        doc — plus exact match counts. Plans come from
        `plan_query(..., use_champions=False)`: no champion slot is read."""
        pb, args, has_mask, has_omc = self._fused_args(
            index, plans, n_docs, cap, doc_masks, thresholds, omc, omc_key
        )
        svals_dev = self._get_device_svals(
            sort_vals, sort_present, svals_key, pb.capb
        )
        kb = min(round_up_pow2(k, 8), pb.capb)
        docs1, vals1, sc1, docs2, ok2, sc2, counts = (
            bm25_search_sorted_packed(
                *args, svals_dev,
                lr=pb.LRb, exact=exact, cap=pb.capb, k=kb,
                has_mask=has_mask, has_omc=has_omc, desc=desc,
            )
        )
        docs1, sc1, docs2, ok2, sc2 = (
            t[: pb.B].cpu().numpy() for t in (docs1, sc1, docs2, ok2, sc2)
        )
        ok1 = vals1[: pb.B].cpu().numpy() > NEG_F32 / 2
        ranked: List[List[Tuple[int, float]]] = []
        for b in range(pb.B):
            row = list(zip(docs1[b][ok1[b]].tolist(), sc1[b][ok1[b]].tolist()))
            row += zip(docs2[b][ok2[b]].tolist(), sc2[b][ok2[b]].tolist())
            ranked.append(row[:k])
        return ranked, counts[: pb.B].cpu().numpy()

    def _get_device_gid(self, ids: np.ndarray, gid_key, capb: int):
        """Group-id column as int32[capb] on the device (-1 = doc lacks the
        field, the padding included). Cached by the caller's version key."""
        key = (gid_key, capb) if gid_key is not None else None
        if key is not None:
            cached = self._fmask_dev.get(key)
            if cached is not _MISS:
                return cached
        arr = np.full((capb,), -1, np.int32)
        n = min(len(ids), capb)
        arr[:n] = ids[:n]
        dev = self._to_dev(arr)
        if key is not None:
            dev = self._fmask_dev.put(key, dev)
        return dev

    def search_topk_grouped(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        gid_col: np.ndarray,        # int32[cap] group ids (-1 = none)
        gid_key,                    # device-cache key (None = no cache)
        n_groups: int,
        max_results: int,
        exact: bool = False,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key=None,
    ):
        """Fused group-by search (ops/bm25.py bm25_search_grouped_packed):
        per query, the main top-k page, the exact match count, and
        per-group top-`max_results` [(doc, score)] pages. Returns
        (vals, ids, counts, group_pages) with group_pages[b][g] a ranked
        list for group id g < n_groups."""
        pb, args, has_mask, has_omc = self._fused_args(
            index, plans, n_docs, cap, doc_masks, thresholds, omc, omc_key
        )
        gid_dev = self._get_device_gid(gid_col, gid_key, pb.capb)
        kb = min(round_up_pow2(k, 8), pb.capb)
        Gb = round_up_pow2(max(n_groups, 1), 8)
        Rb = min(round_up_pow2(max_results, 8), pb.capb)
        vals, ids, counts, gvals, gdocs = bm25_search_grouped_packed(
            *args, gid_dev,
            lr=pb.LRb, exact=exact, cap=pb.capb, k=kb, R=Rb, G=Gb,
            has_mask=has_mask, has_omc=has_omc,
        )
        gvals = gvals[: pb.B, :n_groups].cpu().numpy()
        fin = np.isfinite(gvals).tolist()
        gvals = gvals.tolist()
        gdocs = gdocs[: pb.B, :n_groups].cpu().numpy().tolist()
        group_pages = [
            [
                [
                    (d, v) for d, v, f in zip(gdocs[b][g], gvals[b][g], fin[b][g])
                    if f
                ][:max_results]
                for g in range(n_groups)
            ]
            for b in range(pb.B)
        ]
        return (
            vals[: pb.B, :k].cpu().numpy(),
            ids[: pb.B, :k].cpu().numpy(),
            counts[: pb.B].cpu().numpy(),
            group_pages,
        )


class PrunedPlanMixin(StringSearchTopK):
    """The pruned tier (candidates + exact rescore, ops/pruned.py) for
    corpora too large for a (B, cap) accumulator. Plans come from
    `plan_query(..., with_prefix=True)`; the host helpers are the JAX
    mixin's numpy code. Callers gate eligibility (the JAX read side's
    `ReadSide._pruned_eligible`: 2M docs and up)."""

    # nomination clip for plans built WITHOUT with_prefix (a fallback:
    # eligible searches carry with_prefix plans, whose prefix ranges are
    # the commit-time blocks of depth string_index.PREFIX_LEN)
    PRUNED_PREFIX = 8192
    PRUNED_CANDIDATES = 1024
    # multi-valued facet columns take the device path while no doc holds
    # more values than this (the read side routes wider ones elsewhere)
    PRUNED_FACET_MULTI_MAX = 8
    PRUNED_LCH = 32768   # rescore worklist chunk length
    PRUNED_WCH = 128     # worklist entries per JAX scan step (W's bucket)
    # exact-counts batch slice: queries per dispatch of the counting sort
    PRUNED_COUNTS_SLICE = 8
    # v4 batched dispatch chunk, grown while the nominator's sort width
    # (chunk * T * NPR * lp) stays within PRUNED_BS_SORT_BUDGET
    PRUNED_BS_BATCH = 64
    PRUNED_BS_SORT_BUDGET = 16 * 1024 * 1024
    # v4 binary-search rescore for eligible searches (single-span tokens,
    # non-exact tf, unfiltered)
    PRUNED_BS = True          # dispatch eligible searches to v4
    PRUNED_BS_ACCUM = True    # nominate via accumulated partial scores
    PRUNED_BS_HP = 2048       # head slice per prefix range (slice mode)
    PRUNED_BS_C = 1024        # candidate budget (accum mode)
    PRUNED_BS_BUCKETS = 1024  # rescore bucket-index resolution
    # bucket-span target of the static offset tables: per-range
    # resolution K_r = capb >> shift_r sized for about this many postings
    # per bucket (rescore rounds = log2(max span))
    PRUNED_BS_SPAN = 16

    def __init__(self, device):
        super().__init__(device)
        # filter bitmaps of the worklist rescore, keyed as the f32 masks
        self._fbits_dev = DeviceLru(
            2 * self.MAX_CACHED_SLABS,
            group=lambda k: (
                k[0][:-1] if isinstance(k[0], tuple) else k[0]
            ),
        )

    def _get_device_fbits(self, fmask_dev, mask_key, capb: int):
        """The filter's bitmap (`pack_mask_bits`), which `rescore_worklist`
        reads in place of the f32 mask, built once per mask key beside it.
        None on the CPU, where the plain version reads the f32 mask."""
        if fmask_dev.device.type != "cuda":
            return None
        key = (mask_key, capb) if mask_key is not None else None
        if key is not None:
            cached = self._fbits_dev.get(key)
            if cached is not _MISS:
                return cached
        bits = pack_mask_bits(fmask_dev)
        if key is not None:
            self._fbits_dev.put(key, bits)
        return bits

    @classmethod
    def _pruned_host_inputs(cls, plans, n_docs, thresholds):
        """Host arrays for the pruned kernels:
        (pre_idesc, pre_fdesc, wl_i, wl_f, idf, nd, thr, dfs, lp, T,
        wl_prev, nre, bs_steps). The worklist packs only real (query,
        token, chunk) work; the nomination prefixes come from the plans'
        impact-prefix ranges, with a clipped main range for plans built
        without `with_prefix`."""
        B = len(plans)
        Bb = round_up_pow2(B, 1)
        T = max(p.starts.shape[0] for p in plans)
        Tb = round_up_pow2(T, 1)
        # small corpora: the chunk width follows the longest range (pow2
        # ladder); the 10M tier lands on PRUNED_LCH
        max_rl = max(
            (int(p.lens.max()) if p.lens.size else 1) for p in plans
        )
        lch = min(cls.PRUNED_LCH, round_up_pow2(max_rl, 128))

        def pre_of(p):
            if p.pre_starts is not None:
                return (p.pre_starts, p.pre_lens, p.pre_weights,
                        p.pre_field_b, p.pre_avg)
            return (p.starts, np.minimum(p.lens, cls.PRUNED_PREFIX),
                    p.weights, p.field_b, p.avg_flen)

        NPR = max(1, max(pre_of(p)[0].shape[1] for p in plans))
        NPRb = round_up_pow2(NPR, 1)
        pre_st = np.zeros((Bb, Tb, NPRb), np.int32)
        pre_ln = np.zeros((Bb, Tb, NPRb), np.int32)
        pre_w = np.zeros((Bb, Tb, NPRb), np.float32)
        pre_fb = np.full((Bb, Tb, NPRb), 0.75, np.float32)
        pre_av = np.ones((Bb, Tb, NPRb), np.float32)
        lp = 8
        nd = np.ones((Bb,), np.float32)
        dfs = np.zeros((Bb, Tb), np.float64)
        wl = []          # (b, t, start, len, w, fb, av)
        wl_earlier = []  # per entry: earlier spans of the same token
        max_span = 0
        for i, p in enumerate(plans):
            nd[i] = max(float(n_docs[i]), 1.0)
            ps, pl, pw, pf, pa = pre_of(p)
            t_, r_ = ps.shape
            pre_st[i, :t_, :r_] = ps
            pre_ln[i, :t_, :r_] = pl
            pre_w[i, :t_, :r_] = pw
            pre_fb[i, :t_, :r_] = pf
            pre_av[i, :t_, :r_] = pa
            if pl.size:
                lp = max(lp, int(pl.max()))
            t_n, r_n = p.starts.shape
            for t in range(t_n):
                # earlier spans of the SAME token (any field or tolerance
                # variant) except the range's own (field, term): the
                # device df subtraction dedups across them (union df)
                spans_t = (p.spans[t] if p.spans is not None
                           and t < len(p.spans) else [])
                for r in range(r_n):
                    ln = int(p.lens[t, r])
                    if ln <= 0:
                        continue
                    dfs[i, t] += ln
                    s0 = int(p.starts[t, r])
                    w0 = float(p.weights[t, r])
                    b0 = float(p.field_b[t, r])
                    a0 = float(p.avg_flen[t, r])
                    so = (
                        int(p.range_span[t, r])
                        if p.range_span is not None else -1
                    )
                    if so >= 0:
                        me = spans_t[so][:2]
                        earlier = [
                            (rs, rl)
                            for (fo, to, rs, rl) in spans_t[:so]
                            if (fo, to) != me
                        ]
                    else:
                        earlier = []
                    for (_rs, rl) in earlier:
                        max_span = max(max_span, rl)
                    off = 0
                    while off < ln:
                        take = min(ln - off, lch)
                        wl.append((i, t, s0 + off, take, w0, b0, a0))
                        wl_earlier.append(earlier)
                        off += take
        lp = round_up_pow2(lp, 8)
        W = round_up_pow2(max(len(wl), 1), cls.PRUNED_WCH)
        wl_i = np.zeros((4, W), np.int32)
        wl_f = np.zeros((3, W), np.float32)
        wl_f[2, :] = 1.0
        for j, (b, t, s0, ln, w0, b0, a0) in enumerate(wl):
            wl_i[:, j] = (b, t, s0, ln)
            wl_f[:, j] = (w0, b0, a0)
        nre = max((len(e) for e in wl_earlier), default=0)
        nre = round_up_pow2(nre, 1) if nre else 0
        wl_prev = None
        bs_steps = 0
        if nre:
            wl_prev = np.zeros((2, W, nre), np.int32)
            for j, earlier in enumerate(wl_earlier):
                for e, (rs, rl) in enumerate(earlier):
                    wl_prev[0, j, e] = rs
                    wl_prev[1, j, e] = rl
            bs_steps = 4
            while (1 << bs_steps) < max_span + 1:
                bs_steps += 4
        # clamp to the corpus size: tolerance sums variant ranges, so the
        # raw host df can exceed nd; nomination-only (the rescore counts
        # the deduplicated df on the device)
        d = np.minimum(np.maximum(dfs, 1.0), nd[:, None])
        idf = np.where(
            dfs > 0,
            np.log1p((nd[:, None] - d + 0.5) / (d + 0.5)),
            0.0,
        ).astype(np.float32)
        thr = np.zeros((Bb,), np.float32)
        if thresholds is not None:
            for i, t in enumerate(thresholds):
                thr[i] = t or 0.0
        pre_idesc = np.stack([pre_st, pre_ln])
        pre_fdesc = np.stack([pre_w, pre_fb, pre_av])
        return (pre_idesc, pre_fdesc, wl_i, wl_f, idf, nd, thr, dfs,
                int(lp), int(Tb), wl_prev, int(nre), int(bs_steps))

    @classmethod
    def _pruned_bs_inputs(cls, plans):
        """Host arrays for the v4 binary-search rescore: UNSPLIT
        doc-sorted ranges per (query, token). Plan builders split ranges
        at MAX_RANGE_LEN; pieces split from one span (same range_span
        ordinal, start-adjacent, same field params) re-join here, so NR is
        the real span count and each range stays globally doc-sorted.
        Returns (rng_i int32[2, Bb, Tb, NRU], rng_f f32[3, Bb, Tb, NRU],
        bs_steps)."""
        B = len(plans)
        Bb = round_up_pow2(B, 1)
        T = max(p.starts.shape[0] for p in plans)
        Tb = round_up_pow2(T, 1)
        per = []  # [b][t] -> list of (start, len, w, fb, av)
        nru = 1
        max_len = 1
        for p in plans:
            rows = []
            t_n, r_n = p.starts.shape
            for t in range(t_n):
                items = sorted(
                    (
                        (int(p.starts[t, r]), int(p.lens[t, r]),
                         float(p.weights[t, r]), float(p.field_b[t, r]),
                         float(p.avg_flen[t, r]),
                         int(p.range_span[t, r])
                         if p.range_span is not None else -1 - r)
                        for r in range(r_n)
                        if int(p.lens[t, r]) > 0
                    ),
                )
                merged: list = []
                m_span: list = []
                for s0, ln, w0, b0, a0, so in items:
                    # only pieces of ONE span re-join: two distinct
                    # doc-sorted ranges that happen to abut are not
                    # doc-sorted together
                    if merged and m_span[-1] == so and so >= 0 \
                            and merged[-1][0] + merged[-1][1] == s0 \
                            and merged[-1][2:] == (w0, b0, a0):
                        prev = merged[-1]
                        merged[-1] = (prev[0], prev[1] + ln, w0, b0, a0)
                    else:
                        merged.append((s0, ln, w0, b0, a0))
                        m_span.append(so)
                rows.append(merged)
                nru = max(nru, len(merged))
                for m in merged:
                    max_len = max(max_len, m[1])
            per.append(rows)
        NRU = round_up_pow2(nru, 1)
        rng_st = np.zeros((Bb, Tb, NRU), np.int32)
        rng_ln = np.zeros((Bb, Tb, NRU), np.int32)
        rng_w = np.zeros((Bb, Tb, NRU), np.float32)
        rng_fb = np.full((Bb, Tb, NRU), 0.75, np.float32)
        rng_av = np.ones((Bb, Tb, NRU), np.float32)
        for i, rows in enumerate(per):
            for t, merged in enumerate(rows):
                for r, (s0, ln, w0, b0, a0) in enumerate(merged):
                    rng_st[i, t, r] = s0
                    rng_ln[i, t, r] = ln
                    rng_w[i, t, r] = w0
                    rng_fb[i, t, r] = b0
                    rng_av[i, t, r] = a0
        bs_steps = 4
        while (1 << bs_steps) < max_len + 1:
            bs_steps += 4
        rng_i = np.stack([rng_st, rng_ln])
        rng_f = np.stack([rng_w, rng_fb, rng_av])
        return rng_i, rng_f, int(bs_steps)

    def _pruned_bs_chunk(self, plans) -> int:
        """Batched v4 dispatch chunk: PRUNED_BS_BATCH doubled while the
        chunk's nominator sort width (chunk * max(T*NPR) * max(lp); the
        batch pads T*NPR and lp independently) stays within
        PRUNED_BS_SORT_BUDGET."""
        max_tnpr = 0
        max_lpq = 0
        for pl in plans:
            if pl.pre_lens is not None and pl.pre_lens.size:
                lpq = round_up_pow2(max(8, int(pl.pre_lens.max())), 8)
                t_npr = pl.pre_lens.shape[0] * pl.pre_lens.shape[1]
                max_tnpr = max(max_tnpr, t_npr)
                max_lpq = max(max_lpq, lpq)
        width = max_tnpr * max_lpq
        S = self.PRUNED_BS_BATCH
        if width:
            while width * (S * 2) <= self.PRUNED_BS_SORT_BUDGET:
                S *= 2
        return S

    def _pruned_bs_boff(self, index, rng_i, capb: int, bs_steps: int):
        """Static per-range bucket-offset tables for the v4 rescore. Each
        distinct committed range gets one offsets row at its own
        resolution K_r = capb >> shift_r (about PRUNED_BS_SPAN postings
        per bucket), built on first use, kept on the device and cached by
        (index.uid, generation); a batch ships only (B, T, NR) base and
        shift arrays. flat[0:2] is a zero dummy row for empty ranges.

        Returns (flat_dev | None, base, shift, steps); (None, None, None,
        bs_steps) when a span crosses the committed / live boundary."""
        comm, live, _ck = index.slab_split()
        n_comm = len(comm[0]) if comm is not None else 0
        gen = (index.uid, index.generation)
        state = getattr(self, "_boff_flat", None)
        if state is None or state["key"] != gen:
            state = {
                "key": gen,
                "spans": {},
                "rows": [np.zeros(2, np.int32)],  # dummy row at 0
                "total": 2,
                "dev": None,
            }
            self._boff_flat = state
        spans = state["spans"]
        full_shift = max(capb.bit_length() - 1, 0)
        rng_st, rng_ln = rng_i[0], rng_i[1]
        Bb, Tb, NRU = rng_st.shape
        base = np.zeros((Bb, Tb, NRU), np.int32)
        shift = np.full((Bb, Tb, NRU), full_shift, np.int32)
        max_span = 1
        for b in range(Bb):
            for t in range(Tb):
                for r in range(NRU):
                    ln = int(rng_ln[b, t, r])
                    if ln <= 0:
                        continue  # dummy row
                    s0 = int(rng_st[b, t, r])
                    hit = spans.get((s0, ln))
                    if hit is None:
                        if s0 < n_comm:
                            seg = comm[0][s0:s0 + ln]
                        elif live is not None:
                            seg = live[0][s0 - n_comm:s0 - n_comm + ln]
                        else:
                            seg = np.zeros(0, np.int32)
                        if len(seg) != ln:
                            return None, None, None, bs_steps
                        sh = full_shift
                        while sh > 0 and (
                            ln << sh
                        ) > capb * self.PRUNED_BS_SPAN:
                            sh -= 1
                        K = max(capb >> sh, 1)
                        grid = np.arange(1, K, dtype=np.int64) << sh
                        row = np.empty(K + 1, np.int32)
                        row[0] = 0
                        if K > 1:
                            row[1:K] = np.searchsorted(seg, grid)
                        row[K] = ln
                        hit = (state["total"], sh, int(np.diff(row).max()))
                        spans[(s0, ln)] = hit
                        state["rows"].append(row)
                        state["total"] += K + 1
                        state["dev"] = None
                    base[b, t, r] = hit[0]
                    shift[b, t, r] = hit[1]
                    max_span = max(max_span, hit[2])
        if state["dev"] is None:
            # pow2-padded: the zero tail also absorbs the sentinel
            # candidate's read of at_j + 1 past the last row
            flat = np.concatenate(state["rows"])
            Lp = 1
            while Lp < len(flat) + 1:
                Lp <<= 1
            buf = np.zeros(Lp, np.int32)
            buf[:len(flat)] = flat
            state["dev"] = self._to_dev(buf)
        steps = 4
        while (1 << steps) < max_span + 1:
            steps += 4
        return state["dev"], base, shift, steps

    @staticmethod
    def _pruned_counts(cand_counts, dfs, nd, thresholds, B,
                       sel_frac: float = 1.0):
        """Corpus-wide match counts for the pruned path: the union-
        probability estimate floored by the verified-candidate lower
        bound. Thresholded queries keep the lower bound; filtered ones
        scale the estimate by the filter's selectivity."""
        out = np.asarray(cand_counts[:B]).copy()
        for i in range(B):
            thr_i = 0.0
            if thresholds is not None and i < len(thresholds):
                thr_i = thresholds[i] or 0.0
            if thr_i <= 0.0:
                est = estimate_match_count(
                    float(nd[i]), [d for d in dfs[i] if d > 0]
                )
                out[i] = max(int(out[i]), int(round(est * sel_frac)))
        return out

    def _pruned_mask_inputs(self, mask, mask_key, cap, capb, Bb, C):
        """Device inputs of a FILTERED pruned search: the f32 mask and,
        when the filter selects <= C docs, those docs as the candidate
        set (phase 1 skipped; results and counts exact). Returns
        (fmask_dev, cand_in, cand_given, sel)."""
        fmask_dev = self._get_device_fmask(mask, mask_key, capb)
        sel = int(np.count_nonzero(mask[:cap]))
        cand_in = None
        cand_given = False
        if sel <= C:
            ids = np.nonzero(mask[:cap])[0].astype(np.int32)
            cand_np = np.full((Bb, C), capb, np.int32)
            if len(ids):
                cand_np[:, : len(ids)] = ids[None, :]
            cand_in = self._to_dev(cand_np)
            cand_given = True
        return fmask_dev, cand_in, cand_given, sel

    def _exact_counts_sliced(self, slab, wl_i, thr, fmask_dev, *, B, capb,
                             Tb, exact, has_filter):
        """The exact-counts dispatch in slices of at most
        PRUNED_COUNTS_SLICE queries (the JAX package slices because its
        global sort grows superlinearly on the TPU; kept so both packages
        dispatch the same work)."""
        S = self.PRUNED_COUNTS_SLICE

        def run(wl, th):
            return pruned_exact_counts(
                slab.doc, slab.tf, slab.exact_tf, self._to_dev(wl),
                self._to_dev(th), fmask_dev, lch=self.PRUNED_LCH, cap=capb,
                T=Tb, exact=exact, has_filter=has_filter,
            ).cpu().numpy()

        if B <= S:
            return run(wl_i, thr)[:B]
        bw, ln = wl_i[0], wl_i[3]
        counts = np.zeros((B,), np.int32)
        for s0 in range(0, B, S):
            cols = np.nonzero((bw >= s0) & (bw < s0 + S) & (ln > 0))[0]
            Ws = round_up_pow2(max(len(cols), 1), 2)
            wls = np.zeros((4, Ws), np.int32)
            wls[:, : len(cols)] = wl_i[:, cols]
            wls[0, : len(cols)] -= s0
            thrs = np.zeros((S,), np.float32)
            take = min(S, B - s0)
            thrs[:take] = thr[s0:s0 + take]
            counts[s0:s0 + take] = run(wls, thrs)[:take]
        return counts

    def search_topk_pruned(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        exact: bool = False,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key=None,
        exact_counts: bool = False,
        mask: Optional[np.ndarray] = None,
        mask_key=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pruned full-text search on one device: (vals f32[B, k], ids
        int32[B, k], counts int32[B]).

        Routes, as in the JAX package: v4 (nomination + binary-search
        rescore, `rescore_bsearch`) for unfiltered, non-exact searches
        whose tokens each hit one span, dispatched in chunks of
        `_pruned_bs_chunk` queries; v3 (nomination + worklist rescore,
        `rescore_worklist`) otherwise. `mask` (bool[cap], True = allowed)
        filters every plan, with the dense path's filtered-df idf; a mask
        of at most PRUNED_CANDIDATES docs is the candidate set itself, so
        results and counts are exact. exact_counts=True replaces the
        count estimate by a second, exact dispatch."""
        slab = self._get_device_slab(index)
        B = len(plans)
        capb = round_up_pow2(cap, 128)
        (pre_idesc, pre_fdesc, wl_i, wl_f, idf, nd, thr, dfs, lp, Tb,
         wl_prev, nre, bs_steps) = (
            self._pruned_host_inputs(plans, n_docs, thresholds)
        )
        has_omc = omc is not None
        if has_omc:
            omc_dev = self._get_device_omc(omc, omc_key, capb)
        else:
            omc_dev = torch.ones((1,), dtype=torch.float32, device=self.device)
        # a candidate budget past the doc space only inflates shapes
        C = min(self.PRUNED_CANDIDATES, round_up_pow2(cap, 8))
        has_filter = mask is not None
        fmask_dev = None
        cand_in = None
        cand_given = False
        sel = None
        if has_filter:
            fmask_dev, cand_in, cand_given, sel = self._pruned_mask_inputs(
                mask, mask_key, cap, capb, idf.shape[0], C
            )
        use_bs = (
            self.PRUNED_BS and not exact and not has_filter and nre == 0
        )
        S = self._pruned_bs_chunk(plans) if use_bs else B
        if B > S:
            parts = [
                self.search_topk_pruned(
                    index, plans[i:i + S], n_docs[i:i + S], cap, k,
                    exact=exact,
                    thresholds=(
                        thresholds[i:i + S] if thresholds is not None
                        else None
                    ),
                    omc=omc, omc_key=omc_key, exact_counts=exact_counts,
                )
                for i in range(0, B, S)
            ]
            return (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
            )
        dev = self._to_dev
        if use_bs:
            # v4: exact host idf (single-span tokens, unfiltered, stemmed
            # tf >= 1: range lengths are the df)
            rng_i, rng_f, rbs_steps = self._pruned_bs_inputs(plans)
            bflat, bbase, bshift, rbs_steps = self._pruned_bs_boff(
                index, rng_i, capb, rbs_steps
            )
            if self.PRUNED_BS_ACCUM:
                Cb = min(self.PRUNED_BS_C, round_up_pow2(cap, 8))
            else:
                Cb = pre_idesc.shape[2] * pre_idesc.shape[3] * \
                    self.PRUNED_BS_HP
            kb = min(round_up_pow2(k, 8), Cb)
            vals, ids, cand_counts = pruned_fulltext_topk_bs(
                slab.doc, slab.tf, slab.flen,
                dev(pre_idesc[0]), dev(pre_idesc[1]),
                dev(rng_i), dev(rng_f), dev(idf), dev(thr), omc_dev, None,
                dev(pre_fdesc) if self.PRUNED_BS_ACCUM else None,
                (bflat, dev(bbase), dev(bshift))
                if bflat is not None else None,
                hp=self.PRUNED_BS_HP, cap=capb, k=kb,
                bs_steps=rbs_steps, has_omc=has_omc,
                nom_accum=self.PRUNED_BS_ACCUM,
                lp=lp if self.PRUNED_BS_ACCUM else 0,
                C=Cb if self.PRUNED_BS_ACCUM else 0,
            )
        else:
            kb = min(round_up_pow2(k, 8), C)
            vals, ids, cand_counts = pruned_fulltext_topk(
                slab.doc, slab.tf, slab.exact_tf, slab.flen,
                dev(pre_idesc), dev(pre_fdesc), dev(wl_i), dev(wl_f),
                dev(idf), dev(nd), dev(thr), omc_dev,
                dev(wl_prev) if wl_prev is not None else None,
                fmask_dev, cand_in,
                lp=lp, lch=self.PRUNED_LCH, cap=capb, C=C, k=kb, T=Tb,
                exact=exact, has_omc=has_omc, nre=nre, bs_steps=bs_steps,
                has_filter=has_filter, cand_given=cand_given,
                fbits=(self._get_device_fbits(fmask_dev, mask_key, capb)
                       if has_filter else None),
            )
        cand_counts = cand_counts[:B].cpu().numpy()
        if cand_given:
            # every in-filter doc was verified: counts are exact
            counts = cand_counts
        elif exact_counts:
            counts = self._exact_counts_sliced(
                slab, wl_i, thr, fmask_dev, B=B, capb=capb, Tb=Tb,
                exact=exact, has_filter=has_filter,
            )
        else:
            sel_frac = 1.0
            if sel is not None:
                sel_frac = sel / max(float(nd[0]), 1.0)
            counts = self._pruned_counts(
                cand_counts, dfs, nd, thresholds, B, sel_frac=sel_frac
            )
        return (
            vals[:B, :k].cpu().numpy(),
            ids[:B, :k].cpu().numpy(),
            counts,
        )

    # ------------------------------------------------------------------
    # facets over a pruned plan
    # ------------------------------------------------------------------

    def _facet_worklist(self, plan: QueryPlan, lch: int) -> np.ndarray:
        """Worklist of the facet reps: every main range of the plan
        chunked to lch, each row carrying its token index. Returns wl_i
        int32[4, W], W a power of two."""
        T, NR = plan.starts.shape
        wl = []
        for t in range(T):
            for r in range(NR):
                ln = int(plan.lens[t, r])
                s0 = int(plan.starts[t, r])
                for off in range(0, max(ln, 0), lch):
                    wl.append((0, t, s0 + off, min(ln - off, lch)))
        W = round_up_pow2(max(len(wl), 1), 2)
        wl_i = np.zeros((4, W), np.int32)
        if wl:
            wl_i[:, : len(wl)] = np.asarray(wl, np.int32).T
        return wl_i

    def _device_column(self, col_key, build, bounds):
        """A facet column's device arrays and its (G, 2) ranges, cached in
        `_fmask_dev` by col_key (none: made for this call only); build()
        makes the arrays, as host arrays to upload or device tensors. The
        ranges come with each search, not with the column: the entry keeps
        the last range set beside the column, and another set is uploaded
        in its place."""
        b = np.ascontiguousarray(bounds, np.float32)
        cached = _MISS if col_key is None else self._fmask_dev.get(col_key)
        if cached is not _MISS:
            arrs, b_bytes, b_dev = cached
            if b_bytes == b.tobytes():
                return arrs + (b_dev,)
        else:
            arrs = tuple(a if isinstance(a, torch.Tensor) else self._to_dev(a)
                         for a in build())
        b_dev = self._to_dev(b)
        if col_key is not None:
            self._fmask_dev.put(col_key, (arrs, b.tobytes(), b_dev))
        return arrs + (b_dev,)

    def facet_counts_pruned(
        self,
        index: StringIndex,
        plan: QueryPlan,
        cap: int,
        spec,              # ("cat", ids int32[cap], G)
        #                  | ("num", vals f32[cap] NaN-missing, bounds f32[G, 2])
        #                  | ("mcat", pair_docs, pair_vals, G, M)
        #                  | ("mnum", pair_docs, pair_vals, bounds, M)
        spec_key,          # device-cache key of the column (None: no cache)
        exact: bool = False,
        mask: Optional[np.ndarray] = None,
        mask_key=None,
        thr: float = 0.0,
        vec=None,
        vec_only: bool = False,
    ) -> np.ndarray:
        """Facet counts (int32[G]) over a pruned full-text or hybrid
        search: the distinct matched docs per bucket. Phase A's (docs,
        rep) pair is computed once per plan and kept in a one-slot cache
        for the search's other facet fields; phase B runs one kernel per
        field. `mask` is the alive mask (tombstones): facets count the
        unfiltered match set. `thr` = min distinct matched tokens. `vec` =
        (vector index, q f32[1, dim], similarity, rescale) widens the match
        set by the IVF probe's top-V docs clearing the similarity floor;
        `vec_only` takes those alone (no text worklist)."""
        capb = round_up_pow2(cap, 128)
        has_filter = mask is not None
        fmask_dev = (self._get_device_fmask(mask, mask_key, capb)
                     if has_filter else None)
        # the slot holds a strong reference to the plan, so the `is`
        # check can never alias a recycled id()
        reps_key = (index.uid, mask_key, has_filter, exact, float(thr), capb,
                    vec is not None, vec_only)
        slot = getattr(self, "_facet_reps_slot", None)
        if slot is not None and slot[1] is plan and slot[0] == reps_key:
            docs_dev, rep_dev = slot[2], slot[3]
        else:
            if vec_only:
                # the probe alone, deduplicated against all-sentinel reps
                if vec is None:
                    raise ValueError("vec_only facets need vec")
                docs_dev = torch.full((self.PRUNED_LCH,), capb,
                                      dtype=torch.int32, device=self.device)
                rep_dev = torch.zeros(self.PRUNED_LCH, dtype=torch.float32,
                                      device=self.device)
            else:
                slab = self._get_device_slab(index)
                wl_i = self._facet_worklist(plan, self.PRUNED_LCH)
                docs_dev, rep_dev = pruned_match_reps(
                    slab.doc, slab.tf, slab.exact_tf, self._to_dev(wl_i),
                    float(thr), fmask_dev, lch=self.PRUNED_LCH, cap=capb,
                    exact=exact, has_filter=has_filter,
                )
            if vec is not None:
                vector_index, q, sim_v, rescale = vec
                *layout, window, nprobe = vector_index.int8_device_rows()
                docs_dev, rep_dev = pruned_hybrid_match_reps(
                    docs_dev, rep_dev, *layout,
                    self._to_dev(np.asarray(q, np.float32).reshape(1, -1)),
                    float(sim_v), fmask_dev,
                    V=_ivf_candidates(None, int(layout[0].shape[0])),
                    nprobe=nprobe, window=window, cap=capb,
                    pad=self.PRUNED_LCH, has_filter=has_filter,
                    **_rescale_kw(rescale),
                )
            self._facet_reps_slot = (reps_key, plan, docs_dev, rep_dev)
        col_key = (spec_key, capb) if spec_key is not None else None
        kind = spec[0]
        if kind in ("mcat", "mnum"):
            numeric = kind == "mnum"
            pair_docs, pair_vals = spec[1], spec[2]
            if numeric:
                bounds = spec[3]
                G, M = bounds.shape[0], int(spec[4])
            else:
                G, M = int(spec[3]), int(spec[4])
                bounds = np.zeros((G, 2), np.float32)

            def pairs():
                # a sentinel row (> any doc id, != the reps' cap) keeps
                # the plain version's search inside the table; row_ptr,
                # made on the device, gives the kernel the rows of each
                # doc below cap
                pd_dev = self._to_dev(np.concatenate([
                    np.asarray(pair_docs, np.int32),
                    np.full(1, 2**30, np.int32)]))
                return (
                    pd_dev,
                    np.concatenate([
                        np.asarray(pair_vals,
                                   np.float32 if numeric else np.int32),
                        np.zeros(1, np.float32 if numeric else np.int32)]),
                    row_ptr_table(pd_dev, cap),
                )

            pd_dev, pv_dev, rp_dev, b_dev = self._device_column(
                col_key, pairs, bounds)
            counts = facet_hist_multi(
                docs_dev, rep_dev, pd_dev, pv_dev, rp_dev, b_dev,
                G=G, numeric=numeric, M=max(M, 1),
            )
            return counts.cpu().numpy()
        return self._facet_hist_single(spec, col_key, capb, docs_dev,
                                       rep_dev)

    def facet_match_count(self, plan) -> Optional[int]:
        """The exact match count of the search whose facets were just
        counted: phase A's rep sum, summed in int32 (an f32 sum of ones is
        exact only to 2^24 docs). None when the reps slot holds another
        plan."""
        slot = getattr(self, "_facet_reps_slot", None)
        if slot is None or slot[1] is not plan:
            return None
        return int(slot[3].to(torch.int32).sum())

    def _facet_hist_single(self, spec, col_key, capb, docs_dev,
                           rep_dev) -> np.ndarray:
        """Phase B of a single-valued field: the column on the device,
        padded to capb ("num" with NaN, "cat" with -1), and one
        `facet_hist` launch over the cached reps."""
        numeric = spec[0] == "num"
        if numeric:
            vals, bounds = spec[1], spec[2]
            G = bounds.shape[0]
            fill, dtype = np.nan, np.float32
        else:
            vals, G = spec[1], int(spec[2])
            bounds = np.zeros((G, 2), np.float32)
            fill, dtype = -1, np.int32

        def column():
            arr = np.full((capb,), fill, dtype)
            arr[: min(len(vals), capb)] = vals[:capb]
            return (arr,)

        col_dev, b_dev = self._device_column(col_key, column, bounds)
        counts = facet_hist(docs_dev, rep_dev, col_dev, b_dev, G=G,
                            numeric=numeric)
        return counts.cpu().numpy()


def pair_table(docs: np.ndarray, vals: np.ndarray, cap: int):
    """A multi-valued column's (doc, value) rows as the facet kernels take
    them (numpy, as the JAX package's `filter_fields` column builds them):
    rows of docs < cap, sorted by (doc, value) and deduplicated, and the
    most distinct values one doc holds. Returns (pair_docs int32[P]
    ascending, pair_vals, M)."""
    docs, vals = np.asarray(docs), np.asarray(vals)
    keep = docs < cap
    docs, vals = docs[keep], vals[keep]
    if not len(docs):
        return np.zeros(0, np.int32), vals[:0], 0
    order = np.lexsort((vals, docs))
    d = docs[order].astype(np.int32)
    v = vals[order]
    first = np.ones(len(d), bool)
    first[1:] = (d[1:] != d[:-1]) | (v[1:] != v[:-1])
    d, v = d[first], v[first]
    ends = np.flatnonzero(np.r_[d[1:] != d[:-1], True])
    return d, v, int(np.diff(np.r_[-1, ends]).max())


def _rescale_kw(rescale: Optional[Tuple[float, float]]) -> dict:
    return dict(
        has_rescale=rescale is not None,
        rescale_lo=float(rescale[0]) if rescale else 0.0,
        rescale_hi=float(rescale[1]) if rescale else 1.0,
    )


def _ivf_candidates(candidates: Optional[int], n_rows: int) -> int:
    """V, the IVF candidate rows a hybrid query keeps."""
    return round_up_pow2(
        min(candidates or HYBRID_INT8_CANDIDATES, n_rows), 8
    )


class HybridSearchTopK(PrunedPlanMixin):
    """Fused hybrid: BM25F + vector similarities + min-max fusion +
    threshold + OMC + top-k on the device; only (B, k) values / ids (and
    counts, and optionally the packed match set) come back."""

    def _query_rows(self, queries: np.ndarray, pb) -> torch.Tensor:
        """The query vectors on the device, padded to the plan batch."""
        q = np.zeros((pb.starts.shape[0], queries.shape[1]), np.float32)
        q[: len(queries)] = queries
        return self._to_dev(q)

    def search_topk_hybrid(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        vec_rows,                 # VectorIndex.flat_device_rows() tuple
        queries: np.ndarray,      # f32[B, dim] L2-normalized query vectors
        similarities: Sequence[float],
        exact: bool = False,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key=None,
        rescale: Optional[Tuple[float, float]] = None,
        with_bitmap: bool = False,
    ) -> Tuple[np.ndarray, ...]:
        """Fused hybrid over the flat bf16 vector slab. Champion slots of
        the plans are not read (the read side plans this path ranged)."""
        pb, args, has_mask, has_omc = self._fused_args(
            index, plans, n_docs, cap, doc_masks, thresholds, omc, omc_key,
            similarities,
        )
        out = hybrid_search_topk_packed(
            *args[:7], *vec_rows, self._query_rows(queries, pb), *args[7:],
            lr=pb.LRb, exact=exact, cap=pb.capb,
            k=min(round_up_pow2(k, 8), pb.capb),
            has_mask=has_mask, has_omc=has_omc, with_bitmap=with_bitmap,
            **_rescale_kw(rescale),
        )
        return self._results(out, pb, k, cap, with_bitmap)

    def search_topk_hybrid_int8(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        vec_int8,                 # VectorIndex.int8_device_rows() tuple
        queries: np.ndarray,      # f32[B, dim] L2-normalized query vectors
        similarities: Sequence[float],
        exact: bool = False,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key=None,
        rescale: Optional[Tuple[float, float]] = None,
        candidates: Optional[int] = None,  # V rows per query (default 256)
        with_bitmap: bool = False,
    ) -> Tuple[np.ndarray, ...]:
        """Fused hybrid over the int8/IVF vector layout: the vector side
        probes the top-nprobe cluster units for top-V candidate rows,
        scatter-maxed onto the dense doc space. Champion slots of the
        plans replace heavy terms' posting scans."""
        pb, args, has_mask, has_omc = self._fused_args(
            index, plans, n_docs, cap, doc_masks, thresholds, omc, omc_key,
            similarities,
        )
        *layout, window, nprobe = vec_int8
        champs_dev, ch_idx, ch_w = self._champ_args(index, pb)
        out = hybrid_search_topk_packed_int8(
            *args[:7], *layout, self._query_rows(queries, pb), *args[7:],
            champs_dev, ch_idx, ch_w,
            lr=pb.LRb, exact=exact, cap=pb.capb,
            k=min(round_up_pow2(k, 8), pb.capb),
            V=_ivf_candidates(candidates, int(layout[0].shape[0])),
            nprobe=nprobe, window=window,
            has_mask=has_mask, has_omc=has_omc,
            has_champ=champs_dev is not None,
            with_bitmap=with_bitmap, **_rescale_kw(rescale),
        )
        return self._results(out, pb, k, cap, with_bitmap)

    def search_topk_hybrid_int8_pruned(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        vec_int8,                 # VectorIndex.int8_device_rows() tuple
        doc2row,                  # int32[capb + 1] doc -> packed row, device
        queries: np.ndarray,      # f32[B, dim] L2-normalized
        similarities: Sequence[float],
        exact: bool = False,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key=None,
        rescale: Optional[Tuple[float, float]] = None,
        candidates: Optional[int] = None,  # V rows per query (default 256)
        mask: Optional[np.ndarray] = None,
        mask_key=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pruned hybrid over the int8 IVF layout, for corpora past the
        dense tier: the full-text top-C candidates united with the IVF
        probe's top-V docs, both sides scored exactly on that set and fused
        by min-max (ops/pruned.py). Routes as `search_topk_pruned`: v4
        (`rescore_bsearch`, in chunks of `_pruned_bs_chunk` queries) for
        unfiltered, non-exact, single-span searches, v3
        (`rescore_worklist`) otherwise. `mask` filters every plan; a mask
        of at most PRUNED_CANDIDATES docs is the candidate set itself, so
        both sides and the counts are exact over it. Returns (vals f32[B,
        k], ids int32[B, k], counts int32[B])."""
        slab = self._get_device_slab(index)
        B = len(plans)
        capb = round_up_pow2(cap, 128)
        (pre_idesc, pre_fdesc, wl_i, wl_f, idf, nd, thr, dfs, lp, Tb,
         wl_prev, nre, bs_steps) = (
            self._pruned_host_inputs(plans, n_docs, thresholds)
        )
        *layout, window, nprobe = vec_int8
        V = _ivf_candidates(candidates, int(layout[0].shape[0]))
        # no small-corpus clamp here, as in the JAX executor
        C = self.PRUNED_CANDIDATES
        has_omc = omc is not None
        if has_omc:
            omc_dev = self._get_device_omc(omc, omc_key, capb)
        else:
            omc_dev = torch.ones((1,), dtype=torch.float32, device=self.device)
        Bb = idf.shape[0]
        has_filter = mask is not None
        fmask_dev = None
        cand_in = None
        cand_given = False
        sel = None
        if has_filter:
            fmask_dev, cand_in, cand_given, sel = self._pruned_mask_inputs(
                mask, mask_key, cap, capb, Bb, C
            )
        Ct = C if cand_given else C + V
        q = np.zeros((Bb, queries.shape[1]), np.float32)
        q[: len(queries)] = queries
        sims = np.zeros((Bb,), np.float32)
        sims[: len(similarities)] = similarities
        use_bs = (
            self.PRUNED_BS and not exact and not has_filter and nre == 0
        )
        S = self._pruned_bs_chunk(plans) if use_bs else B
        if B > S:
            parts = [
                self.search_topk_hybrid_int8_pruned(
                    index, plans[i:i + S], n_docs[i:i + S], cap, k,
                    vec_int8, doc2row, queries[i:i + S],
                    similarities[i:i + S], exact=exact,
                    thresholds=(
                        thresholds[i:i + S] if thresholds is not None
                        else None
                    ),
                    omc=omc, omc_key=omc_key, rescale=rescale,
                    candidates=candidates,
                )
                for i in range(0, B, S)
            ]
            return (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
            )
        dev = self._to_dev
        vkw = dict(V=V, nprobe=nprobe, window=window, **_rescale_kw(rescale))
        if use_bs:
            rng_i, rng_f, rbs_steps = self._pruned_bs_inputs(plans)
            bflat, bbase, bshift, rbs_steps = self._pruned_bs_boff(
                index, rng_i, capb, rbs_steps
            )
            if self.PRUNED_BS_ACCUM:
                Cb = min(self.PRUNED_BS_C, round_up_pow2(cap, 8))
            else:
                Cb = pre_idesc.shape[2] * pre_idesc.shape[3] * \
                    self.PRUNED_BS_HP
            kb = min(round_up_pow2(k, 8), Cb + V)
            vals, ids, cand_counts = pruned_hybrid_topk_int8_bs(
                slab.doc, slab.tf, slab.flen,
                dev(pre_idesc[0]), dev(pre_idesc[1]), dev(rng_i), dev(rng_f),
                dev(idf), dev(thr), *layout, doc2row, dev(q), dev(sims),
                omc_dev, None,
                dev(pre_fdesc) if self.PRUNED_BS_ACCUM else None,
                (bflat, dev(bbase), dev(bshift))
                if bflat is not None else None,
                hp=self.PRUNED_BS_HP, cap=capb, k=kb, bs_steps=rbs_steps,
                has_omc=has_omc, nom_accum=self.PRUNED_BS_ACCUM,
                lp=lp if self.PRUNED_BS_ACCUM else 0,
                C=Cb if self.PRUNED_BS_ACCUM else 0, **vkw,
            )
        else:
            kb = min(round_up_pow2(k, 8), Ct)
            vals, ids, cand_counts = pruned_hybrid_topk_int8(
                slab.doc, slab.tf, slab.exact_tf, slab.flen,
                dev(pre_idesc), dev(pre_fdesc), dev(wl_i), dev(wl_f),
                dev(idf), dev(nd), dev(thr), *layout, doc2row, dev(q),
                dev(sims), omc_dev,
                dev(wl_prev) if wl_prev is not None else None,
                fmask_dev, cand_in,
                lp=lp, lch=self.PRUNED_LCH, cap=capb, C=C, k=kb, T=Tb,
                exact=exact, has_omc=has_omc, nre=nre, bs_steps=bs_steps,
                has_filter=has_filter, cand_given=cand_given,
                fbits=(self._get_device_fbits(fmask_dev, mask_key, capb)
                       if has_filter else None),
                **vkw,
            )
        cand_counts = cand_counts[:B].cpu().numpy()
        if cand_given:
            counts = cand_counts
        else:
            sel_frac = 1.0
            if sel is not None:
                sel_frac = sel / max(float(nd[0]), 1.0)
            counts = self._pruned_counts(
                cand_counts, dfs, nd, thresholds, B, sel_frac=sel_frac
            )
        return (
            vals[:B, :k].cpu().numpy(),
            ids[:B, :k].cpu().numpy(),
            counts,
        )


SHARED_LENGTH_CLASSES = (1024, 16384, 131072)
SHARED_CHUNK_BY_CLASS = {1024: 64, 16384: 16, 131072: 8}


def _split_range(ranges, start, length, w, fb, avg):
    """Append (start, length) cut into pieces of at most MAX_RANGE_LEN."""
    while length > MAX_RANGE_LEN:
        ranges.append((start, MAX_RANGE_LEN, w, fb, avg))
        start += MAX_RANGE_LEN
        length -= MAX_RANGE_LEN
    ranges.append((start, length, w, fb, avg))


def analyze_shared_batch(
    index: StringIndex,
    tokens_per_query: Sequence[Sequence[str]],
    properties: Sequence[str],
    boost: Dict[str, float],
    field_params: Optional[Dict[str, Tuple[float, float]]],
    exact: bool,
    tolerance: Optional[int],
    impact_cap: Optional[int],
    use_champions: bool = True,
    token_weight_of: Optional[Dict[str, float]] = None,
):
    """Host-side analysis of a batch: dedup the batch's tokens, resolve
    posting ranges, route fully-champion-covered tokens (optional), and
    partition the rest into range-length classes. Returns
    (u_ranges, u_champs, token_map_global (B, T), classes, B, T)."""
    B = len(tokens_per_query)
    flat: List[str] = []
    q_lens = np.empty(B, np.int32)
    for b, toks in enumerate(tokens_per_query):
        q_lens[b] = len(toks)
        flat.extend(toks)
    T = max(1, int(q_lens.max()) if B else 1)
    uniq_arr, inverse = np.unique(np.asarray(flat, dtype=str), return_inverse=True)
    token_map_global = np.full((B, T), -1, np.int32)
    rows = np.repeat(np.arange(B, dtype=np.int32), q_lens)
    q_starts = (np.cumsum(q_lens, dtype=np.int64) - q_lens).astype(np.int32)
    cols = (
        np.arange(int(q_lens.sum()), dtype=np.int32)
        - np.repeat(q_starts, q_lens)
    )
    token_map_global[rows, cols] = inverse.astype(np.int32)

    u_ranges: List[List[Tuple[int, int, float, float, float]]] = []
    u_champs: List[Optional[List[Tuple[int, float]]]] = []
    tol = 0 if exact else tolerance
    for tok in uniq_arr.tolist():
        ranges: List[Tuple[int, int, float, float, float]] = []
        champ_slots: List[Tuple[int, float]] = []
        champ_covers: List[frozenset] = []
        for path in properties:
            stats = index._stats.get(path)
            if stats is None or stats.doc_count == 0:
                continue
            fw, fb = (field_params or {}).get(path, (1.0, DEFAULT_B))
            w = boost.get(path, 1.0) * fw
            if token_weight_of:
                w *= token_weight_of.get(tok, 1.0)
            avg = stats.avg_len or 1.0
            champ_skip = None
            if use_champions and not exact and not tol:
                ci = index._champ_map.get((path, tok))
                if ci is not None and abs(fb - DEFAULT_B) < 1e-9:
                    c_avg, covered = index._champ_meta[ci]
                    if abs(c_avg - avg) < 1e-6 * max(avg, 1.0):
                        champ_slots.append((ci, w))
                        champ_skip = covered
                        champ_covers.append(covered)
            for (start, length) in index._match_terms(path, tok, tol):
                if champ_skip is not None and \
                        (start, length) in champ_skip:
                    continue
                if impact_cap is not None and length > impact_cap:
                    length = impact_cap
                _split_range(ranges, start, length, w, fb, avg)
        if champ_slots and ranges:
            # partial coverage: revert champions to their ranges
            for covered, (ci, w) in zip(champ_covers, champ_slots):
                avg_c = index._champ_meta[ci][0]
                for (c_start, c_len) in covered:
                    length = c_len
                    if impact_cap is not None and length > impact_cap:
                        length = impact_cap
                    _split_range(ranges, c_start, length, w, DEFAULT_B, avg_c)
            champ_slots = []
        u_ranges.append(ranges)
        u_champs.append(champ_slots or None)

    classes: Dict[int, List[int]] = {c: [] for c in SHARED_LENGTH_CLASSES}
    for ui, ranges in enumerate(u_ranges):
        if u_champs[ui] is not None:
            continue  # champion class handles this token
        ml = max((l for (_, l, *_rest) in ranges), default=0)
        for c in SHARED_LENGTH_CLASSES:
            if ml <= c:
                classes[c].append(ui)
                break
    return u_ranges, u_champs, token_map_global, classes, B, T


def touched_pairs(tmap, n_rows, cu):
    """The (query, chunk) pairs whose rows `assign_rows_accumulate`
    updates: queries with a slot in [0, n_rows) of the local map `tmap`,
    counted once per chunk of cu rows that their slots fall in."""
    chunk = np.where((tmap >= 0) & (tmap < n_rows), tmap // cu, -1)
    chunk.sort(axis=1)
    first = np.ones(chunk.shape, bool)
    first[:, 1:] = chunk[:, 1:] != chunk[:, :-1]
    return int(np.count_nonzero(first & (chunk >= 0)))


def pack_shared_class(u_ranges, uids, token_map_global, B, T, cu):
    """Padded per-class descriptor arrays for the shared kernels:
    (st, ln, wt, fb, av (Up, NRb), tmap (B, T), lrb). Query slots whose
    token is not in the class map to the sentinel Up."""
    Up = max(cu, ((len(uids) + cu - 1) // cu) * cu)
    NR = max(1, max(len(u_ranges[u]) for u in uids))
    NRb = round_up_pow2(NR, 1)
    st = np.zeros((Up, NRb), np.int32)
    ln = np.zeros((Up, NRb), np.int32)
    wt = np.zeros((Up, NRb), np.float32)
    fb = np.full((Up, NRb), 0.75, np.float32)
    av = np.ones((Up, NRb), np.float32)
    local_of = {}
    for li, ui in enumerate(uids):
        local_of[ui] = li
        for ri, (s0, l0, w0, b0, a0) in enumerate(u_ranges[ui][:NRb]):
            st[li, ri] = s0
            ln[li, ri] = l0
            wt[li, ri] = w0
            fb[li, ri] = b0
            av[li, ri] = a0
    n_glob = int(token_map_global.max()) + 1 if token_map_global.size else 0
    lut = np.full(max(n_glob, 1) + 1, Up, np.int32)  # last slot: g == -1
    for ui, li in local_of.items():
        if ui < n_glob:
            lut[ui] = li
    tmap = lut[token_map_global]  # -1 indexes the sentinel last slot
    lrb = round_up_pow2(max(1, int(ln.max())), 8)
    return st, ln, wt, fb, av, tmap, int(lrb)


class SharedBatchExecutor(StringSearchTopK):
    """Term-deduplicated batched scoring: each unique query token is
    scored once into a dense per-token row, and a kernel adds each
    query's own term rows into its score and match-count rows
    (`ops/assign_rows.py`, where the JAX package runs a (B, U)
    assignment matmul).
    Exact, with or without per-query filters. Unique tokens are
    partitioned into range-length classes, scored in chunks of rows."""

    LENGTH_CLASSES = SHARED_LENGTH_CLASSES
    CHUNK_BY_CLASS = SHARED_CHUNK_BY_CLASS

    def search_topk_shared(
        self,
        index: StringIndex,
        tokens_per_query: Sequence[Sequence[str]],
        properties: Sequence[str],
        boost: Dict[str, float],
        n_docs: float,
        cap: int,
        k: int,
        thresholds: Optional[Sequence[float]] = None,
        exact: bool = False,
        tolerance: Optional[int] = None,
        impact_cap: Optional[int] = None,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
        field_params: Optional[Dict[str, Tuple[float, float]]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key=None,
        vec_rows=None,                 # hybrid: flat_device_rows() tuple
        queries: Optional[np.ndarray] = None,   # hybrid: f32[B, dim]
        similarities: Optional[Sequence[float]] = None,
        rescale: Optional[Tuple[float, float]] = None,
        vec_rows_int8=None,            # hybrid: int8_device_rows() tuple
        candidates: Optional[int] = None,       # int8 tail: V per query
        token_weight_of: Optional[Dict[str, float]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        hybrid = vec_rows_int8 is not None or vec_rows is not None
        with span("exec.shared", batch=len(tokens_per_query), hybrid=hybrid):
            slab = self._get_device_slab(index)
            capb = round_up_pow2(cap, 128)
            nd = max(float(n_docs), 1.0)

            # champion tokens: FULLY covered by precomputed dense rows (any
            # live/uncovered range falls the whole token back to ranged
            # scanning, keeping matched-token counts exact)
            with span("exec.analyze") as sp:
                u_ranges, u_champs, token_map_global, classes, B, T = (
                    analyze_shared_batch(
                        index, tokens_per_query, properties, boost,
                        field_params, exact, tolerance, impact_cap,
                        token_weight_of=token_weight_of,
                    )
                )
                sp.fields.update(
                    terms=len(u_ranges),
                    champion_terms=len(u_champs) - u_champs.count(None),
                )

            has_masks = doc_masks is not None and any(
                m is not None for m in doc_masks
            )
            mask_dev = None
            if has_masks:
                with span("exec.pack"):
                    masks = np.ones((B, capb), bool)
                    for i, m in enumerate(doc_masks):
                        if m is not None:
                            masks[i, : len(m)] = m
                            masks[i, len(m):] = False
                (mask_dev,) = self._upload(masks)

            scores = torch.zeros((B, capb), dtype=torch.float32, device=self.device)
            matched = torch.zeros((B, capb), dtype=torch.float32, device=self.device)

            for lr_class, uids in classes.items():
                if not uids:
                    continue
                cu = self.CHUNK_BY_CLASS[lr_class]
                chunks = max(1, -(-len(uids) // cu))
                with span("exec.pack", lr_class=lr_class, tokens=len(uids),
                          chunks=chunks) as sp:
                    st, ln, wt, fb, av, tmap, lrb = pack_shared_class(
                        u_ranges, uids, token_map_global, B, T, cu
                    )
                    # counted from the packed lengths: a pass over the
                    # analysis' range lists costs more than all the spans
                    sp.fields.update(ranges=int(np.count_nonzero(ln)),
                                     postings=int(ln.sum()))
                    pairs = touched_pairs(tmap, len(uids), cu)
                desc = self._upload(st, ln, wt, fb, av, tmap)
                with span("exec.score", device=self.device, lr_class=lr_class,
                          chunks=chunks, pairs=pairs):
                    if has_masks:
                        bm25_shared_partial_masked(
                            *slab, *desc, mask_dev, nd, scores, matched,
                            lr=lrb, cap=capb, cu=cu, exact=exact,
                        )
                    else:
                        bm25_shared_partial(
                            *slab, *desc, nd, scores, matched,
                            lr=lrb, cap=capb, cu=cu, exact=exact,
                        )

            # ---- champion class: dense rows, zero posting gathers ----------
            champ_uids = [ui for ui, c in enumerate(u_champs) if c]
            if champ_uids:
                champs_dev = self._get_device_champs(index, capb)
                with span("exec.pack", lr_class="champion",
                          tokens=len(champ_uids), chunks=1):
                    NC = max(len(u_champs[ui]) for ui in champ_uids)
                    ch_rows = np.full((len(champ_uids), NC), -1, np.int32)
                    ch_w = np.zeros((len(champ_uids), NC), np.float32)
                    for ei, ui in enumerate(champ_uids):
                        for cj, (ci, w) in enumerate(u_champs[ui]):
                            ch_rows[ei, cj] = ci
                            ch_w[ei, cj] = w
                    # one chunk: the queries with a champion slot
                    pairs = int(np.isin(token_map_global, champ_uids)
                                .any(axis=1).sum())
                args = (champs_dev, *self._upload(
                    ch_rows, ch_w, np.asarray(champ_uids, np.int32),
                    token_map_global,
                ))
                with span("exec.score", device=self.device,
                          lr_class="champion", chunks=1, pairs=pairs):
                    if has_masks:
                        bm25_shared_champions_masked(
                            *args, mask_dev, nd, scores, matched
                        )
                    else:
                        bm25_shared_champions(*args, nd, scores, matched)

            with span("exec.pack"):
                thr = np.zeros((B,), np.float32)
                if thresholds is not None:
                    for i, t in enumerate(thresholds):
                        thr[i] = t or 0.0
            has_omc = omc is not None
            if has_omc:
                omc_dev = self._get_device_omc(omc, omc_key, capb)
            else:
                omc_dev = torch.ones((capb,), dtype=torch.float32, device=self.device)
            kb = min(round_up_pow2(k, 8), capb)
            if hybrid:
                # batched-hybrid tail: vector side + min-max fusion + OMC +
                # top-k (ops/hybrid.py)
                thr_dev, q_dev, sim_dev = self._upload(
                    thr, np.asarray(queries, np.float32),
                    np.asarray(similarities, np.float32),
                )
                tail = (scores, matched, thr_dev)
                q_sim = (q_dev, sim_dev, mask_dev, omc_dev)
                kw = dict(cap=capb, k=kb, has_mask=has_masks, has_omc=has_omc,
                          **_rescale_kw(rescale))
                rows = (vec_rows_int8 if vec_rows_int8 is not None
                        else vec_rows)[0].shape[0]
                with span("exec.tail", device=self.device, k=kb, rows=int(rows)):
                    if vec_rows_int8 is not None:
                        *layout, window, nprobe = vec_rows_int8
                        vals, idx, counts = hybrid_finalize_topk_int8(
                            *tail, *layout, *q_sim,
                            V=_ivf_candidates(candidates, int(rows)),
                            nprobe=nprobe, window=window, **kw,
                        )
                    else:
                        vals, idx, counts = hybrid_finalize_topk(
                            *tail, *vec_rows, *q_sim, **kw,
                        )
            else:
                (thr_dev,) = self._upload(thr)
                with span("exec.tail", device=self.device, k=kb, rows=0):
                    vals, idx, counts = finalize_topk(
                        scores, matched, thr_dev, omc_dev, k=kb
                    )
            with span("exec.download") as sp:
                out = (
                    vals[:, :k].cpu().numpy(),
                    idx[:, :k].cpu().numpy(),
                    counts[:B].cpu().numpy(),
                )
                sp.fields["bytes"] = sum(a.nbytes for a in out)
            return out

    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host arrays to the device, as one `exec.upload` span. The
        copies are blocking, so the first waits for the device to finish
        what was queued; while tracing, that wait is an `exec.drain`
        span of its own, and `exec.upload` times the copies alone."""
        if tracing():
            with span("exec.drain"):
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
        with span("exec.upload", copies=len(arrays)) as sp:
            out = [self._to_dev(a) for a in arrays]
            sp.fields["bytes"] = sum(t.nbytes for t in out)
        return out
