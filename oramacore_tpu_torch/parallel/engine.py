"""Doc-id-sharded ENGINE search over a device mesh (the port of
`oramacore_tpu/parallel/engine.py`).

A real committed StringIndex is partitioned by doc id across the shards
of a `ShardMesh` (parallel/mesh.py) at slab-build time, and each search
runs as ONE mesh step: a body a shard, with the collectives of JAX's
`shard_map` steps at the same places:

    shard assignment  doc -> shard = doc % D, local slot = doc // D
                      (global id reconstructs as slot * D + shard)
    per shard         BM25F over the local postings shard (every posting
                      of a doc lives in its shard, so TF / length terms
                      are shard-local), by the same kernels as one device
    collectives       psum of per-token df (global IDF), psum of match
                      counts, pmax of a hybrid's fusion span, all_gather
                      of per-shard top-k + final top-k

Each `_get_*_step` returns the body of the JAX step of the same name,
line for line; `search_*` packs the host arrays, places them (a shard's
slice on its device, `Sharded`; a replicated array once a device) and
runs the step. The local and merged top-k select in `lax.top_k`'s order
(`top_k_by_key`): among equal scores the lower index first, so the merge
over the gathered (B, D * k) row keeps the lower shard. The shard layout
is DERIVED from the committed slab (a vectorized O(P) partition), so
snapshots stay layout-independent: the same index loads on any mesh.

The read side (read/__init__.py) builds these executors when
`reader_side.sharded_shards` > 1: `ShardedStringExec` per index (its
`_fused_executor`), one `ShardedBatchExec` for batches.
"""

from __future__ import annotations

import threading
import time
from itertools import chain
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.search_exec import (
    HYBRID_INT8_CANDIDATES,
    SHARED_CHUNK_BY_CLASS,
    DeviceLru,
    PrunedPlanMixin as PM,
    _MISS,
    analyze_shared_batch,
    pack_shared_class,
)
from ..index.string_index import QueryPlan, StringIndex
from ..index import vector_index as _vi
from ..ops.bm25 import (
    MAX_RANGE_LEN,
    NEG_F32,
    _packbits,
    bm25_score_batch,
    bm25_shared_partial,
    bm25_shared_partial_masked,
    round_up_pow2,
)
from ..ops.facet_hist import facet_hist, facet_hist_multi, row_ptr_table
from ..ops.hybrid import _rescale, _scatter_max, _vector_dense_scores
from ..ops.pruned import (
    NEG_INF,
    _candidate_vec,
    _dedup_sorted,
    _exact_counts_core,
    _lower_bound,
    _match_reps_core,
    _prefix_candidates,
    _sliced_candidates,
    _vec_reps_core,
    rescore_bsearch,
    rescore_worklist,
)
from ..ops.vector import (
    _SCAN_ELEMS,
    _bf16,
    _carry,
    _int8_window_score,
    _probe_units,
    _top_k,
    top_k_by_key,
)
from .mesh import Sharded, ShardMesh, default_devices

INF = float("inf")


def build_engine_mesh(n_shards: int, devices=None) -> ShardMesh:
    devices = list(devices) if devices is not None else default_devices()
    assert len(devices) >= n_shards, (
        f"sharded_shards={n_shards} but only {len(devices)} devices"
    )
    return ShardMesh(devices[:n_shards])


def _merge_topk(ax, s, k: int, ids_of=None):
    """Local top-k of s f32[B, n] (global ids local * D + shard, or
    ids_of(local index) * D + shard), all_gather over the mesh, top-k of
    the (B, D * k) row: (vals f32[B, k], ids int32[B, k])."""
    D, sid = ax.size, ax.index
    B = s.shape[0]
    local_vals, local_idx = top_k_by_key(s, k)
    local = local_idx if ids_of is None else ids_of(local_idx)
    local_ids = (local * D + sid).to(torch.int32)
    all_vals = ax.all_gather(local_vals, axis=1).reshape(B, D * k)
    all_ids = ax.all_gather(local_ids, axis=1).reshape(B, D * k)
    vals, sel = top_k_by_key(all_vals, k)
    return vals, all_ids.gather(1, sel)


def _owned_probe(ax, queries, mat_l, sc_l, doc_l, unit_cen, owner,
                 unit_local, *, V: int, nprobe: int, window: int):
    """The IVF probe on the unit-partitioned int8 layout: every shard
    picks the SAME top-nprobe units (the centroids replicate), scans the
    windows of the units it owns, and keeps its top-V rows in scan order
    (one stable top-k over [V empty slots, window 0, window 1, ...], as
    JAX's scan with a top-k merge a window gives). Returns (vals f32[B,
    V], docs int32[B, V]: the rows' global doc ids, -1 for empty slots)."""
    B = queries.shape[0]
    dev = mat_l.device
    nloc, dim = mat_l.shape
    probes = _probe_units(queries, unit_cen, nprobe)           # (B, P)
    P = probes.shape[1]
    own = (owner[probes] == ax.index).reshape(-1)
    j = unit_local[probes].long().reshape(-1)
    start = (j * window).clamp(max=nloc - window).clamp(min=0)
    q = _bf16(queries)
    qidx = torch.arange(B, device=dev).repeat_interleave(P)
    iota = torch.arange(window, device=dev)
    s = torch.empty((B * P, window), dtype=torch.float32, device=dev)
    step = max(1, _SCAN_ELEMS // (window * dim))
    for m0 in range(0, B * P, step):
        m = slice(m0, min(m0 + step, B * P))
        idx = start[m, None] + iota
        sm, keep = _int8_window_score(mat_l, sc_l, q[qidx[m]], idx)
        s[m] = sm.masked_fill_(~(keep & own[m, None]), NEG_INF)
    rows = (start[:, None] + iota).view(B, P * window)
    init_v, init_r = _carry(B, V, dev)
    vals, sel = _top_k(torch.cat([init_v, s.view(B, P * window)], dim=1), V)
    docs = torch.cat([init_r, doc_l[rows.clamp(max=nloc - 1)]], dim=1)
    return vals, docs.gather(1, sel)


class ShardedStringExec:
    """Doc-sharded executor with the same search_topk contract as the
    single-device StringSearchTopK: (vals f32[B, k], GLOBAL ids int32[B,
    k], counts int32[B])."""

    # a sharded executor may serve several indexes (multi-index batch
    # loops); keep a couple of sharded slabs resident instead of
    # re-partitioning per index per batch
    MAX_CACHED = 2

    def __init__(self, mesh: ShardMesh):
        self.mesh = mesh
        self.D = int(mesh.shape["d"])
        # (uid, gen) -> (sharded slab 4-tuple, boundaries, bprefix), with
        # the BOUNDARY-indexed shard prefix: bprefix[s, i] = # postings
        # with shard == s before boundary i (plans only reference stored
        # range boundaries and their MAX_RANGE_LEN split grid)
        self._slabs = DeviceLru(self.MAX_CACHED, group=lambda k: k[0])
        # vector layouts: flat (uid, gen) / int8 ("i8", uid, gen)
        self._vecs = DeviceLru(
            2 * self.MAX_CACHED,
            group=lambda k: (k[0], k[1]) if isinstance(k[0], str)
            else ("flat", k[0]),
        )
        self._lock = threading.Lock()
        # doc-sharded filter masks and sort / group / facet columns keyed
        # by the caller; group strips the trailing version
        self._fmask_dev = DeviceLru(
            8,
            group=lambda k: (
                k[0][:-1] if isinstance(k[0], tuple) else k[0]
            ),
        )
        # seconds the last slab partition took on the host
        self.last_partition_s = 0.0

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _put(self, arr) -> Sharded:
        """[D, ...] host array: shard s's slice on its device."""
        return self.mesh.shard(np.ascontiguousarray(arr))

    def _rep(self, arr) -> Sharded:
        """A host array replicated on every shard's device."""
        return self.mesh.replicate(np.ascontiguousarray(arr))

    # ------------------------------------------------------------------
    # Sharded slab build (at commit / generation change)
    # ------------------------------------------------------------------

    def ensure_slab(self, index: StringIndex):
        """Partition + upload the index's slab (cached); returns
        (sharded slab 4-tuple, boundaries, bprefix) for this index."""
        gen = (index.uid, index.generation)
        cached = self._slabs.get(gen)
        if cached is not _MISS:
            return cached
        with self._lock:  # one thread partitions; others wait
            cached = self._slabs.get(gen)
            if cached is not _MISS:
                return cached
            t0 = time.perf_counter()
            p_doc, p_tf, p_etf, p_flen = index.slab()
            D = self.D
            P_total = len(p_doc)
            shard = (p_doc.astype(np.int64) % D).astype(np.int32)
            counts = np.bincount(shard, minlength=D)
            # boundary set: every stored range start and end, the
            # MAX_RANGE_LEN split grid inside over-long ranges, and the
            # slab's ends (the (start, len) pairs flattened in C, not
            # walked pair by pair: millions of them at 262,144 docs)
            flat = np.fromiter(
                chain.from_iterable(chain.from_iterable(
                    index.all_range_lists())), np.int64)
            rs, rl = flat[0::2], flat[1::2]
            grid = [np.arange(s0 + MAX_RANGE_LEN, s0 + n, MAX_RANGE_LEN)
                    for s0, n in zip(rs[rl > MAX_RANGE_LEN].tolist(),
                                     rl[rl > MAX_RANGE_LEN].tolist())]
            boundaries = np.unique(np.concatenate(
                [np.array([0, P_total], np.int64), rs, rs + rl, *grid]))
            # bprefix[s, i]: postings of shard s before boundary i, by a
            # binary search of each boundary in the shard's positions
            bprefix = np.stack([
                np.searchsorted(np.flatnonzero(shard == s), boundaries)
                for s in range(D)
            ]).astype(np.int64)
            max_p = int(counts.max()) if P_total else 1
            Pb = round_up_pow2(max(max_p, 1), 1024) + MAX_RANGE_LEN
            docs_l = np.zeros((D, Pb), np.int32)
            tf_l = np.zeros((D, Pb), np.float32)
            etf_l = np.zeros((D, Pb), np.float32)
            flen_l = np.ones((D, Pb), np.float32)
            for s in range(D):
                sel = shard == s
                n = int(counts[s])
                docs_l[s, :n] = (p_doc[sel].astype(np.int64) // D).astype(
                    np.int32
                )
                tf_l[s, :n] = p_tf[sel]
                etf_l[s, :n] = p_etf[sel]
                flen_l[s, :n] = p_flen[sel]
            dev = tuple(self._put(a) for a in (docs_l, tf_l, etf_l, flen_l))
            self.last_partition_s = time.perf_counter() - t0
            return self._slabs.put(gen, (dev, boundaries, bprefix))

    @staticmethod
    def _shard_ranges_on(boundaries, bprefix, D,
                         starts: np.ndarray, lens: np.ndarray):
        """Map global (..., ) ranges onto per-shard local sub-ranges ->
        (D, ...) starts / lens. Plan offsets must land on stored
        boundaries (range starts / ends + the MAX_RANGE_LEN split grid);
        a non-boundary offset (an impact_cap truncation) raises, so
        callers disable impact_cap on the mesh."""
        shape = starts.shape
        st = starts.reshape(-1).astype(np.int64)
        en = st + lens.reshape(-1).astype(np.int64)
        bi = np.searchsorted(boundaries, st)
        be = np.searchsorted(boundaries, en)
        if not (
            np.all(np.take(boundaries, np.minimum(
                bi, len(boundaries) - 1)) == st)
            and np.all(np.take(boundaries, np.minimum(
                be, len(boundaries) - 1)) == en)
        ):
            raise ValueError(
                "sharded plan offsets must align to stored range "
                "boundaries (is impact_cap enabled on a mesh?)"
            )
        s_st = bprefix[:, bi]                        # (D, n)
        s_ln = bprefix[:, be] - s_st
        return (
            s_st.reshape((D,) + shape).astype(np.int32),
            s_ln.reshape((D,) + shape).astype(np.int32),
        )

    # ------------------------------------------------------------------
    # Host packing shared by the dense steps
    # ------------------------------------------------------------------

    def _dense_inputs(self, index, plans, n_docs, cap, k, doc_masks,
                      thresholds, omc):
        """(slab, per-shard starts / lens, replicated descriptors, lr,
        cap_l, kb, has_mask, mask, has_omc, omc) of a dense mesh step."""
        dev_slab, boundaries, bprefix = self.ensure_slab(index)
        D = self.D
        B = len(plans)
        Tb = round_up_pow2(max(p.starts.shape[0] for p in plans), 1)
        NRb = round_up_pow2(max(p.starts.shape[1] for p in plans), 1)
        g_starts = np.zeros((B, Tb, NRb), np.int32)
        g_lens = np.zeros((B, Tb, NRb), np.int32)
        weights = np.zeros((B, Tb, NRb), np.float32)
        field_b = np.full((B, Tb, NRb), 0.75, np.float32)
        avg = np.ones((B, Tb, NRb), np.float32)
        nd = np.ones((B,), np.float32)
        thr = np.zeros((B,), np.float32)
        for i, p in enumerate(plans):
            t, r = p.starts.shape
            g_starts[i, :t, :r] = p.starts
            g_lens[i, :t, :r] = p.lens
            weights[i, :t, :r] = p.weights
            field_b[i, :t, :r] = p.field_b
            avg[i, :t, :r] = p.avg_flen
            nd[i] = max(float(n_docs[i]), 1.0)
            if thresholds is not None and thresholds[i]:
                thr[i] = thresholds[i]
        s_starts, s_lens = self._shard_ranges_on(
            boundaries, bprefix, D, g_starts, g_lens
        )
        lr = round_up_pow2(max(int(s_lens.max()), 1), 8)
        cap_l = round_up_pow2((cap + D - 1) // D, 128)
        kb = min(round_up_pow2(k, 8), cap_l)
        has_mask = doc_masks is not None and any(
            m is not None for m in doc_masks
        )
        mask_arr = None
        if has_mask:
            gm = np.ones((B, cap), bool)
            for i, m in enumerate(doc_masks):
                if m is not None:
                    gm[i, : len(m)] = m
                    gm[i, len(m):] = False
            # padding slots (global id >= cap) stay False
            mask_arr = self._put(self._partition_docs_axis(gm, cap_l, False))
        has_omc = omc is not None
        omc_arr = None
        if has_omc:
            go = np.ones((cap,), np.float32)
            go[: min(len(omc), cap)] = omc[:cap]
            omc_arr = self._put(
                self._partition_docs_axis(go, cap_l, np.float32(1.0)))
        desc = tuple(self._rep(a) for a in (weights, field_b, avg, nd, thr))
        return (dev_slab, self._put(s_starts), self._put(s_lens), desc,
                int(lr), int(cap_l), int(kb), has_mask, mask_arr, has_omc,
                omc_arr, B)

    # ------------------------------------------------------------------
    # Sharded steps (bodies of JAX's shard_map steps)
    # ------------------------------------------------------------------

    def _get_step(self, *, lr, cap_l, k, exact, has_mask, has_omc,
                  with_bitmap=False):
        def shard_fn(ax, p_doc, p_tf, p_etf, p_flen, starts, lens,
                     weights, field_b, avg, n_docs, thr, mask, omc):
            scores, matched = bm25_score_batch(
                p_doc, p_tf, p_etf, p_flen, starts, lens, weights,
                field_b, avg, n_docs, mask if has_mask else None,
                lr=lr, exact=exact, cap=cap_l, axis=ax,
            )
            s = scores * omc[None, :] if has_omc else scores
            keep = (matched >= thr[:, None]) & (scores > 0.0)
            counts = ax.psum(keep.sum(dim=1, dtype=torch.int32))
            s = s.masked_fill(~keep, -INF)
            vals, ids = _merge_topk(ax, s, k)
            if with_bitmap:
                # per-shard packed match bits; the host reinterleaves
                # doc d = slot * D + shard
                return vals, ids, counts, _packbits(keep)
            return vals, ids, counts

        return shard_fn

    def _get_sorted_step(self, *, lr, cap_l, k, exact, has_mask,
                         has_omc, desc):
        D = self.D

        def shard_fn(ax, p_doc, p_tf, p_etf, p_flen, starts, lens,
                     weights, field_b, avg, n_docs, thr, mask, omc,
                     svals):
            B = weights.shape[0]
            scores, matched = bm25_score_batch(
                p_doc, p_tf, p_etf, p_flen, starts, lens, weights,
                field_b, avg, n_docs, mask if has_mask else None,
                lr=lr, exact=exact, cap=cap_l, axis=ax,
            )
            s = scores * omc[None, :] if has_omc else scores
            keep = (matched >= thr[:, None]) & (scores > 0.0)
            counts = ax.psum(keep.sum(dim=1, dtype=torch.int32))
            have = ~torch.isnan(svals)
            present = keep & have[None, :]
            key1 = torch.where(
                present, svals[None, :] if desc else -svals[None, :],
                NEG_F32,
            )
            v1, i1 = top_k_by_key(key1, k)
            sc1 = s.gather(1, i1)
            g1 = (i1 * D + ax.index).to(torch.int32)
            # fieldless matched tail, ordered by GLOBAL doc id
            iota = torch.arange(cap_l, device=s.device)
            gdoc = (iota * D + ax.index).to(torch.float32)
            key2 = torch.where(keep & ~have[None, :], -gdoc, NEG_F32)
            v2, i2 = top_k_by_key(key2, k)
            sc2 = s.gather(1, i2)
            g2 = (i2 * D + ax.index).to(torch.int32)

            def gather(a):
                return ax.all_gather(a, axis=1).reshape(B, D * k)

            return (gather(v1), gather(g1), gather(sc1),
                    gather(v2), gather(g2), gather(sc2), counts)

        return shard_fn

    def _get_grouped_step(self, *, lr, cap_l, k, G, R, exact,
                          has_mask, has_omc):
        """Fused GROUP-BY over the mesh: each shard scores its doc slice
        (psum'd df), sorts it by (gid, -score, global doc), slices its
        per-group first-R pages off the run starts, and the (B, G, D * R)
        gathered pages merge with one 2-key sort per group, so the final
        order is (-score, doc asc) globally, as on one device."""
        D = self.D

        def shard_fn(ax, p_doc, p_tf, p_etf, p_flen, starts, lens,
                     weights, field_b, avg, n_docs, thr, mask, omc, gid):
            B = weights.shape[0]
            scores, matched = bm25_score_batch(
                p_doc, p_tf, p_etf, p_flen, starts, lens, weights,
                field_b, avg, n_docs, mask if has_mask else None,
                lr=lr, exact=exact, cap=cap_l, axis=ax,
            )
            s = scores * omc[None, :] if has_omc else scores
            keep = (matched >= thr[:, None]) & (scores > 0.0)
            counts = ax.psum(keep.sum(dim=1, dtype=torch.int32))
            s = s.masked_fill(~keep, -INF)
            vals, ids = _merge_topk(ax, s, k)
            # ---- per-group pages: local 3-key sort + run slicing ----
            gidk = torch.where(keep & (gid[None, :] >= 0), gid[None, :], G)
            neg = torch.where(gidk < G, -s, INF)
            # lax.sort takes -0.0 == +0.0; a radix sort would not
            neg.masked_fill_(neg == 0, 0.0)
            # (gid, -score, doc): stable sorts over rows in doc order
            by_score = torch.sort(neg, dim=1, stable=True).indices
            gk, by_gid = torch.sort(gidk.gather(1, by_score), dim=1,
                                    stable=True)
            order = by_score.gather(1, by_gid)
            ns = neg.gather(1, order)
            dd = (order * D + ax.index).to(torch.int32)
            pos = torch.searchsorted(
                gk.contiguous(),
                torch.arange(G + 1, device=s.device, dtype=gk.dtype)
                .expand(B, G + 1).contiguous(),
            )
            g_start, g_end = pos[:, :G], pos[:, 1:]
            page_ix = g_start[:, :, None] + torch.arange(R, device=s.device)
            in_run = page_ix < g_end[:, :, None]
            clip = page_ix.clamp(max=cap_l - 1).reshape(B, G * R)
            pns = torch.where(in_run, ns.gather(1, clip).view(B, G, R), INF)
            pdd = torch.where(in_run, dd.gather(1, clip).view(B, G, R), 0)
            ans = ax.all_gather(pns, axis=2).reshape(B, G, D * R)
            add = ax.all_gather(pdd, axis=2).reshape(B, G, D * R)
            # 2-key sort (score, doc): stable sorts, doc first
            o1 = torch.sort(add, dim=2, stable=True).indices
            o2 = torch.sort(ans.gather(2, o1), dim=2, stable=True).indices
            order2 = o1.gather(2, o2)
            mns, mdd = ans.gather(2, order2), add.gather(2, order2)
            head_ns = mns[:, :, :R]
            fin = torch.isfinite(head_ns)
            gvals = torch.where(fin, -head_ns, -INF)
            gdocs = torch.where(fin, mdd[:, :, :R], 0)
            return vals, ids, counts, gvals, gdocs

        return shard_fn

    def search_topk_sorted(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        sort_vals: np.ndarray,
        sort_present: np.ndarray,
        svals_key,
        desc: bool,
        exact: bool = False,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key: Optional[int] = None,
    ):
        """Fused sort-by over the mesh, the single-device
        search_topk_sorted contract (ranked [(doc, score)] rows in
        (value, doc-asc) order with the fieldless tail, exact counts):
        each shard takes its stable top-k per ordering, the host merges
        the D sorted pages by (value, global doc id)."""
        (dev_slab, s_starts, s_lens, desc_arrs, lr, cap_l, kb, has_mask,
         mask_arr, has_omc, omc_arr, B) = self._dense_inputs(
            index, plans, n_docs, cap, k, doc_masks, thresholds, omc)
        # sharded sort column (NaN = missing / padding), device-cached
        ckey = (svals_key, cap_l) if svals_key is not None else None
        sv_dev = _MISS
        if ckey is not None:
            sv_dev = self._fmask_dev.get(ckey)
        if sv_dev is _MISS:
            sv = np.full((cap,), np.nan, np.float32)
            n = min(len(sort_vals), cap)
            sv[:n] = sort_vals[:n].astype(np.float32)
            sv[:n][~sort_present[:n]] = np.nan
            sv_dev = self._put(
                self._partition_docs_axis(sv, cap_l, np.float32(np.nan)))
            if ckey is not None:
                sv_dev = self._fmask_dev.put(ckey, sv_dev)
        step = self._get_sorted_step(
            lr=lr, cap_l=cap_l, k=kb, exact=exact, has_mask=has_mask,
            has_omc=has_omc, desc=desc,
        )
        out = self.mesh.run(step, *dev_slab, s_starts, s_lens, *desc_arrs,
                            mask_arr, omc_arr, sv_dev)[0]
        v1, g1, sc1, v2, g2, sc2, counts = (t.cpu().numpy() for t in out)
        ranked = []
        for b in range(B):
            ok1 = v1[b] > NEG_F32 / 2
            # both directions merge by (-key, doc) ascending: key encodes
            # the direction on device, so -key restores value order
            o = np.lexsort((g1[b][ok1], -v1[b][ok1]))
            row = [
                (int(d), float(v))
                for d, v in zip(g1[b][ok1][o][:k], sc1[b][ok1][o][:k])
            ]
            if len(row) < k:
                ok2 = v2[b] > NEG_F32 / 2
                o2 = np.argsort(g2[b][ok2], kind="stable")
                row += [
                    (int(d), float(v))
                    for d, v in zip(
                        g2[b][ok2][o2][: k - len(row)],
                        sc2[b][ok2][o2][: k - len(row)],
                    )
                ]
            ranked.append(row)
        return ranked, counts[:B]

    # ------------------------------------------------------------------
    # Host-side partitioning of per-doc arrays (masks / OMC / columns)
    # ------------------------------------------------------------------

    def _partition_docs_axis(self, arr: np.ndarray, cap_l: int, fill):
        """Global per-doc array [..., cap] -> sharded [D, ..., cap_l]
        (doc d lands at [d % D, ..., d // D])."""
        D = self.D
        lead = arr.shape[:-1]
        cap = arr.shape[-1]
        padded = np.full(lead + (cap_l * D,), fill, arr.dtype)
        padded[..., :cap] = arr
        resh = padded.reshape(lead + (cap_l, D))
        return np.ascontiguousarray(np.moveaxis(resh, -1, 0))

    @staticmethod
    def _interleave_bits(bits, B: int, cap: int, cap_l: int) -> np.ndarray:
        """(D, B, cap_l / 8) per-shard packed bits -> bool[B, cap] with
        global doc d at shard d % D, slot d // D."""
        D = bits.shape[0]
        shard_bools = np.unpackbits(bits, axis=2)[:, :, :cap_l]
        inter = np.ascontiguousarray(
            shard_bools.transpose(1, 2, 0)
        ).reshape(B, cap_l * D)
        return inter[:, :cap].astype(bool)

    # ------------------------------------------------------------------
    # Vector side (hybrid over the mesh): rows partition by doc % D like
    # the postings, so a doc's fused score is entirely shard-local
    # ------------------------------------------------------------------

    def ensure_vectors(self, vector_index):
        """Partition the flat vector rows across the mesh. Returns the
        sharded tuple, or None when the index is absent or in int8/IVF
        mode (hybrid callers take the int8 path)."""
        if vector_index is None:
            return None
        gen = (getattr(vector_index, "uid", id(vector_index)),
               vector_index._gen)
        out = self._vecs.get(gen)
        if out is not _MISS:
            return out if out is not False else None
        with self._lock:  # one thread partitions; others wait
            out = self._vecs.get(gen)
            if out is not _MISS:
                return out if out is not False else None
            return self._ensure_vectors_locked(vector_index, gen)

    def _ensure_vectors_locked(self, vector_index, gen):
        if vector_index._ivf is not None and not vector_index._live_rows:
            self._vecs.put(gen, False)
            return None
        parts_m = [vector_index._committed_matrix]
        parts_d = [vector_index._committed_docs]
        if vector_index._live_rows:
            parts_m.append(np.stack(vector_index._live_rows))
            parts_d.append(np.asarray(vector_index._live_docs, np.int32))
        matrix = np.concatenate(parts_m)
        docs = np.concatenate(parts_d).astype(np.int64)
        D = self.D
        shard = (docs % D).astype(np.int32)
        counts = np.bincount(shard, minlength=D)
        nb = round_up_pow2(max(int(counts.max()), 1), 128)
        mat_l = np.zeros((D, nb, matrix.shape[1]), np.float32)
        doc_l = np.zeros((D, nb), np.int32)
        valid_l = np.zeros((D, nb), bool)
        for s in range(D):
            sel = shard == s
            n = int(counts[s])
            mat_l[s, :n] = matrix[sel]
            doc_l[s, :n] = (docs[sel] // D).astype(np.int32)
            valid_l[s, :n] = True
        mat = Sharded(t.to(torch.bfloat16) for t in self._put(mat_l))
        return self._vecs.put(gen, (mat, self._put(doc_l),
                                    self._put(valid_l)))

    def _get_hybrid_step(self, *, lr, cap_l, k, exact, has_mask, has_omc,
                         has_rescale, rescale_lo, rescale_hi,
                         with_bitmap=False):
        def shard_fn(ax, p_doc, p_tf, p_etf, p_flen, starts, lens,
                     weights, field_b, avg, n_docs, thr, sim,
                     vec_m, vec_d, vec_v, queries, mask, omc):
            B = weights.shape[0]
            m = mask if has_mask else None
            bm25, matched = bm25_score_batch(
                p_doc, p_tf, p_etf, p_flen, starts, lens, weights,
                field_b, avg, n_docs, m,
                lr=lr, exact=exact, cap=cap_l, axis=ax,
            )
            vec = _vector_dense_scores(
                vec_m, vec_d, vec_v, queries, sim, cap=cap_l,
                has_rescale=has_rescale, rescale_lo=rescale_lo,
                rescale_hi=rescale_hi,
            )
            # min-max fusion with a GLOBAL span: the max is pmaxed over
            # the doc shards, or per-shard scores are incomparable
            ft_keep = (bm25 > 0.0) & (matched >= thr[:, None])
            vec_keep = vec > 0.0
            if m is not None:
                ft_keep &= m
                vec_keep &= m
            ft = bm25.masked_fill(~ft_keep, 0.0)
            vc = vec.masked_fill(~vec_keep, 0.0)
            hi = ax.pmax(torch.maximum(ft.amax(dim=1), vc.amax(dim=1)))
            span = torch.where(hi > 0.0, hi, torch.ones_like(hi))
            fused = (ft + vc) / span[:, None]
            if has_omc:
                fused = fused * omc[None, :]
            present = ft_keep | vec_keep
            fused = fused.masked_fill(~present, -INF)
            counts = ax.psum(present.sum(dim=1, dtype=torch.int32))
            vals, ids = _merge_topk(ax, fused, k)
            if with_bitmap:
                return vals, ids, counts, _packbits(present)
            return vals, ids, counts

        return shard_fn

    # ------------------------------------------------------------------
    # Public search (StringSearchTopK-compatible contract)
    # ------------------------------------------------------------------

    def search_topk(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        exact: bool = False,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key: Optional[int] = None,
        with_bitmap: bool = False,
    ) -> Tuple[np.ndarray, ...]:
        (dev_slab, s_starts, s_lens, desc_arrs, lr, cap_l, kb, has_mask,
         mask_arr, has_omc, omc_arr, B) = self._dense_inputs(
            index, plans, n_docs, cap, k, doc_masks, thresholds, omc)
        step = self._get_step(
            lr=lr, cap_l=cap_l, k=kb, exact=exact, has_mask=has_mask,
            has_omc=has_omc, with_bitmap=with_bitmap,
        )
        out = self.mesh.run(step, *dev_slab, s_starts, s_lens, *desc_arrs,
                            mask_arr, omc_arr)
        vals, ids, counts = (t.cpu().numpy() for t in out[0][:3])
        # padding slots score -inf; global ids beyond cap can only appear
        # with -inf values, which callers drop (v > 0)
        result = (vals[:, :k], ids[:, :k], counts[:B])
        if with_bitmap:
            bits = np.stack([o[3].cpu().numpy() for o in out])
            result += (self._interleave_bits(bits, B, cap, cap_l),)
        return result

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
        omc_key: Optional[int] = None,
    ):
        """Mesh analog of search_topk_grouped (same return contract):
        shard-local (gid, -score, doc) sorts + run slicing, merged across
        shards with one 2-key sort per group (_get_grouped_step). The
        group-id column doc-shards like the slab and caches on the
        devices by (gid_key, cap_l)."""
        (dev_slab, s_starts, s_lens, desc_arrs, lr, cap_l, kb, has_mask,
         mask_arr, has_omc, omc_arr, B) = self._dense_inputs(
            index, plans, n_docs, cap, k, doc_masks, thresholds, omc)
        Gb = round_up_pow2(max(n_groups, 1), 8)
        Rb = min(round_up_pow2(max_results, 8), cap_l)
        gkey = (gid_key, cap_l) if gid_key is not None else None
        gid_dev = _MISS
        if gkey is not None:
            gid_dev = self._fmask_dev.get(gkey)
        if gid_dev is _MISS:
            gcol = np.full((cap,), -1, np.int32)
            gcol[: min(len(gid_col), cap)] = gid_col[:cap]
            gid_dev = self._put(
                self._partition_docs_axis(gcol, cap_l, np.int32(-1)))
            if gkey is not None:
                gid_dev = self._fmask_dev.put(gkey, gid_dev)
        step = self._get_grouped_step(
            lr=lr, cap_l=cap_l, k=kb, G=int(Gb), R=int(Rb), exact=exact,
            has_mask=has_mask, has_omc=has_omc,
        )
        out = self.mesh.run(step, *dev_slab, s_starts, s_lens, *desc_arrs,
                            mask_arr, omc_arr, gid_dev)[0]
        vals, ids, counts, gvals, gdocs = (t.cpu().numpy() for t in out)
        gvals = gvals[:B, :n_groups]
        gdocs = gdocs[:B, :n_groups]
        group_pages = [
            [
                [
                    (int(d), float(v))
                    for d, v in zip(gdocs[b, g], gvals[b, g])
                    if np.isfinite(v) and int(d) < cap
                ][:max_results]
                for g in range(n_groups)
            ]
            for b in range(B)
        ]
        return vals[:B, :k], ids[:B, :k], counts[:B], group_pages

    # ------------------------------------------------------------------
    # Int8/IVF vector sharding: probe UNITS partition round-robin across
    # shards, each shard storing its units' window rows window-aligned
    # (boundary rows duplicate). Unit centroids replicate, so every shard
    # computes the SAME global top-nprobe probe selection with no
    # collective; each shard scans only the units it owns and the
    # per-shard top-V merge is exact (a shard contributes at most V of
    # the global top-V).
    # ------------------------------------------------------------------

    def ensure_vectors_int8(self, vector_index):
        """Partition the packed int8/IVF layout across the mesh. Returns
        the sharded tuple, or None when not in int8/IVF mode."""
        if vector_index is None or vector_index._ivf is None \
                or vector_index._live_rows:
            return None
        gen = ("i8", getattr(vector_index, "uid", id(vector_index)),
               vector_index._gen)
        out = self._vecs.get(gen)
        if out is not _MISS:
            return out
        with self._lock:  # one thread partitions; others wait
            out = self._vecs.get(gen)
            if out is not _MISS:
                return out
            return self._ensure_vectors_int8_locked(vector_index, gen)

    def _ensure_vectors_int8_locked(self, vector_index, gen):
        ivf = vector_index._ivf
        D = self.D
        q = ivf["q"]
        scales = ivf["scales"]
        docs = ivf["docs"]
        unit_starts = ivf["unit_starts"]
        window = int(ivf["window"])
        N, dim = q.shape
        U = len(unit_starts)
        per_shard = (U + D - 1) // D
        nb = max(per_shard * window, window)
        mat_l = np.zeros((D, nb, dim), np.int8)
        sc_l = np.zeros((D, nb), np.float32)
        doc_l = np.zeros((D, nb), np.int32)
        unit_local = np.zeros(U, np.int32)
        for u in range(U):
            s = u % D
            j = u // D
            unit_local[u] = j
            st = min(int(unit_starts[u]), max(N - window, 0))
            en = min(st + window, N)
            n = en - st
            mat_l[s, j * window: j * window + n] = q[st:en]
            sc_l[s, j * window: j * window + n] = scales[st:en]
            doc_l[s, j * window: j * window + n] = docs[st:en]
        return self._vecs.put(gen, (
            self._put(mat_l), self._put(sc_l), self._put(doc_l),
            self._rep(np.asarray(ivf["unit_cen"], np.float32)),
            self._rep((np.arange(U) % D).astype(np.int32)),   # owner
            self._rep(unit_local),
            window,
        ))

    def ensure_vectors_int8_pruned(self, vector_index, cap_l: int):
        """Doc-aligned int8 partition for the sharded PRUNED hybrid: the
        probe partition above packs rows by IVF unit (unit u -> shard
        u % D), so a doc's vector row and its postings live on DIFFERENT
        shards. The pruned rescore scores candidates on their doc % D
        owner, which therefore needs a second copy of the int8 rows laid
        out by doc shard: (my_mat int8[D, nb, dim], my_sc f32[D, nb],
        d2r int32[D, cap_l + 1]) with d2r[local doc] = local row or -1.
        Multi-vector docs keep ONE representative row (last write wins,
        as VectorIndex.int8_doc2row); probe hits fold back in the step.
        Returns None when not in int8/IVF mode."""
        if vector_index is None or vector_index._ivf is None \
                or vector_index._live_rows:
            return None
        gen = ("i8p", getattr(vector_index, "uid", id(vector_index)),
               vector_index._gen, cap_l)
        out = self._vecs.get(gen)
        if out is not _MISS:
            return out
        with self._lock:
            out = self._vecs.get(gen)
            if out is not _MISS:
                return out
            ivf = vector_index._ivf
            D = self.D
            q, scales, docs = ivf["q"], ivf["scales"], ivf["docs"]
            dim = q.shape[1]
            shard = docs % D
            nb = max(int(np.bincount(shard, minlength=D).max()), 1)
            my_mat = np.zeros((D, nb, dim), np.int8)
            my_sc = np.zeros((D, nb), np.float32)
            d2r = np.full((D, cap_l + 1), -1, np.int32)
            for s in range(D):
                sel = np.nonzero(shard == s)[0]
                n = len(sel)
                my_mat[s, :n] = q[sel]
                my_sc[s, :n] = scales[sel]
                ld = docs[sel] // D
                ok = ld < cap_l
                # ascending original-row order: later rows of a multi-
                # vector doc overwrite earlier ones (int8_doc2row parity)
                d2r[s, ld[ok]] = np.arange(n, dtype=np.int32)[ok]
            return self._vecs.put(gen, (
                self._put(my_mat), self._put(my_sc), self._put(d2r),
            ))

    def search_topk_hybrid(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        vector_index,                 # engine VectorIndex (flat mode)
        queries: np.ndarray,          # f32[B, dim] L2-normalized
        similarities: Sequence[float],
        exact: bool = False,
        doc_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key: Optional[int] = None,
        rescale: Optional[Tuple[float, float]] = None,
        with_bitmap: bool = False,
    ):
        """Doc-sharded fused hybrid over the mesh; None when the vector
        index can't shard (int8/IVF mode) so callers fall back.
        with_bitmap appends the reassembled bool[B, cap] match set."""
        vecs = self.ensure_vectors(vector_index)
        if vecs is None:
            return None
        (dev_slab, s_starts, s_lens, desc_arrs, lr, cap_l, kb, has_mask,
         mask_arr, has_omc, omc_arr, B) = self._dense_inputs(
            index, plans, n_docs, cap, k, doc_masks, thresholds, omc)
        sim = np.zeros((B,), np.float32)
        sim[:len(similarities)] = similarities
        step = self._get_hybrid_step(
            lr=lr, cap_l=cap_l, k=kb, exact=exact, has_mask=has_mask,
            has_omc=has_omc, has_rescale=rescale is not None,
            rescale_lo=float(rescale[0]) if rescale else 0.0,
            rescale_hi=float(rescale[1]) if rescale else 1.0,
            with_bitmap=with_bitmap,
        )
        out = self.mesh.run(
            step, *dev_slab, s_starts, s_lens, *desc_arrs, self._rep(sim),
            *vecs, self._rep(np.asarray(queries, np.float32)),
            mask_arr, omc_arr,
        )
        vals, ids, counts = (t.cpu().numpy() for t in out[0][:3])
        result = (vals[:, :k], ids[:, :k], counts[:B])
        if with_bitmap:
            bits = np.stack([o[3].cpu().numpy() for o in out])
            result += (self._interleave_bits(bits, B, cap, cap_l),)
        return result

    # ------------------------------------------------------------------
    # Sharded pruned scoring: the 10M-tier two-phase path (ops/pruned.py)
    # on the mesh. Every phase is shard-local (a doc's postings, impact-
    # prefix entries and candidate slot all live in its doc % D shard),
    # so the only collectives are a df psum (global IDF inside the
    # rescore), a counts psum and the final all_gather top-k merge. Each
    # shard nominates its own top-C candidates, making the global
    # candidate pool D * C deep.
    # ------------------------------------------------------------------

    @staticmethod
    def _shard_pre_ranges(boundaries, bprefix, D,
                          starts: np.ndarray, lens: np.ndarray, clip: int):
        """Map nomination-prefix ranges onto per-shard sub-ranges. Unlike
        _shard_ranges_on, ENDS need not land on stored boundaries
        (plan_query clips oversize LIVE ranges at PREFIX_LEN): ends align
        UP to the next boundary (a superset of the same term's postings,
        which only enriches nomination) and local lens clip to the
        per-shard prefix budget."""
        shape = starts.shape
        st = starts.reshape(-1).astype(np.int64)
        en = st + lens.reshape(-1).astype(np.int64)
        nb = len(boundaries)
        bi = np.searchsorted(boundaries, st)
        if not np.all(
            np.take(boundaries, np.minimum(bi, nb - 1)) == st
        ):
            raise ValueError(
                "prefix-range starts must align to stored boundaries"
            )
        be = np.searchsorted(boundaries, en)  # first boundary >= end
        s_st = bprefix[:, bi]
        s_ln = bprefix[:, np.minimum(be, nb - 1)] - s_st
        s_ln = np.clip(s_ln, 0, clip)
        return (
            s_st.reshape((D,) + shape).astype(np.int32),
            s_ln.reshape((D,) + shape).astype(np.int32),
        )

    def _get_pruned_step(self, *, lp, lch, cap_l, C, k, T, exact,
                         has_omc, nre, bs_steps,
                         has_filter=False, cand_given=False,
                         use_bs=False, nom_accum=True, hp=0):
        def shard_fn(ax, p_doc, p_tf, p_etf, p_flen,
                     pre_st, pre_ln, pre_w, pre_fb, pre_av,
                     rng_st, rng_ln, rng_f,
                     wl_i, wl_f, wl_prev, idf, nd, thr, omc,
                     fmask, cand_in):
            tf_src = p_etf if exact else p_tf
            # the filter mask is doc-sharded like the slab: shard-local
            # gathers give the exact filtered-df IDF after the df psum
            fm = fmask if has_filter else None
            if cand_given:
                # small filters: each shard's slice of the filtered doc
                # set IS its candidate list
                cand = cand_in
            elif use_bs and not nom_accum:
                cand = _sliced_candidates(p_doc, pre_st, pre_ln, hp=hp,
                                          cap=cap_l)
            else:
                cand = _prefix_candidates(
                    p_doc, tf_src, p_flen, pre_st, pre_ln, pre_w, pre_fb,
                    pre_av, idf, fm, lp=lp, cap=cap_l, C=C,
                )
            if use_bs:
                # v4 rescore: per-candidate binary searches into the
                # shard's slices of the UNSPLIT doc-sorted spans; df/IDF
                # is exact from the host under the gate (nre == 0,
                # unfiltered, non-exact tf), so no psum is needed
                scores, matched = rescore_bsearch(
                    p_doc, tf_src, p_flen, rng_st, rng_ln,
                    rng_f[0], rng_f[1], rng_f[2], idf, cand,
                    bs_steps=bs_steps,
                )
            else:
                scores, matched = rescore_worklist(
                    p_doc, tf_src, p_flen, wl_i, wl_f, nd, cand,
                    wl_prev if nre else None, fm,
                    lch=lch, T=T, nre=nre, bs_steps=bs_steps, axis=ax,
                )
            keep = (
                (matched >= thr[:, None]) & (scores > 0.0)
                & (cand < cap_l)
            )
            if has_omc:
                s = scores * omc[cand.clamp(0, cap_l - 1).long()]
            else:
                s = scores
            counts = ax.psum(keep.sum(dim=1, dtype=torch.int32))
            s = s.masked_fill(~keep, -INF)
            vals, ids = _merge_topk(
                ax, s, k, ids_of=lambda ci: cand.gather(1, ci).long())
            return vals, ids, counts

        return shard_fn

    def _pruned_bs_shard_inputs(self, boundaries, bprefix, plans):
        """Per-shard UNSPLIT doc-sorted ranges for the v4 binary-search
        rescore: the single-device coalescing (PrunedPlanMixin.
        _pruned_bs_inputs) recovers each stored span, whose start / end
        land on stored boundaries, so _shard_ranges_on maps them to
        shard-local sub-ranges, each still sorted by LOCAL doc id.

        Returns (s_rng_st (D, Bb, Tb, NRU), s_rng_ln, rng_f (3, Bb, Tb,
        NRU), bs_steps), bs_steps bucketed on the SHARD max length."""
        rng_i, rng_f, _ = PM._pruned_bs_inputs(plans)
        s_rng_st, s_rng_ln = self._shard_ranges_on(
            boundaries, bprefix, self.D, rng_i[0], rng_i[1]
        )
        max_len = int(s_rng_ln.max()) if s_rng_ln.size else 1
        bs_steps = 4
        while (1 << bs_steps) < max_len + 1:
            bs_steps += 4
        return s_rng_st, s_rng_ln, rng_f, int(bs_steps)

    def _get_pruned_counts_step(self, *, lch, cap_l, T, exact,
                                has_filter=False):
        def shard_fn(ax, p_doc, p_tf, p_etf, wl_i, thr, fmask):
            tf_src = p_etf if exact else p_tf
            return _exact_counts_core(
                p_doc, tf_src, wl_i, thr, fmask if has_filter else None,
                lch=lch, cap=cap_l, T=T, axis=ax,
            )

        return shard_fn

    def _pruned_shard_inputs(
        self,
        boundaries, bprefix,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        thresholds: Optional[Sequence[float]],
        omc: Optional[np.ndarray],
    ):
        """Host prep shared by the sharded pruned full-text and hybrid
        paths: nomination prefixes, per-shard rescore worklists,
        earlier-field spans, host IDF, thresholds, OMC partition.
        Returns a dict of ready arrays + static dims."""
        D = self.D
        B = len(plans)
        Bb = round_up_pow2(B, 1)
        T = max(p.starts.shape[0] for p in plans)
        Tb = round_up_pow2(T, 1)
        # small-corpus clamps: the worklist chunk width and candidate
        # budget follow the corpus; the 10M tier is unchanged, and C >=
        # per-shard cap nominates every doc so results hold
        max_rl = max(
            (int(p.lens.max()) if p.lens.size else 1) for p in plans
        )
        lch = min(PM.PRUNED_LCH, round_up_pow2(max_rl, 128))
        cap_l = round_up_pow2((cap + D - 1) // D, 128)
        # clamp by the GLOBAL cap, not cap_l: the small-filter cand-given
        # gate compares the filter's GLOBAL selection count against C,
        # and the read side flags those counts exact under the unclamped
        # constant
        C = min(PM.PRUNED_CANDIDATES, round_up_pow2(cap, 8))

        # ---- nomination prefixes: global descriptors -> per-shard ----
        def pre_of(p):
            if p.pre_starts is not None:
                return (p.pre_starts, p.pre_lens, p.pre_weights,
                        p.pre_field_b, p.pre_avg)
            return (p.starts, np.minimum(p.lens, PM.PRUNED_PREFIX),
                    p.weights, p.field_b, p.avg_flen)

        NPR = max(1, max(pre_of(p)[0].shape[1] for p in plans))
        NPRb = round_up_pow2(NPR, 1)
        pre_st = np.zeros((Bb, Tb, NPRb), np.int32)
        pre_ln = np.zeros((Bb, Tb, NPRb), np.int32)
        pre_w = np.zeros((Bb, Tb, NPRb), np.float32)
        pre_fb = np.full((Bb, Tb, NPRb), 0.75, np.float32)
        pre_av = np.ones((Bb, Tb, NPRb), np.float32)
        nd = np.ones((Bb,), np.float32)
        thr = np.zeros((Bb,), np.float32)
        dfs = np.zeros((Bb, Tb), np.float64)
        for i, p in enumerate(plans):
            nd[i] = max(float(n_docs[i]), 1.0)
            if (thresholds is not None and i < len(thresholds)
                    and thresholds[i]):
                thr[i] = thresholds[i]
            ps, pl, pw, pf, pa = pre_of(p)
            t_, r_ = ps.shape
            pre_st[i, :t_, :r_] = ps
            pre_ln[i, :t_, :r_] = pl
            pre_w[i, :t_, :r_] = pw
            pre_fb[i, :t_, :r_] = pf
            pre_av[i, :t_, :r_] = pa
            dfs[i, :p.lens.shape[0]] = (
                p.lens.astype(np.float64).sum(axis=1)
            )
        # clamped as the single-device host inputs: tolerance sums
        # variant ranges, so raw df can exceed nd (nomination-only)
        d_ = np.minimum(np.maximum(dfs, 1.0), nd[:, None])
        idf = np.where(
            dfs > 0,
            np.log1p((nd[:, None] - d_ + 0.5) / (d_ + 0.5)),
            0.0,
        ).astype(np.float32)
        s_pre_st, s_pre_ln = self._shard_pre_ranges(
            boundaries, bprefix, D, pre_st, pre_ln,
            clip=PM.PRUNED_PREFIX,
        )
        lp = round_up_pow2(max(int(s_pre_ln.max()), 8), 8)

        # ---- main ranges + earlier-field spans -> per-shard worklists
        NRmb = round_up_pow2(max(p.starts.shape[1] for p in plans), 1)
        g_starts = np.zeros((Bb, Tb, NRmb), np.int32)
        g_lens = np.zeros((Bb, Tb, NRmb), np.int32)
        for i, p in enumerate(plans):
            t_, r_ = p.starts.shape
            g_starts[i, :t_, :r_] = p.starts
            g_lens[i, :t_, :r_] = p.lens
        s_starts, s_lens = self._shard_ranges_on(
            boundaries, bprefix, D, g_starts, g_lens
        )
        # flat span table (multi-field union df): spans are unsplit
        # stored ranges, so they map per shard like any other range
        sp_st_l, sp_ln_l = [], []
        span_base: Dict[Tuple[int, int], int] = {}
        for i, p in enumerate(plans):
            if p.spans is None:
                continue
            for t, spans_t in enumerate(p.spans):
                span_base[(i, t)] = len(sp_st_l)
                for (_fo, _to, rs, rl) in spans_t:
                    sp_st_l.append(rs)
                    sp_ln_l.append(rl)
        if sp_st_l:
            s_sp_st, s_sp_ln = self._shard_ranges_on(
                boundaries, bprefix, D,
                np.asarray(sp_st_l, np.int32),
                np.asarray(sp_ln_l, np.int32),
            )
        else:
            s_sp_st = s_sp_ln = np.zeros((D, 0), np.int64)

        per_shard = []  # [(wl rows, earlier flat-span ids per row)]
        max_e = 0
        nre = 0
        max_span = 0
        for s in range(D):
            rows = []
            for i, p in enumerate(plans):
                t_n, r_n = p.starts.shape
                for t in range(t_n):
                    spans_t = (
                        p.spans[t] if p.spans is not None
                        and t < len(p.spans) else []
                    )
                    base = span_base.get((i, t), 0)
                    for r in range(r_n):
                        lln = int(s_lens[s, i, t, r])
                        if lln <= 0:
                            continue
                        so = (
                            int(p.range_span[t, r])
                            if p.range_span is not None else -1
                        )
                        # earlier spans of the same token except the
                        # range's own (field, term): union df across
                        # fields AND tolerance variants
                        if so >= 0:
                            me = spans_t[so][:2]
                            earlier = [
                                base + e for e in range(so)
                                if spans_t[e][:2] != me
                            ]
                        else:
                            earlier = []
                        for eid in earlier:
                            max_span = max(max_span, int(s_sp_ln[s, eid]))
                        nre = max(nre, len(earlier))
                        ls = int(s_starts[s, i, t, r])
                        w0 = float(p.weights[t, r])
                        b0 = float(p.field_b[t, r])
                        a0 = float(p.avg_flen[t, r])
                        off = 0
                        while off < lln:
                            take = min(lln - off, lch)
                            rows.append(
                                (i, t, ls + off, take, w0, b0, a0, earlier)
                            )
                            off += take
            per_shard.append(rows)
            max_e = max(max_e, len(rows))
        W = round_up_pow2(max(max_e, 1), PM.PRUNED_WCH)
        nre = round_up_pow2(nre, 1) if nre else 0
        wl_i = np.zeros((D, 4, W), np.int32)
        wl_f = np.zeros((D, 3, W), np.float32)
        wl_f[:, 2, :] = 1.0
        wl_prev = np.zeros((D, 2, W, nre), np.int32) if nre else None
        for s, rows in enumerate(per_shard):
            for j, (b, t, ls, ll, w0, b0, a0, earlier) in enumerate(rows):
                wl_i[s, :, j] = (b, t, ls, ll)
                wl_f[s, :, j] = (w0, b0, a0)
                if nre:
                    for e, eid in enumerate(earlier):
                        wl_prev[s, 0, j, e] = int(s_sp_st[s, eid])
                        wl_prev[s, 1, j, e] = int(s_sp_ln[s, eid])
        bs_steps = 0
        if nre:
            bs_steps = 4
            while (1 << bs_steps) < max_span + 1:
                bs_steps += 4

        has_omc = omc is not None
        omc_arr = None
        if has_omc:
            go = np.ones((cap,), np.float32)
            go[: min(len(omc), cap)] = omc[:cap]
            omc_arr = self._partition_docs_axis(go, cap_l, np.float32(1.0))

        return dict(
            B=B, Bb=Bb, Tb=Tb, lch=lch, cap_l=int(cap_l), C=C,
            lp=int(lp), nre=int(nre), bs_steps=int(bs_steps),
            s_pre_st=s_pre_st, s_pre_ln=s_pre_ln,
            pre_w=pre_w, pre_fb=pre_fb, pre_av=pre_av,
            wl_i=wl_i, wl_f=wl_f, wl_prev=wl_prev,
            idf=idf, nd=nd, thr=thr, dfs=dfs,
            has_omc=has_omc, omc_arr=omc_arr,
        )

    def _get_facet_reps_step(self, *, lch, cap_l, has_filter):
        """Phase A of the mesh facet path: per-shard (doc, token) sort +
        run-end reps (ops/pruned._match_reps_core; shard-complete, since a
        doc's postings all live in its doc % D shard). The outputs stay
        on the shards for phase B."""
        def shard_fn(ax, p_doc, p_tf, wl_i, thr, fmask):
            return _match_reps_core(
                p_doc, p_tf, wl_i, thr, fmask if has_filter else None,
                lch=lch, cap=cap_l,
            )

        return shard_fn

    def _get_facet_vec_reps_step(self, *, cap_l, V, nprobe, window,
                                 pad, has_filter, has_rescale,
                                 rescale_lo, rescale_hi):
        """HYBRID phase-A tail on the mesh: the IVF probe scans each unit
        on its round-robin owner, the global top-V rows route to their
        doc % D owner via one all_gather (the sharded pruned hybrid's
        probe), then each shard dedups its owned probe docs against its
        full-text reps (ops/pruned._vec_reps_core) and appends them to
        its (docs, rep) pair. `pad` keeps phase B's shapes."""
        D = self.D

        def shard_fn(ax, docs_ft, rep_ft, mat8, sc8, doc8,
                     unit_cen, owner, unit_local, query, sim, fmask):
            lv, ld = _owned_probe(
                ax, query, mat8, sc8, doc8, unit_cen, owner, unit_local,
                V=V, nprobe=nprobe, window=window,
            )
            av = ax.all_gather(lv[0], axis=0).reshape(D * V)
            ad = ax.all_gather(ld[0], axis=0).reshape(D * V)
            gv, sel = top_k_by_key(av, V)
            gd = ad[sel]
            if has_rescale:
                gv = _rescale(gv, rescale_lo, rescale_hi)
            keep = (gd >= 0) & (gv >= sim) & (gv > 0.0)
            own_doc = keep & ((gd % D) == ax.index)
            vd = torch.where(own_doc, gd // D, cap_l).to(torch.int32)
            if has_filter:
                vd = torch.where(
                    fmask[vd.clamp(0, cap_l - 1).long()] > 0.0, vd, cap_l,
                ).to(torch.int32)
            vd, vrep = _vec_reps_core(vd, docs_ft, rep_ft, cap_l)
            vd = torch.cat([vd, vd.new_full((pad - V,), cap_l)])
            vrep = torch.cat([vrep, vrep.new_zeros(pad - V)])
            return torch.cat([docs_ft, vd]), torch.cat([rep_ft, vrep])

        return shard_fn

    def _get_facet_hist_step(self, *, G, numeric):
        """Phase B: per-shard `facet_hist` histograms off the shard's
        (docs, rep), psum'd to exact global counts."""
        def shard_fn(ax, docs, rep, bucket, bounds):
            return facet_hist(docs, rep, bucket, bounds, G=G,
                              numeric=numeric, axis=ax)

        return shard_fn

    def _get_facet_hist_multi_step(self, *, G, numeric, M):
        """Phase B for MULTI-VALUED facet columns on the mesh: per-shard
        `facet_hist_multi` over the shard's pair table, psum'd to exact
        global counts (a doc's reps AND its pair rows both live in its
        doc % D shard)."""
        def shard_fn(ax, docs, rep, pair_docs, pair_vals, row_ptr, bounds):
            return facet_hist_multi(docs, rep, pair_docs, pair_vals,
                                    row_ptr, bounds, G=G, numeric=numeric,
                                    M=M, axis=ax)

        return shard_fn

    def facet_counts_pruned(
        self,
        index: StringIndex,
        plan,
        cap: int,
        spec,
        spec_key,
        exact: bool = False,
        mask: Optional[np.ndarray] = None,
        mask_key=None,
        thr: float = 0.0,
        vec=None,
    ) -> np.ndarray:
        """Mesh facet counting over the pruned plan, the single-device
        contract: distinct matched docs per bucket, sort-based (per-shard
        (doc, token) sort + run-end reps, then a psum'd histogram). The
        sharded (docs, rep) pair is computed ONCE per plan and kept for
        the search's remaining facet fields. `vec` = (vector_index, q,
        similarity, rescale) for HYBRID searches at the int8/IVF tier:
        the probe's owned top-V docs join each shard's reps."""
        dev_slab, boundaries, bprefix = self.ensure_slab(index)
        D = self.D
        lch = PM.PRUNED_LCH
        if plan is not None and getattr(plan, "lens", None) is not None \
                and plan.lens.size:
            # small-corpus clamp (see _pruned_shard_inputs)
            lch = min(lch, round_up_pow2(int(plan.lens.max()), 128))
        cap_l = round_up_pow2((cap + D - 1) // D, 128)
        p_doc, p_tf, p_etf, _p_flen = dev_slab
        has_filter = mask is not None

        # one-slot reps cache: the slot holds a strong ref to the plan,
        # so the `is` identity check can never alias a recycled id()
        reps_key = (index.uid, mask_key, has_filter, bool(exact),
                    float(thr), int(cap_l), vec is not None)
        slot = getattr(self, "_facet_reps_slot", None)
        if slot is not None and slot[1] is plan and slot[0] == reps_key:
            reps = slot[2]
        else:
            T, NR = plan.starts.shape
            s_st, s_ln = self._shard_ranges_on(
                boundaries, bprefix, D, plan.starts[None],
                plan.lens[None],
            )
            per_shard = []
            max_rows = 0
            for sh in range(D):
                rows = []
                for t in range(T):
                    for r in range(NR):
                        lln = int(s_ln[sh, 0, t, r])
                        if lln <= 0:
                            continue
                        ls = int(s_st[sh, 0, t, r])
                        off = 0
                        while off < lln:
                            take = min(lln - off, lch)
                            rows.append((t, ls + off, take))
                            off += take
                per_shard.append(rows)
                max_rows = max(max_rows, len(rows))
            W = round_up_pow2(max(max_rows, 1), 2)
            wl_i = np.zeros((D, 4, W), np.int32)
            for sh, rows in enumerate(per_shard):
                for j, (t, ls, ll) in enumerate(rows):
                    wl_i[sh, 1, j] = t
                    wl_i[sh, 2, j] = ls
                    wl_i[sh, 3, j] = ll
            fmask_dev = None
            if has_filter:
                # C=0: the cand-given branch can't trigger (only the
                # sharded mask upload is wanted here)
                fmask_dev, _c, _cg, _sel = self._pruned_mask_shard_inputs(
                    mask, mask_key, cap, cap_l, 1, 0
                )
            reps_step = self._get_facet_reps_step(
                lch=lch, cap_l=int(cap_l), has_filter=has_filter,
            )
            reps = self.mesh.run(
                reps_step, p_doc, p_etf if exact else p_tf,
                self._put(wl_i), float(thr), fmask_dev,
            )
            if vec is not None:
                vector_index, q, sim_v, rescale = vec
                vecs8 = self.ensure_vectors_int8(vector_index)
                mat8, sc8, doc8, unit_cen, owner, unit_local, window = (
                    vecs8
                )
                n_rows = D * int(mat8[0].shape[0])
                V = round_up_pow2(
                    min(HYBRID_INT8_CANDIDATES, n_rows,
                        round_up_pow2(cap, 8)), 8
                )
                nprobe = min(_vi.IVF_NPROBE, int(unit_cen[0].shape[0]))
                vstep = self._get_facet_vec_reps_step(
                    cap_l=int(cap_l), V=V, nprobe=int(nprobe),
                    # pad must hold the V probe rows (lch can clamp
                    # below V on small corpora)
                    window=int(window), pad=max(lch, V),
                    has_filter=has_filter,
                    has_rescale=rescale is not None,
                    rescale_lo=float(rescale[0]) if rescale else 0.0,
                    rescale_hi=float(rescale[1]) if rescale else 1.0,
                )
                reps = self.mesh.run(
                    vstep, Sharded(r[0] for r in reps),
                    Sharded(r[1] for r in reps), mat8, sc8, doc8,
                    unit_cen, owner, unit_local,
                    self._rep(np.asarray(q, np.float32).reshape(1, -1)),
                    float(sim_v), fmask_dev,
                )
            self._facet_reps_slot = (reps_key, plan, reps)
        docs_dev = Sharded(r[0] for r in reps)
        rep_dev = Sharded(r[1] for r in reps)

        kind = spec[0]
        if kind in ("mcat", "mnum"):
            # multi-valued column: the doc-sorted deduped pair table
            # shards by doc % D (global doc order keeps each shard's
            # local ids ascending), padded with a sentinel > any local
            # id so the per-shard search stays total
            numeric = kind == "mnum"
            if numeric:
                bounds = np.asarray(spec[3], np.float32)
                G, M = int(spec[3].shape[0]), int(spec[4])
            else:
                G, M = int(spec[3]), int(spec[4])
                bounds = np.zeros((G, 2), np.float32)
            ckey = (spec_key, cap_l) if spec_key is not None else None
            pair_dev = _MISS
            if ckey is not None:
                pair_dev = self._fmask_dev.get(ckey)
            if pair_dev is _MISS:
                gd = np.asarray(spec[1])
                gv = np.asarray(spec[2], np.float32 if numeric else np.int32)
                shard = gd % D
                pl = max(int(np.bincount(shard, minlength=D).max())
                         if len(gd) else 0, 0) + 1
                pd = np.full((D, pl), 2 ** 30, np.int32)
                pv = np.zeros((D, pl), gv.dtype)
                for s in range(D):
                    sel = shard == s
                    n = int(np.count_nonzero(sel))
                    pd[s, :n] = gd[sel] // D
                    pv[s, :n] = gv[sel]
                pd_dev = self._put(pd)
                pair_dev = (pd_dev, self._put(pv), Sharded(
                    row_ptr_table(t, cap_l) for t in pd_dev))
                if ckey is not None:
                    pair_dev = self._fmask_dev.put(ckey, pair_dev)
            mstep = self._get_facet_hist_multi_step(
                G=G, numeric=numeric, M=max(M, 1),
            )
            counts = self.mesh.run(mstep, docs_dev, rep_dev, *pair_dev,
                                   self._rep(bounds))
            return counts[0].cpu().numpy()
        numeric = kind == "num"
        ckey = (spec_key, cap_l) if spec_key is not None else None
        col_dev = _MISS
        if ckey is not None:
            col_dev = self._fmask_dev.get(ckey)
        if col_dev is _MISS:
            if numeric:
                part = self._partition_docs_axis(
                    spec[1][:cap].astype(np.float32), cap_l,
                    np.float32(np.nan),
                )
            else:
                part = self._partition_docs_axis(
                    spec[1][:cap].astype(np.int32), cap_l, np.int32(-1)
                )
            col_dev = self._put(part)
            if ckey is not None:
                col_dev = self._fmask_dev.put(ckey, col_dev)
        if numeric:
            bounds = np.asarray(spec[2], np.float32)
            G = int(spec[2].shape[0])
        else:
            G = int(spec[2])
            bounds = np.zeros((G, 2), np.float32)
        hist_step = self._get_facet_hist_step(G=G, numeric=numeric)
        counts = self.mesh.run(hist_step, docs_dev, rep_dev, col_dev,
                               self._rep(bounds))
        return counts[0].cpu().numpy()

    def facet_match_count(self, plan) -> Optional[int]:
        """Mesh analog of facet_match_count: the global rep sum over the
        doc-sharded phase-A reps (per-shard runs are whole and
        doc-disjoint, so one cross-shard sum is the exact thresholded
        match count), summed in int32. None when the reps slot doesn't
        hold this plan."""
        slot = getattr(self, "_facet_reps_slot", None)
        if slot is None or slot[1] is not plan:
            return None
        return int(sum(int(r[1].to(torch.int32).sum()) for r in slot[2]))

    def _pruned_mask_shard_inputs(self, mask, mask_key, cap, cap_l,
                                  Bb, C):
        """Doc-sharded device inputs for a FILTERED pruned search: the
        (D, cap_l) f32 mask (doc d at [d % D, d // D], cached on the
        devices when mask_key is stable), and for filters selecting <= C
        docs the per-shard slices of the filtered doc set as candidate
        lists (sorted local ids, cap_l-padded). Returns (fmask_dev,
        cand_in_dev, cand_given, sel)."""
        key = (mask_key, cap_l) if mask_key is not None else None
        fm = _MISS
        if key is not None:
            fm = self._fmask_dev.get(key)
        if fm is _MISS:
            fm = self._put(self._partition_docs_axis(
                mask[:cap].astype(np.float32), cap_l, np.float32(0.0)))
            if key is not None:
                fm = self._fmask_dev.put(key, fm)
        sel = int(np.count_nonzero(mask[:cap]))
        cand_in = None
        cand_given = False
        if sel <= C:
            ids = np.nonzero(mask[:cap])[0].astype(np.int32)
            cand_np = np.full((self.D, Bb, C), cap_l, np.int32)
            for sh in range(self.D):
                loc = ids[ids % self.D == sh] // self.D
                cand_np[sh, :, : len(loc)] = loc[None, :]
            cand_in = self._put(cand_np)
            cand_given = True
        return fm, cand_in, cand_given, sel

    def _pruned_rescore_inputs(self, h, plans, boundaries, bprefix,
                               use_bs: bool):
        """The rescore's placed inputs and its C / bs_steps / hp: the v4
        ranges when use_bs, else the v3 worklists."""
        C, bs_steps, hp = h["C"], h["bs_steps"], 0
        rng = (None, None, None)
        if use_bs:
            s_rng_st, s_rng_ln, rng_f, bs_steps = (
                self._pruned_bs_shard_inputs(boundaries, bprefix, plans)
            )
            rng = (self._put(s_rng_st), self._put(s_rng_ln),
                   self._rep(rng_f))
            if PM.PRUNED_BS_ACCUM:
                C = min(PM.PRUNED_BS_C, round_up_pow2(h["cap_l"], 8))
            else:
                hp = PM.PRUNED_BS_HP
                C = h["s_pre_st"].shape[2] * h["s_pre_st"].shape[3] * hp
        placed = (
            self._put(h["s_pre_st"]), self._put(h["s_pre_ln"]),
            self._rep(h["pre_w"]), self._rep(h["pre_fb"]),
            self._rep(h["pre_av"]), *rng,
            self._put(h["wl_i"]), self._put(h["wl_f"]),
            self._put(h["wl_prev"]) if h["nre"] else None,
            self._rep(h["idf"]), self._rep(h["nd"]), self._rep(h["thr"]),
        )
        return placed, C, int(bs_steps), hp

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
        """Pruned full text over the mesh, the contract of
        PrunedPlanMixin.search_topk_pruned (GLOBAL doc ids; counts are
        estimate-floored lower bounds unless exact_counts; mask is one
        bool[cap] filter shared by every plan, doc-sharded like the slab
        so the filtered-df psum stays exact; a small filter becomes the
        per-shard candidate lists, results AND counts exact). Plans must
        be built with_prefix and without impact_cap (enforced by
        boundary alignment)."""
        dev_slab, boundaries, bprefix = self.ensure_slab(index)
        h = self._pruned_shard_inputs(
            boundaries, bprefix, plans, n_docs, cap, thresholds, omc
        )
        B, Tb, lch, cap_l = h["B"], h["Tb"], h["lch"], h["cap_l"]
        nre, has_omc = h["nre"], h["has_omc"]
        has_filter = mask is not None
        fmask_dev = None
        cand_in = None
        cand_given = False
        sel = None
        if has_filter:
            fmask_dev, cand_in, cand_given, sel = (
                self._pruned_mask_shard_inputs(
                    mask, mask_key, cap, cap_l, h["idf"].shape[0], h["C"]
                )
            )
        # v4 dispatch mirrors the single-device gate: single-span
        # tokens, non-exact tf, unfiltered
        use_bs = (
            PM.PRUNED_BS and not exact and not has_filter and nre == 0
        )
        placed, C, bs_steps, hp = self._pruned_rescore_inputs(
            h, plans, boundaries, bprefix, use_bs)
        kb = min(round_up_pow2(k, 8), C)
        step = self._get_pruned_step(
            lp=h["lp"], lch=lch, cap_l=cap_l, C=C, k=int(kb),
            T=int(Tb), exact=exact, has_omc=has_omc, nre=nre,
            bs_steps=bs_steps,
            has_filter=has_filter, cand_given=cand_given,
            use_bs=use_bs, nom_accum=PM.PRUNED_BS_ACCUM, hp=hp,
        )
        out = self.mesh.run(
            step, *dev_slab, *placed,
            self._put(h["omc_arr"]) if has_omc else None,
            fmask_dev, cand_in,
        )[0]
        vals, ids, cand_counts = (t.cpu().numpy() for t in out)
        if cand_given:
            counts = cand_counts[:B]
        elif exact_counts:
            counts = self._exact_counts_sliced(
                dev_slab, h, fmask_dev, exact=exact, has_filter=has_filter)
        else:
            sel_frac = 1.0
            if sel is not None:
                sel_frac = sel / max(float(h["nd"][0]), 1.0)
            counts = PM._pruned_counts(
                cand_counts, h["dfs"], h["nd"], thresholds, B,
                sel_frac=sel_frac,
            )
        return vals[:B, :k], ids[:B, :k], counts

    def _exact_counts_sliced(self, dev_slab, h, fmask_dev, *, exact,
                             has_filter):
        """The exact-counts dispatch on the mesh, in slices of at most
        PRUNED_COUNTS_SLICE queries (each shard's counting sort grows
        superlinearly in its flat length)."""
        p_doc, p_tf, p_etf, _ = dev_slab
        B, wl_i, thr = h["B"], h["wl_i"], h["thr"]
        cstep = self._get_pruned_counts_step(
            lch=h["lch"], cap_l=h["cap_l"], T=int(h["Tb"]), exact=exact,
            has_filter=has_filter,
        )

        def run(wl, th):
            return self.mesh.run(cstep, p_doc, p_tf, p_etf, self._put(wl),
                                 self._rep(th), fmask_dev)[0].cpu().numpy()

        S = PM.PRUNED_COUNTS_SLICE
        if B <= S:
            return run(wl_i, thr)[:B]
        # one dispatch per <= S query slice, one shape per worklist-width
        # bucket
        counts = np.zeros((B,), np.int32)
        D = self.D
        for s0 in range(0, B, S):
            take = min(S, B - s0)
            cols = [
                np.nonzero(
                    (wl_i[sh, 0] >= s0) & (wl_i[sh, 0] < s0 + S)
                    & (wl_i[sh, 3] > 0)
                )[0]
                for sh in range(D)
            ]
            Ws = round_up_pow2(
                max(max((len(c) for c in cols), default=0), 1), 2
            )
            wls = np.zeros((D, 4, Ws), np.int32)
            for sh in range(D):
                cc = cols[sh]
                wls[sh, :, : len(cc)] = wl_i[sh][:, cc]
                wls[sh, 0, : len(cc)] -= s0
            thrs = np.zeros((S,), np.float32)
            thrs[:take] = thr[s0:s0 + take]
            counts[s0:s0 + take] = run(wls, thrs)[:take]
        return counts

    # ------------------------------------------------------------------
    # Sharded pruned HYBRID (int8/IVF tier): full-text candidates
    # nominate per doc shard (as above); the IVF probe scans each unit on
    # its round-robin owner and the global top-V rows route back to their
    # doc % D owner via one all_gather; BM25F and cosine are then both
    # EXACT on the per-shard candidate union (the cosine via the
    # doc-aligned int8 copy, ensure_vectors_int8_pruned), fused under a
    # pmax'd global span.
    # ------------------------------------------------------------------

    def _get_pruned_hybrid_step(self, *, lp, lch, cap_l, C, k, T, exact,
                                has_omc, nre, bs_steps, V, nprobe,
                                window, has_rescale, rescale_lo,
                                rescale_hi,
                                has_filter=False, cand_given=False,
                                use_bs=False, nom_accum=True, hp=0):
        D = self.D

        def shard_fn(ax, p_doc, p_tf, p_etf, p_flen,
                     pre_st, pre_ln, pre_w, pre_fb, pre_av,
                     rng_st, rng_ln, rng_f,
                     wl_i, wl_f, wl_prev, idf, nd, thr,
                     mat8, sc8, doc8, unit_cen, owner, unit_local,
                     my_mat, my_sc, d2r,
                     queries, sim, omc, fmask, cand_in):
            sid = ax.index
            tf_src = p_etf if exact else p_tf
            B = queries.shape[0]
            fm = fmask if has_filter else None

            if cand_given:
                ft_cand = None  # small filter: cand_in IS the full set
            elif use_bs and not nom_accum:
                ft_cand = _sliced_candidates(p_doc, pre_st, pre_ln, hp=hp,
                                             cap=cap_l)
            else:
                # full-text nomination: shard-local top-C (local ids)
                ft_cand = _prefix_candidates(
                    p_doc, tf_src, p_flen, pre_st, pre_ln, pre_w, pre_fb,
                    pre_av, idf, fm, lp=lp, cap=cap_l, C=C,
                )

            # IVF probe: global unit selection (centroids replicate),
            # each unit scanned by its owner, global top-V via all_gather
            lv, ld = _owned_probe(
                ax, queries, mat8, sc8, doc8, unit_cen, owner, unit_local,
                V=V, nprobe=nprobe, window=window,
            )
            av = ax.all_gather(lv, axis=1).reshape(B, D * V)
            ad = ax.all_gather(ld, axis=1).reshape(B, D * V)
            gv, sel = top_k_by_key(av, V)      # raw cosines (no rescale)
            gd = ad.gather(1, sel)
            keep_p = (gd >= 0) & (gv > NEG_INF / 2)
            own_doc = keep_p & ((gd % D) == sid)
            my_vdocs = torch.where(own_doc, gd // D, cap_l).to(torch.int32)
            if fm is not None:
                # out-of-filter probe hits never become candidates
                my_vdocs = torch.where(
                    fm[my_vdocs.clamp(0, cap_l - 1).long()] > 0.0,
                    my_vdocs, cap_l,
                ).to(torch.int32)

            if cand_given:
                cand = cand_in
            else:
                # candidate union (sorted; cap_l marks empty + dups)
                cand = _dedup_sorted(torch.cat([ft_cand, my_vdocs], dim=1),
                                     cap_l)
            Ct = cand.shape[1]

            # exact BM25F over the union
            if use_bs:
                scores, matched = rescore_bsearch(
                    p_doc, tf_src, p_flen, rng_st, rng_ln,
                    rng_f[0], rng_f[1], rng_f[2], idf, cand,
                    bs_steps=bs_steps,
                )
            else:
                # global df via psum
                scores, matched = rescore_worklist(
                    p_doc, tf_src, p_flen, wl_i, wl_f, nd, cand,
                    wl_prev if nre else None, fm,
                    lch=lch, T=T, nre=nre, bs_steps=bs_steps, axis=ax,
                )

            # exact cosine per candidate: doc-aligned int8 row gather
            vec = _candidate_vec(cand, d2r, my_mat, my_sc, queries, cap_l)
            # multi-vector docs: fold the probe's own (possibly better)
            # row values back in
            posc = _lower_bound(cand, my_vdocs).clamp(max=Ct - 1).long()
            hit_v = (cand.gather(1, posc) == my_vdocs) & (my_vdocs < cap_l)
            vec = vec.scatter_reduce(
                1, posc, torch.where(hit_v, gv, 0.0), "amax",
                include_self=True)
            if has_rescale:
                vec = _rescale(vec, rescale_lo, rescale_hi)
            vec = torch.where(vec >= sim[:, None], vec, 0.0)

            # min-max fusion: span is the GLOBAL candidate max (pmax)
            ft_keep = (
                (scores > 0.0) & (matched >= thr[:, None]) & (cand < cap_l)
            )
            vc_keep = (vec > 0.0) & (cand < cap_l)
            ft = torch.where(ft_keep, scores, 0.0)
            vc = torch.where(vc_keep, vec, 0.0)
            hi = ax.pmax(torch.maximum(ft.amax(dim=1), vc.amax(dim=1)))
            span = torch.where(hi > 0.0, hi, torch.ones_like(hi))
            fused = (ft + vc) / span[:, None]
            if has_omc:
                fused = fused * omc[cand.clamp(0, cap_l - 1).long()]
            present = ft_keep | vc_keep
            counts = ax.psum(present.sum(dim=1, dtype=torch.int32))
            s = fused.masked_fill(~present, -INF)
            vals, ids = _merge_topk(
                ax, s, k, ids_of=lambda ci: cand.gather(1, ci).long())
            return vals, ids, counts

        return shard_fn

    def search_topk_hybrid_int8_pruned(
        self,
        index: StringIndex,
        plans: Sequence[QueryPlan],
        n_docs: Sequence[float],
        cap: int,
        k: int,
        vector_index,                  # engine VectorIndex (int8/IVF)
        queries: np.ndarray,           # f32[B, dim] L2-normalized
        similarities: Sequence[float],
        exact: bool = False,
        thresholds: Optional[Sequence[float]] = None,
        omc: Optional[np.ndarray] = None,
        omc_key=None,
        rescale: Optional[Tuple[float, float]] = None,
        candidates: Optional[int] = None,
        mask: Optional[np.ndarray] = None,
        mask_key=None,
    ):
        """Pruned fused hybrid over the mesh, the contract of
        HybridSearchTopK.search_topk_hybrid_int8_pruned (GLOBAL doc ids;
        counts are estimate-floored lower bounds; mask is one bool[cap]
        filter shared by every plan, small filters becoming the
        per-shard candidate lists with exact counts). Returns None when
        the vector index is not in int8/IVF mode."""
        probe = self.ensure_vectors_int8(vector_index)
        if probe is None:
            return None
        dev_slab, boundaries, bprefix = self.ensure_slab(index)
        h = self._pruned_shard_inputs(
            boundaries, bprefix, plans, n_docs, cap, thresholds, omc
        )
        B, Bb, Tb, lch, cap_l = (
            h["B"], h["Bb"], h["Tb"], h["lch"], h["cap_l"]
        )
        nre, has_omc = h["nre"], h["has_omc"]
        doc_aligned = self.ensure_vectors_int8_pruned(vector_index, cap_l)
        if doc_aligned is None:
            return None
        mat8, sc8, doc8, unit_cen, owner, unit_local, window = probe
        nprobe = min(_vi.IVF_NPROBE, int(unit_cen[0].shape[0]))
        V = round_up_pow2(
            min(candidates or HYBRID_INT8_CANDIDATES,
                self.D * int(mat8[0].shape[0]),
                round_up_pow2(cap, 8)),
            8,
        )
        has_filter = mask is not None
        fmask_dev = None
        cand_in = None
        cand_given = False
        sel = None
        if has_filter:
            fmask_dev, cand_in, cand_given, sel = (
                self._pruned_mask_shard_inputs(
                    mask, mask_key, cap, cap_l, Bb, h["C"]
                )
            )
        use_bs = (
            PM.PRUNED_BS and not exact and not has_filter and nre == 0
        )
        placed, C, bs_steps, hp = self._pruned_rescore_inputs(
            h, plans, boundaries, bprefix, use_bs)
        Ct = C if cand_given else C + V
        kb = min(round_up_pow2(k, 8), Ct)
        q = np.zeros((Bb, queries.shape[1]), np.float32)
        q[: len(queries)] = queries
        sims = np.zeros((Bb,), np.float32)
        for i, s in enumerate(similarities):
            sims[i] = s
        step = self._get_pruned_hybrid_step(
            lp=h["lp"], lch=lch, cap_l=cap_l, C=C, k=int(kb),
            T=int(Tb), exact=exact, has_omc=has_omc, nre=nre,
            bs_steps=bs_steps, V=int(V), nprobe=int(nprobe),
            window=int(window),
            has_rescale=rescale is not None,
            rescale_lo=float(rescale[0]) if rescale else 0.0,
            rescale_hi=float(rescale[1]) if rescale else 1.0,
            has_filter=has_filter, cand_given=cand_given,
            use_bs=use_bs, nom_accum=PM.PRUNED_BS_ACCUM, hp=hp,
        )
        out = self.mesh.run(
            step, *dev_slab, *placed,
            mat8, sc8, doc8, unit_cen, owner, unit_local, *doc_aligned,
            self._rep(q), self._rep(sims),
            self._put(h["omc_arr"]) if has_omc else None,
            fmask_dev, cand_in,
        )[0]
        vals, ids, cand_counts = (t.cpu().numpy() for t in out)
        if cand_given:
            counts = cand_counts[:B]
        else:
            sel_frac = 1.0
            if sel is not None:
                sel_frac = sel / max(float(h["nd"][0]), 1.0)
            counts = PM._pruned_counts(
                cand_counts, h["dfs"], h["nd"], thresholds, B,
                sel_frac=sel_frac,
            )
        return vals[:B, :k], ids[:B, :k], counts


class ShardedBatchExec(ShardedStringExec):
    """SharedBatchExecutor contract over the doc-sharded mesh: each
    unique token's postings are scored once PER SHARD into local dense
    rows (global df via psum inside ops/bm25.bm25_shared_partial), the
    row kernel `assign_rows_accumulate` adds each query's own term rows
    shard-locally, and one finalize step does threshold + OMC + local
    top-k + all_gather merge. Champion tokens revert to ranged classes
    (champion rows are global-doc-space dense)."""

    def _get_shared_step(self, *, lr, cap_l, cu, exact, has_mask):
        def shard_fn(ax, p_doc, p_tf, p_etf, p_flen, st, ln, wt, fb, av,
                     tmap, nd, mask, scores, matched):
            if has_mask:
                return bm25_shared_partial_masked(
                    p_doc, p_tf, p_etf, p_flen, st, ln, wt, fb, av, tmap,
                    mask, nd, scores, matched,
                    lr=lr, cap=cap_l, cu=cu, exact=exact, axis=ax,
                )
            return bm25_shared_partial(
                p_doc, p_tf, p_etf, p_flen, st, ln, wt, fb, av, tmap, nd,
                scores, matched,
                lr=lr, cap=cap_l, cu=cu, exact=exact, axis=ax,
            )

        return shard_fn

    def _get_finalize_step(self, *, cap_l, k, has_omc):
        def shard_fn(ax, scores, matched, thr, omc):
            s = scores * omc[None, :] if has_omc else scores
            keep = (matched >= thr[:, None]) & (scores > 0.0)
            counts = ax.psum(keep.sum(dim=1, dtype=torch.int32))
            s = s.masked_fill(~keep, -INF)
            vals, ids = _merge_topk(ax, s, k)
            return vals, ids, counts

        return shard_fn

    def _get_hybrid_tail_step(self, *, cap_l, k, has_omc, has_mask,
                              has_rescale, rescale_lo, rescale_hi):
        def shard_fn(ax, scores, matched, thr, sim, vec_m, vec_d, vec_v,
                     queries, mask, omc):
            vec = _vector_dense_scores(
                vec_m, vec_d, vec_v, queries, sim, cap=cap_l,
                has_rescale=has_rescale, rescale_lo=rescale_lo,
                rescale_hi=rescale_hi,
            )
            ft_keep = (scores > 0.0) & (matched >= thr[:, None])
            vec_keep = vec > 0.0
            if has_mask:
                ft_keep &= mask
                vec_keep &= mask
            ft = scores.masked_fill(~ft_keep, 0.0)
            vc = vec.masked_fill(~vec_keep, 0.0)
            hi = ax.pmax(torch.maximum(ft.amax(dim=1), vc.amax(dim=1)))
            span = torch.where(hi > 0.0, hi, torch.ones_like(hi))
            fused = (ft + vc) / span[:, None]
            if has_omc:
                fused = fused * omc[None, :]
            present = ft_keep | vec_keep
            counts = ax.psum(present.sum(dim=1, dtype=torch.int32))
            fused = fused.masked_fill(~present, -INF)
            vals, ids = _merge_topk(ax, fused, k)
            return vals, ids, counts

        return shard_fn

    def _get_hybrid_int8_tail_step(self, *, cap_l, k, V, nprobe, window,
                                   has_omc, has_mask, has_rescale,
                                   rescale_lo, rescale_hi):
        D = self.D

        def shard_fn(ax, scores, matched, thr, sim, queries,
                     mat8, sc8, doc8, unit_cen, owner, unit_local,
                     mask, omc):
            B = scores.shape[0]
            sid = ax.index
            lv, ld = _owned_probe(
                ax, queries, mat8, sc8, doc8, unit_cen, owner, unit_local,
                V=V, nprobe=nprobe, window=window,
            )
            av = ax.all_gather(lv, axis=1).reshape(B, D * V)
            ad = ax.all_gather(ld, axis=1).reshape(B, D * V)
            gv, sel = top_k_by_key(av, V)
            gd = ad.gather(1, sel)
            if has_rescale:
                gv = _rescale(gv, rescale_lo, rescale_hi)
            keep = (gd >= 0) & (gv >= sim[:, None]) & (gv > NEG_INF / 2)
            gv = torch.where(keep, gv, 0.0)
            # route candidates to their owning doc shard's local space
            own_doc = keep & ((gd % D) == sid)
            slot = torch.where(own_doc, gd // D, cap_l).long()
            vec = _scatter_max(torch.where(own_doc, gv, 0.0), slot, cap_l)
            if has_mask:
                vec = vec.masked_fill(~mask, 0.0)
            ft_keep = (scores > 0.0) & (matched >= thr[:, None])
            if has_mask:
                ft_keep &= mask
            vec_keep = vec > 0.0
            ft = scores.masked_fill(~ft_keep, 0.0)
            hi = ax.pmax(torch.maximum(ft.amax(dim=1), vec.amax(dim=1)))
            span = torch.where(hi > 0.0, hi, torch.ones_like(hi))
            fused = (ft + vec) / span[:, None]
            if has_omc:
                fused = fused * omc[None, :]
            present = ft_keep | vec_keep
            counts = ax.psum(present.sum(dim=1, dtype=torch.int32))
            fused = fused.masked_fill(~present, -INF)
            vals, ids = _merge_topk(ax, fused, k)
            return vals, ids, counts

        return shard_fn

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
        omc_key: Optional[int] = None,
        vector_index=None,             # hybrid: engine VectorIndex
        queries: Optional[np.ndarray] = None,
        similarities: Optional[Sequence[float]] = None,
        rescale: Optional[Tuple[float, float]] = None,
        candidates: Optional[int] = None,
        token_weight_of: Optional[Dict[str, float]] = None,
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Mesh-sharded batched search. Returns None when a hybrid batch
        can't shard its vector layout (callers fall back)."""
        hybrid = vector_index is not None
        vecs = vec8t = None
        if hybrid:
            vecs = self.ensure_vectors(vector_index)
            if vecs is None:
                vec8t = self.ensure_vectors_int8(vector_index)
                if vec8t is None:
                    return None
        dev_slab, boundaries, bprefix = self.ensure_slab(index)
        D = self.D
        u_ranges, _champs, token_map_global, classes, B, T = (
            analyze_shared_batch(
                index, tokens_per_query, properties, boost, field_params,
                # impact_cap cutpoints don't align to the boundary
                # prefix; the mesh spreads work 1/D per shard instead
                exact, tolerance, None, use_champions=False,
                token_weight_of=token_weight_of,
            )
        )
        cap_l = round_up_pow2((cap + D - 1) // D, 128)
        kb = min(round_up_pow2(k, 8), cap_l)

        has_masks = doc_masks is not None and any(
            m is not None for m in doc_masks
        )
        mask_dev = None
        if has_masks:
            gm = np.ones((B, cap), bool)
            for i, m in enumerate(doc_masks):
                if m is not None:
                    gm[i, : len(m)] = m
                    gm[i, len(m):] = False
            mask_dev = self._put(self._partition_docs_axis(gm, cap_l, False))
        has_omc = omc is not None
        omc_dev = None
        if has_omc:
            go = np.ones((cap,), np.float32)
            go[: min(len(omc), cap)] = omc[:cap]
            omc_dev = self._put(
                self._partition_docs_axis(go, cap_l, np.float32(1.0)))

        scores = Sharded(torch.zeros((B, cap_l), dtype=torch.float32,
                                     device=d) for d in self.mesh.devices)
        matched = Sharded(torch.zeros((B, cap_l), dtype=torch.float32,
                                      device=d) for d in self.mesh.devices)
        nd = float(max(n_docs, 1.0))
        for lr_class, uids in classes.items():
            if not uids:
                continue
            cu = SHARED_CHUNK_BY_CLASS[lr_class]
            st, ln, wt, fb, av, tmap, _lrb = pack_shared_class(
                u_ranges, uids, token_map_global, B, T, cu
            )
            s_st, s_ln = self._shard_ranges_on(
                boundaries, bprefix, D, st, ln
            )  # (D, Up, NRb)
            lrb = round_up_pow2(max(1, int(s_ln.max())), 8)
            step = self._get_shared_step(
                lr=int(lrb), cap_l=int(cap_l), cu=cu, exact=exact,
                has_mask=has_masks,
            )
            self.mesh.run(
                step, *dev_slab, self._put(s_st), self._put(s_ln),
                self._rep(wt), self._rep(fb), self._rep(av),
                self._rep(tmap), nd, mask_dev, scores, matched,
            )

        thr = np.zeros((B,), np.float32)
        if thresholds is not None:
            for i, t in enumerate(thresholds):
                thr[i] = t or 0.0
        if not hybrid:
            step = self._get_finalize_step(
                cap_l=int(cap_l), k=int(kb), has_omc=has_omc,
            )
            out = self.mesh.run(step, scores, matched, self._rep(thr),
                                omc_dev)
        else:
            q = self._rep(np.asarray(queries, np.float32))
            sims = self._rep(np.asarray(similarities, np.float32))
            rkw = dict(
                has_rescale=rescale is not None,
                rescale_lo=float(rescale[0]) if rescale else 0.0,
                rescale_hi=float(rescale[1]) if rescale else 1.0,
            )
            if vecs is not None:
                step = self._get_hybrid_tail_step(
                    cap_l=int(cap_l), k=int(kb), has_omc=has_omc,
                    has_mask=has_masks, **rkw,
                )
                out = self.mesh.run(step, scores, matched, self._rep(thr),
                                    sims, *vecs, q, mask_dev, omc_dev)
            else:
                (mat8, sc8, doc8, unit_cen, owner, unit_local,
                 window) = vec8t
                V = round_up_pow2(
                    min(candidates or HYBRID_INT8_CANDIDATES,
                        D * int(mat8[0].shape[0]),
                        round_up_pow2(cap, 8)), 8
                )
                nprobe = min(_vi.IVF_NPROBE, int(unit_cen[0].shape[0]))
                step = self._get_hybrid_int8_tail_step(
                    cap_l=int(cap_l), k=int(kb), V=int(V),
                    nprobe=int(nprobe), window=int(window),
                    has_omc=has_omc, has_mask=has_masks, **rkw,
                )
                out = self.mesh.run(
                    step, scores, matched, self._rep(thr), sims, q,
                    mat8, sc8, doc8, unit_cen, owner, unit_local,
                    mask_dev, omc_dev,
                )
        vals, ids, counts = (t.cpu().numpy() for t in out[0])
        return vals[:, :k], ids[:, :k], counts[:B]
