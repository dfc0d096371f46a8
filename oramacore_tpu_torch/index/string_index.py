"""Full-text string index of the port: live host layer + committed slab.

The port's own copy of `oramacore_tpu/index/string_index.py`, host numpy
code with the same names and the same slab layout, so the executors of
`index/search_exec.py` upload it to the card as the JAX executors upload
the JAX index to the TPU:

- The LIVE (uncommitted) layer is small host dicts, bounded by the
  commit threshold.
- COMMIT packs all postings into flat arrays (doc, tf, exact_tf,
  field_len per posting), a CSR over (field, term). Commits append a
  segment; a full merge runs when deletes must be pruned, when a path
  reaches MAX_SEGMENTS, or on request.
- Term matching: every token occurrence indexes its SURFACE form
  (tf += 1, exact_tf += 1) and each variant (tf += 1); consecutive
  surface tokens also index an adjacency bigram. `tolerance` expands a
  query token to all terms within that Levenshtein distance.
- Deletes of committed docs are tombstones applied as a score mask;
  commit makes them physical.

The live layer's bump loop runs in the native (C++) live accumulator
(`native/live_accum.cpp`, `native.NativeLiveAccum`) by default, as in the
JAX module; `ORAMACORE_NATIVE_LIVE=0` keeps it in Python, the semantic
oracle the native one is tested against. `index_text_packed` takes the
writer's packed wire payload straight to it. Left out of the copy: the
msgpack snapshots. `plan_query`'s body, with its `with_prefix` (pruned
tier) branch, is `index/plan.py::plan_query`.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..native import ROUTES
from ..ops.bm25 import MAX_RANGE_LEN
from ..utils.tokenizer import pack_parsed

DEFAULT_B = 0.75  # reference BM25FFieldParams::default (bm25.rs:56-63)
MAX_RANGES = 64   # cap on posting ranges per (query token)
BIGRAM_SEP = "\x1f"  # adjacency shadow-term separator (never in tokens)
# CHAMPION ROWS: committed terms with at least this many postings get a
# precomputed dense normalized-TF row at slab build, so a heavy term
# costs ONE dense row-add at query time instead of gathering and
# aggregating hundreds of thousands of postings
CHAMPION_MIN = 32768
MAX_CHAMPIONS = 64
# committed segments per field before a commit triggers a full merge
MAX_SEGMENTS = 8
# impact-prefix side blocks: committed terms with more than this many
# postings get a copy of their top-PREFIX_LEN postings (by normalized-TF
# impact, tf/flen) appended to the segment, for the pruned tier's
# candidate nomination. Main ranges stay DOC-SORTED.
PREFIX_LEN = 65536

# token range lists cut at MAX_RANGES after coalescing (the JAX package
# counts these in its metrics.RANGE_TRUNCATIONS)
RANGE_TRUNCATIONS = 0

_log = logging.getLogger("oramacore_tpu_torch.string_index")


def use_native_live() -> bool:
    """Native live accumulator opt-out (ORAMACORE_NATIVE_LIVE=0)."""
    return os.environ.get("ORAMACORE_NATIVE_LIVE", "1") != "0"


@dataclass
class FieldStats:
    doc_count: int = 0
    sum_len: float = 0.0

    @property
    def avg_len(self) -> float:
        return self.sum_len / self.doc_count if self.doc_count else 1.0


_SEGMENT_UIDS = itertools.count(1)


@dataclass
class _CommittedField:
    """Committed per-field postings in CSR form (host copies)."""

    terms: List[str]                      # sorted
    starts: np.ndarray                    # int64[n_terms] into the field block
    lens: np.ndarray                      # int32[n_terms]
    doc: np.ndarray                       # int32[P_f]
    tf: np.ndarray                        # float32[P_f]
    exact_tf: np.ndarray                  # float32[P_f]
    flen: np.ndarray                      # float32[P_f]
    stats: FieldStats = field(default_factory=FieldStats)
    # process-unique id: the committed slab portion caches on the tuple
    # of segment uids, so a commit that appends one segment only repacks
    # that segment
    uid: int = field(default_factory=lambda: next(_SEGMENT_UIDS))
    # impact-prefix side block (terms with len > PREFIX_LEN): duplicated
    # top-impact postings, NOT part of the CSR proper (merges and stats
    # ignore them): tid -> (start-in-block, len), plus the block arrays
    prefix_ranges: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    pdoc: Optional[np.ndarray] = None
    ptf: Optional[np.ndarray] = None
    petf: Optional[np.ndarray] = None
    pflen: Optional[np.ndarray] = None


def _levenshtein_within(a: str, b: str, k: int) -> bool:
    """True if edit distance(a, b) <= k (banded DP with early exit)."""
    la, lb = len(a), len(b)
    if abs(la - lb) > k:
        return False
    if k == 0:
        return a == b
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        row_min = cur[0]
        ca = a[i - 1]
        for j in range(1, lb + 1):
            cost = 0 if ca == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            row_min = min(row_min, cur[j])
        if row_min > k:
            return False
        prev = cur
    return prev[lb] <= k


def _coalesce_and_cap(
    ranges: List[Tuple[int, int, float, float, float]], token: str
) -> List[Tuple[int, int, float, float, float]]:
    """Bound a token's posting ranges at MAX_RANGES without silent loss:
    coalesce start-adjacent ranges with identical field params first,
    then truncate, keeping the first-matched (closest under tolerance)
    ranges, with a count in RANGE_TRUNCATIONS and a warning."""
    global RANGE_TRUNCATIONS
    if len(ranges) <= MAX_RANGES:
        return ranges
    srt = sorted(range(len(ranges)), key=lambda i: ranges[i][0])
    merged: List[Tuple[int, int, float, float, float, int]] = []
    for i in srt:
        s, l, w, fb, av = ranges[i]
        if merged:
            ms, ml, mw, mfb, mav, mp = merged[-1]
            if (ms + ml == s and (mw, mfb, mav) == (w, fb, av)
                    and ml + l <= MAX_RANGE_LEN):
                merged[-1] = (ms, ml + l, mw, mfb, mav, min(mp, i))
                continue
        merged.append((s, l, w, fb, av, i))
    merged.sort(key=lambda m: m[5])  # restore closest-first priority
    if len(merged) > MAX_RANGES:
        RANGE_TRUNCATIONS += 1
        _log.warning(
            "token %r matched %d posting ranges (%d after coalescing); "
            "truncated to %d closest-match ranges",
            token, len(ranges), len(merged), MAX_RANGES,
        )
    return [m[:5] for m in merged[:MAX_RANGES]]


@dataclass
class QueryPlan:
    """Padded posting-range descriptors for one query, feeding the kernel.

    Shapes: (T, NR) for starts/lens/weights/field_b/avg_flen. The pruned
    tier's fields are set by `plan_query(..., with_prefix=True)` only:
    pre_* (T, NPR) impact-prefix nomination ranges, range_field and
    range_span (T, NR) each main range's field and span ordinals (-1 =
    padding), spans[t] the token's (field ordinal, term ordinal, start,
    len) spans.
    """

    starts: np.ndarray
    lens: np.ndarray
    weights: np.ndarray
    field_b: np.ndarray
    avg_flen: np.ndarray
    n_tokens: int
    max_range_len: int
    # champion slots: (T, NC) row index into the champion matrix (-1 =
    # none) and the query-time weight to apply to the row
    champ_idx: Optional[np.ndarray] = None
    champ_w: Optional[np.ndarray] = None
    pre_starts: Optional[np.ndarray] = None
    pre_lens: Optional[np.ndarray] = None
    pre_weights: Optional[np.ndarray] = None
    pre_field_b: Optional[np.ndarray] = None
    pre_avg: Optional[np.ndarray] = None
    range_field: Optional[np.ndarray] = None
    range_span: Optional[np.ndarray] = None
    spans: Optional[List[List[Tuple[int, int, int, int]]]] = None


_INDEX_UIDS = itertools.count(1)


class StringIndex:
    """All string fields of one index."""

    def __init__(self, index_bigrams: bool = True):
        # process-unique id: executor device caches key on (uid,
        # generation); generation alone collides across index objects
        self.uid = next(_INDEX_UIDS)

        # adjacency shadow terms for phrase capability (see index_text)
        self.index_bigrams = index_bigrams

        # live layer lookup: path -> term -> doc_id -> row index into the
        # flat per-path accumulator below. The flat layout makes commit
        # and slab build O(rows) numpy conversions instead of per-term
        # Python loops.
        self._live: Dict[str, Dict[str, Dict[int, int]]] = {}
        # flat accumulators: path -> parallel lists
        #   (doc, local_tid, tf, exact_tf); deleted rows get doc=-1
        self._live_rows: Dict[str, Tuple[list, list, list, list]] = {}
        # local term table: path -> (term -> local id, [terms by id])
        self._live_terms: Dict[str, Tuple[Dict[str, int], List[str]]] = {}
        # native (C++) live accumulator: the bump loop in C++; None -> the
        # Python layer above. A library that does not build raises.
        self._native_live = None
        if use_native_live():
            from ..native import NativeLiveAccum, load_live_accum

            self._native_live = NativeLiveAccum(load_live_accum())
        # live field lengths: path -> doc_id -> token count
        self._live_flens: Dict[str, Dict[int, int]] = {}
        # live doc -> [(path, term)] for physical live deletes
        self._live_doc_terms: Dict[int, List[Tuple[str, str]]] = {}
        # committed segments per path
        self._committed: Dict[str, List[_CommittedField]] = {}
        self._stats: Dict[str, FieldStats] = {}
        # search slab (built lazily), [committed | live]: the committed
        # portion (arrays + ranges + champion rows) caches on the tuple of
        # segment uids and only rebuilds after a commit, so the rebuild
        # between commits is O(live rows). `slab()` concatenates the full
        # host view; the executors consume `slab_split()` and append the
        # live part to a cached device buffer.
        self._slab_arrays: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = None
        self._slab_committed: Optional[Tuple] = None  # (key, arrays4, ranges, terms_by_field, total)
        self._slab_live_arrays: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = None
        self._slab_ranges: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
        self._slab_live_ranges: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
        self._slab_prefix_ranges: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
        self._slab_terms_by_field: Dict[str, List[str]] = {}
        self._slab_live_terms: Dict[str, List[str]] = {}
        self._term_matrix_cache: Dict[str, Tuple] = {}
        self._dirty = True
        # monotonically increasing slab generation: device-slab caches key
        # on this (id() of a replaced numpy array can collide after free)
        self.generation = 0
        # champion rows (built with the slab)
        self._champ_map: Dict[Tuple[str, str], int] = {}
        self._champ_matrix: Optional[np.ndarray] = None
        self._champ_meta: List[Tuple[float, frozenset]] = []
        # searches may race the lazy rebuild of a dirty index; serialize it
        self._build_lock = threading.Lock()

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def field_paths(self) -> List[str]:
        return sorted(self._stats.keys())

    def field_stats(self, path: str) -> FieldStats:
        return self._stats.setdefault(path, FieldStats())

    def has_field(self, path: str) -> bool:
        return path in self._stats

    def ensure_field(self, path: str) -> None:
        self._stats.setdefault(path, FieldStats())

    def term_count(self) -> int:
        n = sum(
            len(seg.terms)
            for segs in self._committed.values()
            for seg in segs
        )
        if self._native_live is not None:
            return n + sum(self._native_live.n_terms(p)
                           for p in self._native_live.live_paths())
        return n + sum(len(t) for t in self._live.values())

    def pending_ops(self) -> int:
        return sum(len(d) for d in self._live_flens.values())

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def index_text(
        self,
        doc_id: int,
        path: str,
        parsed: Sequence[Tuple[str, List[str]]],
    ) -> None:
        """Index one field value: `parsed` is tokenize_and_stem output
        (surface, [variants]) per token."""
        self.index_text_packed(doc_id, path, *pack_parsed(parsed or []))

    def index_text_packed(
        self, doc_id: int, path: str, n_tokens: int, payload: str
    ) -> None:
        """Index one field value from the packed wire payload (token :=
        surface [\\x01 variant]*, payload := token (\\x02 token)*), which
        the writer builds once at tokenize time and the native
        accumulator consumes as it is."""
        flens = self._live_flens.setdefault(path, {})
        stats = self.field_stats(path)
        prev = flens.get(doc_id, 0)
        flens[doc_id] = prev + n_tokens  # multiple values (arrays) accumulate
        if prev == 0:
            stats.doc_count += 1
        stats.sum_len += n_tokens
        if self._native_live is not None:
            ROUTES["live_accum"]["native"] += 1
            if payload:
                self._native_live.index_packed(
                    path, doc_id, payload, self.index_bigrams)
            self._dirty = True
            return
        parsed: List[Tuple[str, List[str]]] = []
        if payload:
            for part in payload.split("\x02"):
                ps = part.split("\x01")
                parsed.append((ps[0], ps[1:]))
        self._index_parsed_python(doc_id, path, parsed)

    def _index_parsed_python(
        self,
        doc_id: int,
        path: str,
        parsed: Sequence[Tuple[str, List[str]]],
    ) -> None:
        """The Python live-layer accumulate: the semantic oracle of the
        native accumulator (ORAMACORE_NATIVE_LIVE=0)."""
        ROUTES["live_accum"]["python"] += 1
        field_live = self._live.setdefault(path, {})
        doc_terms = self._live_doc_terms.setdefault(doc_id, [])
        rows = self._live_rows.get(path)
        if rows is None:
            rows = self._live_rows[path] = ([], [], [], [])
            self._live_terms[path] = ({}, [])
        r_doc, r_tid, r_tf, r_etf = rows
        intern, term_names = self._live_terms[path]

        def bump(term: str, exact: bool):
            postings = field_live.setdefault(term, {})
            idx = postings.get(doc_id)
            if idx is None:
                lid = intern.get(term)
                if lid is None:
                    lid = len(term_names)
                    intern[term] = lid
                    term_names.append(term)
                postings[doc_id] = idx = len(r_doc)
                r_doc.append(doc_id)
                r_tid.append(lid)
                r_tf.append(0.0)
                r_etf.append(0.0)
                doc_terms.append((path, term))
            r_tf[idx] += 1.0
            if exact:
                r_etf[idx] += 1.0

        for surface, variants in parsed:
            bump(surface, True)
            for v in variants:
                bump(v, False)
        # ADJACENCY SHADOW TERMS: consecutive surface tokens also index a
        # bigram term (phrase capability without per-posting positions);
        # a phrase-boost query scores its bigrams as extra tokens
        if self.index_bigrams and len(parsed) > 1:
            for (a, _), (b, _) in zip(parsed, parsed[1:]):
                bump(a + BIGRAM_SEP + b, True)
        self._dirty = True

    def delete_doc_live(self, doc_id: int) -> None:
        """Physically remove a doc's live contributions (committed docs are
        masked by the caller's tombstone set until the next commit)."""
        if self._native_live is not None:
            if self._native_live.delete_doc(doc_id):
                self._dirty = True
        else:
            terms = self._live_doc_terms.pop(doc_id, None)
            if terms:
                for path, term in terms:
                    postings = self._live.get(path, {}).get(term)
                    if postings is not None:
                        idx = postings.pop(doc_id, None)
                        if idx is not None:
                            # tombstone the flat row (dropped at commit/slab)
                            self._live_rows[path][0][idx] = -1
                        if not postings:
                            self._live[path].pop(term, None)
                self._dirty = True
        for path, flens in self._live_flens.items():
            n = flens.pop(doc_id, None)
            if n is not None:
                stats = self.field_stats(path)
                stats.doc_count -= 1
                stats.sum_len -= n

    # ------------------------------------------------------------------
    # Commit: merge live into committed CSR, drop tombstoned docs
    # ------------------------------------------------------------------

    def commit(self, deleted: Optional[set] = None,
               force_merge: bool = False) -> None:
        """Segmented commit: the normal commit compacts only the live
        layer into one new immutable segment, O(live rows). A full merge
        of all segments (O(total postings)) runs only when deletes must
        be pruned, when a path reaches MAX_SEGMENTS, or with force_merge.

        Within every segment, postings are sorted by (term, doc) and
        duplicate pairs combined; terms with more than PREFIX_LEN
        postings also get an impact-ordered prefix block."""
        deleted = deleted or set()
        paths = (
            set(self._stats) | set(self._committed) | set(self._live_rows)
        )
        if self._native_live is not None:
            paths.update(self._native_live.live_paths())
        for path in paths:
            segs = self._committed.get(path, [])
            if deleted or force_merge or len(segs) + 1 > MAX_SEGMENTS:
                self._full_merge(path, deleted)
            else:
                seg = self._compact_live(path)
                if seg is not None:
                    self._committed.setdefault(path, []).append(seg)
        self._live.clear()
        self._live_rows.clear()
        self._live_terms.clear()
        self._live_flens.clear()
        self._live_doc_terms.clear()
        if self._native_live is not None:
            self._native_live.clear()
        self._dirty = True

    def _live_rows_arrays(self, path):
        """The live layer's flat rows for one path, from the native
        accumulator or the Python layer:
        (doc i64[n], local_tid i64[n], tf f64[n], etf f64[n], names)
        where names maps local term id -> term string. None when the path
        has no live rows (tombstoned-only counts as having rows)."""
        if self._native_live is not None:
            return self._native_live.rows(path)
        rows = self._live_rows.get(path)
        if rows is None or not rows[0]:
            return None
        _, names = self._live_terms[path]
        return (
            np.asarray(rows[0], np.int64),
            np.asarray(rows[1], np.int64),
            np.asarray(rows[2], np.float64),
            np.asarray(rows[3], np.float64),
            names,
        )

    def _live_paths(self) -> List[str]:
        if self._native_live is not None:
            return self._native_live.live_paths()
        return [p for p, r in self._live_rows.items() if r[0]]

    @staticmethod
    def _remap_live(arrs, terms_arr: np.ndarray):
        """Remap live rows to the (sorted) global vocab, dropping
        tombstoned rows: (tid, doc, tf, etf) or None. Every live name is
        in the union by construction; the clip guards tombstoned-only
        stragglers."""
        ld, lt_local, ltf, letf, names = arrs
        keep = ld >= 0  # drop delete-tombstoned rows
        if len(names) and len(terms_arr):
            # no dtype coercion: a fixed-width cast would TRUNCATE names
            # longer than the union's widest term
            lmap = np.minimum(
                np.searchsorted(terms_arr, np.asarray(names)),
                len(terms_arr) - 1,
            ).astype(np.int64)
        else:
            lmap = np.zeros(max(len(names), 1), np.int64)[: len(names)]
        lt = lmap[lt_local]
        if not keep.all():
            ld, lt = ld[keep], lt[keep]
            ltf, letf = ltf[keep], letf[keep]
        if not len(ld):
            return None
        return lt, ld, ltf, letf

    @staticmethod
    def _pack_segment(terms, t_all, d_all, tf_all, etf_all, flen_arr,
                      stats) -> "_CommittedField":
        """Dedup (term, doc) pairs and build DOC-SORTED CSR arrays, plus
        impact-prefix side blocks for heavy terms."""
        if len(t_all):
            # single combined (term << 40 | doc) key: one argsort instead
            # of a 2-key lexsort; lexsort when ids exceed the packed range
            packable = (
                len(terms) < (1 << 23)
                and (len(d_all) == 0
                     or (int(d_all.max()) < (1 << 40)
                         and int(d_all.min()) >= 0))
            )
            if packable:
                order = np.argsort((t_all << 40) | d_all, kind="stable")
            else:
                order = np.lexsort((d_all, t_all))
            t_all, d_all = t_all[order], d_all[order]
            tf_all, etf_all = tf_all[order], etf_all[order]
            new_run = np.empty(len(t_all), bool)
            new_run[0] = True
            new_run[1:] = (t_all[1:] != t_all[:-1]) | (d_all[1:] != d_all[:-1])
            run_id = np.cumsum(new_run) - 1
            n_runs = int(run_id[-1]) + 1
            tf_m = np.zeros(n_runs)
            etf_m = np.zeros(n_runs)
            np.add.at(tf_m, run_id, tf_all)
            np.add.at(etf_m, run_id, etf_all)
            t_m = t_all[new_run]
            d_m = d_all[new_run]
            flen_post = flen_arr[d_m]

            starts = np.searchsorted(t_m, np.arange(len(terms))).astype(np.int64)
            lens = np.diff(np.append(starts, len(t_m))).astype(np.int32)
        else:
            d_m = np.zeros(0, np.int64)
            tf_m = etf_m = np.zeros(0)
            flen_post = np.zeros(0)
            starts = np.zeros(len(terms), np.int64)
            lens = np.zeros(len(terms), np.int32)

        # drop terms that ended up empty (all postings deleted)
        nz = lens > 0
        if not nz.all():
            terms = [t for t, ok in zip(terms, nz) if ok]
            starts = starts[nz]
            lens = lens[nz]
        cf = _CommittedField(
            terms=terms,
            starts=starts,
            lens=lens,
            doc=d_m.astype(np.int32),
            tf=tf_m.astype(np.float32),
            exact_tf=etf_m.astype(np.float32),
            flen=flen_post.astype(np.float32),
            stats=stats,
        )
        StringIndex._build_prefix_blocks(cf)
        return cf

    @staticmethod
    def _build_prefix_blocks(cf: "_CommittedField") -> None:
        """Impact-prefix side blocks for terms with len > PREFIX_LEN:
        top-PREFIX_LEN postings by tf/flen impact, stored impact-
        descending."""
        heavy = np.nonzero(cf.lens > PREFIX_LEN)[0]
        if not len(heavy):
            return
        pd, pt, pe, pf = [], [], [], []
        off = 0
        for tid in heavy:
            s, n = int(cf.starts[tid]), int(cf.lens[tid])
            imp = cf.tf[s:s + n] / np.maximum(cf.flen[s:s + n], 1e-9)
            sel = np.argpartition(-imp, PREFIX_LEN)[:PREFIX_LEN]
            sel = sel[np.argsort(-imp[sel], kind="stable")] + s
            pd.append(cf.doc[sel])
            pt.append(cf.tf[sel])
            pe.append(cf.exact_tf[sel])
            pf.append(cf.flen[sel])
            cf.prefix_ranges[int(tid)] = (off, PREFIX_LEN)
            off += PREFIX_LEN
        cf.pdoc = np.concatenate(pd)
        cf.ptf = np.concatenate(pt)
        cf.petf = np.concatenate(pe)
        cf.pflen = np.concatenate(pf)

    def _compact_live(self, path) -> Optional["_CommittedField"]:
        """Live layer -> one new segment; O(live rows)."""
        arrs = self._live_rows_arrays(path)
        if arrs is None:
            return None
        # vocab = the intern table (may include fully deleted terms;
        # _pack_segment drops terms that end up with no postings)
        terms_arr = np.unique(np.asarray(arrs[4]))
        terms = terms_arr.tolist()
        parts = self._remap_live(arrs, terms_arr)
        if parts is None:
            return None
        lt, ld, ltf, letf = parts
        live_flens = self._live_flens.get(path, {})
        max_doc = int(ld.max())
        flen_arr = np.zeros(max_doc + 1, np.float64)
        if live_flens:
            fd = np.fromiter(live_flens.keys(), np.int64, len(live_flens))
            fv = np.fromiter(live_flens.values(), np.float64, len(live_flens))
            sel = fd <= max_doc
            flen_arr[fd[sel]] = fv[sel]
        s = self._stats.get(path) or FieldStats()
        stats = FieldStats(s.doc_count, s.sum_len)
        return self._pack_segment(terms, lt, ld, ltf, letf, flen_arr, stats)

    @staticmethod
    def _segment_tids(seg: "_CommittedField", terms_arr: np.ndarray) -> np.ndarray:
        """Per-posting global term ids for a segment: one np.repeat when
        the segment stores postings contiguously in ascending tid order,
        else a slice loop."""
        pos = np.searchsorted(
            terms_arr, np.asarray(seg.terms)
        ).astype(np.int64)
        lens64 = seg.lens.astype(np.int64)
        if int(lens64.sum()) == len(seg.doc) and (
            len(seg.starts) == 0
            or bool((np.diff(seg.starts) >= 0).all())
        ):
            return np.repeat(pos, lens64)
        out = np.empty(len(seg.doc), np.int64)
        for tid in range(len(seg.terms)):
            s, l = int(seg.starts[tid]), int(seg.lens[tid])
            out[s : s + l] = pos[tid]
        return out

    def _full_merge(self, path, deleted: set) -> None:
        segs = self._committed.get(path, [])
        arrs = self._live_rows_arrays(path)

        # sorted vocab union: segments' term lists are already sorted
        vocab_parts = [np.asarray(seg.terms) for seg in segs if seg.terms]
        if arrs is not None and arrs[4]:
            vocab_parts.append(np.unique(np.asarray(arrs[4])))
        if vocab_parts:
            terms_arr = np.unique(np.concatenate(vocab_parts))
        else:
            terms_arr = np.asarray([], dtype="U1")
        terms = terms_arr.tolist()

        parts_t: List[np.ndarray] = []
        parts_d: List[np.ndarray] = []
        parts_tf: List[np.ndarray] = []
        parts_etf: List[np.ndarray] = []
        for seg in segs:
            if not len(seg.doc):
                continue
            parts_t.append(self._segment_tids(seg, terms_arr))
            parts_d.append(seg.doc.astype(np.int64))
            parts_tf.append(seg.tf.astype(np.float64))
            parts_etf.append(seg.exact_tf.astype(np.float64))
        lp = self._remap_live(arrs, terms_arr) if arrs is not None else None
        if lp is not None:
            lt, ld, ltf, letf = lp
            parts_t.append(lt)
            parts_d.append(ld)
            parts_tf.append(ltf)
            parts_etf.append(letf)

        # field lengths per doc (committed values + live additions)
        max_doc = -1
        for seg in segs:
            if len(seg.doc):
                max_doc = max(max_doc, int(seg.doc.max()))
        live_flens = self._live_flens.get(path, {})
        if live_flens:
            max_doc = max(max_doc, max(live_flens))
        if max_doc < 0:
            self._committed.pop(path, None)
            self._stats[path] = FieldStats()
            return
        flen_arr = np.zeros(max_doc + 1, np.float64)
        for seg in segs:
            if len(seg.doc):
                # docs are disjoint across segments (each doc's postings
                # are compacted exactly once), so assignment is safe
                flen_arr[seg.doc.astype(np.int64)] = seg.flen.astype(np.float64)
        if live_flens:
            fd = np.fromiter(live_flens.keys(), np.int64, len(live_flens))
            fv = np.fromiter(live_flens.values(), np.float64, len(live_flens))
            flen_arr[fd] += fv

        t_all = np.concatenate(parts_t) if parts_t else np.zeros(0, np.int64)
        d_all = np.concatenate(parts_d) if parts_d else np.zeros(0, np.int64)
        tf_all = np.concatenate(parts_tf) if parts_tf else np.zeros(0)
        etf_all = np.concatenate(parts_etf) if parts_etf else np.zeros(0)

        if deleted:
            keep = ~np.isin(d_all, np.fromiter(deleted, np.int64, len(deleted)))
            t_all, d_all = t_all[keep], d_all[keep]
            tf_all, etf_all = tf_all[keep], etf_all[keep]

        present = flen_arr > 0
        if deleted:
            for d in deleted:
                if d < len(present):
                    present[d] = False
        stats = FieldStats(
            doc_count=int(present.sum()),
            sum_len=float(flen_arr[present].sum()),
        )
        merged = self._pack_segment(
            terms, t_all, d_all, tf_all, etf_all, flen_arr, stats
        )
        if not len(merged.doc):
            self._committed.pop(path, None)
            self._stats[path] = FieldStats()
            return
        self._committed[path] = [merged]
        self._stats[path] = FieldStats(stats.doc_count, stats.sum_len)

    # ------------------------------------------------------------------
    # Search slab: flat arrays merging committed + live
    # ------------------------------------------------------------------

    def _build_slab(self) -> None:
        with self._build_lock:
            if not self._dirty and self._slab_committed is not None:
                return  # another reader already rebuilt it
            self._build_slab_locked()

    def _committed_key(self) -> Tuple:
        return tuple(
            (path, tuple(cf.uid for cf in segs))
            for path, segs in sorted(self._committed.items())
        )

    def _build_slab_locked(self) -> None:
        ck = self._committed_key()
        cached = self._slab_committed
        if cached is None or cached[0] != ck:
            docs_parts: List[np.ndarray] = []
            tf_parts: List[np.ndarray] = []
            etf_parts: List[np.ndarray] = []
            flen_parts: List[np.ndarray] = []
            ranges: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
            terms_by_field: Dict[str, set] = {}
            prefix_ranges: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
            offset = 0
            for path, segs in self._committed.items():
                tset = terms_by_field.setdefault(path, set())
                for cf in segs:
                    n = len(cf.doc)
                    if n:
                        docs_parts.append(cf.doc)
                        tf_parts.append(cf.tf)
                        etf_parts.append(cf.exact_tf)
                        flen_parts.append(cf.flen)
                    for tid, term in enumerate(cf.terms):
                        ranges.setdefault((path, term), []).append(
                            (offset + int(cf.starts[tid]), int(cf.lens[tid]))
                        )
                        tset.add(term)
                    offset += n
                    # the impact-prefix side block rides the slab right
                    # after the segment's CSR region
                    if cf.pdoc is not None:
                        for tid, (ps, pl) in cf.prefix_ranges.items():
                            prefix_ranges.setdefault(
                                (path, cf.terms[tid]), []
                            ).append((offset + ps, pl))
                        docs_parts.append(cf.pdoc)
                        tf_parts.append(cf.ptf)
                        etf_parts.append(cf.petf)
                        flen_parts.append(cf.pflen)
                        offset += len(cf.pdoc)
            if offset:
                comm_arrays = (
                    np.concatenate(docs_parts),
                    np.concatenate(tf_parts),
                    np.concatenate(etf_parts),
                    np.concatenate(flen_parts),
                )
            else:
                comm_arrays = None
            tbf = {p: sorted(ts) for p, ts in terms_by_field.items()}
            self._slab_committed = (ck, comm_arrays, ranges, tbf, offset)
            self._slab_prefix_ranges = prefix_ranges
            # champion rows reference committed ranges only: rebuild with
            # the committed portion, not per live generation
            self._build_champions(
                comm_arrays
                if comm_arrays is not None
                else (
                    np.zeros(1, np.int32), np.zeros(1, np.float32),
                    np.zeros(1, np.float32), np.ones(1, np.float32),
                )
            )
        _ck, comm_arrays, comm_ranges, comm_tbf, offset = (
            self._slab_committed
        )
        self._slab_ranges = comm_ranges
        self._slab_terms_by_field = comm_tbf

        docs_parts = []
        tf_parts = []
        etf_parts = []
        flen_parts = []
        ranges: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
        terms_by_field: Dict[str, set] = {}

        # live pack: one vectorized (tid, doc) sort of the flat
        # accumulator per path; per-term work is only the ranges dict
        for path in self._live_paths():
            arrs = self._live_rows_arrays(path)
            if arrs is None:
                continue
            ld, lt, ltf64, letf64, term_names = arrs
            flens = self._live_flens.get(path, {})
            tset = terms_by_field.setdefault(path, set())
            keep = ld >= 0
            lt = lt[keep]
            ld = ld[keep]
            ltf = ltf64[keep].astype(np.float32)
            letf = letf64[keep].astype(np.float32)
            if not len(ld):
                continue
            order = np.lexsort((ld, lt))
            lt, ld = lt[order], ld[order]
            ltf, letf = ltf[order], letf[order]
            # dense flen lookup (live docs only)
            if flens:
                fd = np.fromiter(flens.keys(), np.int64, len(flens))
                fv = np.fromiter(flens.values(), np.float64, len(flens))
                dense = np.ones(int(fd.max()) + 1, np.float64)
                dense[fd] = fv
                lflen = dense[np.clip(ld, 0, len(dense) - 1)].astype(np.float32)
            else:
                lflen = np.ones(len(ld), np.float32)
            docs_parts.append(ld.astype(np.int32))
            tf_parts.append(ltf)
            etf_parts.append(letf)
            flen_parts.append(lflen)
            # per-term ranges: run boundaries of the sorted tid column
            boundaries = np.flatnonzero(
                np.concatenate(([True], lt[1:] != lt[:-1]))
            )
            run_lens = np.diff(np.concatenate((boundaries, [len(lt)])))
            for b, rl in zip(boundaries.tolist(), run_lens.tolist()):
                term = term_names[int(lt[b])]
                ranges.setdefault((path, term), []).append(
                    (offset + b, int(rl))
                )
                tset.add(term)
            offset += len(ld)

        if docs_parts:
            self._slab_live_arrays = (
                np.concatenate(docs_parts),
                np.concatenate(tf_parts),
                np.concatenate(etf_parts),
                np.concatenate(flen_parts),
            )
        else:
            self._slab_live_arrays = None
        self._slab_live_ranges = ranges
        self._slab_live_terms = {
            p: sorted(ts) for p, ts in terms_by_field.items()
        }
        self._slab_arrays = None  # full host view rebuilt lazily
        self._term_matrix_cache = {}
        self.generation += 1
        self._dirty = False

    def slab_split(self):
        """(committed arrays4 | None, live arrays4 | None, committed_key):
        the incremental-upload view. The committed portion is stable
        between commits, so device caches append only the live part per
        generation."""
        if self._dirty or self._slab_committed is None:
            self._build_slab()
        ck, comm_arrays, _r, _t, _off = self._slab_committed
        return comm_arrays, self._slab_live_arrays, ck

    def _concat_slab(self):
        parts = []
        ck, comm_arrays, _r, _t, _off = self._slab_committed
        if comm_arrays is not None:
            parts.append(comm_arrays)
        if self._slab_live_arrays is not None:
            parts.append(self._slab_live_arrays)
        if not parts:
            return (
                np.zeros(1, np.int32),
                np.zeros(1, np.float32),
                np.zeros(1, np.float32),
                np.ones(1, np.float32),
            )
        if len(parts) == 1:
            return parts[0]
        return tuple(
            np.concatenate([p[i] for p in parts]) for i in range(4)
        )

    def _build_champions(self, arrays) -> None:
        """Dense normalized-TF rows for the heaviest COMMITTED terms.

        Rows bake the default b and the field's current avg length;
        planning routes a token through its champion only when the
        query-time params match. Live postings of the same term stay as
        ranges and add on top, so champions never go stale mid-commit."""
        self._champ_map = {}
        self._champ_matrix = None
        # (avg, covered): covered is the frozenset of slab ranges the
        # champion row replaces (a term may span several segments)
        self._champ_meta = []
        by_term: Dict[Tuple[str, str], List[Tuple[int, int]]] = {}
        offset = 0
        for path, segs in self._committed.items():
            for cf in segs:
                for tid, term in enumerate(cf.terms):
                    ln = int(cf.lens[tid])
                    if ln >= CHAMPION_MIN // max(len(segs), 1):
                        by_term.setdefault((path, term), []).append(
                            (offset + int(cf.starts[tid]), ln)
                        )
                offset += len(cf.doc)
                if cf.pdoc is not None:  # prefix block rides after the CSR
                    offset += len(cf.pdoc)
        heavy = [
            (sum(ln for _, ln in rngs), path, term, rngs)
            for (path, term), rngs in by_term.items()
            if sum(ln for _, ln in rngs) >= CHAMPION_MIN
        ]
        if not heavy:
            return
        heavy.sort(reverse=True)
        heavy = heavy[:MAX_CHAMPIONS]
        p_doc, p_tf, _etf, p_flen = arrays
        cap = int(p_doc.max()) + 1 if len(p_doc) else 1
        rows = np.zeros((len(heavy), cap), np.float32)
        for ci, (_total, path, term, rngs) in enumerate(heavy):
            stats = self._stats.get(path)
            avg = stats.avg_len if stats and stats.avg_len > 0 else 1.0
            for start, ln in rngs:
                d = p_doc[start:start + ln]
                tf = p_tf[start:start + ln]
                fl = p_flen[start:start + ln]
                denom = (1.0 - DEFAULT_B) + DEFAULT_B * fl / max(avg, 1e-9)
                # accumulate (not assign): commits dedup (term, doc) pairs
                # within a segment, but the ranged path SUMS duplicates
                # across segments
                np.add.at(rows[ci], d, tf / np.maximum(denom, 1e-9))
            self._champ_map[(path, term)] = ci
            self._champ_meta.append((float(avg), frozenset(rngs)))
        self._champ_matrix = rows

    # length buckets for the fuzzy-match term matrices: per-bucket width
    # bounds the padded memory at about 4 bytes per character
    _FUZZY_BUCKETS = (4, 8, 12, 16, 24, 32, 48, 64)

    def _term_matrix(self, path: str):
        """Length-bucketed codepoint matrices for vectorized fuzzy
        matching: list of (terms, mat uint32[n, W], lens int32[n], sig,
        cnt) per bucket. Cached per slab generation."""
        if self._dirty or self._slab_committed is None:
            self._build_slab()
        cached = self._term_matrix_cache.get(path)
        if cached is not None:
            return cached
        terms = [
            t for t in self._slab_terms_by_field.get(path, [])
            if BIGRAM_SEP not in t  # adjacency shadow terms aren't words
        ]
        live = self._slab_live_terms.get(path)
        if live:
            seen = set(terms)
            terms += [
                t for t in live if t not in seen and BIGRAM_SEP not in t
            ]
        by_bucket: Dict[int, List[str]] = {}
        for t in terms:
            for w in self._FUZZY_BUCKETS:
                if len(t) <= w:
                    by_bucket.setdefault(w, []).append(t)
                    break
            else:
                # longer than the largest bucket: an own exact-width
                # bucket per length keeps them matchable without padding
                by_bucket.setdefault(len(t), []).append(t)
        buckets = []
        for w in sorted(by_bucket):
            bt = by_bucket[w]
            n = len(bt)
            lens = np.fromiter((len(t) for t in bt), np.int32, n)
            # vectorized fill: one encode of the joined bucket, then a
            # single fancy-index scatter
            flat = np.frombuffer(
                "".join(bt).encode("utf-32-le"), np.uint32
            )
            mat = np.zeros((n, w), np.uint32)
            rows = np.repeat(np.arange(n, dtype=np.int64), lens)
            offs = np.zeros(n, np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            cols = np.arange(len(flat), dtype=np.int64) - offs[rows]
            mat[rows, cols] = flat
            # per-term prefilter features (both LOWER BOUNDS on edit
            # distance, so filtering on them never drops a true match):
            #  - sig: 64-bit char-class presence mask; one edit flips <= 2
            #    bits, so popcount(sig_a ^ sig_b) <= 2k for ed <= k
            #  - cnt: hashed char counts (16 classes); bag distance
            #    max(|A-B|, |B-A|) <= ed
            h = ((mat.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
                 >> np.uint64(58)).astype(np.uint32)
            present = mat != 0
            sig = np.bitwise_or.reduce(
                np.where(present, np.uint64(1) << h.astype(np.uint64),
                         np.uint64(0)), axis=1)
            cls = h & 15
            idx = (rows * 16 + cls[rows, cols]).astype(np.int64)
            cnt = np.bincount(idx, minlength=n * 16).astype(
                np.int16).reshape(n, 16)
            buckets.append((bt, mat, lens, sig, cnt))
        self._term_matrix_cache[path] = buckets
        return buckets

    def _fuzzy_match(self, path: str, token: str, k: int):
        """All terms within edit distance k of token, ordered by (distance,
        term). A banded Wagner-Fischer vectorized ACROSS candidates: the
        Python loops run over the token / term lengths; every op is a
        numpy vector over the prefiltered candidate set."""
        buckets = self._term_matrix(path)
        tl = len(token)
        tok_codes = np.frombuffer(token.encode("utf-32-le"), np.uint32)
        th = ((tok_codes.astype(np.uint64) *
               np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(58))
        tok_sig = np.bitwise_or.reduce(
            np.uint64(1) << th, initial=np.uint64(0))
        tok_cnt = np.bincount(
            (th & np.uint64(15)).astype(np.int64), minlength=16
        ).astype(np.int16)
        hits = []
        for terms, mat, lens, sig, cnt in buckets:
            W = mat.shape[1]
            if tl - k > W or (lens.max(initial=0) < tl - k):
                continue
            # cascade of edit-distance lower bounds, each pass over the
            # previous pass's survivors; the DP runs on the remainder
            band = np.abs(lens.astype(np.int64) - tl) <= k
            cand = np.nonzero(band)[0]
            if not len(cand):
                continue
            sv = cand[np.bitwise_count(sig[cand] ^ tok_sig) <= 2 * k]
            if not len(sv):
                continue
            diff = cnt[sv].astype(np.int32) - tok_cnt.astype(np.int32)
            bag = np.maximum(
                np.where(diff > 0, diff, 0).sum(axis=1),
                np.where(diff < 0, -diff, 0).sum(axis=1),
            )
            cand = sv[bag <= k]
            if not len(cand):
                continue
            sub = mat[cand]
            sublens = lens[cand]
            L = int(sublens.max()) if len(sublens) else 0
            n = len(cand)
            prev = np.broadcast_to(
                np.arange(L + 1, dtype=np.int32), (n, L + 1)
            ).copy()
            for i in range(1, tl + 1):
                cur = np.empty((n, L + 1), np.int32)
                cur[:, 0] = i
                cost = (sub[:, :L] != tok_codes[i - 1]).astype(np.int32)
                for j in range(1, L + 1):
                    cur[:, j] = np.minimum(
                        np.minimum(prev[:, j] + 1, cur[:, j - 1] + 1),
                        prev[:, j - 1] + cost[:, j - 1],
                    )
                prev = cur
            dist = prev[np.arange(n), np.minimum(sublens, L)]
            ok = dist <= k
            hits.extend(
                (int(d), terms[int(c)]) for d, c in zip(dist[ok], cand[ok])
            )
        hits.sort(key=lambda h: (h[0], h[1]))
        return hits

    def slab(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        if self._dirty or self._slab_committed is None:
            self._build_slab()
        if self._slab_arrays is None:
            self._slab_arrays = self._concat_slab()
        return self._slab_arrays  # type: ignore[return-value]

    def all_range_lists(self):
        """Iterate every (committed + live + impact-prefix block) slab
        range list."""
        yield from self._slab_ranges.values()
        yield from self._slab_live_ranges.values()
        yield from self._slab_prefix_ranges.values()

    # ------------------------------------------------------------------
    # Query planning
    # ------------------------------------------------------------------

    def _match_terms_detail(self, path: str, token: str,
                            tolerance: Optional[int]):
        """Yield (term, committed_ranges, live_ranges) for one
        (field, query-token) pair, closest-match-first under tolerance."""
        if not tolerance or BIGRAM_SEP in token:
            terms = [token]
        else:
            terms = [t for _d, t in self._fuzzy_match(path, token, tolerance)]
        for term in terms:
            cr = self._slab_ranges.get((path, term), ())
            lr = self._slab_live_ranges.get((path, term), ())
            if cr or lr:
                yield term, cr, lr

    def _match_terms(
        self, path: str, token: str, tolerance: Optional[int]
    ) -> List[Tuple[int, int]]:
        """Posting ranges for one (field, query-token) pair, ordered
        closest-match-first under tolerance (so a downstream range-count
        cap keeps the best matches)."""
        out: List[Tuple[int, int]] = []
        for _term, cr, lr in self._match_terms_detail(path, token, tolerance):
            out.extend(cr)
            out.extend(lr)
        return out

    def plan_query(
        self,
        tokens: Sequence[str],
        properties: Sequence[str],
        boost: Dict[str, float],
        tolerance: Optional[int] = None,
        impact_cap: Optional[int] = None,
        field_params: Optional[Dict[str, Tuple[float, float]]] = None,
        token_weights: Optional[Sequence[float]] = None,
        use_champions: bool = False,
        with_prefix: bool = False,
    ) -> QueryPlan:
        """Padded range descriptors (T, NR) for the scoring kernels, and
        with `with_prefix` the pruned tier's nomination ranges and spans:
        `index/plan.py::plan_query`."""
        from .plan import plan_query

        return plan_query(
            self, tokens, properties, boost, tolerance=tolerance,
            impact_cap=impact_cap, field_params=field_params,
            token_weights=token_weights, use_champions=use_champions,
            with_prefix=with_prefix,
        )

    # ------------------------------------------------------------------
    # Stats used for corpus-level scoring
    # ------------------------------------------------------------------

    def info(self) -> Dict[str, object]:
        return {
            "fields": {
                p: {
                    "doc_count": s.doc_count,
                    "avg_field_len": s.avg_len,
                }
                for p, s in self._stats.items()
            },
            "pending_ops": self.pending_ops(),
            "unique_terms": self.term_count(),
        }
