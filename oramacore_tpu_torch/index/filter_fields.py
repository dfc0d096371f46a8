"""Typed filter columns: number / bool / string-enum / date / geopoint.

Replaces the reference's `oramacore_fields` filter storages (number_field.rs,
date_field.rs, bool, string_filter, geopoint BKD — see SURVEY §2.7) with
dense columnar (doc_id, value) arrays. A where-tree evaluates to a boolean
doc mask over the index's doc-id capacity; masks combine with and/or/not
(reference filter.rs:34 `calculate_filter_for_fields`), and the final mask
is applied in-register inside the scoring kernels.

Columns are host numpy (vectorized eval is O(values) and tiny next to
scoring); the resulting mask ships to the device once per query. Facet
counts (facet.rs) and group-by (group.rs) reuse the same columns via
bincount-style reductions.

The port's copy of `oramacore_tpu/index/filter_fields.py`, with the same
names and behaviour; its snapshot meta is JSON (`.meta.json`) in place of
`.meta.msgpack`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types import (
    DateFilter,
    FieldFilter,
    GeoFilter,
    GeoPolygonFilter,
    GeoRadiusFilter,
    NumberFilter,
    WhereFilter,
)


class _ColumnBase:
    """Append-only (doc, value) column with live + committed layers."""

    def __init__(self, value_dtype):
        self._value_dtype = value_dtype
        self._live_docs: List[int] = []
        self._live_vals: List[Any] = []
        self._committed_docs: np.ndarray = np.zeros(0, np.int32)
        self._committed_vals: np.ndarray = np.zeros(0, value_dtype)
        self._slab: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # dense doc -> value cache for sort-by (built lazily, invalidated
        # with the slab); avoids O(corpus) host scans per query
        self._dense: Optional[Tuple[int, np.ndarray, np.ndarray]] = None
        # monotonic mutation counter: device-resident sort columns key on
        # (uid, prop, version) so fused sort-by reuses the upload until
        # the column actually changes (search_exec.search_topk_sorted)
        self.version = 0
        self._single_valued_cache = None
        self._dense_ids_cache = None

    def append(self, doc_id: int, value) -> None:
        self._live_docs.append(doc_id)
        self._live_vals.append(value)
        self._slab = None
        self._dense = None
        self.version += 1

    def slab(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._slab is None:
            if self._live_docs:
                docs = np.concatenate(
                    [self._committed_docs, np.asarray(self._live_docs, np.int32)]
                )
                vals = np.concatenate(
                    [
                        self._committed_vals,
                        np.asarray(self._live_vals, self._value_dtype),
                    ]
                )
            else:
                docs, vals = self._committed_docs, self._committed_vals
            self._slab = (docs, vals)
        return self._slab

    def commit(self, deleted: Optional[set] = None) -> None:
        docs, vals = self.slab()
        if deleted:
            keep = ~np.isin(docs, np.fromiter(deleted, np.int32, len(deleted)))
            docs, vals = docs[keep], vals[keep]
        order = np.argsort(docs, kind="stable")
        self._committed_docs = np.ascontiguousarray(docs[order])
        self._committed_vals = np.ascontiguousarray(vals[order])
        self._live_docs, self._live_vals = [], []
        self._slab = None
        self._dense = None
        self.version += 1

    def delete_doc_live(self, doc_id: int) -> None:
        if doc_id in self._live_docs:
            keep = [i for i, d in enumerate(self._live_docs) if d != doc_id]
            self._live_docs = [self._live_docs[i] for i in keep]
            self._live_vals = [self._live_vals[i] for i in keep]
            self._slab = None
            self._dense = None
            self.version += 1

    def dense_values(self, cap: int) -> Tuple[np.ndarray, np.ndarray]:
        """(values f64[cap], present bool[cap]) — first value per doc wins
        (matches scan order for multi-valued fields). Cached until the
        column changes, so sort-by is O(hits log hits) per query instead
        of an O(corpus) Python loop."""
        cached = self._dense
        if cached is not None and cached[0] >= cap:
            return cached[1], cached[2]
        docs, vals = self.slab()
        out = np.zeros(cap, np.float64)
        present = np.zeros(cap, bool)
        if len(docs):
            d = docs[docs < cap]
            v = vals[docs < cap].astype(np.float64)
            # write reversed so the FIRST occurrence is the final write
            out[d[::-1]] = v[::-1]
            present[d] = True
        self._dense = (cap, out, present)
        return out, present

    def n_values(self) -> int:
        return len(self._committed_docs) + len(self._live_docs)

    def single_valued(self) -> bool:
        """True when no doc holds more than one value in this column —
        the precondition for the device facet path's dense id/value
        columns (multi-valued facet fields keep the host counting).
        Cached by the mutation version."""
        cached = self._single_valued_cache
        if cached is not None and cached[0] == self.version:
            return cached[1]
        docs, _ = self.slab()
        sv = bool(len(docs) == np.unique(docs).size)
        self._single_valued_cache = (self.version, sv)
        return sv

    def dense_id_column(self, cap: int) -> np.ndarray:
        """int32[cap] value per doc (-1 = none); callers must have
        checked single_valued(). For bool columns ids are 0/1; for
        interned string columns the intern ids. Cached by the mutation
        version (the device facet path asks per faceted query)."""
        cached = self._dense_ids_cache
        if cached is not None and cached[0] == (self.version, cap):
            return cached[1]
        docs, vals = self.slab()
        out = np.full(cap, -1, np.int32)
        if len(docs):
            d = docs[docs < cap]
            out[d] = vals[docs < cap].astype(np.int32)
        self._dense_ids_cache = ((self.version, cap), out)
        return out

    def group_id_column(self, cap: int, max_groups: int = 1024):
        """(ids int32[cap] (-1 = none), labels) for DEVICE group-by over
        a numeric column: distinct slab values become group ids in
        ascending value order (reference group.rs groups on any
        filterable value). None when the column has more than
        `max_groups` distinct values — the host dict flow takes over.
        Callers must have checked single_valued(). Cached by the
        mutation version."""
        cached = getattr(self, "_group_ids_cache", None)
        if cached is not None and cached[0] == (self.version, cap):
            return cached[1]
        docs, vals = self.slab()
        uniq = np.unique(vals)
        if len(uniq) > max_groups:
            out = None
        else:
            ids = np.full(cap, -1, np.int32)
            sel = docs < cap
            ids[docs[sel]] = np.searchsorted(uniq, vals[sel]).astype(
                np.int32
            )
            out = (ids, [float(v) for v in uniq])
        self._group_ids_cache = ((self.version, cap), out)
        return out

    def pair_table(self, cap: int):
        """Doc-sorted DEDUPED (doc, value) pairs + the max distinct
        values any doc holds — the device multi-valued facet path's
        CSR inputs (search_exec facet kinds "mcat"/"mnum": per matched
        doc a binary search locates its run, then <= m bounded probes
        read its values; value_counts/range_counts semantics — a doc
        counts once per DISTINCT value / once per range). Returns
        (pair_docs int32[P] ascending, pair_vals, m). Cached by the
        mutation version."""
        cached = getattr(self, "_pair_table_cache", None)
        if cached is not None and cached[0] == (self.version, cap):
            return cached[1]
        docs, vals = self.slab()
        keep = docs < cap
        docs, vals = docs[keep], vals[keep]
        if len(docs):
            order = np.lexsort((vals, docs))
            d = docs[order].astype(np.int32)
            v = vals[order]
            first = np.ones(len(d), bool)
            first[1:] = (d[1:] != d[:-1]) | (v[1:] != v[:-1])
            d, v = d[first], v[first]
            ends = np.flatnonzero(np.r_[d[1:] != d[:-1], True])
            m = int(np.diff(np.r_[-1, ends]).max())
        else:
            d = np.zeros(0, np.int32)
            v = np.zeros(0, self._value_dtype)
            m = 0
        out = (d, v, m)
        self._pair_table_cache = ((self.version, cap), out)
        return out

    @staticmethod
    def _mask_from_docs(docs: np.ndarray, cap: int) -> np.ndarray:
        mask = np.zeros(cap, bool)
        if len(docs):
            mask[docs[docs < cap]] = True
        return mask


class NumberField(_ColumnBase):
    def __init__(self):
        super().__init__(np.float64)

    def insert(self, doc_id: int, values: Sequence[float]) -> None:
        for v in values:
            self.append(doc_id, float(v))

    def _select(self, nf: NumberFilter) -> np.ndarray:
        docs, vals = self.slab()
        if nf.op == "eq":
            sel = vals == float(nf.value)
        elif nf.op == "gt":
            sel = vals > float(nf.value)
        elif nf.op == "gte":
            sel = vals >= float(nf.value)
        elif nf.op == "lt":
            sel = vals < float(nf.value)
        elif nf.op == "lte":
            sel = vals <= float(nf.value)
        elif nf.op == "between":
            lo, hi = nf.value  # type: ignore[misc]
            sel = (vals >= float(lo)) & (vals <= float(hi))
        else:
            raise ValueError(f"unknown number op {nf.op}")
        return docs[sel]

    def filter_mask(self, nf: NumberFilter, cap: int) -> np.ndarray:
        return self._mask_from_docs(self._select(nf), cap)

    def range_counts(
        self, ranges: Sequence[Tuple[float, float]], doc_mask: np.ndarray
    ) -> List[int]:
        """Facet counts: docs in mask with a value in [from, to] per range."""
        docs, vals = self.slab()
        out = []
        for lo, hi in ranges:
            sel = (vals >= lo) & (vals <= hi)
            hit_docs = docs[sel]
            hit_docs = hit_docs[hit_docs < len(doc_mask)]
            out.append(int(np.unique(hit_docs[doc_mask[hit_docs]]).size))
        return out


class DateField(_ColumnBase):
    def __init__(self):
        super().__init__(np.int64)

    def insert(self, doc_id: int, epoch_ms: int) -> None:
        self.append(doc_id, int(epoch_ms))

    def filter_mask(self, df: DateFilter, cap: int) -> np.ndarray:
        docs, vals = self.slab()
        if df.op == "eq":
            sel = vals == int(df.value)
        elif df.op == "gt":
            sel = vals > int(df.value)
        elif df.op == "gte":
            sel = vals >= int(df.value)
        elif df.op == "lt":
            sel = vals < int(df.value)
        elif df.op == "lte":
            sel = vals <= int(df.value)
        elif df.op == "between":
            lo, hi = df.value  # type: ignore[misc]
            sel = (vals >= int(lo)) & (vals <= int(hi))
        else:
            raise ValueError(f"unknown date op {df.op}")
        return self._mask_from_docs(docs[sel], cap)


class BoolField(_ColumnBase):
    def __init__(self):
        super().__init__(np.bool_)

    def insert(self, doc_id: int, value: bool) -> None:
        self.append(doc_id, bool(value))

    def filter_mask(self, value: bool, cap: int) -> np.ndarray:
        docs, vals = self.slab()
        return self._mask_from_docs(docs[vals == bool(value)], cap)

    def counts(self, doc_mask: np.ndarray) -> Dict[str, int]:
        docs, vals = self.slab()
        docs_c = docs[docs < len(doc_mask)]
        vals_c = vals[docs < len(doc_mask)]
        in_mask = doc_mask[docs_c]
        return {
            "true": int(np.unique(docs_c[in_mask & vals_c]).size),
            "false": int(np.unique(docs_c[in_mask & ~vals_c]).size),
        }


class StringFilterField(_ColumnBase):
    """Interned enum values (reference EnumStrategy, fields.rs:357-367)."""

    def __init__(self):
        super().__init__(np.int32)
        self._intern: Dict[str, int] = {}
        self._values: List[str] = []

    def intern(self, value: str) -> int:
        vid = self._intern.get(value)
        if vid is None:
            vid = len(self._values)
            self._intern[value] = vid
            self._values.append(value)
        return vid

    def insert(self, doc_id: int, values: Sequence[str]) -> None:
        for v in values:
            self.append(doc_id, self.intern(v))

    def filter_mask(self, value, cap: int) -> np.ndarray:
        docs, vals = self.slab()
        if isinstance(value, str):
            wanted = [self._intern.get(value, -1)]
        else:
            wanted = [self._intern.get(v, -1) for v in value]
        sel = np.isin(vals, np.asarray(wanted, np.int32))
        return self._mask_from_docs(docs[sel], cap)

    def value_counts(self, doc_mask: np.ndarray) -> Dict[str, int]:
        docs, vals = self.slab()
        keep = docs < len(doc_mask)
        docs, vals = docs[keep], vals[keep]
        in_mask = doc_mask[docs]
        docs, vals = docs[in_mask], vals[in_mask]
        out: Dict[str, int] = {}
        if len(vals) == 0:
            return out
        # unique (value, doc) pairs so multi-value docs count once per value
        pairs = np.unique(np.stack([vals.astype(np.int64), docs.astype(np.int64)]), axis=1)
        counts = np.bincount(pairs[0], minlength=len(self._values))
        for vid, c in enumerate(counts):
            if c:
                out[self._values[vid]] = int(c)
        return out

    def doc_values(self, doc_ids: Sequence[int]) -> Dict[int, List[str]]:
        docs, vals = self.slab()
        out: Dict[int, List[str]] = {}
        if not len(docs):
            return out
        wanted = np.asarray(list(doc_ids), np.int64)
        sel = np.isin(docs, wanted)  # vectorized; Python loop only on hits
        for d, v in zip(docs[sel].tolist(), vals[sel].tolist()):
            out.setdefault(d, []).append(self._values[v])
        return out

    def all_values(self) -> List[str]:
        return list(self._values)


class GeoField:
    """Packed lat/lon pairs; radius (haversine) and polygon filters."""

    def __init__(self):
        self._docs = _ColumnBase(np.int32)
        self._lat = _ColumnBase(np.float64)
        self._lon = _ColumnBase(np.float64)

    def insert(self, doc_id: int, lat: float, lon: float) -> None:
        self._docs.append(doc_id, doc_id)
        self._lat.append(doc_id, lat)
        self._lon.append(doc_id, lon)

    def commit(self, deleted: Optional[set] = None) -> None:
        # must drop the same rows in all three columns: replicate manually
        docs, _ = self._docs.slab()
        _, lats = self._lat.slab()
        _, lons = self._lon.slab()
        if deleted:
            keep = ~np.isin(docs, np.fromiter(deleted, np.int32, len(deleted)))
            docs, lats, lons = docs[keep], lats[keep], lons[keep]
        for col, vals in ((self._docs, docs), (self._lat, lats), (self._lon, lons)):
            col._committed_docs = np.ascontiguousarray(docs.astype(np.int32))
            col._committed_vals = np.ascontiguousarray(vals)
            col._live_docs, col._live_vals = [], []
            col._slab = None
            col._dense = None
            col.version += 1

    def delete_doc_live(self, doc_id: int) -> None:
        for col in (self._docs, self._lat, self._lon):
            col.delete_doc_live(doc_id)

    def n_values(self) -> int:
        return self._docs.n_values()

    def filter_mask(self, gf: GeoFilter, cap: int) -> np.ndarray:
        docs, _ = self._docs.slab()
        _, lats = self._lat.slab()
        _, lons = self._lon.slab()
        if isinstance(gf, GeoRadiusFilter):
            lat1 = np.radians(gf.center.lat)
            lat2 = np.radians(lats)
            dlat = lat2 - lat1
            dlon = np.radians(lons - gf.center.lon)
            a = (
                np.sin(dlat / 2) ** 2
                + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
            )
            dist = 2 * 6371000.0 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
            sel = dist <= gf.radius_meters
            if not gf.inside:
                sel = ~sel
        elif isinstance(gf, GeoPolygonFilter):
            # ray casting
            sel = np.zeros(len(docs), bool)
            pts = gf.points
            n = len(pts)
            for i in range(n):
                a_, b_ = pts[i], pts[(i + 1) % n]
                cond = ((a_.lat > lats) != (b_.lat > lats)) & (
                    lons
                    < (b_.lon - a_.lon) * (lats - a_.lat) / (b_.lat - a_.lat + 1e-12)
                    + a_.lon
                )
                sel ^= cond
            if not gf.inside:
                sel = ~sel
        else:
            raise ValueError(f"unknown geo filter {gf!r}")
        return _ColumnBase._mask_from_docs(docs[sel], cap)


@dataclass
class FilterFields:
    """All filterable columns of one index, keyed by field path."""

    numbers: Dict[str, NumberField] = field(default_factory=dict)
    dates: Dict[str, DateField] = field(default_factory=dict)
    bools: Dict[str, BoolField] = field(default_factory=dict)
    strings: Dict[str, StringFilterField] = field(default_factory=dict)
    geos: Dict[str, GeoField] = field(default_factory=dict)

    def number(self, path: str) -> NumberField:
        return self.numbers.setdefault(path, NumberField())

    def date(self, path: str) -> DateField:
        return self.dates.setdefault(path, DateField())

    def bool_(self, path: str) -> BoolField:
        return self.bools.setdefault(path, BoolField())

    def string(self, path: str) -> StringFilterField:
        return self.strings.setdefault(path, StringFilterField())

    def geo(self, path: str) -> GeoField:
        return self.geos.setdefault(path, GeoField())

    def all_fields(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for p in self.numbers:
            out[p] = "number"
        for p in self.dates:
            out[p] = "date"
        for p in self.bools:
            out[p] = "bool"
        for p in self.strings:
            out[p] = "string"
        for p in self.geos:
            out[p] = "geopoint"
        return out

    def commit(self, deleted: Optional[set] = None) -> None:
        for group in (self.numbers, self.dates, self.bools, self.strings, self.geos):
            for f in group.values():
                f.commit(deleted)

    def delete_doc_live(self, doc_id: int) -> None:
        for group in (self.numbers, self.dates, self.bools, self.strings, self.geos):
            for f in group.values():
                f.delete_doc_live(doc_id)

    # ------------------------------------------------------------------
    # Where-tree evaluation → doc mask (reference filter.rs:34)
    # ------------------------------------------------------------------

    def _leaf_mask(self, cond: FieldFilter, cap: int) -> np.ndarray:
        path, kind, payload = cond.path, cond.kind, cond.payload
        if kind == "number":
            f = self.numbers.get(path)
            if f is None and path in self.dates:
                # numeric filter over a declared date field: epoch compare
                df = DateFilter(payload.op, payload.value)  # type: ignore[union-attr]
                return self.dates[path].filter_mask(df, cap)
            return f.filter_mask(payload, cap) if f else np.zeros(cap, bool)
        if kind == "date":
            f = self.dates.get(path)
            if f is not None:
                return f.filter_mask(payload, cap)
            # date literal over an auto-discovered NUMBER field: compare
            # as epoch milliseconds (dates are stored as i64 epochs)
            nf = self.numbers.get(path)
            if nf is not None:
                num = NumberFilter(
                    payload.op,
                    list(payload.value) if isinstance(payload.value, tuple)
                    else payload.value,
                )
                return nf.filter_mask(num, cap)
            return np.zeros(cap, bool)
        if kind == "bool":
            f = self.bools.get(path)
            return f.filter_mask(payload, cap) if f else np.zeros(cap, bool)
        if kind == "string":
            f = self.strings.get(path)
            return f.filter_mask(payload, cap) if f else np.zeros(cap, bool)
        if kind == "geo":
            f = self.geos.get(path)
            return f.filter_mask(payload, cap) if f else np.zeros(cap, bool)
        raise ValueError(f"unknown filter kind {kind}")

    def eval_where(self, where: WhereFilter, cap: int) -> Optional[np.ndarray]:
        """None means 'no filter' (all docs pass)."""
        if where is None or where.is_empty():
            return None
        mask = np.ones(cap, bool)
        for cond in where.conditions:
            mask &= self._leaf_mask(cond, cap)
        for sub in where.and_:
            sub_mask = self.eval_where(sub, cap)
            if sub_mask is not None:
                mask &= sub_mask
        if where.or_:
            or_mask = np.zeros(cap, bool)
            for sub in where.or_:
                sub_mask = self.eval_where(sub, cap)
                or_mask |= sub_mask if sub_mask is not None else np.ones(cap, bool)
            mask &= or_mask
        if where.not_ is not None:
            sub_mask = self.eval_where(where.not_, cap)
            if sub_mask is not None:
                mask &= ~sub_mask
        return mask


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------

def save_filter_fields(ff: FilterFields, path_prefix: str) -> None:
    """Persist COMMITTED columns (callers commit first)."""
    import os

    from ..storage.files import atomic_write_json, savez_snapshot

    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    arrays = {}
    meta: Dict[str, Any] = {"numbers": [], "dates": [], "bools": [], "strings": {}, "geos": []}
    for kind, group in (
        ("numbers", ff.numbers),
        ("dates", ff.dates),
        ("bools", ff.bools),
    ):
        for path, col in group.items():
            key = f"{kind}__{path}".replace("/", "_")
            arrays[key + "__docs"] = col._committed_docs
            arrays[key + "__vals"] = col._committed_vals
            meta[kind].append(path)
    for path, col in ff.strings.items():
        key = f"strings__{path}".replace("/", "_")
        arrays[key + "__docs"] = col._committed_docs
        arrays[key + "__vals"] = col._committed_vals
        meta["strings"][path] = col._values
    for path, geo in ff.geos.items():
        key = f"geos__{path}".replace("/", "_")
        arrays[key + "__docs"] = geo._docs._committed_docs
        arrays[key + "__lat"] = geo._lat._committed_vals
        arrays[key + "__lon"] = geo._lon._committed_vals
        meta["geos"].append(path)
    tmp_npz = path_prefix + ".npz.tmp"
    with open(tmp_npz, "wb") as fh:
        savez_snapshot(fh, **arrays)
    os.replace(tmp_npz, path_prefix + ".npz")
    atomic_write_json(path_prefix + ".meta.json", meta)


def load_filter_fields(path_prefix: str) -> FilterFields:
    from ..storage.files import read_json

    ff = FilterFields()
    meta = read_json(path_prefix + ".meta.json")
    if meta is None:
        return ff
    with np.load(path_prefix + ".npz") as arrays:
        for kind, ctor in (("numbers", ff.number), ("dates", ff.date), ("bools", ff.bool_)):
            for path in meta[kind]:
                key = f"{kind}__{path}".replace("/", "_")
                col = ctor(path)
                col._committed_docs = arrays[key + "__docs"]
                col._committed_vals = arrays[key + "__vals"]
        for path, values in meta["strings"].items():
            key = f"strings__{path}".replace("/", "_")
            col = ff.string(path)
            col._committed_docs = arrays[key + "__docs"]
            col._committed_vals = arrays[key + "__vals"]
            col._values = list(values)
            col._intern = {v: i for i, v in enumerate(col._values)}
        for path in meta["geos"]:
            key = f"geos__{path}".replace("/", "_")
            geo = ff.geo(path)
            docs = arrays[key + "__docs"]
            geo._docs._committed_docs = docs
            geo._docs._committed_vals = docs.copy()
            geo._lat._committed_docs = docs
            geo._lat._committed_vals = arrays[key + "__lat"]
            geo._lon._committed_docs = docs
            geo._lon._committed_vals = arrays[key + "__lon"]
    return ff
