"""Facet histograms of the pruned tier's phase B: the CUDA kernels
`facet_hist` and `facet_hist_multi` (`csrc/facet_hist.cu`), counterparts
of oramacore_tpu/ops/pruned.py `_facet_hist_core` and
`_facet_hist_multi_core`.

Both take phase A's run-end reps (`ops/pruned.py::pruned_match_reps`):
docs int32[N] and rep f32[N], where rep is 1.0 at one entry of each
distinct matched doc and 0.0 elsewhere (a nonzero rep counts as one doc).
They return the distinct matched docs per facet bucket as int32[G]:

- `facet_hist`, a single-valued column of length L: int32 value ids
  (categorical; -1 = none, ids >= G count nowhere) or f32 values
  (numeric; NaN = missing) against G inclusive ranges `bounds` f32[G, 2]
  (the ranges may overlap).
- `facet_hist_multi`, a multi-valued column as its doc-sorted, deduped
  (doc, value) pair table whose last row is a sentinel doc larger than
  any real one, and `row_ptr` int32[L + 1], each doc's first row
  (`row_ptr_table`); M bounds the rows a doc has. Categorical: one count
  per distinct value of the doc; numeric: one count per range that any
  of the doc's values falls in. A kept doc outside [0, L) counts nothing
  (JAX's probes find no row for such a doc, but for one equal to the
  table's sentinel, which they match against the sentinel row).

JAX counts with chunked bf16 one-hot matmuls into f32, exact below 2^24;
these counts are exact in int32. A wrapper given CPU tensors runs its
plain PyTorch version; given CUDA tensors it launches its kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .score_windows import _check, _device_of, _raise_on

# Kernel launches per entry point, counted only where a kernel is
# enqueued (never for the plain versions). Reset with reset_launch_counts.
LAUNCHES = {"facet_hist": 0, "facet_hist_multi": 0}

# dynamic shared memory one block of an H100 can use
SMEM_LIMIT = 232448
# facet_hist_multi's ring of kept docs, 256 int32 for each of 8 warps
MULTI_RING_BYTES = 8 * 256 * 4

_lib = None

# elements of the (entries, G) membership tiles a plain version builds
_PLAIN_ELEMS = 1 << 24


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (first call) and bind the CUDA library."""
    global _lib
    if _lib is None:
        lib = _build.load("facet_hist")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.facet_hist_launch.argtypes = [
            ptr, ptr, i64,              # docs, rep, n
            ptr, i64, ptr,              # column, n_col, bounds
            i64, i64, ptr, ptr,         # G, numeric, out, stream
        ]
        lib.facet_hist_launch.restype = ctypes.c_int
        lib.facet_hist_multi_launch.argtypes = [
            ptr, ptr, i64,              # docs, rep, n
            ptr, i64, ptr, i64, ptr,    # row_ptr, L, pair_vals, P, bounds
            i64, i64, i64, ptr, ptr,    # G, M, numeric, out, stream
        ]
        lib.facet_hist_multi_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(G: int, numeric: bool, multi: bool = False) -> int:
    """Shared memory of one block: G int32 counters, the G ranges of a
    numeric column, and facet_hist_multi's rings."""
    return G * (12 if numeric else 4) + (MULTI_RING_BYTES if multi else 0)


def max_buckets(numeric: bool, multi: bool = False) -> int:
    """The largest G one block holds."""
    return (SMEM_LIMIT - (MULTI_RING_BYTES if multi else 0)) // (
        12 if numeric else 4)


def row_ptr_table(pair_docs: torch.Tensor, L: int) -> torch.Tensor:
    """int32[L + 1] on pair_docs' device: row_ptr[d] = lower_bound(
    pair_docs, d) for d in [0, L], the first row of doc d in a doc-sorted
    pair table and, at d + 1, the end of its rows (a sentinel row and rows
    of docs past L lie after row_ptr[L])."""
    docs = torch.arange(L + 1, dtype=torch.int32, device=pair_docs.device)
    return torch.searchsorted(pair_docs, docs, out_int32=True)


def _check_common(docs, rep, bounds, G: int, numeric: bool,
                  multi: bool = False) -> None:
    _check(docs, "docs", torch.int32, 1)
    _check(rep, "rep", torch.float32, 1)
    _check(bounds, "bounds", torch.float32, 2)
    if rep.shape[0] != docs.shape[0]:
        raise ValueError("docs and rep must have one length")
    if G < 1:
        raise ValueError(f"G must be positive, got {G}")
    if tuple(bounds.shape) != (G, 2):
        raise ValueError(f"bounds must be ({G}, 2), got {tuple(bounds.shape)}")
    need = smem_bytes(G, numeric, multi)
    if need > SMEM_LIMIT:
        kind = "numeric" if numeric else "categorical"
        raise ValueError(
            f"a {kind} facet of G={G} buckets needs {need} bytes of shared "
            f"memory a block; one block holds at most {SMEM_LIMIT}")


def _values_dtype(numeric: bool):
    return torch.float32 if numeric else torch.int32


def _range_members(v: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """bool[m, G]: v inside each inclusive range (NaN inside none)."""
    return (v[:, None] >= bounds[None, :, 0]) & (v[:, None] <= bounds[None, :, 1])


def facet_hist_plain(docs, rep, bucket, bounds, G: int, numeric: bool):
    """Plain PyTorch version of `facet_hist`."""
    d = docs[rep != 0].to(torch.int64).clamp(0, bucket.shape[0] - 1)
    v = bucket[d]
    if not numeric:
        v = v[(v >= 0) & (v < G)].to(torch.int64)
        return torch.bincount(v, minlength=G)[:G].to(torch.int32)
    counts = torch.zeros(G, dtype=torch.int64, device=docs.device)
    step = max(1, _PLAIN_ELEMS // G)
    for s in range(0, v.shape[0], step):
        counts += _range_members(v[s:s + step], bounds).sum(dim=0)
    return counts.to(torch.int32)


def facet_hist(docs, rep, bucket, bounds, *, G: int, numeric: bool):
    """Distinct matched docs per bucket of a single-valued column: int32[G].
    `bucket` is int32[L] value ids (numeric=False) or f32[L] values
    (numeric=True), indexed by doc (docs clip to [0, L - 1], as JAX's
    gather does; only kept reps read it). One block holds at most
    `max_buckets(numeric)` buckets: 58,112 ids or 19,370 ranges."""
    _check_common(docs, rep, bounds, G, numeric)
    _check(bucket, "bucket", _values_dtype(numeric), 1)
    if bucket.shape[0] < 1:
        raise ValueError("bucket must not be empty")
    dev = _device_of([docs, rep, bucket, bounds])
    if dev.type == "cpu":
        return facet_hist_plain(docs, rep, bucket, bounds, G, numeric)
    out = torch.empty(G, dtype=torch.int32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        err = lib.facet_hist_launch(
            docs.data_ptr(), rep.data_ptr(), docs.shape[0],
            bucket.data_ptr(), bucket.shape[0], bounds.data_ptr(),
            G, int(numeric), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "facet_hist")
    LAUNCHES["facet_hist"] += 1
    return out


def facet_hist_multi_plain(docs, rep, pair_docs, pair_vals, row_ptr, bounds,
                           G: int, M: int, numeric: bool):
    """Plain PyTorch version of `facet_hist_multi`: JAX's probes (at most
    M rows from lower_bound(pair_docs, doc), each kept while it is inside
    the table and holds the doc) for the kept docs in [0, L), L =
    len(row_ptr) - 1; it reads only row_ptr's length."""
    L = row_ptr.shape[0] - 1
    d = docs[rep != 0]
    d = d[(d >= 0) & (d < L)]
    P = pair_docs.shape[0]
    counts = torch.zeros(G, dtype=torch.int64, device=docs.device)
    step = max(1, _PLAIN_ELEMS // (G if numeric else 1))
    for s in range(0, d.shape[0], step):
        ds = d[s:s + step]
        pos = torch.searchsorted(pair_docs, ds, right=False)
        member = None
        for j in range(M):
            p = pos + j
            pc = p.clamp(max=P - 1)
            valid = (p < P) & (pair_docs[pc] == ds)
            v = pair_vals[pc]
            if numeric:
                hit = valid[:, None] & _range_members(v, bounds)
                member = hit if member is None else member | hit
            else:
                ok = valid & (v >= 0) & (v < G)
                counts += torch.bincount(v[ok].to(torch.int64),
                                         minlength=G)[:G]
        if member is not None:
            counts += member.sum(dim=0)
    return counts.to(torch.int32)


def facet_hist_multi(docs, rep, pair_docs, pair_vals, row_ptr, bounds, *,
                     G: int, M: int, numeric: bool):
    """Distinct matched docs per bucket of a multi-valued column: int32[G].
    pair_docs int32[P] ascending, its last row a sentinel larger than any
    doc; pair_vals int32[P] value ids or f32[P] values; row_ptr int32[L +
    1] = row_ptr_table(pair_docs, L); M >= 1 bounds the rows of one doc.
    The warps' rings share the block with the counters, so it holds at
    most `max_buckets(numeric, multi=True)` buckets: 56,064 ids or 18,688
    ranges."""
    _check_common(docs, rep, bounds, G, numeric, multi=True)
    _check(pair_docs, "pair_docs", torch.int32, 1)
    _check(pair_vals, "pair_vals", _values_dtype(numeric), 1)
    _check(row_ptr, "row_ptr", torch.int32, 1)
    P = pair_docs.shape[0]
    if P < 1 or pair_vals.shape[0] != P:
        raise ValueError("pair_docs and pair_vals must have one length >= 1 "
                         "(the sentinel row)")
    if row_ptr.shape[0] < 1:
        raise ValueError("row_ptr must hold L + 1 >= 1 rows")
    if M < 1:
        raise ValueError(f"M must be positive, got {M}")
    dev = _device_of([docs, rep, pair_docs, pair_vals, row_ptr, bounds])
    if dev.type == "cpu":
        return facet_hist_multi_plain(docs, rep, pair_docs, pair_vals,
                                      row_ptr, bounds, G, M, numeric)
    out = torch.empty(G, dtype=torch.int32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        err = lib.facet_hist_multi_launch(
            docs.data_ptr(), rep.data_ptr(), docs.shape[0],
            row_ptr.data_ptr(), row_ptr.shape[0] - 1, pair_vals.data_ptr(), P,
            bounds.data_ptr(), G, M, int(numeric), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "facet_hist_multi")
    LAUNCHES["facet_hist_multi"] += 1
    return out
