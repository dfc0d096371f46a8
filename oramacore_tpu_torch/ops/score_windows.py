"""Posting-window BM25F scoring: wrappers of `csrc/score_windows.cu`.

The port of `oramacore_tpu/ops/pallas_score.py::score_windows`. Two entry
points, each with its plain PyTorch version beside it:

- `score_windows`: the Pallas kernel's contract. Windows of width `w` at
  `aligned_starts` give `docs int32[NS, w]` and
  `ntf = weight * tf / max((1-b) + (b/avg) * flen, 1e-9)` as f32[NS, w],
  with `params f32[NS, 4] = (weight, 1-b, b/avg, unused)`.
- `score_ranges_accumulate`: the form every BM25 function of
  `ops/bm25.py` runs. Per (row, range) it scores exactly `lens` postings
  from `starts`, with bm25.py's operand order
  `ntf = w * tf / max((1-b) + b * flen / max(avg, 1e-9), 1e-9)`, keeps
  slots with `tf > 0` and a doc in `[0, cap)`, and adds ntf into
  `acc[row, doc]`. It fuses the TPU path's window gather and its dense
  aggregation (`oramacore_tpu/ops/bm25.py:_aggregate_dense`). The kernel
  walks a work list of tiles of TILE_VECS 16-byte posting vectors in
  row-major (row, range) order; `work_list_plain` and `work_items_plain`
  are that list's plain versions.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel or raises; it never falls back. Postings outside the
slab read as doc 0 with tf 0 in both versions (callers pad the slab with
`MAX_RANGE_LEN` zeros, so a well-formed plan never reaches them).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches per entry point, counted only where a kernel is
# enqueued (never for the plain versions). Reset with reset_launch_counts.
LAUNCHES = {"score_windows": 0, "score_ranges_accumulate": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (first call) and bind the CUDA library."""
    global _lib
    if _lib is None:
        lib = _build.load("score_windows")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.score_windows_launch.argtypes = [
            ptr, ptr, ptr, i64, ptr, ptr, i64, i64, ptr, ptr, ptr,
        ]
        lib.score_windows_launch.restype = ctypes.c_int
        lib.score_ranges_accumulate_launch.argtypes = [
            ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr,
            i64, i64, i64, ptr, i64, ptr, ptr,
        ]
        lib.score_ranges_accumulate_launch.restype = ctypes.c_int
        lib.score_ranges_work_list_launch.argtypes = [ptr, ptr, i64, ptr, ptr]
        lib.score_ranges_work_list_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


# ---------------------------------------------------------------------------
# score_windows: the Pallas kernel's contract
# ---------------------------------------------------------------------------

def score_windows_plain(p_doc, p_tf, p_flen, aligned_starts, params, w: int):
    """Plain PyTorch version of `score_windows` (index gather + formula)."""
    n = p_doc.shape[0]
    slot = torch.arange(w, device=p_doc.device, dtype=torch.int64)
    idx = aligned_starts.to(torch.int64)[:, None] + slot
    inside = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, max(n - 1, 0))
    denom = params[:, 1:2] + params[:, 2:3] * p_flen[idx]
    ntf = params[:, 0:1] * p_tf[idx] / torch.clamp(denom, min=1e-9)
    return p_doc[idx].masked_fill(~inside, 0), ntf.masked_fill(~inside, 0.0)


def score_windows(p_doc, p_tf, p_flen, aligned_starts, params, *, w: int):
    """Returns (docs int32[NS, w], ntf f32[NS, w]); see the module doc."""
    _check(p_doc, "p_doc", torch.int32, 1)
    _check(p_tf, "p_tf", torch.float32, 1)
    _check(p_flen, "p_flen", torch.float32, 1)
    _check(aligned_starts, "aligned_starts", torch.int32, 1)
    _check(params, "params", torch.float32, 2)
    n = p_doc.shape[0]
    ns = aligned_starts.shape[0]
    if p_tf.shape[0] != n or p_flen.shape[0] != n:
        raise ValueError("p_doc, p_tf and p_flen must have one length")
    if tuple(params.shape) != (ns, 4):
        raise ValueError(f"params must be ({ns}, 4), got {tuple(params.shape)}")
    if w <= 0:
        raise ValueError("w must be positive")
    dev = _device_of((p_doc, p_tf, p_flen, aligned_starts, params))
    if dev.type == "cpu":
        return score_windows_plain(p_doc, p_tf, p_flen, aligned_starts, params, w)
    lib = load_kernels()
    docs = torch.empty((ns, w), dtype=torch.int32, device=dev)
    ntf = torch.empty((ns, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.score_windows_launch(
            p_doc.data_ptr(), p_tf.data_ptr(), p_flen.data_ptr(), n,
            aligned_starts.data_ptr(), params.data_ptr(), ns, w,
            docs.data_ptr(), ntf.data_ptr(), stream,
        )
    _raise_on(err, "score_windows")
    LAUNCHES["score_windows"] += 1
    return docs, ntf


# ---------------------------------------------------------------------------
# score_ranges_accumulate: the fused form on the search path
# ---------------------------------------------------------------------------

# elements per gather chunk of the plain version (bounds its scratch)
_PLAIN_CHUNK = 1 << 24

# 16-byte posting vectors per tile of the kernel's work list
# (kTileVecs in csrc/score_windows.cu: 256 threads x 2 vectors)
TILE_VECS = 512


def work_list_plain(starts, lens):
    """The kernel's work list: int64[R * NR], the inclusive cumsum over the
    (row, range) pairs in row-major order of each pair's tiles. A pair's
    postings [s, s + len) are counted as 16-byte vectors from the aligned
    slab index s - (s & 3); len <= 0 gives no tile."""
    s = starts.reshape(-1).to(torch.int64)
    n = lens.reshape(-1).to(torch.int64)
    vecs = ((s & 3) + n + 3) // 4
    tiles = torch.where(n > 0, (vecs + TILE_VECS - 1) // TILE_VECS, 0)
    return torch.cumsum(tiles, 0)


def work_items_plain(starts, lens):
    """The kernel's walk, item by item: (pair, lo, hi) for each tile in
    work-list order, where [lo, hi) are the slab indices of the pair's
    range that the tile covers (the kernel masks the rest of its
    vectors)."""
    cum = work_list_plain(starts, lens)
    s = starts.reshape(-1).to(torch.int64)
    n = lens.reshape(-1).to(torch.int64)
    total = int(cum[-1]) if cum.numel() else 0
    items = torch.arange(total, dtype=torch.int64, device=cum.device)
    pair = torch.searchsorted(cum, items, right=True)   # first cum > item
    tile = items - torch.where(pair > 0, cum[(pair - 1).clamp(min=0)], 0)
    start, end = s[pair], s[pair] + n[pair]
    q0 = start - (start & 3) + 4 * TILE_VECS * tile
    lo = torch.maximum(q0, start)
    hi = torch.minimum(q0 + 4 * TILE_VECS, end)
    return pair, lo, hi


def score_ranges_pairs_plain(
    p_doc, p_tf, p_flen, starts, lens, weight, field_b, avg, cap: int
):
    """The plain version's scatter pairs, in chunks of rows: yields
    (flat index row * cap + doc int64[m], ntf f32[m]) for every kept
    posting (tf > 0, doc in [0, cap), inside the slab)."""
    R, NR = starts.shape
    n = p_doc.shape[0]
    L = int(lens.max()) if lens.numel() else 0
    if L <= 0 or n == 0:
        return
    dev = p_doc.device
    slot = torch.arange(L, device=dev, dtype=torch.int64)
    rows_per_chunk = max(1, _PLAIN_CHUNK // max(1, NR * L))
    for r0 in range(0, R, rows_per_chunk):
        r1 = min(R, r0 + rows_per_chunk)
        idx = starts[r0:r1].to(torch.int64)[:, :, None] + slot   # (r, NR, L)
        valid = (slot < lens[r0:r1, :, None]) & (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        tf = p_tf[idx]
        doc = p_doc[idx].to(torch.int64)
        b = field_b[r0:r1, :, None]
        denom = (1.0 - b) + b * p_flen[idx] / torch.clamp(
            avg[r0:r1, :, None], min=1e-9
        )
        ntf = weight[r0:r1, :, None] * tf / torch.clamp(denom, min=1e-9)
        keep = valid & (tf > 0) & (doc >= 0) & (doc < cap)
        row = torch.arange(r0, r1, device=dev, dtype=torch.int64)[:, None, None]
        yield (row * cap + doc)[keep], ntf[keep]


def score_ranges_accumulate_plain(
    p_doc, p_tf, p_flen, starts, lens, weight, field_b, avg, acc
):
    """Plain PyTorch version of `score_ranges_accumulate` (masked gather,
    then `index_add_` into `acc`); `p_tf` is the tf column already chosen.
    Updates `acc` in place and returns it."""
    flat_acc = acc.view(-1)
    for flat, ntf in score_ranges_pairs_plain(
        p_doc, p_tf, p_flen, starts, lens, weight, field_b, avg, acc.shape[1]
    ):
        flat_acc.index_add_(0, flat, ntf)
    return acc


def score_ranges_accumulate(
    p_doc, p_tf, p_exact_tf, p_flen,
    starts, lens, weight, field_b, avg,
    acc,
    *,
    exact: bool,
    max_len: int,
):
    """acc[r, doc] += ntf for every posting of every range of row r.

    p_*: the posting slab (int32 / f32 [P]); `exact` selects p_exact_tf.
    starts, lens int32[R, NR]; weight, field_b, avg f32[R, NR];
    acc f32[R, cap], updated in place and returned.
    `max_len` bounds `lens` (the plan's range-length bucket); the kernel
    uses it only to cap the grid of a small call, so a low bound costs
    speed, not results.
    """
    tf = p_exact_tf if exact else p_tf
    _check(p_doc, "p_doc", torch.int32, 1)
    _check(tf, "p_exact_tf" if exact else "p_tf", torch.float32, 1)
    _check(p_flen, "p_flen", torch.float32, 1)
    _check(starts, "starts", torch.int32, 2)
    _check(lens, "lens", torch.int32, 2)
    for t, name in ((weight, "weight"), (field_b, "field_b"), (avg, "avg")):
        _check(t, name, torch.float32, 2)
    _check(acc, "acc", torch.float32, 2)
    n = p_doc.shape[0]
    if tf.shape[0] != n or p_flen.shape[0] != n:
        raise ValueError("p_doc, p_tf and p_flen must have one length")
    R, NR = starts.shape
    for t, name in ((lens, "lens"), (weight, "weight"),
                    (field_b, "field_b"), (avg, "avg")):
        if tuple(t.shape) != (R, NR):
            raise ValueError(f"{name} must be ({R}, {NR}), got {tuple(t.shape)}")
    if acc.shape[0] != R:
        raise ValueError(f"acc must have {R} rows, got {acc.shape[0]}")
    dev = _device_of((p_doc, tf, p_flen, starts, lens, weight, field_b, avg, acc))
    if dev.type == "cpu":
        return score_ranges_accumulate_plain(
            p_doc, tf, p_flen, starts, lens, weight, field_b, avg, acc
        )
    if R * NR == 0 or max_len <= 0:
        return acc
    lib = load_kernels()
    work = torch.empty(R * NR, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.score_ranges_accumulate_launch(
            p_doc.data_ptr(), tf.data_ptr(), p_flen.data_ptr(), n,
            starts.data_ptr(), lens.data_ptr(), weight.data_ptr(),
            field_b.data_ptr(), avg.data_ptr(), R, NR, int(max_len),
            acc.data_ptr(), acc.shape[1], work.data_ptr(), stream,
        )
    _raise_on(err, "score_ranges_accumulate")
    LAUNCHES["score_ranges_accumulate"] += 1
    return acc
