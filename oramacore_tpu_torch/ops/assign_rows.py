"""Each query's own term rows into its dense BM25 rows: the wrappers of
`csrc/assign_rows.cu`.

The shared (term-deduplicated) path of `ops/bm25.py` scores each unique
term of a batch once into a dense row of `acc` (rows, cap). Two entry
points carry those rows to the queries:

- `count_present`: each row's document frequency, df[r] = the number of
  docs with acc[r] > 0, as f32[rows].
- `assign_rows_accumulate`: for each query b and each slot t of
  `token_map` whose term is row r = token_map[b, t] - row0 of `acc`
  (0 <= r < rows), in slot order,

      idf        = ln(1 + (N - d + 0.5) / (d + 0.5)),  d = max(df, 1)
      present    = acc[r] > 0
      scores[b]  += where(present, idf * (k1 + 1) * acc[r] / (k1 + acc[r]), 0)
      matched[b] += present

  with `df` per row (f32[rows]) or per row and query (f32[rows, B], the
  filtered df of the masked twins). Slots outside [row0, row0 + rows),
  such as the padding sentinels, add nothing; a term held by two slots of
  one query adds twice.

Together they replace the dense `(B, rows) @ (rows, cap)` assignment
products of the JAX functions (oramacore_tpu/ops/bm25.py:528 and its
twins at :609, :645, :692) and the elementwise chain around them.

A wrapper given CPU tensors runs the plain version (for the assignment,
`index_select` / `index_add_` over all the slots at once: the CPU's
`index_add_` adds in index order, so the sums run in the kernel's slot
order and operand order, and the two agree bit for bit). Given CUDA
tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .score_windows import _check, _device_of, _raise_on

# Kernel launches per entry point, counted only where a kernel is
# enqueued (never for the plain version). Reset with reset_launch_counts.
LAUNCHES = {"assign_rows_accumulate": 0, "count_present": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (first call) and bind the CUDA library."""
    global _lib
    if _lib is None:
        lib = _build.load("assign_rows")
        ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.assign_rows_accumulate_launch.argtypes = [
            ptr, i64, i64, ptr, i64, i64, f32, ptr, i64, i64, f32, f32,
            ptr, ptr, i64, ptr,
        ]
        lib.assign_rows_accumulate_launch.restype = ctypes.c_int
        lib.count_present_launch.argtypes = [ptr, i64, i64, ptr, ptr]
        lib.count_present_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def count_present_plain(acc):
    return (acc > 0.0).sum(dim=1, dtype=torch.float32)


def count_present(acc):
    """f32[rows]: the docs of each row of acc f32[rows, cap] with acc > 0."""
    _check(acc, "acc", torch.float32, 2)
    dev = _device_of((acc,))
    if dev.type == "cpu":
        return count_present_plain(acc)
    rows, cap = acc.shape
    df = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0:
        return df
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.count_present_launch(acc.data_ptr(), rows, cap,
                                       df.data_ptr(), stream)
    _raise_on(err, "count_present")
    _build.count_launch(LAUNCHES, "count_present")
    return df


def assign_rows_accumulate_plain(acc, df, token_map, scores, matched,
                                 row0: int, n_docs, k1: float):
    """Plain PyTorch version of `assign_rows_accumulate`; updates
    `scores` and `matched` in place and returns them."""
    from .bm25 import _idf   # bm25.py imports this module

    rows = acc.shape[0]
    B = token_map.shape[0]
    w = _idf(n_docs, df.clamp(min=1.0))
    w = w[:, None].expand(rows, B) if w.dim() == 1 else w
    r = token_map.to(torch.int64) - row0
    q, t = torch.nonzero((r >= 0) & (r < rows), as_tuple=True)  # (b, t) order
    r = r[q, t]
    a = acc.index_select(0, r)
    present = a > 0.0
    sat = w[r, q][:, None] * (k1 + 1.0) * a / (k1 + a)
    # the CPU's index_add_ adds the entries of one row in index order
    scores.index_add_(0, q, sat.masked_fill_(~present, 0.0))
    matched.index_add_(0, q, present.to(matched.dtype))
    return scores, matched


def assign_rows_accumulate(acc, df, token_map, scores, matched, *,
                           row0: int, n_docs: float, k1: float):
    """scores[b] += sat of each of b's slots in rows [row0, row0 + rows),
    matched[b] += its presence; see the module doc.

    acc f32[rows, cap]; df f32[rows] or f32[rows, B]; token_map
    int32[B, T]; scores, matched f32[B, cap], updated in place and
    returned; n_docs the corpus size N."""
    _check(acc, "acc", torch.float32, 2)
    _check(token_map, "token_map", torch.int32, 2)
    _check(scores, "scores", torch.float32, 2)
    _check(matched, "matched", torch.float32, 2)
    rows, cap = acc.shape
    B, T = token_map.shape
    if df.dtype != torch.float32 or not df.is_contiguous():
        raise TypeError("df must be a contiguous f32 tensor")
    if tuple(df.shape) == (rows,):
        df_rs, df_qs = 1, 0
    elif tuple(df.shape) == (rows, B):
        df_rs, df_qs = B, 1
    else:
        raise ValueError(f"df must be ({rows},) or ({rows}, {B}), "
                         f"got {tuple(df.shape)}")
    for t, name in ((scores, "scores"), (matched, "matched")):
        if tuple(t.shape) != (B, cap):
            raise ValueError(f"{name} must be ({B}, {cap}), got {tuple(t.shape)}")
    dev = _device_of((acc, df, token_map, scores, matched))
    if dev.type == "cpu":
        return assign_rows_accumulate_plain(acc, df, token_map, scores,
                                            matched, row0, n_docs, k1)
    if rows * B * T * cap == 0:
        return scores, matched
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.assign_rows_accumulate_launch(
            acc.data_ptr(), rows, int(row0), df.data_ptr(), df_rs, df_qs,
            float(n_docs), token_map.data_ptr(), B, T, float(k1),
            float(k1 + 1.0), scores.data_ptr(), matched.data_ptr(), cap,
            stream,
        )
    _raise_on(err, "assign_rows_accumulate")
    _build.count_launch(LAUNCHES, "assign_rows_accumulate")
    return scores, matched
