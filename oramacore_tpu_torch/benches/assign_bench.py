"""`count_present` and `assign_rows_accumulate` where the shared path
runs them, beside their bound and the dense assignment products they
replaced.

    python -m oramacore_tpu_torch.benches.assign_bench \
        [--docs 1000000] [--batch 1024] [--reps 20]

The batch is `benches/ranges_bench.py`'s configuration
(`benches/scale_bench.py:40`, `bench_bm25_1m`: vocab 100,000, 40
postings per doc, zipf term weights, seed 0), at `--docs` documents and
`--batch` queries a batch (`--docs 457199 --batch 512` gives the
benchmark's full-text shape: cap=2^19, B=512). One warm-up batch, then
every launch of the row kernel in the next steady `search_topk_shared`
batch is recorded at its call in `ops/bm25.py` (acc, df, slot map, first
row, N; `ranges_bench.capture_batch`) and replayed on the card:

- each launch against the plain versions: df and matched exactly, scores
  within rtol 1e-6 (the same sums in the same order);
- timed as CUDA graph replays (device time; `benches.time_graph`): the
  row kernel and the df count, each alone; on the same
  operands the two products it replaced, `scores.addmm_(A, sat)` and
  `matched.addmm_(A, present)` (A, sat and present made outside the
  timed region); and the whole per-chunk chain they replaced (present,
  df, idf, sat, A and the two products);
- the plain version, by CUDA events;
- the row kernel's bound: (4 * pairs + rows read) * cap * 4 bytes at
  3.35 TB/s, where pairs are the queries with a slot in the launch's rows
  (each reads and writes its two rows) and rows read the distinct rows
  their slots name; the df count's, rows * cap * 4 bytes.

Reported for the batch's first launch (the first chunk of its shortest
length class) and for all of the batch's launches together.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from ..ops import assign_rows as ar
from ..ops import bm25
from . import bound_ms, card_line, time_cuda, time_graph
from . import ranges_bench as rb


class Launch(NamedTuple):
    acc: torch.Tensor        # f32[rows, cap]
    df: torch.Tensor         # f32[rows] or f32[rows, B]
    token_map: torch.Tensor  # int32[B, T]
    row0: int
    n_docs: float


def recorder(launches: List[Launch], real: Callable) -> Callable:
    """`real` (the row kernel's wrapper as ops/bm25.py calls it), also
    appending copies of each call's operands to `launches`."""

    def record(acc, df, token_map, scores, matched, *, row0, n_docs, k1):
        launches.append(Launch(acc.clone(), df.clone(), token_map.clone(),
                               int(row0), float(n_docs)))
        return real(acc, df, token_map, scores, matched, row0=row0,
                    n_docs=n_docs, k1=k1)

    return record


def pairs_and_rows(L: Launch):
    """(queries with a slot in the launch's rows, distinct rows named)."""
    r = L.token_map.cpu().numpy().astype(np.int64) - L.row0
    inside = (r >= 0) & (r < L.acc.shape[0])
    return int(inside.any(axis=1).sum()), int(np.unique(r[inside]).size)


def kernel_fn(L: Launch, scores, matched) -> None:
    ar.assign_rows_accumulate(L.acc, L.df, L.token_map, scores, matched,
                              row0=L.row0, n_docs=L.n_docs, k1=bm25.K1)


def dense_operands(L: Launch):
    """(A, sat, present) of the products the kernels replaced."""
    rows = L.acc.shape[0]
    uid = torch.arange(L.row0, L.row0 + rows, device=L.acc.device)
    A = (L.token_map[:, :, None] == uid[None, None, :]).sum(
        dim=1, dtype=torch.float32)
    present = (L.acc > 0.0).to(torch.float32)
    df = present.sum(dim=1).clamp(min=1.0)
    sat = bm25._idf(L.n_docs, df)[:, None] * (bm25.K1 + 1.0) * L.acc \
        / (bm25.K1 + L.acc) * present
    return A, sat, present


def old_chain_fn(L: Launch, scores, matched) -> None:
    """The per-chunk work the kernels replaced, after the acc."""
    A, sat, present = dense_operands(L)
    scores.addmm_(A, sat)
    matched.addmm_(A, present)


def check_and_time(launches: List[Launch], reps: int) -> Dict:
    """Each launch against the plain versions, then the times and bounds
    of the launches together (summed over launches)."""
    B = launches[0].token_map.shape[0]
    dev = launches[0].acc.device
    out = dict(launches=len(launches), pairs=0, rows=0, bytes=0,
               count_bytes=0, max_abs_err=0.0, ms=0.0, count_ms=0.0,
               products_ms=0.0, chain_ms=0.0, plain_ms=0.0)
    bufs: Dict[int, tuple] = {}
    for i, L in enumerate(launches):
        rows, cap = L.acc.shape
        if L.df.dim() == 1 and not torch.equal(
                ar.count_present(L.acc), ar.count_present_plain(L.acc)):
            raise AssertionError(f"launch {i}: df differs from the plain "
                                 f"version's")
        s, m = torch.zeros((B, cap), device=dev), torch.zeros((B, cap), device=dev)
        ps, pm = s.clone(), m.clone()
        kernel_fn(L, s, m)
        ar.assign_rows_accumulate_plain(L.acc, L.df, L.token_map, ps, pm,
                                        L.row0, L.n_docs, bm25.K1)
        torch.cuda.synchronize()
        if not torch.equal(m, pm):
            raise AssertionError(f"launch {i}: matched differs from the plain "
                                 f"version's")
        if not torch.allclose(s, ps, rtol=1e-6, atol=0):
            raise AssertionError(f"launch {i}: scores outside rtol 1e-6 of "
                                 f"the plain version")
        out["max_abs_err"] = max(out["max_abs_err"], float((s - ps).abs().max()))
        del s, m, ps, pm
        pairs, read = pairs_and_rows(L)
        out["pairs"] += pairs
        out["rows"] += read
        out["bytes"] += (4 * pairs + read) * cap * 4
        out["count_bytes"] += rows * cap * 4
        if cap not in bufs:
            bufs[cap] = (torch.zeros((B, cap), device=dev),
                         torch.zeros((B, cap), device=dev))
        sb, mb = bufs[cap]
        out["plain_ms"] += time_cuda(lambda L=L: ar.assign_rows_accumulate_plain(
            L.acc, L.df, L.token_map, sb, mb, L.row0, L.n_docs, bm25.K1), 1)
        if L.df.dim() == 1:   # the unfiltered path's launches
            A, sat, present = dense_operands(L)
            out["products_ms"] += time_graph(
                lambda: (sb.addmm_(A, sat), mb.addmm_(A, present)), reps)
            del A, sat, present
            out["chain_ms"] += time_graph(lambda L=L: old_chain_fn(L, sb, mb),
                                          reps)
            out["count_ms"] += time_graph(lambda L=L: ar.count_present(L.acc),
                                          reps)
        out["ms"] += time_graph(lambda L=L: kernel_fn(L, sb, mb), reps)
    out["bound_ms"], out["bound_by"] = bound_ms(out["bytes"], 0)
    out["count_bound_ms"], _ = bound_ms(out["count_bytes"], 0)
    return out


def report(name: str, res: Dict, card: str) -> None:
    ms = res["ms"]
    print(f"  assign_rows_accumulate [{name}] {res['launches']} launch(es), "
          f"{res['pairs']} pairs, {res['rows']} rows read, "
          f"{res['bytes'] / 1e9:.3f} GB: kernel {ms:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}), "
          f"{100 * res['bound_ms'] / ms:.1f}% of bound; count_present "
          f"{res['count_ms']:.4f} ms, bound {res['count_bound_ms']:.4f} ms "
          f"({100 * res['count_bound_ms'] / max(res['count_ms'], 1e-9):.1f}%); "
          f"the replaced addmm_ pair "
          f"{res['products_ms']:.4f} ms, the replaced chain "
          f"{res['chain_ms']:.4f} ms; plain {res['plain_ms']:.4f} ms "
          f"(max abs err {res['max_abs_err']:.3g}) [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=rb.N_DOCS)
    ap.add_argument("--batch", type=int, default=rb.BATCH)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("assign_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from .. import require_cuda

    require_cuda()
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    idx = rb.build_index(args.docs, rb.VOCAB, rb.POSTINGS_PER_DOC, seed=0)
    batches = rb.make_batches(2, args.batch, seed=1)
    launches: List[Launch] = []
    rb.capture_batch(idx, batches[0], batches[1], device, args.docs,
                     rows=launches)
    torch.cuda.synchronize()
    del idx
    L0 = launches[0]
    print(f"  {args.docs:,} docs: {len(launches)} launches in one batch; the "
          f"first: B={L0.token_map.shape[0]}, T={L0.token_map.shape[1]}, "
          f"rows={L0.acc.shape[0]}, cap={L0.acc.shape[1]}", flush=True)
    report("first launch", check_and_time(launches[:1], args.reps), card)
    report("the batch", check_and_time(launches, args.reps), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
