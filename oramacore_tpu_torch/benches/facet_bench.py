"""The pruned facets' phase-B kernels at phase 13's recorded inputs: the
facet columns and the call recording that `chip_smoke.py` runs, the
bound and sector counts, and a same-call bench of an earlier design.

    python -m oramacore_tpu_torch.benches.facet_bench [--baseline OLD.cu]

The bench builds pruned_10m (`pruned_bench.build_index`) and the four
facet columns (`facet_columns`), records the four phase-B calls of the
query of the three most frequent terms (2,097,152 entries, 1,090,881 kept
reps) through `PrunedPlanMixin.facet_counts_pruned`, holds each kernel to
its plain version there, and times it as CUDA-graph replays with the L2
warm and cold (a 256 MiB write between replays, subtracted), beside the
bound (`facet_bound`) and each design's bytes in 32-byte sectors, then
the limit cases (`limit_cases`). `--baseline OLD.cu`
builds an earlier `facet_hist.cu` with its own launchers (e.g. `git show
35f90b1:oramacore_tpu_torch/ops/csrc/facet_hist.cu`, a binary search per
kept rep, into the gitignored `build/archive/`) and times it in turns
with the current kernels: baseline, current, current, baseline.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from . import bound_ms, time_graph

FACET_G = 64              # the 10M bench's string bucket (:1430-1435)
FACET_RANGES = np.array([[0, 99], [100, 249], [200, 499], [500, 749],
                         [750, 999], [0, 999], [333, 333], [990, 1000]],
                        np.float32)   # inclusive, overlapping


def facet_columns(n, seed=13):
    """The four facet columns over all n docs, seeded: {name: (spec,
    cache key)}. A single-valued string column of FACET_G ids (the bench's
    bucket); a number column (integers in [0, 1000), 5% missing) against
    FACET_RANGES; a multi-valued string column of 1-4 distinct ids from 32;
    a multi-valued number column of 1-3 values (repeats dedup) against
    FACET_RANGES. Multi-valued columns become pair tables with the port's
    numpy `pair_table`."""
    from ..index.search_exec import pair_table

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, FACET_G, n).astype(np.int32)
    nums = np.round(rng.uniform(0, 1000, n)).astype(np.float32)
    nums[rng.random(n) < 0.05] = np.nan
    k = rng.integers(1, 5, n)
    docs = np.repeat(np.arange(n, dtype=np.int32), k)
    j = np.arange(len(docs)) - np.repeat(np.cumsum(k) - k, k)
    v0 = np.repeat(rng.integers(0, 32, n), k)
    step = np.repeat(rng.integers(1, 8, n), k)   # 4 steps < 32: distinct
    pd, pv, m = pair_table(docs, ((v0 + j * step) % 32).astype(np.int32), n)
    k = rng.integers(1, 4, n)
    docs = np.repeat(np.arange(n, dtype=np.int32), k)
    vals = np.round(rng.uniform(0, 1000, len(docs))).astype(np.float32)
    npd, npv, nm = pair_table(docs, vals, n)
    return {
        "string G=64": (("cat", ids, FACET_G), ("facet", "str", 1)),
        "number, 8 ranges": (("num", nums, FACET_RANGES), ("facet", "num", 1)),
        "multi string G=32": (("mcat", pd, pv, 32, m), ("facet", "mstr", 1)),
        "multi number, 8 ranges": (("mnum", npd, npv, FACET_RANGES, nm),
                                   ("facet", "mnum", 1)),
    }


def record_facet_calls(run):
    """run() with the executor's two phase-B entry points recorded (their
    tensors cloned): (its result, {spec kind: (args, kwargs)}) of one
    query's calls, a single- and a multi-valued pair."""
    from ..index import search_exec as se
    from . import pruned_bench as pb

    out, single = pb.capture(se, "facet_hist", lambda: pb.capture(
        se, "facet_hist_multi", run))
    out, multi = out
    calls = {"num" if kw["numeric"] else "cat": (a, kw)
             for a, kw in single[:2]}
    calls.update({"mnum" if kw["numeric"] else "mcat": (a, kw)
                  for a, kw in multi[:2]})
    return out, calls


def _kept(args):
    docs, rep = args[0], args[1]
    return docs[rep != 0].to(torch.int64)


def _rows(lo, hi):
    """The row indices [lo_i, hi_i) of every kept doc, concatenated."""
    n = hi - lo
    return torch.repeat_interleave(lo, n) + (
        torch.arange(int(n.sum()), device=lo.device)
        - torch.repeat_interleave(torch.cumsum(n, 0) - n, n))


def _multi_rows(args, kw):
    """(kept docs in [0, L), their rows' first and end index) as
    JAX's probes find them."""
    pair_docs, row_ptr = args[2], args[4]
    d = _kept(args)
    d = d[(d >= 0) & (d < row_ptr.shape[0] - 1)].to(torch.int32)
    lo = torch.searchsorted(pair_docs, d, right=False)
    hi = torch.searchsorted(pair_docs, d, right=True)
    return d, lo, torch.minimum(hi, lo + kw["M"])


def _sectors(idx) -> float:
    """32-byte sectors that int32 / f32 words at `idx` fall in."""
    return float(torch.unique(idx.to(torch.int64) // 8).numel())


def facet_bound(kind, args, kw):
    """(bytes by 4-byte word, bytes by 32-byte sector for a binary search
    per kept rep) one phase-B call must move: docs and rep (8 B an entry)
    once, each kept rep's value (a column word) or its rows of the pair
    table (doc and value, 8 B a row), the bounds and the counts once. The
    sector count takes the column's sectors, or the pair rows' doc and
    value sectors, that the kept reps touch (not the search's probes)."""
    base = 8 * args[0].shape[0] + 12 * kw["G"]
    if kind in ("cat", "num"):
        d = _kept(args).clamp(0, args[2].shape[0] - 1)
        return base + 4 * float(d.numel()), base + 32 * _sectors(d)
    _d, lo, hi = _multi_rows(args, kw)
    rows = _rows(lo, hi)
    return base + 8 * float(rows.numel()), base + 2 * 32 * _sectors(rows)


def design_sectors(kind, args, kw) -> float:
    """Bytes the current design moves, in 32-byte sectors: docs and rep
    once (16-byte loads), the column sectors (single-valued) or the
    row_ptr sectors of d and d + 1 and the value sectors of the rows
    (multi-valued) that the kept reps touch, the bounds and the counts."""
    base = 8 * args[0].shape[0] + 12 * kw["G"]
    if kind in ("cat", "num"):
        return facet_bound(kind, args, kw)[1]
    d, lo, hi = _multi_rows(args, kw)
    d = d.to(torch.int64)
    return (base + 32 * _sectors(torch.cat([d, d + 1]))
            + 32 * _sectors(_rows(lo, hi)))


def limit_cases(kind, args, kw) -> Dict[str, tuple]:
    """Copies of a recorded call that name the kernel's floor. `stream`:
    docs and rep streamed and the kept reps counted, no gather (a column
    of one word; a row_ptr of L = 0, so no doc has rows). `gather`: the
    gathers over the kept reps alone, pre-compacted (rep all ones)."""
    d = args[0][args[1] != 0].contiguous()
    gather = (d, torch.ones(d.shape[0], device=d.device)) + tuple(args[2:])
    stream = list(args)
    if kind in ("cat", "num"):
        stream[2] = args[2][:1]
    else:
        stream[4] = args[4][:1]
    return {"stream": (tuple(stream), kw), "gather": (gather, kw)}


def load_baseline(source: Path) -> Dict[str, Callable]:
    """Runners over an earlier `facet_hist.cu` whose multi launcher
    searches the pair table (no row_ptr), built with the port's nvcc
    flags: {name: run(args, kw)}."""
    from ..ops import _build

    lib = _build.load_source(source, "baseline_facet")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.facet_hist_launch.argtypes = [ptr, ptr, i64, ptr, i64, ptr, i64, i64,
                                      ptr, ptr]
    lib.facet_hist_multi_launch.argtypes = [ptr, ptr, i64, ptr, ptr, i64, ptr,
                                            i64, i64, i64, ptr, ptr]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err):
        if err:
            raise RuntimeError(f"baseline launch failed: cudaError_t {err}")

    def single(args, kw):
        docs, rep, col, bounds = args
        out = torch.empty(kw["G"], dtype=torch.int32, device=docs.device)
        check(lib.facet_hist_launch(
            docs.data_ptr(), rep.data_ptr(), docs.shape[0], col.data_ptr(),
            col.shape[0], bounds.data_ptr(), kw["G"], int(kw["numeric"]),
            out.data_ptr(), stream()))
        return out

    def multi(args, kw):
        docs, rep, pd, pv, _row_ptr, bounds = args
        out = torch.empty(kw["G"], dtype=torch.int32, device=docs.device)
        check(lib.facet_hist_multi_launch(
            docs.data_ptr(), rep.data_ptr(), docs.shape[0], pd.data_ptr(),
            pv.data_ptr(), pd.shape[0], bounds.data_ptr(), kw["G"], kw["M"],
            int(kw["numeric"]), out.data_ptr(), stream()))
        return out

    return {"facet_hist": single, "facet_hist_multi": multi}


def current_runners() -> Dict[str, Callable]:
    from ..ops import facet_hist as fh

    return {"facet_hist": lambda a, kw: fh.facet_hist(*a, **kw),
            "facet_hist_multi": lambda a, kw: fh.facet_hist_multi(*a, **kw)}


def record(device):
    """pruned_10m, its facet columns and the top-3-terms query's four
    phase-B calls, recorded."""
    from ..index.plan import plan_query
    from ..index.search_exec import PrunedPlanMixin
    from . import pruned_bench as pb

    idx = pb.build_index()
    ex = PrunedPlanMixin(device)
    columns = facet_columns(pb.N_DOCS)
    plan = plan_query(idx, ["t0", "t1", "t2"], [pb.FIELD], {},
                      with_prefix=True)
    _, calls = record_facet_calls(lambda: [
        ex.facet_counts_pruned(idx, plan, pb.N_DOCS, *columns[k])
        for k in columns])
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="an earlier facet_hist.cu to time beside this one")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("facet_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from .. import require_cuda
    from ..ops import facet_hist as fh
    from . import card_line
    from .pruned_bench import time_cold

    require_cuda()
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    calls = record(device)
    print(f"index, columns and recorded calls: {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    flush = torch.empty(64 << 20, device=device)
    runners = {"current": current_runners()}
    if args.baseline is not None:
        runners["baseline"] = load_baseline(args.baseline)
    turns = ("baseline", "current", "current", "baseline") \
        if args.baseline is not None else ("current",)
    for kind in ("cat", "num", "mcat", "mnum"):
        a, kw = calls[kind]
        name = "facet_hist" if kind in ("cat", "num") else "facet_hist_multi"
        plain = getattr(fh, f"{name}_plain")(*a, **kw)
        for who in dict.fromkeys(turns):
            got = runners[who][name](a, kw)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise AssertionError(f"{name} [{kind}]: {who} differs from "
                                     f"the plain version")
        by_word, searched = facet_bound(kind, a, kw)
        mine = design_sectors(kind, a, kw)
        bound, by = bound_ms(by_word, 0)
        print(f"{name} [{kind}, G={kw['G']}, N={a[0].shape[0]:,}, "
              f"{int((a[1] != 0).sum()):,} kept]: equal to the plain version;"
              f" bound {bound * 1e3:.2f} us ({by}, {by_word / 1e6:.1f} MB by "
              f"word); sector-level bytes: a search per rep "
              f"{searched / 1e6:.1f} MB ({bound_ms(searched, 0)[0] * 1e3:.2f}"
              f" us, without the search's probes), this design "
              f"{mine / 1e6:.1f} MB ({bound_ms(mine, 0)[0] * 1e3:.2f} us) "
              f"[{card}]", flush=True)
        times = {}
        for who in turns:
            run = runners[who][name]
            for k, v in (("warm", time_graph(lambda: run(a, kw), args.reps)),
                         ("cold", time_cold(lambda: run(a, kw), flush,
                                            args.reps))):
                times.setdefault((who, k), []).append(v)
        for who in dict.fromkeys(turns):
            warm, cold = min(times[(who, "warm")]), min(times[(who, "cold")])
            print(f"  {who}: {warm:.4f} ms (L2 warm), {cold:.4f} ms (L2 "
                  f"cold); {100 * bound / warm:.1f}% / {100 * bound / cold:.1f}"
                  f"% of bound; turns: warm " + ", ".join(
                      f"{v:.4f}" for v in times[(who, "warm")]) + "; cold "
                  + ", ".join(f"{v:.4f}" for v in times[(who, "cold")])
                  + f" [{card}]", flush=True)
        run = runners["current"][name]
        for case, (ca, ckw) in limit_cases(kind, a, kw).items():
            warm = time_graph(lambda: run(ca, ckw), args.reps)
            cold = time_cold(lambda: run(ca, ckw), flush, args.reps)
            print(f"  limit case [{case}]: {warm:.4f} ms (L2 warm), "
                  f"{cold:.4f} ms (L2 cold) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
