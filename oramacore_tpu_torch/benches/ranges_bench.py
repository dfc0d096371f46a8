"""`score_ranges_accumulate` where the search path runs it, beside its
bound, on the 1M-doc full-text configuration.

    python -m oramacore_tpu_torch.benches.ranges_bench [--baseline OLD.cu]

The data is `benches/scale_bench.py:40` (`bench_bm25_1m`): 1,000,000
docs, vocab 100,000, 40 postings per doc, zipf term weights, seed 0, in
one committed segment of the port's `StringIndex`. The cases, on the card:

- `batch`: every launch of one steady B=1024 `search_topk_shared` batch,
  recorded at the kernel's call in `ops/bm25.py` and replayed as made;
- `synthetic`: R=64 rows of NR=32 ranges at random starts, half of them
  up to MAX_RANGE_LEN postings and half up to 1/64 of that, cap=2^20;
- `rows_1024`: R=1024 rows of NR=8 ranges, 4 GiB of accumulators;
- `edges`: starts off 16-byte boundaries, zero-length pairs, ranges
  shorter than one 16-byte vector and ranges past either end of the slab;
- and, timed only, two copies of `synthetic` that show what limits the
  kernel (`limit_cases`): one that adds nothing, one whose adds all land
  in L2.

Each case is held against the plain version (the hit set exactly, values
within rtol 1e-5 / atol 1e-6, since atomic sums reorder) and timed by
CUDA events: the kernel as one CUDA graph of all of the case's launches
(device time; an eager loop of small launches times the host), the plain
version, and, labelled "scatter only" (as a CUDA graph too),
`acc.view(-1).index_add_` of the plain version's (index, ntf) pairs made
outside the timed region. No one
PyTorch call computes the gather, the formula and the scatter together.
A case's bound (`benches.bound_ms`) counts 12 B per posting inside the
slab, 20 B of descriptors per pair and 64 B per 32-byte accumulator
sector that the case touches (read once and written once), counted from
the plain version's result.

`--baseline OLD.cu` builds another copy of `csrc/score_windows.cu` whose
`score_ranges_accumulate_launch` takes no work buffer (the design with
one block per (pair, slice of the longest range)) and times it on the
same cases, in turns with the current kernel: baseline, current, current,
baseline.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from ..ops import _build
from ..ops import score_windows as sw
from ..ops.bm25 import MAX_RANGE_LEN
from . import bound_ms, card_line, time_cuda, time_graph

# bench_bm25_1m (benches/scale_bench.py:40)
N_DOCS = 1_000_000
VOCAB = 100_000
POSTINGS_PER_DOC = 40
BATCH = 1024

# f32 operations per kept posting: the ntf formula's 2 multiplies,
# 2 divides and 1 add, and the accumulating add
OPS_PER_POSTING = 6


# ---------------------------------------------------------------------------
# the 1M-doc configuration's data (numpy, seeded)
# ---------------------------------------------------------------------------

def synth_corpus_postings(n_docs, vocab, postings_per_doc, seed=0):
    """Synthetic postings with a zipf-ish term distribution, packed CSR
    (a copy of benches/scale_bench.py:20-37)."""
    rng = np.random.default_rng(seed)
    # term frequencies ~ zipf: term t has weight 1/(t+1)
    weights = 1.0 / np.arange(1, vocab + 1)
    weights /= weights.sum()
    terms = rng.choice(vocab, size=n_docs * postings_per_doc, p=weights)
    docs = np.repeat(np.arange(n_docs, dtype=np.int32), postings_per_doc)
    # sort by term -> CSR
    order = np.argsort(terms, kind="stable")
    terms_s, docs_s = terms[order], docs[order]
    starts = np.searchsorted(terms_s, np.arange(vocab))
    lens = np.diff(np.append(starts, len(terms_s))).astype(np.int32)
    tf = rng.integers(1, 4, len(docs_s)).astype(np.float32)
    flen = np.full(len(docs_s), float(postings_per_doc), np.float32)
    return docs_s.astype(np.int32), tf, flen, starts.astype(np.int64), lens


def build_index(n_docs, vocab, postings_per_doc, seed=0):
    """One committed segment of field "body", as benches/scale_bench.py
    builds it; the slab build gives the heaviest terms champion rows."""
    from ..index.string_index import FieldStats, StringIndex, _CommittedField

    docs, tf, flen, starts, lens = synth_corpus_postings(
        n_docs, vocab, postings_per_doc, seed
    )
    idx = StringIndex()
    idx._committed["body"] = [_CommittedField(
        terms=[f"t{i}" for i in range(vocab)],
        starts=starts, lens=lens,
        doc=docs, tf=tf, exact_tf=tf, flen=flen,
        stats=FieldStats(doc_count=n_docs, sum_len=float(flen.sum())),
    )]
    idx._stats["body"] = FieldStats(n_docs, float(flen.sum()))
    idx.slab_split()
    return idx


def make_batches(n_batches, batch, seed=1):
    """Queries of 2-4 zipf-drawn tokens (scale_bench's token law)."""
    rng = np.random.default_rng(seed)
    return [
        [[f"t{int(rng.zipf(1.3)) + 10}" for _ in range(int(rng.integers(2, 5)))]
         for _ in range(batch)]
        for _ in range(n_batches)
    ]


# ---------------------------------------------------------------------------
# cases: launches of the kernel, as its wrapper takes them
# ---------------------------------------------------------------------------

class Launch(NamedTuple):
    slab: tuple          # p_doc, p_tf, p_exact_tf, p_flen
    desc: tuple          # starts, lens int32[R, NR]; weight, field_b, avg f32
    cap: int
    exact: bool
    max_len: int


def capture_batch(idx, warm_up, queries, device, n_docs,
                  properties=("body",)) -> List[Launch]:
    """The kernel's launches in one steady `search_topk_shared` batch
    over `properties` (after one batch of warm-up), with copies of their
    descriptors."""
    from ..index.search_exec import SharedBatchExecutor
    from ..ops import bm25

    ex = SharedBatchExecutor(device)

    def run(qs):
        return ex.search_topk_shared(idx, qs, list(properties), {},
                                     float(n_docs), n_docs, 10)

    run(warm_up)
    launches: List[Launch] = []
    real = bm25.score_ranges_accumulate

    def record(p_doc, p_tf, p_exact_tf, p_flen, *desc_acc, exact, max_len):
        *desc, acc = desc_acc
        launches.append(Launch((p_doc, p_tf, p_exact_tf, p_flen),
                               tuple(t.clone() for t in desc), acc.shape[1],
                               exact, max_len))
        return real(p_doc, p_tf, p_exact_tf, p_flen, *desc_acc, exact=exact,
                    max_len=max_len)

    bm25.score_ranges_accumulate = record
    try:
        run(queries)
    finally:
        bm25.score_ranges_accumulate = real
    return launches


def _launch(slab, arrays, cap, max_len=MAX_RANGE_LEN) -> Launch:
    dev = slab[0].device
    return Launch(tuple(slab), tuple(torch.from_numpy(a).to(dev) for a in arrays),
                  cap, False, max_len)


def _params(rng, R, NR):
    return (rng.uniform(0.5, 2, (R, NR)).astype(np.float32),
            rng.uniform(0.3, 0.9, (R, NR)).astype(np.float32),
            rng.uniform(5, 40, (R, NR)).astype(np.float32))


def synthetic_case(rng, slab, R=64, NR=32, cap=1 << 20) -> Launch:
    """The shape chip_smoke.py's phase 4 has timed from the start: mixed
    long and short ranges at random starts (the draws keep their order, so
    a seed gives the same case as before)."""
    n = slab[0].shape[0]
    lens = rng.integers(0, MAX_RANGE_LEN + 1, (R, NR))
    lens[:, NR // 2:] //= 64
    starts = rng.integers(0, n - MAX_RANGE_LEN, (R, NR)).astype(np.int32)
    return _launch(slab, (starts, lens.astype(np.int32), *_params(rng, R, NR)),
                   cap)


def rows_case(rng, slab, R=1024, NR=8, cap=1 << 20) -> Launch:
    """R rows of NR ranges up to 16,384 postings: R * cap f32 accumulators
    (4 GiB at the defaults), so the row-major walk must keep a band of
    rows in L2."""
    n = slab[0].shape[0]
    lens = rng.integers(0, 16385, (R, NR)).astype(np.int32)
    starts = rng.integers(0, n - MAX_RANGE_LEN, (R, NR)).astype(np.int32)
    return _launch(slab, (starts, lens, *_params(rng, R, NR)), cap)


def edges_case(rng, slab, R=64, NR=32, cap=1 << 20) -> Launch:
    """Starts off 16-byte boundaries; a quarter of the pairs empty; a
    column of ranges shorter than one vector; ranges that start before
    the slab or run past its end."""
    n = slab[0].shape[0]
    starts = rng.integers(0, n - MAX_RANGE_LEN, (R, NR))
    starts = starts - starts % 4 + rng.integers(1, 4, (R, NR))
    lens = rng.integers(1, 40_000, (R, NR))
    lens[rng.random((R, NR)) < 0.25] = 0
    lens[:, 1] = rng.integers(1, 4, R)
    starts[:, 2] = n - rng.integers(1, 20_000, R)
    starts[:, 3] = -rng.integers(1, 20_000, R)
    return _launch(slab, (starts.astype(np.int32), lens.astype(np.int32),
                          *_params(rng, R, NR)), cap)


def limit_cases(launch: Launch) -> Dict[str, Launch]:
    """Two copies of a case that find what limits the kernel: `no adds`
    (every tf 0, so the kernel reads and scores every posting and adds
    nothing) and `adds in L2` (every doc taken mod 65536 into a cap of
    65536, so each row's adds land in 256 KB and every row stays in L2)."""
    p_doc, p_tf, p_exact_tf, p_flen = launch.slab
    zeros = torch.zeros_like(p_tf)
    return {
        "no adds": launch._replace(slab=(p_doc, zeros, zeros, p_flen)),
        "adds in L2": launch._replace(slab=(p_doc & 0xFFFF, p_tf, p_exact_tf,
                                            p_flen), cap=1 << 16),
    }


# ---------------------------------------------------------------------------
# check, bound and time
# ---------------------------------------------------------------------------

def kernel_fn(launch: Launch, acc) -> None:
    sw.score_ranges_accumulate(*launch.slab, *launch.desc, acc,
                               exact=launch.exact, max_len=launch.max_len)


def _tf_of(launch: Launch):
    p_doc, p_tf, p_exact_tf, p_flen = launch.slab
    return p_doc, (p_exact_tf if launch.exact else p_tf), p_flen


def _in_slab(launch: Launch) -> int:
    n = launch.slab[0].shape[0]
    s = launch.desc[0].to(torch.int64)
    e = s + launch.desc[1].to(torch.int64).clamp(min=0)
    return int((e.clamp(0, n) - s.clamp(0, n)).clamp(min=0).sum())


def _touched_sectors(ref) -> int:
    """32-byte sectors (8 f32) of acc that hold a hit."""
    nz = ref != 0
    pad = (-nz.shape[1]) % 8
    if pad:
        nz = torch.nn.functional.pad(nz, (0, pad))
    return int(nz.view(nz.shape[0], -1, 8).any(dim=2).sum())


def check_case(name: str, launches: List[Launch], reps: int) -> Dict:
    """Each launch against the plain version, then the case's bound and
    the times of the plain version and of the scatter alone (per launch,
    summed). The kernel's launches here are not the main path's."""
    n_bytes = n_ops = postings = 0
    err, plain_ms, scatter_ms = 0.0, 0.0, 0.0
    for i, L in enumerate(launches):
        R = L.desc[0].shape[0]
        acc = torch.zeros((R, L.cap), device=L.slab[0].device)
        kernel_fn(L, acc)
        ref = sw.score_ranges_accumulate_plain(*_tf_of(L), *L.desc,
                                               torch.zeros_like(acc))
        torch.cuda.synchronize()
        if not torch.equal(acc > 0, ref > 0):
            raise AssertionError(f"{name}, launch {i}: the hit set differs "
                                 f"from the plain version's")
        if not torch.allclose(acc, ref, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{name}, launch {i}: acc outside rtol 1e-5 "
                                 f"/ atol 1e-6 of the plain version")
        err = max(err, float((acc - ref).abs().max()))
        posts = _in_slab(L)
        postings += posts
        n_bytes += 12 * posts + 20 * R * L.desc[0].shape[1] \
            + 64 * _touched_sectors(ref)
        del ref
        plain_ms += time_cuda(lambda L=L, acc=acc: sw.score_ranges_accumulate_plain(
            *_tf_of(L), *L.desc, acc), 1)
        pairs = list(sw.score_ranges_pairs_plain(*_tf_of(L), *L.desc, L.cap))
        n_ops += OPS_PER_POSTING * sum(int(f.numel()) for f, _ in pairs)
        flat = acc.view(-1)

        def scatter(pairs=pairs, flat=flat):
            for f, v in pairs:
                flat.index_add_(0, f, v)

        scatter_ms += time_graph(scatter, reps)
        del pairs, acc
    bound, by = bound_ms(n_bytes, n_ops)
    return dict(launches=len(launches), postings=postings, bytes=n_bytes,
                max_abs_err=err, plain_ms=plain_ms, scatter_ms=scatter_ms,
                bound_ms=bound, bound_by=by)


def time_launches(launches: List[Launch], fn: Callable, reps: int) -> float:
    """Device ms of one pass over all launches (`benches.time_graph`: the
    host's cost of each wrapper call does not count)."""
    accs = {}
    for L in launches:
        shape = (L.desc[0].shape[0], L.cap)
        if shape not in accs:
            accs[shape] = torch.zeros(shape, device=L.slab[0].device)

    def run():
        for L in launches:
            fn(L, accs[(L.desc[0].shape[0], L.cap)])

    return time_graph(run, reps)


def report(name: str, res: Dict, card: str) -> None:
    ms = res["ms"]
    print(f"  score_ranges_accumulate [{name}] {res['launches']} launch(es), "
          f"{res['postings']:,} postings, {res['bytes'] / 1e9:.3f} GB: kernel "
          f"{ms:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
          f"{100 * res['bound_ms'] / ms:.1f}% of bound; plain "
          f"{res['plain_ms']:.4f} ms; scatter only (index_add_) "
          f"{res['scatter_ms']:.4f} ms; library call: none "
          f"(max abs err {res['max_abs_err']:.3g}) [{card}]", flush=True)


# ---------------------------------------------------------------------------
# the earlier design, from another source, for --baseline
# ---------------------------------------------------------------------------

def load_baseline(source: Path) -> Callable:
    """A Launch runner over `score_ranges_accumulate_launch` of `source`
    built with the port's nvcc flags; that launcher takes (..., n_rows,
    n_ranges, max_len, acc, cap, stream), with no work buffer."""
    lib = _build.load_source(source, "baseline")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = lib.score_ranges_accumulate_launch
    fn.argtypes = [ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr,
                   i64, i64, i64, ptr, i64, ptr]
    fn.restype = ctypes.c_int

    def run(L: Launch, acc) -> None:
        p_doc, tf, p_flen = _tf_of(L)
        R, NR = L.desc[0].shape
        err = fn(p_doc.data_ptr(), tf.data_ptr(), p_flen.data_ptr(),
                 p_doc.shape[0], *(t.data_ptr() for t in L.desc), R, NR,
                 L.max_len, acc.data_ptr(), L.cap,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: cudaError_t {err}")

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="an earlier score_windows.cu to time beside this one")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ranges_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from .. import require_cuda
    from ..index.search_exec import SharedBatchExecutor

    require_cuda()
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    idx = build_index(N_DOCS, VOCAB, POSTINGS_PER_DOC, seed=0)
    batches = make_batches(2, BATCH, seed=1)
    slab = tuple(SharedBatchExecutor(device)._get_device_slab(idx))
    rng = np.random.default_rng(2)
    cases = {
        "batch": capture_batch(idx, batches[0], batches[1], device, N_DOCS),
        "synthetic": [synthetic_case(rng, slab)],
        "rows_1024": [rows_case(rng, slab)],
        "edges": [edges_case(rng, slab)],
    }
    base = load_baseline(args.baseline) if args.baseline else None
    for name, launch in limit_cases(cases["synthetic"][0]).items():
        ms = time_launches([launch], kernel_fn, args.reps)
        print(f"  score_ranges_accumulate [synthetic, {name}]: kernel "
              f"{ms:.4f} ms [{card}]", flush=True)
    for name, launches in cases.items():
        res = check_case(name, launches, args.reps)
        if base is None:
            res["ms"] = time_launches(launches, kernel_fn, args.reps)
            report(name, res, card)
            continue
        turns = (("baseline", base), ("current", kernel_fn),
                 ("current", kernel_fn), ("baseline", base))
        times = [(label, time_launches(launches, fn, args.reps))
                 for label, fn in turns]
        for label in ("baseline", "current"):
            mine = [t for lab, t in times if lab == label]
            res["ms"] = min(mine)
            report(f"{name}, {label}", res, card)
            print(f"    ({label} turns: {', '.join(f'{t:.4f}' for t in mine)} "
                  f"ms)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
