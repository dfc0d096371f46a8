#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `oramacore_tpu_torch/ops/csrc/` into
`build/kernels/`, checks each kernel against its plain PyTorch version on
the card, then drives the dense BM25F search path through the executor
entry points the read side calls (`SharedBatchExecutor.search_topk_shared`
for batches, `StringSearchTopK.search_topk` for single queries) on the
repo's 1M-doc full-text scale configuration (`benches/scale_bench.py`,
`bench_bm25_1m`: 1,000,000 docs, vocab 100,000, 40 postings per doc,
zipf term weights, seed 0). Results are held against the numpy reference
scorer.

Progress goes to stdout. The second-to-last line is a JSON object with
one entry per kernel of the path; the last line is
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero and
prints no result line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench_bm25_1m (benches/scale_bench.py:40)
N_DOCS = 1_000_000
VOCAB = 100_000
POSTINGS_PER_DOC = 40
BATCH = 1024
STEADY_BATCHES = 5
K = 10
N_CHECKED = 8  # queries held against the numpy reference

KERNEL_SOURCE = "oramacore_tpu_torch/ops/csrc/score_windows.cu"
REPLACES = "oramacore_tpu/ops/pallas_score.py:34"


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data (numpy, seeded)
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
    from oramacore_tpu.index.string_index import (
        FieldStats,
        StringIndex,
        _CommittedField,
    )

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
# checks
# ---------------------------------------------------------------------------

def reference_top(ref, k):
    top = sorted(ref.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return [d for d, _ in top], np.array([s for _, s in top], np.float64)


def topk_errors(ids, vals, ref_ids, ref_vals, score_of, rtol=1e-4,
                tie_rtol=1e-5):
    """Disagreements of one query's top-k with a reference top-k: values
    within rtol; an id may differ from the reference's at the same rank
    only across a near-tie (its reference score within tie_rtol of the
    reference's score at that rank)."""
    errs = []
    n = len(ref_ids)
    if not np.allclose(vals[:n], ref_vals, rtol=rtol, atol=0):
        errs.append(f"values {vals[:n]} vs {ref_vals}")
    if np.isfinite(vals[n:]).any():
        errs.append(f"extra hits {vals[n:]}")
    for i in range(n):
        if int(ids[i]) == int(ref_ids[i]):
            continue
        s = score_of.get(int(ids[i]))
        if s is None or abs(s - ref_vals[i]) > tie_rtol * abs(ref_vals[i]):
            errs.append(f"rank {i}: doc {ids[i]} (ref score {s}) vs "
                        f"doc {ref_ids[i]} ({ref_vals[i]})")
    return errs


def reference_scores(idx, queries, n_docs, masks=None):
    from oramacore_tpu_torch.index.search_exec import host_bm25_reference

    return [
        host_bm25_reference(idx, q, ["body"], {}, n_docs,
                            doc_mask=None if masks is None else masks[b])
        for b, q in enumerate(queries)
    ]


def check_against_reference(refs, vals, ids, counts, label, masks=None):
    bad = []
    for b, ref in enumerate(refs):
        ref_ids, ref_vals = reference_top(ref, K)
        errs = topk_errors(ids[b], vals[b], ref_ids, ref_vals, ref)
        if counts[b] != len(ref):
            errs.append(f"match count {counts[b]} vs {len(ref)}")
        if masks is not None and not all(masks[b][d] for d in ids[b][:len(ref_ids)]):
            errs.append("a filtered-out doc was returned")
        bad += [f"query {b}: {e}" for e in errs]
    check(not bad, f"{label}: top-{K} and match counts of {len(refs)} "
                   f"queries equal the numpy reference"
                   + ("" if not bad else "\n    " + "\n    ".join(bad[:10])))


def check_shared_vs_single(refs, sv, si, pv, pi):
    bad = []
    for b, ref in enumerate(refs):
        n = int(np.isfinite(pv[b]).sum())
        errs = topk_errors(si[b], sv[b], pi[b][:n],
                           pv[b][:n].astype(np.float64), ref, rtol=1e-5)
        bad += [f"query {b}: {e}" for e in errs]
    check(not bad, f"shared and per-query top-{K} agree (overlap 1.0 "
                   f"outside near-ties) on {len(refs)} queries"
                   + ("" if not bad else "\n    " + "\n    ".join(bad[:10])))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def time_cuda(fn, reps):
    """Mean ms per call over `reps` calls, after one warm-up, by CUDA
    events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(slab, card):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from oramacore_tpu_torch.ops import score_windows as sw

    dev = slab.doc.device
    n = slab.doc.shape[0]
    rng = np.random.default_rng(2)
    out = {}

    # score_windows: the TPU kernel's contract, NS=4096, w=1024
    ns, w = 4096, 1024
    starts = torch.from_numpy(
        (rng.integers(0, (n - w) // 1024, ns) * 1024).astype(np.int32)
    ).to(dev)
    b = rng.uniform(0.3, 0.9, ns)
    params = torch.from_numpy(np.stack(
        [rng.uniform(0.5, 2, ns), 1 - b, b / rng.uniform(5, 40, ns),
         np.zeros(ns)], axis=1).astype(np.float32)).to(dev)
    docs, ntf = sw.score_windows(slab.doc, slab.tf, slab.flen, starts,
                                 params, w=w)
    pdocs, pntf = sw.score_windows_plain(slab.doc, slab.tf, slab.flen,
                                         starts, params, w)
    torch.cuda.synchronize()
    err = float((ntf - pntf).abs().max())
    check(torch.equal(docs, pdocs), "score_windows: docs equal the plain version")
    check(torch.allclose(ntf, pntf, rtol=1e-6, atol=0),
          f"score_windows: ntf within rtol 1e-6 of the plain version "
          f"(max abs err {err:.3g})")
    ms = time_cuda(lambda: sw.score_windows(
        slab.doc, slab.tf, slab.flen, starts, params, w=w), 20)
    plain_ms = time_cuda(lambda: sw.score_windows_plain(
        slab.doc, slab.tf, slab.flen, starts, params, w), 5)
    print(f"  score_windows NS={ns} w={w}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms [{card}]", flush=True)
    out["score_windows"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err)

    # score_ranges_accumulate at the shared path's shapes: cu=64 rows,
    # NR=32 ranges of up to MAX_RANGE_LEN postings, cap=2^20
    from oramacore_tpu_torch.ops.bm25 import MAX_RANGE_LEN

    R, NR, cap = 64, 32, 1 << 20
    lens = rng.integers(0, MAX_RANGE_LEN + 1, (R, NR))
    lens[:, NR // 2:] //= 64  # mixed long and short ranges, like a chunk
    desc = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, n - MAX_RANGE_LEN, (R, NR)).astype(np.int32),
        lens.astype(np.int32),
        rng.uniform(0.5, 2, (R, NR)).astype(np.float32),
        rng.uniform(0.3, 0.9, (R, NR)).astype(np.float32),
        rng.uniform(5, 40, (R, NR)).astype(np.float32),
    )]
    acc = torch.zeros((R, cap), device=dev)
    sw.score_ranges_accumulate(*slab, *desc, acc, exact=False,
                               max_len=MAX_RANGE_LEN)
    ref = sw.score_ranges_accumulate_plain(
        slab.doc, slab.tf, slab.flen, *desc, torch.zeros_like(acc)
    )
    torch.cuda.synchronize()
    err = float((acc - ref).abs().max())
    check(torch.equal(acc > 0, ref > 0),
          "score_ranges_accumulate: the set of hit docs equals the plain version's")
    check(torch.allclose(acc, ref, rtol=1e-5, atol=1e-6),
          f"score_ranges_accumulate: acc within rtol 1e-5 / atol 1e-6 of the "
          f"plain version (max abs err {err:.3g})")
    postings = int(lens.sum())
    ms = time_cuda(lambda: sw.score_ranges_accumulate(
        *slab, *desc, acc, exact=False, max_len=MAX_RANGE_LEN), 20)
    plain_ms = time_cuda(lambda: sw.score_ranges_accumulate_plain(
        slab.doc, slab.tf, slab.flen, *desc, acc), 3)
    print(f"  score_ranges_accumulate R={R} NR={NR} cap={cap} "
          f"({postings:,} postings): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, kernel {postings * 12 / ms / 1e6:.1f} GB/s "
          f"of posting reads [{card}]", flush=True)
    out["score_ranges_accumulate"] = dict(ms=ms, plain_ms=plain_ms,
                                          max_abs_err=err)
    return out


def drive_main_path(idx, batches, n_docs, device, card, filter_seed=3):
    """The main path once, through the executors' entry points: batches
    through search_topk_shared (unfiltered, then filtered), then
    N_CHECKED single queries through search_topk. Returns what the checks
    need."""
    import torch

    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.index.search_exec import SharedBatchExecutor
    from oramacore_tpu_torch.ops.bm25 import round_up_pow2

    cap = n_docs
    ex = SharedBatchExecutor(device)
    t0 = time.perf_counter()
    ex._get_device_slab(idx)
    ex._get_device_champs(idx, round_up_pow2(cap, 128))
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"  slab + champion rows to the device: "
          f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)

    def run(qs, **kw):
        t = time.perf_counter()
        res = ex.search_topk_shared(idx, qs, ["body"], {}, float(n_docs),
                                    cap, K, **kw)
        return res, time.perf_counter() - t

    first, first_s = run(batches[0])
    steady = [run(qs)[1] for qs in batches[1:]]
    B = len(batches[0])
    mean_s = float(np.mean(steady))
    print(f"  search_topk_shared B={B} k={K} cap={cap}: first batch "
          f"{first_s * 1e3:.1f} ms; steady over {len(steady)} distinct "
          f"batches mean {mean_s * 1e3:.1f} ms (min {min(steady) * 1e3:.1f}, "
          f"max {max(steady) * 1e3:.1f}); {B / mean_s:.1f} QPS [{card}]",
          flush=True)

    rng = np.random.default_rng(filter_seed)
    masks = rng.integers(0, 2, (B, n_docs), dtype=np.uint8).view(bool)
    filtered, filt_s = run(batches[0], doc_masks=list(masks))
    print(f"  search_topk_shared B={B} with a 50% filter per query: "
          f"{filt_s * 1e3:.1f} ms [{card}]", flush=True)

    queries = batches[0][:N_CHECKED]
    plans = [plan_query(idx, q, ["body"], {}, use_champions=True)
             for q in queries]
    t = time.perf_counter()
    single = ex.search_topk(idx, plans, [float(n_docs)] * len(plans), cap, K)
    print(f"  search_topk B={len(plans)}: "
          f"{(time.perf_counter() - t) * 1e3:.1f} ms [{card}]", flush=True)
    return dict(first=first, filtered=filtered, masks=masks, single=single,
                queries=queries)


def check_main_path(idx, run, n_docs):
    vals, ids, counts = run["first"]
    q = run["queries"]
    B = len(vals)
    check(vals.shape == (B, K) and ids.shape == (B, K)
          and counts.shape == (B,), f"result shapes ({B}, {K}) / ({B},)")
    hit = np.isfinite(vals)
    check(bool((vals[hit] > 0).all() and (ids >= 0).all()
               and (ids < n_docs).all()),
          "scores finite and positive, ids inside the corpus")
    t0 = time.perf_counter()
    refs = reference_scores(idx, q, float(n_docs))
    masks = run["masks"][:2]
    frefs = reference_scores(idx, q[:2], float(n_docs), masks)
    print(f"  numpy reference for {len(q) + 2} queries: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check_against_reference(refs, vals, ids, counts, "shared, unfiltered")
    fv, fi, fc = run["filtered"]
    check_against_reference(frefs, fv, fi, fc, "shared, filtered", masks)
    pv, pi, pc = run["single"]
    check_against_reference(refs, pv, pi, pc, "per-query")
    check_shared_vs_single(refs, vals, ids, pv, pi)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from oramacore_tpu_torch import require_cuda
    from oramacore_tpu_torch.ops import _build
    from oramacore_tpu_torch.ops import score_windows as sw

    print("[1] device", flush=True)
    require_cuda()
    device = torch.device("cuda")
    card = card_line()
    print(f"  card: {card}", flush=True)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)

    print("[2] build the kernels", flush=True)
    t0 = time.perf_counter()
    sw.load_kernels()
    seconds, log = _build.BUILD_LOG["score_windows"]
    built = f"built by nvcc in {seconds:.1f} s" if log else \
        "loaded from build/kernels/ (built earlier from the same sources)"
    print(f"  score_windows.cu: {built}; ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    print(f"[3] the {N_DOCS:,}-doc index (bench_bm25_1m)", flush=True)
    t0 = time.perf_counter()
    idx = build_index(N_DOCS, VOCAB, POSTINGS_PER_DOC, seed=0)
    comm = idx.slab_split()[0]
    n_champ = 0 if idx._champ_matrix is None else idx._champ_matrix.shape[0]
    print(f"  host index build {time.perf_counter() - t0:.2f} s: "
          f"{len(comm[0]):,} postings, {n_champ} champion rows", flush=True)
    batches = make_batches(1 + STEADY_BATCHES, BATCH, seed=1)

    print("[4] kernels against their plain versions on the card", flush=True)
    from oramacore_tpu_torch.index.search_exec import SharedBatchExecutor

    slab = SharedBatchExecutor(device)._get_device_slab(idx)
    timings = phase_kernels(slab, card)
    del slab
    torch.cuda.empty_cache()

    print("[5] the main path", flush=True)
    torch.cuda.reset_peak_memory_stats()
    sw.reset_launch_counts()
    run = drive_main_path(idx, batches, N_DOCS, device, card)
    launches = dict(sw.LAUNCHES)
    print(f"  kernel launches on the main path: {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    check(launches["score_ranges_accumulate"] > 0,
          "the main path launched score_ranges_accumulate")
    check_main_path(idx, run, N_DOCS)

    t = timings["score_ranges_accumulate"]
    kernels = {"kernels": [{
        "name": "score_ranges_accumulate",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches["score_ranges_accumulate"],
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
    }]}
    print(f"card: {card}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # any failed phase: no result line, non-zero exit
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
