#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `oramacore_tpu_torch/ops/csrc/` into
`build/kernels/` (one nvcc per source, in parallel), checks each kernel
against its plain PyTorch version on the card and times it beside its
bound (bytes over 3.35 TB/s) and a PyTorch call that computes the same
function where there is one; `score_ranges_accumulate` runs the recorded
launches of one steady B=1024 batch of the main path and the cases of
`oramacore_tpu_torch/benches/ranges_bench.py`. Then it drives the port's
paths through the entry points a user calls, each with the kernels'
launch counts set to 0 just before it and read just after:

- the dense BM25F search path through the executor entry points the read
  side calls (`SharedBatchExecutor.search_topk_shared` for batches,
  `StringSearchTopK.search_topk` for single queries) on the repo's 1M-doc
  full-text scale configuration (`benches/scale_bench.py`,
  `bench_bm25_1m`: 1,000,000 docs, vocab 100,000, 40 postings per doc,
  zipf term weights, seed 0);
- the window-scoring bench (`oramacore_tpu_torch/benches/pallas_bench.py`
  at its defaults: 2048 windows of 1024 over 64Mi postings), the one path
  that runs `gather_windows` and `score_windows`;
- the fused sort-by search (`search_topk_sorted`, batched B=64 with k=512
  and single queries) and group-by search (`search_topk_grouped`, B=8,
  G=8 and G=64) on the same 1M-doc index;
- vector search on the repo's 1M-vector configuration
  (`benches/scale_bench.py`, `bench_vector_1m`: 1,000,000 rows x 384,
  seed 0, B=64, k=10): `VectorIndex.search_many` and `search` over the
  flat bf16 slab, then over the int8 IVF layout that `_build_ivf` makes
  (1,000 centroids, window 2048, nprobe 32);
- fused hybrid search on the 1M-doc index with row i of that matrix as
  doc i's vector: `HybridSearchTopK.search_topk_hybrid` (B=8, plain,
  filtered, OMC + match bitmap), `search_topk_hybrid_int8` (B=8,
  champion plans) and both hybrid tails of `search_topk_shared` (B=1024);
- the pruned full-text tier (`PrunedPlanMixin.search_topk_pruned`) on the
  repo's 10M-tier text configuration (`benches/hybrid10m_bench.py` at its
  defaults: 10,485,760 docs, 2^27 postings, vocab 65,536, 3-term
  queries; `oramacore_tpu_torch/benches/pruned_bench.py`): v4 at B=64,
  256 (four chunks) and 1, v3 under a 50% filter (B=64), exact tf (B=8),
  a 1,000-doc filter (B=8, the filter as candidate set) and exact counts
  (B=8, and B=64 sliced by 8); both rescore kernels, `rescore_bsearch`
  and `rescore_worklist`, against their plain versions at the inputs of
  the v4 and v3 B=64 calls (timed), the v4 B=1 call and the v3 exact-tf
  B=8 call;
- on the same 10M-doc index and the vector side of that configuration
  (10,485,760 x 768 int8 IVF layout, 4,096 centroids, window 2,048,
  nprobe 8, built on the card by
  `oramacore_tpu_torch/benches/hybrid10m.py`): the pruned facets
  (`PrunedPlanMixin.facet_counts_pruned` and `facet_match_count`) over a
  string, a number, a multi-valued string and a multi-valued number
  column, plain, thresholded, exact tf, under 5% tombstones, hybrid and
  vector-only; both facet kernels, `facet_hist` and `facet_hist_multi`,
  against their plain versions at the largest query's reps (timed); the
  pruned int8 hybrid (`HybridSearchTopK.search_topk_hybrid_int8_pruned`)
  at v4 B=64 and 256, v3 under a 50% filter, a 1,000-doc filter and
  exact tf;
- the text encoder (`oramacore_tpu_torch/embeddings/`) with both bundled
  checkpoints, `models/semantic-base` and `models/semantic-mini`, loaded
  by hand (safetensors reader, WordPiece tokenizer): its attention
  kernel, `encoder_attention`, against its plain version in f64 at the
  encoder's shapes, BGEBase's and BGESmall's geometry and the edge cases
  (timed beside `scaled_dot_product_attention`); the golden vectors of
  the JAX encoder;
  65,536 seeded passages through `EmbeddingsService.calculate_embeddings`
  (`SemanticBase`, calls of 100 as the write side batches), 1,024 of them
  held against the plain path in f64; B=1024 encode throughput of each
  model; B=1 query latency; then flat, IVF and hybrid search
  (`HybridSearchTopK.search_topk_hybrid` over a `StringIndex` of the same
  passages, indexed through the text parser's packed tokens) with
  embedded query texts;
- the ingest text pipeline on 262,144 seeded JSON documents of the
  reference's games-bench shape (`oramacore_tpu_torch/benches/
  ingest_bench.py`): the native tokenizer, live accumulator and hash
  encoder against their Python routes on 16,384 of them (timed, held
  equal), then every document through `flatten_document`, `build_doc_op`
  and `StringIndex.index_text_packed`, and through the `EmbeddingQueue`
  into a `VectorIndex`; the shared BM25 batch (B=256) of query strings
  planned by `query_tokens`, its `score_ranges_accumulate` launches
  against the plain version, flat and IVF search (B=64) and the fused
  hybrid (B=8).

Each `torch.profiler` reading is held to the wrappers' launch counts of
the same call (`profile_once`): a profile that misses a launch gives no
device time.

Search results are held against numpy references: the BM25 reference
scorer, bf16-rounded vector products summed in f32, a numpy copy of the
IVF probe scan, min-max fusion, a numpy copy of the pruned tier's
nomination (ids and scores against the reference scorer restricted to
the candidates), and numpy facet counts (distinct matched docs per
bucket).

Progress goes to stdout. The second-to-last line is a JSON object with
one entry per kernel; the last line is `{"ok": true, "device": {...}}`.
Any failed phase exits non-zero and prints no result line. Without a CUDA
device it exits non-zero at once.
"""

from __future__ import annotations

import gc
import json
import os
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

# sort-by / group-by phases (read/__init__.py:2616 bounds sorted pages at
# 512; benches/hybrid10m_bench.py:1150-1170 sets the group-by shapes)
SORT_BATCH = 64
SORT_K = 512
GROUP_BATCH = 8
GROUP_K = 16
GROUP_R = 8
N_SORT_CHECKED = 4  # queries of each new path held against the reference

# bench_vector_1m (benches/scale_bench.py:108); 384 is the width of the
# default embedding model builtin-minihash-384
VEC_ROWS = 1_000_000
VEC_DIM = 384
VEC_BATCH = 64
VEC_STEADY = 3      # distinct steady batches after the first
N_VEC_CHECKED = 8   # queries held against the numpy reference
VEC_TIE = 1e-5      # |score difference| below which two rows are near-tied
HYBRID_BATCH = 8
HYBRID_SIM = 0.1
HYBRID_COS = 0.8    # cosine of each hybrid query vector to its source doc
N_HYBRID_CHECKED = 4
NEG_INF = -1e30

# phase 12: the pruned tier (benches/hybrid10m_bench.py's text side)
PRUNED_STEADY = 3     # distinct steady batches after the checked one
N_PRUNED_CHECKED = 4  # queries of each route held against numpy
# routes whose first rescore call holds its kernel to the plain version
# (True: also timed, for the kernels line)
KERNEL_CALLS = {"v4 B=64": True, "v3 50% filter B=64": True,
                "v4 B=1": False, "v3 exact B=8": False}

# phase 13: pruned facets and the pruned int8 hybrid on phase 12's index
# with benches/hybrid10m_bench.py's vector side
N_HYBRID10M_LABEL = "10,485,760 x 768"
FACET_QUERIES = 32        # the bench's 3-term queries, after the top-3 one
N_FACET_CHECKED = 2       # facet queries of each case held against numpy
HYBRID_POOL = 512         # query vectors (the bench's NQ)
N_HYBRID_PRUNED_CHECKED = 4
SIMILARITY_10M = 0.3      # the bench's vector similarity (:531-539)
TOMBSTONES = 0.05         # dead share of the facet cases' alive mask

# phase 14: the text encoder, from passage text to search
ENC_PASSAGES = 65_536     # the ingest corpus (benches/encoder_bench.py)
ENC_SEED = 14
ENC_CALL = 100            # texts a call: the write side's batch_limit
                          # (write/__init__.py:200)
ENC_CHECKED = 1_024       # ingested passages held against the f64 plain path
ENC_THROUGHPUT_B = 1_024  # one encode call of each model
ENC_QUERIES = 64          # B=1 query embeddings timed
ENC_SEARCH_B = 64         # embedded queries a flat / IVF batch
ENC_HYBRID_SIM = 0.5      # the hybrid's vector similarity threshold
ENC_ATOL = 2e-5           # |d| of unit vectors: against the JAX encoder's
                          # golden vectors and the f64 plain path
ATTN_TOL = 1e-5           # encoder_attention against its f64 plain version
                          # (rtol and atol; f32 sums of up to 512 terms)
# tests/test_semantic_encoder.py:46-75
ENC_SYNONYMS = ["car", "automobile", "doctor", "physician", "storm"]
ENC_PHRASE_Q = ["buy car", "fast boat trip", "doctor visit",
                "cold storm night"]
ENC_PHRASE_T = ["automobile purchase", "rapid vessel voyage",
                "physician appointment", "icy tempest evening"]

# phase 15: the ingest text pipeline, from JSON documents to search
# (oramacore_tpu_torch/benches/ingest_bench.py)
INGEST_DOCS = 262_144     # documents of the games bench's shape
INGEST_SEED = 15
INGEST_VOCAB = 50_000     # English-like words, stems x suffixes
INGEST_COMPARE = 16_384   # documents timed on the native and Python routes
INGEST_PARITY = 4_096     # ASCII documents / texts held route against route
INGEST_INSERT = 1_024     # documents an insert batch
INGEST_QUERIES = 256      # query strings of 1-4 words (the BM25 batch)
INGEST_VEC_B = 64         # embedded queries a flat / IVF batch
INGEST_HYBRID_SIM = 0.2   # the hybrid's vector similarity threshold
N_INGEST_CHECKED = 16     # BM25 queries held against the reference scorer

# Every ported kernel entry point: its wrapper module, the CUDA source, the
# TPU kernel (or, with jitted=True, the jitted JAX function) it replaces,
# and the path whose run gives its launch count.
KERNELS = (
    dict(name="score_windows",
         module="oramacore_tpu_torch.ops.score_windows", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/score_windows.cu",
         replaces="oramacore_tpu/ops/pallas_score.py:34", path="bench"),
    dict(name="score_ranges_accumulate",
         module="oramacore_tpu_torch.ops.score_windows", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/score_windows.cu",
         replaces="oramacore_tpu/ops/pallas_score.py:34", path="main"),
    dict(name="gather_windows",
         module="oramacore_tpu_torch.ops.gather_windows", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/gather_windows.cu",
         replaces="oramacore_tpu/ops/pallas_gather.py:38", path="bench"),
    # kernels for jitted JAX code (XLA, no pallas_call)
    dict(name="rescore_bsearch",
         module="oramacore_tpu_torch.ops.pruned", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/pruned_rescore.cu",
         replaces="oramacore_tpu/ops/pruned.py:764", jitted=True,
         path="pruned"),
    dict(name="rescore_worklist",
         module="oramacore_tpu_torch.ops.pruned", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/pruned_rescore.cu",
         replaces="oramacore_tpu/ops/pruned.py:242", jitted=True,
         path="pruned"),
    dict(name="facet_hist",
         module="oramacore_tpu_torch.ops.facet_hist", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/facet_hist.cu",
         replaces="oramacore_tpu/ops/pruned.py:1139", jitted=True,
         path="facets"),
    dict(name="facet_hist_multi",
         module="oramacore_tpu_torch.ops.facet_hist", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/facet_hist.cu",
         replaces="oramacore_tpu/ops/pruned.py:1198", jitted=True,
         path="facets"),
    dict(name="encoder_attention",
         module="oramacore_tpu_torch.ops.attention", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/encoder_attention.cu",
         replaces="oramacore_tpu/embeddings/flax_encoder.py:69", jitted=True,
         path="encoder"),
)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


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


def check_against_reference(refs, vals, ids, counts, label, masks=None,
                            k=K):
    bad = []
    for b, ref in enumerate(refs):
        ref_ids, ref_vals = reference_top(ref, k)
        errs = topk_errors(ids[b], vals[b], ref_ids, ref_vals, ref)
        if counts[b] != len(ref):
            errs.append(f"match count {counts[b]} vs {len(ref)}")
        if masks is not None and not all(masks[b][d] for d in ids[b][:len(ref_ids)]):
            errs.append("a filtered-out doc was returned")
        bad += [f"query {b}: {e}" for e in errs]
    report_check(bad, f"{label}: top-{k} and match counts of {len(refs)} "
                      f"queries equal the numpy reference")


def report_check(bad, what):
    check(not bad, what + ("" if not bad else "\n    " + "\n    ".join(bad[:10])))


def check_shared_vs_single(refs, sv, si, pv, pi):
    bad = []
    for b, ref in enumerate(refs):
        n = int(np.isfinite(pv[b]).sum())
        errs = topk_errors(si[b], sv[b], pi[b][:n],
                           pv[b][:n].astype(np.float64), ref, rtol=1e-5)
        bad += [f"query {b}: {e}" for e in errs]
    report_check(bad, f"shared and per-query top-{K} agree (overlap 1.0 "
                      f"outside near-ties) on {len(refs)} queries")


def sorted_page_errors(ranked, count, ref, vals, present, desc, k):
    """One sort-by page against the reference order: docs with the field
    by (value, doc asc), then fieldless docs by doc asc; ids exact, scores
    within rtol 1e-4, the match count exact."""
    sign = -1.0 if desc else 1.0
    with_f = sorted((d for d in ref if present[d]),
                    key=lambda d: (sign * vals[d], d))
    exp = (with_f + sorted(d for d in ref if not present[d]))[:k]
    got = [d for d, _ in ranked]
    errs = []
    if got != exp:
        i = next((i for i, (a, b) in enumerate(zip(got, exp)) if a != b),
                 min(len(got), len(exp)))
        errs.append(f"page differs from rank {i} (len {len(got)} vs "
                    f"{len(exp)}): {got[i:i + 3]} vs {exp[i:i + 3]}")
    elif not np.allclose([v for _, v in ranked], [ref[d] for d in exp],
                         rtol=1e-4, atol=0):
        errs.append("scores outside rtol 1e-4")
    if count != len(ref):
        errs.append(f"match count {count} vs {len(ref)}")
    return errs


def group_page_errors(pages, ref, gid, R):
    """Per-group pages against the reference: each group's docs by
    (score desc, doc asc), top R, held with the topk_errors rule."""
    errs = []
    for g, page in enumerate(pages):
        members = {d: s for d, s in ref.items() if gid[d] == g}
        ref_ids, ref_vals = reference_top(members, R)
        ids = np.array([d for d, _ in page] + [-1] * (R - len(page)))
        got = np.array([v for _, v in page] + [-np.inf] * (R - len(page)))
        errs += [f"group {g}: {e}" for e in
                 topk_errors(ids, got, ref_ids, ref_vals, members)]
    return errs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def time_cold(fn_of, start_sets, reps):
    """Device ms per launch of `fn_of(starts)`, by one CUDA graph over
    distinct sets of window starts, so no launch finds its windows in the
    50 MB L2 left there by the one before."""
    from oramacore_tpu_torch.benches import time_graph

    return time_graph(lambda: [fn_of(s) for s in start_sets], reps) / len(
        start_sets)


def share(name, ms, bound, by, card):
    print(f"  {name}: {100 * bound / ms:.1f}% of its bound ({ms:.4f} ms "
          f"against {bound:.4f} ms, bound by {by}) [{card}]", flush=True)


def phase_kernels(idx, batches, slab, card):
    """Each kernel against its plain version at the main path's shapes,
    timed beside its bound and, where one PyTorch call computes the same
    function, that call. score_ranges_accumulate runs the launches of one
    steady B=1024 search_topk_shared batch as recorded, chip_smoke's
    earlier synthetic shape, R=1024 rows and edge cases
    (benches/ranges_bench.py)."""
    import torch

    from oramacore_tpu_torch.benches import bound_ms, time_cuda
    from oramacore_tpu_torch.benches import ranges_bench as rb
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
    # timed over 8 sets of windows (a set moves 84 MB); seeded apart, so
    # the draws above stay those of earlier runs
    cold = np.random.default_rng(10)
    start_sets = [torch.from_numpy(
        (cold.integers(0, (n - w) // 1024, ns) * 1024).astype(np.int32)
    ).to(dev) for _ in range(8)]
    ms = time_cold(lambda st: sw.score_windows(
        slab.doc, slab.tf, slab.flen, st, params, w=w), start_sets, 10)
    plain_ms = time_cuda(lambda: sw.score_windows_plain(
        slab.doc, slab.tf, slab.flen, starts, params, w), 5)
    # 12 B read and 8 B written per slot, 20 B of start + params per window;
    # 6 f32 operations per slot
    bound, by = bound_ms(ns * w * 20 + ns * 20, ns * w * 6)
    print(f"  score_windows NS={ns} w={w}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; library call: none [{card}]", flush=True)
    share("score_windows", ms, bound, by, card)
    out["score_windows"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                bound_ms=bound, bound_by=by, library_ms=None)

    # score_ranges_accumulate: phase 4's synthetic shape (R=64 rows of
    # NR=32 ranges, cap=2^20, the same draws as before), then the recorded
    # launches of one steady B=1024 batch of the main path, R=1024 rows
    # and edge cases from a generator of their own
    cases = {"synthetic": [rb.synthetic_case(rng, tuple(slab))]}
    t0 = time.perf_counter()
    cases["batch"] = rb.capture_batch(idx, batches[0], batches[1], dev,
                                      N_DOCS)
    print(f"  recorded {len(cases['batch'])} launches of one steady "
          f"search_topk_shared B={len(batches[1])} batch in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng2 = np.random.default_rng(3)
    cases["rows_1024"] = [rb.rows_case(rng2, tuple(slab))]
    cases["edges"] = [rb.edges_case(rng2, tuple(slab))]
    res = {}
    for name, launches in cases.items():
        try:
            res[name] = rb.check_case(name, launches, reps=3)
        except AssertionError as e:
            raise SmokeFailure(f"score_ranges_accumulate: {e}") from e
        check(True, f"score_ranges_accumulate [{name}]: {len(launches)} "
                    f"launch(es), the hit set equals the plain version's and "
                    f"acc is within rtol 1e-5 / atol 1e-6 (max abs err "
                    f"{res[name]['max_abs_err']:.3g})")
        res[name]["ms"] = rb.time_launches(launches, rb.kernel_fn,
                                           20 if len(launches) == 1 else 5)
        rb.report(name, res[name], card)
        share(f"score_ranges_accumulate [{name}]", res[name]["ms"],
              res[name]["bound_ms"], res[name]["bound_by"], card)
    del cases
    r = res["batch"]
    out["score_ranges_accumulate"] = dict(
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None,
        max_abs_err=max(x["max_abs_err"] for x in res.values()))

    # gather_windows: the TPU kernel's contract on the slab's doc (int32)
    # and tf (f32) columns, NS=4096, w=1024; a copy, so exact
    from oramacore_tpu_torch.ops import gather_windows as gw

    starts = torch.from_numpy(
        (rng.integers(0, (n - w) // gw.ALIGN, ns) * gw.ALIGN).astype(np.int32)
    ).to(dev)
    start_sets = [torch.from_numpy(
        (cold.integers(0, (n - w) // gw.ALIGN, ns) * gw.ALIGN).astype(np.int32)
    ).to(dev) for _ in range(8)]    # 8 sets of 32 MiB moved each
    flat_sets = [(st.long()[:, None] + torch.arange(w, device=dev)).reshape(-1)
                 for st in start_sets]
    for col, src in (("doc", slab.doc), ("tf", slab.tf)):
        got = gw.gather_windows(src, starts, w=w)
        exp = gw.gather_windows_plain(src, starts, w)
        torch.cuda.synchronize()
        err = float((got.double() - exp.double()).abs().max())
        check(got.dtype == src.dtype and torch.equal(got, exp),
              f"gather_windows on p_{col} ({src.dtype}): equal to the plain "
              f"version (max abs err {err:.3g})")
        ms = time_cold(lambda st: gw.gather_windows(src, st, w=w),
                       start_sets, 20)
        plain_ms = time_cuda(lambda: gw.gather_windows_plain(src, starts, w), 10)
        lib_ms = time_cold(lambda fi: torch.index_select(src, 0, fi),
                           flat_sets, 20)
        mib = ns * w * 4 / 2**20
        bound, by = bound_ms(2 * ns * w * 4 + ns * 4, 0)
        print(f"  gather_windows p_{col} NS={ns} w={w} ({mib:.0f} MiB read + "
              f"{mib:.0f} MiB written): kernel {ms:.4f} ms "
              f"({2 * mib * 2**20 / ms / 1e6:.1f} GB/s), plain "
              f"{plain_ms:.4f} ms, library torch.index_select {lib_ms:.4f} ms "
              f"[{card}]", flush=True)
        if col == "doc":
            share("gather_windows", ms, bound, by, card)
            out["gather_windows"] = dict(
                ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)
    return out


def wrapper_modules():
    import importlib

    return [importlib.import_module(m)
            for m in dict.fromkeys(k["module"] for k in KERNELS)]


def counted(label, fn):
    """Run one path with every launch count set to 0 just before it;
    returns (its result, the counts read just after)."""
    import torch

    mods = wrapper_modules()
    for mod in mods:
        mod.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    counts = {name: n for mod in mods for name, n in mod.LAUNCHES.items()}
    print(f"  kernel launches on the {label} path: {counts}", flush=True)
    return res, counts


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
    return refs, frefs


def phase_bench(card):
    """The window-scoring bench at its defaults: parity, then the times of
    its three arms."""
    import torch

    from oramacore_tpu_torch.benches import pallas_bench as pb

    ns, w, postings = 2048, 1024, 64 * 1024 * 1024
    t0 = time.perf_counter()
    d = pb.make_data(ns, w, postings, torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"  data NS={ns} W={w} P={postings:,} "
          f"({3 * (postings + w) * 4 / 2**30:.2f} GiB of slab) on the card: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        err = pb.check_parity(pb.run_arms(d))
    except AssertionError as e:
        raise SmokeFailure(f"bench parity: {e}") from e
    print(f"  ok: bench parity: fused docs == 2-stage docs, fused ntf within "
          f"rtol 1e-5 / atol 1e-6 (max abs err {err:.3g}), gathered docs == "
          f"2-stage docs", flush=True)
    times = pb.time_arms(d)
    pb.report(d, times, card)
    return times


def sort_column(n_docs, seed=4):
    """A number column: seeded integers 0..9,999 as f64 (values repeat, so
    ties are real), 10% of docs without the field."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 10_000, n_docs).astype(np.float64),
            rng.random(n_docs) >= 0.1)


def phase_sorted(idx, batches, refs, frefs, masks, n_docs, device, card):
    """Fused sort-by: the batched route (SharedBatchExecutor, B=64, k=512,
    desc) and single queries (StringSearchTopK: asc, and asc under a 50%
    filter), held against the reference order."""
    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.index.search_exec import (
        SharedBatchExecutor,
        StringSearchTopK,
    )

    vals, present = sort_column(n_docs)
    key = ("svals", idx.uid, "price", 1)

    def plans_of(qs):
        return [plan_query(idx, q, ["body"], {}, use_champions=False)
                for q in qs]

    def sorted_run(ex, qs, desc, **kw):
        plans = plans_of(qs)
        t = time.perf_counter()
        res = ex.search_topk_sorted(
            idx, plans, [float(n_docs)] * len(plans), n_docs, SORT_K,
            sort_vals=vals, sort_present=present, svals_key=key, desc=desc,
            **kw)
        return res, time.perf_counter() - t

    shared = SharedBatchExecutor(device)
    single = StringSearchTopK(device)

    def drive():
        out = {}
        for i, qs in enumerate(batches[:3]):
            out[f"batch{i}"] = sorted_run(shared, qs[:SORT_BATCH], True)
        q = batches[0][:N_SORT_CHECKED]
        out["asc"] = [sorted_run(single, [x], False) for x in q]
        out["filtered"] = [sorted_run(single, [x], False, doc_masks=[m])
                           for x, m in zip(q[:len(frefs)], masks)]
        return out

    out, launches = counted("sort-by", drive)
    check(launches["score_ranges_accumulate"] > 0,
          "the sort-by path launched score_ranges_accumulate")
    ts = [out[f"batch{i}"][1] * 1e3 for i in range(3)]
    print(f"  search_topk_sorted (SharedBatchExecutor) B={SORT_BATCH} "
          f"k={SORT_K} desc: first {ts[0]:.1f} ms, then {ts[1]:.1f} / "
          f"{ts[2]:.1f} ms on distinct batches [{card}]", flush=True)
    asc = [t * 1e3 for _, t in out["asc"]]
    filt = [t * 1e3 for _, t in out["filtered"]]
    print(f"  search_topk_sorted (StringSearchTopK) B=1 k={SORT_K} asc: "
          f"{', '.join(f'{t:.1f}' for t in asc)} ms; under a 50% filter: "
          f"{', '.join(f'{t:.1f}' for t in filt)} ms [{card}]", flush=True)

    (ranked, counts), _ = out["batch0"]
    bad = []
    for b, ref in enumerate(refs[:N_SORT_CHECKED]):
        bad += [f"batched query {b}: {e}" for e in sorted_page_errors(
            ranked[b], counts[b], ref, vals, present, True, SORT_K)]
    for b, ((r, c), _) in enumerate(out["asc"]):
        bad += [f"single query {b}: {e}" for e in sorted_page_errors(
            r[0], c[0], refs[b], vals, present, False, SORT_K)]
    for b, ((r, c), _) in enumerate(out["filtered"]):
        bad += [f"filtered query {b}: {e}" for e in sorted_page_errors(
            r[0], c[0], frefs[b], vals, present, False, SORT_K)]
        if not all(masks[b][d] for d, _ in r[0]):
            bad.append(f"filtered query {b}: a filtered-out doc was returned")
    report_check(bad, f"sort-by pages (k={SORT_K}) equal the numpy reference "
                      f"doc for doc, with exact counts: {N_SORT_CHECKED} "
                      f"batched desc, {len(out['asc'])} single asc, "
                      f"{len(out['filtered'])} filtered asc")
    n_page = len(ranked[0])
    check(n_page == min(SORT_K, len(refs[0])),
          f"the first batched page holds {n_page} docs")


def phase_grouped(idx, batches, refs, n_docs, device, card):
    """Fused group-by at G=8 and G=64 (B=8, k=16, R=8), held against the
    reference: main page and counts as on the main path, each group's page
    by (score desc, doc asc) outside near-ties."""
    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.index.search_exec import StringSearchTopK

    ex = StringSearchTopK(device)
    qs = batches[0][:GROUP_BATCH]
    plans = [plan_query(idx, q, ["body"], {}, use_champions=False) for q in qs]
    for G in (8, 64):
        gid = np.random.default_rng(5 + G).integers(-1, G, n_docs).astype(np.int32)

        def run(gid=gid, G=G):
            t = time.perf_counter()
            res = ex.search_topk_grouped(
                idx, plans, [float(n_docs)] * len(plans), n_docs, GROUP_K,
                gid_col=gid, gid_key=("gid", idx.uid, G), n_groups=G,
                max_results=GROUP_R)
            return res, time.perf_counter() - t

        runs, launches = counted(f"group-by G={G}", lambda: [run(), run()])
        check(launches["score_ranges_accumulate"] > 0,
              f"the group-by path (G={G}) launched score_ranges_accumulate")
        (vals, ids, counts, pages), t_first = runs[0]
        print(f"  search_topk_grouped B={len(plans)} k={GROUP_K} "
              f"R={GROUP_R} G={G}: first {t_first * 1e3:.1f} ms, again "
              f"{runs[1][1] * 1e3:.1f} ms [{card}]", flush=True)
        check(vals.shape == (len(plans), GROUP_K) and len(pages) == len(plans)
              and all(len(p) == G for p in pages),
              f"group-by G={G}: result shapes")
        checked = refs[:N_SORT_CHECKED]
        check_against_reference(checked, vals, ids, counts,
                                f"group-by G={G} main page", k=GROUP_K)
        bad = []
        for b, ref in enumerate(checked):
            bad += [f"query {b}: {e}" for e in
                    group_page_errors(pages[b], ref, gid, GROUP_R)]
        n_entries = sum(len(p) for b in range(len(checked)) for p in pages[b])
        report_check(bad, f"group-by G={G}: {n_entries} group-page entries of "
                          f"{len(checked)} queries equal the numpy reference "
                          f"outside near-ties")


# ---------------------------------------------------------------------------
# vector and hybrid phases
# ---------------------------------------------------------------------------

def bf16_round(x):
    """f32 -> bf16 (round to nearest even) -> f32, in numpy."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def vector_corpus(n, dim, n_batches, batch, seed=0):
    """bench_vector_1m's data: rows drawn normal and L2-normalized, then
    query batches from the same generator."""
    from oramacore_tpu_torch.ops.vector import l2_normalize

    rng = np.random.default_rng(seed)
    vecs = l2_normalize(rng.normal(size=(n, dim)).astype(np.float32))
    batches = [l2_normalize(rng.normal(size=(batch, dim)).astype(np.float32))
               for _ in range(n_batches)]
    return vecs, batches


# the device function each counted entry point launches once a call
# (rescore_worklist: its tail kernel, which runs even when no tile does)
KERNEL_FUNCTIONS = {
    "score_windows": "score_windows_kernel",
    "score_ranges_accumulate": "score_ranges_accumulate_kernel",
    "gather_windows": "gather_windows_kernel",
    "rescore_bsearch": "rescore_bsearch_kernel",
    "rescore_worklist": "worklist_tail_kernel",
    "facet_hist": "facet_hist_kernel",
    "facet_hist_multi": "facet_hist_multi_kernel",
    "encoder_attention": "encoder_attention_kernel",
}


def profiled_counts(key_counts):
    """{entry point: launches of its device function} from a profile's
    (kernel name, count) pairs; a name may come demangled or mangled
    (`<length><name>`, e.g. `_ZN12_GLOBAL__N_130score_ranges_accumulate_
    kernelILb1ELb0EE...`, as the profiler gives some kernels of a
    ctypes-loaded library)."""
    import re

    pairs = list(key_counts)
    pats = {name: re.compile(rf"(?<![A-Za-z0-9_]){func}(?![A-Za-z0-9_])"
                             rf"|{len(func)}{func}")
            for name, func in KERNEL_FUNCTIONS.items()}
    return {name: sum(c for key, c in pairs if pat.search(key))
            for name, pat in pats.items()}


def launch_counts():
    return {name: n for mod in wrapper_modules()
            for name, n in mod.LAUNCHES.items()}


def profile_once(label, fn, card):
    """One call under torch.profiler, after a traced warm-up call that
    the profiler discards: device kernel time, idle share (against the
    shorter wall time of two unprofiled calls just before, since the
    profiler's own host work lengthens the profiled one) and the largest
    kernels.
    The profile's count of each kernel must equal the wrappers' LAUNCHES
    for the same call, or the phase fails: a profile that misses
    launches is a reading, not a result. (A profile without the warm-up
    step dropped kernels late in a long run.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = min(walls)
    got = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.update(
                     events=p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = launch_counts()
        fn()
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in launch_counts().items()}
        prof.step()
    kernels = [
        (getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
        for e in got["events"] if str(e.device_type).endswith("CUDA")
        and not e.key.startswith("ProfilerStep")
    ]
    profiled = profiled_counts((key, c) for _, c, key in kernels)
    off = {name: (launched[name], profiled[name]) for name in profiled
           if launched[name] != profiled[name]}
    ran = ", ".join(f"{k} {n}" for k, n in launched.items() if n) or "none"
    what = (f"profile, {label}: each kernel's count equals the wrappers' "
            f"LAUNCHES ({ran})")
    if off:
        what += (f"; it missed launches, (launched, profiled) {off}, "
                 f"{sum(c for _, c, _ in kernels)} device events")
    check(not off, what)
    dev = sum(ms for ms, _, _ in kernels)
    print(f"  profile, {label}: wall {wall:.2f} ms (unprofiled, best of 2), "
          f"device kernels {dev:.2f} ms, idle "
          f"{max(0.0, 1 - dev / wall) * 100:.0f}% [{card}]", flush=True)
    for ms, count, key in sorted(kernels, reverse=True)[:6]:
        print(f"    {ms:9.3f} ms x{count:<5} {key[:100]}", flush=True)
    return dev


def top_hits(hits, k):
    """A result dict's top-k as (ids, scores), by (score desc, doc asc)."""
    top = sorted(hits.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return [d for d, _ in top], np.array([s for _, s in top], np.float64)


def vector_top_errors(hits, ref, k=K, rtol=1e-4):
    """One vector query's top-k against a dense reference score row (the
    best score per doc, -inf where none): scores within rtol, ids equal
    outside near-ties (reference scores within VEC_TIE)."""
    ids, got = top_hits(hits, k)
    ref_ids = np.argsort(-ref, kind="stable")[:k]
    errs = []
    if len(ids) != k:
        errs.append(f"{len(ids)} hits, want {k}")
    elif not np.allclose(got, ref[ref_ids], rtol=rtol, atol=0):
        errs.append(f"scores {got} vs {ref[ref_ids]}")
    for i, (d, r) in enumerate(zip(ids, ref_ids)):
        if d != r and abs(ref[d] - ref[r]) > VEC_TIE:
            errs.append(f"rank {i}: doc {d} ({ref[d]}) vs doc {r} ({ref[r]})")
    return errs


def filtered_searches(vidx, targets, mask, label, card):
    """One single-target search per target under one filter mask, timed;
    returns the first one's hits."""
    hits, ms = [], []
    for target in targets:
        t = time.perf_counter()
        hits.append(vidx.search([target], limit=K, similarity=-1.0,
                                filter_mask=mask))
        ms.append((time.perf_counter() - t) * 1e3)
    print(f"  {label}search, one target, 50% filter: first {ms[0]:.1f} ms, "
          f"again (another target) {ms[1]:.1f} ms [{card}]", flush=True)
    return hits[0]


def phase_flat(vidx, vb16, batches, device, card):
    """Flat vector search: search_many (B=64, the batched route), search
    with the 64 targets in one call, one filtered single-target search;
    each held against bf16 products summed in f32 on the host."""
    from oramacore_tpu_torch.ops.vector import l2_normalize

    n = len(vb16)
    t = time.perf_counter()
    vidx.flat_device_rows()
    sync(device)
    print(f"  bf16 slab of {n:,} x {vb16.shape[1]} to the device: "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    def many(qs):
        t = time.perf_counter()
        res = vidx.search_many(qs, limit=K, similarities=[-1.0] * len(qs))
        return res, time.perf_counter() - t

    first, first_s = many(batches[0])
    steady = [many(qs)[1] for qs in batches[1:]]
    B = len(batches[0])
    print(f"  search_many B={B} k={K}: first {first_s * 1e3:.1f} ms; steady "
          f"{', '.join(f'{s * 1e3:.1f}' for s in steady)} ms, "
          f"{B / np.mean(steady):.1f} QPS [{card}]", flush=True)
    times, multi = [], []
    for qs in batches[:2]:
        t = time.perf_counter()
        multi.append(vidx.search(list(qs), limit=K, similarity=-1.0))
        times.append(time.perf_counter() - t)
    print(f"  search with {B} targets in one call: first {times[0] * 1e3:.1f} "
          f"ms, again {times[1] * 1e3:.1f} ms [{card}]", flush=True)
    mask = np.random.default_rng(6).random(n) < 0.5
    filtered = filtered_searches(vidx, batches[0][:2], mask, "", card)
    profile_once(f"search_many B={B}", lambda: many(batches[1]), card)

    q = bf16_round(l2_normalize(batches[0]))
    ref = vb16 @ q.T                                   # (n, B) f32
    bad = []
    for b in range(N_VEC_CHECKED):
        bad += [f"search_many query {b}: {e}"
                for e in vector_top_errors(first[b], ref[:, b])]
    bad += [f"{B} targets: {e}" for e in
            vector_top_errors(multi[0], ref.max(axis=1))]
    bad += [f"filtered: {e}" for e in
            vector_top_errors(filtered, np.where(mask, ref[:, 0], -np.inf))]
    report_check(bad, f"flat vector top-{K} of {N_VEC_CHECKED} queries, of the "
                      f"{B}-target call and of the filtered call equal the "
                      f"numpy reference outside near-ties (|dscore| <= {VEC_TIE})")
    return ref[:, :N_VEC_CHECKED]


def numpy_probe(q, lay, nprobe, k, doc_mask=None):
    """The IVF probe scan in numpy: bf16 centroid dots pick nprobe units
    (ties: lower unit first), each unit's window (start clamped to
    N - window) is scored as scale * dot(bf16(q), int8 row), and one
    stable top-k over [k empty slots, windows in probe order] keeps k.
    Returns (vals, rows, kth value, whether the nprobe-th unit is
    near-tied with the next, all scanned (vals, rows))."""
    qb = bf16_round(q)
    cs = lay["cen_b16"] @ qb
    order = np.argsort(-cs, kind="stable")
    tie = nprobe < len(cs) and cs[order[nprobe - 1]] - cs[order[nprobe]] <= VEC_TIE
    n, w = len(lay["q"]), lay["window"]
    starts = np.minimum(lay["unit_starts"][order[:nprobe]].astype(np.int64), n - w)
    rows = (starts[:, None] + np.arange(w)).reshape(-1)
    sc = lay["scales"][rows]
    s = (lay["q"][rows].astype(np.float32) @ qb) * sc
    keep = sc > 0
    if doc_mask is not None:
        keep &= doc_mask[np.clip(lay["docs"][rows], 0, len(doc_mask) - 1)]
    s = np.where(keep, s, np.float32(NEG_INF)).astype(np.float32)
    cat_v = np.concatenate([np.full(k, NEG_INF, np.float32), s])
    cat_r = np.concatenate([np.full(k, -1), rows])
    sel = np.argsort(-cat_v, kind="stable")[:k]
    return cat_v[sel], cat_r[sel], cat_v[sel[-1]], tie, (s, rows)


def phase_ivf(vidx, vecs, batches, flat_ref, device, card,
              recall_note="the rows are uniform, so clusters do not fit "
                          "them"):
    """The IVF int8 tier: _build_ivf on the same index, search_many B=64
    and a filtered search, held against numpy_probe + the f32 rerank on
    the port's own layout; recall@10 against exact search as information."""
    from oramacore_tpu_torch.index import vector_index as vi
    from oramacore_tpu_torch.ops.vector import l2_normalize

    t = time.perf_counter()
    vidx._build_ivf()
    sync(device)
    lay = dict(vidx._ivf)
    n_units = len(lay["unit_starts"])
    print(f"  _build_ivf: {time.perf_counter() - t:.2f} s ({n_units} probe units "
          f"of window {lay['window']}) [{card}]", flush=True)
    t = time.perf_counter()
    vidx.int8_device_rows()
    sync(device)
    print(f"  int8 layout to the device: {time.perf_counter() - t:.2f} s",
          flush=True)
    nprobe = min(vi.IVF_NPROBE, n_units)

    def many(qs):
        t = time.perf_counter()
        res = vidx.search_many(qs, limit=K, similarities=[-1.0] * len(qs))
        return res, time.perf_counter() - t

    first, first_s = many(batches[0])
    steady = [many(qs)[1] for qs in batches[1:]]
    B = len(batches[0])
    print(f"  IVF search_many B={B} k={K} nprobe={nprobe}: first "
          f"{first_s * 1e3:.1f} ms; steady "
          f"{', '.join(f'{s * 1e3:.1f}' for s in steady)} ms, "
          f"{B / np.mean(steady):.1f} QPS [{card}]", flush=True)
    mask = np.random.default_rng(7).random(len(vecs)) < 0.5
    filtered = filtered_searches(vidx, batches[0][:2], mask, "IVF ", card)
    profile_once(f"IVF search_many B={B}", lambda: many(batches[1]), card)

    lay["cen_b16"] = bf16_round(lay["unit_cen"])
    k = min(vi.round_up_pow2(max(K * 4, 16), 16), len(lay["q"]))
    qs = l2_normalize(batches[0])
    bad, recalls = [], []

    def reranked(q, doc_mask=None):
        vals, rows, _, tie, _ = numpy_probe(q, lay, nprobe, k, doc_mask)
        ref = np.full(len(vecs), -np.inf)
        ok = (rows >= 0) & (vals > -1e29)
        scores = vecs[lay["perm"][rows[ok]]] @ q
        np.maximum.at(ref, lay["docs"][rows[ok]], scores)
        return ref, tie

    for b in range(N_VEC_CHECKED):
        ref, tie = reranked(qs[b])
        errs = vector_top_errors(first[b], ref)
        bad += [f"query {b}{' (probe near-tie)' if tie else ''}: {e}" for e in errs]
        exact = set(np.argsort(-flat_ref[:, b], kind="stable")[:K].tolist())
        recalls.append(len(exact & set(top_hits(first[b], K)[0])) / K)
    ref, _ = reranked(qs[0], mask)
    bad += [f"filtered: {e}" for e in vector_top_errors(filtered, ref)]
    report_check(bad, f"IVF top-{K} of {N_VEC_CHECKED} queries and of the "
                      f"filtered call equal a numpy probe + f32 rerank of the "
                      f"same layout outside near-ties")
    print(f"  IVF recall@{K} against exact flat search (information, not a "
          f"gate; {recall_note}): {np.mean(recalls):.3f}", flush=True)
    return lay, nprobe


def hybrid_vectors(vecs, n, seed=8):
    """n query vectors, each a seeded perturbation of a random doc's
    vector with a cosine of about HYBRID_COS to it, normalized."""
    from oramacore_tpu_torch.ops.vector import l2_normalize

    rng = np.random.default_rng(seed)
    d = vecs.shape[1]
    sigma = np.sqrt(1 / HYBRID_COS ** 2 - 1) / np.sqrt(d)
    src = vecs[rng.integers(0, len(vecs), n)]
    return l2_normalize(src + sigma * rng.normal(size=src.shape)).astype(np.float32)


def dense_scores(ref, n):
    """A {doc: score} of the reference scorer as a dense f64 row (0 = no
    match; reference scores are positive)."""
    out = np.zeros(n)
    out[np.fromiter(ref.keys(), np.int64, len(ref))] = np.fromiter(
        ref.values(), np.float64, len(ref))
    return out


def fused_reference(bm25, vec, maybe, mask=None, omc=None):
    """Min-max fusion of one query in float64, dense over the docs: bm25
    the reference scorer's scores (already filtered), vec the vector
    scores (0 = no hit), maybe the docs whose vector hit is a near-tie.
    Returns (fused, -inf where no match; present; maybe docs)."""
    if mask is not None:
        vec = np.where(mask, vec, 0.0)
    present = (bm25 > 0) | (vec > 0)
    hi = max(float(bm25.max()), float(vec.max()))
    fused = (bm25 + vec) / (hi if hi > 0 else 1.0)
    if omc is not None:
        fused = fused * omc
    maybe = {d for d in maybe if bm25[d] == 0 and (mask is None or mask[d])}
    return np.where(present, fused, -np.inf), present, maybe


def hybrid_errors(out, refs, label, bitmap=None):
    """top-k ids / scores outside near-ties, and match counts (and match
    bitmaps) within the near-tied vector hits."""
    vals, ids, counts = out[:3]
    bad = []
    for b, (fused, present, maybe) in enumerate(refs):
        ref_ids = np.argsort(-fused, kind="stable")[:min(K, int(present.sum()))]
        score_of = {int(d): float(fused[d]) for d in ids[b]
                    if 0 <= d < len(fused) and present[d]}
        errs = topk_errors(ids[b], vals[b], ref_ids, fused[ref_ids], score_of)
        near = np.zeros(len(fused), bool)
        near[list(maybe)] = True
        sure = present & ~near
        n_sure = int(sure.sum())
        if not n_sure <= counts[b] <= n_sure + len(maybe):
            errs.append(f"match count {counts[b]} vs {n_sure} "
                        f"(+{len(maybe)} near-tied)")
        if bitmap is not None:
            got = bitmap[b][:len(fused)]
            if not ((got | ~sure).all() and (~got | present | near).all()
                    and got.sum() == counts[b]):
                errs.append("match bitmap differs from the reference set")
        bad += [f"{label} query {b}: {e}" for e in errs]
    return bad


def phase_hybrid(idx, vec_rows, lay, nprobe, vecs, vb16, batches, refs,
                 frefs, masks, n_docs, device, card):
    """Fused hybrid on the 1M-doc index (doc i's vector is row i): the
    single-batch executors over the flat slab and the IVF layout, and both
    tails of the shared batch path; launch counts per path. The BM25 side
    of the checks reuses phase 5's reference scores (refs unfiltered,
    frefs under masks[:len(frefs)])."""
    import torch

    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.index.search_exec import (
        HYBRID_INT8_CANDIDATES,
        HybridSearchTopK,
        SharedBatchExecutor,
        _ivf_candidates,
    )

    flat_rows, int8_rows = vec_rows
    B = len(batches[0])
    qv = hybrid_vectors(vecs, B)
    toks = batches[0][:HYBRID_BATCH]
    nd = [float(n_docs)] * HYBRID_BATCH
    sims = [HYBRID_SIM] * HYBRID_BATCH
    omc = np.random.default_rng(9).uniform(0.5, 2.0, n_docs).astype(np.float32)
    ex = HybridSearchTopK(device)
    shared = SharedBatchExecutor(device)
    plans = [plan_query(idx, q, ["body"], {}, use_champions=False) for q in toks]
    cplans = [plan_query(idx, q, ["body"], {}, use_champions=True) for q in toks]
    fmasks = list(masks[:HYBRID_BATCH])

    paths = {
        "hybrid flat": lambda: ex.search_topk_hybrid(
            idx, plans, nd, n_docs, K, flat_rows, qv[:HYBRID_BATCH], sims),
        "hybrid flat, 50% filter": lambda: ex.search_topk_hybrid(
            idx, plans, nd, n_docs, K, flat_rows, qv[:HYBRID_BATCH], sims,
            doc_masks=fmasks),
        "hybrid flat, OMC + bitmap": lambda: ex.search_topk_hybrid(
            idx, plans, nd, n_docs, K, flat_rows, qv[:HYBRID_BATCH], sims,
            omc=omc, omc_key=("omc", idx.uid, 1), with_bitmap=True),
        "hybrid int8, champion plans": lambda: ex.search_topk_hybrid_int8(
            idx, cplans, nd, n_docs, K, int8_rows, qv[:HYBRID_BATCH], sims),
        f"shared B={B}, flat tail": lambda: shared.search_topk_shared(
            idx, batches[0], ["body"], {}, float(n_docs), n_docs, K,
            vec_rows=flat_rows, queries=qv, similarities=[HYBRID_SIM] * B),
        f"shared B={B}, int8 tail": lambda: shared.search_topk_shared(
            idx, batches[0], ["body"], {}, float(n_docs), n_docs, K,
            vec_rows_int8=int8_rows, queries=qv, similarities=[HYBRID_SIM] * B),
    }
    out = {}
    for label, fn in paths.items():
        torch.cuda.reset_peak_memory_stats()
        runs, launches = counted(label,
                                 lambda fn=fn: [timed_ms(fn), timed_ms(fn)])
        out[label] = runs[0][0]
        check(launches["score_ranges_accumulate"] > 0,
              f"the {label} path launched score_ranges_accumulate")
        print(f"  {label}: first {runs[0][1]:.1f} ms, again {runs[1][1]:.1f} ms; "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB [{card}]", flush=True)
    for label in ("hybrid flat", "hybrid int8, champion plans",
                  f"shared B={B}, flat tail", f"shared B={B}, int8 tail"):
        profile_once(label, paths[label], card)

    # numpy references of N_HYBRID_CHECKED queries
    t0 = time.perf_counter()
    nq = N_HYBRID_CHECKED
    sims_ref = vb16 @ bf16_round(qv[:nq]).T            # (n_docs, nq)

    def flat_vec(b):
        s = sims_ref[:, b]
        return (np.where(s >= HYBRID_SIM, s, 0.0),
                set(np.nonzero(np.abs(s - HYBRID_SIM) <= VEC_TIE)[0].tolist()))

    def int8_vec(b, doc_mask=None):
        V = _ivf_candidates(HYBRID_INT8_CANDIDATES, len(lay["q"]))
        vals, rows, kth, tie, (s_all, r_all) = numpy_probe(
            qv[b], lay, nprobe, V, doc_mask)
        vec = np.zeros(n_docs)
        ok = (rows >= 0) & (vals >= HYBRID_SIM) & (vals > NEG_INF / 2)
        np.maximum.at(vec, lay["docs"][rows[ok]], vals[ok])
        edge = (np.abs(s_all - kth) <= VEC_TIE) & (kth > NEG_INF / 2)
        near = np.abs(vals - HYBRID_SIM) <= VEC_TIE
        maybe = set(lay["docs"][r_all[edge]].tolist())
        maybe |= set(lay["docs"][rows[near & (rows >= 0)]].tolist())
        if tie:
            print(f"  note: query {b} has a near-tied probe unit", flush=True)
        return vec, maybe

    def refs_of(vec_of, bm25, mask_of=lambda b: None, omc_=None):
        out_ = []
        for b, bm25_b in enumerate(bm25):
            vec, maybe = vec_of(b)
            out_.append(fused_reference(bm25_b, vec, maybe, mask_of(b), omc_))
        return out_

    frefs = [dense_scores(r, n_docs) for r in frefs[:nq]]
    refs = [dense_scores(r, n_docs) for r in refs[:nq]]
    flat_refs = refs_of(flat_vec, refs)
    bad = hybrid_errors(out["hybrid flat"], flat_refs, "hybrid flat")
    bad += hybrid_errors(
        out["hybrid flat, 50% filter"],
        refs_of(flat_vec, frefs, lambda b: fmasks[b]), "hybrid filtered")
    omc_out = out["hybrid flat, OMC + bitmap"]
    bad += hybrid_errors(omc_out, refs_of(flat_vec, refs, omc_=omc),
                         "hybrid OMC", bitmap=omc_out[3])
    int8_refs = refs_of(int8_vec, refs)
    bad += hybrid_errors(out["hybrid int8, champion plans"], int8_refs,
                         "hybrid int8")
    bad += hybrid_errors(out[f"shared B={B}, flat tail"], flat_refs,
                         "shared flat tail")
    bad += hybrid_errors(out[f"shared B={B}, int8 tail"], int8_refs,
                         "shared int8 tail")
    print(f"  numpy hybrid references: {time.perf_counter() - t0:.1f} s",
          flush=True)
    report_check(bad, f"hybrid top-{K}, match counts and the match bitmap of "
                      f"{nq} queries on each of the {len(paths)} paths "
                      f"({len(frefs)} on the filtered one) equal the numpy "
                      f"reference outside near-ties")


# ---------------------------------------------------------------------------
# the pruned full-text tier (phase 12)
# ---------------------------------------------------------------------------

def pruned_batch(route, j, B, shared):
    """Batch j of a route: the checked first batch opens with the shared
    queries, every other batch is distinct."""
    from oramacore_tpu_torch.benches.pruned_bench import route_batch

    return route_batch(route, j, B, len(shared))


def pruned_checks(idx, slab_np, run, C, refs, mask, label, counts_exact):
    """One route's first batch: the nomination of the checked queries
    against the numpy copy, returned ids and scores against the reference
    scorer restricted to the candidates, counts; returns the top-10
    overlap with the exact top-10 of each checked query."""
    from oramacore_tpu_torch.benches import pruned_bench as pb
    from oramacore_tpu_torch.index.search_exec import PrunedPlanMixin

    (vals, ids, counts), plans, qs, cands, exact = run
    fm = None if mask is None else mask.astype(np.float32)
    n = pb.N_DOCS
    bad, overlap = [], []
    for b, ref in enumerate(refs):
        cand = cands[b]
        real = {int(d) for d in cand if d < n}
        if mask is not None and int(mask.sum()) <= C:      # cand_given
            if sorted(real) != np.nonzero(mask)[0].tolist():
                bad.append(f"query {b}: the candidates are not the filter")
        else:
            idf_row = PrunedPlanMixin._pruned_host_inputs(
                [plans[b]], [float(n)], None)[4][0]
            part = pb.nominate_numpy(slab_np, plans[b], idf_row, fm, exact)
            bad += [f"query {b}: nomination: {e}" for e in
                    pb.nomination_errors(cand, part, C, n)[:3]]
        inside = {d: s for d, s in ref.items() if d in real}
        exp_ids, exp_vals = reference_top(inside, K)
        bad += [f"query {b}: {e}" for e in
                topk_errors(ids[b], vals[b], exp_ids, exp_vals, ref)]
        top, _ = reference_top(ref, K)
        overlap.append(len(set(top) & {int(d) for d in ids[b][:K]}) / K)
    if counts_exact:
        for b, q in enumerate(qs):
            want = (len(refs[b]) if b < len(refs)
                    else pb.match_count(idx, q, mask))
            if int(counts[b]) != want:
                bad.append(f"query {b}: count {counts[b]} vs {want}")
    report_check(bad, f"{label}: candidates of {len(refs)} queries equal the "
                      f"numpy nomination outside near-ties, ids and scores "
                      f"equal the reference restricted to the candidates"
                      + (f", counts of {len(qs)} queries exact"
                         if counts_exact else ""))
    return overlap


def phase_pruned(device, card):
    """The pruned tier on the 10M-doc text configuration
    (benches/hybrid10m_bench.py's text side, oramacore_tpu_torch/benches/
    pruned_bench.py): each route through search_topk_pruned with the
    launch counts reset before and read after, checked against numpy, and
    both rescore kernels against their plain versions at the inputs of
    the first call of each route in KERNEL_CALLS."""
    import torch

    from oramacore_tpu_torch.benches import pruned_bench as pb
    from oramacore_tpu_torch.index import string_index as si
    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.index.search_exec import (
        HybridSearchTopK,
        host_bm25_reference,
    )
    from oramacore_tpu_torch.ops import pruned as pr

    t0 = time.perf_counter()
    idx = pb.build_index()
    n = pb.N_DOCS
    slab_np = idx.slab()
    print(f"  host index build {time.perf_counter() - t0:.1f} s: {n:,} docs, "
          f"{pb.N_POSTINGS:,} postings + {len(idx._slab_prefix_ranges)} side "
          f"blocks of {si.PREFIX_LEN:,} ({len(slab_np[0]):,} slab postings)",
          flush=True)
    # the hybrid executor is a PrunedPlanMixin; phase 13 reuses it and
    # its device slab
    ex = HybridSearchTopK(device)
    t0 = time.perf_counter()
    slab = ex._get_device_slab(idx)
    sync(device)
    print(f"  slab to the device: {time.perf_counter() - t0:.2f} s, "
          f"{sum(c.numel() * 4 for c in slab) / 2**30:.2f} GiB", flush=True)
    C = min(ex.PRUNED_CANDIDATES, ex.PRUNED_BS_C)
    rng = np.random.default_rng(12)
    half = rng.random(n) < 0.5
    small = np.zeros(n, bool)
    small[rng.choice(n, 1000, replace=False)] = True
    shared = pb.make_queries(N_PRUNED_CHECKED, seed=7)
    t0 = time.perf_counter()
    refs = {}
    for name, mask in (("all", None), ("half", half), ("small", small)):
        refs[name] = [host_bm25_reference(idx, q, ["body"], {}, float(n),
                                          doc_mask=mask) for q in shared]
    print(f"  numpy reference for {3 * len(shared)} queries: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # label, B, search kwargs, mask name, kernel, counts exact
    routes = [
        ("v4 B=64", 64, {}, None, "rescore_bsearch", False),
        ("v4 B=256 (4 chunks)", 256, {}, None, "rescore_bsearch", False),
        ("v4 B=1", 1, {}, None, "rescore_bsearch", False),
        ("v3 50% filter B=64", 64, {}, "half", "rescore_worklist", False),
        ("v3 exact B=8", 8, dict(exact=True), None, "rescore_worklist", False),
        ("1,000-doc filter B=8 (cand_given)", 8, {}, "small",
         "rescore_worklist", True),
        ("exact_counts B=8", 8, dict(exact_counts=True), None,
         "rescore_bsearch", True),
        ("exact_counts B=64 (sliced by 8)", 64, dict(exact_counts=True), None,
         "rescore_bsearch", True),
    ]
    masks = {"half": half, "small": small}
    total = {}
    kernel_inputs = {}
    for ri, (label, B, kw, mname, kernel, counts_exact) in enumerate(routes):
        mask = masks.get(mname)
        skw = dict(kw)
        if mask is not None:
            skw.update(mask=mask, mask_key=("pruned", mname))

        def search(qs, skw=skw):
            plans = [plan_query(idx, q, ["body"], {}, with_prefix=True)
                     for q in qs]
            t = time.perf_counter()
            res = ex.search_topk_pruned(idx, plans, [float(n)] * len(qs), n,
                                        K, **skw)
            return res, plans, time.perf_counter() - t

        def drive(ri=ri, B=B, kernel=kernel, search=search):
            qs = pruned_batch(ri, 0, B, shared)
            (res, plans, first_s), calls = pb.capture(
                pr, kernel, lambda: search(qs))
            steady = [search(pruned_batch(ri, j, B, shared))[2]
                      for j in range(1, 1 + PRUNED_STEADY)]
            return res, plans, qs, calls, first_s, steady

        torch.cuda.reset_peak_memory_stats()
        (res, plans, qs, calls, first_s, steady), launches = counted(
            label, drive)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c
        check(launches[kernel] > 0, f"{label}: launched {kernel} "
                                    f"({launches[kernel]} launches)")
        print(f"  {label}: first {first_s * 1e3:.1f} ms; steady over "
              f"{len(steady)} distinct batches mean "
              f"{np.mean(steady) * 1e3:.1f} ms (min {min(steady) * 1e3:.1f}, "
              f"max {max(steady) * 1e3:.1f}), {B / np.mean(steady):.1f} QPS; "
              f"peak device memory {peak:.2f} GiB [{card}]", flush=True)
        profile_once(label, lambda: search(
            pruned_batch(ri, 1 + PRUNED_STEADY, B, shared)), card)
        cpos = 9 if kernel == "rescore_bsearch" else 6
        cands = calls[0][0][cpos].cpu().numpy()
        if label in KERNEL_CALLS:
            kernel_inputs[label] = (kernel, calls[0])
        run = (res, plans, qs, cands, kw.get("exact", False))
        ref = refs[mname or "all"][:B]
        overlap = pruned_checks(idx, slab_np, run, C, ref, mask, label,
                                counts_exact)
        print(f"  {label}: top-{K} overlap with the exact top-{K} "
              f"(information): {', '.join(f'{o:.1f}' for o in overlap)}",
              flush=True)
    timings = {}
    for label, timed in KERNEL_CALLS.items():
        name, (args, kw) = kernel_inputs[label]
        try:
            r = pb.check_kernel(name, args, kw, timed=timed)
        except AssertionError as e:
            raise SmokeFailure(f"{label}: {e}") from e
        check(True, f"{name}: equal to its plain version at the {label} "
                    f"call's inputs (matched exact, scores within rtol 1e-5; "
                    f"max abs err {r['max_abs_err']:.3g})")
        if not timed:
            continue
        timings[name] = r
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.1f} MB), {100 * r['bound_ms'] / r['ms']:.1f}"
              f"% of bound; this design's sector-level bytes "
              f"{r['sector_bytes'] / 1e6:.1f} MB; library call: none "
              f"[{card}]", flush=True)
    ctx = dict(idx=idx, ex=ex, slab_np=slab_np, refs=refs, masks=masks,
               shared=shared, C=C)
    return timings, total, ctx


# ---------------------------------------------------------------------------
# pruned facets and the pruned int8 hybrid (phase 13)
# ---------------------------------------------------------------------------

def facet_reference(slab_np, plan, specs, n, thr=0.0, alive=None,
                    exact=False, vec_docs=None, text=True):
    """Facet counts in numpy: the docs holding at least max(thr, 1)
    distinct tokens of the plan's main ranges (tf > 0), inside the alive
    mask, united with vec_docs; per bucket the distinct matched docs.
    Returns ([counts per spec], matched count)."""
    p_doc, p_tf, p_etf = slab_np[:3]
    tf_src = p_etf if exact else p_tf
    parts = []
    for t in range(plan.starts.shape[0] if text else 0):
        rs = [p_doc[s:s + ln][tf_src[s:s + ln] > 0]
              for s, ln in zip(plan.starts[t].tolist(), plan.lens[t].tolist())
              if ln > 0]
        if rs:
            parts.append(np.unique(np.concatenate(rs)))
    hit = np.zeros(n, bool)
    if parts:
        docs, cnt = np.unique(np.concatenate(parts), return_counts=True)
        hit[docs[cnt >= max(thr, 1.0)]] = True
    if alive is not None:
        hit &= alive
    if vec_docs is not None:
        hit[vec_docs] = True
    out = []
    for kind, *rest in specs:
        if kind == "cat":
            ids, G = rest[0], rest[1]
            v = ids[hit]
            out.append(np.bincount(v[(v >= 0) & (v < G)], minlength=G)[:G])
        elif kind == "num":
            v = rest[0][hit]
            out.append(np.array([((v >= lo) & (v <= hi)).sum()
                                 for lo, hi in rest[1]]))
        else:
            pd, pv = rest[0], rest[1]
            keep = hit[pd]
            d, v = pd[keep], pv[keep]
            if kind == "mcat":
                G = rest[2]
                out.append(np.bincount(v[(v >= 0) & (v < G)], minlength=G)[:G])
            else:
                out.append(np.array([len(np.unique(d[(v >= lo) & (v <= hi)]))
                                     for lo, hi in rest[2]]))
    return out, int(hit.sum())


class DeviceRows:
    """Rows of a device matrix fetched on demand, for numpy_probe."""

    def __init__(self, mat):
        self.mat = mat

    def __len__(self):
        return self.mat.shape[0]

    def __getitem__(self, rows):
        import torch

        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.mat.device)
        return self.mat[idx].cpu().numpy()


def layout_numpy(lay):
    """What numpy_probe reads of an int8 layout: the matrix fetched on
    demand, the rest on the host."""
    return dict(q=DeviceRows(lay.mat), scales=lay.scales.cpu().numpy(),
                docs=lay.row_doc.cpu().numpy(),
                cen_b16=bf16_round(lay.unit_cen.cpu().numpy()),
                unit_starts=lay.unit_starts.cpu().numpy(), window=lay.window)


def port_probe(lay, q, V, fmask=None):
    """The port's own probe of one query: its top-V (vals, rows) as the
    facet path takes them (ivf_int8_topk_masked under the mask)."""
    import torch

    from oramacore_tpu_torch.ops.vector import ivf_int8_topk_masked

    mat, scales, row_doc, cen, starts, window, nprobe = lay.int8_device_rows()
    qd = torch.from_numpy(np.asarray(q, np.float32).reshape(1, -1)).to(
        mat.device)
    mask2d = None if fmask is None else (fmask > 0)[None, :]
    vals, rows = ivf_int8_topk_masked(
        qd, mat, scales, row_doc, cen, starts, mask2d, k=V, nprobe=nprobe,
        window=window, has_mask=fmask is not None)
    return vals[0].cpu().numpy(), rows[0].cpu().numpy()


def probe_errors(lay_np, nprobe, q, V, vals, rows, doc_mask=None):
    """The port's probe rows against numpy_probe of the same windows:
    equal outside near-ties at the V-th value (VEC_TIE)."""
    nv, nr, kth, tie, _ = numpy_probe(q, lay_np, nprobe, V, doc_mask)
    if tie:
        return []   # the nprobe-th unit is near-tied: another window set
    got = {int(r) for r, v in zip(rows, vals) if r >= 0 and v > NEG_INF / 2}
    sure = {int(r) for r, v in zip(nr, nv) if r >= 0 and v > kth + VEC_TIE}
    maybe = {int(r) for r, v in zip(nr, nv) if r >= 0 and v >= kth - VEC_TIE}
    errs = [f"row {r} missing" for r in sorted(sure - got)[:3]]
    errs += [f"row {r} not in the numpy top-{V}"
             for r in sorted(got - maybe)[:3]]
    if not np.allclose(np.sort(vals)[-8:], np.sort(nv)[-8:], rtol=1e-5,
                       atol=1e-6):
        errs.append("top probe values differ")
    return errs


def spread(xs, nd):
    """mean (p10, p50, p90, min, max) of xs, to nd decimals."""
    p10, p50, p90 = np.percentile(xs, [10, 50, 90])
    return (f"mean {np.mean(xs):.{nd}f} (p10 {p10:.{nd}f}, p50 {p50:.{nd}f}, "
            f"p90 {p90:.{nd}f}, min {min(xs):.{nd}f}, max {max(xs):.{nd}f})")


def timed_ms(fn):
    t = time.perf_counter()
    res = fn()
    return res, (time.perf_counter() - t) * 1e3


def phase_facets(ctx, lay, lay_np, qpool, device, card):
    """facet_counts_pruned with every spec kind on the bench's 3-term
    queries and the query of the three most frequent terms, in seven
    cases; exact counts against numpy, facet_match_count, the port's probe
    rows against numpy. Returns (the largest query's phase-B calls,
    recorded; the launch counts of all cases)."""
    import torch

    from oramacore_tpu_torch.benches import pruned_bench as pb
    from oramacore_tpu_torch.benches.facet_bench import (
        facet_columns,
        record_facet_calls,
    )
    from oramacore_tpu_torch.index import search_exec as se
    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.index.search_exec import _ivf_candidates

    idx, ex, slab_np = ctx["idx"], ctx["ex"], ctx["slab_np"]
    n = pb.N_DOCS
    t0 = time.perf_counter()
    columns = facet_columns(n)
    names = list(columns)
    specs = [columns[k][0] for k in names]
    print(f"  facet columns over {n:,} docs (pair tables of "
          f"{len(specs[2][1]):,} and {len(specs[3][1]):,} rows, M = "
          f"{specs[2][4]} and {specs[3][4]}): {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    alive = np.random.default_rng(14).random(n) >= TOMBSTONES
    V = _ivf_candidates(None, n)
    queries = [["t0", "t1", "t2"]] + pb.make_queries(FACET_QUERIES, seed=31)
    cases = [
        ("plain", {}),
        ("thresholded, thr=2", dict(thr=2.0)),
        ("thresholded, thr=3", dict(thr=3.0)),
        ("exact tf", dict(exact=True)),
        (f"{TOMBSTONES:.0%} tombstones", dict(mask=alive,
                                              mask_key=("alive", 1))),
        ("hybrid", dict(vec=True)),
        ("vec_only", dict(vec=True, vec_only=True)),
    ]
    launches_all = {}
    bad = []
    for ci, (label, opts) in enumerate(cases):
        times = []

        def run_case(ci=ci, opts=opts):
            out = []
            for qi, q in enumerate(queries):
                plan = plan_query(idx, q, ["body"], {}, with_prefix=True)
                kw = dict(opts)
                qv = qpool[(7 * ci + qi) % len(qpool)]
                if kw.pop("vec", False):
                    kw["vec"] = (lay, qv[None, :], SIMILARITY_10M, None)
                t = []
                counts = []
                for name, (spec, key) in columns.items():
                    c, ms = timed_ms(lambda: ex.facet_counts_pruned(
                        idx, plan, n, spec, key, **kw))
                    counts.append(c)
                    t.append(ms)
                mc, ms = timed_ms(lambda: ex.facet_match_count(plan))
                # phase B of the first field again, from the cached reps
                _, again = timed_ms(lambda: ex.facet_counts_pruned(
                    idx, plan, n, *columns[names[0]], **kw))
                times.append((t, again))
                out.append((plan, qv, kw, counts, mc))
            return out

        torch.cuda.reset_peak_memory_stats()
        runs, launches = counted(f"facets, {label}", run_case)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k2, v in launches.items():
            launches_all[k2] = launches_all.get(k2, 0) + v
        check(launches["facet_hist"] > 0 and launches["facet_hist_multi"] > 0,
              f"facets, {label}: launched facet_hist "
              f"({launches['facet_hist']}) and facet_hist_multi "
              f"({launches['facet_hist_multi']})")
        whole = [sum(t) for t, _ in times]
        phase_a = [t[0] - again for t, again in times]
        phase_b = [np.mean(t[1:] + [again]) for t, again in times]
        print(f"  facets, {label}: first query (top-3 terms, 4 fields) "
              f"{whole[0]:.1f} ms, phase A {phase_a[0]:.1f} ms, phase B "
              f"{phase_b[0]:.3f} ms a field; {len(whole) - 1} distinct 3-term "
              f"queries: {spread(whole[1:], 2)} ms a query "
              f"({1e3 / np.mean(whole[1:]):.1f} QPS), phase A "
              f"{spread(phase_a[1:], 2)} ms, phase B {spread(phase_b[1:], 3)} "
              f"ms a field; peak device memory {peak:.2f} GiB [{card}]",
              flush=True)
        plan = plan_query(idx, queries[1], ["body"], {}, with_prefix=True)
        kw = dict(runs[1][2])
        profile_once(f"facets, {label}, one query, 4 fields", lambda: [
            ex.facet_counts_pruned(idx, plan, n, *columns[k], **kw)
            for k in names], card)
        for plan, qv, kw, counts, mc in runs[:N_FACET_CHECKED]:
            vec_docs = None
            fmask = None
            if "mask" in kw:
                fmask = ex._get_device_fmask(kw["mask"], kw["mask_key"],
                                             se.round_up_pow2(n, 128))
            if "vec" in kw:
                vals, rows = port_probe(lay, qv, V, fmask)
                bad += [f"{label}: probe: {e}" for e in probe_errors(
                    lay_np, lay.nprobe, qv, V, vals, rows,
                    kw.get("mask"))]
                ok = (rows >= 0) & (vals >= SIMILARITY_10M) & (vals > 0)
                vec_docs = lay_np["docs"][rows[ok]]
            ref, n_ref = facet_reference(
                slab_np, plan, specs, n, thr=kw.get("thr", 0.0),
                alive=kw.get("mask"), exact=kw.get("exact", False),
                vec_docs=vec_docs, text=not kw.get("vec_only", False))
            for name, c, r in zip(names, counts, ref):
                if c.dtype != np.int32 or not np.array_equal(c, r):
                    bad.append(f"{label}, {name}: {c.tolist()[:8]} vs "
                               f"{r.tolist()[:8]}")
            if mc != n_ref:
                bad.append(f"{label}: facet_match_count {mc} vs {n_ref}")
    # phase B's inputs at the top-3 query, recorded after every timed case:
    # the recording clones every tensor argument (0.5 GiB)
    plan = plan_query(idx, queries[0], ["body"], {}, with_prefix=True)
    _, recorded = record_facet_calls(lambda: [
        ex.facet_counts_pruned(idx, plan, n, *columns[k]) for k in names])
    report_check(bad, f"facet counts of every field and facet_match_count "
                      f"equal numpy exactly on {N_FACET_CHECKED} queries of "
                      f"each of the {len(cases)} cases; the port's probe rows "
                      f"equal a numpy probe scan outside near-ties")
    return recorded, launches_all


def facet_kernel_checks(recorded, card):
    """Both phase-B kernels against their plain versions at the largest
    query's reps for all four specs, timed as CUDA-graph replays (L2 warm,
    and cold after a 256 MiB write) beside the bound and, for the
    string column, the library composition."""
    import torch

    from oramacore_tpu_torch.benches import bound_ms, time_cuda, time_graph
    from oramacore_tpu_torch.benches import pruned_bench as pb
    from oramacore_tpu_torch.benches.facet_bench import (
        design_sectors,
        facet_bound,
    )
    from oramacore_tpu_torch.ops import facet_hist as fh

    flush = torch.empty(64 << 20, device=recorded["cat"][0][0].device)
    out = {}
    for kind in ("cat", "num", "mcat", "mnum"):
        args, kw = recorded[kind]
        name = "facet_hist" if kind in ("cat", "num") else "facet_hist_multi"
        kernel, plain = getattr(fh, name), getattr(fh, f"{name}_plain")
        before = fh.LAUNCHES[name]
        got = kernel(*args, **kw)
        exp = plain(*args, **kw)
        torch.cuda.synchronize()
        if fh.LAUNCHES[name] != before + 1:
            raise SmokeFailure(f"{name}: the wrapper did not launch its kernel")
        err = float((got - exp).abs().max())
        check(torch.equal(got, exp),
              f"{name} [{kind}]: equal to its plain version at the largest "
              f"query's reps (N={args[0].shape[0]:,}, "
              f"{int((args[1] != 0).sum()):,} kept; max abs err {err:.3g})")
        ms = time_graph(lambda: kernel(*args, **kw), 20)
        cold = pb.time_cold(lambda: kernel(*args, **kw), flush, 20)
        plain_ms = time_cuda(lambda: plain(*args, **kw), 3)
        by_word, by_sector = facet_bound(kind, args, kw)
        bound, by = bound_ms(by_word, 0)
        lib_ms, lib = None, "none"
        if kind == "cat":
            docs, rep, bucket = args[0], args[1], args[2]
            top = pb.N_DOCS - 1   # sentinel docs (rep 0) read a real id
            lib = (f"torch.bincount(bucket[docs.clamp(max={top})], "
                   f"weights=rep, minlength=G)")
            lib_ms = time_cuda(lambda: torch.bincount(
                bucket[docs.clamp(max=top)], weights=rep, minlength=kw["G"]),
                10)
        mine = design_sectors(kind, args, kw)
        print(f"  {name} [{kind}, G={kw['G']}]: kernel {ms:.4f} ms (L2 "
              f"warm), {cold:.4f} ms (L2 cold); plain {plain_ms:.4f} ms; "
              f"bound {bound * 1e3:.2f} us ({by_word / 1e6:.1f} MB by word; "
              f"{bound_ms(by_sector, 0)[0] * 1e3:.2f} us, "
              f"{by_sector / 1e6:.1f} MB by sector for a search per rep, "
              f"{bound_ms(mine, 0)[0] * 1e3:.2f} us, {mine / 1e6:.1f} MB in "
              f"this one); library call {lib}"
              + (f" {lib_ms:.4f} ms" if lib_ms is not None else "")
              + f" [{card}]", flush=True)
        share(f"{name} [{kind}]", ms, bound, by, card)
        r = dict(ms=ms, cold_ms=cold, plain_ms=plain_ms, bound_ms=bound,
                 bound_by=by, max_abs_err=err, library_ms=lib_ms)
        if kind in ("cat", "mcat"):     # the kernels line: string columns
            out[name] = r
        else:
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    return out


def hybrid_pruned_errors(ctx, lay, lay_np, run, route, mask, V):
    """One route's first batch: the candidates against the numpy
    nomination united with the numpy probe's top-V docs (outside near-ties
    of either), then the fused top-10 against numpy over the port's own
    candidates: BM25 from the reference scorer, the int8 row times the
    bf16 query, min-max fusion; counts exact for cand_given."""
    from oramacore_tpu_torch.benches import pruned_bench as pb
    from oramacore_tpu_torch.index.search_exec import PrunedPlanMixin

    (vals, ids, counts), plans, cands, qv = run
    n = pb.N_DOCS
    refs = ctx["refs"][route][:N_HYBRID_PRUNED_CHECKED]
    fm = None if mask is None else mask.astype(np.float32)
    cand_given = mask is not None and int(mask.sum()) <= ctx["C"]
    bad = []
    for b, ref in enumerate(refs):
        real = np.array(sorted({int(d) for d in cands[b] if d < n}), np.int64)
        # the route probes unfiltered and drops hits outside the filter
        pvals, prow, pkth, tie, _ = numpy_probe(qv[b], lay_np, lay.nprobe, V)
        pdocs = lay_np["docs"][prow[(prow >= 0) & (pvals > NEG_INF / 2)]]
        if mask is not None:
            pdocs = pdocs[mask[pdocs]]
        if cand_given:
            if real.tolist() != np.nonzero(mask)[0].tolist():
                bad.append(f"query {b}: the candidates are not the filter")
        else:
            idf_row = PrunedPlanMixin._pruned_host_inputs(
                [plans[b]], [float(n)], None)[4][0]
            part = pb.nominate_numpy(ctx["slab_np"], plans[b], idf_row, fm)
            if tie:     # a near-tied window set: other windows' hits
                extra, edge = (), set(real.tolist())
            else:       # hits near the V-th probe value may go either way
                extra = pdocs.tolist()
                edge = {int(lay_np["docs"][r]) for r, v in zip(prow, pvals)
                        if r >= 0 and abs(v - pkth) <= VEC_TIE}
            bad += [f"query {b}: {e}" for e in pb.nomination_errors(
                real, part, ctx["C"], n, extra=extra, edge=edge)[:3]]
        # numpy fusion over the port's own candidates
        rows = lay.pos[real].cpu().numpy() if len(real) else np.zeros(0, int)
        q8 = DeviceRows(lay.mat)[rows].astype(np.float32)
        vec = (q8 @ bf16_round(qv[b])) * lay_np["scales"][rows]
        near = np.abs(vec - SIMILARITY_10M) <= VEC_TIE
        vec = np.where(vec >= SIMILARITY_10M, vec, 0.0)
        bm = np.array([ref.get(int(d), 0.0) for d in real])
        hi = max(float(bm.max(initial=0.0)), float(vec.max(initial=0.0)))
        fused = (bm + vec) / (hi if hi > 0 else 1.0)
        present = (bm > 0) | (vec > 0)
        score_of = {int(d): float(f) for d, f, p in zip(real, fused, present)
                    if p}
        order = np.argsort(-np.where(present, fused, -np.inf), kind="stable")
        top = [i for i in order[:K] if present[i]]
        errs = topk_errors(ids[b], vals[b], real[top], fused[top], score_of)
        n_sure = int((present & ~near).sum())
        if cand_given and not n_sure <= counts[b] <= int(present.sum()) + \
                int(near.sum()):
            errs.append(f"count {counts[b]} vs {n_sure} (+{int(near.sum())} "
                        f"near the similarity floor)")
        elif not cand_given and counts[b] < n_sure:
            errs.append(f"count {counts[b]} below the {n_sure} present "
                        f"candidates")
        bad += [f"query {b}: {e}" for e in errs]
    return bad


def phase_hybrid_pruned(ctx, lay, lay_np, qpool, device, card):
    """search_topk_hybrid_int8_pruned on five routes, each with launch
    counts reset before and read after, first and steady latency, QPS,
    peak memory and one profile with the gather-dot's share; the first
    batch's checked queries against numpy."""
    import torch

    from oramacore_tpu_torch.benches import pruned_bench as pb
    from oramacore_tpu_torch.benches import time_graph
    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.index.search_exec import (
        _ivf_candidates,
        round_up_pow2,
    )
    from oramacore_tpu_torch.ops import pruned as pr

    idx, ex = ctx["idx"], ctx["ex"]
    n = pb.N_DOCS
    d2r = lay.int8_doc2row(round_up_pow2(n, 128))
    rows = lay.int8_device_rows()
    V = _ivf_candidates(None, n)
    shared = ctx["shared"]
    # label, B, search kwargs, mask name, kernel
    routes = [
        ("v4 B=64", 64, {}, None, "rescore_bsearch"),
        ("v4 B=256 (4 chunks)", 256, {}, None, "rescore_bsearch"),
        ("v3 50% filter B=64", 64, {}, "half", "rescore_worklist"),
        ("1,000-doc filter B=8 (cand_given)", 8, {}, "small",
         "rescore_worklist"),
        ("v3 exact B=8", 8, dict(exact=True), None, "rescore_worklist"),
    ]
    bad = []
    for ri, (label, B, kw, mname, kernel) in enumerate(routes):
        mask = ctx["masks"].get(mname)
        skw = dict(kw)
        if mask is not None:
            skw.update(mask=mask, mask_key=("pruned", mname))

        def search(j, skw=skw, B=B, ri=ri):
            qs = pruned_batch(20 + ri, j, B, shared)
            qv = qpool[[(j * B + i) % len(qpool) for i in range(B)]]
            plans = [plan_query(idx, q, ["body"], {}, with_prefix=True)
                     for q in qs]
            res, ms = timed_ms(lambda: ex.search_topk_hybrid_int8_pruned(
                idx, plans, [float(n)] * B, n, K, rows, d2r, qv,
                [SIMILARITY_10M] * B, **skw))
            return res, plans, qv, ms

        def drive(kernel=kernel, search=search):
            (first, plans, qv, first_ms), calls = pb.capture(
                pr, kernel, lambda: search(0))
            steady = [search(j)[3] for j in range(1, 1 + PRUNED_STEADY)]
            return first, plans, qv, calls, first_ms, steady

        torch.cuda.reset_peak_memory_stats()
        (first, plans, qv, calls, first_ms, steady), launches = counted(
            f"pruned hybrid, {label}", drive)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(launches[kernel] > 0, f"pruned hybrid, {label}: launched "
                                    f"{kernel} ({launches[kernel]} launches)")
        print(f"  pruned hybrid, {label}: first {first_ms:.1f} ms; steady "
              f"over {len(steady)} distinct batches mean "
              f"{np.mean(steady):.1f} ms (min {min(steady):.1f}, max "
              f"{max(steady):.1f}), {1e3 * B / np.mean(steady):.1f} QPS; peak "
              f"device memory {peak:.2f} GiB [{card}]", flush=True)
        # the gather-dot's calls of the profiled search, kept by
        # reference (the layout is 7.5 GiB) and timed after it as CUDA
        # graph replays: its device time, without the host's launches
        real_cv = pr._candidate_vec
        cv_calls = []

        def recorded_cv(*a, **k):
            cv_calls.append((a, k))
            return real_cv(*a, **k)

        pr._candidate_vec = recorded_cv
        try:
            dev_ms = profile_once(f"pruned hybrid, {label}",
                                  lambda: search(1 + PRUNED_STEADY), card)
        finally:
            pr._candidate_vec = real_cv
        g_ms = sum(time_graph(lambda a=a, k=k: real_cv(*a, **k), 10)
                   for a, k in cv_calls)
        del cv_calls
        print(f"  pruned hybrid, {label}: the int8 gather-dot "
              f"(_candidate_vec, CUDA-graph replays of its calls) "
              f"{g_ms:.3f} ms of {dev_ms:.3f} device ms "
              f"({100 * g_ms / max(dev_ms, 1e-9):.1f}%) [{card}]", flush=True)
        cpos = 9 if kernel == "rescore_bsearch" else 6
        cands = calls[0][0][cpos].cpu().numpy()
        bad += [f"{label}: {e}" for e in hybrid_pruned_errors(
            ctx, lay, lay_np, (first, plans, cands, qv),
            mname or "all", mask, V)]
    report_check(bad, f"pruned hybrid: candidates of {N_HYBRID_PRUNED_CHECKED} "
                      f"queries on each of {len(routes)} routes equal the "
                      f"numpy nomination united with the numpy probe outside "
                      f"near-ties, top-{K} ids and scores equal numpy fusion "
                      f"over them, counts exact where the filter is the "
                      f"candidate set")


def phase_facets_hybrid(ctx, device, card):
    """Phase 13: the int8 IVF layout of the 10M configuration, the pruned
    facets, both facet kernels against their plain versions, the pruned
    int8 hybrid. Returns (kernel timings, the facet path's launches)."""
    import torch

    from oramacore_tpu_torch.benches import hybrid10m
    from oramacore_tpu_torch.benches import pruned_bench as pb

    n = pb.N_DOCS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lay = hybrid10m.build_layout(n, device)
    sync(device)
    print(f"  int8 IVF layout built on the card in "
          f"{time.perf_counter() - t0:.1f} s: {lay.mat.shape[0]:,} x "
          f"{lay.mat.shape[1]} int8 ({lay.mat.numel() / 2**30:.2f} GiB), "
          f"{lay.unit_starts.shape[0]:,} probe units of window {lay.window}, "
          f"nprobe {lay.nprobe}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    lay_np = layout_numpy(lay)
    qpool = hybrid10m.query_vectors(HYBRID_POOL, device)
    recorded, launches = phase_facets(ctx, lay, lay_np, qpool, device, card)
    timings = facet_kernel_checks(recorded, card)
    del recorded
    phase_hybrid_pruned(ctx, lay, lay_np, qpool, device, card)
    slab = ctx["ex"]._get_device_slab(ctx["idx"])
    slab_gib = sum(c.numel() * c.element_size() for c in slab) / 2**30
    # each path above printed its own peak
    print(f"  resident: slab {slab_gib:.2f} GiB, int8 layout "
          f"{lay.mat.numel() / 2**30:.2f} GiB; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    return timings, launches


# ---------------------------------------------------------------------------
# the text encoder: passage text -> vectors -> search (phase 14)
# ---------------------------------------------------------------------------

def sdpa_ms(qkv, mask, H, reps):
    """The library yardstick: one F.scaled_dot_product_attention call on
    the same inputs (`attention_bench.sdpa`: Q, K, V as (B, H, L, hd)
    views of qkv, an additive f32 mask of 0 / -1e9), CUDA-graph replays;
    and its output as the kernel's (B, L, D), for its error."""
    from oramacore_tpu_torch.benches import time_graph
    from oramacore_tpu_torch.benches.attention_bench import sdpa

    B, L, D3 = qkv.shape
    ms = time_graph(lambda: sdpa(qkv, mask, H), reps)
    return ms, sdpa(qkv, mask, H).transpose(1, 2).reshape(B, L, D3 // 3)


def attention_checks(device, card):
    """encoder_attention against its plain version in f64 at every case of
    benches/encoder_bench.py (the shapes phase 14's encoder gives it,
    BGEBase's and BGESmall's geometry, padded batch rows, L=1), each timed
    as CUDA-graph replays, warm and L2-cold, beside its bound (bytes
    against FLOPs at the 3xTF32 tensor-core rate; the FFMA-rate bound in
    brackets), the plain version and scaled_dot_product_attention on the
    same inputs (its time and max abs error). The kernels line takes the
    first case, SemanticBase at B=1024, L=64."""
    import torch

    from oramacore_tpu_torch.benches import (
        H100_F32_OPS_PER_S,
        H100_TF32X3_OPS_PER_S,
        bound_ms,
        time_cuda,
        time_graph,
    )
    from oramacore_tpu_torch.benches.encoder_bench import (
        ATTENTION_CASES,
        attention_inputs,
        attention_reference,
    )
    from oramacore_tpu_torch.benches.pruned_bench import time_cold
    from oramacore_tpu_torch.ops import attention as at

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out, errs = {}, []
    for i, (label, case) in enumerate(ATTENTION_CASES.items()):
        B, L, H, hd = case["B"], case["L"], case["H"], case["hd"]
        qkv, mask = attention_inputs(case, 140 + i, device)
        got = at.encoder_attention(qkv, mask, H)
        ref = attention_reference(qkv, mask, H)
        sync(device)
        err = float((got.double() - ref).abs().max())
        errs.append(err)
        tiles = at.tiles_for(B, H, L, hd)
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got.double(), ref, rtol=ATTN_TOL, atol=ATTN_TOL),
            f"encoder_attention [{label}, {tiles.warps} warps a (b, h), key "
            f"tile {tiles.key_tile}, {tiles.grid} blocks]: within rtol/atol "
            f"{ATTN_TOL} of its plain version in f64 (max abs err {err:.3g})")
        n_bytes, n_ops = at.attention_work(B, L, H, hd)
        bound, by = bound_ms(n_bytes, n_ops, H100_TF32X3_OPS_PER_S)
        ffma, ffma_by = bound_ms(n_bytes, n_ops, H100_F32_OPS_PER_S)
        warm = time_graph(lambda: at.encoder_attention(qkv, mask, H), 20)
        cold = time_cold(lambda: at.encoder_attention(qkv, mask, H), flush,
                         10)
        plain_ms = time_cuda(lambda: at.encoder_attention_plain(qkv, mask, H),
                             5)
        lib_ms, lib_out = sdpa_ms(qkv, mask, H, 20)
        lib_err = float((lib_out.double() - ref).abs().max())
        print(f"  encoder_attention [{label}]: kernel {warm:.4f} ms warm, "
              f"{cold:.4f} ms L2-cold; plain {plain_ms:.4f} ms; library "
              f"scaled_dot_product_attention (additive f32 mask) "
              f"{lib_ms:.4f} ms (max abs err {lib_err:.3g}); bound "
              f"{bound:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, "
              f"{n_ops / 1e9:.2f} GFLOP at the 3xTF32 rate) [FFMA rate: "
              f"{ffma:.4f} ms, {ffma_by}] [{card}]", flush=True)
        share(f"encoder_attention [{label}], L2-cold", cold, bound, by, card)
        if i == 0:
            out["encoder_attention"] = dict(
                ms=cold, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)
    del flush
    out["encoder_attention"]["max_abs_err"] = max(errs)
    return out


def device_ms(fn):
    """(result, device ms) of one call between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def synonym_checks(encs):
    """tests/test_semantic_encoder.py's synonym (:46-56) and phrase
    (:59-88) checks on the card's vectors."""
    for name, enc in encs.items():
        v = dict(zip(ENC_SYNONYMS, enc.encode(ENC_SYNONYMS)))
        cos = {pair: float(v[pair[0]] @ v[pair[1]]) for pair in (
            ("car", "automobile"), ("doctor", "physician"), ("car", "doctor"),
            ("automobile", "storm"))}
        check(cos[("car", "automobile")] > 0.8
              and cos[("doctor", "physician")] > 0.8
              and cos[("car", "doctor")] < 0.6
              and cos[("automobile", "storm")] < 0.6,
              f"{name}: synonyms close, other words apart "
              f"({', '.join(f'{a}~{b} {c:.3f}' for (a, b), c in cos.items())})")
    margins = {}
    for name, enc in encs.items():
        S = np.array(enc.encode(ENC_PHRASE_Q)) @ np.array(
            enc.encode(ENC_PHRASE_T)).T
        n = len(ENC_PHRASE_Q)
        check(bool((np.argmax(S, axis=1) == np.arange(n)).all()),
              f"{name}: each phrase query ranks its paraphrase first")
        margins[name] = float(np.mean(np.diag(S) - np.max(
            S - np.eye(n) * 9.0, axis=1)))
    check(margins["SemanticBase"] > margins["SemanticMini"] + 0.02
          and margins["SemanticBase"] > 0.4,
          f"phrase margins: SemanticBase {margins['SemanticBase']:.4f}, "
          f"SemanticMini {margins['SemanticMini']:.4f}")


def embed(svc, texts, intent, model="SemanticBase"):
    """One calculate_embeddings call of short texts: (f32[n, D], host
    ms)."""
    out, ms = timed_ms(lambda: svc.calculate_embeddings(texts, intent, model))
    if any(len(v) != 1 for v in out):
        raise SmokeFailure("a query of 2-4 words gave other than one vector")
    return np.stack([v[0] for v in out]), ms


def ingest(svc, corpus, device, card):
    """The corpus through calculate_embeddings(..., PASSAGE, SemanticBase)
    in calls of ENC_CALL texts, as the write side batches; returns the
    vectors and the launch counts of the run."""
    import torch
    from oramacore_tpu_torch.embeddings import Intent

    def run():
        vecs = []
        for i in range(0, len(corpus), ENC_CALL):
            out = svc.calculate_embeddings(corpus[i:i + ENC_CALL],
                                           Intent.PASSAGE, "SemanticBase")
            if any(len(v) != 1 for v in out):
                raise SmokeFailure("a passage of <= 64 words gave several "
                                   "chunks")
            vecs += [v[0] for v in out]
        return np.stack(vecs)

    torch.cuda.reset_peak_memory_stats()
    (vecs, secs), launches = counted(
        "encoder ingest", lambda: timed_ms(run))
    secs /= 1e3
    n_calls = -(-len(corpus) // ENC_CALL)
    print(f"  ingest: {len(corpus):,} passages in {n_calls} calls of "
          f"{ENC_CALL}: {secs:.2f} s, {len(corpus) / secs:,.1f} passages/s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB [{card}]", flush=True)
    return vecs, launches


def phase_encoder(device, card):
    """Phase 14: encoder_attention against its plain version and timed;
    both bundled checkpoints loaded through safetensors_io and wordpiece;
    the golden vectors; the ingest corpus through the service, held
    against the plain f64 path; encode throughput; B=1 query latency;
    flat, IVF and hybrid search with embedded queries, held against
    numpy. Returns (timings, the ingest run's launch counts)."""
    import copy

    import torch

    from oramacore_tpu_torch.benches.encoder_bench import (
        passages,
        vocab_words,
    )
    from oramacore_tpu_torch.embeddings import EmbeddingsService, Intent
    from oramacore_tpu_torch.embeddings import encoder as em
    from oramacore_tpu_torch.index.plan import plan_query, query_tokens
    from oramacore_tpu_torch.index.search_exec import (
        HybridSearchTopK,
        host_bm25_reference,
    )
    from oramacore_tpu_torch.index.string_index import StringIndex
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )
    from oramacore_tpu_torch.ops import attention as at
    from oramacore_tpu_torch.types import Locale
    from oramacore_tpu_torch.utils.tokenizer import TextParser

    timings = attention_checks(device, card)

    encs = {}
    for name, sub in em.BUNDLED:
        t0 = time.perf_counter()
        enc = em.load_torch_encoder(os.path.join(ROOT, "models", sub), device)
        sync(device)
        check(enc is not None, f"{name}: models/{sub} loaded through "
                               f"safetensors_io and wordpiece in "
                               f"{time.perf_counter() - t0:.2f} s")
        print(f"  {name}: {len(enc.model.layers)} layers, width {enc.dim}, "
              f"{enc.n_heads} heads, max_len {enc.max_len}", flush=True)
        encs[name] = enc
    check(em.register_bundled_checkpoints(device) == [n for n, _ in em.BUNDLED],
          "SemanticBase and SemanticMini bound lazily to the service")
    base = encs["SemanticBase"]
    n_layers = len(base.model.layers)

    with np.load(os.path.join(ROOT, "oramacore_tpu_torch", "embeddings",
                              "golden_semantic.npz")) as f:
        gold = {k: f[k] for k in f.files}
    for name, enc in encs.items():
        got = np.stack(enc.encode(gold["texts"].tolist()))
        err = float(np.abs(got - gold[name]).max())
        check(got.shape == gold[name].shape and err <= ENC_ATOL,
              f"{name}: {len(got)} golden texts within {ENC_ATOL} of the JAX "
              f"encoder's vectors (max |d| {err:.3g})")
    synonym_checks(encs)

    words = vocab_words(os.path.join(ROOT, "models", "semantic-base",
                                     "vocab.txt"))
    t0 = time.perf_counter()
    corpus = passages(words, ENC_PASSAGES, seed=ENC_SEED)
    qtexts = passages(words, ENC_SEARCH_B * (1 + VEC_STEADY), seed=ENC_SEED + 1,
                      n_words=(2, 4))
    print(f"  corpus: {len(corpus):,} passages of 8-64 words ("
          f"{sum(len(p.split()) for p in corpus):,} words; zipf over the "
          f"{len(words)} words of the vocabulary, 5% made-up words), "
          f"{len(qtexts)} queries of 2-4 words: {time.perf_counter() - t0:.1f} "
          f"s of host time", flush=True)
    svc = EmbeddingsService()
    vecs, launches = ingest(svc, corpus, device, card)
    n_calls = -(-len(corpus) // ENC_CALL)
    check(launches["encoder_attention"] == n_calls * n_layers,
          f"the ingest path launched encoder_attention "
          f"{launches['encoder_attention']} times ({n_calls} calls x "
          f"{n_layers} layers)")
    norms = np.linalg.norm(vecs, axis=1)
    check(vecs.shape == (len(corpus), base.dim) and np.isfinite(vecs).all()
          and np.abs(norms - 1).max() < 1e-5,
          f"{vecs.shape[0]:,} finite unit vectors of width {base.dim}")
    batch = corpus[:ENC_CALL]
    (ids, mask), tok_ms = timed_ms(lambda: base.tokenize(batch))
    _, dev_ms = device_ms(lambda: base.forward(ids, mask))
    _, wall_ms = timed_ms(lambda: svc.calculate_embeddings(
        batch, Intent.PASSAGE, "SemanticBase"))
    print(f"  one ingest call of {ENC_CALL} ({ids.shape[0]} x {ids.shape[1]} "
          f"padded): tokenize {tok_ms:.2f} ms (host), forward {dev_ms:.3f} ms "
          f"between CUDA events (the card also waits there for the host's "
          f"launches), whole call {wall_ms:.2f} ms [{card}]", flush=True)
    profile_once(f"one ingest call of {ENC_CALL}",
                 lambda: svc.calculate_embeddings(batch, Intent.PASSAGE,
                                                  "SemanticBase"), card)
    ref_model = copy.deepcopy(base.model).double()
    ref_model.attention = at.encoder_attention_plain
    err = 0.0
    with torch.inference_mode():
        for i in range(0, ENC_CHECKED, ENC_CALL):
            part = corpus[i:min(i + ENC_CALL, ENC_CHECKED)]
            ids, mask = base.tokenize(part)
            ref = ref_model(torch.from_numpy(ids).to(device),
                            torch.from_numpy(mask).to(device))[:len(part)]
            err = max(err, float(np.abs(
                vecs[i:i + len(part)] - ref.cpu().numpy()).max()))
    check(err <= ENC_ATOL, f"{ENC_CHECKED:,} ingested vectors within {ENC_ATOL} "
                           f"of the plain path in f64 (max |d| {err:.3g})")
    del ref_model

    for name, enc in encs.items():
        texts = corpus[-ENC_THROUGHPUT_B:]
        enc.encode(texts)                      # one warm call
        ids, mask = enc.tokenize(texts)
        _, wall = timed_ms(lambda enc=enc: enc.encode(texts))
        _, dev = device_ms(lambda enc=enc: enc.forward(ids, mask))
        print(f"  {name} encode B={len(texts)} ({ids.shape[0]} x "
              f"{ids.shape[1]}): {wall:.2f} ms, {len(texts) / wall * 1e3:,.1f} "
              f"passages/s; forward {dev:.3f} ms between CUDA events "
              f"[{card}]", flush=True)
        profile_once(f"{name} encode B={len(texts)}",
                     lambda enc=enc: enc.encode(texts), card)

    tok, dev, wall = [], [], []
    for q in qtexts[:ENC_QUERIES]:
        (ids, mask), ms = timed_ms(lambda q=q: base.tokenize([q]))
        tok.append(ms)
        dev.append(device_ms(lambda: base.forward(ids, mask))[1])
        wall.append(timed_ms(lambda q=q: svc.calculate_embeddings(
            [q], Intent.QUERY, "SemanticBase"))[1])
    print(f"  B=1 query embedding over {ENC_QUERIES} queries, ms: tokenize "
          f"{spread(tok, 3)}; forward between CUDA events {spread(dev, 3)}; "
          f"calculate_embeddings {spread(wall, 3)} [{card}]", flush=True)
    _, qlaunch = counted("B=1 query embedding", lambda: svc.calculate_embeddings(
        [qtexts[0]], Intent.QUERY, "SemanticBase"))
    check(qlaunch["encoder_attention"] == n_layers,
          f"a B=1 query embedding launched encoder_attention {n_layers} times")
    profile_once("B=1 query embedding", lambda: svc.calculate_embeddings(
        [qtexts[1]], Intent.QUERY, "SemanticBase"), card)

    # search with embedded queries
    t0 = time.perf_counter()
    vidx = VectorIndex(VectorIndexConfig(dim=base.dim), device)
    for d, v in enumerate(vecs):
        vidx.insert(d, [v])
    vidx.commit()
    print(f"  {len(vecs):,} vectors inserted and committed: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    qb, embed_ms = [], []
    for j in range(1 + VEC_STEADY):
        q, ms = embed(svc, qtexts[j * ENC_SEARCH_B:(j + 1) * ENC_SEARCH_B],
                      Intent.QUERY)
        qb.append(q)
        embed_ms.append(ms)
    sims = [-1.0] * ENC_SEARCH_B
    flat_ref = phase_flat(vidx, bf16_round(vecs), qb, device, card)
    flat_ms = timed_ms(lambda: vidx.search_many(qb[1], K, sims))[1]
    one = qb[1][:ENC_SEARCH_B // 4]
    flat_one = np.median([timed_ms(lambda q=q: vidx.search([q], K, -1.0))[1]
                          for q in one])
    flat_rows = vidx.flat_device_rows()
    phase_ivf(vidx, vecs, qb, flat_ref, device, card,
              recall_note="embedded passages")
    ivf_ms = timed_ms(lambda: vidx.search_many(qb[1], K, sims))[1]
    ivf_one = np.median([timed_ms(lambda q=q: vidx.search([q], K, -1.0))[1]
                         for q in one])

    t0 = time.perf_counter()
    parser = TextParser(Locale.EN)
    idx = StringIndex()
    for d, p in enumerate(corpus):
        idx.index_text_packed(d, "body", *parser.tokenize_and_stem_packed(p))
    idx.commit()
    n = len(corpus)
    print(f"  StringIndex of the same passages (TextParser's packed tokens, "
          f"native live accumulator): {time.perf_counter() - t0:.1f} s of "
          f"host time", flush=True)
    htexts = qtexts[:HYBRID_BATCH]
    qv, hembed_ms = embed(svc, htexts, Intent.QUERY)
    toks = [query_tokens(parser, t, False) for t in htexts]
    plans = [plan_query(idx, t, ["body"], {}) for t in toks]
    ex = HybridSearchTopK(device)
    nd = [float(n)] * HYBRID_BATCH
    hsims = [ENC_HYBRID_SIM] * HYBRID_BATCH
    runs, hl = counted("encoder hybrid", lambda: [timed_ms(
        lambda: ex.search_topk_hybrid(idx, plans, nd, n, K, flat_rows, qv,
                                      hsims)) for _ in range(3)])
    check(hl["score_ranges_accumulate"] > 0,
          "the hybrid path launched score_ranges_accumulate")
    vb16 = bf16_round(vecs)
    sims_ref = vb16 @ bf16_round(qv).T
    refs = []
    for b, t in enumerate(toks):
        bm25 = dense_scores(host_bm25_reference(idx, t, ["body"], {},
                                                float(n)), n)
        s = sims_ref[:, b]
        vec = np.where(s >= ENC_HYBRID_SIM, s, 0.0)
        maybe = set(np.nonzero(np.abs(s - ENC_HYBRID_SIM) <= VEC_TIE)[0].tolist())
        refs.append(fused_reference(bm25, vec, maybe))
    report_check(hybrid_errors(runs[0][0], refs, "encoder hybrid"),
                 f"hybrid top-{K} and match counts of {HYBRID_BATCH} embedded "
                 f"queries equal the numpy fusion of the reference scorer and "
                 f"bf16 products ({int(sum((sims_ref >= ENC_HYBRID_SIM).sum(0)))} "
                 f"vector hits at similarity {ENC_HYBRID_SIM})")
    hyb_ms = runs[-1][1]
    print(f"  per query, embed ms beside search ms [{card}]:\n"
          f"    flat B={ENC_SEARCH_B}: embed {embed_ms[1] / ENC_SEARCH_B:.3f} "
          f"(a B={ENC_SEARCH_B} call), search_many {flat_ms / ENC_SEARCH_B:.3f}\n"
          f"    IVF B={ENC_SEARCH_B}: embed {embed_ms[1] / ENC_SEARCH_B:.3f}, "
          f"search_many {ivf_ms / ENC_SEARCH_B:.3f}\n"
          f"    hybrid B={HYBRID_BATCH}: embed {hembed_ms / HYBRID_BATCH:.3f}, "
          f"search_topk_hybrid {hyb_ms / HYBRID_BATCH:.3f}\n"
          f"    B=1 query (medians): embed {np.median(wall):.3f}, search flat "
          f"{flat_one:.3f}, IVF {ivf_one:.3f}", flush=True)
    return timings, launches


def ingest_routes(docs, parser, card):
    """The tokenizer, the live accumulator and the hash encoder, native
    route against Python route on the same documents: timed, and held
    equal (payloads and op bodies exactly, slabs exactly, vectors within
    1e-6). Returns the field types the documents gave."""
    import oramacore_tpu_torch.index.string_index as si
    from oramacore_tpu_torch.embeddings import (
        MODELS,
        DEFAULT_MODEL,
        _hash_backend,
        hash_encode,
    )
    from oramacore_tpu_torch.benches import ingest_bench as ib
    from oramacore_tpu_torch.types import Locale
    from oramacore_tpu_torch.utils.flatten import flatten_document
    from oramacore_tpu_torch.utils.tokenizer import TextParser, pack_parsed
    from oramacore_tpu_torch.write.doc_op import build_doc_op, embedding_text

    python = TextParser(Locale.EN, use_native=False)
    flats = [flatten_document(d) for d in docs]
    ft = {}
    for flat in flats:
        ib.discover_fields(ft, flat)
    n = len(docs)

    # tokenize: the op bodies of the documents, each parser
    bodies, secs = {}, {}
    for route, p in (("python", python), ("native", parser)):
        (bodies[route], secs[route]) = timed_ms(lambda p=p: [
            build_doc_op(ft, p, d, doc["id"], flat, doc)
            for d, (doc, flat) in enumerate(zip(docs, flats))])
    tokens = sum(v[0] for b in bodies["native"]
                 for v in b["strings_packed"].values())
    ascii_texts = [s for doc in docs for s in (doc["title"], doc["description"])
                   if s.isascii()][:2 * INGEST_PARITY]
    bad = [s for s in ascii_texts if parser.tokenize_and_stem_packed(s)
           != pack_parsed(python.tokenize_and_stem(s))]
    check(not bad and len(ascii_texts) == 2 * INGEST_PARITY,
          f"native packed payloads equal pack_parsed of the Python parser on "
          f"the title and description of {INGEST_PARITY:,} ASCII documents")
    check(bodies["native"] == bodies["python"],
          f"the {n:,} op bodies of both tokenizer routes are equal")
    for route in ("native", "python"):
        print(f"  tokenize + op bodies, {route} route: {n:,} documents, "
              f"{tokens:,} tokens in {secs[route] / 1e3:.2f} s: "
              f"{n / secs[route] * 1e3:,.0f} documents/s, "
              f"{tokens / secs[route] * 1e3:,.0f} tokens/s [{card}, host]",
              flush=True)

    # index: the same bodies through each live accumulator, then commit
    idxs = {}
    saved = os.environ.get("ORAMACORE_NATIVE_LIVE")
    try:
        for route in ("python", "native"):
            os.environ["ORAMACORE_NATIVE_LIVE"] = "1" if route == "native" else "0"
            idx = si.StringIndex()
            t0 = time.perf_counter()
            for b in bodies[route]:
                for path in ("title", "description"):
                    idx.index_text_packed(b["doc_id"], path,
                                          *b["strings_packed"][path])
            t1 = time.perf_counter()
            idx.commit()
            idx.slab_split()
            t2 = time.perf_counter()
            idxs[route] = idx
            itok = sum(b["strings_packed"][p][0] for b in bodies[route]
                       for p in ("title", "description"))
            print(f"  index_text_packed, {route} live accumulator: {n:,} "
                  f"documents, {itok:,} tokens in {t1 - t0:.2f} s: "
                  f"{n / (t1 - t0):,.0f} documents/s, {itok / (t1 - t0):,.0f} "
                  f"tokens/s; commit + slab {t2 - t1:.2f} s [{card}, host]",
                  flush=True)
    finally:
        if saved is None:
            os.environ.pop("ORAMACORE_NATIVE_LIVE", None)
        else:
            os.environ["ORAMACORE_NATIVE_LIVE"] = saved
    check(idxs["native"]._native_live is not None
          and idxs["python"]._native_live is None
          and all(np.array_equal(x, y) for x, y in zip(
              idxs["native"].slab(), idxs["python"].slab(), strict=True))
          and idxs["native"]._slab_ranges == idxs["python"]._slab_ranges,
          f"the {n:,}-document index built through the native live "
          f"accumulator has the slab arrays and ranges of the Python one")
    del idxs

    # hash embedding: the documents' embedding texts, each route
    info = MODELS[DEFAULT_MODEL]
    texts = [embedding_text(f) for f in flats]
    py, py_ms = timed_ms(lambda: [hash_encode(s, info.dim) for s in texts])
    nat, nat_ms = timed_ms(lambda: _hash_backend(texts, info))
    asc = [i for i, s in enumerate(texts) if s.isascii()][:INGEST_PARITY]
    err = float(np.abs(np.stack([nat[i] for i in asc])
                       - np.stack([py[i] for i in asc])).max())
    check(len(asc) == INGEST_PARITY and err <= 1e-6,
          f"native hash vectors within 1e-6 of Python hash_encode on "
          f"{INGEST_PARITY:,} ASCII texts (max |d| {err:.3g})")
    for route, ms in (("python hash_encode", py_ms),
                      ("native (_hash_backend)", nat_ms)):
        print(f"  hash embedding {info.name}, {route}: {n:,} passages in "
              f"{ms / 1e3:.2f} s, {n / ms * 1e3:,.0f} passages/s "
              f"[{card}, host]", flush=True)


def phase_ingest(device, card):
    """Phase 15: JSON documents through flatten_document, build_doc_op
    (the native tokenizer's packed tokens) and index_text_packed (the
    native live accumulator), their embedding text through the
    EmbeddingQueue (the native hash encoder) into a VectorIndex; then the
    shared BM25 batch, flat and IVF vector search and the fused hybrid on
    query strings planned by query_tokens, held against the reference
    scorer and numpy; score_ranges_accumulate on this slab against its
    plain version."""
    import torch

    from oramacore_tpu_torch import native
    from oramacore_tpu_torch.benches import ingest_bench as ib
    from oramacore_tpu_torch.benches import ranges_bench as rb
    from oramacore_tpu_torch.embeddings import (
        DEFAULT_MODEL,
        EmbeddingsService,
        Intent,
    )
    from oramacore_tpu_torch.index.plan import plan_query, query_tokens
    from oramacore_tpu_torch.index.search_exec import (
        HybridSearchTopK,
        SharedBatchExecutor,
        host_bm25_reference,
    )
    from oramacore_tpu_torch.index.string_index import StringIndex
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )
    from oramacore_tpu_torch.types import Locale
    from oramacore_tpu_torch.utils.tokenizer import TextParser
    from oramacore_tpu_torch.write.embedding_queue import EmbeddingQueue

    props = list(ib.TEXT_FIELDS)
    t0 = time.perf_counter()
    words, stems = ib.vocabulary(INGEST_VOCAB, seed=INGEST_SEED)
    docs = ib.documents(INGEST_DOCS, seed=INGEST_SEED, words=words)
    qtexts = ib.queries(stems, INGEST_QUERIES, seed=INGEST_SEED + 1)
    odd = sum(not (d["title"] + d["description"]).isascii() for d in docs)
    n = len(docs)
    print(f"  corpus: {n:,} documents (title 2-8, description 8-64 words, "
          f"zipf over {len(words):,} words of {len(stems):,} stems; {odd:,} "
          f"with a non-ASCII word), {len(qtexts)} queries of 1-4 words: "
          f"{time.perf_counter() - t0:.1f} s of host time", flush=True)
    kinds = {}
    for loc in Locale:
        kinds.setdefault(TextParser(loc, use_native=False).stemmer,
                         []).append(loc.value)
    print("  stemmer by locale: " + "; ".join(
        f"{k}: {', '.join(v)}" for k, v in sorted(kinds.items())), flush=True)
    parser = TextParser(Locale.EN)

    ingest_routes(docs[:INGEST_COMPARE], parser, card)

    # the whole corpus: ingest loop -> index, queue -> vector index
    native.reset_routes()
    torch.cuda.reset_peak_memory_stats()
    sidx = StringIndex()
    vidx = VectorIndex(VectorIndexConfig(dim=384), device)

    def sink(collection, body):
        vidx.insert(body["doc_id"], [np.asarray(v, np.float32)
                                     for v in body["vectors"]])

    queue = EmbeddingQueue(EmbeddingsService(), sink, batch_limit=ENC_CALL)
    ft = {}
    t0 = time.perf_counter()
    try:
        stats = ib.ingest(docs, parser, sidx, queue, ft,
                          insert_batch=INGEST_INSERT, model=DEFAULT_MODEL)
        t_in = time.perf_counter() - t0
        drained = queue.flush_and_wait(timeout=900)
        t_last = time.perf_counter() - t0
    finally:
        queue.stop()
    check(drained and queue.failed_batches == 0,
          f"the embedding queue drained: {queue.batches:,} batches of "
          f"<= {ENC_CALL}, {queue.failed_batches} failed")
    print(f"  ingest of {n:,} documents ({int(stats['tokens']):,} tokens in "
          f"title and description): op bodies {stats['ops_s']:.2f} s, "
          f"index_text_packed {stats['index_s']:.2f} s, submit "
          f"{stats['submit_s']:.2f} s; {n / t_in:,.0f} documents/s to the "
          f"last op; the queue's last vector at {t_last:.2f} s "
          f"({queue.seconds:.2f} s busy in its worker) [{card}, host]",
          flush=True)
    t0 = time.perf_counter()
    sidx.commit()
    sidx.slab_split()
    t1 = time.perf_counter()
    vidx.commit()
    t2 = time.perf_counter()
    print(f"  commit: StringIndex {t1 - t0:.2f} s (+ slab), VectorIndex "
          f"{t2 - t1:.2f} s [{card}, host]", flush=True)
    routes = {k: dict(v) for k, v in native.ROUTES.items()}
    print(f"  routes (native / Python): {routes}", flush=True)
    check(routes["hash_encode"] == {"native": n - odd, "python": odd}
          and routes["tokenizer"]["python"] == odd
          and routes["live_accum"] == {"native": 2 * n, "python": 0},
          "every ASCII text took the native tokenizer and hash encoder, every "
          "other text the Python route, every field the native accumulator")
    vdocs = vidx._committed_docs
    check(len(vdocs) == n and np.array_equal(vdocs, np.arange(n)),
          f"all {n:,} documents, each with text, hold their vector")
    vecs = vidx._committed_matrix

    # BM25 shared batch: query_tokens -> plan -> search_topk_shared
    toks = [query_tokens(parser, q, False) for q in qtexts]
    ex = SharedBatchExecutor(device)

    def bm25():
        return ex.search_topk_shared(sidx, toks, props, {}, float(n), n, K)

    (res, first_ms), launches = counted("ingest BM25", lambda: timed_ms(bm25))
    check(launches["score_ranges_accumulate"] > 0,
          "the ingest BM25 batch launched score_ranges_accumulate")
    steady = [timed_ms(bm25)[1] for _ in range(3)]
    print(f"  search_topk_shared B={len(toks)} k={K} over {props}: first "
          f"{first_ms:.1f} ms (slab to the device included); steady "
          f"{', '.join(f'{s:.1f}' for s in steady)} ms, "
          f"{len(toks) / np.mean(steady) * 1e3:,.1f} QPS [{card}]", flush=True)
    vals, ids, counts = res
    refs = [host_bm25_reference(sidx, toks[b], props, {}, float(n))
            for b in range(N_INGEST_CHECKED)]
    check_against_reference(refs, vals, ids, counts, "ingest BM25")
    terms = set()
    for p in props:
        terms.update(sidx._slab_terms_by_field.get(p, ()))
    stem_only = [b for b, q in enumerate(qtexts)
                 if all(w not in terms for w in q.split()) and counts[b] > 0]
    check(bool(stem_only),
          f"{len(stem_only)} queries whose every word no document holds found "
          f"hits through the stem (e.g. {qtexts[stem_only[0]]!r} -> "
          f"{toks[stem_only[0]]}, {int(counts[stem_only[0]])} hits)"
          if stem_only else "a query of stem-only words found hits")
    profile_once(f"ingest BM25 B={len(toks)}", bm25, card)

    # score_ranges_accumulate on this slab against its plain version
    launches_rec = rb.capture_batch(sidx, toks[:64], toks, device, n,
                                    properties=props)
    try:
        r = rb.check_case("ingest B=256", launches_rec, reps=3)
    except AssertionError as e:
        raise SmokeFailure(f"score_ranges_accumulate: {e}") from e
    check(True, f"score_ranges_accumulate [ingest B={len(toks)}]: "
                f"{len(launches_rec)} launch(es), the hit set equals the plain "
                f"version's and acc is within rtol 1e-5 / atol 1e-6 (max abs "
                f"err {r['max_abs_err']:.3g})")
    r["ms"] = rb.time_launches(launches_rec, rb.kernel_fn, 5)
    rb.report(f"ingest B={len(toks)}", r, card)
    share(f"score_ranges_accumulate [ingest B={len(toks)}]", r["ms"],
          r["bound_ms"], r["bound_by"], card)
    del launches_rec

    # vector search of the hash-embedded queries, flat then IVF
    svc = EmbeddingsService()
    nb = len(qtexts) // INGEST_VEC_B
    qb = [embed(svc, qtexts[j * INGEST_VEC_B:(j + 1) * INGEST_VEC_B],
                Intent.QUERY, DEFAULT_MODEL)[0] for j in range(nb)]
    vb16 = bf16_round(vecs)
    flat_ref = phase_flat(vidx, vb16, qb, device, card)
    flat_rows = vidx.flat_device_rows()
    phase_ivf(vidx, vecs, qb, flat_ref, device, card,
              recall_note="hash-embedded documents")

    # the fused hybrid, B=8
    qv = qb[0][:HYBRID_BATCH]
    htoks = toks[:HYBRID_BATCH]
    plans = [plan_query(sidx, tk, props, {}) for tk in htoks]
    hx = HybridSearchTopK(device)
    nd = [float(n)] * HYBRID_BATCH
    hsims = [INGEST_HYBRID_SIM] * HYBRID_BATCH
    runs, hl = counted("ingest hybrid", lambda: [timed_ms(
        lambda: hx.search_topk_hybrid(sidx, plans, nd, n, K, flat_rows, qv,
                                      hsims)) for _ in range(3)])
    check(hl["score_ranges_accumulate"] > 0,
          "the ingest hybrid launched score_ranges_accumulate")
    sims_ref = vb16 @ bf16_round(qv).T
    hrefs = []
    for b, tk in enumerate(htoks):
        bm = dense_scores(host_bm25_reference(sidx, tk, props, {}, float(n)), n)
        s = sims_ref[:, b]
        vec = np.where(s >= INGEST_HYBRID_SIM, s, 0.0)
        maybe = set(np.nonzero(np.abs(s - INGEST_HYBRID_SIM) <= VEC_TIE)[0]
                    .tolist())
        hrefs.append(fused_reference(bm, vec, maybe))
    report_check(hybrid_errors(runs[0][0], hrefs, "ingest hybrid"),
                 f"hybrid top-{K} and match counts of {HYBRID_BATCH} queries "
                 f"equal the numpy fusion of the reference scorer and bf16 "
                 f"products ({int((sims_ref >= INGEST_HYBRID_SIM).sum())} "
                 f"vector hits at similarity {INGEST_HYBRID_SIM})")
    print(f"  search_topk_hybrid B={HYBRID_BATCH}: first {runs[0][1]:.1f} ms, "
          f"steady {runs[1][1]:.1f}, {runs[2][1]:.1f} ms [{card}]", flush=True)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB [{card}]", flush=True)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from oramacore_tpu_torch import require_cuda
    from oramacore_tpu_torch.benches import card_line
    from oramacore_tpu_torch.benches.ranges_bench import (
        build_index,
        make_batches,
    )
    from oramacore_tpu_torch.ops import _build

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
    _build.load_all()
    for mod in wrapper_modules():
        mod.load_kernels()
    for name, (seconds, log) in sorted(_build.BUILD_LOG.items()):
        built = f"built by nvcc in {seconds:.1f} s" if log else \
            "loaded from build/kernels/ (built earlier from the same sources)"
        print(f"  {name}.cu: {built}", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    print(f"  all kernels ready in {time.perf_counter() - t0:.1f} s", flush=True)
    from oramacore_tpu_torch import native
    from oramacore_tpu_torch.native import _build as native_build

    t0 = time.perf_counter()
    for load in (native.load_tokenizer, native.load_hash_encoder,
                 native.load_live_accum):
        load()
    print(f"  native host libraries (g++ {' '.join(native_build.CXX_FLAGS)}) "
          f"ready in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {'built in %.1f s' % s if s else 'cached'}"
                      for k, s in sorted(native_build.BUILD_LOG.items())),
          flush=True)

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
    timings = phase_kernels(idx, batches, slab, card)
    del slab
    torch.cuda.empty_cache()

    path_launches = {}
    print("[5] the main path", flush=True)
    torch.cuda.reset_peak_memory_stats()
    run, path_launches["main"] = counted(
        "main", lambda: drive_main_path(idx, batches, N_DOCS, device, card))
    print(f"  peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(path_launches["main"]["score_ranges_accumulate"] > 0,
          "the main path launched score_ranges_accumulate")
    refs, frefs = check_main_path(idx, run, N_DOCS)
    torch.cuda.empty_cache()

    print("[6] the window-scoring bench (benches/pallas_bench.py port)",
          flush=True)
    _, path_launches["bench"] = counted("bench", lambda: phase_bench(card))
    for name in ("gather_windows", "score_windows"):
        check(path_launches["bench"][name] > 0, f"the bench launched {name}")
    torch.cuda.empty_cache()

    print("[7] sort-by search", flush=True)
    phase_sorted(idx, batches, refs, frefs, run["masks"][:len(frefs)],
                 N_DOCS, device, card)
    torch.cuda.empty_cache()

    print("[8] group-by search", flush=True)
    phase_grouped(idx, batches, refs, N_DOCS, device, card)
    torch.cuda.empty_cache()

    print(f"[9] flat vector search, {VEC_ROWS:,} x {VEC_DIM} (bench_vector_1m)",
          flush=True)
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )

    t0 = time.perf_counter()
    vecs, vbatches = vector_corpus(VEC_ROWS, VEC_DIM, 1 + VEC_STEADY, VEC_BATCH)
    vb16 = bf16_round(vecs)
    print(f"  host data: {time.perf_counter() - t0:.1f} s", flush=True)
    vidx = VectorIndex(VectorIndexConfig(dim=VEC_DIM), device)
    vidx._committed_matrix = vecs   # as bench_vector_1m fills its index
    vidx._committed_docs = np.arange(VEC_ROWS, dtype=np.int32)
    vidx._gen += 1
    torch.cuda.reset_peak_memory_stats()
    flat_ref = phase_flat(vidx, vb16, vbatches, device, card)
    flat_rows = vidx.flat_device_rows()
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)

    print("[10] IVF int8 vector search on the same index", flush=True)
    lay, nprobe = phase_ivf(vidx, vecs, vbatches, flat_ref, device, card)
    int8_rows = vidx.int8_device_rows()

    print("[11] hybrid search: the 1M-doc index, doc i's vector is row i",
          flush=True)
    phase_hybrid(idx, (flat_rows, int8_rows), lay, nprobe, vecs, vb16,
                 batches, refs, frefs, run["masks"], N_DOCS, device, card)
    del idx, vidx, vecs, vb16, flat_rows, int8_rows, lay, run, refs, frefs
    gc.collect()
    torch.cuda.empty_cache()

    print("[12] the pruned full-text tier on the 10M-doc text configuration "
          "(benches/hybrid10m_bench.py)", flush=True)
    t_phase = time.perf_counter()
    pruned_timings, path_launches["pruned"], ctx = phase_pruned(device, card)
    timings.update(pruned_timings)
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("[13] pruned facets and the pruned int8 hybrid: the same index and "
          f"a {N_HYBRID10M_LABEL} int8 IVF layout "
          "(benches/hybrid10m_bench.py's vector side)", flush=True)
    t_phase = time.perf_counter()
    facet_timings, path_launches["facets"] = phase_facets_hybrid(
        ctx, device, card)
    timings.update(facet_timings)
    del ctx
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    print("[14] the text encoder: SemanticBase and SemanticMini from passage "
          f"text ({ENC_PASSAGES:,} passages) to vector and hybrid search",
          flush=True)
    t_phase = time.perf_counter()
    enc_timings, path_launches["encoder"] = phase_encoder(device, card)
    timings.update(enc_timings)
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[15] ingest: {INGEST_DOCS:,} JSON documents through the text "
          f"parser, the native live accumulator and the embedding queue to "
          f"full-text, vector and hybrid search", flush=True)
    t_phase = time.perf_counter()
    phase_ingest(device, card)
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)

    kernels = {"kernels": [{
        "name": k["name"],
        "route": k["route"],
        "source": k["source"],
        "replaces": k["replaces"],
        "launches": path_launches[k["path"]][k["name"]],
        "max_abs_err": timings[k["name"]]["max_abs_err"],
        "ms": timings[k["name"]]["ms"],
        "plain_ms": timings[k["name"]]["plain_ms"],
        "bound_ms": timings[k["name"]]["bound_ms"],
        "bound_by": timings[k["name"]]["bound_by"],
        "library_ms": timings[k["name"]]["library_ms"],
    } for k in KERNELS]}
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
