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
  16,384 seeded passages through `EmbeddingsService.calculate_embeddings`
  (`SemanticBase`, calls of 100 as the write side batches), 1,024 of them
  held against the plain path in f64; B=1024 encode throughput of each
  model; B=1 query latency; then flat, IVF and hybrid search
  (`HybridSearchTopK.search_topk_hybrid` over a `StringIndex` of the same
  passages, indexed through the text parser's packed tokens) with
  embedded query texts;
- the ingest text pipeline on 4,096 seeded JSON documents of the
  reference's games-bench shape (`oramacore_tpu_torch/benches/
  ingest_bench.py`): the native tokenizer, live accumulator and hash
  encoder against their Python routes on all of them (timed, held
  equal), then every document through `flatten_document`, `build_doc_op`
  and `StringIndex.index_text_packed`, and through the `EmbeddingQueue`
  into a `VectorIndex`; the shared BM25 batch (B=256) of query strings
  planned by `query_tokens`, its `score_ranges_accumulate` launches
  against the plain version, flat and IVF search (B=64) and the fused
  hybrid (B=8); before them, the 14 Snowball locales of the text parser
  (the port's own stemmers: the card's machine has no `nltk`) on their seeded
  vocabularies (`oramacore_tpu_torch/benches/stem_vocab.py`, about 2,000
  words each) held to the committed digests of NLTK's stems, and the
  port's code parser on the sources of the repo's code-parser tests,
  held to the outputs the CPU tests pin;
- training: the attention's backward kernels
  (`encoder_attention_backward_dq`, `_dkv`) against their plain version
  in f64 at the cases of `oramacore_tpu_torch/benches/train_bench.py`
  (timed beside the backward of `scaled_dot_product_attention`), then
  SemanticBase (4 layers, width 256, 8 heads of 32) trained through
  `oramacore_tpu_torch/train/semantic_encoder.py` at the defaults of
  `scripts/train_semantic_encoder_v2.py` (64 pairs of 16 tokens, seed 0;
  500 of its 1,500 steps), the run's first steps held card against CPU,
  and the
  trained checkpoint saved under `build/trained/`, loaded through
  `load_torch_encoder`, checked (probes, synonyms, phrases) and searched
  with;
- the runtime, through the entry points a user calls: `build_orama(config,
  device="cuda")` with the in-memory op log and the consumer thread;
  262,144 games documents of phase 15's generator (hash model) and 16,384 of
  phase 14's passages (SemanticBase, embedded by the write side's queue)
  through `WriteSide.insert_documents` in batches of 1,024; searches of
  every kind (full-text, where-filters, facets, sort-by, group-by,
  tolerance, exact, a pin rule, vector, hybrid) through `ReadSide.search`
  and `search_batch` (the shared B=256 route, filtered, sorted, vector and
  hybrid batches) on the live layer and after the commit; held to a CPU
  read side loaded from the snapshots, to the BM25 reference scorer, to
  a restart, and, with `reader_side.pruning = "on"`, card against CPU
  again; latency, QPS, the B=256 batch's device time and the read side's
  overhead over a direct `search_topk_shared` call;
- the API server, through the entry points a user calls: that runtime
  served by `server.ApiServer` on 127.0.0.1 (an event loop on its own
  thread) and reached with the port's client (`client.OramaCoreTPU`):
  every case above over `/search` and `/search/batch` held to the
  in-process answers (dense, then with pruning "on"), `search` p50 / p99
  and B=256 QPS over HTTP beside in-process, HS256 and RS256 customer
  tokens (the key pair `oramacore_tpu_torch/benches/rs256_smoke_key.json`)
  and bad keys, a BeforeSearch and a TransformDocumentAfterSearch hook
  set over HTTP, 8,192 documents over `/insert` and the repo's
  `tests/hurl/api-test.hurl` and `search-paths.hurl`; then `python -m
  oramacore_tpu_torch.server` as three processes: on
  `config.example.yaml`, and as a writer and a reader node (YAML configs
  written under `build/server_nodes/`, the tcp-stream op log, the reader
  on the card) with 4,096 documents sent to the writer over HTTP, the
  reader held to an in-process CPU runtime fed the same documents,
  killed with SIGKILL, restarted and caught up, and every node stopped
  with SIGTERM (exit 0);
- RAG answers: that runtime served with the port's AI service
  (`ai/service.AIService`) and a scripted OpenAI-compatible LLM
  (`oramacore_tpu_torch/benches/llm_mock.py`, no weights: the repository
  has none) on a socket: 32 `/answer` calls in each of full-text and
  hybrid on the games and vector on the SemanticBase passages (each
  answer's `search_results` held to `ReadSide.search` with the machine's
  parameters, the LLM request to those documents, the streamed tokens to
  the script; wall and time to the first token), planned answers, NLP
  queries (constraints injected on price and genre), OpenAI chat,
  MCP searches held to `/search`, suggestions, titles, tools, system
  prompts, training sets, a BeforeAnswer hook seen on the hook-log SSE,
  mode "auto" searches and the repo's `tests/hurl/kv-actions-test.hurl`;
- the doc-sharded mesh (`parallel/`), through the entry point a user
  calls: a `ReadSide` with `reader_side.sharded_shards = 4` and
  `mesh_devices=[cuda:0] * 4` (four shards on the one card) loaded from
  the runtime's data dir, its own string indexes, vectors and int8 IVF
  layout held equal to the runtime's, every dense, pruned and
  int8-hybrid case and B=256 batches held to the runtime's single-device
  read side, each kernel launched once a shard on each case (the query
  encoder once a search); and the head widths 160, 256 and 320,
  above the tensor-core attention kernels', through their f32
  instances forward and backward (phase 14);
- training at the full width of `scripts/train_semantic_encoder_tpu.py`
  through `oramacore_tpu_torch/train/semantic_encoder_tpu.py` (6 layers,
  width 256, 8 heads of 32, B=256 pairs as one (512, 32) batch a step,
  400 of its 1,200 steps, seed 0): the three attention kernels at that
  shape against their f64 references, timed beside their bound and
  `scaled_dot_product_attention`'s forward and backward; step times, one
  profiled step, the first steps held card against CPU (the first step's
  gradients leaf by leaf, the losses, the parameters), the validation
  probes of both tiers, and the checkpoint saved under `build/trained/`,
  reloaded in `TorchTextEncoder` and probed again.

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
import warnings

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
PRUNED_STEADY = 1     # distinct steady batches after the checked one
                      # (3 until phase 20, cut for time)
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
ENC_PASSAGES = 16_384     # the ingest corpus (benches/encoder_bench.py)
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
INGEST_DOCS = 4_096       # documents of the games bench's shape (phase 17
#                           takes 262,144 of them through the runtime;
#                           8,192 until phase 20, cut for time)
INGEST_SEED = 15
INGEST_VOCAB = 50_000     # English-like words, stems x suffixes
INGEST_COMPARE = 4_096    # documents timed on the native and Python routes
INGEST_PARITY = 2_048     # ASCII documents / texts held route against route
INGEST_INSERT = 1_024     # documents an insert batch
INGEST_QUERIES = 256      # query strings of 1-4 words (the BM25 batch)
INGEST_VEC_B = 64         # embedded queries a flat / IVF batch
INGEST_HYBRID_SIM = 0.2   # the hybrid's vector similarity threshold
N_INGEST_CHECKED = 16     # BM25 queries held against the reference scorer

# phase 16: training the text encoder (train/semantic_encoder.py)
TRAIN_SEED = 16
TRAIN_STEPS = 500         # of the script's 1,500 (all until phase 20, then
                          # 750, cut for time; the pair accuracy reaches 1.0
                          # by step 100)
TRAIN_COMPARE = 10        # first steps of the run held card against CPU
TRAIN_LOSS_TOL = 1e-4     # |loss| card against CPU at each of those steps
TRAIN_PARAM_TOL = 1e-5    # |parameter| card against CPU after them
WIDE_TRAIN_STEPS = 3      # steps at --hidden 256 --heads 1 (one head of 256:
                          # the wide backward kernels), card against CPU
TRAIN_PASSAGES = 512      # passages embedded with the trained model

# phase 21: training at scripts/train_semantic_encoder_tpu.py's full width
# (train/semantic_encoder_tpu.py: 6 layers, 256 wide, B=256 pairs, L=32)
TPU_TRAIN_STEPS = 400     # of the script's 1,200 (cut for time: at 1,200
                          # the phase took 70.2 s, the host's batches and
                          # launches pace a step at 46 ms)
TPU_TRAIN_COMPARE = 3     # first steps of the run held card against CPU
TPU_TRAIN_GRAD_REL = 1e-4  # |gradient| card against CPU at the first step,
                           # of each leaf's largest
TPU_TRAIN_OUT = os.path.join(ROOT, "build", "trained",
                             "semantic-base-tpu-smoke")

# the sources of tests/test_aux_components.py's code-parser tests, which
# phase 15 parses with the port's utils/code_parser.py; the SHA-256 of its
# outputs (code_parser_outputs) is pinned by tests/test_torch_code_parser.py
# against the JAX package's outputs
CODE_SOURCES = {
    "tsx": """
import React, { useState } from 'react';
import { searchClient } from './lib/search';
// renders the results list
export default function SearchResults({ query }) {
  const [items, setItems] = useState([]);
  /* fetch on mount */
  const fetchItems = async () => searchClient.find(query);
  return <ResultList items={items} />;
}
class HelperThing {}
""",
    "lexer robustness": '''
const API = "function fakeFn(x) { import bad from 'nope' }";
// function commentedOut() {}
const re = /function alsoNot\\(\\)/g;
const tpl = `prefix ${ computeValue(realArg) } function neitherMe() {}`;
const ratio = total / count / 2;  // divisions, not regexes
import real, { useThing as useAliased } from "@scope/pkg";
export const realFn = async ({ nested = { a: 1 }, flag = true }, rest) => 1;
''',
    "jsx and extends": '''
class SearchBox extends BaseWidget {}
const App = () => <ResultGrid items={items} pageSize={20} onSelect={go} />;
''',
}
TOOL_SOURCES = [
    "export default function run({ city, units = 'metric' }) { return 1; }",
    "export default async (a, b) => a + b",
    "function notExported() {}",
    "export default function run({ city, opts = { a: 1, b: 2 }, "
    "units = 'metric' }, extra) { return 1; }",
    "export default async (query: string, limit: number = 10) => 1",
    "export default x => x * 2",
]
CODE_PARSER_DIGEST = ("090f5852f1db0e8677380f1708e22f9b"
                      "fbc6797fc35528a2ffe02313f5f26882")

# phase 17: the runtime (build_orama -> WriteSide -> op log -> ReadSide)
RS_DOCS = 262_144         # games documents (phase 15's corpus, seed 15)
RS_PASSAGES = 16_384      # SemanticBase passages (phase 14's, seed 14)
RS_INSERT = 1_024         # documents an insert_documents call
RS_QUERIES = 256          # query strings (the B=256 shared batch)
RS_SINGLE = 64            # single full-text search calls
RS_KIND_QUERIES = 4       # queries of each other search kind
RS_VEC_B = 64             # the vector and hybrid batches
RS_SIM = 0.2              # vector similarity on the hash-model games
RS_PASSAGE_SIM = 0.5      # vector similarity on SemanticBase passages
RS_LATENCY_N = 16         # single calls timed for each other mode (32
                          # until phase 20, cut for time)
RS_CPU_FULLTEXT = 4       # single full-text searches held card to CPU
                          # (8 until phase 20; cut for time)
RS_CPU_KIND = 1           # queries of each other kind held card to CPU
                          # (2 until phase 20; cut for time)
N_RS_NUMPY = 16           # plain queries held to host_bm25_reference
RS_DIR = os.path.join(ROOT, "build", "read_side")
RS_MASTER = "smoke-master-key"
RS_KEYS = {"games": ("games-read", "games-write"),
           "passages": ("passages-read", "passages-write")}

# phase 20: the doc-sharded mesh over phase 17's data
MESH_SHARDS = 4           # shards, all on the one card (mesh_devices)
MESH_BATCH_CALLS = 2      # search_batch calls of each kind at B=RS_QUERIES
MESH_ONCE_A_SEARCH = ("encoder_attention",)  # the query's embedding, made
                          # once before the shards (each other mesh kernel
                          # launches once a shard)

# phase 18: the API server
SRV_INGEST = 8_192        # documents inserted over HTTP into the served
                          # runtime (16,384 before phase 19, cut for time)
SRV_LATENCY_N = 16        # single calls timed over HTTP and in-process a mode
                          # (32 until phase 20, cut for time)
SRV_HOOK_DOCS = 64        # documents of the hooked collection
NODE_DOCS = 4_096         # documents sent to the writer node over HTTP
                          # (16,384 before phase 19, 8,192 before phase
                          # 20, cut for time)
NODE_FULLTEXT = 16        # full-text searches held reader node to CPU
NODE_KIND = 2             # searches of each other kind held reader node to CPU
NODE_DIR = os.path.join(ROOT, "build", "server_nodes")
NODE_WAIT_S = 600.0       # the longest wait for a node (start, catch-up)
JWT_ISSUER, JWT_AUDIENCE, JWT_HS256 = "smoke", "oramacore", "smoke-hs256"
# phase 19: RAG answers from phase 17's runtime
AI_ANSWERS = 32           # /answer calls of each mode
AI_PLANNED = 8            # /planned_answer calls
AI_CHAT = 8               # OpenAI chat calls, half of them streamed
AI_NLP = 8                # /generate/nlp_query calls
AI_MCP = 8                # MCP tools/call searches
AI_AUTO = 4               # mode "auto" searches
AI_MAX_DOCS = 5           # documents an answer retrieves
AI_ANSWER = ("The closest matches are listed above with their prices and "
             "genres; the first one fits the question best.")
AI_SELECTED = ["name"]    # the properties the mock picks to embed

# Every ported kernel entry point: its wrapper module, the CUDA source, the
# TPU kernel (or, with jitted=True, the jitted JAX function) it replaces,
# the path whose run gives its launch count, and whether phase 20's mesh
# path launches it (once a shard).
KERNELS = (
    dict(name="score_windows",
         module="oramacore_tpu_torch.ops.score_windows", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/score_windows.cu",
         replaces="oramacore_tpu/ops/pallas_score.py:34", path="bench",
         mesh=False),
    dict(name="score_ranges_accumulate",
         module="oramacore_tpu_torch.ops.score_windows", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/score_windows.cu",
         replaces="oramacore_tpu/ops/pallas_score.py:34", path="main",
         mesh=True),
    dict(name="gather_windows",
         module="oramacore_tpu_torch.ops.gather_windows", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/gather_windows.cu",
         replaces="oramacore_tpu/ops/pallas_gather.py:38", path="bench",
         mesh=False),
    # kernels for jitted JAX code (XLA, no pallas_call)
    dict(name="assign_rows_accumulate",
         module="oramacore_tpu_torch.ops.assign_rows", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/assign_rows.cu",
         replaces="oramacore_tpu/ops/bm25.py:528", jitted=True,
         path="main", mesh=True),
    dict(name="count_present",
         module="oramacore_tpu_torch.ops.assign_rows", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/assign_rows.cu",
         replaces="oramacore_tpu/ops/bm25.py:528", jitted=True,
         path="main", mesh=True),
    dict(name="rescore_bsearch",
         module="oramacore_tpu_torch.ops.pruned", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/pruned_rescore.cu",
         replaces="oramacore_tpu/ops/pruned.py:764", jitted=True,
         path="pruned", mesh=True),
    dict(name="rescore_worklist",
         module="oramacore_tpu_torch.ops.pruned", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/pruned_rescore.cu",
         replaces="oramacore_tpu/ops/pruned.py:242", jitted=True,
         path="pruned", mesh=True),
    dict(name="facet_hist",
         module="oramacore_tpu_torch.ops.facet_hist", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/facet_hist.cu",
         replaces="oramacore_tpu/ops/pruned.py:1139", jitted=True,
         path="facets", mesh=True),
    dict(name="facet_hist_multi",
         module="oramacore_tpu_torch.ops.facet_hist", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/facet_hist.cu",
         replaces="oramacore_tpu/ops/pruned.py:1198", jitted=True,
         path="facets", mesh=False),
    # the attention and its gradient count their wide instances for head
    # widths above 128 (ops/csrc/attention_wide.cuh) under the same names
    dict(name="encoder_attention",
         module="oramacore_tpu_torch.ops.attention", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/encoder_attention.cu",
         replaces="oramacore_tpu/embeddings/flax_encoder.py:69", jitted=True,
         path="encoder", mesh=True),
    # the attention's gradient, which JAX's autodiff derives inside the
    # jitted training step
    dict(name="encoder_attention_backward_dq",
         module="oramacore_tpu_torch.ops.attention", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/encoder_attention_backward.cu",
         replaces="scripts/train_semantic_encoder_v2.py:304", jitted=True,
         path="train", mesh=False),
    dict(name="encoder_attention_backward_dkv",
         module="oramacore_tpu_torch.ops.attention", route="cuda",
         source="oramacore_tpu_torch/ops/csrc/encoder_attention_backward.cu",
         replaces="scripts/train_semantic_encoder_v2.py:304", jitted=True,
         path="train", mesh=False),
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
    rows_launches = []
    cases["batch"] = rb.capture_batch(idx, batches[0], batches[1], dev,
                                      N_DOCS, rows=rows_launches)
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

    # assign_rows_accumulate: every launch of the same steady B=1024 batch
    # of the main path, as recorded above, beside the addmm_ pair it
    # replaced on the same operands (benches/assign_bench.py)
    from oramacore_tpu_torch.benches import assign_bench as ab

    try:
        r = ab.check_and_time(rows_launches, reps=5)
    except AssertionError as e:
        raise SmokeFailure(f"assign_rows_accumulate: {e}") from e
    check(True, f"assign_rows_accumulate [batch]: {len(rows_launches)} "
                f"launches, df and matched equal the plain versions' and "
                f"scores are within rtol 1e-6 (max abs err {r['max_abs_err']:.3g})")
    ab.report("batch", r, card)
    share("assign_rows_accumulate [batch]", r["ms"], r["bound_ms"],
          r["bound_by"], card)
    del rows_launches
    out["assign_rows_accumulate"] = dict(
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["products_ms"],
        max_abs_err=r["max_abs_err"])
    out["count_present"] = dict(
        ms=r["count_ms"], plain_ms=None, bound_ms=r["count_bound_ms"],
        bound_by="bytes", library_ms=None, max_abs_err=0.0)

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
    before = launch_counts()
    filtered, filt_s = run(batches[0], doc_masks=list(masks))
    launched = {k: n - before[k] for k, n in launch_counts().items()
                if n > before[k]}
    print(f"  search_topk_shared B={B} with a 50% filter per query: "
          f"{filt_s * 1e3:.1f} ms; kernel launches {launched} [{card}]",
          flush=True)
    check(launched.get("assign_rows_accumulate", 0) > 0,
          "the filtered batch launched assign_rows_accumulate")

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


# host seconds profile_once leaves between the profiled call and each edge
# of the profiler's window
PROFILE_EDGE_S = 0.005
# readings profile_once takes before a reading that misses launches fails
PROFILE_TRIES = 3

# the device function each counted entry point launches once a call
# (rescore_worklist: its tail kernel, which runs even when no tile does)
KERNEL_FUNCTIONS = {
    "score_windows": "score_windows_kernel",
    "score_ranges_accumulate": "score_ranges_accumulate_kernel",
    "gather_windows": "gather_windows_kernel",
    "assign_rows_accumulate": "assign_rows_accumulate_kernel",
    "count_present": "count_present_kernel",
    "rescore_bsearch": "rescore_bsearch_kernel",
    "rescore_worklist": "worklist_tail_kernel",
    "facet_hist": "facet_hist_kernel",
    "facet_hist_multi": "facet_hist_multi_kernel",
    "encoder_attention": "encoder_attention_kernel",
    "encoder_attention_backward_dq": "attention_dq_kernel",
    "encoder_attention_backward_dkv": "attention_dkv_kernel",
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


def profile_reading(fn):
    """One torch.profiler reading of fn (a warm-up step, then the
    profiled call between PROFILE_EDGE_S gaps): the wrappers' LAUNCHES
    during that call, and (device ms, count, name) of each device
    kernel in the profile (the device ranges of `record_function`
    annotations, which the port's spans open under a profiler, are not
    kernels and are left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    got = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.update(
                     events=p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_EDGE_S)
        before = launch_counts()
        fn()
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in launch_counts().items()}
        time.sleep(PROFILE_EDGE_S)
        prof.step()
    kernels = [
        (getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
        for e in got["events"] if str(e.device_type).endswith("CUDA")
        and not e.key.startswith("ProfilerStep")
        and not getattr(e, "is_user_annotation", False)
    ]
    return launched, kernels


def profile_once(label, fn, card):
    """One call under torch.profiler, after a traced warm-up call that
    the profiler discards: device kernel time, idle share (against the
    shorter wall time of two unprofiled calls just before, since the
    profiler's own host work lengthens the profiled one) and the largest
    kernels.
    The profile's count of each kernel must equal the wrappers' LAUNCHES
    for the same call, or the phase fails: a profile that misses
    launches is a reading, not a result. (A profile without the warm-up
    step dropped kernels late in a long run; with it, a reading of the
    hybrid's champion route once lost 2 of its 4 kernels.) The profiler
    keeps only device activity whose timestamps fall inside its window,
    and it takes the window's edges on the host's clock, so the profiled
    call starts PROFILE_EDGE_S after the window opens, and the window
    closes PROFILE_EDGE_S after the call has finished on the device.
    The schedule runs one cycle (repeat=1), so the window's close starts
    no second warm-up trace. A reading that still misses launches (once
    it held no device activity at all) is printed and taken again, up to
    PROFILE_TRIES readings; only a reading whose counts all match is
    kept, and the phase fails when none does."""
    import torch

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = min(walls)
    for reading in range(1, PROFILE_TRIES + 1):
        launched, kernels = profile_reading(fn)
        profiled = profiled_counts((key, c) for _, c, key in kernels)
        off = {name: (launched[name], profiled[name]) for name in profiled
               if launched[name] != profiled[name]}
        ran = ", ".join(f"{k} {n}" for k, n in launched.items() if n) or "none"
        what = (f"profile, {label}: each kernel's count equals the wrappers' "
                f"LAUNCHES ({ran})")
        if off:
            what += (f"; reading {reading} of {PROFILE_TRIES} missed "
                     f"launches, (launched, profiled) {off}, "
                     f"{sum(c for _, c, _ in kernels)} device events")
        if not off or reading == PROFILE_TRIES:
            break
        print(f"  {what}: read again", flush=True)
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


def attention_checks(device, card, cases=None):
    """encoder_attention against its plain version in f64 at every case of
    benches/encoder_bench.py (the shapes phase 14's encoder gives it,
    BGEBase's and BGESmall's geometry, padded batch rows, L=1), or at
    `cases`, each timed as CUDA-graph replays, warm and L2-cold, beside
    its bound (bytes against FLOPs at the 3xTF32 tensor-core rate; the
    FFMA-rate bound in brackets), the plain version and
    scaled_dot_product_attention on the same inputs (its time and max abs
    error); then, without `cases`, the head widths of width_checks. The
    kernels line takes the first case, SemanticBase at B=1024, L=64."""
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
    for i, (label, case) in enumerate((cases or ATTENTION_CASES).items()):
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
    if cases is None:
        width_checks(device, card)
    return out


def width_checks(device, card):
    """Head widths the tensor-core kernels do not take, through the
    wrappers on the card: hd 48 zero-padded to 64 (one launch, within
    ATTN_TOL of the f64 plain version), and hd 160, 256, 320 and a ragged
    130 on the wide instances, forward within ATTN_TOL and backward within
    BWD_TOL of their f64 references, one launch of each kernel a call. The
    forward and the backward pair are timed warm as CUDA-graph replays
    beside their bounds (3xTF32 rate; FFMA rate in brackets), the plain
    versions and scaled_dot_product_attention's forward and backward; the
    forward kernel and each backward kernel alone (on the operands the
    wrapper gives them: hd 130 zero-padded to 132) L2-cold beside their
    own bounds. (The wide kernels' earlier FFMA designs are timed against
    these by `python -m oramacore_tpu_torch.benches.attention_bench --wide
    --baseline` and `... .train_bench --wide --baseline`.) Returns {label:
    numbers} of the wide cases."""
    import torch

    from oramacore_tpu_torch.benches import (
        H100_F32_OPS_PER_S,
        H100_TF32X3_OPS_PER_S,
        bound_ms,
        time_cuda,
        time_graph,
    )
    from oramacore_tpu_torch.benches.attention_bench import wide_kernel
    from oramacore_tpu_torch.benches.encoder_bench import (
        WIDTH_CASES,
        attention_inputs,
        attention_reference,
    )
    from oramacore_tpu_torch.benches.pruned_bench import time_cold
    from oramacore_tpu_torch.benches.train_bench import (
        BWD_TOL,
        SdpaBackward,
        backward_inputs,
        backward_reference,
        backward_work,
        current_parts,
    )
    from oramacore_tpu_torch.ops import attention as at

    names = ("encoder_attention", "encoder_attention_backward_dq",
             "encoder_attention_backward_dkv")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {}
    for i, (label, case) in enumerate(WIDTH_CASES.items()):
        B, L, H, hd = case["B"], case["L"], case["H"], case["hd"]
        qkv, mask = attention_inputs(case, 150 + i, device)
        launches = at.LAUNCHES["encoder_attention"]
        plain = at.PLAIN_WIDTH_CALLS["encoder_attention_plain"]
        how = at.route(hd)
        got = at.encoder_attention(qkv, mask, H)
        sync(device)
        launched = at.LAUNCHES["encoder_attention"] - launches
        err = float((got.double() - attention_reference(qkv, mask, H))
                    .abs().max())
        check(launched == 1 and bool(torch.isfinite(got).all())
              and err <= ATTN_TOL
              and at.PLAIN_WIDTH_CALLS["encoder_attention_plain"] == plain,
              f"encoder_attention [{label}]: route {how}, {launched} kernel "
              f"launch(es), max abs err {err:.3g} against the f64 plain "
              f"version [{card}]")
        if how != "wide":
            continue
        _, _, dctx = backward_inputs(case, 170 + i, device)
        before = {n: at.LAUNCHES[n] for n in names}
        dgot = at.encoder_attention_backward(qkv, mask, dctx, H)
        sync(device)
        d_launched = {n: at.LAUNCHES[n] - before[n] for n in names[1:]}
        dref = backward_reference(qkv, mask, dctx, H)
        derr = float((dgot.double() - dref).abs().max())
        tl = at.wide_backward_tiles_for(B, H, L, hd)
        check(all(v == 1 for v in d_launched.values())
              and bool(torch.isfinite(dgot).all())
              and torch.allclose(dgot.double(), dref, rtol=BWD_TOL,
                                 atol=BWD_TOL),
              f"encoder_attention_backward [{label}]: route {how} ({tl.rows} "
              f"rows a block, chunks of {tl.chunk} columns), launches "
              f"{d_launched}, dQ, dK, dV within rtol/atol {BWD_TOL} of the "
              f"f64 reference (max abs err {derr:.3g}) [{card}]")
        fwd_ms = time_graph(lambda: at.encoder_attention(qkv, mask, H), 10)
        bwd_ms = time_graph(lambda: at.encoder_attention_backward(
            qkv, mask, dctx, H), 5)
        # each kernel alone on the operands the wrapper gives it
        fwd_cold = time_cold(wide_kernel(qkv, mask, H, None), flush, 3)
        launch = current_parts(qkv, mask, dctx, H, wide=True)
        cold = {k: time_cold(lambda k=k: launch(k), flush, 3)
                for k in ("dq", "dkv")}
        plain_ms = time_cuda(lambda: at.encoder_attention_plain(qkv, mask,
                                                                H), 3)
        bplain_ms = time_cuda(lambda: at.encoder_attention_backward_plain(
            qkv, mask, dctx, H), 3)
        lib_ms, _ = sdpa_ms(qkv, mask, H, 10)
        lib = SdpaBackward(qkv, mask, dctx, H, flush)
        lib_bwd = time_cuda(lib.graph.replay, 5)
        lib_cold = time_cuda(lib.cold_graph.replay, 3) - time_graph(
            flush.zero_, 3)
        del lib
        f_bytes, f_ops = at.attention_work(B, L, H, hd)
        f_bound = bound_ms(f_bytes, f_ops, H100_TF32X3_OPS_PER_S)
        f_ffma = bound_ms(f_bytes, f_ops, H100_F32_OPS_PER_S)[0]
        work = backward_work(B, L, H, hd)
        b_bound = bound_ms(*work["total"], H100_TF32X3_OPS_PER_S)
        b_ffma = bound_ms(*work["total"], H100_F32_OPS_PER_S)[0]
        print(f"  wide [{label}]: forward {fwd_ms:.4f} ms (plain "
              f"{plain_ms:.4f}, scaled_dot_product_attention {lib_ms:.4f}; "
              f"bound {f_bound[0]:.4f} ms {f_bound[1]} at the 3xTF32 rate, "
              f"{f_ffma:.4f} at the FFMA rate); backward {bwd_ms:.4f} ms "
              f"(plain {bplain_ms:.4f}, SDPA's backward {lib_bwd:.4f}; bound "
              f"{b_bound[0]:.4f} ms {b_bound[1]}, FFMA rate {b_ffma:.4f}); "
              f"max abs err forward "
              f"{err:.3g}, backward {derr:.3g}, warm [{card}]", flush=True)
        tf = at.wide_tiles_for(B, H, L, at.wide_width(hd))
        print(f"  wide [{label}] encoder_attention alone ({tf.rows} query "
              f"rows a block, chunks of {tf.chunk} columns): {fwd_cold:.4f} "
              f"ms L2-cold; bound {f_bound[0]:.4f} ms ({f_bound[1]} at the "
              f"3xTF32 rate), {100 * f_bound[0] / fwd_cold:.1f}% of it "
              f"[FFMA rate {f_ffma:.4f} ms, {100 * f_ffma / fwd_cold:.1f}%] "
              f"[{card}]", flush=True)
        kernels = {"forward": dict(ms=fwd_cold, bound_ms=f_bound[0],
                                   bound_by=f_bound[1])}
        for k in ("dq", "dkv"):
            bd = bound_ms(*work[k], H100_TF32X3_OPS_PER_S)
            bf = bound_ms(*work[k], H100_F32_OPS_PER_S)[0]
            kernels[k] = dict(ms=cold[k], bound_ms=bd[0], bound_by=bd[1])
            print(f"  wide [{label}] encoder_attention_backward_{k} alone: "
                  f"{cold[k]:.4f} ms L2-cold; bound {bd[0]:.4f} ms ({bd[1]} "
                  f"at the 3xTF32 rate), {100 * bd[0] / cold[k]:.1f}% of it "
                  f"[FFMA rate {bf:.4f} ms, {100 * bf / cold[k]:.1f}%] "
                  f"[{card}]", flush=True)
        print(f"  wide [{label}] dq + dkv {sum(cold.values()):.4f} ms "
              f"L2-cold, plain {bplain_ms:.4f} ms, SDPA's backward "
              f"{lib_cold:.4f} ms L2-cold [{card}]", flush=True)
        out[label] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, plain_ms=plain_ms,
                          bwd_plain_ms=bplain_ms, sdpa_ms=lib_ms,
                          sdpa_bwd_ms=lib_bwd, sdpa_bwd_cold_ms=lib_cold,
                          fwd_bound=f_bound[0],
                          bwd_bound=b_bound[0], err=err, bwd_err=derr,
                          kernels=kernels)
    del flush
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


def synonym_checks(encs, base="SemanticBase", mini="SemanticMini"):
    """tests/test_semantic_encoder.py's synonym (:46-56) and phrase
    (:59-88) checks on the card's vectors: `encs` maps a name to an
    encoder; the phrase margin of `base` must beat `mini`'s."""
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
    check(margins[base] > margins[mini] + 0.02 and margins[base] > 0.4,
          f"phrase margins: {base} {margins[base]:.4f}, {mini} "
          f"{margins[mini]:.4f}")


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
    # the references take the rows as the index holds them: insert
    # normalizes each vector, which moves a few elements of the encoder's
    # unit vectors across a bf16 rounding boundary
    vecs = vidx._committed_matrix
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


def code_parser_outputs(mod) -> str:
    """JSON of `mod.CodeParser().parse` on each of CODE_SOURCES and
    `mod.extract_tool_params` on each of TOOL_SOURCES (mod: a code_parser
    module, the port's here, the JAX package's in the CPU tests)."""
    import dataclasses

    parsed = {name: [dataclasses.astuple(t)
                     for t in mod.CodeParser().parse(src)]
              for name, src in CODE_SOURCES.items()}
    tools = [mod.extract_tool_params(src) for src in TOOL_SOURCES]
    return json.dumps({"parse": parsed, "tools": tools}, sort_keys=True)


def code_parser_checks():
    """The port's code parser (utils/code_parser.py, which no path of the
    port imports) on the sources of the repo's code-parser tests, held to
    the outputs the CPU tests pin (CODE_PARSER_DIGEST)."""
    import hashlib

    from oramacore_tpu_torch.utils import code_parser

    out = code_parser_outputs(code_parser)
    got = hashlib.sha256(out.encode("utf-8")).hexdigest()
    kinds = {(k, v) for name in CODE_SOURCES
             for k, v, *_ in json.loads(out)["parse"][name]}
    check(got == CODE_PARSER_DIGEST and ("function", "realFn") in kinds
          and ("function", "fakeFn") not in kinds,
          f"code_parser: CodeParser().parse of {len(CODE_SOURCES)} sources "
          f"({', '.join(CODE_SOURCES)}; {len(kinds)} tokens) and "
          f"extract_tool_params of {len(TOOL_SOURCES)} equal the outputs the "
          f"CPU tests pin (SHA-256 {got[:16]})")


def snowball_checks(card):
    """The 14 Snowball locales of the port's TextParser (its own copy of
    NLTK's stemmers; the card's machine has no nltk): each parser stems its
    locale's seeded vocabulary (benches/stem_vocab.py, about 2,000 words)
    through tokenize_and_stem, held to the committed SHA-256 of NLTK's
    stems; the route's words/s on the host."""
    from oramacore_tpu_torch.benches import stem_vocab as sv
    from oramacore_tpu_torch.types import Locale
    from oramacore_tpu_torch.utils import snowball
    from oramacore_tpu_torch.utils.tokenizer import TextParser

    n, secs, bad = 0, 0.0, []
    for lang in snowball.LANGUAGES:
        parser = TextParser(Locale(lang), use_native=False)
        words = sv.vocabulary(lang)
        t0 = time.perf_counter()
        parsed = parser.tokenize_and_stem(" ".join(words))
        secs += time.perf_counter() - t0
        n += len(words)
        stems = [v[0] if v else t for t, v in parsed]
        if parser.stemmer != "snowball" or len(parsed) != len(words) or \
                sv.digest(words, stems) != sv.DIGESTS[lang]:
            bad.append(lang)
    check(not bad, f"Snowball: the {len(snowball.LANGUAGES)} locales' parsers "
                   f"stem their seeded vocabularies ({n:,} words) as NLTK "
                   f"3.10.0 does (per-locale SHA-256 equal to the committed "
                   f"table){'; differ: ' + ', '.join(bad) if bad else ''}")
    print(f"  Snowball route (Python, tokenize_and_stem, a fresh parser a "
          f"locale): {n:,} words in {secs:.2f} s, {n / secs:,.0f} words/s "
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
    check(sorted(kinds.get("snowball", [])) == sorted(
        TextParser._SNOWBALL_LANGS),
          f"the {len(TextParser._SNOWBALL_LANGS)} NLTK locales stem with "
          f"Snowball (the port's own)")
    snowball_checks(card)
    code_parser_checks()
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


# ---------------------------------------------------------------------------
# training the text encoder (phase 16)
# ---------------------------------------------------------------------------

def backward_checks(device, card, cases=None):
    """Both backward kernels against their f64 reference at every case of
    benches/train_bench.py (the training call first), or at `cases`,
    each timed as
    CUDA-graph replays, the pair and each part alone, warm and L2-cold,
    beside its bound (bytes against FLOPs at the 3xTF32 tensor-core rate,
    as the kernels run their products; the share of the f32 FFMA-rate
    bound, which the earlier SIMT design was held to, in brackets), the plain
    version and the backward of scaled_dot_product_attention on the same
    inputs, also CUDA-graph replays, warm and L2-cold. The kernels line
    takes the training call, L2-cold."""
    import torch

    from oramacore_tpu_torch.benches import (
        H100_F32_OPS_PER_S,
        H100_TF32X3_OPS_PER_S,
        bound_ms,
        time_cuda,
        time_graph,
    )
    from oramacore_tpu_torch.benches.pruned_bench import time_cold
    from oramacore_tpu_torch.benches.train_bench import (
        BACKWARD_CASES,
        BWD_TOL,
        backward_inputs,
        backward_reference,
        backward_work,
        SdpaBackward,
    )
    from oramacore_tpu_torch.ops import attention as at

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out, errs = {}, {"dq": [], "dkv": []}
    for i, (label, case) in enumerate((cases or BACKWARD_CASES).items()):
        B, L, H, hd = case["B"], case["L"], case["H"], case["hd"]
        D = H * hd
        qkv, mask, dctx = backward_inputs(case, 160 + i, device)
        got = at.encoder_attention_backward(qkv, mask, dctx, H)
        ref = backward_reference(qkv, mask, dctx, H)
        sync(device)
        diff = (got.double() - ref).abs()
        err = {"dq": float(diff[..., :D].max()),
               "dkv": float(diff[..., D:].max())}
        for k, v in err.items():
            errs[k].append(v)
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got.double(), ref, rtol=BWD_TOL, atol=BWD_TOL),
            f"encoder_attention_backward [{label}]: dQ, dK, dV within "
            f"rtol/atol {BWD_TOL} of the f64 reference (max abs err dQ "
            f"{err['dq']:.3g}, dK/dV {err['dkv']:.3g}; largest |grad| "
            f"{float(ref.abs().max()):.3g})")
        work = backward_work(B, L, H, hd)
        bounds = {k: bound_ms(*w, H100_TF32X3_OPS_PER_S)
                  for k, w in work.items()}
        ffma = {k: bound_ms(*w, H100_F32_OPS_PER_S)[0]
                for k, w in work.items()}
        dqkv, stats = at.launch_backward(qkv, mask, dctx, H)
        parts = {
            "total": lambda: at.encoder_attention_backward(qkv, mask, dctx,
                                                           H),
            "dq": lambda: at.launch_backward(qkv, mask, dctx, H, ("dq",),
                                             dqkv, stats),
            "dkv": lambda: at.launch_backward(qkv, mask, dctx, H, ("dkv",),
                                              dqkv, stats),
        }
        warm = {k: time_graph(fn, 10) for k, fn in parts.items()}
        cold = {k: time_cold(fn, flush, 5) for k, fn in parts.items()}
        plain_ms = time_cuda(lambda: at.encoder_attention_backward_plain(
            qkv, mask, dctx, H), 3)
        lib = SdpaBackward(qkv, mask, dctx, H, flush)
        lib_warm = time_cuda(lib.graph.replay, 10)
        lib_cold = time_cuda(lib.cold_graph.replay, 5) - time_graph(
            flush.zero_, 5)
        lib_err = float((lib.dqkv.double() - ref).abs().max())
        del lib
        print(f"  encoder_attention_backward [{label}]: both kernels "
              f"{warm['total']:.4f} ms warm, {cold['total']:.4f} ms L2-cold "
              f"(dq {warm['dq']:.4f} / {cold['dq']:.4f}, dkv "
              f"{warm['dkv']:.4f} / {cold['dkv']:.4f}); plain "
              f"{plain_ms:.4f} ms; library: autograd.grad of "
              f"scaled_dot_product_attention (additive f32 mask), backward "
              f"alone {lib_warm:.4f} ms warm, {lib_cold:.4f} ms L2-cold "
              f"(max abs err {lib_err:.3g}); bound "
              f"{bounds['total'][0]:.4f} ms ({bounds['total'][1]}: "
              f"{work['total'][0] / 1e6:.1f} MB, "
              f"{work['total'][1] / 1e9:.2f} GFLOP at the 3xTF32 rate; dq "
              f"{bounds['dq'][0]:.4f}, dkv {bounds['dkv'][0]:.4f}) [FFMA "
              f"rate: {ffma['total']:.4f} ms, dq {ffma['dq']:.4f}, dkv "
              f"{ffma['dkv']:.4f}] [{card}]", flush=True)
        share(f"encoder_attention_backward [{label}], L2-cold",
              cold["total"], *bounds["total"], card)
        print("    L2-cold, " + ", ".join(
            f"{k}: {100 * bounds[k][0] / cold[k]:.1f}% of its 3xTF32 bound "
            f"[{100 * ffma[k] / cold[k]:.1f}% of its FFMA-rate one]"
            for k in ("dq", "dkv", "total")) + f" [{card}]", flush=True)
        if i == 0:
            for k in ("dq", "dkv"):
                out[f"encoder_attention_backward_{k}"] = dict(
                    ms=cold[k], plain_ms=plain_ms, bound_ms=bounds[k][0],
                    bound_by=bounds[k][1], library_ms=lib_cold)
    del flush
    for k in ("dq", "dkv"):
        out[f"encoder_attention_backward_{k}"]["max_abs_err"] = max(errs[k])
    return out


def phase_train(device, card):
    """Phase 16: the backward kernels against their plain version and
    timed; SemanticBase trained at the script's defaults through
    train.semantic_encoder (seed 0; TRAIN_STEPS of the script's 1,500
    steps), launch counts checked,
    steady step time, one profiled step, the validation probes; the first
    steps held card against CPU, and WIDE_TRAIN_STEPS steps at --hidden
    256 --heads 1 through the wide kernels (`wide_train_checks`); the
    checkpoint saved under build/, loaded through load_torch_encoder,
    checked (probes, synonyms, phrases) and searched with. Returns
    (timings, the run's launch counts)."""
    import torch

    from oramacore_tpu_torch.benches.encoder_bench import (
        passages,
        vocab_words,
    )
    from oramacore_tpu_torch.benches.train_bench import StepTimer
    from oramacore_tpu_torch.embeddings import encoder as em
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )
    from oramacore_tpu_torch.train import semantic_encoder as se

    timings = backward_checks(device, card)

    cfg = se.TrainConfig(steps=TRAIN_STEPS)
    print(f"  training: {cfg} (the script's defaults but the steps)",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = se.SemanticTrainer(cfg, device)
    timer = StepTimer()

    def run():
        timer.mark()
        return trainer.run(log=lambda line: print(f"  {line}", flush=True),
                           on_step=timer.mark)

    logged, launches = counted("training", run)
    secs = time.perf_counter() - t0
    calls = cfg.steps * 2 * cfg.layers
    check(all(launches[k] == calls for k in (
        "encoder_attention", "encoder_attention_backward_dq",
        "encoder_attention_backward_dkv")),
        f"{cfg.steps} steps launched encoder_attention and both backward "
        f"kernels {calls} times each (2 encoder calls x {cfg.layers} "
        f"layers a step)")
    step_ms = timer.step_ms()
    steady = float(np.median(step_ms[10:]))
    print(f"  {cfg.steps} steps in {secs:.2f} s ({cfg.steps / secs:.1f} "
          f"steps/s over the whole window, the host's batches included); "
          f"step (device timeline between steps, after step 10) median "
          f"{steady:.3f} ms, p90 "
          f"{float(np.percentile(step_ms[10:], 90)):.3f} ms; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"[{card}]", flush=True)
    losses = [row[1] for row in logged]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the loss fell from {losses[0]:.4f} to {losses[-1]:.4f} (pair "
          f"accuracy {logged[0][2]:.3f} -> {logged[-1][2]:.3f})")
    cos = trainer.validate()
    check(True, "validation probes: " + ", ".join(
        f"cos({k.replace('~', ', ')}) {c:.3f}" for k, c in cos.items())
          + " (car~automobile beats car~doctor by more than 0.2)")
    batch = trainer.next_batch()
    # past the schedule's end the rate is 0: these steps move Adam's
    # moments only, not the parameters
    before = {k: p.detach().clone() for k, p in
              trainer.model.named_parameters()}
    profile_once("one training step", lambda: trainer.step(batch), card)
    check(all(torch.equal(p, before[k]) for k, p in
              trainer.model.named_parameters()),
          "the profiled steps (rate 0 past the schedule) left the trained "
          "parameters as they were")

    # the first steps of the same run, card against CPU
    state0 = se.init_state(cfg, len(se.vocab_tokens()),
                           torch.Generator().manual_seed(se.SEED))
    on_card = se.SemanticTrainer(cfg, device, state=state0)
    on_cpu = se.SemanticTrainer(cfg, "cpu", state=state0)
    worst = 0.0
    for i in range(TRAIN_COMPARE):
        b_card, b_cpu = on_card.next_batch(), on_cpu.next_batch()
        l_card = float(on_card.step(b_card)[0])
        l_cpu = float(on_cpu.step(b_cpu)[0])
        worst = max(worst, abs(l_card - l_cpu))
    held, what = params_card_vs_cpu(on_card, on_cpu, state0,
                                    TRAIN_PARAM_TOL)
    check(worst <= TRAIN_LOSS_TOL and held,
          f"{TRAIN_COMPARE} steps on the card (kernels) and on the CPU (plain "
          f"versions) from one set of parameters and the same batches: losses "
          f"within {TRAIN_LOSS_TOL} (max |d| {worst:.3g}), {what}")
    del on_card, on_cpu
    wide_train_checks(device, card)

    # serve the trained checkpoint
    out = os.path.join(ROOT, "build", "trained", "semantic-base-smoke")
    trainer.save(out)
    enc = em.load_torch_encoder(out, device)
    check(enc is not None and enc.dim == cfg.hidden
          and enc.n_heads == cfg.heads,
          f"the trained checkpoint saved to build/trained/ and loaded "
          f"through load_torch_encoder ({cfg.layers} layers, width "
          f"{enc.dim}, {enc.n_heads} heads)")
    served = np.stack(enc.encode(se.PROBES))
    own = trainer.embed(se.PROBES)
    err = float(np.abs(served - own).max())
    check(err <= ENC_ATOL and float(served[0] @ served[1])
          > float(served[0] @ served[2]) + 0.2,
          f"served probes within {ENC_ATOL} of the trainer's (max |d| "
          f"{err:.3g}); cos(car, automobile) {float(served[0] @ served[1]):.3f}"
          f" > cos(car, doctor) {float(served[0] @ served[2]):.3f} + 0.2")
    mini = em.load_torch_encoder(os.path.join(ROOT, "models", "semantic-mini"),
                                 device)
    synonym_checks({"trained SemanticBase": enc, "SemanticMini": mini},
                   base="trained SemanticBase")
    words = vocab_words(os.path.join(out, "vocab.txt"))
    corpus = passages(words, TRAIN_PASSAGES, seed=TRAIN_SEED)
    qtexts = passages(words, ENC_SEARCH_B * (1 + VEC_STEADY),
                      seed=TRAIN_SEED + 1, n_words=(2, 4))
    vecs = np.stack(enc.encode(corpus))
    vidx = VectorIndex(VectorIndexConfig(dim=enc.dim), device)
    for d, v in enumerate(vecs):
        vidx.insert(d, [v])
    vidx.commit()
    qb = [np.stack(enc.encode(qtexts[j * ENC_SEARCH_B:(j + 1) * ENC_SEARCH_B]))
          for j in range(1 + VEC_STEADY)]
    print(f"  {len(corpus)} passages and {len(qtexts)} queries embedded with "
          f"the trained model", flush=True)
    # the rows as the index holds them (insert normalizes them)
    phase_flat(vidx, bf16_round(vidx._committed_matrix), qb, device, card)
    return timings, launches


def wide_train_checks(device, card):
    """Phase 16 at the script's --hidden 256 --heads 1: one head of 256 a
    layer, so every attention call of a step runs the wide forward and
    both wide backward kernels (one launch of each per encoder call and
    layer). WIDE_TRAIN_STEPS steps from one set of parameters, card
    against CPU (plain versions) on the same batches, held by the rule of
    the default width's steps: losses within TRAIN_LOSS_TOL, parameters
    within TRAIN_PARAM_TOL, and the first step's gradients leaf by leaf
    within TPU_TRAIN_GRAD_REL (phase 21's `grads_card_vs_cpu`)."""
    import torch

    from oramacore_tpu_torch.ops import attention as at
    from oramacore_tpu_torch.train import semantic_encoder as se

    cfg = se.TrainConfig(steps=TRAIN_STEPS, heads=1)
    hd = cfg.hidden // cfg.heads
    check(at.route(hd) == "wide", f"--hidden {cfg.hidden} --heads "
          f"{cfg.heads} gives heads of {hd}, the wide route")
    state0 = se.init_state(cfg, len(se.vocab_tokens()),
                           torch.Generator().manual_seed(se.SEED))
    on_card = se.SemanticTrainer(cfg, device, state=state0)
    on_cpu = se.SemanticTrainer(cfg, "cpu", state=state0)

    def steps():
        worst, grads = 0.0, None
        for i in range(WIDE_TRAIN_STEPS):
            b_card, b_cpu = on_card.next_batch(), on_cpu.next_batch()
            l_card = float(on_card.step(b_card)[0])
            worst = max(worst, abs(l_card - float(on_cpu.step(b_cpu)[0])))
            if i == 0:
                # Adam's first steps cannot show a gradient of the wrong
                # size in the parameters: hold the gradients themselves
                grads = grads_card_vs_cpu(on_card, on_cpu,
                                          TPU_TRAIN_GRAD_REL)
        return worst, grads

    (worst, (grads_held, grads_what)), launches = counted(
        f"hd {hd} training", steps)
    calls = WIDE_TRAIN_STEPS * 2 * cfg.layers
    check(all(launches[k] == calls for k in (
        "encoder_attention", "encoder_attention_backward_dq",
        "encoder_attention_backward_dkv")),
        f"{WIDE_TRAIN_STEPS} steps at --hidden {cfg.hidden} --heads "
        f"{cfg.heads} launched the wide forward and both wide backward "
        f"kernels {calls} times each (2 encoder calls x {cfg.layers} layers "
        f"a step)")
    held, what = params_card_vs_cpu(on_card, on_cpu, state0,
                                    TRAIN_PARAM_TOL)
    check(worst <= TRAIN_LOSS_TOL and grads_held and held,
          f"{WIDE_TRAIN_STEPS} steps at hd {hd} on the card (the wide "
          f"kernels) and on the CPU (plain versions) from one set of "
          f"parameters and the same batches: losses within "
          f"{TRAIN_LOSS_TOL} (max |d| {worst:.3g}); {grads_what}; {what} "
          f"[{card}]")


def params_card_vs_cpu(on_card, on_cpu, start, tol):
    """Phases 16 and 21: every parameter of the card's trainer within tol
    of the CPU trainer's (max |d|). Returns (held, what)."""
    got = {k: p.detach().cpu() for k, p in on_card.model.named_parameters()}
    want = {k: p.detach() for k, p in on_cpu.model.named_parameters()}
    worst = max(float((got[k] - w).abs().max()) for k, w in want.items())
    moved = max(float((w - start[k]).abs().max()) for k, w in want.items())
    return worst <= tol, (f"parameters within {tol} (max |d| {worst:.3g}; "
                          f"the steps moved them up to {moved:.3g})")


def grads_card_vs_cpu(on_card, on_cpu, rel):
    """The gradients of the trainers' last step, leaf by leaf, card
    against CPU: each within rel of the CPU leaf's largest magnitude (the
    rule of tests/test_torch_train_tpu.py). Returns (held, what)."""
    want = {k: p.grad for k, p in on_cpu.model.named_parameters()}
    errs = {}
    for k, p in on_card.model.named_parameters():
        scale = max(float(want[k].abs().max()), 1e-12)
        errs[k] = (float((p.grad.cpu() - want[k]).abs().max()), scale)
    name = max(errs, key=lambda k: errs[k][0] / errs[k][1])
    err, scale = errs[name]
    return all(e <= rel * c for e, c in errs.values()), (
        f"the first step's gradients of all {len(errs)} leaves within {rel} "
        f"of each leaf's largest (worst {name}: max |d| {err:.3g} of "
        f"{scale:.3g})")


def phase_train_tpu(device, card):
    """Phase 21: train/semantic_encoder_tpu.py at the full width of
    scripts/train_semantic_encoder_tpu.py (6 layers, width 256, 8 heads of
    32, B=256 pairs as one (512, 32) batch a step, seed 0): the attention
    forward and both backward kernels at that shape against their f64
    references, timed (CUDA-graph replays, L2-cold) beside the 3xTF32
    bound and scaled_dot_product_attention's forward and backward; the
    run (TPU_TRAIN_STEPS steps) with its launches, steps/s, median and p90
    step, one profiled step (device ms, idle share; profiled launches held
    to LAUNCHES) and peak memory; the validation probes of both tiers; the
    first TPU_TRAIN_COMPARE steps card against CPU (losses, the first
    step's gradients, then the parameters); the checkpoint saved
    under build/, reloaded in TorchTextEncoder and probed again. Returns
    the run's launch counts."""
    import torch

    from oramacore_tpu_torch.benches.train_bench import StepTimer
    from oramacore_tpu_torch.embeddings import encoder as em
    from oramacore_tpu_torch.train import semantic_encoder as se
    from oramacore_tpu_torch.train import semantic_encoder_tpu as tpu

    cfg = tpu.TpuTrainConfig(steps=TPU_TRAIN_STEPS)
    case = dict(B=2 * cfg.batch, L=cfg.seq, H=cfg.heads,
                hd=cfg.hidden // cfg.heads, padded=0)
    label = (f"train_semantic_encoder_tpu B={case['B']} L={case['L']} "
             f"H={case['H']} hd={case['hd']}")
    attention_checks(device, card, {label: case})
    backward_checks(device, card, {label: case})

    print(f"  training: {cfg} (the script's defaults but the steps)",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = tpu.TpuScriptTrainer(cfg, device)
    timer = StepTimer()

    def run():
        timer.mark()
        return trainer.run(log_every=200,
                           log=lambda line: print(f"  {line}", flush=True),
                           on_step=timer.mark)

    logged, launches = counted("train_semantic_encoder_tpu", run)
    secs = time.perf_counter() - t0
    calls = cfg.steps * cfg.layers
    check(all(launches[k] == calls for k in (
        "encoder_attention", "encoder_attention_backward_dq",
        "encoder_attention_backward_dkv")),
        f"{cfg.steps} steps launched encoder_attention and both backward "
        f"kernels {calls} times each (one encoder call x {cfg.layers} "
        f"layers a step)")
    step_ms = timer.step_ms()[10:]
    print(f"  {cfg.steps} steps in {secs:.2f} s ({cfg.steps / secs:.2f} "
          f"steps/s over the whole window, the host's batches and the "
          f"model's set-up included); step (device timeline between steps, "
          f"after step 10) median {float(np.median(step_ms)):.3f} ms, p90 "
          f"{float(np.percentile(step_ms, 90)):.3f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]",
          flush=True)
    losses = [row[1] for row in logged]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the loss fell from {losses[0]:.4f} to {losses[-1]:.4f} (pair "
          f"accuracy {logged[0][2]:.3f} -> {logged[-1][2]:.3f})")
    cos = trainer.validate()
    check(True, "validation probes of both tiers: " + ", ".join(
        f"cos({k.replace('~', ', ')}) {c:.3f}" for k, c in cos.items())
          + " (each synonym beats its cross-concept word by more than 0.2)")
    batch = trainer.next_batch()
    # past the schedule's end the rate is 0: the profiled steps move
    # Adam's moments only
    before = {k: p.detach().clone() for k, p in
              trainer.model.named_parameters()}
    profile_once("one step of train_semantic_encoder_tpu",
                 lambda: trainer.step(batch), card)
    check(all(torch.equal(p, before[k]) for k, p in
              trainer.model.named_parameters()),
          "the profiled steps (rate 0 past the schedule) left the trained "
          "parameters as they were")

    # the first steps of the same run, card against CPU
    state0 = tpu.init_state(cfg, len(tpu.vocab_tokens()),
                            torch.Generator().manual_seed(se.SEED))
    on_card = tpu.TpuScriptTrainer(cfg, device, state=state0)
    on_cpu = tpu.TpuScriptTrainer(cfg, "cpu", state=state0)
    worst = 0.0
    t0 = time.perf_counter()
    for i in range(TPU_TRAIN_COMPARE):
        b_card, b_cpu = on_card.next_batch(), on_cpu.next_batch()
        l_card = float(on_card.step(b_card)[0])
        l_cpu = float(on_cpu.step(b_cpu)[0])
        worst = max(worst, abs(l_card - l_cpu))
        if i == 0:
            # Adam divides a gradient by its running magnitude, so the
            # parameters after these small steps cannot tell a gradient of
            # the wrong size: hold the first step's gradients themselves
            grads_held, grads_what = grads_card_vs_cpu(on_card, on_cpu,
                                                       TPU_TRAIN_GRAD_REL)
    held, what = params_card_vs_cpu(on_card, on_cpu, state0, TRAIN_PARAM_TOL)
    check(worst <= TRAIN_LOSS_TOL and grads_held and held,
          f"{TPU_TRAIN_COMPARE} steps at full width on the card (kernels) "
          f"and on the CPU (plain versions, {time.perf_counter() - t0:.1f} s) "
          f"from one set of parameters and the same batches: losses within "
          f"{TRAIN_LOSS_TOL} (max |d| {worst:.3g}); {grads_what}; {what}")
    del on_card, on_cpu

    # save, reload in the serving encoder, probe again
    trainer.save(TPU_TRAIN_OUT)
    cos = tpu.reload_check(TPU_TRAIN_OUT, device)
    enc = em.TorchTextEncoder(TPU_TRAIN_OUT, device)
    check(enc.dim == cfg.hidden and enc.n_heads == cfg.heads
          and enc.max_len == cfg.max_len
          and len(enc.model.layers) == cfg.layers,
          f"the checkpoint saved to build/trained/ and reloaded in "
          f"TorchTextEncoder ({cfg.layers} layers, width {enc.dim}, "
          f"{enc.n_heads} heads, max_position_embeddings {enc.max_len}): "
          f"cos(car, automobile) {cos['car~automobile']:.3f} > cos(car, "
          f"doctor) {cos['car~doctor']:.3f} + 0.2")
    return launches


# ---------------------------------------------------------------------------
# the runtime: write side, op log, read side (phase 17)
# ---------------------------------------------------------------------------

def rs_config(data_dir, pruning="auto"):
    """The runtime's config for phase 17: defaults, with commits left to
    the script (the per-collection thresholds would otherwise commit
    every 10,000 ops during the ingest)."""
    from oramacore_tpu_torch.config import OramacoreConfig

    cfg = OramacoreConfig()
    cfg.data_dir = data_dir
    cfg.auth.master_api_key = RS_MASTER
    big = 1 << 40
    cfg.writer_side.insert_batch_commit_size = big
    cfg.reader_side.insert_batch_commit_size = big
    cfg.reader_side.operation_threshold = big
    cfg.reader_side.time_threshold = float(big)
    cfg.reader_side.pruning = pruning
    return cfg


def rs_cases(qtexts, ptexts):
    """(single searches, batches) of phase 17: name -> (collection,
    SearchParams JSON), name -> (collection, [SearchParams JSON])."""
    from oramacore_tpu_torch.benches import ingest_bench as ib

    g = ib.GENRES
    ranges = [{"from": 10 * i, "to": 10 * i + 10} for i in range(8)]
    singles = {f"fulltext {i}": ("games", {"term": qtexts[i]})
               for i in range(RS_SINGLE)}
    kinds = {
        "price range": lambda q, i: {
            "term": q, "where": {"price": {"between": [20, 45]}}},
        "genre": lambda q, i: {"term": q, "where": {"genre": g[i % len(g)]}},
        "price and genre": lambda q, i: {"term": q, "where": {
            "genre": [g[i % len(g)], g[(i + 7) % len(g)]],
            "price": {"lt": 50}}},
        "facets": lambda q, i: {"term": q, "facets": {
            "genre": {}, "price": {"ranges": ranges}}},
        "sort asc": lambda q, i: {"term": q, "limit": 20, "sortBy": {
            "property": "price", "order": "asc"}},
        "sort desc": lambda q, i: {"term": q, "limit": 20, "sortBy": {
            "property": "price", "order": "desc"}},
        "group by genre": lambda q, i: {"term": q, "groupBy": {
            "properties": ["genre"], "maxResults": 3}},
        "tolerance 1": lambda q, i: {"term": q, "tolerance": 1},
        "exact": lambda q, i: {"term": q, "exact": True},
        "pinned": lambda q, i: {"term": "pinned " + q},
        "vector": lambda q, i: {"mode": "vector", "term": q,
                                "similarity": RS_SIM},
        "hybrid": lambda q, i: {"mode": "hybrid", "term": q,
                                "similarity": RS_SIM},
    }
    at = RS_SINGLE
    for kind, make in kinds.items():
        for i in range(RS_KIND_QUERIES):
            singles[f"{kind} {i}"] = ("games", make(qtexts[at % len(qtexts)],
                                                    i))
            at += 1
    for i in range(RS_KIND_QUERIES):
        singles[f"passages fulltext {i}"] = ("passages", {"term": ptexts[i]})
        singles[f"passages vector {i}"] = ("passages", {
            "mode": "vector", "term": ptexts[i], "similarity": RS_PASSAGE_SIM})
        singles[f"passages hybrid {i}"] = ("passages", {
            "mode": "hybrid", "term": ptexts[i],
            "similarity": RS_PASSAGE_SIM})
    qb = qtexts[:RS_VEC_B]
    batches = {
        f"batch fulltext B={len(qtexts)}": ("games", [
            {"term": q} for q in qtexts]),
        f"batch fulltext B={len(qb)}": ("games", [{"term": q} for q in qb]),
        f"batch genre B={len(qb)}": ("games", [
            {"term": q, "where": {"genre": g[i % len(g)]}}
            for i, q in enumerate(qb)]),
        f"batch sort B={len(qb)}": ("games", [
            {"term": q, "sortBy": {"property": "price", "order": "desc"}}
            for q in qb]),
        f"batch vector B={len(qb)}": ("games", [
            {"mode": "vector", "term": q, "similarity": RS_SIM} for q in qb]),
        f"batch hybrid B={len(qb)}": ("games", [
            {"mode": "hybrid", "term": q, "similarity": RS_SIM} for q in qb]),
        f"passages batch hybrid B={len(ptexts)}": ("passages", [
            {"mode": "hybrid", "term": q, "similarity": RS_PASSAGE_SIM}
            for q in ptexts]),
        f"passages batch vector B={len(ptexts)}": ("passages", [
            {"mode": "vector", "term": q, "similarity": RS_PASSAGE_SIM}
            for q in ptexts]),
    }
    return singles, batches


def rs_held_to_cpu(name, pruned=False):
    """The cases a CPU read side answers (its plain kernel versions take
    seconds a search at this size): the first RS_CPU_FULLTEXT single
    full-text searches, the first RS_CPU_KIND of every other kind, every
    batch; with pruning "on" one of each kind, no tolerance (each fuzzy
    variant span is a binary search per posting in the plain worklist)
    and no B=256 batch."""
    if name.startswith("batch") or name.startswith("passages batch"):
        return not (pruned and f"B={RS_QUERIES}" in name)
    kind, i = name.rsplit(" ", 1)
    if pruned:
        return kind != "tolerance 1" and int(i) < (
            RS_CPU_FULLTEXT // 2 if kind == "fulltext" else 1)
    return int(i) < (RS_CPU_FULLTEXT if kind == "fulltext" else RS_CPU_KIND)


def rs_answers(rs, singles, batches, only=None):
    """Every case through ReadSide.search / search_batch: name -> list of
    SearchResult."""
    from oramacore_tpu_torch.types import SearchParams

    out = {}
    for name, (coll, p) in singles.items():
        if only is None or only(name):
            out[name] = [rs.search(coll, RS_KEYS[coll][0],
                                   SearchParams.from_json(p))]
    for name, (coll, plist) in batches.items():
        if only is None or only(name):
            out[name] = rs.search_batch(
                coll, RS_KEYS[coll][0],
                [SearchParams.from_json(p) for p in plist])
    return out


def rs_hits_errors(a, b, label, rtol=1e-4, tie_rtol=1e-5):
    """Two pages of hits, `a` the reference: scores within rtol, ids
    equal outside runs of near-tied reference scores (inside a run the
    order is free; a run reaching the page's end may hold other docs),
    and equal documents under equal ids."""
    if len(a) != len(b):
        return [f"{label}: {len(b)} hits vs {len(a)}"]
    errs = []
    sa = np.array([h.score for h in a], np.float64)
    sb = np.array([h.score for h in b], np.float64)
    if not np.allclose(sb, sa, rtol=rtol, atol=1e-7):
        errs.append(f"{label}: scores {sb[:5]} vs {sa[:5]}")
    i, n = 0, len(a)
    while i < n:
        j = i + 1
        while j < n and abs(sa[j] - sa[i]) <= tie_rtol * max(abs(sa[i]), 1e-30):
            j += 1
        ia, ib_ = [h.id for h in a[i:j]], [h.id for h in b[i:j]]
        if j < n and sorted(ia) != sorted(ib_):
            errs.append(f"{label}: ranks {i}-{j - 1} {ib_} vs {ia}")
        i = j
    docs = {h.id: h.document for h in a}
    errs += [f"{label}: document of {h.id}" for h in b
             if h.id in docs and docs[h.id] != h.document]
    return errs


def rs_result_errors(a, b, label):
    """SearchResult `b` against `a`: the hits as above, count and
    count_estimated exact, facet counts exact, groups' labels exact and
    their hits as above."""
    errs = rs_hits_errors(a.hits, b.hits, label)
    if (a.count, a.count_estimated) != (b.count, b.count_estimated):
        errs.append(f"{label}: count {b.count} ({b.count_estimated}) vs "
                    f"{a.count} ({a.count_estimated})")
    fa = {k: v.values for k, v in (a.facets or {}).items()}
    fb = {k: v.values for k, v in (b.facets or {}).items()}
    if fa != fb:
        errs.append(f"{label}: facets {fb} vs {fa}")
    ga, gb = a.groups or [], b.groups or []
    if [x.values for x in ga] != [x.values for x in gb]:
        errs.append(f"{label}: group labels differ")
    else:
        for x, y in zip(ga, gb):
            errs += rs_hits_errors(x.result, y.result, f"{label} {x.values}")
    return errs


def rs_compare(ref, got, what):
    """Hold every case of `got` to `ref` (rs_result_errors)."""
    bad, n = [], 0
    for name, results in got.items():
        for qi, (a, b) in enumerate(zip(ref[name], results)):
            bad += rs_result_errors(a, b, f"{name}[{qi}]")
            n += 1
    report_check(bad, f"{what}: {n} searches ({len(got)} cases) agree: ids "
                      f"outside near-ties (1e-5), scores rtol 1e-4, counts, "
                      f"facet counts, groups, hydrated documents")
    return n


def rs_sanity(ans, what):
    """Every case answered with finite scores; the search kinds reached
    what they name (hits, facets, groups, pinned docs first)."""
    bad = []
    for name, results in ans.items():
        for r in results:
            if not all(np.isfinite(h.score) for h in r.hits):
                bad.append(f"{name}: a score is not finite")
    for name in (n for n in ans if n.endswith(" 0")):
        r = ans[name][0]
        if name.startswith(("fulltext", "facets", "group", "hybrid")) \
                and not r.hits:
            bad.append(f"{name}: no hits")
        if name.startswith("facets") and not r.facets["genre"].values:
            bad.append(f"{name}: no genre facet")
        if name.startswith("group") and r.hits and not r.groups:
            bad.append(f"{name}: no groups")
    report_check(bad, f"{what}: finite scores; full-text, hybrid, facet and "
                      f"group cases answered")


def rs_wait_searchable(orama, doc, coll="games"):
    """Seconds until `doc`, the last one sent, is a hit of a search for
    its own title (every word, exact). The read side's applied offset is
    polled every 10 ms until it reaches the write side's, then the search
    runs (a search on the live layer packs it anew after every applied
    op, so polling with searches would slow the consumer it waits for)."""
    from oramacore_tpu_torch.types import SearchParams

    ws, rs = orama.write_side, orama.read_side
    target = ws.op_sender.offset
    p = SearchParams.from_json({"term": doc["title"], "exact": True,
                                "threshold": 1.0, "limit": 1000})
    t0 = time.perf_counter()
    while True:
        if rs.live_offset >= target:
            res = rs.search(coll, RS_KEYS[coll][0], p)
            if any(h.id.endswith(":" + doc["id"]) for h in res.hits):
                return time.perf_counter() - t0
        if time.perf_counter() - t0 > 600:
            raise SmokeFailure(f"document {doc['id']} not searchable after "
                               f"600 s")
        time.sleep(0.01)


def rs_wait_applied(orama, timeout=900.0):
    """Wait until the read side has applied every op the write side sent
    (the embedding queue drained first)."""
    ws, rs = orama.write_side, orama.read_side
    if not ws.embedding_queue.flush_and_wait(timeout=timeout):
        raise SmokeFailure("the embedding queue did not drain")
    t0 = time.perf_counter()
    while rs.live_offset < ws.op_sender.offset:
        if time.perf_counter() - t0 > timeout:
            raise SmokeFailure("the read side did not apply the op log")
        time.sleep(0.01)


def rs_latency(rs, singles, card):
    """p50 / p99 of single ReadSide.search calls by mode (host clock)."""
    from oramacore_tpu_torch.types import SearchParams

    modes = {"fulltext": "fulltext ", "price range": "price range ",
             "facets": "facets ", "sort": "sort asc ",
             "group by": "group by genre ", "vector": "vector ",
             "hybrid": "hybrid ", "passages hybrid (SemanticBase)":
             "passages hybrid "}
    out = {}
    for mode, prefix in modes.items():
        names = [n for n in singles if n.startswith(prefix)]
        calls = [singles[names[i % len(names)]] for i in range(
            RS_SINGLE if mode == "fulltext" else RS_LATENCY_N)]
        ms = []
        for coll, p in calls:
            sp = SearchParams.from_json(p)
            t = time.perf_counter()
            rs.search(coll, RS_KEYS[coll][0], sp)
            ms.append((time.perf_counter() - t) * 1e3)
        out[mode] = (float(np.percentile(ms, 50)), float(np.percentile(ms, 99)))
        print(f"  ReadSide.search, {mode}: {len(ms)} calls, p50 "
              f"{out[mode][0]:.3f} ms, p99 {out[mode][1]:.3f} ms [{card}]",
              flush=True)
    return out


def rs_numpy_check(rs, qtexts):
    """N_RS_NUMPY plain queries: ReadSide.search's top-10 and count held
    to host_bm25_reference on the read side's committed index (the
    tokens and fields the read side plans)."""
    from oramacore_tpu_torch.index.search_exec import host_bm25_reference
    from oramacore_tpu_torch.types import SearchParams

    idx = rs.collections["games"].indexes["main"]
    props = [p for p, t in idx.field_types.items()
             if t.startswith("string") or t == "date"]
    n = float(idx.document_count())
    bad = []
    for b, q in enumerate(qtexts[:N_RS_NUMPY]):
        toks = [w for t, v in idx.parser.tokenize_and_stem(q) for w in [t] + v]
        ref = host_bm25_reference(idx.string, toks, props, {}, n)
        res = rs.search("games", RS_KEYS["games"][0],
                        SearchParams.from_json({"term": q}))
        ids = np.array([idx.user_to_internal[h.id.split(":", 1)[1]]
                        for h in res.hits])
        vals = np.array([h.score for h in res.hits], np.float64)
        ref_ids, ref_vals = reference_top(ref, K)
        errs = topk_errors(ids, vals, ref_ids, ref_vals, ref)
        if res.count != len(ref):
            errs.append(f"count {res.count} vs {len(ref)}")
        bad += [f"query {b} {q!r}: {e}" for e in errs]
    report_check(bad, f"{N_RS_NUMPY} plain queries through ReadSide.search: "
                      f"top-{K} and counts equal host_bm25_reference over "
                      f"{props} of the committed index")


def rs_overhead(rs, qtexts, card):
    """The same queries through SharedBatchExecutor.search_topk_shared on
    the read side's own committed index and through ReadSide.search_batch,
    in turns (A B B A A B); returns (executor ms, read side ms)."""
    from oramacore_tpu_torch.types import SearchParams

    idx = rs.collections["games"].indexes["main"]
    props = [p for p, t in idx.field_types.items() if t.startswith("string")]
    toks = [[w for t, v in idx.parser.tokenize_and_stem(q) for w in [t] + v]
            or [""] for q in qtexts]
    ex = rs._shared_executor
    n, cap = float(idx.document_count()), idx.cap()
    params = [SearchParams.from_json({"term": q}) for q in qtexts]

    def direct():
        # the arguments the read side passes (its thresholds are zeros)
        return ex.search_topk_shared(idx.string, toks, props, {}, n, cap, K,
                                     thresholds=[0.0] * len(toks))

    def read_side():
        return rs.search_batch("games", RS_KEYS["games"][0], params)

    times = {"direct": [], "read side": []}
    for fn in ("direct", "read side", "read side", "direct", "direct",
               "read side"):
        times[fn].append(timed_ms(direct if fn == "direct" else read_side)[1])
    a, b = min(times["direct"]), min(times["read side"])
    vals, ids, counts = direct()
    res = read_side()
    check(all(int(counts[i]) == r.count for i, r in enumerate(res)),
          f"the direct executor call and ReadSide.search_batch give the same "
          f"{len(res)} counts")
    print(f"  read side overhead, B={len(qtexts)} full-text: "
          f"search_topk_shared {a:.2f} ms, ReadSide.search_batch {b:.2f} ms "
          f"(best of 3 each, in turns): {b / a:.3f}x [{card}]", flush=True)
    return a, b


def phase_read_side(device, card):
    """Phase 17: the runtime on the card. build_orama, two collections
    through WriteSide.insert_documents while the consumer thread applies
    the op log, searches of every kind through ReadSide.search and
    search_batch before and after the commit, then held to a CPU read
    side loaded from the snapshots, to host_bm25_reference, to a restart
    and, with pruning switched "on" on both, card against CPU again.
    Returns its launch counts and numbers, and the restarted runtime
    (pruning back to "auto") with its cases for phase 18."""
    import copy
    import shutil

    import torch

    from oramacore_tpu_torch.benches import ingest_bench as ib
    from oramacore_tpu_torch.benches.encoder_bench import (
        passages,
        vocab_words,
    )
    from oramacore_tpu_torch.embeddings import EmbeddingsService
    from oramacore_tpu_torch.oplog import InMemoryTransport
    from oramacore_tpu_torch.read import ReadSide
    from oramacore_tpu_torch.runtime import build_orama
    from oramacore_tpu_torch.utils.tokenizer import NLPService

    out = {}
    t0 = time.perf_counter()
    words, stems = ib.vocabulary(INGEST_VOCAB, seed=INGEST_SEED)
    docs = ib.documents(RS_DOCS, seed=INGEST_SEED, words=words)
    qtexts = ib.queries(stems, RS_QUERIES, seed=INGEST_SEED + 1)
    pwords = vocab_words(os.path.join(ROOT, "models", "semantic-base",
                                      "vocab.txt"))
    pdocs = [{"id": f"p{i}", "text": t} for i, t in enumerate(
        passages(pwords, RS_PASSAGES, seed=ENC_SEED))]
    ptexts = passages(pwords, RS_VEC_B, seed=ENC_SEED + 1, n_words=(2, 4))
    pin_ids = [docs[5]["id"], docs[77]["id"]]
    singles, batches = rs_cases(qtexts, ptexts)
    print(f"  corpus: {len(docs):,} games documents, {len(pdocs):,} "
          f"passages, {len(singles)} single searches and {len(batches)} "
          f"batches: {time.perf_counter() - t0:.1f} s of host time",
          flush=True)

    shutil.rmtree(RS_DIR, ignore_errors=True)
    cfg = rs_config(RS_DIR)
    torch.cuda.reset_peak_memory_stats()
    orama = build_orama(cfg, device=device, start_consumer=True)
    ws, rs = orama.write_side, orama.read_side
    for cid, (rk, wk) in RS_KEYS.items():
        ws.create_collection(RS_MASTER, cid, read_api_key=rk,
                             write_api_key=wk,
                             embedding_model="SemanticBase"
                             if cid == "passages" else None)
        ws.create_index(cid, wk, "main")
    ws.insert_pin_rule("games", RS_KEYS["games"][1], {
        "id": "promo",
        "conditions": [{"pattern": "pinned", "anchoring": "contains"}],
        "consequence": {"promote": [{"doc_id": pin_ids[0], "position": 0},
                                    {"doc_id": pin_ids[1], "position": 2}]},
    })

    # the games: insert batches while the consumer applies them
    t0 = time.perf_counter()
    for lo in range(0, len(docs), RS_INSERT):
        ws.insert_documents("games", "main", RS_KEYS["games"][1],
                            docs[lo:lo + RS_INSERT])
    t_insert = time.perf_counter() - t0
    t_last = t_insert + rs_wait_searchable(orama, docs[-1])
    rs_wait_applied(orama)
    t_applied = time.perf_counter() - t0
    out["docs_per_s"] = len(docs) / t_insert
    print(f"  games: {len(docs):,} documents through insert_documents in "
          f"batches of {RS_INSERT}: {t_insert:.2f} s, {out['docs_per_s']:,.0f} "
          f"documents/s; the last document searchable at {t_last:.2f} s; "
          f"every op (with the hash-model embeddings) applied at "
          f"{t_applied:.2f} s [{card}]", flush=True)

    # the passages: SemanticBase embeddings on the write side's queue
    def passages_ingest():
        t = time.perf_counter()
        for lo in range(0, len(pdocs), RS_INSERT):
            ws.insert_documents("passages", "main", RS_KEYS["passages"][1],
                                pdocs[lo:lo + RS_INSERT])
        rs_wait_applied(orama)
        return time.perf_counter() - t

    t_pass, launches = counted("read side, passages ingest", passages_ingest)
    check(launches["encoder_attention"] > 0,
          f"the passages' embedding queue launched encoder_attention "
          f"{launches['encoder_attention']} times")
    out["launches_passages"] = launches
    print(f"  passages: {len(pdocs):,} through insert_documents and the "
          f"SemanticBase embedding queue, applied in {t_pass:.2f} s [{card}]",
          flush=True)

    # searches on the live layer, before any commit
    t0 = time.perf_counter()
    live, launches = counted("read side, live layer",
                             lambda: rs_answers(rs, singles, batches))
    print(f"  every case on the live layer: {time.perf_counter() - t0:.1f} s",
          flush=True)
    rs_sanity(live, "live layer")
    check(launches["score_ranges_accumulate"] > 0
          and launches["encoder_attention"] > 0,
          "the live-layer searches launched score_ranges_accumulate and "
          "encoder_attention")

    t0 = time.perf_counter()
    ws.commit()
    t1 = time.perf_counter()
    rs.commit(force=True)
    t2 = time.perf_counter()
    out["commit_s"] = (t1 - t0, t2 - t1)
    print(f"  commit: WriteSide.commit {t1 - t0:.2f} s, "
          f"ReadSide.commit(force=True) {t2 - t1:.2f} s [{card}, host]",
          flush=True)

    t0 = time.perf_counter()
    committed, launches = counted("read side, committed",
                                  lambda: rs_answers(rs, singles, batches))
    print(f"  every case after the commit: {time.perf_counter() - t0:.1f} s "
          f"(the first search packs the committed slab)", flush=True)
    out["launches_dense"] = launches
    check(launches["score_ranges_accumulate"] > 0,
          f"the committed dense searches launched score_ranges_accumulate "
          f"{launches['score_ranges_accumulate']} times")
    rs_sanity(committed, "committed")
    rs_compare(committed, live, "live layer against committed, card")
    pinned = [h.id for h in committed["pinned 0"][0].hits]
    check(pinned[0] == "main:" + pin_ids[0] and pinned[2] == "main:" + pin_ids[1],
          f"the pin rule put {pin_ids[0]} first and {pin_ids[1]} third")
    rs_numpy_check(rs, qtexts)

    out["latency"] = rs_latency(rs, singles, card)
    from oramacore_tpu_torch.types import SearchParams

    big = [SearchParams.from_json(p)
           for p in batches[f"batch fulltext B={len(qtexts)}"][1]]
    hyb = [SearchParams.from_json(p)
           for p in batches[f"batch hybrid B={RS_VEC_B}"][1]]
    for label, plist in ((f"full-text B={len(big)}", big),
                         (f"hybrid B={len(hyb)}", hyb)):
        steady = [timed_ms(lambda: rs.search_batch(
            "games", RS_KEYS["games"][0], plist))[1] for _ in range(3)]
        out[f"qps {label}"] = len(plist) / min(steady) * 1e3
        print(f"  ReadSide.search_batch {label}: "
              f"{', '.join(f'{x:.2f}' for x in steady)} ms, "
              f"{out[f'qps {label}']:,.1f} QPS (best of 3) [{card}]",
              flush=True)
    out["device_ms_b256"] = profile_once(
        f"ReadSide.search_batch full-text B={len(big)}",
        lambda: rs.search_batch("games", RS_KEYS["games"][0], big), card)
    out["overhead"] = rs_overhead(rs, qtexts, card)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {out['peak_gib']:.3f} GiB [{card}]",
          flush=True)

    # restart from the data dir
    t0 = time.perf_counter()
    orama.stop()
    orama = build_orama(cfg, device=device, start_consumer=True)
    rs = orama.read_side
    print(f"  restart: stop and build_orama from {RS_DIR} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    restarted = rs_answers(rs, singles, batches)
    print(f"  every case after the restart: {time.perf_counter() - t0:.1f} s",
          flush=True)
    rs_compare(committed, restarted, "restart against before it, card")

    # a CPU read side loaded from the same snapshots (never committed:
    # it shares the data dir)
    t0 = time.perf_counter()
    cpu = ReadSide(rs_config(RS_DIR), InMemoryTransport().receiver,
                   EmbeddingsService(), NLPService(), device="cpu")
    cpu_ans = rs_answers(cpu, singles, batches, rs_held_to_cpu)
    print(f"  CPU read side: loaded and answered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rs_compare(cpu_ans, {k: restarted[k] for k in cpu_ans},
               "card against a CPU read side (plain kernel versions) on the "
               "snapshots")

    # the pruned tier: the restarted read side (a reload from the
    # snapshots) and the CPU one with reader_side.pruning switched to "on"
    # (read at each search), card against CPU
    rs.config.reader_side.pruning = "on"
    cpu.config.reader_side.pruning = "on"
    t0 = time.perf_counter()
    pruned, launches = counted("read side, pruned", lambda: rs_answers(
        rs, singles, batches, lambda name: not name.startswith("tolerance")))
    print(f"  every case but tolerance, pruned: {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    out["launches_pruned"] = launches
    for name in ("rescore_bsearch", "rescore_worklist", "facet_hist"):
        check(launches[name] > 0,
              f"the pruned searches launched {name} {launches[name]} times")
    rs_sanity(pruned, "pruned")
    t0 = time.perf_counter()
    cpu_p = rs_answers(cpu, singles, batches,
                       lambda name: rs_held_to_cpu(name, pruned=True))
    print(f"  CPU read side, pruned: {time.perf_counter() - t0:.1f} s",
          flush=True)
    rs_compare(cpu_p, {k: pruned[k] for k in cpu_p},
               "pruned: card against CPU")
    check(pruned["fulltext 0"][0].count_estimated,
          "the pruned plain searches report estimated counts")
    profile_once("ReadSide.search, pruned facets", lambda: rs.search(
        "games", RS_KEYS["games"][0], SearchParams.from_json(
            singles["facets 0"][1])), card)
    # phase 18 serves the restarted runtime as it stands
    rs.config.reader_side.pruning = "auto"
    del cpu
    gc.collect()
    torch.cuda.empty_cache()
    served = {"orama": orama, "singles": singles, "batches": batches,
              "qtexts": qtexts, "words": words,
              "docs_per_s": out["docs_per_s"]}
    return out, served


# ---------------------------------------------------------------------------
# the API server over a socket (phase 18)
# ---------------------------------------------------------------------------

def hits_of(hs):
    """SearchResultHits from hits' JSON (a served result's, an answer's
    `search_results`)."""
    from oramacore_tpu_torch.types import SearchResultHit

    return [SearchResultHit(h["id"], h["score"], h["document"]) for h in hs]


def result_of_json(d):
    """A SearchResult of the port's types from its JSON (what the server
    sends), for rs_result_errors."""
    from oramacore_tpu_torch.types import (
        FacetResult,
        GroupedResult,
        SearchResult,
    )

    facets = None if "facets" not in d else {
        k: FacetResult(v["count"], v["values"])
        for k, v in d["facets"].items()}
    groups = None if "groups" not in d else [
        GroupedResult(g["values"], hits_of(g["result"])) for g in d["groups"]]
    return SearchResult(hits_of(d["hits"]), d["count"], facets, groups,
                        bool(d.get("count_estimated", False)))


def as_served(answers):
    """In-process answers as the server serializes them (to_json through
    json), so both sides of a comparison went through the same JSON."""
    return {name: [result_of_json(json.loads(json.dumps(r.to_json())))
                   for r in results] for name, results in answers.items()}


def http_answers(client, singles, batches, only=None):
    """Every case through POST /search and /search/batch with the port's
    client: name -> list of SearchResult."""
    out = {}
    for name, (coll, p) in singles.items():
        if only is None or only(name):
            c = client.collection(coll, read_api_key=RS_KEYS[coll][0])
            out[name] = [result_of_json(c.search(p))]
    for name, (coll, plist) in batches.items():
        if only is None or only(name):
            res = client._http.post(f"/v1/collections/{coll}/search/batch",
                                    {"searches": plist},
                                    api_key=RS_KEYS[coll][0])
            out[name] = [result_of_json(r) for r in res["results"]]
    return out


def serve_in_thread(config, orama, ai_service=None):
    """The port's ApiServer for `orama` (and `ai_service`, if any) on
    127.0.0.1:0, on an event loop of its own thread (the search handlers
    run in its default executor); returns (base url, stop function)."""
    import asyncio
    import threading

    from oramacore_tpu_torch.server import ApiServer

    config.http.host, config.http.port = "127.0.0.1", 0
    server = ApiServer(config, orama.write_side, orama.read_side, ai_service)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="api-server",
                              daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(60)

    def stop():
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        stop_loop(loop, thread, "the API server's")

    return f"http://127.0.0.1:{server.port}", stop


def stop_loop(loop, thread, whose):
    """Cancel and await every task left on `loop` (run by `thread`), then
    stop the loop, join the thread and close the loop, so that nothing is
    pending when the interpreter exits."""
    import asyncio

    async def drain():
        tasks = [t for t in asyncio.all_tasks() if t is not
                 asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await loop.shutdown_asyncgens()

    asyncio.run_coroutine_threadsafe(drain(), loop).result(60)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=60)
    check(not thread.is_alive(), f"{whose} event loop stopped, no task "
          f"left on it")
    loop.close()


def http_latency(client, rs, singles, card):
    """p50 / p99 of single searches over HTTP and in-process, in turns
    per call, for full-text, facets and hybrid."""
    from oramacore_tpu_torch.types import SearchParams

    out = {}
    for mode, prefix in (("fulltext", "fulltext "), ("facets", "facets "),
                         ("hybrid", "hybrid ")):
        names = [n for n in singles if n.startswith(prefix)]
        calls = [singles[names[i % len(names)]] for i in range(SRV_LATENCY_N)]
        http_ms, local_ms = [], []
        for coll, p in calls:
            c = client.collection(coll, read_api_key=RS_KEYS[coll][0])
            t = time.perf_counter()
            c.search(p)
            http_ms.append((time.perf_counter() - t) * 1e3)
            sp = SearchParams.from_json(p)
            t = time.perf_counter()
            rs.search(coll, RS_KEYS[coll][0], sp)
            local_ms.append((time.perf_counter() - t) * 1e3)
        out[mode] = {k: (float(np.percentile(v, 50)), float(np.percentile(v, 99)))
                     for k, v in (("http", http_ms), ("in-process", local_ms))}
        h, l_ = out[mode]["http"], out[mode]["in-process"]
        print(f"  search, {mode}: {len(calls)} calls each: over HTTP p50 "
              f"{h[0]:.3f} ms, p99 {h[1]:.3f} ms; in-process p50 {l_[0]:.3f} "
              f"ms, p99 {l_[1]:.3f} ms; HTTP adds {h[0] - l_[0]:.3f} ms at "
              f"p50 [{card}, host clock]", flush=True)
    return out


def rs256_token(jwk, payload):
    """An RS256 JWT signed with the private half of `jwk` (RSASSA-PKCS1-
    v1_5 over SHA-256, by hand: s = EM^d mod n)."""
    import hashlib

    from oramacore_tpu_torch.auth import (
        _SHA256_DIGEST_INFO,
        _b64url_decode,
        _b64url_encode,
    )

    n, d = (int.from_bytes(_b64url_decode(jwk[f]), "big") for f in "nd")
    head = _b64url_encode(json.dumps({"alg": "RS256", "typ": "JWT",
                                      "kid": jwk["kid"]}).encode())
    signing_input = f"{head}.{_b64url_encode(json.dumps(payload).encode())}"
    k = (n.bit_length() + 7) // 8
    t = _SHA256_DIGEST_INFO + hashlib.sha256(signing_input.encode()).digest()
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    sig = pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")
    return f"{signing_input}.{_b64url_encode(sig)}"


def http_status(fn):
    """The HTTP status of a client call (200 when it returns)."""
    from oramacore_tpu_torch.client import ApiError

    try:
        fn()
        return 200
    except ApiError as e:
        return e.status


def server_auth(client, rs, term):
    """An HS256 and an RS256 customer token search; bad keys get 401."""
    from oramacore_tpu_torch.auth import (
        JwtManager,
        JwtProvider,
        _b64url_decode,
        _b64url_encode,
        make_hs256_token,
    )

    with open(os.path.join(ROOT, "oramacore_tpu_torch", "benches",
                           "rs256_smoke_key.json")) as fh:
        jwk = json.load(fh)
    public = {k: jwk[k] for k in ("kty", "kid", "alg", "n", "e")}
    # as build_orama attaches a JwtManager for auth.jwt_providers
    rs.jwt_manager = JwtManager([JwtProvider(
        issuer=JWT_ISSUER, audience=JWT_AUDIENCE, hs256_secret=JWT_HS256,
        static_jwks={"keys": [public]})])
    claims = {"iss": JWT_ISSUER, "aud": JWT_AUDIENCE,
              "exp": time.time() + 600, "collectionID": "games"}
    hs = make_hs256_token(JWT_HS256, claims)
    rs256 = rs256_token(jwk, claims)
    q = {"term": term}
    want = client.collection("games", read_api_key=RS_KEYS["games"][0]
                             ).search(q)
    for label, tok in (("HS256", hs), ("RS256", rs256)):
        got = client.collection("games", read_api_key=tok).search(q)
        check(want["count"] > 0 and got["count"] == want["count"]
              and [h["id"] for h in got["hits"]]
              == [h["id"] for h in want["hits"]],
              f"a {label} customer token searches and gets the read key's "
              f"answer ({got['count']} matches)")
    parts = rs256.split(".")
    sig = bytearray(_b64url_decode(parts[2]))
    sig[-1] ^= 1
    bad = {"a wrong key": "not-the-key",
           "an RS256 token with a flipped signature bit":
               ".".join(parts[:2] + [_b64url_encode(bytes(sig))]),
           "an expired RS256 token": rs256_token(jwk, {**claims,
                                                       "exp": time.time() - 1}),
           "an HS256 token of another secret": make_hs256_token("x", claims),
           "a token bound to another collection": rs256_token(
               jwk, {**claims, "collectionID": "passages"})}
    for label, key in bad.items():
        st = http_status(lambda: client.collection(
            "games", read_api_key=key).search(q))
        check(st == 401, f"{label} gets 401 (got {st})")


def server_hooks(client, rs):
    """A BeforeSearch and a TransformDocumentAfterSearch hook set over
    HTTP on a small collection, and their effect; prints which sandbox
    engaged (the hooks runtime's seccomp filter, else rlimits only)."""
    coll = client.create_collection("hooked", read_api_key="hooked-read",
                                    write_api_key="hooked-write")
    coll.create_index("main")
    names = ("amber", "basil", "cedar", "delta", "ember", "fjord", "grove")
    docs = [{"id": str(i), "title": f"{names[i % 7]} record", "n": i}
            for i in range(SRV_HOOK_DOCS)]
    coll.insert_documents("main", docs)
    coll.set_hook("BeforeSearch", (
        "def BeforeSearch(inp):\n"
        "    return {'term': inp['term'].replace('nothing', 'amber'),"
        " 'limit': 5}\n"))
    coll.set_hook("TransformDocumentAfterSearch", (
        "def TransformDocumentAfterSearch(doc):\n"
        "    doc['hooked'] = doc['n'] * 2\n"
        "    return doc\n"))
    t0 = time.perf_counter()
    while True:
        out = coll.search({"term": "nothing"})
        if out["count"] and all("hooked" in h["document"] for h in out["hits"]):
            break
        if time.perf_counter() - t0 > 120:
            raise SmokeFailure(f"the hooks took no effect: {out}")
        time.sleep(0.05)
    check(len(out["hits"]) == 5 and all(
        h["document"]["title"] == "amber record"
        and h["document"]["hooked"] == 2 * h["document"]["n"]
        for h in out["hits"]),
        "BeforeSearch rewrote the term and the limit, TransformDocument"
        "AfterSearch the documents")
    probe = rs.hooks_runtime.exec_hook("hooked", "hook", (
        "def hook(x):\n"
        "    import socket\n"
        "    try:\n"
        "        socket.socket()\n"
        "        return 'rlimits only (seccomp refused by this host)'\n"
        "    except PermissionError:\n"
        "        return 'seccomp filter and rlimits'\n"), {})
    print(f"  hooks sandbox: {probe}", flush=True)
    return probe


def node_yaml(role, data_dir, http_port, log_port, log_path):
    """A node's config file, as config.example.yaml writes one."""
    lines = [f"data_dir: {data_dir}", f"role: {role}", "http:",
             "  host: 127.0.0.1", f"  port: {http_port}", "auth:",
             f"  master_api_key: {RS_MASTER}", "log:", "  console_level: warn"]
    if role == "writer":
        lines += ["writer_side:", "  output:", "    type: tcp-stream",
                  f"    path: {log_path}", "    host: 127.0.0.1",
                  f"    port: {log_port}", "    fsync: true"]
    else:
        lines += ["reader_side:", "  input:", "    type: tcp-stream",
                  "    host: 127.0.0.1", f"    port: {log_port}",
                  "  insert_batch_commit_size: 8192"]
    return "\n".join(lines) + "\n"


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Node:
    """`python -m oramacore_tpu_torch.server --config <yaml>` as a
    subprocess (on the card: the entry point's default device)."""

    args = ()  # more arguments of the entry point (none on the card)

    def __init__(self, name, config_path, env=None):
        self.name = name
        self.config_path = config_path
        self.env = env or {}
        self.log_path = os.path.join(NODE_DIR, f"{name}.log")
        self.proc = None

    def launch(self):
        import subprocess

        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env.update(self.env)
        self._log = open(self.log_path, "a")
        self._log_from = self._log.tell()
        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "oramacore_tpu_torch.server", "--config",
             self.config_path, *self.args], cwd=ROOT, env=env,
            stdout=self._log,
            stderr=subprocess.STDOUT)

    def wait_ready(self):
        """Seconds from launch until the node prints its listening line."""
        while True:
            with open(self.log_path) as fh:
                fh.seek(self._log_from)
                if "listening on" in fh.read():
                    return time.perf_counter() - self._t0
            if self.proc.poll() is not None:
                raise SmokeFailure(f"the {self.name} node exited with "
                                   f"{self.proc.returncode}: {self.tail()}")
            if time.perf_counter() - self._t0 > NODE_WAIT_S:
                raise SmokeFailure(f"the {self.name} node did not start")
            time.sleep(0.1)

    def tail(self):
        with open(self.log_path) as fh:
            return fh.read()[-2000:]

    def kill9(self):
        import signal

        os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=60)
        self._log.close()

    def terminate(self):
        """SIGTERM; returns the exit code."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=300)
        self._log.close()
        return rc

    def kill_if_running(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def node_info(client):
    return client._http.get("/")


def wait_caught_up(writer, reader, n_docs):
    """Seconds until the reader node counts n_docs documents and has
    applied every op the writer sent (the writer's embedding queue
    drains first: its offset holds still for a second)."""
    rk = RS_KEYS["games"][0]
    t0 = time.perf_counter()
    last, still = -1, time.perf_counter()
    while True:
        sent = node_info(writer)["writer"]["sent_offset"]
        if sent != last:
            last, still = sent, time.perf_counter()
        try:
            info = node_info(reader)["reader"]
            count = reader.collection("games", read_api_key=rk).stats()[
                "document_count"]
        except Exception:  # noqa: BLE001 — not up, or the create not applied
            info, count = {"live_offset": -1}, -1
        if (count == n_docs and info["live_offset"] >= sent
                and time.perf_counter() - still > 1.0):
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > NODE_WAIT_S:
            raise SmokeFailure(f"the reader node did not catch up: {count} "
                               f"documents, offset {info} of {sent}")
        time.sleep(0.05)


def node_cases(singles):
    """The cases held reader node to CPU: NODE_FULLTEXT full-text
    searches and NODE_KIND of every other kind of the games collection
    but the pinned (no pin rule there) and the tolerance ones. A fuzzy
    token's variants are cut to the 64 closest posting ranges, counted
    over the committed slab and the live layer apart, so its answer
    depends on where the commits fell; the reader node commits on its own
    schedule, the CPU runtime not at all (phase 17 holds tolerance cases
    card to CPU on the same snapshots)."""
    out = {}
    for name, case in singles.items():
        kind, i = name.rsplit(" ", 1)
        if case[0] != "games" or kind in ("pinned", "tolerance 1"):
            continue
        if int(i) < (NODE_FULLTEXT if kind == "fulltext" else NODE_KIND):
            out[name] = case
    return out


def launch_nodes():
    """Write the nodes' configs and launch, together: the repo's own
    config.example.yaml (its port moved by the env override it documents:
    8080 may be taken), a writer and a reader node joined by the
    tcp-stream op log. They start while phase 18's in-process part runs."""
    import shutil

    shutil.rmtree(NODE_DIR, ignore_errors=True)
    os.makedirs(NODE_DIR)
    ports = {role: free_port() for role in ("example", "writer", "reader",
                                            "log")}
    nodes = {"example": Node("example", os.path.join(ROOT,
                                                     "config.example.yaml"),
                             env={"ORAMACORE_HTTP_PORT":
                                  str(ports["example"])})}
    for role in ("writer", "reader"):
        path = os.path.join(NODE_DIR, f"{role}.yaml")
        with open(path, "w") as fh:
            fh.write(node_yaml(role, os.path.join(NODE_DIR, f"{role}-data"),
                               ports[role], ports["log"],
                               os.path.join(NODE_DIR, "ops.stream")))
        nodes[role] = Node(role, path)
    for node in nodes.values():
        node.launch()
    return nodes, ports


def phase_two_nodes(served, card, nodes, ports):
    """The launched nodes: config.example.yaml answers; NODE_DOCS
    documents to the writer over HTTP while an in-process CPU runtime is
    fed the same documents on another thread; the reader node held to
    it, killed with SIGKILL, restarted; SIGTERM to every node."""
    import threading

    from oramacore_tpu_torch.benches import ingest_bench as ib
    from oramacore_tpu_torch.client import OramaCoreTPU
    from oramacore_tpu_torch.runtime import build_orama

    out = {}
    example, writer, reader = (nodes[k] for k in ("example", "writer",
                                                  "reader"))
    docs = ib.documents(NODE_DOCS, seed=INGEST_SEED + 4,
                        words=served["words"])
    rk, wk = RS_KEYS["games"]
    cases = node_cases(served["singles"])
    fed = {}

    def feed_cpu():
        try:
            t0 = time.perf_counter()
            cpu = fed["orama"] = build_orama(
                rs_config(os.path.join(NODE_DIR, "cpu-data")), device="cpu",
                start_consumer=True)
            cpu.write_side.create_collection(RS_MASTER, "games",
                                             read_api_key=rk,
                                             write_api_key=wk)
            cpu.write_side.create_index("games", wk, "main")
            for lo in range(0, len(docs), RS_INSERT):
                cpu.write_side.insert_documents("games", "main", wk,
                                                docs[lo:lo + RS_INSERT])
            rs_wait_applied(cpu)
            fed["ref"] = as_served(rs_answers(cpu.read_side, cases, {}))
            fed["s"] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — raised on the main thread
            fed["error"] = e

    feeder = threading.Thread(target=feed_cpu, name="cpu-runtime")
    try:
        t_e = example.wait_ready()
        ec = OramaCoreTPU(f"http://127.0.0.1:{ports['example']}", "change-me")
        info = node_info(ec)
        check(ec.health() and info["role"] == "both"
              and isinstance(ec.list_collections(), list),
              f"python -m oramacore_tpu_torch.server --config "
              f"config.example.yaml serves (up at {t_e:.1f} s, role "
              f"{info['role']})")
        check(example.terminate() == 0, "SIGTERM: the example node exits 0")
        t_w, t_r = writer.wait_ready(), reader.wait_ready()
        print(f"  nodes up: example at {t_e:.1f} s, writer at {t_w:.1f} s, "
              f"reader at {t_r:.1f} s after their launch at the phase's "
              f"start (python -m oramacore_tpu_torch.server --config "
              f"<yaml>)", flush=True)
        feeder.start()
        wc = OramaCoreTPU(f"http://127.0.0.1:{ports['writer']}", RS_MASTER,
                          timeout=600)
        rc = OramaCoreTPU(f"http://127.0.0.1:{ports['reader']}", RS_MASTER,
                          timeout=600)
        coll = wc.create_collection("games", read_api_key=rk, write_api_key=wk)
        coll.create_index("main")
        t0 = time.perf_counter()
        for lo in range(0, len(docs), RS_INSERT):
            coll.insert_documents("main", docs[lo:lo + RS_INSERT])
        t_ins = time.perf_counter() - t0
        t_up = t_ins + wait_caught_up(wc, rc, len(docs))
        out["node_docs_per_s"] = len(docs) / t_ins
        print(f"  writer node: {len(docs):,} documents over HTTP in batches "
              f"of {RS_INSERT}: {t_ins:.2f} s, {out['node_docs_per_s']:,.0f} "
              f"documents/s; the reader node caught up at {t_up:.2f} s "
              f"(an in-process CPU runtime fed alongside) [{card}]",
              flush=True)
        got = http_answers(rc, cases, {})
        feeder.join()
        if "error" in fed:
            raise fed["error"]
        print(f"  CPU runtime: fed {len(docs):,} documents and answered "
              f"{len(cases)} cases in {fed['s']:.1f} s", flush=True)
        rs_compare(fed["ref"], got, "reader node over HTTP against an "
                                    "in-process CPU runtime fed the same "
                                    "documents")
        rs_sanity(got, "reader node")

        # kill -9 the reader, restart it from its data dir
        before = rc.collection("games", read_api_key=rk).stats()[
            "document_count"]
        reader.kill9()
        t0 = time.perf_counter()
        reader.launch()
        reader.wait_ready()
        out["catch_up_s"] = time.perf_counter() - t0 + wait_caught_up(
            wc, rc, len(docs))
        after = rc.collection("games", read_api_key=rk).stats()[
            "document_count"]
        check(after == before == len(docs),
              f"the restarted reader resumes at {after:,} documents "
              f"({before:,} before the kill)")
        print(f"  reader node killed with SIGKILL and restarted: caught up "
              f"in {out['catch_up_s']:.2f} s (process start included) "
              f"[{card}]", flush=True)
        again = http_answers(rc, {k: cases[k] for k in list(cases)[:8]}, {})
        rs_compare({k: got[k] for k in again}, again,
                   "reader node after the restart against before it")
        codes = (writer.terminate(), reader.terminate())
        check(codes == (0, 0), f"SIGTERM: both nodes exit 0 (got {codes})")
    except Exception:
        for node in nodes.values():
            if node.proc is not None and node.proc.poll() is None:
                print(f"  {node.name} node log: {node.tail()}", flush=True)
        raise
    finally:
        if feeder.is_alive():
            feeder.join()
        if "orama" in fed:
            fed["orama"].stop()
    return out


def phase_server(served, device, card):
    """Phase 18: phase 17's runtime served by the port's ApiServer on a
    socket: its cases over HTTP held to the in-process answers (dense,
    then pruned), latency and QPS beside in-process, JWT auth, hooks,
    ingest over HTTP and the hurl scripts; then two nodes through the
    server's entry point (launched first, so that they start while the
    in-process part runs)."""
    out = {}
    nodes, ports = launch_nodes()
    try:
        out.update(phase_in_process_server(served, card))
        out.update(phase_two_nodes(served, card, nodes, ports))
    finally:
        for node in nodes.values():
            node.kill_if_running()
    return out


def phase_in_process_server(served, card):
    """Phase 18's first part: phase 17's runtime served in-process."""
    from oramacore_tpu_torch.client import OramaCoreTPU
    from oramacore_tpu_torch.utils.hurl import run_hurl_file

    orama = served["orama"]
    rs = orama.read_side
    singles, batches = served["singles"], served["batches"]
    out = {}
    base, stop = serve_in_thread(orama.config, orama)
    client = OramaCoreTPU(base, RS_MASTER, timeout=600)
    try:
        check(client.health(), f"the server answers /health at {base}")
        t0 = time.perf_counter()
        ref = as_served(rs_answers(rs, singles, batches))
        t1 = time.perf_counter()
        got, launches = counted("server, phase 17's cases over HTTP",
                                lambda: http_answers(client, singles, batches))
        print(f"  every case in-process {t1 - t0:.1f} s, over HTTP "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        out["launches_dense"] = launches
        check(launches["score_ranges_accumulate"] > 0,
              f"the searches over HTTP launched score_ranges_accumulate "
              f"{launches['score_ranges_accumulate']} times")
        rs_compare(ref, got, "over HTTP against ReadSide.search / "
                             "search_batch in-process")
        rs_sanity(got, "over HTTP")

        rs.config.reader_side.pruning = "on"
        try:
            only = lambda name: not name.startswith("tolerance")  # noqa: E731
            ref_p = as_served(rs_answers(rs, singles, batches, only))
            got_p, launches = counted(
                "server, pruned over HTTP",
                lambda: http_answers(client, singles, batches, only))
        finally:
            rs.config.reader_side.pruning = "auto"
        out["launches_pruned"] = launches
        for name in ("rescore_bsearch", "rescore_worklist", "facet_hist"):
            check(launches[name] > 0, f"the pruned searches over HTTP "
                                      f"launched {name} {launches[name]} times")
        rs_compare(ref_p, got_p, "pruned, over HTTP against in-process")

        out["latency"] = http_latency(client, rs, singles, card)
        big = batches[f"batch fulltext B={RS_QUERIES}"][1]
        from oramacore_tpu_torch.types import SearchParams

        bparams = [SearchParams.from_json(p) for p in big]
        qps = {}
        for label, fn in (
                ("over HTTP", lambda: client._http.post(
                    "/v1/collections/games/search/batch", {"searches": big},
                    api_key=RS_KEYS["games"][0])),
                ("in-process", lambda: rs.search_batch(
                    "games", RS_KEYS["games"][0], bparams))):
            steady = [timed_ms(fn)[1] for _ in range(3)]
            qps[label] = len(big) / min(steady) * 1e3
            print(f"  search/batch full-text B={len(big)} {label}: "
                  f"{', '.join(f'{x:.2f}' for x in steady)} ms, "
                  f"{qps[label]:,.1f} QPS (best of 3) [{card}]", flush=True)
        out["qps"] = qps

        server_auth(client, rs, served["qtexts"][0])
        out["sandbox"] = server_hooks(client, rs)

        from oramacore_tpu_torch.benches import ingest_bench as ib

        docs = ib.documents(SRV_INGEST, seed=INGEST_SEED + 3,
                            words=served["words"])
        coll = client.create_collection("ingested", read_api_key="ing-read",
                                        write_api_key="ing-write")
        coll.create_index("main")
        t0 = time.perf_counter()
        for lo in range(0, len(docs), RS_INSERT):
            coll.insert_documents("main", docs[lo:lo + RS_INSERT])
        t_ins = time.perf_counter() - t0
        rs_wait_applied(orama)
        out["http_docs_per_s"] = len(docs) / t_ins
        n = coll.stats()["document_count"]
        check(n == len(docs), f"{n:,} of {len(docs):,} documents inserted "
                              f"over HTTP are counted")
        print(f"  ingest over HTTP: {len(docs):,} documents in batches of "
              f"{RS_INSERT}: {t_ins:.2f} s, {out['http_docs_per_s']:,.0f} "
              f"documents/s (phase 17's in-process games ingest: "
              f"{served['docs_per_s']:,.0f}/s); applied at "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)

        for script in ("api-test.hurl", "search-paths.hurl"):
            t0 = time.perf_counter()
            run_hurl_file(os.path.join(ROOT, "tests", "hurl", script),
                          {"base_url": base, "master_key": RS_MASTER},
                          timeout_s=120)
            print(f"  tests/hurl/{script} through the port's hurl runner: "
                  f"passed in {time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        stop()
    return out


# ---------------------------------------------------------------------------
# RAG answers over the served runtime (phase 19)
# ---------------------------------------------------------------------------

def ai_mock_script(served):
    """The scripted LLM of phase 19 (benches/llm_mock.py): (substring of
    the prompt, reply). A prompt no entry names gets "" (the answer
    machine then searches with the user's own query). The autoquery
    replies plan two searches on the games: the first one's text states
    a price cap and a genre, which the constraint extractor injects."""
    from oramacore_tpu_torch.benches import ingest_bench as ib

    q = served["qtexts"]
    genre = ib.GENRES[-2]
    first = f"{q[0]} {genre} games under $40"
    tool_call = json.dumps([{"id": "call_1", "type": "function", "function": {
        "name": "stock", "arguments": json.dumps({"sku": "g7"})}}])
    return [
        ("You route a user message", '{"strategy": "simple"}'),
        ("independent search intents",
         json.dumps({"queries": [first, q[1]]})),
        ("choose which collection properties", json.dumps({"selections": [
            {"query": first, "properties": ["title", "price", "genre"]},
            {"query": q[1], "properties": ["title"]}]})),
        ("compose executable search parameters", json.dumps({"searches": [
            {"term": q[0], "limit": AI_MAX_DOCS},
            {"term": q[1], "limit": AI_MAX_DOCS}]})),
        ("classify a search query", '{"mode": "hybrid"}'),
        ("should feed semantic embeddings",
         json.dumps({"properties": AI_SELECTED})),
        ("check the stock", "TOOL_CALL " + tool_call),
        ("suggested queries", json.dumps([q[2], q[3]])),
        ("title for a conversation", "Games under forty"),
        ("used as training data", json.dumps([q[4], q[5], q[6]])),
        ("grounded question-answering assistant", AI_ANSWER),
    ], genre


class MockLLMThread:
    """benches/llm_mock.py's MockLLMServer on 127.0.0.1:0, on an event
    loop of its own thread."""

    def __init__(self, script):
        import asyncio
        import threading

        from oramacore_tpu_torch.benches.llm_mock import MockLLMServer

        self.mock = MockLLMServer(script, default="")
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="llm-mock", daemon=True)
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.mock.start(),
                                         self.loop).result(60)

    def stop(self):
        import asyncio

        asyncio.run_coroutine_threadsafe(self.mock.stop(),
                                         self.loop).result(60)
        stop_loop(self.loop, self.thread, "the LLM mock's")


def ai_call(port, path, body, key):
    """One POST to the AI server: (status, content type, SSE events or the
    JSON body, seconds to the first answer token or None, seconds in
    all). An SSE answer is read line by line as it streams and must end
    with data: [DONE]."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, body=json.dumps(body), headers={
        "Authorization": f"Bearer {key}",
        "Content-Type": "application/json"})
    resp = conn.getresponse()
    ctype = resp.getheader("content-type", "")
    first = None
    if ctype.startswith("text/event-stream"):
        out, done = [], False
        while True:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):].strip()
            if payload == b"[DONE]":
                done = True
                continue
            ev = json.loads(payload)
            if first is None and (ev.get("type") == "answer_token" or (
                    ev.get("object") == "chat.completion.chunk"
                    and ev["choices"] and ev["choices"][0]["delta"].get(
                        "content"))):
                first = time.perf_counter() - t0
            out.append(ev)
        if resp.status == 200 and not done:
            raise SmokeFailure(f"{path}: the SSE answer did not end with "
                               f"data: [DONE]")
    else:
        raw = resp.read()
        out = json.loads(raw) if "json" in ctype else raw.decode()
    wall = time.perf_counter() - t0
    conn.close()
    return resp.status, ctype, out, first, wall


def answer_checks(rs, coll, events, mock_requests, label):
    """One /answer's events held to what the machine did: the search it
    made (the optimizing_query event's query, the mode, the similarity
    and the limit it was given) repeated in-process equals its
    search_results by rs_hits_errors' rules; the mock's GenerateAnswer
    request carries those documents' JSON; the streamed tokens join to
    the scripted answer. Returns (errors, in-process ms, hits)."""
    from oramacore_tpu_torch.types import SearchParams

    types_ = [e["type"] for e in events]
    errs = []
    for t in ("acknowledged", "selected_llm", "optimizing_query",
              "search_results", "answer_token"):
        if t not in types_:
            errs.append(f"{label['name']}: no {t} event ({types_})")
    if errs:
        return errs, 0.0, 0
    if events[-1].get("state") != "completed":
        errs.append(f"{label['name']}: ends with {events[-1]}")
    opt = next(e for e in events if e["type"] == "optimizing_query")
    params = {"term": opt["optimized_query"], "mode": label["mode"],
              "similarity": label["similarity"], "limit": AI_MAX_DOCS}
    t = time.perf_counter()
    ref = rs.search(coll, RS_KEYS[coll][0], SearchParams.from_json(params))
    ms = (time.perf_counter() - t) * 1e3
    ref = result_of_json(json.loads(json.dumps(ref.to_json())))
    got = next(e for e in events if e["type"] == "search_results")["results"]
    errs += rs_hits_errors(ref.hits, hits_of(got), label["name"])
    context = json.dumps([h["document"] for h in got], ensure_ascii=False)
    asks = [r for r in mock_requests if "grounded question-answering"
            in json.dumps(r["messages"])]
    if len(asks) != 1 or context not in asks[0]["messages"][-1]["content"]:
        errs.append(f"{label['name']}: the GenerateAnswer request does not "
                    f"carry the search_results documents")
    tokens = "".join(e["token"] for e in events if e["type"] == "answer_token")
    if tokens.strip() != AI_ANSWER:
        errs.append(f"{label['name']}: streamed {tokens!r}")
    return errs, ms, len(got)


def pctl(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def answer_calls(port, mock, cases):
    """Every case (label dict, collection, interaction body) through
    POST /answer: (label, collection, status, content type, events,
    seconds to the first token, seconds in all, the LLM requests the
    answer made) each."""
    out = []
    for label, coll, body in cases:
        n0 = len(mock.requests)
        st, ctype, events, first, wall = ai_call(
            port, f"/v1/collections/{coll}/answer", body, RS_KEYS[coll][0])
        out.append((label, coll, st, ctype, events, first, wall,
                    mock.requests[n0:]))
    return out


def ai_answers(rs, calls, card):
    """The /answer calls of one mode held by answer_checks; prints wall
    and time to the first answer token p50 / p99 beside the in-process
    search p50."""
    bad, walls, firsts, local, n_llm, answered = [], [], [], [], [], 0
    for label, coll, st, ctype, events, first, wall, asked in calls:
        if st != 200 or not ctype.startswith("text/event-stream"):
            bad.append(f"{label['name']}: HTTP {st} {ctype} {events!r:.200}")
            continue
        errs, ms, n_hits = answer_checks(rs, coll, events, asked, label)
        bad += errs
        answered += n_hits > 0
        walls.append(wall * 1e3)
        firsts.append((first or wall) * 1e3)
        local.append(ms)
        n_llm.append(len(asked))
    mode, coll = calls[0][0]["mode"], calls[0][1]
    if not answered:
        bad.append(f"no {mode} answer found a document")
    report_check(bad, f"{len(calls)} /answer calls ({mode}, {coll}): "
                      f"search_results equal ReadSide.search with the "
                      f"machine's parameters, the GenerateAnswer request "
                      f"carries their documents, the tokens join to the "
                      f"scripted answer; {answered} of them with hits")
    out = {"wall": (pctl(walls, 50), pctl(walls, 99)),
           "first_token": (pctl(firsts, 50), pctl(firsts, 99)),
           "search_p50": pctl(local, 50),
           "llm_calls": sorted(set(n_llm))}
    print(f"  /answer, {mode} on {coll}: {len(calls)} calls, wall p50 "
          f"{out['wall'][0]:.2f} ms, p99 {out['wall'][1]:.2f} ms; first "
          f"answer_token p50 {out['first_token'][0]:.2f} ms, p99 "
          f"{out['first_token'][1]:.2f} ms; in-process ReadSide.search on "
          f"the same parameters p50 {out['search_p50']:.3f} ms; LLM calls "
          f"an answer {out['llm_calls']} [{card}, host clock]", flush=True)
    return out


def llm_client_ms(url, card, n=32):
    """The port's LLM client alone against the mock, in one event loop:
    p50 of a chat call and of a streamed answer to its last token
    (`AI_ANSWER`, word by word)."""
    import asyncio

    from oramacore_tpu_torch.ai.llms import LLMProviderConfig, LLMService

    svc = LLMService(LLMProviderConfig("mock", url, "mock-llm"))
    msgs = [{"role": "system", "content": "You are a grounded "
             "question-answering assistant."},
            {"role": "user", "content": "which game?"}]

    async def run():
        chat, stream, answers = [], [], set()
        for _ in range(n):
            t = time.perf_counter()
            msg = await svc.chat(msgs)
            chat.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            toks = [tok async for tok in svc.chat_stream(msgs)]
            stream.append((time.perf_counter() - t) * 1e3)
            answers.add((msg["content"], "".join(toks).strip()))
        return chat, stream, answers

    chat, stream, answers = asyncio.run(run())
    check(answers == {(AI_ANSWER, AI_ANSWER)},
          f"the LLM client read the mock's answer, whole and streamed, in "
          f"{n} calls of each")
    out = {"chat_p50": pctl(chat, 50), "stream_p50": pctl(stream, 50)}
    print(f"  the LLM client alone against the mock: chat p50 "
          f"{out['chat_p50']:.3f} ms, a streamed answer "
          f"({len(AI_ANSWER.split())} chunks) p50 {out['stream_p50']:.3f} "
          f"ms [{card}, host clock]", flush=True)
    return out


def autoquery_checks(rs, events, prefix, label):
    """The searches an autoquery run planned (its tracked_queries_generated
    state) repeated in-process equal its search_results, search by
    search, by rs_hits_errors' rules."""
    from oramacore_tpu_torch.types import SearchParams

    tracked = next(e for e in events if e["type"] == prefix + "state_changed"
                   and e["state"] == "tracked_queries_generated")
    got = hits_of(next(e for e in events
                       if e["type"] == prefix + "search_results")["results"])
    errs, at = [], 0
    for i, sp in enumerate(tracked["data"]["searches"]):
        ref = rs.search("games", RS_KEYS["games"][0],
                        SearchParams.from_json(sp))
        ref = result_of_json(json.loads(json.dumps(ref.to_json()))).hits
        errs += rs_hits_errors(ref, got[at:at + len(ref)], f"{label}[{i}]")
        at += len(ref)
    if at != len(got) or not got:
        errs.append(f"{label}: {len(got)} hits for {at} planned")
    return errs, tracked["data"]["searches"]


def hook_log_stream(port, coll, key):
    """A raw socket on GET /logs, read past its head."""
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    sock.sendall(f"GET /v1/collections/{coll}/logs?api-key={key} HTTP/1.1\r\n"
                 f"Host: smoke\r\n\r\n".encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(4096)
    check(b"text/event-stream" in buf, "the hook-log SSE answers")
    return sock, buf.split(b"\r\n\r\n", 1)[1]


def phase_ai(served, device, card):
    """Phase 19: phase 17's runtime served with the port's AIService and
    a scripted LLM (benches/llm_mock.py) on a socket: /answer in three
    modes, planned answers, OpenAI chat, NLP queries, MCP, suggestions,
    titles, tools, system prompts, training sets, a BeforeAnswer hook on
    the hook-log SSE, mode "auto" searches and kv-actions-test.hurl."""
    from oramacore_tpu_torch.ai.service import AIService
    from oramacore_tpu_torch.client import OramaCoreTPU
    from oramacore_tpu_torch.types import SearchParams
    from oramacore_tpu_torch.utils.hurl import run_hurl_file

    t_phase = time.perf_counter()
    orama = served["orama"]
    rs, ws = orama.read_side, orama.write_side
    qtexts = served["qtexts"]
    ptexts = [p["term"] for p in served["batches"][
        f"passages batch vector B={RS_VEC_B}"][1]]
    script, genre = ai_mock_script(served)
    llm = MockLLMThread(script)
    mock = llm.mock
    cfg = orama.config
    cfg.ai.remote_llms = [{"name": "mock", "url": mock.url,
                           "model": "mock-llm"}]
    ai = AIService(cfg, ws, rs)
    check(rs.hooks_runtime is ai.hooks_runtime
          and ws.hooks_runtime is ai.hooks_runtime
          and rs.llm_resolve_mode is not None,
          "the AIService attached its hooks runtime to both sides and the "
          "auto-mode resolver to the read side")
    base, stop = serve_in_thread(cfg, orama, ai)
    port = int(base.rsplit(":", 1)[1])
    client = OramaCoreTPU(base, RS_MASTER, timeout=600)
    out = {}
    try:
        # /answer in three modes; each mode's calls counted
        modes = (("fulltext", "games", qtexts, 0.5),
                 ("hybrid", "games", qtexts[AI_ANSWERS:], RS_SIM),
                 ("vector", "passages", ptexts, RS_PASSAGE_SIM))
        for mode, coll, texts, sim in modes:
            cases = [({"name": f"answer {mode} {i}", "mode": mode,
                       "similarity": sim}, coll,
                      {"interactionID": f"{mode}-{i}",
                       "query": texts[i % len(texts)], "searchMode": mode,
                       "min_similarity": sim, "max_documents": AI_MAX_DOCS})
                     for i in range(AI_ANSWERS)]
            calls, launches = counted(
                f"/answer, {mode} on {coll}",
                lambda cases=cases: answer_calls(port, mock, cases))
            want = "encoder_attention" if mode == "vector" else \
                "score_ranges_accumulate"
            check(launches[want] > 0, f"the {mode} answers launched {want} "
                                      f"{launches[want]} times")
            out[mode] = ai_answers(rs, calls, card)
            out[mode]["launches"] = launches
            profile_once(f"one /answer, {mode} on {coll}",
                         lambda coll=coll, body=cases[0][2]: ai_call(
                             port, f"/v1/collections/{coll}/answer", body,
                             RS_KEYS[coll][0]), card)

        out["llm_client"] = llm_client_ms(mock.url, card)

        # planned answers and NLP queries: the autoquery machine
        rk = RS_KEYS["games"][0]
        planned_ms, nlp_ms, bad = [], [], []
        for i in range(AI_PLANNED):
            st, _, events, _, wall = ai_call(
                port, "/v1/collections/games/planned_answer",
                {"interactionID": f"planned-{i}",
                 "query": f"{qtexts[i]} and something cheap"}, rk)
            planned_ms.append(wall * 1e3)
            errs, searches = autoquery_checks(rs, events,
                                              "advanced_autoquery_",
                                              f"planned {i}")
            bad += errs
            toks = "".join(e["token"] for e in events
                           if e["type"] == "answer_token")
            if st != 200 or toks.strip() != AI_ANSWER:
                bad.append(f"planned {i}: HTTP {st}, tokens {toks!r}")
        for i in range(AI_NLP):
            st, _, events, _, wall = ai_call(
                port, "/v1/collections/games/generate/nlp_query",
                {"query": f"{qtexts[i]} under $40"}, rk)
            nlp_ms.append(wall * 1e3)
            errs, searches = autoquery_checks(rs, events, "", f"nlp {i}")
            bad += errs if st == 200 else [f"nlp {i}: HTTP {st}"]
        first = searches[0].get("where", {})
        check(first.get("price") == {"lte": 40.0}
              and first.get("genre") == genre,
              f"the constraint extractor injected price <= 40 and genre "
              f"{genre!r} into the planned search ({first})")
        report_check(bad, f"{AI_PLANNED} planned answers and {AI_NLP} NLP "
                          f"queries: each planned search's hits equal "
                          f"ReadSide.search in-process")
        out["planned_p50"], out["nlp_p50"] = pctl(planned_ms, 50), \
            pctl(nlp_ms, 50)

        # OpenAI-compatible chat, half of it streamed
        chat_ms, bad = [], []
        for i in range(AI_CHAT):
            stream = bool(i % 2)
            st, _, body, _, wall = ai_call(
                port, "/v1/games/openai/chat/completions",
                {"model": "mock/mock-llm", "stream": stream, "messages": [
                    {"role": "system", "content": "Be brief."},
                    {"role": "user", "content": qtexts[i]}]}, rk)
            chat_ms.append(wall * 1e3)
            text = "".join(c["choices"][0]["delta"].get("content") or ""
                           for c in body if c["choices"]) if stream else \
                body["choices"][0]["message"]["content"]
            if st != 200 or text.strip() != AI_ANSWER:
                bad.append(f"chat {i}: HTTP {st}, {text!r}")
        report_check(bad, f"{AI_CHAT} OpenAI chat calls ({AI_CHAT // 2} "
                          f"streamed) answer the scripted text")
        out["chat_p50"] = pctl(chat_ms, 50)

        # MCP: the handshake, then searches held to /search over HTTP
        def rpc(body):
            return client._http.post("/v1/collections/games/mcp", body,
                                     api_key=rk)

        init = rpc({"jsonrpc": "2.0", "id": 0, "method": "initialize"})
        tools = rpc({"jsonrpc": "2.0", "id": 1, "method": "tools/list"})
        check(init["result"]["protocolVersion"] and {"search", "nlp_search"}
              <= {t["name"] for t in tools["result"]["tools"]},
              "MCP initialize and tools/list")
        bad = []
        for i in range(AI_MCP):
            args = {"term": qtexts[40 + i], "limit": 10}
            got = rpc({"jsonrpc": "2.0", "id": 2 + i, "method": "tools/call",
                       "params": {"name": "search", "arguments": args}})
            got = json.loads(got["result"]["content"][0]["text"])
            want = client.collection("games", read_api_key=rk).search(args)
            bad += rs_result_errors(result_of_json(want), result_of_json(got),
                                    f"mcp {i}")
        report_check(bad, f"{AI_MCP} MCP tools/call searches equal /search "
                          f"over HTTP")

        # suggestions, title, tools, system prompts, training sets
        conv = {"messages": [{"role": "user", "content": qtexts[0]}]}
        sug = client._http.post("/v1/collections/games/suggestions", conv,
                                api_key=rk)
        title = client._http.post("/v1/collections/games/title", conv,
                                  api_key=rk)
        check(sug["suggestions"] == [qtexts[2], qtexts[3]]
              and title["title"] == "Games under forty",
              "suggestions and title answer the scripted replies")
        wk = RS_KEYS["games"][1]
        client._http.post("/v1/collections/games/tools/insert", {
            "id": "stock", "description": "Check the stock of a game",
            "parameters": {"type": "object", "properties": {
                "sku": {"type": "string"}}},
            "code": "def stock(args):\n    return {'sku': args['sku'], "
                    "'in_stock': 7}\n"}, api_key=wk)
        ran = client._http.post("/v1/collections/games/tools/run", {
            "messages": [{"role": "user",
                          "content": "check the stock of g7"}]}, api_key=rk)
        check(ran["results"] == [{"tool": "stock", "arguments": {"sku": "g7"},
                                  "result": {"sku": "g7", "in_stock": 7}}],
              f"tools/run: the mock's tool call ran the tool's code "
              f"({ran['results']})")
        client._http.post("/v1/collections/games/system_prompts/insert", {
            "id": "smoke", "prompt": "Answer in one line.",
            "usage_mode": "manual"}, api_key=wk)
        got = client._http.post("/v1/collections/games/system_prompts/get",
                                {"id": "smoke"}, api_key=rk)
        check(got["system_prompt"]["prompt"] == "Answer in one line.",
              "system_prompts insert and get")
        n0 = len(mock.requests)
        gen = client._http.post(
            "/v1/collections/games/training_sets/queries_generator/generate",
            {"count": 3}, api_key=wk)
        asked = json.dumps(mock.requests[n0:])
        idx = rs.collections["games"].indexes["main"]
        uids = [idx.doc_user_ids[d] for d in list(idx.doc_user_ids)[:2]]
        sample = rs.batch_get_documents("games", rk, uids)
        check(gen["data"] == [qtexts[4], qtexts[5], qtexts[6]]
              and len(sample) == 2
              and all(d["title"] in asked for d in sample.values()),
              "training_sets generate: the LLM request carries sampled "
              "games documents, and the set is the scripted one")

        # a BeforeAnswer hook: its print arrives on the hook-log SSE and
        # its output (one document) is what the answer prompt carries
        sock, logs = hook_log_stream(port, "games", rk)
        try:
            client.collection("games", write_api_key=wk).set_hook(
                "BeforeAnswer",
                "def BeforeAnswer(payload):\n"
                "    print('before answer', len(payload['results']))\n"
                "    return {'results': payload['results'][:1]}\n")
            t0 = time.perf_counter()
            while not rs.collections["games"].hooks.get("BeforeAnswer"):
                check(time.perf_counter() - t0 < 60, "the hook is applied")
                time.sleep(0.01)
            n0 = len(mock.requests)
            st, _, events, _, _ = ai_call(
                port, "/v1/collections/games/answer",
                {"interactionID": "hooked", "query": qtexts[0],
                 "searchMode": "fulltext", "max_documents": AI_MAX_DOCS}, rk)
            res = next(e for e in events if e["type"] == "search_results")
            ask = next(r for r in mock.requests[n0:]
                       if "grounded question-answering"
                       in json.dumps(r["messages"]))
            one = json.dumps([res["results"][0]["document"]],
                             ensure_ascii=False)
            check(st == 200 and len(res["results"]) > 1
                  and one in ask["messages"][-1]["content"],
                  f"BeforeAnswer cut the {len(res['results'])} results to "
                  f"one in the answer prompt")
            t0 = time.perf_counter()
            want = f"before answer {len(res['results'])}".encode()
            while want not in logs:
                check(time.perf_counter() - t0 < 60,
                      "the hook's print reaches the hook-log SSE")
                logs += sock.recv(4096)
            print(f"  hook-log SSE: {want.decode()!r} arrived", flush=True)
        finally:
            sock.close()
        client._http.post("/v1/collections/games/hooks/delete",
                          {"name": "BeforeAnswer"}, api_key=wk)

        # mode "auto": the mock picks hybrid
        bad = []
        for i in range(AI_AUTO):
            n0 = len(mock.requests)
            p = {"term": qtexts[60 + i], "mode": "auto"}
            got = client.collection("games", read_api_key=rk).search(p)
            asked = [r for r in mock.requests[n0:]
                     if "classify a search query" in json.dumps(r)]
            want = rs.search("games", rk, SearchParams.from_json(
                dict(p, mode="hybrid")))
            bad += rs_result_errors(result_of_json(json.loads(json.dumps(
                want.to_json()))), result_of_json(got), f"auto {i}")
            if len(asked) != 1:
                bad.append(f"auto {i}: {len(asked)} mode requests")
        report_check(bad, f"{AI_AUTO} mode auto searches asked the LLM once "
                          f"each and equal the hybrid search it chose (at "
                          f"hybrid's default similarity, as auto resolves)")

        # the repo's kv-actions script, whole
        t0 = time.perf_counter()
        run_hurl_file(os.path.join(ROOT, "tests", "hurl",
                                   "kv-actions-test.hurl"),
                      {"base_url": base, "master_key": RS_MASTER},
                      timeout_s=120)
        kv_idx = ws.collections["hurl-kv"].indexes["main"]
        check(kv_idx.embedding_fields == AI_SELECTED,
              f"tests/hurl/kv-actions-test.hurl passed in "
              f"{time.perf_counter() - t0:.2f} s; its insert asked the LLM "
              f"which properties to embed ({kv_idx.embedding_fields})")
    finally:
        stop()
        llm.stop()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  OpenAI chat p50 {out['chat_p50']:.2f} ms, planned answer p50 "
          f"{out['planned_p50']:.2f} ms, nlp_query p50 {out['nlp_p50']:.2f} "
          f"ms; {len(mock.requests)} LLM requests in all; the phase "
          f"{out['seconds']:.1f} s [{card}, host clock]", flush=True)
    return out


# ---------------------------------------------------------------------------
# the doc-sharded mesh (phase 20)
# ---------------------------------------------------------------------------

def mesh_kinds(singles, qtexts):
    """Phase 20's single searches: name -> (collection, params, pruning):
    phase 17's full-text searches and 4 of each other kind (filters,
    facets, sort, group-by, exact counts, vector, hybrid, the passages),
    then with pruning "on" 4 pruned full-text (games and passages) and 4
    pruned facet searches."""
    dense = ("fulltext ", "price range ", "genre ", "price and genre ",
             "facets ", "sort asc ", "sort desc ", "group by genre ",
             "exact ", "pinned ", "vector ", "hybrid ", "passages ")
    cases = {name: (coll, p, "auto") for name, (coll, p) in singles.items()
             if name.startswith(dense)}
    for i in range(RS_KIND_QUERIES):
        q = qtexts[(7 * i + 3) % len(qtexts)]
        cases[f"exact count {i}"] = ("games", {"term": q,
                                               "exactCount": True}, "auto")
        for kind in ("fulltext", "facets"):
            coll, p = singles[f"{kind} {i}"]
            cases[f"pruned {kind} {i}"] = (coll, p, "on")
        coll, p = singles[f"passages fulltext {i}"]
        cases[f"pruned passages fulltext {i}"] = (coll, p, "on")
    return cases


def mesh_compare(ref, got, what):
    """rs_compare for the mesh: hits, facets and groups as phase 17's gate,
    counts exact wherever either side reports an exact count. Where both
    flag their count as estimated (the pruned tier without exactCount),
    the estimate is floored by the verified candidates, and each of D
    shards verifies its own top C (a pool D times the single device's),
    so there the mesh's count must be flagged too and at least its hits;
    the differences are printed."""
    import copy

    bad, n, moved = [], 0, []
    for name, results in got.items():
        for qi, (a, b) in enumerate(zip(ref[name], results)):
            label = f"{name}[{qi}]"
            if a.count_estimated and b.count_estimated:
                if b.count != a.count:
                    moved.append(f"{label} {a.count} -> {b.count}")
                if b.count < len(b.hits):
                    bad.append(f"{label}: estimated count {b.count} below "
                               f"its {len(b.hits)} hits")
                b = copy.copy(b)
                b.count = a.count
            bad += rs_result_errors(a, b, label)
            n += 1
    if moved:
        print(f"  estimated counts, single device -> mesh: "
              f"{'; '.join(moved)}", flush=True)
    report_check(bad, f"{what}: {n} searches ({len(got)} cases) agree: ids "
                      f"outside near-ties (1e-5), scores rtol 1e-4, exact "
                      f"counts, facet counts, groups, hydrated documents")


def launch_counts():
    """Every wrapper's launch count as it stands."""
    return {name: n for mod in wrapper_modules()
            for name, n in mod.LAUNCHES.items()}


def mesh_answers(rs, cases, lat=None, per_case=None):
    """Every case through ReadSide.search with its pruning setting: name ->
    [SearchResult]; `lat` gathers each call's ms by case kind, `per_case`
    each case's launches."""
    from oramacore_tpu_torch.types import SearchParams

    out = {}
    for name, (coll, p, pruning) in cases.items():
        rs.config.reader_side.pruning = pruning
        sp = SearchParams.from_json(p)
        before = launch_counts()
        t = time.perf_counter()
        out[name] = [rs.search(coll, RS_KEYS[coll][0], sp)]
        if lat is not None:
            lat.setdefault(name.rsplit(" ", 1)[0], []).append(
                (time.perf_counter() - t) * 1e3)
        if per_case is not None:
            per_case[name] = {k: n - before[k]
                              for k, n in launch_counts().items()}
    rs.config.reader_side.pruning = "auto"
    return out


def mesh_batches(rs, batches, per_case):
    """name -> [SearchResult] of each batch through search_batch;
    `per_case` gathers each batch's launches."""
    from oramacore_tpu_torch.types import SearchParams

    out = {}
    for name, (coll, plist) in batches.items():
        before = launch_counts()
        out[name] = rs.search_batch(coll, RS_KEYS[coll][0],
                                    [SearchParams.from_json(p) for p in plist])
        per_case[name] = {k: n - before[k] for k, n in launch_counts().items()}
    return out


def mesh_launches_check(single, mesh, what):
    """Each mesh kernel's launches on each case against the single
    device's on it: MESH_SHARDS times (once a shard), or as many for the
    query encoder (MESH_ONCE_A_SEARCH)."""
    bad = []
    for name, one in single.items():
        for k in KERNELS:
            n = k["name"]
            if not k["mesh"]:
                continue
            want = one[n] * (1 if n in MESH_ONCE_A_SEARCH else MESH_SHARDS)
            if mesh[name][n] != want:
                bad.append(f"{name}: {n} {mesh[name][n]} on the mesh, "
                           f"{one[n]} on one device")
    report_check(bad, f"{what}: on each of {len(single)} cases each mesh "
                      f"kernel launched {MESH_SHARDS} x the single device's "
                      f"launches ({', '.join(MESH_ONCE_A_SEARCH)}: as many)")


def phase_mesh(served, rs_out, device, card):
    """Phase 20: a read side with sharded_shards=4 and mesh_devices=[cuda:0]
    * 4 (four shards on the one card, the port's form of XLA's host device
    count) loaded from phase 17's data dir (262,144 games documents,
    16,384 SemanticBase passages; no ingest), held case by case to phase
    17's single-device read side (the runtime phases 18 and 19 served,
    which left those two collections as they were). Dense cases, then
    pruned ones (pruning "on"), then B=256 batches; then the games'
    vectors take an int8 IVF layout (each read side builds its own; the
    two are held equal) for the pruned int8 hybrid and the int8 batch
    tails. The mesh plans on its own string indexes, packed here and held
    equal to the single device's, as are its loaded vectors. Each case's
    launches are held to the single device's on it (each kernel once a
    shard, the query encoder once a search). Prints the mesh's latency
    by mode beside phase 17's, B=256 QPS, the pack and slab partition
    times, one profiled batch and peak memory. A
    read side with sharded_shards=4 and no mesh_devices, on an empty data
    dir, shows that one card turns the mesh off with JAX's warning."""
    import logging

    import torch

    from oramacore_tpu_torch.embeddings import EmbeddingsService
    from oramacore_tpu_torch.oplog import InMemoryTransport
    from oramacore_tpu_torch.read import ReadSide
    from oramacore_tpu_torch.utils.tokenizer import NLPService

    out = {}
    single = served["orama"].read_side
    emb = EmbeddingsService(device=device)

    def cfg(data_dir):
        c = rs_config(data_dir)
        c.reader_side.sharded_shards = MESH_SHARDS
        return c

    class Warned(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    warned = Warned()
    logger = logging.getLogger("oramacore_tpu.read")
    logger.addHandler(warned)
    try:
        off = ReadSide(cfg(os.path.join(RS_DIR, "mesh_warning")),
                       InMemoryTransport().receiver, emb, NLPService(),
                       device=device)
    finally:
        logger.removeHandler(warned)
    check(off.sharded_mesh is None and any(
        f"sharded_shards={MESH_SHARDS} but only "
        f"{torch.cuda.device_count()} devices" in w for w in warned.lines),
        f"sharded_shards={MESH_SHARDS} without mesh_devices on "
        f"{torch.cuda.device_count()} card: JAX's warning ({warned.lines}); "
        f"no mesh, so every route takes the single-device executors")
    del off
    t0 = time.perf_counter()
    mesh = ReadSide(cfg(RS_DIR), InMemoryTransport().receiver, emb,
                    NLPService(), device=device,
                    mesh_devices=[device] * MESH_SHARDS)
    check(mesh.sharded_mesh is not None
          and mesh.sharded_mesh.D == MESH_SHARDS,
          f"the mesh read side holds {MESH_SHARDS} shards on {device}")
    games = mesh.collections["games"].indexes["main"]
    check(games.document_count() == single.collections["games"].indexes[
        "main"].document_count() == RS_DOCS,
        f"the mesh read side loaded phase 17's {RS_DOCS:,} games documents "
        f"from {RS_DIR} in {time.perf_counter() - t0:.1f} s [host]")
    # the mesh read side's own indexes, loaded from the snapshot: its
    # string indexes packed here (the first search would pack them) and
    # held, with its vectors, to the single device's
    t0 = time.perf_counter()
    for cid in ("games", "passages"):
        mesh.collections[cid].indexes["main"].string.slab()
    out["pack_s"] = time.perf_counter() - t0
    bad = []
    for cid in ("games", "passages"):
        a = mesh.collections[cid].indexes["main"]
        b = single.collections[cid].indexes["main"]
        if not all(np.array_equal(x, y) for x, y in zip(a.string.slab(),
                                                         b.string.slab())):
            bad.append(f"{cid}: the slab arrays differ")
        if (a.string._slab_ranges != b.string._slab_ranges
                or a.string._slab_prefix_ranges
                != b.string._slab_prefix_ranges):
            bad.append(f"{cid}: the term or impact-prefix ranges differ")
        if not (np.array_equal(a.vector._committed_matrix,
                               b.vector._committed_matrix)
                and np.array_equal(a.vector._committed_docs,
                                   b.vector._committed_docs)):
            bad.append(f"{cid}: the committed vectors differ")
    report_check(bad, f"the mesh read side's own string indexes (packed in "
                      f"{out['pack_s']:.1f} s of host) and vectors, loaded "
                      f"from {RS_DIR}, equal the single device's: slab "
                      f"arrays, term and impact-prefix ranges, committed "
                      f"rows and their documents")

    cases = mesh_kinds(served["singles"], served["qtexts"])
    big = served["qtexts"][:RS_QUERIES]
    g = __import__("oramacore_tpu_torch.benches.ingest_bench",
                   fromlist=["GENRES"]).GENRES
    flat_batches, int8_batches = {}, {}
    for c in range(MESH_BATCH_CALLS):
        qs = big if c == 0 else big[::-1]
        flat_batches[f"batch fulltext B={len(qs)} #{c}"] = (
            "games", [{"term": q} for q in qs])
        flat_batches[f"batch genre B={len(qs)} #{c}"] = ("games", [
            {"term": q, "where": {"genre": g[i % len(g)]}}
            for i, q in enumerate(qs)])
        flat_batches[f"batch hybrid flat B={len(qs)} #{c}"] = ("games", [
            {"mode": "hybrid", "term": q, "similarity": RS_SIM} for q in qs])
        int8_batches[f"batch hybrid int8 B={len(qs)} #{c}"] = ("games", [
            {"mode": "hybrid", "term": q, "similarity": RS_SIM} for q in qs])

    # the slab's partition, timed apart (the first full-text search
    # would do it)
    t0 = time.perf_counter()
    ex = mesh._fused_executor(mesh.collections["games"], games)
    ex.ensure_slab(games.string)
    out["partition_s"] = ex.last_partition_s
    print(f"  games slab partitioned over {MESH_SHARDS} shards (doc % "
          f"{MESH_SHARDS}) in {out['partition_s']:.2f} s of host, on the "
          f"card in {time.perf_counter() - t0:.2f} s in all", flush=True)

    torch.cuda.reset_peak_memory_stats()
    pc_single, pc_mesh = {}, {}
    ref, _ = counted("phase 20, single device",
                     lambda: mesh_answers(single, cases, per_case=pc_single))
    got, mesh_l = counted("phase 20, the mesh",
                          lambda: mesh_answers(mesh, cases,
                                               per_case=pc_mesh))
    mesh_compare(ref, got, f"mesh ({MESH_SHARDS} shards on one card) "
                           f"against the single device, dense and pruned "
                           f"searches")
    rs_sanity(got, "mesh")

    batches_ref, _ = counted("phase 20, batches, single device",
                             lambda: mesh_batches(single, flat_batches,
                                                  pc_single))
    batches_got, b_mesh = counted("phase 20, batches, the mesh",
                                  lambda: mesh_batches(mesh, flat_batches,
                                                       pc_mesh))
    mesh_compare(batches_ref, batches_got,
                 f"mesh against the single device, {len(flat_batches)} "
                 f"search_batch calls at B={RS_QUERIES}")

    # the games' int8 IVF layout, built by each read side's own index
    # (deterministic kernels: the k-means sums in a fixed order) and held
    # layout to layout
    t0 = time.perf_counter()
    sv, mv = single.collections["games"].indexes["main"].vector, games.vector
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sv._build_ivf()
            mv._build_ivf()
    finally:
        torch.use_deterministic_algorithms(False)
    check(sv._ivf.keys() == mv._ivf.keys() and all(
        np.array_equal(sv._ivf[k], mv._ivf[k]) for k in sv._ivf),
        f"games vectors: the int8 IVF layouts the two read sides built "
        f"({len(mv._ivf['unit_starts']):,} probe units of "
        f"{mv._ivf['window']} rows, both in "
        f"{time.perf_counter() - t0:.2f} s) are equal: rows, scales, "
        f"documents, unit centroids and starts, permutation")
    pruned_hy = {f"pruned int8 hybrid {i}": (
        "games", served["singles"][f"hybrid {i}"][1], "on")
        for i in range(RS_KIND_QUERIES)}
    ref8, _ = counted("phase 20, int8, single device", lambda: (
        mesh_answers(single, pruned_hy, per_case=pc_single),
        mesh_batches(single, int8_batches, pc_single)))
    got8, i8_mesh = counted("phase 20, int8, the mesh", lambda: (
        mesh_answers(mesh, pruned_hy, per_case=pc_mesh),
        mesh_batches(mesh, int8_batches, pc_mesh)))
    mesh_compare(ref8[0], got8[0], "mesh against the single device, "
                                   "pruned int8 hybrid searches")
    mesh_compare(ref8[1], got8[1], f"mesh against the single device, "
                                   f"{len(int8_batches)} int8 hybrid "
                                   f"search_batch calls at B={RS_QUERIES}")
    check(all(r.count_estimated for rr in got8[0].values() for r in rr
              if r.hits), "the pruned int8 hybrid searches rode the pruned "
                          "tier (estimated counts)")
    mesh_launches_check(pc_single, pc_mesh, "the mesh's launches")
    launches = {k: mesh_l[k] + b_mesh[k] + i8_mesh[k] for k in mesh_l}
    for k in KERNELS:
        if k["mesh"]:
            check(launches[k["name"]] > 0,
                  f"the mesh path launched {k['name']} "
                  f"{launches[k['name']]} times")
    singles_l = {k: sum(c[k] for c in pc_single.values()) for k in launches}
    print(f"  mesh path launches (each kernel once a shard): {launches}; "
          f"single device on the same dense and pruned cases and batches: "
          f"{singles_l}", flush=True)
    out["launches"] = launches

    lat = {}   # a second pass, timed: the first one warmed every route
    mesh_answers(mesh, cases, lat)
    by_mode = {"fulltext": "fulltext", "price range": "price range",
               "facets": "facets", "sort": "sort asc",
               "group by": "group by genre", "vector": "vector",
               "hybrid": "hybrid",
               "passages hybrid (SemanticBase)": "passages hybrid",
               "pruned fulltext": "pruned fulltext",
               "pruned facets": "pruned facets"}
    before = rs_out.get("latency", {})
    for mode, kind in by_mode.items():
        ms = lat.get(kind, [])
        if not ms:
            continue
        p50, p99 = np.percentile(ms, 50), np.percentile(ms, 99)
        prev = before.get(mode)
        was = (f"; phase 17, one device: p50 {prev[0]:.3f} ms, p99 "
               f"{prev[1]:.3f} ms" if prev else "")
        print(f"  ReadSide.search on the mesh, {mode}: {len(ms)} calls, p50 "
              f"{p50:.3f} ms, p99 {p99:.3f} ms{was} [{card}]", flush=True)
    from oramacore_tpu_torch.types import SearchParams

    plist = [SearchParams.from_json({"term": q}) for q in big]
    for label, rs in (("mesh", mesh), ("single device", single)):
        steady = [timed_ms(lambda: rs.search_batch(
            "games", RS_KEYS["games"][0], plist))[1] for _ in range(3)]
        qps = len(plist) / min(steady) * 1e3
        out[f"qps {label}"] = qps
        print(f"  ReadSide.search_batch full-text B={len(plist)}, {label}: "
              f"{', '.join(f'{x:.2f}' for x in steady)} ms, {qps:,.1f} QPS "
              f"(best of 3; phase 17: "
              f"{rs_out.get(f'qps full-text B={len(plist)}', 0.0):,.1f}) "
              f"[{card}]", flush=True)
    out["device_ms"] = profile_once(
        f"mesh ReadSide.search_batch full-text B={len(plist)}",
        lambda: mesh.search_batch("games", RS_KEYS["games"][0], plist),
        card)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  peak device memory {out['peak_gib']:.3f} GiB (both read "
          f"sides) [{card}]", flush=True)
    mesh.sharded_mesh.close()
    del single, mesh
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    t_script = time.perf_counter()
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
    from oramacore_tpu_torch.ops import _build, attention

    print("[1] device", flush=True)
    require_cuda()
    device = torch.device("cuda")
    card = card_line()
    print(f"  card: {card}", flush=True)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)

    # the kernels (one nvcc a source) and the native host libraries (g++)
    # build in the background while [3] builds the host index
    print("[2] build the kernels and the native host libraries (in the "
          "background, while [3] builds the host index)", flush=True)
    from concurrent.futures import ThreadPoolExecutor

    from oramacore_tpu_torch import native
    from oramacore_tpu_torch.native import _build as native_build

    def seconds(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    t_build = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        kernels_s = pool.submit(seconds, _build.load_all)
        native_s = pool.submit(seconds, lambda: [load() for load in (
            native.load_tokenizer, native.load_hash_encoder,
            native.load_live_accum)])

        print(f"[3] the {N_DOCS:,}-doc index (bench_bm25_1m)", flush=True)
        t0 = time.perf_counter()
        idx = build_index(N_DOCS, VOCAB, POSTINGS_PER_DOC, seed=0)
        comm = idx.slab_split()[0]
        n_champ = (0 if idx._champ_matrix is None
                   else idx._champ_matrix.shape[0])
        print(f"  host index build {time.perf_counter() - t0:.2f} s: "
              f"{len(comm[0]):,} postings, {n_champ} champion rows",
              flush=True)
        batches = make_batches(1 + STEADY_BATCHES, BATCH, seed=1)
        kernel_secs, native_secs = kernels_s.result(), native_s.result()
    for mod in wrapper_modules():
        mod.load_kernels()
    attention.load_backward_kernels()
    for name, (secs, log) in sorted(_build.BUILD_LOG.items()):
        built = f"built by nvcc in {secs:.1f} s" if log else \
            "loaded from build/kernels/ (built earlier from the same sources)"
        print(f"  {name}.cu: {built}", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    print(f"  all kernels ready in {kernel_secs:.1f} s; native host libraries "
          f"(g++ {' '.join(native_build.CXX_FLAGS)}) in {native_secs:.1f} s: "
          + ", ".join(f"{k} {'built in %.1f s' % s if s else 'cached'}"
                      for k, s in sorted(native_build.BUILD_LOG.items()))
          + f"; [2] and [3] took {time.perf_counter() - t_build:.1f} s "
          f"together", flush=True)

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
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[16] training: SemanticBase at the script's defaults "
          f"({TRAIN_STEPS:,} of its 1,500 steps of B=64 pairs, L=16) "
          "through the attention kernels forward and "
          "backward, then the trained checkpoint served; "
          f"{WIDE_TRAIN_STEPS} steps at --hidden 256 --heads 1 through the "
          "wide kernels", flush=True)
    t_phase = time.perf_counter()
    train_timings, path_launches["train"] = phase_train(device, card)
    timings.update(train_timings)
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)

    gc.collect()
    torch.cuda.empty_cache()

    print(f"[17] the runtime: build_orama, {RS_DOCS:,} games documents and "
          f"{RS_PASSAGES:,} SemanticBase passages through WriteSide and the "
          f"op log, searches through ReadSide.search and search_batch",
          flush=True)
    t_phase = time.perf_counter()
    rs_out, served = phase_read_side(device, card)
    print(f"  phase 17: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print(f"[18] the API server: phase 17's runtime over a socket "
          f"(python -m oramacore_tpu_torch.server's ApiServer), then a "
          f"writer and a reader node on the tcp-stream op log", flush=True)
    t_phase = time.perf_counter()
    try:
        phase_server(served, device, card)
        print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        print("[19] RAG answers: phase 17's runtime served with the port's "
              "AIService and a scripted LLM (benches/llm_mock.py): /answer "
              "in three modes, planned answers, OpenAI chat, NLP queries, "
              "MCP, tools, system prompts, training sets, a hook on the "
              "hook-log SSE", flush=True)
        t_phase = time.perf_counter()
        phase_ai(served, device, card)
        print(f"  phase 19: {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        print(f"[20] the doc-sharded mesh: {MESH_SHARDS} shards on {device} "
              f"(mesh_devices) over phase 17's data, held to phase 17's "
              f"single-device read side", flush=True)
        t_phase = time.perf_counter()
        path_launches["mesh"] = phase_mesh(served, rs_out, device,
                                           card)["launches"]
        print(f"  phase 20: {time.perf_counter() - t_phase:.1f} s",
              flush=True)
    finally:
        served["orama"].stop()
    del served, rs_out
    gc.collect()
    torch.cuda.empty_cache()

    print(f"[21] training at scripts/train_semantic_encoder_tpu.py's full "
          f"width: 6 layers, 256 wide, B=256 pairs at L=32, "
          f"{TPU_TRAIN_STEPS:,} of its 1,200 steps, through the attention "
          f"kernels forward "
          f"and backward, then the checkpoint reloaded", flush=True)
    t_phase = time.perf_counter()
    path_launches["train_tpu"] = phase_train_tpu(device, card)
    print(f"  phase 21: {time.perf_counter() - t_phase:.1f} s", flush=True)

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
    print("  mesh launches (phase 20): " + ", ".join(
        f"{k['name']} {path_launches['mesh'][k['name']]}" for k in KERNELS
        if k["mesh"]), flush=True)
    print(f"  the whole script: {time.perf_counter() - t_script:.1f} s",
          flush=True)
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
