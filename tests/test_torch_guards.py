"""Guards of the port: it never imports jax nor any module of the JAX
package, and it never runs silently on the CPU when a CUDA device was
asked for."""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs in a fresh interpreter: tests/conftest.py imports jax in-process.
_NO_JAX_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import numpy as np
    import oramacore_tpu_torch
    for m in pkgutil.walk_packages(oramacore_tpu_torch.__path__,
                                   "oramacore_tpu_torch."):
        importlib.import_module(m.name)
    from oramacore_tpu_torch.index.string_index import StringIndex
    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.index.search_exec import SharedBatchExecutor

    idx = StringIndex()
    rng = np.random.default_rng(0)
    for d in range(200):
        words = rng.choice(["alpha", "beta", "gamma", "delta"], 4)
        idx.index_text(d, "body", [(str(w), []) for w in words])
    idx.commit()
    ex = SharedBatchExecutor("cpu")
    qs = [["alpha", "beta"], ["gamma"]]
    plans = [plan_query(idx, q, ["body"], {}) for q in qs]
    v1, i1, _ = ex.search_topk(idx, plans, [200.0, 200.0], 200, 5)
    v2, i2, _ = ex.search_topk_shared(idx, qs, ["body"], {}, 200.0, 200, 5)
    assert np.allclose(v1, v2, rtol=1e-5) and v1[0, 0] > 0
    ranked, _ = ex.search_topk_sorted(
        idx, plans, [200.0, 200.0], 200, 5, sort_vals=np.arange(200.0),
        sort_present=np.ones(200, bool), svals_key=None, desc=True)
    docs = [d for d, _ in ranked[0]]
    assert len(docs) == 5 and docs == sorted(docs, reverse=True)
    _, _, _, pages = ex.search_topk_grouped(
        idx, plans, [200.0, 200.0], 200, 5, gid_col=np.arange(200) % 3,
        gid_key=None, n_groups=3, max_results=2)
    assert len(pages[0]) == 3
    from oramacore_tpu_torch.index.search_exec import PrunedPlanMixin
    pplans = [plan_query(idx, q, ["body"], {}, with_prefix=True) for q in qs]
    pv, pi, _ = PrunedPlanMixin("cpu").search_topk_pruned(
        idx, pplans, [200.0, 200.0], 200, 5)
    assert np.allclose(pv, v1, rtol=1e-5)  # the budget covers the corpus

    import torch
    from oramacore_tpu_torch.benches import pallas_bench
    from oramacore_tpu_torch.ops.gather_windows import gather_windows
    src = torch.arange(4096, dtype=torch.int32)
    out = gather_windows(src, torch.tensor([1024], dtype=torch.int32), w=1024)
    assert out[0, 0].item() == 1024
    d = pallas_bench.make_data(4, 1024, 4096, "cpu")
    pallas_bench.check_parity(pallas_bench.run_arms(d))

    from oramacore_tpu_torch.index.search_exec import HybridSearchTopK
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex, VectorIndexConfig)
    vecs = rng.normal(size=(200, 16)).astype(np.float32)
    vidx = VectorIndex(VectorIndexConfig(dim=16), "cpu")
    for d in range(200):
        vidx.insert(d, [vecs[d]])
    vidx.commit()
    assert 5 in vidx.search([vecs[5]], limit=3, similarity=0.0)   # flat
    flat = vidx.flat_device_rows()
    vidx._build_ivf()
    assert 5 in vidx.search([vecs[5]], limit=3, similarity=0.0)   # IVF
    q = vecs[:2] / np.linalg.norm(vecs[:2], axis=1, keepdims=True)
    hv, hi, _ = HybridSearchTopK("cpu").search_topk_hybrid(
        idx, plans, [200.0, 200.0], 200, 5, flat, q, [0.1, 0.1])
    assert hv[0, 0] > 0
    for tail in (dict(vec_rows=flat), dict(vec_rows_int8=vidx.int8_device_rows())):
        sv, si, _ = ex.search_topk_shared(idx, qs, ["body"], {}, 200.0, 200, 5,
                                          queries=q, similarities=[0.1, 0.1], **tail)
        assert sv[0, 0] > 0
    from oramacore_tpu_torch.benches import hybrid10m
    for name, v in dict(D=16, N_CENTERS=4, N_CENTROIDS=8, SAMPLE=128,
                        CHUNK=64, WINDOW=32, LLOYD_BLOCK=64).items():
        setattr(hybrid10m, name, v)
    lay = hybrid10m.build_layout(200, "cpu")
    hx = HybridSearchTopK("cpu")
    fc = hx.facet_counts_pruned(
        idx, pplans[0], 200, ("cat", np.arange(200) % 3, 3), None,
        vec=(lay, lay.mat[:1].float().numpy(), 0.0, None))
    assert fc.sum() >= hx.facet_match_count(pplans[0]) > 0
    hv2, _, _ = hx.search_topk_hybrid_int8_pruned(
        idx, pplans, [200.0, 200.0], 200, 5, lay.int8_device_rows(),
        lay.int8_doc2row(256), q[:, :16].copy(), [0.1, 0.1])
    assert hv2[0, 0] > 0
    from oramacore_tpu_torch.embeddings import EmbeddingsService, Intent
    from oramacore_tpu_torch.embeddings.encoder import (
        register_bundled_checkpoints)
    assert register_bundled_checkpoints("cpu") == ["SemanticBase",
                                                   "SemanticMini"]
    ev = EmbeddingsService().calculate_embeddings(
        ["buy car", "automobile purchase"], Intent.PASSAGE, "SemanticMini")
    assert abs(float(np.linalg.norm(ev[0][0])) - 1) < 1e-5
    assert float(ev[0][0] @ ev[1][0]) > 0.5
    # the ingest path: JSON documents through the native tokenizer, live
    # accumulator and hash encoder, the op bodies and the embedding queue
    from oramacore_tpu_torch.benches import ingest_bench as ib
    from oramacore_tpu_torch.index.plan import query_tokens
    from oramacore_tpu_torch.native import ROUTES
    from oramacore_tpu_torch.types import Locale
    from oramacore_tpu_torch.utils.tokenizer import TextParser
    from oramacore_tpu_torch.write.embedding_queue import EmbeddingQueue
    words, stems = ib.vocabulary(500, seed=1)
    sidx = StringIndex()
    vidx2 = VectorIndex(VectorIndexConfig(dim=384), "cpu")
    eq = EmbeddingQueue(EmbeddingsService(), lambda c, b: vidx2.insert(
        b["doc_id"], [np.asarray(v, np.float32) for v in b["vectors"]]))
    parser = TextParser(Locale.EN)
    ib.ingest(ib.documents(300, seed=2, words=words), parser, sidx, eq, {})
    assert eq.flush_and_wait(timeout=60) and eq.failed_batches == 0
    eq.stop()
    sidx.commit()
    vidx2.commit()
    assert len(vidx2._committed_docs) == 300
    toks = [query_tokens(parser, q, False) for q in ib.queries(stems, 4)]
    tv, _, _ = ex.search_topk_shared(sidx, toks, ["title", "description"], {},
                                     300.0, 300, 5)
    assert tv.max() > 0 and sidx._native_live is not None
    assert all(ROUTES[k]["native"] > 0 for k in ROUTES), ROUTES
    # the trainer: two CPU updates at a small width, then its save
    import tempfile
    from oramacore_tpu_torch.train import semantic_encoder as se
    tr = se.SemanticTrainer(se.TrainConfig(steps=2, batch=8, layers=1,
                                           hidden=32, heads=2, ffn=64), "cpu")
    tr.run(log=lambda s: None)
    with tempfile.TemporaryDirectory() as d:
        tr.save(d)
        from oramacore_tpu_torch.embeddings.encoder import TorchTextEncoder
        tv = TorchTextEncoder(d, "cpu").encode(["car"])
        assert abs(float(np.linalg.norm(tv[0])) - 1) < 1e-5
    # the runtime: build_orama on the CPU, a collection through the
    # write side, the op log and the read side, a search, a commit and a
    # reload from the snapshots
    import tempfile as _tf
    from oramacore_tpu_torch.config import OramacoreConfig
    from oramacore_tpu_torch.runtime import build_orama
    from oramacore_tpu_torch.types import SearchParams
    cfg = OramacoreConfig()
    cfg.data_dir = _tf.mkdtemp()
    orama = build_orama(cfg, device="cpu", sync_embeddings=True,
                        start_consumer=False)
    coll = orama.write_side.create_collection(None, "c")
    orama.write_side.create_index("c", coll.write_api_key, "i")
    orama.write_side.insert_documents("c", "i", coll.write_api_key, [
        {"id": str(i), "t": f"red fox {i}", "n": i} for i in range(20)])
    orama.read_side.pump()
    orama.write_side.commit()
    orama.read_side.commit(force=True)
    orama.stop()
    orama = build_orama(cfg, device="cpu", sync_embeddings=True,
                        start_consumer=False)
    res = orama.read_side.search("c", coll.read_api_key, SearchParams.from_json(
        {"term": "fox", "where": {"n": {"lt": 5}}, "facets": {"n": {
            "ranges": [{"from": 0, "to": 9}]}}}))
    # facets count the unfiltered matches (the reference's facet quirk)
    assert res.count == 5 and res.facets["n"].values == {"0-9": 10}, res
    orama.stop()
    # the doc-sharded mesh: the same collection on two CPU shards, and
    # the toy sharded step
    cfg.reader_side.sharded_shards = 2
    orama = build_orama(cfg, device="cpu", sync_embeddings=True,
                        start_consumer=False, mesh_devices=["cpu", "cpu"])
    assert orama.read_side.sharded_mesh is not None
    res2 = orama.read_side.search("c", coll.read_api_key, SearchParams.from_json(
        {"term": "fox", "where": {"n": {"lt": 5}}}))
    assert res2.count == 5, res2
    orama.stop()
    from oramacore_tpu_torch import parallel as par
    toy = par.make_toy_sharded_index(2, 64, 8, 16, 8)
    step = par.make_sharded_search_step(par.build_mesh(1, 2, ["cpu"] * 2),
                                        lr=8, cap=16, k=4)
    ids, vals = step(*toy, torch.zeros((2, 1, 1), dtype=torch.int32),
                     torch.full((2, 1, 1), 4, dtype=torch.int32),
                     torch.ones((2, 1, 1)), torch.full((2, 1, 1), 25.0),
                     torch.ones((2, 8)) / 8 ** 0.5, 32.0, 0.5)
    assert ids.shape == (2, 4) and bool(torch.isfinite(vals).all())
    for name in ("oramacore_tpu_torch.runtime",
                 "oramacore_tpu_torch.config",
                 "oramacore_tpu_torch.metrics",
                 "oramacore_tpu_torch.oplog",
                 "oramacore_tpu_torch.storage.files",
                 "oramacore_tpu_torch.storage.kv",
                 "oramacore_tpu_torch.storage.docstore",
                 "oramacore_tpu_torch.index.filter_fields",
                 "oramacore_tpu_torch.read",
                 "oramacore_tpu_torch.read.read_index",
                 "oramacore_tpu_torch.read.pin_rules",
                 "oramacore_tpu_torch.read.analytics",
                 "oramacore_tpu_torch.utils.trace",
                 "oramacore_tpu_torch.utils.locks",
                 "oramacore_tpu_torch.write",
                 "oramacore_tpu_torch.train.semantic_encoder",
                 "oramacore_tpu_torch.benches.train_bench",
                 "oramacore_tpu_torch.embeddings",
                 "oramacore_tpu_torch.native",
                 "oramacore_tpu_torch.native._build",
                 "oramacore_tpu_torch.types",
                 "oramacore_tpu_torch.utils.tokenizer",
                 "oramacore_tpu_torch.utils.snowball",
                 "oramacore_tpu_torch.utils.code_parser",
                 "oramacore_tpu_torch.benches.stem_vocab",
                 "oramacore_tpu_torch.train.semantic_encoder_tpu",
                 "oramacore_tpu_torch.utils.flatten",
                 "oramacore_tpu_torch.write.doc_op",
                 "oramacore_tpu_torch.write.embedding_queue",
                 "oramacore_tpu_torch.benches.ingest_bench",
                 "oramacore_tpu_torch.embeddings.encoder",
                 "oramacore_tpu_torch.embeddings.safetensors_io",
                 "oramacore_tpu_torch.embeddings.wordpiece",
                 "oramacore_tpu_torch.ops.attention",
                 "oramacore_tpu_torch.benches.encoder_bench",
                 "oramacore_tpu_torch.ops.gather_windows",
                 "oramacore_tpu_torch.ops.pruned",
                 "oramacore_tpu_torch.ops.facet_hist",
                 "oramacore_tpu_torch.benches.hybrid10m",
                 "oramacore_tpu_torch.benches.pallas_bench",
                 "oramacore_tpu_torch.ops.hybrid",
                 "oramacore_tpu_torch.index.vector_index",
                 "oramacore_tpu_torch.parallel",
                 "oramacore_tpu_torch.parallel.mesh",
                 "oramacore_tpu_torch.parallel.engine"):
        assert name in sys.modules, name
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "aiohttp", "msgpack", "yaml", "transformers", "safetensors",
        "optax", "scripts", "cryptography", "nltk"))
    assert not leaked, leaked
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    assert not leaked, leaked
    leaked = sorted(m for m in sys.modules
                    if m == "oramacore_tpu" or m.startswith("oramacore_tpu."))
    assert not leaked, leaked
    print("NO_JAX_OK")
""")


def test_port_never_imports_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


_IMPORT_OF_JAX_PACKAGE = re.compile(
    r"^\s*(from\s+oramacore_tpu(\.\S*)?\s+import\b"
    r"|import\s+oramacore_tpu(\.\S*)?(\s|,|$))", re.M)


def test_no_source_of_the_port_imports_the_jax_package():
    """No .py file of oramacore_tpu_torch/ and no line of chip_smoke.py
    imports oramacore_tpu or a module under it."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "oramacore_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    found = []
    for path in files:
        with open(path) as f:
            for m in _IMPORT_OF_JAX_PACKAGE.finditer(f.read()):
                found.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not found, found
    # the pattern itself: it finds both forms, and not the port's own name
    for line, hit in (("from oramacore_tpu.index import x", True),
                      ("import oramacore_tpu.ops.bm25 as b", True),
                      ("    import oramacore_tpu", True),
                      ("from oramacore_tpu_torch.ops import x", False),
                      ("import oramacore_tpu_torch", False)):
        assert bool(_IMPORT_OF_JAX_PACKAGE.search(line)) == hit, line


_IMPORT_OF_ABSENT_PACKAGE = re.compile(
    r"^\s*(from|import)\s+(jax|jaxlib|flax|transformers|safetensors|msgpack"
    r"|yaml|aiohttp|optax|scripts|cryptography|nltk)(\.\S*)?(\s|,|$)", re.M)


def test_no_source_of_the_port_imports_jax_transformers_or_safetensors():
    """The card's machine has none of them: no .py file of
    oramacore_tpu_torch/ and no line of chip_smoke.py imports jax,
    transformers, safetensors, msgpack, yaml, aiohttp, optax,
    cryptography or nltk, even inside a function;
    nor the repo's scripts/ (the trainer keeps its own copy of what it
    needs of scripts/train_semantic_encoder_v2.py)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "oramacore_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    found = []
    for path in files:
        with open(path) as f:
            for m in _IMPORT_OF_ABSENT_PACKAGE.finditer(f.read()):
                found.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not found, found
    for line, hit in (("import jax", True), ("    import jax.numpy as jnp", True),
                      ("from transformers import AutoTokenizer", True),
                      ("from safetensors.numpy import load_file", True),
                      ("from . import safetensors_io", False),
                      ("    import optax", True),
                      ("import scripts.train_semantic_encoder_v2 as s", True),
                      ("from scripts import train_semantic_encoder_v2", True),
                      ("import yaml", True),
                      ("    from aiohttp import web", True),
                      ("import yamlx", False),
                      ("    from cryptography.hazmat.primitives import x",
                       True),
                      ("import cryptographyx", False),
                      ("import scriptsx", False),
                      ("import jaxtyping", False),
                      ("    from nltk.stem.snowball import SnowballStemmer",
                       True),
                      ("from .snowball import SnowballStemmer", False),
                      ("import nltkx", False)):
        assert bool(_IMPORT_OF_ABSENT_PACKAGE.search(line)) == hit, line


_SERVER_IMPORTS = textwrap.dedent("""
    import sys
    import oramacore_tpu_torch.server
    import oramacore_tpu_torch.server.__main__
    import oramacore_tpu_torch.auth
    import oramacore_tpu_torch.ai.hooks
    import oramacore_tpu_torch.client
    import oramacore_tpu_torch.utils.hurl
    import oramacore_tpu_torch.utils.secrets
    import oramacore_tpu_torch.utils.yaml_subset
    import oramacore_tpu_torch.utils.logs
    from oramacore_tpu_torch.config import load_config
    cfg = load_config("config.example.yaml")
    assert cfg.auth.master_api_key == "change-me"
    banned = ("jax", "oramacore_tpu", "aiohttp", "yaml", "cryptography",
              "msgpack")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
    assert not leaked, leaked
    print("SERVER_IMPORTS_OK")
""")


def test_server_auth_hooks_and_client_import_nothing_banned():
    """The server, auth, hooks, client, hurl, secrets, logging and YAML
    modules (and reading config.example.yaml) leave no jax, JAX package,
    aiohttp, yaml, cryptography or msgpack module in a fresh
    interpreter."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SERVER_IMPORTS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SERVER_IMPORTS_OK" in proc.stdout


_AI_IMPORTS = textwrap.dedent("""
    import sys
    import oramacore_tpu_torch.ai.service
    import oramacore_tpu_torch.ai.answer
    import oramacore_tpu_torch.ai.llms
    import oramacore_tpu_torch.ai.accelerator
    import oramacore_tpu_torch.benches.llm_mock
    banned = ("jax", "oramacore_tpu", "aiohttp", "yaml", "cryptography",
              "msgpack")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
    assert not leaked, leaked
    print("AI_IMPORTS_OK")
""")


def test_ai_service_and_llm_mock_import_nothing_banned():
    """The AI service, the answer machine, the LLM client and the LLM
    mock leave no jax, JAX package, aiohttp, yaml, cryptography or
    msgpack module in a fresh interpreter."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _AI_IMPORTS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "AI_IMPORTS_OK" in proc.stdout


def test_server_main_without_a_card_exits_non_zero():
    """`python -m oramacore_tpu_torch.server` defaults to the card and has
    no CPU fallback: without one it exits non-zero, naming CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "oramacore_tpu_torch.server", "--config",
         "config.example.yaml"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr, proc.stderr
    assert "listening" not in proc.stdout


def test_cuda_executor_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    from oramacore_tpu_torch import require_cuda
    from oramacore_tpu_torch.index.search_exec import (
        HybridSearchTopK,
        SharedBatchExecutor,
        StringSearchExecutor,
        StringSearchTopK,
    )
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )

    for cls in (StringSearchExecutor, StringSearchTopK, SharedBatchExecutor,
                HybridSearchTopK):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorIndex(VectorIndexConfig(dim=8), "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        require_cuda()


def test_mesh_step_with_a_kernel_that_fails_to_build_raises(monkeypatch,
                                                            tmp_path):
    """A mesh step on tensors the wrapper takes for CUDA ones, with a
    kernel whose build fails (no nvcc): every shard's launch raises, the
    step aborts and re-raises in the caller, and no plain version runs
    in the kernel's place."""
    import numpy as np

    from oramacore_tpu_torch.index.string_index import StringIndex
    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.ops import _build, score_windows as sw
    from oramacore_tpu_torch.parallel.engine import (
        ShardedStringExec,
        build_engine_mesh,
    )

    def no_nvcc():
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")

    plain = []
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(sw, "_lib", None)
    monkeypatch.setattr(sw, "_device_of", lambda ts: torch.device("cuda"))
    monkeypatch.setattr(sw, "score_ranges_accumulate_plain",
                        lambda *a, **kw: plain.append(1))
    idx = StringIndex()
    rng = np.random.default_rng(0)
    for d in range(64):
        idx.index_text(d, "body", [(str(w), []) for w in rng.choice(
            ["alpha", "beta", "gamma"], 3)])
    idx.commit()
    mesh = build_engine_mesh(2, ["cpu", "cpu"])
    try:
        ex = ShardedStringExec(mesh)
        plans = [plan_query(idx, ["alpha"], ["body"], {})]
        before = dict(sw.LAUNCHES)
        with pytest.raises(RuntimeError, match="nvcc"):
            ex.search_topk(idx, plans, [64.0], 64, 5)
        assert plain == [] and sw.LAUNCHES == before
    finally:
        mesh.close()


def test_executor_needs_an_explicit_device():
    from oramacore_tpu_torch.index.search_exec import SharedBatchExecutor
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )

    with pytest.raises(TypeError):
        SharedBatchExecutor()  # no "CUDA if present, else CPU" default
    with pytest.raises(ValueError):
        SharedBatchExecutor("meta")
    with pytest.raises(TypeError):
        VectorIndex(VectorIndexConfig(dim=8))
    with pytest.raises(ValueError):
        VectorIndex(VectorIndexConfig(dim=8), "meta")


def test_kernel_wrapper_refuses_mixed_devices():
    from oramacore_tpu_torch.ops.score_windows import score_windows

    dev = torch.device("meta")
    with pytest.raises(ValueError):
        score_windows(
            torch.zeros(8, dtype=torch.int32), torch.zeros(8),
            torch.zeros(8, device=dev), torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 4)), w=4,
        )


def _ported_rows_of_perf_md():
    """Entry points of the rows marked "ported" in PERF.md's kernel table
    (the table whose header names "Entry point")."""
    import re

    names, in_table = set(), False
    with open(os.path.join(REPO, "PERF.md")) as f:
        for line in f:
            if not line.startswith("|"):
                in_table = False
                continue
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if "Entry point" in line:
                in_table = True
                status_col = next(i for i, c in enumerate(cells)
                                  if c.startswith("Status"))
                continue
            if in_table and cells[status_col].startswith("ported"):
                names.add(re.search(r"`(\w+)`", cells[1]).group(1))
    return names


def test_kernel_table_covers_every_wrapper_and_perf_row():
    """chip_smoke.py's table of kernels (which builds its `kernels` line)
    names every counted entry point of every wrapper, every "ported" row
    of PERF.md's kernel tables, and every TPU kernel of the JAX package.
    A row with `jitted=True` replaces jitted JAX code instead of a Pallas
    kernel: its `replaces` names a function of a module that jits."""
    import importlib
    import pkgutil

    import chip_smoke
    import oramacore_tpu_torch.ops as ops

    table = {k["name"]: k for k in chip_smoke.KERNELS}
    assert len(table) == len(chip_smoke.KERNELS)
    counted = {}
    for m in pkgutil.iter_modules(ops.__path__, "oramacore_tpu_torch.ops."):
        mod = importlib.import_module(m.name)
        for name in getattr(mod, "LAUNCHES", {}):
            counted[name] = m.name
    assert set(table) == set(counted)
    assert set(table) == _ported_rows_of_perf_md()
    replaced = set()
    jitted = 0
    for name, k in table.items():
        assert k["module"] == counted[name], name
        assert k["route"] in ("cuda", "triton")
        assert os.path.isfile(os.path.join(REPO, k["source"])), k["source"]
        path, line = k["replaces"].rsplit(":", 1)
        with open(os.path.join(REPO, path)) as f:
            text = f.read()
        # a function of the module, or (the training step) one that a
        # function of the script defines and jits
        assert text.splitlines()[int(line) - 1].lstrip().startswith("def "), \
            k["replaces"]
        if k.get("jitted"):
            # jax.jit, or flax_encoder.py's `@partial(__import__("jax").jit, ...)`
            assert "jax.jit" in text or '__import__("jax").jit' in text, path
            jitted += 1
        else:
            assert "pl.pallas_call" in text, path
            replaced.add(path)
    # assign_rows_accumulate and count_present (the shared path's
    # assignment products and the df around them), rescore_bsearch, rescore_worklist (the pruned tier), facet_hist,
    # facet_hist_multi (its facets), encoder_attention (the text encoder),
    # encoder_attention_backward_dq and _dkv (its training step)
    assert jitted == 9
    assert table["encoder_attention_backward_dq"]["replaces"] == \
        "scripts/train_semantic_encoder_v2.py:304"
    # the kernels phase 20's mesh path launches (once a shard), whose
    # rows of PERF.md's tables give their mesh launches
    mesh = {n for n, k in table.items() if k["mesh"]}
    assert mesh == {"score_ranges_accumulate", "assign_rows_accumulate",
                    "count_present", "rescore_bsearch", "rescore_worklist",
                    "facet_hist", "encoder_attention"}
    with open(os.path.join(REPO, "PERF.md")) as f:
        rows = [line for line in f if line.startswith("|")]
    for name in mesh:
        assert any(f"`{name}`" in r and "phase 20" in r for r in rows), name
    pallas_files = set()
    for root, _, files in os.walk(os.path.join(REPO, "oramacore_tpu")):
        for fn in files:
            full = os.path.join(root, fn)
            if fn.endswith(".py") and "pl.pallas_call(" in open(full).read():
                pallas_files.add(os.path.relpath(full, REPO))
    assert pallas_files and pallas_files <= replaced, pallas_files - replaced


def test_profile_counts_name_each_kernel():
    """chip_smoke.profile_once holds a profile's kernel counts to the
    wrappers' LAUNCHES: each KERNELS entry maps to a __global__ function
    of its source, and a profiler key counts for its own entry alone."""
    import chip_smoke

    assert set(chip_smoke.KERNEL_FUNCTIONS) == {k["name"]
                                                for k in chip_smoke.KERNELS}
    for k in chip_smoke.KERNELS:
        with open(os.path.join(REPO, k["source"])) as f:
            src = f.read()
        func = chip_smoke.KERNEL_FUNCTIONS[k["name"]]
        assert re.search(rf"__global__[^;{{]*?\b{func}\s*\(", src), k["name"]
    got = chip_smoke.profiled_counts([
        ("void score_ranges_accumulate_kernel<true, false>(int const*, "
         "float const*, float const*, long)", 35),
        ("void work_list_kernel(int const*, int const*, long, long long*)", 9),
        ("void facet_hist_multi_kernel(int const*, int const*)", 2),
        ("void facet_hist_kernel(int const*, int const*)", 3),
        ("void rescore_worklist_kernel<true>(int const*)", 6),
        ("worklist_tail_kernel(float const*, int const*)", 5),
        ("void encoder_attention_kernel<32, 4, 64>(float const*)", 4),
        ("void encoder_attention_kernel<64, 1, 32>(float const*)", 4),
        ("ampere_sgemm_128x64_nn", 16),
        ("void (anonymous namespace)::assign_rows_accumulate_kernel<true>("
         "float const*, long, long, float const*)", 73),
        ("_ZN12_GLOBAL__N_129assign_rows_accumulate_kernelILb0EEEvPKfllS2_ll"
         "fPKilliffPfS5_l", 1),
        ("void (anonymous namespace)::count_present_kernel<true>(float const*, "
         "long, float*)", 69),
        # mangled names, as the profiler gives a ctypes library's kernels
        ("_Z21gather_windows_kernelPKiS0_lPil", 7),
        ("_Z22rescore_bsearch_kernelILb1EEvPKiPKfS3_l", 1),
        ("_Z17facet_hist_kernelPKiS0_", 1),
        ("_Z23facet_hist_multi_kernelPKiS0_", 1),
        ("_ZN12_GLOBAL__N_130score_ranges_accumulate_kernelILb1ELb0EEEvPKiPKf"
         "S4_lS2_S2_S4_S4_S4_llPKxPfl", 1),
        ("_ZN12_GLOBAL__N_124encoder_attention_kernelILi32ELi4ELi64EEEvPKf", 2),
        ("void (anonymous namespace)::attention_dq_kernel<32>(float const*)", 8),
        ("void (anonymous namespace)::attention_dkv_kernel<32>(float const*)",
         8),
        ("_ZN62_GLOBAL__N__593f5441_29_encoder_attention_backward_cu_405d82f1"
         "19attention_dq_kernelILi32EEEvPKfPKiS2_PfP6float4iiif", 1),
        ("_ZN62_GLOBAL__N__593f5441_29_encoder_attention_backward_cu_405d82f1"
         "20attention_dkv_kernelILi128EEEvPKfPKiS2_PK6float4Pfiiif", 2),
    ])
    assert got == dict(score_windows=0, score_ranges_accumulate=36,
                       gather_windows=7, assign_rows_accumulate=74,
                       count_present=69,
                       rescore_bsearch=1, rescore_worklist=5,
                       facet_hist=4, facet_hist_multi=3, encoder_attention=10,
                       encoder_attention_backward_dq=9,
                       encoder_attention_backward_dkv=10)


class _FakeProfile:
    """torch.profiler.profile's surface that chip_smoke.profile_once uses:
    on its second step it hands `on_trace_ready` the next reading of
    `readings` (the profiled count of encoder_attention_kernel); each step
    is written to `log`."""

    def __init__(self, readings, log, **kw):
        self.readings, self.log = readings, log
        self.ready, self.steps = kw["on_trace_ready"], 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step(self):
        self.steps += 1
        self.log.append("step")
        if self.steps == 2:
            n = self.readings.pop(0)
            event = type("Event", (), dict(
                self_device_time_total=5.0, count=n, device_type="CUDA",
                key="void encoder_attention_kernel<32, 4, 64>(float const*)"))
            self.ready(type("Prof", (), dict(key_averages=lambda s: [event]))())


@pytest.mark.parametrize("readings,ok", [
    ([1], True), ([0, 0, 0], False), ([2, 2, 2], False),
    ([0, 1], True), ([2, 0, 1], True)])
def test_profile_once_holds_each_reading_to_the_launches(monkeypatch, readings,
                                                         ok):
    """Each reading's kernel count must equal the wrappers' LAUNCHES for
    the profiled call: one that does not is taken again, and the phase
    fails when PROFILE_TRIES readings all miss; the kept reading is a
    matching one. The call starts PROFILE_EDGE_S after the window opens
    and the window closes PROFILE_EDGE_S after it."""
    import chip_smoke
    from oramacore_tpu_torch.ops import attention as at

    left, log, schedules = list(readings), [], []
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: schedules.append(kw["schedule"])
                        or _FakeProfile(left, log, **kw))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: log.append("sync"))
    monkeypatch.setattr(chip_smoke.time, "sleep",
                        lambda s: log.append(("sleep", s)))

    def call():   # one launch of the attention a call, as a wrapper counts
        at.LAUNCHES["encoder_attention"] += 1
        log.append("call")

    before = dict(at.LAUNCHES)
    try:
        if ok:
            assert chip_smoke.profile_once("fake", call, "CPU") == 5.0 / 1e3
        else:
            with pytest.raises(chip_smoke.SmokeFailure, match="missed"):
                chip_smoke.profile_once("fake", call, "CPU")
        assert not left
        assert ok or len(readings) == chip_smoke.PROFILE_TRIES
        assert log.count("step") == 2 * len(readings)
        # one cycle: the step that closes the window starts no new trace
        act = torch.profiler.ProfilerAction
        assert [[sched(i) for i in range(3)] for sched in schedules] == [
            [act.WARMUP, act.RECORD_AND_SAVE, act.NONE]] * len(readings)
        edge = ("sleep", chip_smoke.PROFILE_EDGE_S)
        assert chip_smoke.PROFILE_EDGE_S > 0
        assert log[-8:] == ["call", "sync", "step", edge, "call", "sync",
                            edge, "step"]
    finally:
        at.LAUNCHES.update(before)
