"""Guards of the port: it never imports jax, and it never runs silently on
the CPU when a CUDA device was asked for."""

import os
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
    from oramacore_tpu.index.string_index import StringIndex
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
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
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


def test_cuda_executor_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    from oramacore_tpu_torch import require_cuda
    from oramacore_tpu_torch.index.search_exec import (
        SharedBatchExecutor,
        StringSearchExecutor,
        StringSearchTopK,
    )

    for cls in (StringSearchExecutor, StringSearchTopK, SharedBatchExecutor):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        require_cuda()


def test_executor_needs_an_explicit_device():
    from oramacore_tpu_torch.index.search_exec import SharedBatchExecutor

    with pytest.raises(TypeError):
        SharedBatchExecutor()  # no "CUDA if present, else CPU" default
    with pytest.raises(ValueError):
        SharedBatchExecutor("meta")


def test_kernel_wrapper_refuses_mixed_devices():
    from oramacore_tpu_torch.ops.score_windows import score_windows

    dev = torch.device("meta")
    with pytest.raises(ValueError):
        score_windows(
            torch.zeros(8, dtype=torch.int32), torch.zeros(8),
            torch.zeros(8, device=dev), torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 4)), w=4,
        )
