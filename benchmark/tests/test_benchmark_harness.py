"""The harness is driven by data: a new configuration, traffic mix,
per-layer metric and cell are found by name from BENCHMARK.json, with no
edit to a file that is there; and the result's last line keeps its shape."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run
from benchmark.tests._small import run_small

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _copy(tmp_path: Path) -> Path:
    dst = tmp_path / "checkout"
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_new_files_are_found_by_name(tmp_path):
    dst = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (dst / "benchmark").rglob("*")
              if p.is_file()}
    cfg = json.loads((BENCH / "configs" / "beir_quora.json").read_text())
    cfg["text"].update(n_docs=1500, vocab=2000)
    cfg["vectors"]["centers"] = 32
    (dst / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (dst / "benchmark" / "traffic" / "tiny_mix.json").write_text(json.dumps({
        "kind": "hybrid", "batch": 8, "k": 5, "terms_min": 1, "terms_max": 3,
        "similarity": 0.2, "pool_batches": 3, "warmup_batches": 1,
        "trace_batches": 2, "check_queries": 16}))
    (dst / "benchmark" / "metrics" / "tiny_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (dst / "benchmark" / "limits" / "tiny_cell.json").write_text(json.dumps(
        {"limits": {"score_err": 1e-4, "topk_gap": 1e-4, "count_off": 0}}))
    m = json.loads((dst / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny", "source": "a test",
                         "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "tiny_cell", "config": "tiny",
                           "traffic": "tiny_mix", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "tiny_metric", "unit": "x",
                           "better": "lower", "source": "device_trace",
                           "layer": "Device", "moves": "qps",
                           "workloads": ["tiny_cell"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(m))
    for p, data in before.items():
        assert p.read_bytes() == data
    code = (
        "import json\n"
        "from benchmark import run\n"
        "m = run.load_json(run.MANIFEST)\n"
        "e2e, layer = run.cell_metrics(m, 'tiny_cell')\n"
        "assert [x['name'] for x in layer] == ['tiny_metric'], layer\n"
        "assert run.load_reader('tiny_metric').read(None) == 42.0\n"
        "out, n = run.run_cell('tiny_cell', 5, 0.3, False, device='cpu')\n"
        "print(json.dumps([out['correct'], sorted(out['metrics']), n]))\n"
    )
    env = {"PYTHONPATH": f"{dst}:{ROOT}", "PATH": "/usr/bin:/bin"}
    import os
    env = {**os.environ, **env}
    res = subprocess.run([sys.executable, "-c", code], cwd=dst, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    correct, names, n = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and names == ["p95_ms", "qps", "setup_s"] and n > 0


def test_result_shape():
    out, _ = run_small("cqadup_fulltext")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"}
    assert list(out["compared"]) == ["score_err", "topk_gap", "count_off"]
    for v in out["compared"].values():
        assert set(v) == {"value", "limit"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "cqadup_fulltext", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 2 and res.stdout == ""


def test_manifest_names_files_under_paths():
    m = run.load_json(run.MANIFEST)
    for c in m["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    for w in m["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    for p in m["per_layer"]:
        assert (BENCH / "metrics" / f"{p['name']}.py").exists()
