"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`configs/<file>`) and a traffic mix (`traffic/<traffic>.json`); per-layer
metrics are read by `metrics/<name>.py`. Set-up makes the corpus from the
seed, builds the collection through the program's write side, draws the
batches and runs the warm-up batches; then one client sends distinct
batches back to back for `--seconds`, each timed on the host clock from
the executor call until its results are on the host. With `--trace 1` a
profiled window of whole batches follows, and the per-layer metrics are
read from it. Last, with the program's state freed, a sample of the
window's answers is checked against the plain reference.

The last line of standard output is the result; the numbers compared
with their limits are the last lines of standard error and the last key
of the result. No card, or fewer cards than the cell asks for: exit 2, no
result. JAX or the JAX package loaded in this process: exit 3, no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
BANNED = ("jax", "jaxlib", "flax", "oramacore_tpu")
REF_CHUNK = 64    # queries the reference scores at once


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, workload: str):
    """(workload entry, configuration entry, configuration, traffic)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return w, conf, cfg, traffic


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(manifest: dict, workload: str):
    """(end-to-end metrics, per-layer metrics) that this cell reports."""
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if _applies(m, workload) and m["moves"] in names]
    return e2e, layer


def load_reader(name: str):
    """The reader module of per-layer metric `name`
    (`metrics/<name>.py`, whose `read(ctx)` returns a number or None)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


class Cell:
    """One cell set up: corpus, the program's collection, the batches."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 wrap_search: Optional[Callable] = None):
        from . import corpus
        from .system import System
        from .traffic import Batches, make_pool

        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.stages: Dict[str, float] = {}
        t = time.perf_counter()
        self.text = corpus.make_text(cfg, seed, device)
        self.vecs = corpus.make_vectors(cfg, seed, device)
        self.stages["generate_s"] = time.perf_counter() - t
        self.system = System(cfg, self.text, self.vecs, device)
        self.stages.update(self.system.stages)
        t = time.perf_counter()
        self.pool = make_pool(traffic, self.text, self.vecs, seed, device)
        self.batches = Batches(self.pool, int(traffic["pool_batches"]),
                               corpus.term_strings(self.text.vocab))
        self.stages["traffic_s"] = time.perf_counter() - t
        self.k = int(traffic["k"])
        self.hybrid = traffic["kind"] == "hybrid"
        self.search = self.system.search
        if wrap_search is not None:
            self.search = wrap_search(self.search)

    def call(self, slot: int, text_only: bool = False, tokens=None):
        if tokens is None:
            tokens = self.batches.tokens(slot)
        q = None
        if self.hybrid and not text_only:
            q = self.pool.vectors[slot]
        return self.search(tokens, self.k, q, self.pool.similarity)

    def warm_up(self, sync: Callable[[], None]) -> None:
        t = time.perf_counter()
        for slot in self.batches.warmup_slots():
            self.call(slot)
            if self.hybrid:
                self.call(slot, text_only=True)
        sync()
        self.stages["warmup_s"] = time.perf_counter() - t

    def work(self, slots) -> Dict[str, float]:
        """What the traced batches must do, counted from the generator's
        data: the postings of each batch's distinct terms (mean), the
        batch, k and the vector rows."""
        df = self.text.df
        posts = []
        for s in slots:
            t = self.pool.terms[s]
            posts.append(int(df[np.unique(t[t >= 0])].sum()))
        return {"postings": float(np.mean(posts)),
                "batch": int(self.traffic["batch"]), "k": self.k,
                "n_rows": self.text.n_docs if self.hybrid else 0,
                "dim": self.vecs.dim if self.hybrid else 0}


def run_window(cell: Cell, seconds: float, sync: Callable[[], None]):
    """The closed loop: (latencies s, [(slot, result)], window s)."""
    lat, results = [], []
    i = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        slot = cell.batches.slot_of(i)
        tokens = cell.batches.tokens(slot)
        t = time.perf_counter()
        out = cell.call(slot, tokens=tokens)
        lat.append(time.perf_counter() - t)
        results.append((slot, out))
        i += 1
    sync()
    return lat, results, time.perf_counter() - t_start


def reference_of(cell: Cell, device):
    from .reference import Reference

    return Reference(cell.text.n_docs, cell.text.vocab, cell.text.n_tokens,
                     cell.text.tokens, cell.vecs.rows if cell.vecs else None,
                     device)


def check_answers(cell: Cell, results, device, seed: int, ref=None):
    """The compared numbers over a sample of the window's answers, and
    how many were checked. Runs once the program's collection is freed."""
    from .check import compare, sample_queries
    from .corpus import stream_seed

    B = int(cell.traffic["batch"])
    slots = np.array([s for s, _ in results])
    terms = cell.pool.terms[slots].reshape(-1, cell.pool.terms.shape[-1])
    n_terms = cell.pool.n_terms[slots].reshape(-1)
    heavy = cell.text.df[np.where(terms >= 0, terms, 0)] * (terms >= 0)
    must = int(np.argmax(heavy.sum(axis=1)))
    rng = np.random.default_rng(stream_seed(seed, "check"))
    picks = sample_queries(len(terms), int(cell.traffic["check_queries"]),
                           must, rng)
    ref = ref or reference_of(cell, device)
    got, scored = [], []
    for c0 in range(0, len(picks), REF_CHUNK):
        chunk = picks[c0:c0 + REF_CHUNK]
        tl = [terms[p][:n_terms[p]].tolist() for p in chunk]
        qv = None
        if cell.hybrid:
            qv = np.stack([cell.pool.vectors[slots[p // B]][p % B]
                           for p in chunk])
        scored.extend(ref.scores(tl, qv, cell.pool.similarity))
        for p in chunk:
            vals, ids, counts = results[p // B][1]
            got.append((vals[p % B], ids[p % B], counts[p % B]))
    return compare(got, scored, cell.k), len(picks)


class TraceContext:
    """What a per-layer reader sees: the traced reading, its variants
    (read on demand from the same batches), the batches' work, and a
    place to note a bound beside the card's power limit."""

    def __init__(self, reading, variants: Dict[str, Callable], work: dict,
                 power: str):
        self.reading = reading
        self._variants = variants
        self._cache: Dict[str, object] = {}
        self.work = work
        self.power = power

    def variant(self, name: str):
        if name not in self._cache:
            self._cache[name] = self._variants[name]()
        return self._cache[name]

    def note(self, metric: str, bound_s: float, which: str) -> None:
        log(f"{metric}: least time {bound_s * 1e3:.6f} ms a batch "
            f"({which}-bound, published H100 SXM peaks) against "
            f"{self.reading.busy_ms_per_batch:.4f} device-busy ms a batch; "
            f"card {self.power}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, cfg_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None,
             wrap_search: Optional[Callable] = None):
    """One run of one cell: (the result's dict, queries checked).
    `device` None means the first card; the overrides and `wrap_search`
    are for tests at small sizes and for checks that break the timed
    path."""
    import torch

    from .check import judge, load_limits, malformed_rows
    from .system import kernel_functions, launch_counts

    manifest = load_json(MANIFEST)
    w, _conf, cfg, traffic = find_cell(manifest, workload)
    cfg = cfg_override or cfg
    traffic = traffic_override or traffic
    e2e, layer = cell_metrics(manifest, workload)
    on_card = device is None
    dev = torch.device("cuda", 0) if on_card else torch.device(device)
    if on_card:
        card = torch.cuda.get_device_name(0)
        power = power_limit()
        log(f"card: {card}; nvidia-smi name, power limit: {power}")
        torch.cuda.reset_peak_memory_stats()
        sync = torch.cuda.synchronize
    else:
        card, power, sync = "cpu", "cpu", (lambda: None)

    cell = Cell(cfg, traffic, seed, dev, wrap_search)
    cell.warm_up(sync)
    gc.collect()
    setup_s = time.perf_counter() - _T0
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in cell.stages.items()))
    log(f"corpus: {cell.text.n_docs} docs, {len(cell.text.tokens)} tokens, "
        f"{cell.text.n_postings} postings, vocab {cell.text.vocab}")

    lat, results, window_s = run_window(cell, seconds, sync)
    B = int(traffic["batch"])
    n_queries = len(results) * B
    failed = sum(malformed_rows(v, i, cell.text.n_docs)
                 for _s, (v, i, _c) in results)
    lat_ms = [x * 1e3 for x in lat]
    log(f"window {window_s:.3f} s: {len(results)} batches of {B}, "
        f"{n_queries} queries; batch ms median {percentile(lat_ms, 50):.3f}, "
        f"p95 {percentile(lat_ms, 95):.3f}, min {min(lat_ms):.3f}, "
        f"max {max(lat_ms):.3f}")

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": card,
                   "count": 1}
    breakdown = None
    if not trace:
        values = {"qps": n_queries / window_s,
                  "p95_ms": percentile(lat_ms, 95), "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        from .trace import profile_batches

        slots = list(range(int(traffic["trace_batches"])))
        warm = cell.batches.warmup_slots()[0]
        reading = profile_batches(cell.call, slots, warm, launch_counts,
                                  kernel_functions, log)
        variants = {"text_only": lambda: profile_batches(
            lambda s: cell.call(s, text_only=True), slots, warm,
            launch_counts, kernel_functions, log)}
        ctx = TraceContext(reading, variants, cell.work(slots), power)
        log(f"trace: {reading.n_batches} batches, window "
            f"{reading.window_s:.6f} s, busy {reading.busy_s:.6f} s, "
            f"{reading.n_kernels} kernels, launches {reading.launched}")
        for m in layer:
            v = load_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=reading.busy_s, window_s=reading.window_s)
        breakdown = {"device_ops": reading.device_ops,
                     "idle_gaps": reading.idle_gaps}
    device_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated()) if on_card else 0)

    # the program's state goes before the reference takes the device
    cell.system = cell.search = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, n_checked = check_answers(cell, results, dev, seed)
    ok, shown = judge(numbers, load_limits(workload))
    out = {"correct": bool(ok and failed == 0), "attempted": n_queries,
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = shown
    return out, n_checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = load_json(MANIFEST)
    w = find_cell(manifest, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        log(f"no result: the cell needs {w['chips']} CUDA card(s); "
            f"torch.cuda.is_available() {torch.cuda.is_available()}, "
            f"device_count {torch.cuda.device_count()}")
        return 2
    out, n_checked = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    found = banned_modules()
    if found:
        log(f"no result: JAX or the JAX package loaded in this process: {found}")
        return 3
    log(f"checked {n_checked} answered queries against the reference")
    for name, v in out["compared"].items():
        log(f"compared {name}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
