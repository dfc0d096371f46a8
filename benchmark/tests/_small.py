"""Small versions of the cells for test runs."""

from benchmark import run


def scaled(cfg: dict, n_docs: int, vocab: int) -> dict:
    """A copy of a configuration with fewer documents and terms (and at
    most 64 vector centres): for tests only, never for a cell."""
    out = {**cfg, "text": {**cfg["text"], "n_docs": int(n_docs),
                           "vocab": int(vocab)}}
    if cfg.get("vectors"):
        out["vectors"] = {**cfg["vectors"],
                          "centers": min(int(cfg["vectors"]["centers"]), 64)}
    return out


def small(workload: str, n_docs: int = 3000, batch: int = 16):
    manifest = run.load_json(run.MANIFEST)
    _w, _conf, cfg, traffic = run.find_cell(manifest, workload)
    cfg = scaled(cfg, n_docs, 3000)
    traffic = {**traffic, "batch": batch, "pool_batches": 4,
               "warmup_batches": 1, "check_queries": 48}
    return cfg, traffic


def run_small(workload: str, wrap=None, seconds: float = 0.5,
              seed: int = 2**31 + 7):
    cfg, traffic = small(workload)
    return run.run_cell(workload, seed, seconds, False, device="cpu",
                        cfg_override=cfg, traffic_override=traffic,
                        wrap_search=wrap)
