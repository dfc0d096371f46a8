"""Steady latency of two pruned routes of `chip_smoke.py`'s phase 12, to
compare two trees of the repo in one call to the card.

    python oramacore_tpu_torch/benches/route_latency.py [--root DIR] [--batches N]

`--root` is a checkout of the repo whose `oramacore_tpu_torch` is
imported (default: the one that holds this file); run the script once
per tree, in turns (A, B, B, A, ...). Each run builds the 10M-doc index
(`pruned_bench.build_index`), warms each route on two batches, then
times N distinct batches of v4 B=64 and of v3 B=64 under phase 12's 50%
filter: the host clock around `search_topk_pruned`, which ends in the
copy of its results to the host (plans are built outside the timed
region, as phase 12 does). It prints one JSON line: the card, the root
and each route's ms per batch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--batches", type=int, default=10)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("route_latency: needs a CUDA card", file=sys.stderr)
        return 1
    import oramacore_tpu_torch
    from oramacore_tpu_torch.benches import card_line
    from oramacore_tpu_torch.benches import pruned_bench as pb
    from oramacore_tpu_torch.index.plan import plan_query
    from oramacore_tpu_torch.index.search_exec import PrunedPlanMixin

    if not oramacore_tpu_torch.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {oramacore_tpu_torch.__file__}, "
                           f"not the package under {root}")
    idx = pb.build_index()
    n = pb.N_DOCS
    ex = PrunedPlanMixin(torch.device("cuda"))
    half = np.random.default_rng(12).random(n) < 0.5

    def search(qs, **kw):
        plans = [plan_query(idx, q, [pb.FIELD], {}, with_prefix=True)
                 for q in qs]
        t = time.perf_counter()
        ex.search_topk_pruned(idx, plans, [float(n)] * len(qs), n, 10, **kw)
        return 1e3 * (time.perf_counter() - t)

    routes = {"v4 B=64": {},
              "v3 50% filter B=64": dict(mask=half, mask_key=("route", "half"))}
    out = {"card": card_line(), "root": root}
    for label, kw in routes.items():
        for j in range(2):
            search(pb.make_queries(64, seed=5000 + j), **kw)
        out[label] = [round(search(pb.make_queries(64, seed=6000 + j), **kw), 3)
                      for j in range(args.batches)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
