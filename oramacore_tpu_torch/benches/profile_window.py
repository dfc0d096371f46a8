"""How often `torch.profiler` misses kernels of a profiled call, by the
host time left between the call and the edges of the profiler's window:

    python -m oramacore_tpu_torch.benches.profile_window [--readings 200]
        [--edges 0 0.005]

Each reading profiles one call as `chip_smoke.profile_once` does (a
schedule of one cycle, one warm-up step and one active step, the call
once in each) and compares the profile's count of
`score_ranges_accumulate_kernel` with the wrapper's `LAUNCHES` for the
active call. The call launches the kernel twice at its start and twice
at its end, with a matmul between, so counted kernels sit at both edges
of the window. For each edge in
`--edges` the active call starts that many seconds after the window
opens, and the window closes that many seconds after the call has
finished on the device; the readings take the edges in turns. It prints
the readings that missed launches for each edge.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def reading(fn, edge_s: float) -> tuple:
    """(launched, profiled) score_ranges_accumulate launches of one
    profiled call of fn."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from ..ops import score_windows as sw

    got = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.update(
                     events=p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(edge_s)
        before = sw.LAUNCHES["score_ranges_accumulate"]
        fn()
        torch.cuda.synchronize()
        launched = sw.LAUNCHES["score_ranges_accumulate"] - before
        time.sleep(edge_s)
        prof.step()
    profiled = sum(e.count for e in got["events"]
                   if str(e.device_type).endswith("CUDA")
                   and "score_ranges_accumulate_kernel" in e.key)
    return launched, profiled


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readings", type=int, default=200,
                    help="readings for each edge")
    ap.add_argument("--edges", type=float, nargs="+", default=[0.0, 0.005],
                    help="host seconds between the call and each edge")
    args = ap.parse_args(argv)

    from .. import require_cuda
    from . import card_line
    from ..ops.score_windows import score_ranges_accumulate
    from .ranges_bench import synthetic_case

    require_cuda()
    device = torch.device("cuda")
    card = card_line()
    rng = np.random.default_rng(0)
    n = 1 << 22
    slab = (torch.from_numpy(rng.integers(0, 1 << 20, n, dtype=np.int32)),
            torch.from_numpy(rng.uniform(0, 4, n).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 4, n).astype(np.float32)),
            torch.from_numpy(rng.uniform(1, 60, n).astype(np.float32)))
    case = synthetic_case(rng, tuple(t.to(device) for t in slab))
    acc = torch.zeros((case.desc[0].shape[0], case.cap), device=device)
    x = torch.randn((2048, 2048), device=device)

    def call():
        for _ in range(2):
            score_ranges_accumulate(*case.slab, *case.desc, acc,
                                    exact=False, max_len=case.max_len)
        x @ x
        for _ in range(2):
            score_ranges_accumulate(*case.slab, *case.desc, acc,
                                    exact=False, max_len=case.max_len)

    missed = {e: [] for e in args.edges}
    t0 = time.perf_counter()
    for _ in range(args.readings):
        for e in args.edges:
            launched, profiled = reading(call, e)
            if launched != profiled:
                missed[e].append(profiled)
    for e, lost in missed.items():
        print(f"edge {e * 1e3:g} ms: {len(lost)} of {args.readings} readings "
              f"missed launches (profiled counts of 4 launched: "
              f"{sorted(lost)}) [{card}]", flush=True)
    print(f"{args.readings * len(args.edges)} readings in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
