"""Window-scoring bench on one NVIDIA card: the port of
`benches/pallas_bench.py`.

Three ways to produce the (docs, ntf) posting windows that BM25's dense
aggregation consumes, on the same seeded slab:

  1. xla-2stage:    plain PyTorch gathers of the three columns, then the
                    elementwise ntf (the JAX bench's vmapped dynamic_slice
                    + XLA arithmetic)
  2. pallas-gather: the `gather_windows` kernel on `p_doc` alone (what the
                    JAX bench times for its gather arm)
  3. pallas-fused:  the `score_windows` kernel (gather + ntf in one pass)

Parity, as the JAX bench checks it (plus the gather, which it only
times): fused docs equal the 2-stage docs exactly, fused ntf within
rtol 1e-5 / atol 1e-6 of the 2-stage ntf, gathered docs equal the
2-stage docs exactly.

    python -m oramacore_tpu_torch.benches.pallas_bench [--windows 2048] \\
        [--w 1024] [--postings 67108864] [--iters 10]

Needs a CUDA card; every line carries the card's `nvidia-smi` name and
power limit. `make_data`, `run_arms`, `check_parity` and `time_arms` are
importable, so a smoke run can call them as a phase and a CPU test can
check the parity at a tiny size (the wrappers then run their plain
versions).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..ops import gather_windows as gw
from ..ops import score_windows as sw
from . import card_line, time_cuda

ARMS = ("xla-2stage", "pallas-gather", "pallas-fused")


class BenchData(NamedTuple):
    p_doc: torch.Tensor    # int32[P + W]
    p_tf: torch.Tensor     # f32[P + W]
    p_flen: torch.Tensor   # f32[P + W]
    starts: torch.Tensor   # int32[NS], multiples of 1024 below P
    params: torch.Tensor   # f32[NS, 4]: weight, 1-b, b/avg, 0
    w: int


def make_data(ns: int, w: int, postings: int, device, seed: int = 0
              ) -> BenchData:
    """The JAX bench's seeded slab and windows (benches/pallas_bench.py
    data block), on `device`."""
    rng = np.random.default_rng(seed)
    n = postings + w
    cols = (
        rng.integers(0, 1 << 20, n).astype(np.int32),
        rng.integers(0, 4, n).astype(np.float32),
        rng.uniform(1, 50, n).astype(np.float32),
        (rng.integers(0, postings // 1024, ns) * 1024).astype(np.int32),
    )
    b = rng.uniform(0.3, 0.9, ns)
    avg = rng.uniform(5, 40, ns)
    params = np.stack([
        rng.uniform(0.5, 2.0, ns), 1.0 - b, b / avg, np.zeros(ns),
    ], axis=1).astype(np.float32)
    return BenchData(*(torch.from_numpy(a).to(device)
                       for a in (*cols, params)), w)


def two_stage(d: BenchData):
    """xla-2stage: plain gathers, then the elementwise ntf."""
    docs = gw.gather_windows_plain(d.p_doc, d.starts, d.w)
    tf = gw.gather_windows_plain(d.p_tf, d.starts, d.w)
    fl = gw.gather_windows_plain(d.p_flen, d.starts, d.w)
    p = d.params
    ntf = p[:, 0:1] * tf / torch.clamp(p[:, 1:2] + p[:, 2:3] * fl, min=1e-9)
    return docs, ntf


def _arm_fns(d: BenchData):
    return {
        "xla-2stage": lambda: two_stage(d),
        "pallas-gather": lambda: gw.gather_windows(d.p_doc, d.starts, w=d.w),
        "pallas-fused": lambda: sw.score_windows(
            d.p_doc, d.p_tf, d.p_flen, d.starts, d.params, w=d.w),
    }


def run_arms(d: BenchData) -> Dict[str, object]:
    """Each arm once; its outputs by arm name."""
    return {name: fn() for name, fn in _arm_fns(d).items()}


def check_parity(outs: Dict[str, object]) -> float:
    """Raises AssertionError unless the arms agree (see the module doc);
    returns the fused ntf's max abs error against the 2-stage ntf."""
    d1, n1 = outs["xla-2stage"]
    d3, n3 = outs["pallas-fused"]
    if not torch.equal(d1, d3):
        raise AssertionError("fused docs differ from the 2-stage docs")
    if not torch.allclose(n3, n1, rtol=1e-5, atol=1e-6):
        raise AssertionError("fused ntf is not within rtol 1e-5 / atol 1e-6 "
                             "of the 2-stage ntf")
    if not torch.equal(outs["pallas-gather"], d1):
        raise AssertionError("gathered docs differ from the 2-stage docs")
    return float((n3 - n1).abs().max()) if n1.numel() else 0.0


def time_arms(d: BenchData, iters: int = 10) -> Dict[str, float]:
    """Mean ms per call of each arm by CUDA events, after one warm-up."""
    return {name: time_cuda(fn, iters) for name, fn in _arm_fns(d).items()}


def arm_bytes(d: BenchData) -> Dict[str, int]:
    """Bytes each arm reads from the slab (4 per slot and column)."""
    slots = d.starts.shape[0] * d.w
    return {"xla-2stage": 12 * slots, "pallas-gather": 4 * slots,
            "pallas-fused": 12 * slots}


def report(d: BenchData, times: Dict[str, float], card: str) -> None:
    read = arm_bytes(d)
    for name in ARMS:
        ms = times[name]
        print(f"{name:14s} {ms:9.4f} ms  ({read[name] / ms / 1e6:8.1f} GB/s "
              f"of slab reads) [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=2048)
    ap.add_argument("--w", type=int, default=1024)
    ap.add_argument("--postings", type=int, default=64 * 1024 * 1024)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    from .. import require_cuda

    require_cuda()
    card = card_line()
    d = make_data(args.windows, args.w, args.postings, torch.device("cuda"))
    print(f"device={torch.cuda.get_device_name(0)} NS={args.windows} "
          f"W={args.w} P={args.postings:,} [{card}]", file=sys.stderr)
    err = check_parity(run_arms(d))
    report(d, time_arms(d, args.iters), card)
    print(f"PARITY OK (fused == 2-stage, max abs ntf err {err:.3g}; "
          f"gather == 2-stage docs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
