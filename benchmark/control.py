"""Readings that the limits of `correct` are set from, on the card at a
cell's own size, all seeds in one process:

    python3 -m benchmark.control --workload <name> --seeds <a,b,...> \
        --faults <n> --batches <n> [--out <file.jsonl>]

For every seed: the cell's set-up, `--batches` batches of the pool through
the timed path, and the compared numbers over as many sampled answers as a
run checks (the sound reading). For the first `--faults` seeds also the
same batches under each of `faults.py`'s wrappers: the control (TF32), an
answer altered, half of each batch left out. One JSON line a reading goes
to standard output and to `--out`. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import faults
from .run import (Cell, MANIFEST, check_answers, find_cell, load_json, log,
                  reference_of)


def readings(workload: str, seed: int, n_batches: int, with_faults: bool,
             device):
    _w, _conf, cfg, traffic = find_cell(load_json(MANIFEST), workload)
    t = time.perf_counter()
    cell = Cell(cfg, traffic, seed, device)
    cell.warm_up(torch.cuda.synchronize)
    setup = time.perf_counter() - t
    sound = cell.search
    kinds = {"sound": sound}
    if with_faults:
        kinds.update(control_tf32=faults.tf32(sound),
                     answer_altered=faults.answer_altered(
                         cell.text.n_docs)(sound),
                     half_batch=faults.half_batch(sound))
    results = {}
    for kind, search in kinds.items():
        cell.search = search
        results[kind] = [(s, cell.call(s)) for s in range(n_batches)]
    torch.cuda.synchronize()
    cell.system = cell.search = None
    gc.collect()
    torch.cuda.empty_cache()
    ref = reference_of(cell, device)
    out = []
    for kind, res in results.items():
        numbers, n_checked = check_answers(cell, res, device, seed, ref)
        out.append({"workload": workload, "seed": seed, "kind": kind,
                    "numbers": numbers, "checked": n_checked,
                    "batches": n_batches, "setup_s": setup})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("no card: these readings are the card's")
        return 2
    dev = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            for line in readings(args.workload, seed, args.batches,
                                 i < args.faults, dev):
                text = json.dumps(line)
                print(text, flush=True)
                if sink:
                    sink.write(text + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
