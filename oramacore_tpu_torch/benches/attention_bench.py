"""The encoder attention kernel at phase 14's cases, beside an earlier
design, SDPA and its limit cases; and the 3xTF32 arithmetic it runs, in
PyTorch, for the CPU tests.

    python -m oramacore_tpu_torch.benches.attention_bench [--baseline OLD.cu]
    python -m oramacore_tpu_torch.benches.attention_bench --wide \
        [--baseline OLD.cu] [--sweep]

For every `encoder_bench.ATTENTION_CASES` entry (inputs from the seeds
`chip_smoke.py` phase 14 uses) the bench holds the kernel to the f64
reference within `ATTN_TOL`, and times it as CUDA-graph replays with the
L2 warm and cold (a 256 MiB write between replays, subtracted), beside
both bounds (bytes over 3.35 TB/s against FLOPs over the 3xTF32 rate of
165 TFLOP/s; the FFMA-rate bound in brackets), one
`scaled_dot_product_attention` call with an additive f32 mask (time and
max abs error against the same reference), and three limit cases of
the kernel: `bytes only` (Q, K, V in and ctx out, no math), `math only`
(no load from device memory) and `mma only` (the mma.sync sequence of
S and P V alone, with its dependences). It prints each kernel's
`-Xptxas -v` lines. `--baseline OLD.cu` builds an earlier `encoder_attention.cu` whose
launcher takes S lanes a query row (the SIMT design: `git show
9b4844d:oramacore_tpu_torch/ops/csrc/encoder_attention.cu` into the
gitignored `build/archive/`), holds it to the same reference, and times
it in turns with the current kernel: baseline, current, current,
baseline.

The baseline runs only the cases of head width 32 and 64, the widths that
design takes.

`--wide` takes the wide forward kernel (head widths above 128) at every
case of `encoder_bench.WIDTH_CASES` above 128 (`--sweep` adds
`WIDE_SWEEP`'s lengths at hd 256 and 132): the route through the wrapper
(`encoder_attention`: a ragged width zero-padded to `wide_width`) held to
the f64 reference and timed, warm and L2-cold, beside its bounds (the
3xTF32 rate; the FFMA rate in brackets) and SDPA; then the kernel alone on
the operands the wrapper gives it with 16 and with 32 query rows a block
(`wide_tiles_for(..., rows)`), in turns (16, 32, 32, 16). There
`--baseline OLD.cu` is the wide forward's FFMA design, 0ed7058's file and
its two headers (`git show 0ed7058:oramacore_tpu_torch/ops/csrc/<file>`
for `encoder_attention.cu`, `attention_wide.cuh` and `tf32_mma.cuh`, into
one directory under `build/archive/`), whose wide entry point takes no
tiling; it runs at the true width and is timed in turns with the route
(baseline, current, current, baseline).

`tf32_rna`, `split_tf32` and `attention_tf32` are the kernel's arithmetic
in PyTorch on the CPU (cvt.rna.tf32.f32, the hi / lo split, and the
attention with 3 or 1 tf32 passes per product over the kernel's key
tiles), `wide_attention_tf32` the wide kernel's; the tests hold them to
the f64 reference. Nothing on the main path uses them.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from . import (
    H100_F32_OPS_PER_S,
    H100_TF32X3_OPS_PER_S,
    bound_ms,
    time_graph,
)
from .train_bench import _mma, one_thread

ATTN_TOL = 1e-5   # rtol and atol against the f64 reference, as chip_smoke


# ---------------------------------------------------------------------------
# the kernel's arithmetic, in PyTorch
# ---------------------------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on an f32 tensor: the f32 rounded to 10 mantissa
    bits, ties away from zero, as an f32 whose low 13 bits are zero.
    Subnormals round in place (a carry makes the least normal), ±0 and
    ±inf stay, a NaN passes through."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    sign = bits & -0x80000000
    # on the magnitude, adding half an ulp of tf32 and cutting rounds half
    # away from zero; the largest finite values carry into inf
    out = ((mag + 0x1000) & -0x2000) | sign
    out = torch.where(mag > 0x7F800000, bits, out)
    return out.view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple:
    """(hi, lo) tf32 parts of f32 x: hi = tf32(x), lo = tf32(x - hi)."""
    x = x.to(torch.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b in f32 from tf32 parts: 3 passes sum a_lo b_hi, a_hi b_lo,
    a_hi b_hi (small terms first); 1 pass is a_hi b_hi alone. Products of
    tf32 values are exact in f32, so the sums round as the tensor cores'
    f32 accumulation does (in another order)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if passes == 1:
        return ah @ bh
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return (al @ bh + ah @ bl) + ah @ bh


def attention_tf32(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int,
                   passes: int = 3) -> torch.Tensor:
    """The kernel's attention on the CPU in f32: per tile of the key tile
    that `tiles_for` picks, S = Q K^T in `passes` tf32 passes, an IEEE
    division by f32(sqrt(hd)), + 0 / -1e9 from the mask (-inf past L),
    the online softmax, O += P V in `passes` passes, and O times the
    f32 reciprocal of l at the end."""
    from ..ops.attention import MASKED, check_shapes, tiles_for

    B, L, D, hd = check_shapes(qkv, mask, n_heads)
    KT = tiles_for(B, n_heads, L, hd).key_tile
    q, k, v = (t.to(torch.float32).reshape(B, L, n_heads, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    div = torch.tensor(np.sqrt(hd), dtype=torch.float32)
    bias = torch.where(mask > 0, 0.0, MASKED).to(torch.float32)
    m = torch.full((B, n_heads, L, 1), -torch.inf)
    l = torch.zeros((B, n_heads, L, 1))
    o = torch.zeros((B, n_heads, L, hd))
    for t0 in range(0, L, KT):
        kt, vt = k[:, :, t0:t0 + KT], v[:, :, t0:t0 + KT]
        s = _product(q, kt.transpose(-1, -2), passes) / div
        s = s + bias[:, None, None, t0:t0 + KT]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + _product(p, vt, passes)
        m = m_new
    return (o * torch.reciprocal(l)).transpose(1, 2).reshape(B, L, D)


@one_thread
def wide_attention_tf32(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int,
                        passes: int = 3, chunked: bool = True) -> torch.Tensor:
    """The wide forward kernel's arithmetic (head widths above 128; any
    width) on the CPU in f32, for the tests. Every product is a chain of
    tensor-core steps in `passes` tf32 passes that truncate what they add
    into their accumulator (`train_bench._mma`). S = Q K^T sums over the
    head's columns in chunks of C (`wide_tiles_for(...).chunk` at
    `wide_width`): each chunk's chain from 0, added to the running sum in
    f32 rounded to nearest (chunked=False takes the whole width in one
    chain, as an accumulator on the tensor core would). Then s = S / div
    + 0 or -1e9 (an IEEE quotient), the exact softmax (max, sum of exp,
    P = exp / sum), and O = P V, each 8-key step's chain from 0 added in
    rounded f32 (mma3_add). The order of the row sums is not the
    kernel's. Nothing on the main path uses it."""
    from ..ops.attention import (
        MASKED,
        plain_shapes,
        wide_tiles_for,
        wide_width,
    )

    B, L, D, hd = plain_shapes(qkv, mask, n_heads)
    C = wide_tiles_for(B, n_heads, L, wide_width(hd)).chunk if chunked \
        else hd
    q, k, v = (t.to(torch.float32).reshape(B, L, n_heads, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    div = torch.tensor(np.sqrt(hd), dtype=torch.float32)
    bias = torch.where(mask > 0, 0.0, MASKED).to(torch.float32)

    def product(a, b):   # a @ b from an accumulator of 0
        return _mma(torch.zeros(a.shape[:-1] + b.shape[-1:]), a, b, passes)

    s = None
    for c0 in range(0, hd, C):
        part = product(q[..., c0:c0 + C], k[..., c0:c0 + C].transpose(-1, -2))
        s = part if s is None else s + part
    s = s / div + bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.zeros((B, n_heads, L, hd))
    for j in range(0, L, 8):
        o = o + product(p[..., j:j + 8], v[:, :, j:j + 8])
    return o.transpose(1, 2).reshape(B, L, D)


# ---------------------------------------------------------------------------
# the designs on the card
# ---------------------------------------------------------------------------

def lanes_split(B: int, n_heads: int, L: int) -> int:
    """S lanes a query row in the SIMT design (its `split_for`): enough to
    keep a block's 128 / S rows within L rounded up to 16, and to launch
    132 x 1,024 threads where the batch allows; at most 8."""
    span = max(16, -(-L // 16) * 16)
    fits = [S for S in (1, 2, 4, 8) if 128 // S <= span]
    for S in fits:
        if B * n_heads * L * S >= 132 * 1024:
            return S
    return fits[-1]


def load_baseline(source: Path, wide: bool = False) -> Callable:
    """run(qkv, mask, H) -> ctx over an earlier encoder_attention.cu, built
    with the port's nvcc flags: its launcher that takes S lanes a query
    row (the SIMT design), or with `wide` its wide entry point that takes
    no tiling (the FFMA design), at the true head width."""
    from ..ops import _build

    lib = _build.load_source(source, "baseline_attention")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    if wide:
        fn = lib.encoder_attention_wide_launch
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, ctypes.c_float,
                       ptr]
        fn.restype = ctypes.c_int

        def run_wide(qkv, mask, H):
            B, L, D3 = qkv.shape
            hd = D3 // 3 // H
            ctx = torch.empty((B, L, D3 // 3), dtype=torch.float32,
                              device=qkv.device)
            err = fn(qkv.data_ptr(), mask.data_ptr(), ctx.data_ptr(), B, L,
                     H, hd, float(np.float32(np.sqrt(hd))),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"baseline launch failed: cudaError_t "
                                   f"{err}")
            return ctx

        return run_wide
    lib.encoder_attention_launch.argtypes = [
        ptr, ptr, ptr, i64, i64, i64, i64, i64, ctypes.c_float, ptr]
    lib.encoder_attention_launch.restype = ctypes.c_int

    def run(qkv, mask, H):
        B, L, D3 = qkv.shape
        hd = D3 // 3 // H
        ctx = torch.empty((B, L, D3 // 3), dtype=torch.float32,
                          device=qkv.device)
        err = lib.encoder_attention_launch(
            qkv.data_ptr(), mask.data_ptr(), ctx.data_ptr(), B, L, H, hd,
            lanes_split(B, H, L), float(np.float32(np.sqrt(hd))),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: cudaError_t {err}")
        return ctx

    return run


def ptxas_lines(name: str = "encoder_attention") -> list:
    """The `-Xptxas -v` lines that give each instantiation of the kernels
    of `csrc/<name>.cu` its registers, spills and static shared memory:
    the source compiled once more with the port's flags (the library in
    use may have come from the build cache, without its log)."""
    import subprocess
    import tempfile

    from ..ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{tmp}/a.so",
             str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if re.search(r"Compiling entry|registers|spill", ln)]


def sdpa(qkv, mask, H):
    """One F.scaled_dot_product_attention call on the same inputs (Q, K, V
    as (B, H, L, hd) views, an additive f32 mask of 0 / -1e9), as
    (B, L, D): the library yardstick, used nowhere in the port."""
    import torch.nn.functional as F

    B, L, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (t.view(B, L, H, D // H).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    bias = torch.where(mask > 0, 0.0, -1e9).float()[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


# --sweep's wide forward cases beside WIDTH_CASES: hd 256 at other
# lengths (about 4,096 query rows of 4 heads each), and at fewer rows
# around the grid where `wide_rows` changes (128 and 256 blocks of 32
# rows; 64), and the padded width 132 at two
WIDE_SWEEP = {
    f"hd {hd} B={B} L={L} H=4 (sweep)": dict(B=B, L=L, H=4, hd=hd, padded=0)
    for hd, B, L in ((256, 256, 16), (256, 128, 32), (256, 48, 100),
                     (256, 16, 256), (256, 8, 384), (256, 4, 256),
                     (256, 8, 256), (256, 8, 64), (132, 32, 128),
                     (132, 8, 512))}


def wide_kernel(qkv, mask, H, rows):
    """launch(): the wide forward kernel alone with `rows` query rows a
    block, on the operands the wrapper gives it (a ragged width zero-padded
    to `wide_width`)."""
    from ..ops import attention as at

    hd = qkv.shape[2] // 3 // H
    w = at.wide_width(hd)
    if w != hd:
        qkv = at.pad_heads(qkv, H, hd, w)
    return lambda: at.launch_wide(qkv, mask, H, div_hd=hd, rows=rows)


def main_wide(args, card, flush) -> int:
    """The wide forward's bench (see the module doc)."""
    from ..ops import attention as at
    from .encoder_bench import (
        WIDTH_CASES,
        attention_inputs,
        attention_reference,
    )
    from .pruned_bench import time_cold

    cases = {k: c for k, c in WIDTH_CASES.items() if c["hd"] > 128}
    if args.sweep:
        cases.update(WIDE_SWEEP)
    runners = {"current": lambda qkv, mask, H: at.encoder_attention(
        qkv, mask, H)}
    if args.baseline is not None:
        runners["baseline"] = load_baseline(args.baseline, wide=True)
    turns = ("baseline", "current", "current", "baseline") \
        if args.baseline is not None else ("current",)
    for i, (label, case) in enumerate(cases.items()):
        B, L, H, hd = case["B"], case["L"], case["H"], case["hd"]
        qkv, mask = attention_inputs(case, 150 + i, flush.device)
        ref = attention_reference(qkv, mask, H)
        n_bytes, n_ops = at.attention_work(B, L, H, hd)
        bound, by = bound_ms(n_bytes, n_ops, H100_TF32X3_OPS_PER_S)
        ffma, ffma_by = bound_ms(n_bytes, n_ops, H100_F32_OPS_PER_S)
        tiles = {r: at.wide_tiles_for(B, H, L, at.wide_width(hd), r)
                 for r in at.WIDE_FWD_ROWS}
        print(f"{label}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP; "
              f"bound {bound:.4f} ms ({by}, 3xTF32 at 165 TFLOP/s) [FFMA "
              f"rate: {ffma:.4f} ms, {ffma_by}]; route's rows "
              f"{at.wide_rows(B, H, L)}; (rows, chunk, row tiles, grid, "
              f"smem) "
              + ", ".join(str((t.rows, t.chunk, t.row_tiles, t.grid, t.smem))
                          for t in tiles.values()) + f" [{card}]", flush=True)
        alone = {r: wide_kernel(qkv, mask, H, r) for r in at.WIDE_FWD_ROWS}
        checked = {**{who: (lambda who=who: runners[who](qkv, mask, H))
                      for who in dict.fromkeys(turns)},
                   **{f"rows {r}": fn for r, fn in alone.items()}}
        for who, run in checked.items():
            got = run()
            if got.shape[2] != ref.shape[2]:
                got = at.unpad_heads(got, H, hd, at.wide_width(hd))
            torch.cuda.synchronize()
            err = float((got.double() - ref).abs().max())
            if not (bool(torch.isfinite(got).all()) and torch.allclose(
                    got.double(), ref, rtol=ATTN_TOL, atol=ATTN_TOL)):
                raise AssertionError(f"{label}: {who} is not within "
                                     f"{ATTN_TOL} of the f64 reference (max "
                                     f"abs err {err:.3g})")
            print(f"  {who}: max abs err {err:.3g} against f64", flush=True)
        times = {}
        order = [(who, lambda who=who: runners[who](qkv, mask, H))
                 for who in turns]
        r0, r1 = at.WIDE_FWD_ROWS
        order += [(f"rows {r}", alone[r]) for r in (r0, r1, r1, r0)]
        for who, run in order:
            for k, v in (("warm", time_graph(run, args.reps)),
                         ("cold", time_cold(run, flush, args.reps))):
                times.setdefault((who, k), []).append(v)
        for who in dict.fromkeys(w for w, _ in order):
            warm, cold = min(times[(who, "warm")]), min(times[(who, "cold")])
            what = "the kernel alone" if who.startswith("rows") else \
                "through the wrapper" if who == "current" else "at the " \
                "true width"
            print(f"  {who} ({what}): {warm:.4f} ms (L2 warm), {cold:.4f} "
                  f"ms (L2 cold); {100 * bound / cold:.1f}% of the 3xTF32 "
                  f"bound cold [{100 * ffma / cold:.1f}% of the FFMA-rate "
                  f"one]; turns: warm " + ", ".join(
                      f"{v:.4f}" for v in times[(who, "warm")]) + "; cold "
                  + ", ".join(f"{v:.4f}" for v in times[(who, "cold")])
                  + f" [{card}]", flush=True)
        lib_out = sdpa(qkv, mask, H)
        lib_err = float((lib_out.transpose(1, 2).reshape(B, L, -1).double()
                         - ref).abs().max())
        lib_warm = time_graph(lambda: sdpa(qkv, mask, H), args.reps)
        lib_cold = time_cold(lambda: sdpa(qkv, mask, H), flush, args.reps)
        print(f"  scaled_dot_product_attention (additive f32 mask): "
              f"{lib_warm:.4f} ms (L2 warm), {lib_cold:.4f} ms (L2 cold); "
              f"max abs err {lib_err:.3g} against f64 [{card}]", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="an earlier encoder_attention.cu to time beside "
                         "this one")
    ap.add_argument("--wide", action="store_true",
                    help="the wide forward kernel at encoder_bench."
                         "WIDTH_CASES above 128 instead of ATTENTION_CASES")
    ap.add_argument("--sweep", action="store_true",
                    help="with --wide, WIDE_SWEEP's cases too")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from .. import require_cuda
    from ..ops import attention as at
    from . import card_line
    from .encoder_bench import (
        ATTENTION_CASES,
        attention_inputs,
        attention_reference,
    )
    from .pruned_bench import time_cold

    require_cuda()
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    at.load_kernels()
    for ln in ptxas_lines():
        print(f"  ptxas: {ln}", flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    if args.wide:
        return main_wide(args, card, flush)
    runners = {"current": lambda qkv, mask, H: at.encoder_attention(
        qkv, mask, H)}
    if args.baseline is not None:
        runners["baseline"] = load_baseline(args.baseline)
    turns = ("baseline", "current", "current", "baseline") \
        if args.baseline is not None else ("current",)
    for i, (label, case) in enumerate(ATTENTION_CASES.items()):
        B, L, H, hd = case["B"], case["L"], case["H"], case["hd"]
        qkv, mask = attention_inputs(case, 140 + i, device)
        ref = attention_reference(qkv, mask, H)
        n_bytes, n_ops = at.attention_work(B, L, H, hd)
        bound, by = bound_ms(n_bytes, n_ops, H100_TF32X3_OPS_PER_S)
        ffma, ffma_by = bound_ms(n_bytes, n_ops, H100_F32_OPS_PER_S)
        tiles = at.tiles_for(B, H, L, hd)
        # the baseline's SIMT design takes head widths 32 and 64 only
        case_turns = turns if hd in (32, 64) else ("current",)
        print(f"{label}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP; "
              f"bound {bound:.4f} ms ({by}, 3xTF32 at 165 TFLOP/s) [FFMA "
              f"rate: {ffma:.4f} ms, {ffma_by}]; tiles {tiles._asdict()} "
              f"[{card}]", flush=True)
        for who in dict.fromkeys(case_turns):
            got = runners[who](qkv, mask, H)
            torch.cuda.synchronize()
            err = float((got.double() - ref).abs().max())
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got.double(), ref, rtol=ATTN_TOL, atol=ATTN_TOL)
            if not ok:
                raise AssertionError(f"{label}: {who} is not within "
                                     f"{ATTN_TOL} of the f64 reference "
                                     f"(max abs err {err:.3g})")
            print(f"  {who}: max abs err {err:.3g} against f64", flush=True)
        times = {}
        for who in case_turns:
            run = runners[who]
            for k, v in (
                    ("warm", time_graph(lambda: run(qkv, mask, H), args.reps)),
                    ("cold", time_cold(lambda: run(qkv, mask, H), flush,
                                       args.reps))):
                times.setdefault((who, k), []).append(v)
        for who in dict.fromkeys(case_turns):
            warm, cold = min(times[(who, "warm")]), min(times[(who, "cold")])
            print(f"  {who}: {warm:.4f} ms (L2 warm), {cold:.4f} ms (L2 "
                  f"cold); {100 * bound / cold:.1f}% of the 3xTF32 bound "
                  f"cold [{100 * ffma / cold:.1f}% of the FFMA-rate one]; "
                  f"turns: warm " + ", ".join(
                      f"{v:.4f}" for v in times[(who, "warm")]) + "; cold "
                  + ", ".join(f"{v:.4f}" for v in times[(who, "cold")])
                  + f" [{card}]", flush=True)
        lib_out = sdpa(qkv, mask, H)
        lib_err = float((lib_out.transpose(1, 2).reshape(B, L, -1).double()
                         - ref).abs().max())
        lib_warm = time_graph(lambda: sdpa(qkv, mask, H), args.reps)
        lib_cold = time_cold(lambda: sdpa(qkv, mask, H), flush, args.reps)
        print(f"  scaled_dot_product_attention (additive f32 mask): "
              f"{lib_warm:.4f} ms (L2 warm), {lib_cold:.4f} ms (L2 cold); "
              f"max abs err {lib_err:.3g} against f64 [{card}]", flush=True)
        for mode, name in ((1, "bytes only"), (2, "math only"),
                           (3, "mma only")):
            warm = time_graph(lambda: at.launch(qkv, mask, H, mode), args.reps)
            cold = time_cold(lambda: at.launch(qkv, mask, H, mode), flush,
                             args.reps)
            print(f"  limit case [{name}]: {warm:.4f} ms (L2 warm), "
                  f"{cold:.4f} ms (L2 cold) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
