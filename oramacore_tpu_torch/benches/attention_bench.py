"""The encoder attention kernel at phase 14's cases, beside an earlier
design, SDPA and its limit cases; and the 3xTF32 arithmetic it runs, in
PyTorch, for the CPU tests.

    python -m oramacore_tpu_torch.benches.attention_bench [--baseline OLD.cu]

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

`tf32_rna`, `split_tf32` and `attention_tf32` are the kernel's arithmetic
in PyTorch on the CPU (cvt.rna.tf32.f32, the hi / lo split, and the
attention with 3 or 1 tf32 passes per product over the kernel's key
tiles); the tests hold them to the f64 reference. Nothing on the main
path uses them.
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


def load_baseline(source: Path) -> Callable:
    """run(qkv, mask, H) -> ctx over an earlier encoder_attention.cu whose
    launcher takes S lanes a query row (the SIMT design), built with the
    port's nvcc flags."""
    from ..ops import _build

    lib = _build.load_source(source, "baseline_attention")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
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


def ptxas_lines() -> list:
    """The `-Xptxas -v` lines that give each instantiation of the kernel
    its registers, spills and static shared memory: the source compiled
    once more with the port's flags (the library in use may have come
    from the build cache, without its log)."""
    import subprocess
    import tempfile

    from ..ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{tmp}/a.so",
             str(_build.CSRC / "encoder_attention.cu")],
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="an earlier encoder_attention.cu to time beside "
                         "this one")
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
    runners = {"current": lambda qkv, mask, H: at.encoder_attention(
        qkv, mask, H)}
    if args.baseline is not None:
        runners["baseline"] = load_baseline(args.baseline)
    turns = ("baseline", "current", "current", "baseline") \
        if args.baseline is not None else ("current",)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    for i, (label, case) in enumerate(ATTENTION_CASES.items()):
        B, L, H, hd = case["B"], case["L"], case["H"], case["hd"]
        qkv, mask = attention_inputs(case, 140 + i, device)
        ref = attention_reference(qkv, mask, H)
        n_bytes, n_ops = at.attention_work(B, L, H, hd)
        bound, by = bound_ms(n_bytes, n_ops, H100_TF32X3_OPS_PER_S)
        ffma, ffma_by = bound_ms(n_bytes, n_ops, H100_F32_OPS_PER_S)
        tiles = at.tiles_for(B, H, L, hd)
        print(f"{label}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP; "
              f"bound {bound:.4f} ms ({by}, 3xTF32 at 165 TFLOP/s) [FFMA "
              f"rate: {ffma:.4f} ms, {ffma_by}]; tiles {tiles._asdict()} "
              f"[{card}]", flush=True)
        for who in dict.fromkeys(turns):
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
        for who in turns:
            run = runners[who]
            for k, v in (
                    ("warm", time_graph(lambda: run(qkv, mask, H), args.reps)),
                    ("cold", time_cold(lambda: run(qkv, mask, H), flush,
                                       args.reps))):
                times.setdefault((who, k), []).append(v)
        for who in dict.fromkeys(turns):
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
