"""Inputs and yardsticks of the training checks on the card
(`chip_smoke.py` phase 16), and the bench of the attention's backward
kernels:

    python -m oramacore_tpu_torch.benches.train_bench [--wide]
        [--baseline OLD.cu]

For every `BACKWARD_CASES` entry (inputs from the seeds phase 16 uses),
or with `--wide` every case of `encoder_bench.WIDTH_CASES` above 128
(the wide kernels), the bench holds both kernels (dq then dkv) to the
f64 reference within `BWD_TOL` and times them as CUDA-graph replays, L2
warm and cold (a 256 MiB write between replays, subtracted), beside their
bound (bytes against FLOPs at the 3xTF32 rate of 165 TFLOP/s; the
FFMA-rate bound in brackets), then each kernel alone L2-cold beside its
own bound, and the backward of `scaled_dot_product_attention` on the same
inputs (`SdpaBackward`). It prints the kernels' `-Xptxas -v` lines.
`--baseline OLD.cu` builds an earlier `encoder_attention_backward.cu`
whose entry points take no tiling, holds it to the same reference and
times it in turns with the current pair (baseline, current, current,
baseline), and each of its kernels alone. Without `--wide` that is the
narrow kernels' SIMT design (`git show
dda63df:oramacore_tpu_torch/ops/csrc/encoder_attention_backward.cu`);
with it, the wide kernels' FFMA design, a3966e4's file and its two
headers (`git show a3966e4:oramacore_tpu_torch/ops/csrc/<file>` for
`encoder_attention_backward.cu`, `attention_wide.cuh` and
`tf32_mma.cuh`, into one directory). Either goes into the gitignored
`build/archive/`.

- `BACKWARD_CASES`: the shapes at which the attention's backward kernels
  (`encoder_attention_backward_dq`, `encoder_attention_backward_dkv`) are
  held to their plain version: the training call (B=64 pairs of L=16 at
  SemanticBase's 8 heads of 32), SemanticBase's B=1024 L=64 `encode`
  shape, BGEBase's geometry (12 heads of 64, L=512), head widths 16 and
  128 (no registry model has them: the forward's cases of the same
  shapes), an odd L=37, padded batch rows whose keys are all masked, L=1,
  and two lengths where the kernels' tiling changes: L=65 (a partial last
  tile of 64) and L=33 with padded rows (4 warps a (b, h) from L=33).
  `backward_inputs` makes them from a seed: `encoder_bench`'s qkv and
  mask, and dctx drawn normal.
- `backward_reference`: the f64 reference, `encoder_attention_backward_
  plain` in f64 with P uniform in batch rows whose keys are all masked,
  as the f32 math of JAX and of the kernels gives it there.
- `backward_tf32`: the kernels' arithmetic (tiles, 3xTF32 products as
  chains of tensor-core steps that truncate what they add into their
  accumulator, divisions, statistics) in PyTorch on the CPU, for the
  tests.
- `wide_backward_tf32`: the same for the wide kernels (head widths above
  128): S and dP summed over the head a column chunk at a time, dQ, dK
  and dV an 8-row step at a time.
- `backward_work`: the bytes and FLOPs each entry point and the whole
  gradient must spend, for the bound.
- `SdpaBackward`: the library yardstick, `torch.autograd.grad` of
  `F.scaled_dot_product_attention` with the same additive f32 mask on the
  same inputs, the backward alone, captured in CUDA graphs (warm and
  after an L2 flush).
- `StepTimer`: the device timeline of a training loop, one CUDA event
  after each step.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .encoder_bench import attention_inputs

# rtol and atol of the backward kernels against the f64 reference, here, in
# chip_smoke.py's phase 16 and in the card's tests
BWD_TOL = 5e-5

BACKWARD_CASES = {
    "training B=64 L=16": dict(B=64, L=16, H=8, hd=32, padded=0),
    "SemanticBase B=1024 L=64": dict(B=1024, L=64, H=8, hd=32, padded=0),
    "BGEBase B=8 L=512": dict(B=8, L=512, H=12, hd=64, padded=0),
    "hd 16 B=1024 L=64 H=16": dict(B=1024, L=64, H=16, hd=16, padded=0),
    "hd 128 B=8 L=512 H=8": dict(B=8, L=512, H=8, hd=128, padded=0),
    "SemanticBase B=16 L=37": dict(B=16, L=37, H=8, hd=32, padded=0),
    "SemanticBase B=128 L=32, 28 padded rows": dict(B=128, L=32, H=8, hd=32,
                                                    padded=28),
    "SemanticBase B=2 L=1, 1 padded row": dict(B=2, L=1, H=8, hd=32,
                                               padded=1),
    "SemanticBase B=32 L=65": dict(B=32, L=65, H=8, hd=32, padded=0),
    "SemanticBase B=64 L=33, 8 padded rows": dict(B=64, L=33, H=8, hd=32,
                                                  padded=8),
}


def backward_inputs(case: dict, seed: int, device) -> tuple:
    """(qkv f32[B, L, 3D], mask int32[B, L], dctx f32[B, L, D]) of a case,
    from a seed."""
    qkv, mask = attention_inputs(case, seed, device)
    B, L, D = case["B"], case["L"], case["H"] * case["hd"]
    rng = np.random.default_rng(seed + 1)
    dctx = rng.normal(size=(B, L, D)).astype(np.float32)
    return qkv, mask, torch.from_numpy(dctx).to(device)


def backward_reference(qkv: torch.Tensor, mask: torch.Tensor,
                       dctx: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The f64 reference of `encoder_attention_backward`: the plain
    version's steps on qkv and dctx in f64, except that in batch rows whose
    mask is all zero P is 1 / L at every key. f64 keeps those rows' scores
    apart under the -1e9 (its ulp at 1e9 is 1.2e-7); the f32 math of JAX
    and of the kernels rounds all of them to -1e9, so P is uniform there
    and dS = P (dP - rowsum(P dP)) is not zero."""
    from ..ops.attention import attention_backward_from_probs, attention_probs

    q, k, v, P, div = attention_probs(qkv.double(), mask, n_heads)
    dead = (mask > 0).sum(dim=1) == 0
    if dead.any():
        P[dead] = 1.0 / qkv.shape[1]
    return attention_backward_from_probs(q, k, v, P, dctx.double(), div)


def one_thread(fn: Callable) -> Callable:
    """fn run with PyTorch on one CPU thread (the count restored after):
    the emulators' tensors are small, and their thousands of small steps
    ran far slower on 8 threads beside other test workers. `_mma`
    gives the bits it gave on the default threads
    (`tests/test_torch_attention_grad_split.py`)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_num_threads(n)
    return run


_F32_TINY = float(np.finfo(np.float32).tiny)   # the least normal f32
_F32_MAX = float(np.finfo(np.float32).max)


def _cut_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 x rounded toward zero to f32, kept in f64: its 29 low mantissa
    bits cleared, which is that rounding wherever the result is 0 or a
    normal f32; elsewhere (f32 subnormals, beyond the f32 range, NaN) the
    f32 rounded to nearest and stepped towards 0 where it grew."""
    t = (x.view(torch.int64) & -(1 << 29)).view(torch.float64)
    a = t.abs()
    off = ~(((a >= _F32_TINY) & (a <= _F32_MAX)) | (a == 0))
    if bool(off.any()):
        xo = x[off]
        r = xo.to(torch.float32)
        t[off] = torch.where(r.double().abs() > xo.abs(),
                             torch.nextafter(r, torch.zeros_like(r)),
                             r).double()
    return t


@one_thread
def _mma(d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         passes: int) -> torch.Tensor:
    """d + a @ b (a [..., M, K], b [..., K, N], d f32 [..., M, N]) as a
    chain of mma.sync.m16n8k8 steps into the accumulator d: for each 8 of
    K, each tf32 pass (a_lo b_hi, a_hi b_lo, a_hi b_hi; a_hi b_hi alone at
    1 pass) sums its 8 products exactly and adds them to d, the result
    rounded toward zero to f32 (held in f64 along the chain, where it is
    exact). That is a model of the tensor core's truncating accumulation,
    not its exact behaviour (see `backward_tf32`)."""
    from .attention_bench import split_tf32

    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    ah, al = (x.double() for x in split_tf32(a))
    bh, bl = (x.double() for x in split_tf32(b))
    steps = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    d = d.double()
    for k in range(0, a.shape[-1], 8):
        for x, y in steps:
            d = _cut_f32(d + x[..., k:k + 8] @ y[..., k:k + 8, :])
    return d.to(torch.float32)


@one_thread
def backward_tf32(qkv: torch.Tensor, mask: torch.Tensor, dctx: torch.Tensor,
                  n_heads: int, passes: int = 3,
                  accumulate: str = "steps") -> torch.Tensor:
    """The backward kernels' arithmetic on the CPU in f32, for the tests:
    dq's statistics pass over its key tiles (`backward_tiles_for`: S and
    dP, the online max m, sum l and delta sum, delta = that sum / l), its
    second pass (P = exp(s - m) / l, dS = P (dP - delta) / div, dQ +=
    dS K), then dkv over its query tiles (P^T from the stored m and l,
    dV += P^T dO, dK += dS^T Q); every division an IEEE quotient, -1e9
    added for masked keys. Every product is a chain of tensor-core steps
    in `passes` tf32 passes (`_mma`: each step's sum taken into the
    accumulator rounded toward zero). S and dP accumulate from 0; with
    accumulate="steps", as the kernels do, dQ's products over one key tile
    and dK's and dV's over one 8-query step accumulate from 0 and are then
    added to dQ, dK and dV in f32 rounded to nearest; "running" takes them
    into dQ, dK and dV step by step, as mma3 would (the kernels' first
    design). The order of the row sums within a tile is not the kernels'.

    The truncation model is not the card's: on the H100 the running
    design was 5.14e-5 off at BGEBase L=512 and the per-step design
    6.6e-6, where this model gives both within a few 1e-6 (running larger),
    so it cannot show the failure the card showed; the card's test at
    `BACKWARD_CASES` can. Nothing on the main path uses it."""
    from ..ops.attention import MASKED, backward_tiles_for, check_shapes

    if accumulate not in ("steps", "running"):
        raise ValueError(f"accumulate must be 'steps' or 'running', got "
                         f"{accumulate!r}")
    running = accumulate == "running"
    B, L, D, hd = check_shapes(qkv, mask, n_heads)
    tiles = backward_tiles_for(B, n_heads, L, hd)
    KT, QT = tiles["dq"].tile, tiles["dkv"].tile
    q, k, v = (x.to(torch.float32).reshape(B, L, n_heads, hd).transpose(1, 2)
               for x in qkv.split(D, dim=-1))
    do = dctx.to(torch.float32).reshape(B, L, n_heads, hd).transpose(1, 2)
    div = torch.tensor(np.sqrt(hd), dtype=torch.float32)
    bias = torch.where(mask > 0, 0.0, MASKED).to(torch.float32)

    def product(a, b):   # a @ b from an accumulator of 0
        zero = torch.zeros(a.shape[:-1] + b.shape[-1:])
        return _mma(zero, a, b, passes)

    def tile_of(t0):   # scores and dP of the query rows against keys t0...
        kt, vt = k[:, :, t0:t0 + KT], v[:, :, t0:t0 + KT]
        s = product(q, kt.transpose(-1, -2)) / div
        return (s + bias[:, None, None, t0:t0 + KT],
                product(do, vt.transpose(-1, -2)), kt)

    m = torch.full((B, n_heads, L, 1), -torch.inf)
    l = torch.zeros((B, n_heads, L, 1))
    e = torch.zeros((B, n_heads, L, 1))
    for t0 in range(0, L, KT):
        s, dp, _ = tile_of(t0)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        e = e * alpha + (p * dp).sum(dim=-1, keepdim=True)
        m = m_new
    delta = e / l
    dq = torch.zeros_like(q)
    for t0 in range(0, L, KT):
        s, dp, kt = tile_of(t0)
        ds = torch.exp(s - m) / l * (dp - delta) / div
        dq = _mma(dq, ds, kt, passes) if running else dq + product(ds, kt)

    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    m_t, l_t, d_t = (x.transpose(-1, -2) for x in (m, l, delta))
    for i0 in range(0, L, QT):
        rows = slice(i0, i0 + QT)
        qt, ot = q[:, :, rows], do[:, :, rows]
        s = product(k, qt.transpose(-1, -2)) / div
        s = s + bias[:, None, :, None]
        p = torch.exp(s - m_t[..., rows]) / l_t[..., rows]
        dp = product(v, ot.transpose(-1, -2))
        ds = p * (dp - d_t[..., rows]) / div
        if running:
            dv, dk = _mma(dv, p, ot, passes), _mma(dk, ds, qt, passes)
            continue
        for j in range(0, qt.shape[2], 8):
            dv = dv + product(p[..., j:j + 8], ot[:, :, j:j + 8])
            dk = dk + product(ds[..., j:j + 8], qt[:, :, j:j + 8])
    return torch.cat([x.transpose(1, 2).reshape(B, L, D)
                      for x in (dq, dk, dv)], dim=-1)


@one_thread
def wide_backward_tf32(qkv: torch.Tensor, mask: torch.Tensor,
                       dctx: torch.Tensor, n_heads: int, passes: int = 3,
                       chunked: bool = True) -> torch.Tensor:
    """The wide backward kernels' arithmetic (head widths above 128; any
    width) on the CPU in f32, for the tests. Every product is a chain of
    tensor-core steps in `passes` tf32 passes (`_mma`). S and dP (S^T and
    dP^T in dkv) sum over the head's columns in chunks of C
    (`wide_backward_tiles_for(...).chunk`): each chunk's chain from 0,
    added to the running sum in f32 rounded to nearest (chunked=False takes
    the whole width in one chain, as an accumulator on the tensor core
    would). dq's row statistics (m, l, delta = sum P dP), P = exp(s - m) /
    l and dS = P (dP - delta) / div; dkv's P^T and dS^T from those
    statistics; dQ = dS K, dK = dS^T Q and dV = P^T dO, each 8-row step's
    chain from 0, added in rounded f32 (mma3_add). Every division an IEEE
    quotient, -1e9 added for masked keys. The order of the row sums is not
    the kernels', and the truncation model is milder than the card's (see
    `backward_tf32`). Nothing on the main path uses it."""
    from ..ops.attention import MASKED, plain_shapes, wide_backward_tiles_for

    B, L, D, hd = plain_shapes(qkv, mask, n_heads)
    C = wide_backward_tiles_for(B, n_heads, L, hd).chunk if chunked else hd
    q, k, v = (x.to(torch.float32).reshape(B, L, n_heads, hd).transpose(1, 2)
               for x in qkv.split(D, dim=-1))
    do = dctx.to(torch.float32).reshape(B, L, n_heads, hd).transpose(1, 2)
    div = torch.tensor(np.sqrt(hd), dtype=torch.float32)
    bias = torch.where(mask > 0, 0.0, MASKED).to(torch.float32)

    def product(a, b):   # a @ b from an accumulator of 0
        zero = torch.zeros(a.shape[:-1] + b.shape[-1:])
        return _mma(zero, a, b, passes)

    def over_d(a, b):   # a b^T, summed over the head's columns a chunk at a time
        acc = None
        for c0 in range(0, hd, C):
            part = product(a[..., c0:c0 + C],
                           b[..., c0:c0 + C].transpose(-1, -2))
            acc = part if acc is None else acc + part
        return acc

    def over_rows(a, b):   # a b, summed over the rows of b 8 at a time
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
        for j in range(0, a.shape[-1], 8):
            acc = acc + product(a[..., j:j + 8], b[..., j:j + 8, :])
        return acc

    s = over_d(q, k) / div + bias[:, None, None, :]
    dp = over_d(do, v)
    m = s.amax(dim=-1, keepdim=True)
    l = torch.exp(s - m).sum(dim=-1, keepdim=True)
    p = torch.exp(s - m) / l
    delta = (p * dp).sum(dim=-1, keepdim=True)
    dq = over_rows((p * (dp - delta)) / div, k)

    m_t, l_t, d_t = (x.transpose(-1, -2) for x in (m, l, delta))
    st = over_d(k, q) / div + bias[:, None, :, None]
    pt = torch.exp(st - m_t) / l_t
    dst = (pt * (over_d(v, do) - d_t)) / div
    dk, dv = over_rows(dst, q), over_rows(pt, do)
    return torch.cat([x.transpose(1, 2).reshape(B, L, D)
                      for x in (dq, dk, dv)], dim=-1)


def backward_work(B: int, L: int, n_heads: int, hd: int) -> dict:
    """{"dq", "dkv", "total"}: (bytes, FLOPs) each must spend. Every input
    read once and every output written once (4 B a float; the int32 mask;
    the (m, l, delta) row statistics as 16 B a row between the two), and 2
    hd FLOPs a product per (b, h, i, j): S and dP in both entry points, dQ
    in dq, dK and dV in dkv (6 and 8 hd); the gradient as one function
    needs S, dP, dQ, dK, dV (10 hd) and neither the statistics nor a
    second read."""
    D = n_heads * hd
    qkv, dctx, mask = 4 * B * L * 3 * D, 4 * B * L * D, 4 * B * L
    stats = 16 * B * n_heads * L
    pairs = B * n_heads * L * L * hd
    return {
        "dq": (qkv + dctx + mask + 4 * B * L * D + stats, 6 * pairs),
        "dkv": (qkv + dctx + mask + stats + 2 * 4 * B * L * D, 8 * pairs),
        "total": (qkv + dctx + mask + 4 * B * L * 3 * D, 10 * pairs),
    }


class SdpaBackward:
    """The library yardstick, used nowhere in the port: one
    `torch.autograd.grad` of a retained `F.scaled_dot_product_attention`
    graph (Q, K, V as (B, H, L, hd) leaves copied from qkv, an additive f32
    mask of 0 / -1e9, grad dctx), the backward alone, captured in CUDA
    graphs so that it is timed as the kernels are. `graph` replays the
    backward; `cold_graph` a write of `flush` (the L2 flush) and then the
    backward. `dqkv` is its gradient in the fused layout, for its error.

    Autograd runs each backward op on its forward op's stream, so the
    forward, the warm-up and both captures run on one side stream (the
    legacy default stream cannot be captured)."""

    def __init__(self, qkv: torch.Tensor, mask: torch.Tensor,
                 dctx: torch.Tensor, n_heads: int, flush: torch.Tensor):
        import torch.nn.functional as F

        B, L, D3 = qkv.shape
        D = D3 // 3
        hd = D // n_heads
        side = torch.cuda.Stream(device=qkv.device)
        side.wait_stream(torch.cuda.current_stream(qkv.device))
        with torch.cuda.stream(side):
            self.leaves = tuple(
                t.reshape(B, L, n_heads, hd).transpose(1, 2).contiguous()
                .requires_grad_(True) for t in qkv.detach().split(D, dim=-1))
            bias = torch.where(mask > 0, 0.0, -1e9).float()[:, None, None, :]
            with torch.enable_grad():
                self.out = F.scaled_dot_product_attention(*self.leaves,
                                                          attn_mask=bias)
            self.grad = dctx.reshape(B, L, n_heads, hd).transpose(
                1, 2).contiguous()
            for _ in range(2):
                dq, dk, dv = self._backward()
        torch.cuda.current_stream(qkv.device).wait_stream(side)
        self.dqkv = torch.cat([t.transpose(1, 2).reshape(B, L, D)
                               for t in (dq, dk, dv)], dim=-1)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self._backward()
        self.cold_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.cold_graph, stream=side):
            flush.zero_()
            self._backward()

    def _backward(self) -> tuple:
        return torch.autograd.grad(self.out, self.leaves, self.grad,
                                   retain_graph=True)


class StepTimer:
    """Device ms of each step of a loop: a CUDA event is recorded on the
    current stream before the first step and after each one, so a step's
    time is the stretch of the device's timeline between two events (it
    includes time the device waits for the host's launches). Reading the
    times synchronizes once."""

    def __init__(self):
        self.events = []

    def mark(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def step_ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                   self.events[1:])]


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------

def load_baseline(source: Path, wide: bool = False) -> Callable:
    """run(qkv, mask, dctx, H, parts=("dq", "dkv"), dqkv=None, stats=None)
    -> (dqkv, stats) over an earlier encoder_attention_backward.cu whose
    entry points take no tiling (the narrow ones, or with `wide` the wide
    ones), built with the port's nvcc flags: its dq, then its dkv, on the
    current stream; a part alone as `at.launch_backward` takes it."""
    from ..ops import _build

    lib = _build.load_source(source, "baseline_attention_backward")
    kind = "_wide" if wide else ""
    dq_fn = getattr(lib, f"encoder_attention_backward_dq{kind}_launch")
    dkv_fn = getattr(lib, f"encoder_attention_backward_dkv{kind}_launch")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for fn in (dq_fn, dkv_fn):
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64,
                       ctypes.c_float, ptr]
        fn.restype = ctypes.c_int

    def run(qkv, mask, dctx, H, parts=("dq", "dkv"), dqkv=None, stats=None):
        B, L, D3 = qkv.shape
        hd = D3 // 3 // H
        dqkv = torch.empty_like(qkv) if dqkv is None else dqkv
        if stats is None:
            stats = torch.empty((B * H * L, 4), dtype=torch.float32,
                                device=qkv.device)
        div = float(np.float32(np.sqrt(hd)))
        stream = torch.cuda.current_stream().cuda_stream
        if "dq" in parts:
            _check_launch(dq_fn(
                qkv.data_ptr(), mask.data_ptr(), dctx.data_ptr(),
                dqkv.data_ptr(), stats.data_ptr(), B, L, H, hd, div, stream))
        if "dkv" in parts:
            _check_launch(dkv_fn(
                qkv.data_ptr(), mask.data_ptr(), dctx.data_ptr(),
                stats.data_ptr(), dqkv.data_ptr(), B, L, H, hd, div, stream))
        return dqkv, stats

    return run


def current_parts(qkv, mask, dctx, H, wide: bool) -> Callable:
    """launch(part) of each current backward kernel alone ("dq" or "dkv",
    on the dqkv and stats of one launch of both), on the operands the
    wrapper gives it: a wide width that is not a multiple of 4 zero-padded
    to `wide_width`."""
    from ..ops import attention as at

    if not wide:
        dqkv, stats = at.launch_backward(qkv, mask, dctx, H)
        return lambda k: at.launch_backward(qkv, mask, dctx, H, (k,), dqkv,
                                            stats)
    B, L, D3 = qkv.shape
    hd = D3 // 3 // H
    w = at.wide_width(hd)
    if w != hd:
        qkv, dctx = (at.pad_heads(t, H, hd, w) for t in (qkv, dctx))
    stats = torch.empty((B * H * L, 4), dtype=torch.float32,
                        device=qkv.device)
    dqkv = at.launch_backward_wide(qkv, mask, dctx, H, stats=stats,
                                   div_hd=hd)
    return lambda k: at.launch_backward_wide(qkv, mask, dctx, H, (k,), dqkv,
                                             stats, div_hd=hd)


def _check_launch(err: int) -> None:
    if err:
        raise RuntimeError(f"baseline launch failed: cudaError_t {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wide", action="store_true",
                    help="the wide kernels (encoder_bench.WIDTH_CASES "
                         "above 128) instead of BACKWARD_CASES")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="an earlier encoder_attention_backward.cu to time "
                         "beside this one")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from .. import require_cuda
    from ..ops import attention as at
    from . import (
        H100_F32_OPS_PER_S,
        H100_TF32X3_OPS_PER_S,
        bound_ms,
        card_line,
        time_cuda,
        time_graph,
    )
    from .attention_bench import ptxas_lines
    from .encoder_bench import WIDTH_CASES
    from .pruned_bench import time_cold

    require_cuda()
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    at.load_backward_kernels()
    for ln in ptxas_lines("encoder_attention_backward"):
        print(f"  ptxas: {ln}", flush=True)
    cases = ({k: c for k, c in WIDTH_CASES.items() if c["hd"] > 128}
             if args.wide else BACKWARD_CASES)
    runners = {"current": lambda qkv, mask, dctx, H:
               at.encoder_attention_backward(qkv, mask, dctx, H)}
    if args.baseline is not None:
        base = load_baseline(args.baseline, args.wide)
        runners["baseline"] = lambda qkv, mask, dctx, H: base(
            qkv, mask, dctx, H)[0]
    turns = ("baseline", "current", "current", "baseline") \
        if args.baseline is not None else ("current",)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    for i, (label, case) in enumerate(cases.items()):
        B, L, H, hd = case["B"], case["L"], case["H"], case["hd"]
        qkv, mask, dctx = backward_inputs(case, 160 + i, device)
        ref = backward_reference(qkv, mask, dctx, H)
        works = backward_work(B, L, H, hd)
        work = works["total"]
        bound, by = bound_ms(*work, H100_TF32X3_OPS_PER_S)
        ffma, ffma_by = bound_ms(*work, H100_F32_OPS_PER_S)
        if args.wide:
            t = at.wide_backward_tiles_for(B, H, L, at.wide_width(hd))
            tiles = (f"(rows, chunk, row tiles, grid) "
                     f"{(t.rows, t.chunk, t.row_tiles, t.grid)}")
        else:
            tiles = "(warps, pairs, tile, stages, grid) " + str({
                k: (t.warps, t.pairs, t.tile, t.stages, t.grid)
                for k, t in at.backward_tiles_for(B, H, L, hd).items()})
        print(f"{label}: {work[0] / 1e6:.1f} MB, {work[1] / 1e9:.3f} GFLOP; "
              f"bound {bound:.4f} ms ({by}, 3xTF32 at 165 TFLOP/s) [FFMA "
              f"rate: {ffma:.4f} ms, {ffma_by}]; tiles {tiles} [{card}]",
              flush=True)
        for who in dict.fromkeys(turns):
            got = runners[who](qkv, mask, dctx, H)
            torch.cuda.synchronize()
            err = float((got.double() - ref).abs().max())
            if not (bool(torch.isfinite(got).all()) and torch.allclose(
                    got.double(), ref, rtol=BWD_TOL, atol=BWD_TOL)):
                raise AssertionError(f"{label}: {who} is not within "
                                     f"{BWD_TOL} of the f64 reference (max "
                                     f"abs err {err:.3g})")
            print(f"  {who}: max abs err {err:.3g} against f64", flush=True)
        times = {}
        for who in turns:
            run = runners[who]
            for k, v in (
                    ("warm", time_graph(lambda: run(qkv, mask, dctx, H),
                                        args.reps)),
                    ("cold", time_cold(lambda: run(qkv, mask, dctx, H),
                                       flush, args.reps))):
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
        D = H * hd
        got = runners["current"](qkv, mask, dctx, H)
        diff = (got.double() - ref).abs()
        print(f"  current: max abs err dQ {float(diff[..., :D].max()):.3g}, "
              f"dK {float(diff[..., D:2 * D].max()):.3g}, dV "
              f"{float(diff[..., 2 * D:].max()):.3g}", flush=True)
        parts = {"current": current_parts(qkv, mask, dctx, H, args.wide)}
        if args.baseline is not None:
            b_dqkv, b_stats = base(qkv, mask, dctx, H)
            parts["baseline"] = lambda k: base(qkv, mask, dctx, H, (k,),
                                               b_dqkv, b_stats)
        for who, launch in parts.items():
            cold = {k: time_cold(lambda k=k: launch(k), flush, args.reps)
                    for k in ("dq", "dkv")}
            shares = []
            for k in ("dq", "dkv"):
                bd, bd_by = bound_ms(*works[k], H100_TF32X3_OPS_PER_S)
                bf = bound_ms(*works[k], H100_F32_OPS_PER_S)[0]
                shares.append(
                    f"{k} {cold[k]:.4f} ms (bound {bd:.4f} ms {bd_by}, "
                    f"{100 * bd / cold[k]:.1f}%; FFMA rate {bf:.4f} ms, "
                    f"{100 * bf / cold[k]:.1f}%)")
            print(f"  {who}, each kernel alone, L2 cold: "
                  + "; ".join(shares)
                  + f"; together {sum(cold.values()):.4f} ms [{card}]",
                  flush=True)
        lib = SdpaBackward(qkv, mask, dctx, H, flush)
        lib_warm = time_cuda(lib.graph.replay, args.reps)
        lib_cold = time_cuda(lib.cold_graph.replay, args.reps) - time_graph(
            flush.zero_, args.reps)
        lib_err = float((lib.dqkv.double() - ref).abs().max())
        del lib
        print(f"  autograd.grad of scaled_dot_product_attention (additive "
              f"f32 mask), backward alone: {lib_warm:.4f} ms (L2 warm), "
              f"{lib_cold:.4f} ms (L2 cold); max abs err {lib_err:.3g} "
              f"against f64 [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
