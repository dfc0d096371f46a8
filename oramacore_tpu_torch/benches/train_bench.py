"""Inputs and yardsticks of the training checks on the card
(`chip_smoke.py` phase 16).

- `BACKWARD_CASES`: the shapes at which the attention's backward kernels
  (`encoder_attention_backward_dq`, `encoder_attention_backward_dkv`) are
  held to their plain version: the training call (B=64 pairs of L=16 at
  SemanticBase's 8 heads of 32), SemanticBase's B=1024 L=64 `encode`
  shape, BGEBase's geometry (12 heads of 64, L=512), head widths 16 and
  128 (no registry model has them: the forward's cases of the same
  shapes), an odd L=37, padded batch rows whose keys are all masked, and
  L=1. `backward_inputs` makes them from a seed: `encoder_bench`'s qkv and
  mask, and dctx drawn normal.
- `backward_reference`: the f64 reference, `encoder_attention_backward_
  plain` in f64 with P uniform in batch rows whose keys are all masked,
  as the f32 math of JAX and of the kernels gives it there.
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

import numpy as np
import torch

from .encoder_bench import attention_inputs

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
