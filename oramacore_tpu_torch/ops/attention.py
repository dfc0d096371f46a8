"""Encoder self-attention: the wrapper of `csrc/encoder_attention.cu`.

The port of the attention inside the jitted JAX function
`oramacore_tpu/embeddings/flax_encoder.py::bert_forward` (`:97-105`;
JAX jits it, there is no pallas_call):

    q, k, v = (B, L, H, hd) views of the fused projection
    att = softmax(einsum("bqhd,bkhd->bhqk", q, k) / sqrt(hd) + neg)
    ctx = einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)

with `neg` 0 where `mask[b, j] > 0` and -1e9 elsewhere.
`encoder_attention(qkv, mask, n_heads)` takes the projection output
`qkv` f32[B, L, 3D] (Q, K, V side by side, head h at columns h * hd of
each) and the key mask int32[B, L], and returns ctx f32[B, L, D].
`encoder_attention_plain` is the same math step by step in PyTorch, in
the dtype it is given (the card's check runs it in f64).

- Supported: 1 <= L <= 512 and head width hd in {32, 64}, which cover
  every model of the registry; anything else raises ValueError, on every
  device. Nothing gives way to the plain version on the card. The plain
  version takes any head width: `embeddings/encoder.BertEncoder` calls it
  for the others on CPU tensors, as JAX's `bert_forward` serves any
  width; on the card those widths raise until the kernel takes them.
- A batch row whose mask is all zero (the padding rows of a power-of-two
  batch) gets the mean of V in every query row, as in JAX: -1e9 is added
  to every score, and at 1e9 the f32 ulp is 64, so all its scores round
  to one value while they stay within ±32. A boolean mask in
  `scaled_dot_product_attention` gives NaN there instead.

The kernel runs both products on the tensor cores in 3xTF32 (each f32
operand split into two tf32 parts, three products summed in f32), which
keeps f32 accuracy; a single tf32 pass is never used. `tiles_for` is its
tiling, chosen here so the CPU tests reach it.

A CPU tensor runs the plain version. A CUDA tensor launches the kernel or
raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .score_windows import _device_of, _raise_on

MAX_LEN = 512
HEAD_DIMS = (32, 64)
MASKED = -1e9

# Kernel launches, counted only where the kernel is enqueued (never for
# the plain version). Reset with reset_launch_counts.
LAUNCHES = {"encoder_attention": 0}

# the kernel's tiling (csrc/encoder_attention.cu): a block of 4 warps, 16
# query rows a warp; per (b, h) a ring of at most 2 raw stages of K, V and
# the mask as cp.async lands them, and one split stage (K rows of 2 hd + 16
# floats, V key-pair rows of 4 hd + 8, a bias a key)
_WARPS = 4
_THREADS = 32 * _WARPS
_SMEM_PER_SM = 227 * 1024           # shared memory a block may use on the H100
_REGS_PER_SM = 65_536
# blocks an SM the launch bound asks ptxas to fit (168 registers a thread)
_MIN_BLOCKS = 3
# key tile of 64 query rows a block (W = 4), by head width: at hd 64 the
# split stage of 64 keys would leave room for one block an SM
_LONG_KEY_TILE = {32: 64, 64: 32}


class Tiles(NamedTuple):
    """How the kernel tiles one call (see `tiles_for`)."""
    warps: int       # warps sharing one (b, h), 16 query rows each
    key_tile: int    # keys a shared-memory stage holds
    pairs: int       # (b, h) pairs a block serves: 4 // warps
    q_tiles: int     # blocks along the query rows of one (b, h)
    stages: int      # cp.async ring depth: 2, or 1 where one tile covers L
    grid: int        # blocks launched
    smem: int        # dynamic shared-memory bytes a block
    max_regs: int    # registers a thread may hold (the launch bound)
    blocks_per_sm: int   # resident blocks an SM, by registers and smem

    @property
    def rows(self) -> int:
        """Query rows of one (b, h) a block covers."""
        return 16 * self.warps


def tiles_for(B: int, n_heads: int, L: int, hd: int) -> Tiles:
    """The kernel's tiling of a call: W warps a (b, h) and key tiles of KT
    = 16 W keys up to L = 32 (so a short sequence neither computes nor
    stages rows and keys it lacks, and a block serves 4 / W pairs), then
    W = 4 (64 query rows) with KT = 64 at hd 32 and 32 at hd 64, and a
    two-stage ring, so tile t + 1 is copied while tile t is computed."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} is not one of {HEAD_DIMS}")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"sequence length {L} is outside [1, {MAX_LEN}]")
    W = 1 if L <= 16 else 2 if L <= 32 else 4
    KT = _LONG_KEY_TILE[hd] if W == 4 else 16 * W
    pairs = _WARPS // W
    q_tiles = -(-L // (16 * W))
    stages = min(2, -(-L // KT))
    grid = -(-(B * n_heads) // pairs) * q_tiles
    raw = 2 * KT * hd + KT
    split = KT * (2 * hd + 16) + KT // 2 * (4 * hd + 8) + KT
    smem = pairs * (stages * raw + split) * 4
    # ptxas gives whole 8-register steps a thread
    max_regs = min(255, _REGS_PER_SM // (_THREADS * _MIN_BLOCKS) // 8 * 8)
    per_sm = min(_REGS_PER_SM // (_THREADS * max_regs),
                 _SMEM_PER_SM // smem, 2048 // _THREADS)
    return Tiles(W, KT, pairs, q_tiles, stages, grid, smem, max_regs, per_sm)


_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (first call) and bind the CUDA library."""
    global _lib
    if _lib is None:
        lib = _build.load("encoder_attention")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.encoder_attention_launch.argtypes = [
            ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, i64, ctypes.c_float,
            i64, ptr]
        lib.encoder_attention_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_shapes(qkv: torch.Tensor, mask: torch.Tensor,
                 n_heads: int) -> tuple:
    """(B, L, D, hd) of a call the kernel supports; ValueError otherwise."""
    B, L, D, hd = plain_shapes(qkv, mask, n_heads)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} is not one of {HEAD_DIMS}")
    return B, L, D, hd


def plain_shapes(qkv: torch.Tensor, mask: torch.Tensor,
                 n_heads: int) -> tuple:
    """(B, L, D, hd) of a call the plain version takes, any head width;
    ValueError otherwise."""
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, L, 3D), got {tuple(qkv.shape)}")
    B, L, D3 = qkv.shape
    D = D3 // 3
    if n_heads <= 0 or D % n_heads:
        raise ValueError(f"width {D} is not a multiple of {n_heads} heads")
    hd = D // n_heads
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"sequence length {L} is outside [1, {MAX_LEN}]")
    if tuple(mask.shape) != (B, L):
        raise ValueError(f"mask must be ({B}, {L}), got {tuple(mask.shape)}")
    return B, L, D, hd


def attention_work(B: int, L: int, n_heads: int, hd: int) -> tuple:
    """(bytes, FLOPs) one call needs: Q, K, V read once and ctx written
    once (4 B each) plus the int32 mask; 2 * L * hd FLOPs for the scores
    and as many for the weighted sum, per (b, h, query row)."""
    D = n_heads * hd
    return 4 * B * L * D * 4 + B * L * 4, 4 * B * n_heads * L * L * hd


def encoder_attention_plain(qkv: torch.Tensor, mask: torch.Tensor,
                            n_heads: int) -> torch.Tensor:
    """Plain PyTorch version: the JAX code step by step, in qkv's dtype,
    at any head width (`BertEncoder` sends it, on CPU tensors, the widths
    the kernel refuses)."""
    B, L, D, hd = plain_shapes(qkv, mask, n_heads)
    q, k, v = (t.reshape(B, L, n_heads, hd) for t in qkv.split(D, dim=-1))
    # a 0-d tensor divisor divides (a Python scalar would multiply by the
    # reciprocal on the card); f32(sqrt(hd)) as JAX rounds np.sqrt(hd)
    div = torch.tensor(np.sqrt(hd), dtype=qkv.dtype, device=qkv.device)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / div
    zero = torch.zeros((), dtype=qkv.dtype, device=qkv.device)
    neg = torch.where(mask[:, None, None, :] > 0, zero, zero + MASKED)
    att = torch.softmax(att + neg, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)


def encoder_attention(qkv: torch.Tensor, mask: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    """ctx f32[B, L, D] of the attention; see the module doc."""
    B, L, D, hd = check_shapes(qkv, mask, n_heads)
    dev = _device_of((qkv, mask))
    if dev.type == "cpu":
        return encoder_attention_plain(qkv, mask, n_heads)
    return launch(qkv, mask, n_heads)


def launch(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int,
           mode: int = 0) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors. mode 0 is the attention;
    1 (the bytes only: Q, K, V in, ctx out, no math), 2 (the math only:
    nothing read from device memory) and 3 (the mma.sync sequence only)
    are the bench's limit cases, whose output is no attention."""
    B, L, D, hd = check_shapes(qkv, mask, n_heads)
    dev = _device_of((qkv, mask))
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {dev}")
    if qkv.dtype != torch.float32:
        raise TypeError(f"qkv: expected torch.float32, got {qkv.dtype}")
    if mask.dtype != torch.int32:
        raise TypeError(f"mask: expected torch.int32, got {mask.dtype}")
    if not (qkv.is_contiguous() and mask.is_contiguous()):
        raise ValueError("qkv and mask must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must start on a 16-byte boundary")
    lib = load_kernels()
    tiles = tiles_for(B, n_heads, L, hd)
    ctx = torch.empty((B, L, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.encoder_attention_launch(
            qkv.data_ptr(), mask.data_ptr(), ctx.data_ptr(), B, L, n_heads,
            hd, tiles.warps, tiles.key_tile, tiles.stages,
            float(np.float32(np.sqrt(hd))), mode, stream)
    _raise_on(err, "encoder_attention")
    LAUNCHES["encoder_attention"] += 1
    return ctx
