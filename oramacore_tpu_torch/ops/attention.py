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

- Supported: 1 <= L <= 512 and any head width, as JAX's `bert_forward`
  serves any width; a longer sequence raises ValueError. The
  tensor-core kernels take head widths in {16, 32, 64, 128} (the
  registry's models have 32 and 64). The wrappers choose a route by
  shape, before any launch (`route`): a kernel width launches as it is;
  a width under 128 (8, 48, 96, ...) is zero-padded to the next kernel
  width (`padded_width`), launched with the divisor f32(sqrt(hd)) of the
  true width, and sliced back (zero columns leave Q K^T and dP = dO V^T
  unchanged, and the padded columns of O, dQ, dK and dV are zero); a
  width above 128 takes the "wide" instances (`launch_wide`,
  `launch_backward_wide`, csrc/attention_wide.cuh: a 16 x hd accumulator
  a warp no longer fits in registers, so they stream the head's columns,
  all three on the tensor cores in 3xTF32, tiled by `wide_tiles_for` and
  `wide_backward_tiles_for`; a width that is not a multiple of 4 is
  zero-padded to one, `wide_width`, with the true width's divisor). A
  CPU tensor runs the plain version at any width (forward calls above
  128 counted in `PLAIN_WIDTH_CALLS`).
- A batch row whose mask is all zero (the padding rows of a power-of-two
  batch) gets the mean of V in every query row, as in JAX: -1e9 is added
  to every score, and at 1e9 the f32 ulp is 64, so all its scores round
  to one value while they stay within ±32. A boolean mask in
  `scaled_dot_product_attention` gives NaN there instead.

The kernel runs both products on the tensor cores in 3xTF32 (each f32
operand split into two tf32 parts, three products summed in f32), which
keeps f32 accuracy; a single tf32 pass is never used. `tiles_for` is its
tiling, chosen here so the CPU tests reach it.

The gradient (`csrc/encoder_attention_backward.cu`, what JAX's autodiff
derives from those lines in `scripts/train_semantic_encoder_v2.py`'s
jitted `train_step`): `encoder_attention_backward(qkv, mask, dctx,
n_heads)` returns dqkv f32[B, L, 3D] in the fused layout, by two kernels
in stream order (`encoder_attention_backward_dq`: dQ and each query row's
max, sum and delta = rowsum(P * dP); `encoder_attention_backward_dkv`: dK
and dV from those), both with their products on the tensor cores in
3xTF32 as the forward's; `backward_tiles_for` is their tiling.
`encoder_attention_backward_plain` is the vjp step by step. `EncoderAttention` is the autograd Function around both directions,
which `BertEncoder` calls: under `inference_mode` only its forward runs.

A CPU tensor runs the plain version. A CUDA tensor takes its route by
shape before any launch (above): a kernel launch, which raises on
failure and never falls back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .score_windows import _device_of, _raise_on

MAX_LEN = 512
HEAD_DIMS = (16, 32, 64, 128)
MASKED = -1e9

# Forward calls on CPU tensors whose head width takes the wide route on
# the card (above 128), run by encoder_attention_plain in
# `encoder_attention`.
PLAIN_WIDTH_CALLS = {"encoder_attention_plain": 0}

# Kernel launches, counted only where the kernel is enqueued (never for
# the plain version). Reset with reset_launch_counts.
LAUNCHES = {"encoder_attention": 0, "encoder_attention_backward_dq": 0,
            "encoder_attention_backward_dkv": 0}

# the kernel's tiling (csrc/encoder_attention.cu): a block of 4 warps, 16
# query rows a warp; per (b, h) a ring of at most 2 raw stages of K, V and
# the mask as cp.async lands them, and one split stage (K rows of 2 hd + 16
# floats, V key-pair rows of 4 hd + 8, a bias a key)
_WARPS = 4
_THREADS = 32 * _WARPS
_SMEM_PER_SM = 227 * 1024           # shared memory a block may use on the H100
_REGS_PER_SM = 65_536
# blocks an SM the launch bound asks ptxas to fit, by head width: 3 (168
# registers a thread); 2 at hd 128 (255), whose O accumulator alone takes
# 64 registers a thread
_MIN_BLOCKS = {16: 3, 32: 3, 64: 3, 128: 2}
# key tile of 64 query rows a block (W = 4), by head width: at hd 64 a
# split stage of 64 keys, and at hd 128 one of 32, would leave room for
# one block an SM
_LONG_KEY_TILE = {16: 64, 32: 64, 64: 32, 128: 16}


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
    W = 4 (64 query rows) with KT = 64 at hd 16 and 32, 32 at hd 64 and
    16 at hd 128 (`_LONG_KEY_TILE`), and a two-stage ring, so tile t + 1
    is copied while tile t is computed."""
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
    max_regs = min(255, _REGS_PER_SM // (_THREADS * _MIN_BLOCKS[hd]) // 8 * 8)
    per_sm = min(_REGS_PER_SM // (_THREADS * max_regs),
                 _SMEM_PER_SM // smem, 2048 // _THREADS)
    return Tiles(W, KT, pairs, q_tiles, stages, grid, smem, max_regs, per_sm)


# the backward kernels' tiling (csrc/encoder_attention_backward.cu): rows
# of the other side (keys in dq, queries in dkv) a tile holds when 4 warps
# share a (b, h); 2 blocks an SM (255 registers a thread), each within half
# of an SM's 228 KB of shared memory less the 1 KB it reserves a block
_BWD_LONG_TILE = {16: 64, 32: 64, 64: 32, 128: 16}
_BWD_MIN_BLOCKS = 2
_SMEM_SM = 228 * 1024
_SMEM_RESERVED = 1024


class BackwardTiles(NamedTuple):
    """How one backward kernel tiles a call (see `backward_tiles_for`);
    the wrapper launches with every field but `blocks_per_sm`."""
    warps: int       # warps sharing one (b, h), 16 rows each
    tile: int        # rows of the other side a shared-memory stage holds
    pairs: int       # (b, h) pairs a block serves
    row_tiles: int   # blocks along the rows of one (b, h)
    stages: int      # cp.async ring depth: 2, or 1 where one tile covers L
    grid: int        # blocks launched
    smem: int        # dynamic shared-memory bytes a block (the kernel
                     # refuses a launch whose layout takes another size)
    blocks_per_sm: int   # resident blocks an SM, by registers and smem


def _backward_floats(kernel: str, hd: int, T: int, stages: int) -> int:
    """Shared-memory floats of one (b, h) group of a backward kernel: the
    raw stages as cp.async lands them and the split stage (d-major rows of
    2 hd + 16 floats, row-pair rows of 4 hd + 8). The kernels' DqTile and
    DkvTile lay out the same floats, and refuse a launch with another
    size."""
    d_major, pair_major = T * (2 * hd + 16), T // 2 * (4 * hd + 8)
    if kernel == "dq":   # raw K, V, mask; split K both ways, V, the bias
        return stages * (2 * T * hd + T) + 2 * d_major + pair_major + T
    # dkv: raw Q, dO, statistics; split Q and dO both ways, the statistics
    return stages * (2 * T * hd + 4 * T) + 2 * (d_major + pair_major) + 4 * T


def backward_tiles_for(B: int, n_heads: int, L: int, hd: int) -> dict:
    """{"dq": BackwardTiles, "dkv": BackwardTiles} of a call. Both kernels
    give each warp 16 rows of its side (queries in dq, keys in dkv): W = 1
    warp a (b, h) up to L = 16, 2 up to 32, else 4 (as `tiles_for`), and
    walk the other side in tiles of T = min(16 W, 64 at hd 16 and 32, 32
    at hd 64, 16 at hd 128) rows through a two-stage ring (one stage
    where one tile covers L). A block serves 4 / W pairs, halved while 2
    blocks would not fit an SM's shared memory. The launch bound of 2
    blocks an SM gives a thread 255 registers."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} is not one of {HEAD_DIMS}")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"sequence length {L} is outside [1, {MAX_LEN}]")
    W = 1 if L <= 16 else 2 if L <= 32 else 4
    T = min(16 * W, _BWD_LONG_TILE[hd])
    stages = min(2, -(-L // T))
    row_tiles = -(-L // (16 * W))
    out = {}
    for kernel in ("dq", "dkv"):
        G = _WARPS // W
        while G > 1 and _BWD_MIN_BLOCKS * (
                G * _backward_floats(kernel, hd, T, 2) * 4
                + _SMEM_RESERVED) > _SMEM_SM:
            G //= 2
        threads = 32 * W * G
        smem = G * _backward_floats(kernel, hd, T, stages) * 4
        per_sm = min(_REGS_PER_SM // (threads * 255),
                     _SMEM_SM // (smem + _SMEM_RESERVED), 2048 // threads, 32)
        out[kernel] = BackwardTiles(
            W, T, G, row_tiles, stages, -(-(B * n_heads) // G) * row_tiles,
            smem, per_sm)
    return out


# the wide backward kernels' tiling (csrc/encoder_attention_backward.cu,
# head widths above 128): a block of 8 warps owns 16 rows of one (b, h)
# and keeps their scores against all L rows of the other side (two floats
# a pair, rows of L rounded up to 128, plus 4); phase A streams tiles of
# 128 other-side rows a head-column chunk at a time through a two-stage
# ring (the 16 own rows and the tile's, two operands each, chunk + 4
# floats a row). The chunks the .cu compiles, in the order tried: 32
# where it pads no more columns than 16 and 2 blocks fit an SM, else 16
# (2 blocks fit at every L)
WIDE_CHUNKS = (32, 16)
_WIDE_ROWS = 16
_WIDE_TILE = 128
_WIDE_THREADS = 256


class WideTiles(NamedTuple):
    """How the wide kernels tile a call (see `wide_tiles_for`, the
    forward's, and `wide_backward_tiles_for`, both backward kernels'); the
    wrapper launches with every field but `blocks_per_sm`."""
    rows: int        # rows of its own side of one (b, h) a block owns
    chunk: int       # head columns a phase-A stage holds (C)
    row_tiles: int   # blocks along the rows of one (b, h)
    grid: int        # blocks launched: B H row_tiles
    smem: int        # dynamic shared-memory bytes a block (the kernels
                     # refuse a launch whose layout takes another size)
    blocks_per_sm: int   # resident blocks an SM by shared memory


def _wide_smem(rows: int, chunk: int, L: int, ops: int) -> int:
    """Shared-memory bytes of a wide block (attention_wide.cuh's
    TileLayout) that owns `rows` rows with `ops` operands a side: `ops`
    score arrays of round128(L) + 4 floats a row, and a ring of 2 stages
    of ops x (rows + 128) rows of chunk + 4 floats."""
    stride = -(-L // _WIDE_TILE) * _WIDE_TILE + 4
    stage = ops * (rows + _WIDE_TILE) * (chunk + 4)
    return 4 * (ops * rows * stride + 2 * stage)


def wide_backward_smem(chunk: int, L: int) -> int:
    """Shared-memory bytes of a wide backward block (the kernels'
    WideTile): two score rows of round128(L) + 4 floats for each of the 16
    rows, and a ring of 2 stages of (2 x 16 + 2 x 128) rows of chunk + 4
    floats."""
    return _wide_smem(_WIDE_ROWS, chunk, L, 2)


def _wide_chunk(hd: int, smem_of, blocks: int) -> tuple:
    """(chunk, smem, blocks an SM by shared memory): the first of
    `WIDE_CHUNKS` whose block `smem_of(chunk)` fits `blocks` an SM, taking
    chunks of 32 columns only where they compute no more padded columns
    than 16 (hd mod 32 is 0 or above 16)."""
    for chunk in WIDE_CHUNKS:
        if chunk == 32 and 0 < hd % 32 <= 16:
            continue
        smem = smem_of(chunk)
        per_sm = _SMEM_SM // (smem + _SMEM_RESERVED)
        if per_sm >= blocks:
            break
    return chunk, smem, per_sm


def _check_wide_call(L: int, hd: int) -> None:
    if hd < 1:
        raise ValueError(f"head width {hd} is not positive")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"sequence length {L} is outside [1, {MAX_LEN}]")


def wide_backward_tiles_for(B: int, n_heads: int, L: int,
                            hd: int) -> WideTiles:
    """The wide backward kernels' tiling of a call (both kernels take the
    same): 16 rows a block, and the first of `WIDE_CHUNKS` that fits 2
    blocks an SM (16 resident warps), taking chunks of 32 columns only
    where they compute no more padded columns than 16 (hd mod 32 is 0 or
    above 16)."""
    _check_wide_call(L, hd)
    chunk, smem, per_sm = _wide_chunk(
        hd, lambda c: wide_backward_smem(c, L), 2)
    row_tiles = -(-L // _WIDE_ROWS)
    return WideTiles(_WIDE_ROWS, chunk, row_tiles, B * n_heads * row_tiles,
                     smem, min(per_sm, 2048 // _WIDE_THREADS))


# the wide forward's tiling (csrc/encoder_attention.cu, head widths above
# 128): a block of 8 warps owns 16 or 32 query rows of one (b, h) (one or
# two m16 tiles a warp) and keeps their scores against all L keys (one
# float a pair); its ring holds the block's Q rows and a tile of 128 K
# rows, a chunk of columns each. The (rows, chunk) pairs the .cu compiles;
# the blocks an SM each launch bound asks for, by rows
WIDE_FWD_ROWS = (16, 32)
_WIDE_FWD_BLOCKS = {16: 3, 32: 2}


def wide_smem(rows: int, chunk: int, L: int) -> int:
    """Shared-memory bytes of a wide forward block (the kernel's
    TileLayout): one score row of round128(L) + 4 floats for each of its
    rows, and a ring of 2 stages of (rows + 128) rows of chunk + 4
    floats."""
    return _wide_smem(rows, chunk, L, 1)


_SMS = 132   # streaming multiprocessors of the H100


def wide_rows(B: int, n_heads: int, L: int) -> int:
    """Query rows a wide forward block owns: 32 (two m16 tiles a warp,
    each split fragment of K and V feeding two products, half the re-reads
    of K and V), unless L <= 16 (half of each block would be padding) or
    32-row blocks would number fewer than the card's SMs, where twice as
    many 16-row blocks fill more of it. On the card (NVIDIA H100 80GB
    HBM3, `attention_bench --wide --sweep`) 32 rows ran faster at every
    sweep case but those two kinds."""
    if L <= 16 or B * n_heads * -(-L // 32) < _SMS:
        return 16
    return 32


def wide_tiles_for(B: int, n_heads: int, L: int, hd: int,
                   rows=None) -> WideTiles:
    """The wide forward kernel's tiling of a call: `rows` query rows a
    block (`wide_rows` when None; 16 or 32) and the first of
    `WIDE_CHUNKS` that fits the blocks an SM its launch bound asks for (3
    at 16 rows, 2 at 32), taking chunks of 32 columns only where they
    compute no more padded columns than 16."""
    _check_wide_call(L, hd)
    rows = wide_rows(B, n_heads, L) if rows is None else rows
    if rows not in WIDE_FWD_ROWS:
        raise ValueError(f"rows {rows} are not one of {WIDE_FWD_ROWS}")
    chunk, smem, per_sm = _wide_chunk(
        hd, lambda c: wide_smem(rows, c, L), _WIDE_FWD_BLOCKS[rows])
    row_tiles = -(-L // rows)
    return WideTiles(rows, chunk, row_tiles, B * n_heads * row_tiles, smem,
                     min(per_sm, 2048 // _WIDE_THREADS))


_lib = None
_bwd_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (first call) and bind the forward's CUDA library."""
    global _lib
    if _lib is None:
        lib = _build.load("encoder_attention")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.encoder_attention_launch.argtypes = [
            ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, i64, ctypes.c_float,
            i64, ptr]
        lib.encoder_attention_launch.restype = ctypes.c_int
        lib.encoder_attention_wide_launch.argtypes = [
            ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, i64, i64, i64,
            ctypes.c_float, ptr]
        lib.encoder_attention_wide_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def load_backward_kernels() -> ctypes.CDLL:
    """Build (first call) and bind the backward's CUDA library, which only
    training launches."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("encoder_attention_backward")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for fn in (lib.encoder_attention_backward_dq_launch,
                   lib.encoder_attention_backward_dkv_launch):
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64,
                           i64, i64, i64, i64, i64, i64, i64,
                           ctypes.c_float, ptr]
            fn.restype = ctypes.c_int
        for fn in (lib.encoder_attention_backward_dq_wide_launch,
                   lib.encoder_attention_backward_dkv_wide_launch):
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64,
                           i64, i64, i64, i64, i64, ctypes.c_float, ptr]
            fn.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


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


def padded_width(hd: int):
    """The kernel width a head width runs at: hd itself in HEAD_DIMS, the
    next one above it under 128, None above 128 (the wide route)."""
    return next((w for w in HEAD_DIMS if w >= hd), None)


def route(hd: int) -> str:
    """How the wrappers run a head width on the card: "kernel" (a
    tensor-core kernel width), "padded" (zero-padded to `padded_width`)
    or "wide" (above 128: the instances of `launch_wide` and
    `launch_backward_wide`, at `wide_width`)."""
    w = padded_width(hd)
    return "wide" if w is None else "kernel" if w == hd else "padded"


def wide_width(hd: int) -> int:
    """The width the wide kernels run a head width above 128 at:
    hd rounded up to a multiple of 4, so each head's rows are 16-byte
    copies (the kernels take any width, a ragged one by 4-byte copies
    that cost about 4 times as much)."""
    return -(-hd // 4) * 4


def pad_heads(t: torch.Tensor, n_heads: int, hd: int,
              width: int) -> torch.Tensor:
    """(B, L, P * n_heads * hd) with each head's columns zero-padded to
    `width`: (B, L, P * n_heads * width), contiguous (P = 3 for qkv, 1 for
    ctx or dctx)."""
    B, L, C = t.shape
    parts = C // (n_heads * hd)
    x = t.reshape(B, L, parts * n_heads, hd)
    # one write of each element (faster on the card than a zero fill and a
    # copy into it)
    out = torch.cat([x, x.new_zeros((B, L, parts * n_heads, width - hd))],
                    dim=-1)
    return out.reshape(B, L, parts * n_heads * width)


def unpad_heads(t: torch.Tensor, n_heads: int, hd: int,
                width: int) -> torch.Tensor:
    """The inverse of `pad_heads`: each head's first hd columns."""
    B, L, C = t.shape
    parts = C // (n_heads * width)
    return t.reshape(B, L, parts, n_heads, width)[..., :hd].reshape(
        B, L, parts * n_heads * hd)


def encoder_attention_plain(qkv: torch.Tensor, mask: torch.Tensor,
                            n_heads: int, div_hd=None) -> torch.Tensor:
    """Plain PyTorch version: the JAX code step by step, in qkv's dtype,
    at any head width; the scores are divided by sqrt(div_hd) (the head
    width when None; a padded call's check passes the true one)."""
    B, L, D, _ = plain_shapes(qkv, mask, n_heads)
    _, _, v, att, _ = attention_probs(qkv, mask, n_heads, div_hd)
    return torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)


def encoder_attention(qkv: torch.Tensor, mask: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    """ctx f32[B, L, D] of the attention; see the module doc. A CPU
    tensor runs the plain version at any head width (above 128 counted in
    PLAIN_WIDTH_CALLS). On the card the route is chosen by the head width
    before any launch (`route`): the kernel, the kernel on zero-padded
    heads, or, above 128, the wide kernel (at `wide_width`: a width that
    is not a multiple of 4 zero-padded to one, with the true width's
    divisor, and sliced back)."""
    B, L, D, hd = plain_shapes(qkv, mask, n_heads)
    how = route(hd)
    if _device_of((qkv, mask)).type == "cpu":
        if how == "wide":
            PLAIN_WIDTH_CALLS["encoder_attention_plain"] += 1
        return encoder_attention_plain(qkv, mask, n_heads)
    if how == "wide":
        w = wide_width(hd)
        if w == hd:
            return launch_wide(qkv, mask, n_heads)
        ctx = launch_wide(pad_heads(qkv, n_heads, hd, w), mask, n_heads,
                          div_hd=hd)
        return unpad_heads(ctx, n_heads, hd, w)
    if how == "padded":
        w = padded_width(hd)
        ctx = launch(pad_heads(qkv, n_heads, hd, w), mask, n_heads,
                     div_hd=hd)
        return unpad_heads(ctx, n_heads, hd, w)
    return launch(qkv, mask, n_heads)


def launch(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int,
           mode: int = 0, div_hd=None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors of a kernel head width;
    the scores are divided by f32(sqrt(div_hd)) (the head width when None;
    a padded call passes its true width). mode 0 is the attention;
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
            float(np.float32(np.sqrt(div_hd or hd))), mode, stream)
    _raise_on(err, "encoder_attention")
    _build.count_launch(LAUNCHES, "encoder_attention")
    return ctx


def _check_wide(qkv, mask, dctx=None):
    """The device of a wide launch's CUDA tensors, checked."""
    tensors = (qkv, mask) if dctx is None else (qkv, mask, dctx)
    dev = _device_of(tensors)
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {dev}")
    for name, t, dtype in (("qkv", qkv, torch.float32),
                           ("mask", mask, torch.int32),
                           ("dctx", dctx, torch.float32)):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def launch_wide(qkv: torch.Tensor, mask: torch.Tensor, n_heads: int,
                div_hd=None, rows=None) -> torch.Tensor:
    """One launch of the wide forward kernel (any head width; the wrapper
    sends those above 128, at `wide_width`) on CUDA tensors, tiled by
    `wide_tiles_for` (`rows` query rows a block, its own choice when
    None), divisor f32(sqrt(div_hd)) (the head width when None). Counted
    as `encoder_attention`."""
    B, L, D, hd = plain_shapes(qkv, mask, n_heads)
    dev = _check_wide(qkv, mask)
    lib = load_kernels()
    tl = wide_tiles_for(B, n_heads, L, hd, rows)
    ctx = torch.empty((B, L, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.encoder_attention_wide_launch(
            qkv.data_ptr(), mask.data_ptr(), ctx.data_ptr(), B, L, n_heads,
            hd, tl.rows, tl.chunk, tl.row_tiles, tl.grid, tl.smem,
            float(np.float32(np.sqrt(div_hd or hd))), stream)
    _raise_on(err, "encoder_attention")
    _build.count_launch(LAUNCHES, "encoder_attention")
    return ctx


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

def attention_probs(qkv: torch.Tensor, mask: torch.Tensor,
                    n_heads: int, div_hd=None) -> tuple:
    """(q, k, v as (B, L, H, hd) views, P f[B, H, L, L], the 0-d divisor)
    of the plain version, in qkv's dtype: P = softmax(QK^T / div + neg),
    div = sqrt(div_hd), the head width when None."""
    B, L, D, hd = plain_shapes(qkv, mask, n_heads)
    q, k, v = (t.reshape(B, L, n_heads, hd) for t in qkv.split(D, dim=-1))
    # a 0-d tensor divisor divides (a Python scalar would multiply by the
    # reciprocal on the card); f32(sqrt(hd)) as JAX rounds np.sqrt(hd)
    div = torch.tensor(np.sqrt(div_hd or hd), dtype=qkv.dtype,
                       device=qkv.device)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / div
    zero = torch.zeros((), dtype=qkv.dtype, device=qkv.device)
    neg = torch.where(mask[:, None, None, :] > 0, zero, zero + MASKED)
    return q, k, v, torch.softmax(att + neg, dim=-1), div


def attention_backward_from_probs(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, P: torch.Tensor,
                                  dctx: torch.Tensor,
                                  div: torch.Tensor) -> torch.Tensor:
    """dqkv (B, L, 3D) from the probabilities P, step by step: dV = P^T dO,
    dP = dO V^T, dS = P (dP - rowsum(P dP)), dQ = (dS / div) K,
    dK = (dS / div)^T Q."""
    B, L, H, hd = q.shape
    dout = dctx.reshape(B, L, H, hd)
    dv = torch.einsum("bhqk,bqhd->bkhd", P, dout)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, v)
    ds = P * (dp - (P * dp).sum(dim=-1, keepdim=True))
    ds = ds / div
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.cat([t.reshape(B, L, H * hd) for t in (dq, dk, dv)],
                     dim=-1)


def encoder_attention_backward_plain(qkv: torch.Tensor, mask: torch.Tensor,
                                     dctx: torch.Tensor, n_heads: int,
                                     div_hd=None) -> torch.Tensor:
    """Plain PyTorch version of the gradient: the vjp of the JAX attention
    lines, step by step in qkv's dtype (f64 for the card's check), at any
    head width: P recomputed, then `attention_backward_from_probs`
    (divisor sqrt(div_hd), the head width when None)."""
    B, L, D, _ = plain_shapes(qkv, mask, n_heads)
    if tuple(dctx.shape) != (B, L, D):
        raise ValueError(f"dctx must be ({B}, {L}, {D}), got "
                         f"{tuple(dctx.shape)}")
    q, k, v, P, div = attention_probs(qkv, mask, n_heads, div_hd)
    return attention_backward_from_probs(q, k, v, P, dctx.to(qkv.dtype), div)


def encoder_attention_backward(qkv: torch.Tensor, mask: torch.Tensor,
                               dctx: torch.Tensor,
                               n_heads: int) -> torch.Tensor:
    """dqkv f32[B, L, 3D] of the attention given dctx f32[B, L, D], by
    the forward's route (`route`): on the card the kernels, the kernels
    on zero-padded heads (dctx padded, dqkv sliced), or above 128 the
    wide kernels (at `wide_width`: a width that is not a multiple of 4
    zero-padded to one, as under 128); the plain version on CPU tensors.
    See the module doc."""
    B, L, D, hd = plain_shapes(qkv, mask, n_heads)
    if tuple(dctx.shape) != (B, L, D):
        raise ValueError(f"dctx must be ({B}, {L}, {D}), got "
                         f"{tuple(dctx.shape)}")
    how = route(hd)
    if _device_of((qkv, mask, dctx)).type == "cpu":
        return encoder_attention_backward_plain(qkv, mask, dctx, n_heads)
    if how == "wide":
        w = wide_width(hd)
        if w == hd:
            return launch_backward_wide(qkv, mask, dctx, n_heads)
        dqkv = launch_backward_wide(pad_heads(qkv, n_heads, hd, w), mask,
                                    pad_heads(dctx, n_heads, hd, w), n_heads,
                                    div_hd=hd)
        return unpad_heads(dqkv, n_heads, hd, w)
    if how == "padded":
        w = padded_width(hd)
        dqkv = launch_backward(pad_heads(qkv, n_heads, hd, w), mask,
                               pad_heads(dctx, n_heads, hd, w), n_heads,
                               div_hd=hd)[0]
        return unpad_heads(dqkv, n_heads, hd, w)
    return launch_backward(qkv, mask, dctx, n_heads)[0]


def launch_backward(qkv: torch.Tensor, mask: torch.Tensor,
                    dctx: torch.Tensor, n_heads: int,
                    parts=("dq", "dkv"), dqkv=None, stats=None,
                    div_hd=None) -> tuple:
    """The backward kernels, in stream order, on CUDA tensors of a kernel
    head width: (dqkv, stats); divisor f32(sqrt(div_hd)), the head width
    when None. The main path launches both parts; a bench times one:
    ("dq",) fills dQ and the stats, ("dkv",) takes the `dqkv` and `stats`
    of an earlier dq launch and fills dK and dV."""
    B, L, D, hd = check_shapes(qkv, mask, n_heads)
    dev = _device_of((qkv, mask, dctx))
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {dev}")
    for name, t, dtype in (("qkv", qkv, torch.float32),
                           ("dctx", dctx, torch.float32),
                           ("mask", mask, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qkv.data_ptr() % 16 or dctx.data_ptr() % 16:
        raise ValueError("qkv and dctx must start on a 16-byte boundary")
    if set(parts) - {"dq", "dkv"} or not parts:
        raise ValueError(f"parts {parts} are not of ('dq', 'dkv')")
    if "dq" not in parts and (dqkv is None or stats is None):
        raise ValueError("a dkv launch alone needs the dqkv and stats of a "
                         "dq launch")
    lib = load_backward_kernels()
    if dqkv is None:
        dqkv = torch.empty((B, L, 3 * D), dtype=torch.float32, device=dev)
    if stats is None:
        stats = torch.empty((B * n_heads * L, 4), dtype=torch.float32,
                            device=dev)
    if dqkv.shape != (B, L, 3 * D) or stats.shape != (B * n_heads * L, 4):
        raise ValueError("dqkv or stats of another call")
    div = float(np.float32(np.sqrt(div_hd or hd)))
    tiles = backward_tiles_for(B, n_heads, L, hd)
    dq, dkv = tiles["dq"], tiles["dkv"]
    with torch.cuda.device(dev):
        # read here: autograd runs a backward on its own thread, with the
        # forward's stream set as current
        stream = torch.cuda.current_stream(dev).cuda_stream
        if "dq" in parts:
            err = lib.encoder_attention_backward_dq_launch(
                qkv.data_ptr(), mask.data_ptr(), dctx.data_ptr(),
                dqkv.data_ptr(), stats.data_ptr(), B, L, n_heads, hd,
                dq.warps, dq.pairs, dq.tile, dq.stages, dq.row_tiles,
                dq.grid, dq.smem, div, stream)
            _raise_on(err, "encoder_attention_backward_dq")
            _build.count_launch(LAUNCHES, "encoder_attention_backward_dq")
        if "dkv" in parts:
            err = lib.encoder_attention_backward_dkv_launch(
                qkv.data_ptr(), mask.data_ptr(), dctx.data_ptr(),
                stats.data_ptr(), dqkv.data_ptr(), B, L, n_heads, hd,
                dkv.warps, dkv.pairs, dkv.tile, dkv.stages, dkv.row_tiles,
                dkv.grid, dkv.smem, div, stream)
            _raise_on(err, "encoder_attention_backward_dkv")
            _build.count_launch(LAUNCHES, "encoder_attention_backward_dkv")
    return dqkv, stats


def launch_backward_wide(qkv: torch.Tensor, mask: torch.Tensor,
                         dctx: torch.Tensor, n_heads: int,
                         parts=("dq", "dkv"), dqkv=None, stats=None,
                         div_hd=None) -> torch.Tensor:
    """The wide backward instances (any head width; the wrapper sends
    those above 128), dq then dkv in stream order, on CUDA tensors, tiled
    by `wide_backward_tiles_for`, divisor f32(sqrt(div_hd)) (the head
    width when None): dqkv f32[B, L, 3D], counted as
    `encoder_attention_backward_dq` and `_dkv` (the stats between them are
    the wide kernels' own: each query row's max, sum and delta). The main
    path launches both parts; a bench times one: ("dq",) fills dQ and
    `stats` (allocated when None), ("dkv",) takes the `dqkv` and `stats`
    of an earlier dq launch and fills dK and dV."""
    B, L, D, hd = plain_shapes(qkv, mask, n_heads)
    if tuple(dctx.shape) != (B, L, D):
        raise ValueError(f"dctx must be ({B}, {L}, {D}), got "
                         f"{tuple(dctx.shape)}")
    dev = _check_wide(qkv, mask, dctx)
    if set(parts) - {"dq", "dkv"} or not parts:
        raise ValueError(f"parts {parts} are not of ('dq', 'dkv')")
    if "dq" not in parts and (dqkv is None or stats is None):
        raise ValueError("a dkv launch alone needs the dqkv and stats of a "
                         "dq launch")
    lib = load_backward_kernels()
    if dqkv is None:
        dqkv = torch.empty((B, L, 3 * D), dtype=torch.float32, device=dev)
    if stats is None:
        stats = torch.empty((B * n_heads * L, 4), dtype=torch.float32,
                            device=dev)
    if dqkv.shape != (B, L, 3 * D) or stats.shape != (B * n_heads * L, 4):
        raise ValueError("dqkv or stats of another call")
    tl = wide_backward_tiles_for(B, n_heads, L, hd)
    div = float(np.float32(np.sqrt(div_hd or hd)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if "dq" in parts:
            err = lib.encoder_attention_backward_dq_wide_launch(
                qkv.data_ptr(), mask.data_ptr(), dctx.data_ptr(),
                dqkv.data_ptr(), stats.data_ptr(), B, L, n_heads, hd,
                tl.rows, tl.chunk, tl.row_tiles, tl.grid, tl.smem, div,
                stream)
            _raise_on(err, "encoder_attention_backward_dq")
            _build.count_launch(LAUNCHES, "encoder_attention_backward_dq")
        if "dkv" in parts:
            err = lib.encoder_attention_backward_dkv_wide_launch(
                qkv.data_ptr(), mask.data_ptr(), dctx.data_ptr(),
                stats.data_ptr(), dqkv.data_ptr(), B, L, n_heads, hd,
                tl.rows, tl.chunk, tl.row_tiles, tl.grid, tl.smem, div,
                stream)
            _raise_on(err, "encoder_attention_backward_dkv")
            _build.count_launch(LAUNCHES, "encoder_attention_backward_dkv")
    return dqkv


class EncoderAttention(torch.autograd.Function):
    """The attention with its gradient: `apply(qkv, mask, n_heads)` -> ctx.
    The forward is `encoder_attention`, the backward
    `encoder_attention_backward` (the kernels on CUDA tensors, the plain
    versions on CPU tensors); dqkv comes back in the fused layout, with
    None for the mask and n_heads."""

    @staticmethod
    def forward(ctx, qkv, mask, n_heads):
        out = encoder_attention(qkv, mask, n_heads)
        ctx.save_for_backward(qkv, mask)
        ctx.n_heads = n_heads
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dctx):
        qkv, mask = ctx.saved_tensors
        return (encoder_attention_backward(qkv, mask, dctx.contiguous(),
                                           ctx.n_heads), None, None)
