"""The vector side of the repo's 10M-doc hybrid configuration
(`benches/hybrid10m_bench.py`, `:50-57` and `:289-388`), built on the
card: one int8 IVF layout of 10,485,760 rows x 768, doc i's vector in
row pos[i].

The corpus is a mixture of 1,024 unit-norm true centers, each row a
center plus N(0, 0.037^2) noise per coordinate, L2-normalized (so a row's
cosine to its center is about 0.7). IVF: 4,096 centroids from 4 Lloyd
steps (bf16 dots, `index/vector_index.py::_lloyd_step`) on a 262,144-row
sample of the same mixture, probe units of window 2,048 rows per
cluster, nprobe 8. Queries come from the same mixture and search with
similarity 0.3 (`:434-437`, `:531-539`).

The rows are made on the card from seeded `torch.Generator`s in
524,288-row chunks (the f32 corpus would be 32 GiB): a first pass assigns
each chunk to its nearest centroid, a second makes the same chunk again,
quantizes it per row (`ops/vector.py::quantize_rows_int8`) and scatters
it into its packed place (7.5 GiB of int8). `jax.random` gives other
numbers from the same seed: the data is the bench's distribution, not
its draws. `VectorIndex._build_ivf` is not used: it needs the f32 matrix
on the host. Tests shrink it by setting the module's constants.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.vector_index import _lloyd_step
from ..ops.vector import _bf16, quantize_rows_int8

D = 768
N_CENTERS = 1024        # true centers of the mixture
SIGMA = 0.037
N_CENTROIDS = 4096      # IVF centroids
WINDOW = 2048
NPROBE = 8
LLOYD_ITERS = 4
SAMPLE = 262144
CHUNK = 524288          # rows made per step on the card
LLOYD_BLOCK = 16384
SIMILARITY = 0.3

_ASSIGN_BLOCK = 65536   # rows per centroid product while assigning


class Int8Layout:
    """A packed int8 IVF layout on the device, with the accessors the
    executors take from `VectorIndex`: `int8_device_rows()` and
    `int8_doc2row(capb)`."""

    def __init__(self, mat, scales, row_doc, unit_cen, unit_starts, pos,
                 window: int, nprobe: int):
        self.mat, self.scales, self.row_doc = mat, scales, row_doc
        self.unit_cen, self.unit_starts = unit_cen, unit_starts
        self.pos = pos              # int64[n_docs] doc -> packed row
        self.window, self.nprobe = window, nprobe
        self._doc2row = None

    def int8_device_rows(self):
        return (self.mat, self.scales, self.row_doc, self.unit_cen,
                self.unit_starts, self.window, self.nprobe)

    def int8_doc2row(self, capb: int) -> torch.Tensor:
        """doc id -> packed row, int32[capb + 1], -1 past the corpus."""
        if self._doc2row is None or self._doc2row.shape[0] != capb + 1:
            d2r = torch.full((capb + 1,), -1, dtype=torch.int32,
                             device=self.mat.device)
            d2r[: self.pos.shape[0]] = self.pos.to(torch.int32)
            self._doc2row = d2r
        return self._doc2row


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def mixture_centers(device):
    """The true centers, unit norm, f32[N_CENTERS, D]."""
    c = torch.randn((N_CENTERS, D), generator=_gen(0, device), device=device)
    return c / torch.linalg.norm(c, dim=1, keepdim=True)


def mixture_rows(centers, n: int, seed: int):
    """n rows of the mixture from generator `seed`, L2-normalized."""
    dev = centers.device
    g = _gen(seed, dev)
    assign = torch.randint(0, centers.shape[0], (n,), generator=g, device=dev)
    rows = centers[assign] + SIGMA * torch.randn(
        (n, centers.shape[1]), generator=g, device=dev)
    return rows / torch.linalg.norm(rows, dim=1, keepdim=True)


def _assign(rows, cen_b16):
    """Nearest centroid of each row by bf16 dot (first maximum, as
    jnp.argmax), in blocks of _ASSIGN_BLOCK rows."""
    out = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    for s in range(0, rows.shape[0], _ASSIGN_BLOCK):
        out[s:s + _ASSIGN_BLOCK] = torch.argmax(
            _bf16(rows[s:s + _ASSIGN_BLOCK]) @ cen_b16.T, dim=1)
    return out


def build_layout(n_docs: int, device) -> Int8Layout:
    """The packed int8 layout of an n_docs-row mixture (one row per doc),
    made chunk by chunk on `device`; see the module doc. Generators: 0
    the centers, 1 the Lloyd sample, 2 its initial centroids, 17 + i
    chunk i."""
    device = torch.device(device)
    centers = mixture_centers(device)
    smp = mixture_rows(centers, SAMPLE, 1)
    init = torch.randperm(SAMPLE, generator=_gen(2, device),
                          device=device)[:N_CENTROIDS]
    cen = smp[init]
    for _ in range(LLOYD_ITERS):
        cen = _lloyd_step(smp, cen, min(LLOYD_BLOCK, SAMPLE))
    del smp
    cen_b16 = _bf16(cen)
    starts = range(0, n_docs, CHUNK)

    def rows_of(ci, s0):
        return mixture_rows(centers, min(CHUNK, n_docs - s0), 17 + ci)

    assignment = torch.empty(n_docs, dtype=torch.int64, device=device)
    for ci, s0 in enumerate(starts):
        assignment[s0:s0 + CHUNK] = _assign(rows_of(ci, s0), cen_b16)
    perm = torch.sort(assignment, stable=True).indices      # packed -> doc
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(n_docs, device=device)         # doc -> packed
    counts = torch.bincount(assignment, minlength=N_CENTROIDS).cpu().numpy()
    del assignment
    mat = torch.empty((n_docs, D), dtype=torch.int8, device=device)
    scales = torch.empty(n_docs, dtype=torch.float32, device=device)
    for ci, s0 in enumerate(starts):
        q8, sc = quantize_rows_int8(rows_of(ci, s0))
        p = pos[s0:s0 + CHUNK]
        mat[p] = q8
        scales[p] = sc
    # probe units: each cluster's rows in windows of WINDOW, sharing the
    # cluster's centroid
    first = np.zeros(N_CENTROIDS + 1, np.int64)
    np.cumsum(counts, out=first[1:])
    per = -(-counts // WINDOW)
    unit_cluster = np.repeat(np.arange(N_CENTROIDS), per)
    within = np.arange(len(unit_cluster)) - np.repeat(np.cumsum(per) - per, per)
    unit_starts = (first[unit_cluster] + within * WINDOW).astype(np.int32)
    return Int8Layout(
        mat, scales, perm.to(torch.int32),
        cen[torch.from_numpy(unit_cluster).to(device)].contiguous(),
        torch.from_numpy(unit_starts).to(device), pos, window=WINDOW,
        nprobe=min(NPROBE, len(unit_starts)))


def query_vectors(n: int, device) -> np.ndarray:
    """n query vectors from the corpus's mixture (generator 3), f32[n, D]
    on the host."""
    centers = mixture_centers(torch.device(device))
    return mixture_rows(centers, n, 3).cpu().numpy()
