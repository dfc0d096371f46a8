"""The system under test: `oramacore_tpu_torch`, driven as its read side
drives a committed collection under `reader_side.pruned_min_docs`.

This is the only module of the benchmark that imports the program. The
corpus goes in through the write side's public calls
(`StringIndex.index_text_packed`, `VectorIndex.insert`, each index's
`commit()`); a batch goes through
`SharedBatchExecutor.search_topk_shared` with the arguments
`ReadSide.search_batch` passes for an unfiltered batch (no OMC, no
impact cap, n_docs and cap the collection's document count), and the
hybrid tail takes `VectorIndex.flat_device_rows()`.

The collection indexes no adjacency bigrams and matches stemmed terms
(`exact=False`): the traffic sends no phrase boost and no exact match,
and the plain reference models neither.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .corpus import TextCorpus, VectorCorpus, payloads

PROGRAM = "oramacore_tpu_torch"
# entry -> device function(s) as the CUDA sources name them, where the two
# names differ, for wrappers that name no `KERNELS` of their own
DEVICE_FUNCTIONS = {
    "rescore_worklist": "worklist_tail_kernel",
    "encoder_attention": ("encoder_attention_kernel",
                          "encoder_attention_wide_kernel"),
    "encoder_attention_backward_dq": "attention_dq_kernel",
    "encoder_attention_backward_dkv": "attention_dkv_kernel",
}


class System:
    """One collection of the program: its indexes and its batch executor."""

    def __init__(self, cfg: dict, text: TextCorpus,
                 vectors: Optional[VectorCorpus], device):
        from oramacore_tpu_torch.index.search_exec import SharedBatchExecutor
        from oramacore_tpu_torch.index.string_index import StringIndex

        self.field = text.field
        self.n_docs = text.n_docs
        self.stages: Dict[str, float] = {}
        t0 = time.perf_counter()
        self.string = StringIndex(index_bigrams=False)
        put = self.string.index_text_packed
        for d, (n, payload) in enumerate(zip(text.n_tokens.tolist(),
                                             payloads(text))):
            put(d, self.field, n, payload)
        t1 = time.perf_counter()
        self.string.commit()
        t2 = time.perf_counter()
        self.stages.update(index_text_s=t1 - t0, text_commit_s=t2 - t1)
        self.vector = None
        if vectors is not None:
            from oramacore_tpu_torch.index.vector_index import (
                VectorIndex, VectorIndexConfig)

            self.vector = VectorIndex(VectorIndexConfig(dim=vectors.dim),
                                      device)
            ins = self.vector.insert
            for d, row in enumerate(vectors.rows):
                ins(d, [row])
            t3 = time.perf_counter()
            self.vector.commit()
            self.stages.update(vector_insert_s=t3 - t2,
                               vector_commit_s=time.perf_counter() - t3)
        self.executor = SharedBatchExecutor(device)

    def vec_rows(self):
        rows = self.vector.flat_device_rows()
        if rows is None:
            raise RuntimeError("the vector index is not flat: this cell "
                               "measures the flat bf16 tier")
        return rows

    def search(self, tokens: Sequence[Sequence[str]], k: int,
               queries: Optional[np.ndarray] = None,
               similarity: Optional[float] = None):
        """One batch through the executor; (vals f32[B, k], ids i32[B, k],
        counts i32[B]) on the host. Without `queries`, full text only."""
        hybrid = {}
        if queries is not None:
            hybrid = dict(vec_rows=self.vec_rows(), queries=queries,
                          similarities=[similarity] * len(tokens),
                          rescale=None)
        return self.executor.search_topk_shared(
            self.string, tokens, [self.field], {}, float(self.n_docs),
            self.n_docs, k, thresholds=[0.0] * len(tokens),
            exact=False, tolerance=None, impact_cap=None,
            doc_masks=None, field_params=None, omc=None, omc_key=None,
            token_weight_of=None, **hybrid,
        )


def wrapper_modules() -> List:
    """The program's loaded modules that count their kernels' launches
    (a module-level `LAUNCHES` dict): after warm-up, every wrapper that
    the timed path calls."""
    return [mod for name, mod in sorted(list(sys.modules.items()))
            if name.split(".")[0] == PROGRAM and mod is not None
            and isinstance(getattr(mod, "LAUNCHES", None), dict)]


def launch_counts() -> Dict[str, int]:
    return {name: n for mod in wrapper_modules()
            for name, n in mod.LAUNCHES.items()}


def kernel_functions() -> Dict[str, object]:
    """Each counted entry's device function, or a tuple of those of which
    one runs a launch: the wrapper's own `KERNELS` where it names the
    entry, else the table above, else `<entry>_kernel`."""
    out: Dict[str, object] = {}
    for mod in wrapper_modules():
        own = getattr(mod, "KERNELS", None) or {}
        for name in mod.LAUNCHES:
            out[name] = own.get(name) or DEVICE_FUNCTIONS.get(
                name, f"{name}_kernel")
    return out


def set_tf32(on: bool) -> None:
    """The program's lower-precision path: its f32 products in TF32 (the
    program pins them to full f32 when it takes the card)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    torch.set_float32_matmul_precision("high" if on else "highest")
