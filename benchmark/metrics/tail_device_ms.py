"""Device ms a batch of the tail: the CUDA events around `exec.tail`
(threshold and top-k; in a hybrid cell the cosine, fusion and top-k)."""

from benchmark import spans


def read(ctx):
    return spans.per_batch_ms(ctx, ["exec.tail"], device=True)
