"""Device ms a batch of dense BM25 scoring: the CUDA events around each
`exec.score` span (every length class and the champion rows)."""

from benchmark import spans


def read(ctx):
    return spans.per_batch_ms(ctx, ["exec.score"], device=True)
