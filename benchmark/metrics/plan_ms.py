"""Host ms a batch in the executor's query analysis (`exec.analyze`:
the batch's distinct terms, their posting ranges, champion routing)."""

from benchmark import spans


def read(ctx):
    return spans.per_batch_ms(ctx, ["exec.analyze"])
