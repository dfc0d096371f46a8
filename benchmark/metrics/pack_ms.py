"""Host ms a batch packing descriptor arrays (`exec.pack`: each length
class's ranges, the champion rows, masks and thresholds)."""

from benchmark import spans


def read(ctx):
    return spans.per_batch_ms(ctx, ["exec.pack"])
