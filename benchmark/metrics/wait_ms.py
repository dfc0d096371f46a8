"""Host ms a batch waiting for the device: the drains before the
blocking uploads (`exec.drain`: the device finishes what was queued) and
the download (`exec.download`: the device drains the tail, then the
results are copied to the host)."""

from benchmark import spans


def read(ctx):
    return spans.per_batch_ms(ctx, ["exec.drain", "exec.download"])
