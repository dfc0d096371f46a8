"""Host ms a batch copying the packed arrays to the device
(`exec.upload`: pageable host-to-device copies, after `exec.drain` has
waited for the device's queued work)."""

from benchmark import spans


def read(ctx):
    return spans.per_batch_ms(ctx, ["exec.upload"])
