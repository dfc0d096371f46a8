"""Host ms a batch enqueueing the device work (`exec.score` and
`exec.tail` on the host clock: the eager launches of scoring and of the
top-k tail, with any wait for room in the launch queue and the
profiler's own cost a launch)."""

from benchmark import spans


def read(ctx):
    return spans.per_batch_ms(ctx, ["exec.score", "exec.tail"])
