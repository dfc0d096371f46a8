"""Device-busy ms per batch of the hybrid call minus that of the same
batches called full text only, in the same traced run."""


def read(ctx):
    if not ctx.work.get("n_rows"):
        return None
    text = ctx.variant("text_only")
    return ctx.reading.busy_ms_per_batch - text.busy_ms_per_batch
