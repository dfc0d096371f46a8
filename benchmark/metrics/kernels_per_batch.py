"""Device kernels in the traced window over the batches in it (the
reading's hand-written kernel counts equal their wrappers' LAUNCHES)."""


def read(ctx):
    r = ctx.reading
    return r.n_kernels / r.n_batches
