"""Device idle share of the traced window: 100 * (1 - busy / window),
busy the union of the device operations' intervals."""


def read(ctx):
    r = ctx.reading
    return 100.0 * (1.0 - r.busy_s / r.window_s)
