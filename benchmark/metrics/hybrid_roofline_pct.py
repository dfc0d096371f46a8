"""The hybrid batch's share of its roofline: BM25's bytes and the flat
cosine's bytes and bf16 operations (`roofline.batch_work`), the larger of
the two bounds, over the device-busy time per batch."""

from benchmark import roofline


def read(ctx):
    w = ctx.work
    if not w.get("n_rows"):
        return None
    b, f = roofline.batch_work(w, with_vectors=True)
    t, which = roofline.bound(b, f)
    ctx.note("hybrid_roofline_pct", t, which)
    return roofline.share_pct(t, ctx.reading.busy_s / ctx.reading.n_batches)
