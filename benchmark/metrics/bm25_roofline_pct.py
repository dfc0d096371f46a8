"""Dense BM25's share of its roofline: the least time to read every
posting of each batch's distinct terms once and write its results once
(`roofline.bm25_work`), over the device-busy time per batch. Only where
the batch is BM25 alone (a cell without vectors)."""

from benchmark import roofline


def read(ctx):
    w = ctx.work
    if w.get("n_rows"):
        return None
    b, f = roofline.bm25_work(w["postings"], int(w["batch"]), int(w["k"]))
    t, which = roofline.bound(b, f)
    ctx.note("bm25_roofline_pct", t, which)
    return roofline.share_pct(t, ctx.reading.busy_s / ctx.reading.n_batches)
