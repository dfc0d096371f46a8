"""The port's StringIndex (oramacore_tpu_torch/index/string_index.py)
against the JAX package's, built from the same seeded docs: several
commits (segments), live deletes, a full merge with committed deletes,
adjacency bigrams, a corpus over CHAMPION_MIN and terms over PREFIX_LEN
(both shrunk in both modules). Slab, ranges, champion rows, term matching
and plans must be equal exactly (CPU)."""

import dataclasses

import numpy as np
import pytest

import oramacore_tpu.index.string_index as jsi
import oramacore_tpu_torch.index.string_index as tsi
from oramacore_tpu_torch.index.plan import plan_query

CHAMP_MIN = 256
PREFIX = 96
VOCAB = [f"w{i}" for i in range(150)] + ["walk", "walks", "walked", "talk",
                                         "tall", "wall", "call"]
PROPS = ["title", "body"]
# the write path, step by step: (first doc, last doc + 1, what follows)
STEPS = (
    (0, 400, "commit"),                 # segment 1
    (400, 700, "live deletes, commit"),  # segment 2
    (700, 900, "full merge"),           # commit with committed deletes
    (900, 1100, "commit"),              # a segment after the merge
    (1100, 1200, "live"),               # uncommitted, with a live delete
)
STAGES = {"segments": 2, "merged": 3, "live": 5}


def _parsed(rng, n_lo, n_hi, extra=()):
    words = list(rng.choice(VOCAB, int(rng.integers(n_lo, n_hi)))) + list(extra)
    return [(str(w), ["stem" + w[1:]] if rng.random() < 0.3 else [])
            for w in words]


def build(module, stage, monkeypatch):
    """One index of string_index module `module`, after STEPS[:stage]."""
    monkeypatch.setattr(module, "CHAMPION_MIN", CHAMP_MIN)
    monkeypatch.setattr(module, "PREFIX_LEN", PREFIX)
    rng = np.random.default_rng(0)
    idx = module.StringIndex()
    for lo, hi, then in STEPS[:stage]:
        for d in range(lo, hi):
            heavy = ["heavy"] if d < 700 else []
            idx.index_text(d, "title", _parsed(rng, 1, 5, heavy + ["common"]))
            idx.index_text(d, "body", _parsed(rng, 3, 12))
        if then == "live deletes, commit":
            idx.delete_doc_live(410)
            idx.delete_doc_live(420)
            idx.commit()
        elif then == "full merge":
            idx.commit(deleted={3, 450})
        elif then == "commit":
            idx.commit()
        else:
            idx.delete_doc_live(1150)
    idx.slab_split()
    return idx


class Pair:
    """The JAX index `j`, the port's `t`, and whether their live slabs
    must agree posting for posting (`exact_live`). Both packages index
    through their native live accumulator by default and through their
    Python live layer with ORAMACORE_NATIVE_LIVE=0. The native one
    numbers a path's live terms in its own order, so where one side
    takes it and the other does not, the live part of the slab holds the
    same postings per term in another order."""

    def __init__(self, j, t, exact_live):
        self.j, self.t, self.exact_live = j, t, exact_live

    def ranges(self, idx, ranges, content=False):
        """Ranges as given, or, where the live order may differ (or with
        `content`), as the sorted (doc, tf, exact_tf, flen) postings each
        one holds."""
        if self.exact_live and not content:
            return list(ranges)
        cols = idx.slab()
        return [sorted(zip(*(c[s:s + n].tolist() for c in cols)))
                for s, n in ranges]


@pytest.fixture(params=["native-default", "python-live"])
def live_layer(request, monkeypatch):
    """Both indexes take their native live accumulator (the default; the
    JAX one where it loads), or their Python live layer."""
    if request.param == "python-live":
        monkeypatch.setenv("ORAMACORE_NATIVE_LIVE", "0")
    return request.param


@pytest.fixture(params=sorted(STAGES))
def pair(request, live_layer, monkeypatch):
    stage = STAGES[request.param]
    j, t = build(jsi, stage, monkeypatch), build(tsi, stage, monkeypatch)
    return Pair(j, t, (j._native_live is None) == (t._native_live is None)
                or stage < STAGES["live"])


def _equal_arrays4(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_slab_split_and_ranges_equal(pair):
    j, t = pair.j, pair.t
    jc, jl, jk = j.slab_split()
    tc, tl, tk = t.slab_split()
    _equal_arrays4(jc, tc)
    # the key holds process-unique segment ids: compare its shape
    assert [(p, len(u)) for p, u in jk] == [(p, len(u)) for p, u in tk]
    if pair.exact_live:
        _equal_arrays4(jl, tl)
        _equal_arrays4(j.slab(), t.slab())
    else:
        assert [a.dtype for a in jl] == [a.dtype for a in tl]
        assert sorted(zip(*(a.tolist() for a in jl))) == \
            sorted(zip(*(a.tolist() for a in tl)))
    assert j._slab_ranges == t._slab_ranges
    assert j._slab_live_ranges.keys() == t._slab_live_ranges.keys()
    for key, rs in j._slab_live_ranges.items():
        assert pair.ranges(j, rs) == pair.ranges(t, t._slab_live_ranges[key])
    assert j._slab_prefix_ranges == t._slab_prefix_ranges
    assert j._slab_terms_by_field == t._slab_terms_by_field
    assert j._slab_live_terms == t._slab_live_terms
    assert {p: dataclasses.astuple(s) for p, s in j._stats.items()} == \
        {p: dataclasses.astuple(s) for p, s in t._stats.items()}
    assert j.pending_ops() == t.pending_ops()
    ji, ti = j.info(), t.info()
    if not pair.exact_live:
        # the native accumulator still counts a live term whose only doc
        # was deleted; the Python live layer drops it
        ji.pop("unique_terms"), ti.pop("unique_terms")
    assert ji == ti


def test_segments_equal(pair):
    j, t = pair.j, pair.t
    assert sorted(j._committed) == sorted(t._committed)
    for path, jsegs in j._committed.items():
        tsegs = t._committed[path]
        assert len(jsegs) == len(tsegs)
        for a, b in zip(jsegs, tsegs):
            assert a.terms == b.terms and a.prefix_ranges == b.prefix_ranges
            for name in ("starts", "lens", "doc", "tf", "exact_tf", "flen",
                         "pdoc", "ptf", "petf", "pflen"):
                x, y = getattr(a, name), getattr(b, name)
                assert (x is None) == (y is None), name
                if x is not None:
                    assert x.dtype == y.dtype, name
                    np.testing.assert_array_equal(x, y, err_msg=name)


def test_champions_equal(pair):
    j, t = pair.j, pair.t
    assert j._champ_map == t._champ_map
    assert j._champ_meta == t._champ_meta
    if j._champ_matrix is None:
        assert t._champ_matrix is None
    else:
        assert t._champ_matrix.dtype == j._champ_matrix.dtype
        np.testing.assert_array_equal(t._champ_matrix, j._champ_matrix)


TOKENS = ["w3", "w17", "walk", "wakl", "tal", "heavy", "common", "stem5",
          "nosuchword", "w3" + jsi.BIGRAM_SEP + "w4", "hevy"]


@pytest.mark.parametrize("tolerance", [None, 0, 1, 2])
def test_match_terms_equal(pair, tolerance):
    j, t = pair.j, pair.t
    for path in PROPS:
        for tok in TOKENS:
            assert pair.ranges(t, t._match_terms(path, tok, tolerance)) == \
                pair.ranges(j, j._match_terms(path, tok, tolerance)), (path, tok)
            jd = list(j._match_terms_detail(path, tok, tolerance))
            td = list(t._match_terms_detail(path, tok, tolerance))
            assert [(term, cr) for term, cr, _ in td] == \
                [(term, cr) for term, cr, _ in jd], (path, tok)
            assert [pair.ranges(t, lr) for _, _, lr in td] == \
                [pair.ranges(j, lr) for _, _, lr in jd], (path, tok)
        if tolerance:
            assert t._fuzzy_match(path, "wakl", tolerance) == \
                j._fuzzy_match(path, "wakl", tolerance)


PLAN_CASES = [
    dict(tokens=["w3", "w7"], properties=PROPS, boost={}),
    dict(tokens=["heavy", "w5", "common"], properties=PROPS,
         boost={"title": 2.0}),
    dict(tokens=["wakl", "tal"], properties=PROPS, boost={}, tolerance=1),
    dict(tokens=["w1", "stem4"], properties=["body"], boost={}, tolerance=2),
    dict(tokens=["heavy", "w9"], properties=PROPS, boost={},
         field_params={"title": (1.5, 0.6)}, token_weights=[1.0, 0.5]),
    dict(tokens=["common", "w2"], properties=PROPS, boost={}, impact_cap=40),
    dict(tokens=["w3" + jsi.BIGRAM_SEP + "w4", "nosuchword"],
         properties=PROPS, boost={}),
]


def _postings_per_token(pair, idx, plan):
    """Each token row of a plan as the sorted (posting, weight, b, avg)
    tuples its ranges cover: what a plan scores, whatever the order of
    the live slab (which decides which ranges coalesce)."""
    out = []
    for ti in range(plan.starts.shape[0]):
        rows = []
        for ri in range(plan.starts.shape[1]):
            (posts,) = pair.ranges(idx, [(int(plan.starts[ti, ri]),
                                          int(plan.lens[ti, ri]))],
                                   content=True)
            params = (float(plan.weights[ti, ri]), float(plan.field_b[ti, ri]),
                      float(plan.avg_flen[ti, ri]))
            rows += [(p, params) for p in posts]
        out.append(sorted(rows))
    return out


@pytest.mark.parametrize("use_champions", [False, True])
@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_query_equal(pair, case, use_champions):
    """The port's plan (StringIndex.plan_query and index/plan.py, one
    code path) equals the JAX dense plan, field for field; beside the
    native live layer, the range fields hold the same postings with the
    same parameters per token."""
    j, t = pair.j, pair.t
    kw = dict(PLAN_CASES[case], use_champions=use_champions)
    exp = j.plan_query(with_prefix=False, **kw)
    ranged = ("starts", "lens", "weights", "field_b", "avg_flen",
              "max_range_len")
    for got in (t.plan_query(**kw), plan_query(t, **kw)):
        assert type(got) is tsi.QueryPlan
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(exp)]
        cut = got.starts.shape[1] == tsi.MAX_RANGES
        if not pair.exact_live and cut:
            # which ranges coalesce, and so which survive the cut at
            # MAX_RANGES, follows the live slab's order: the cut plans
            # agree in shape only (the Python live layer agrees exactly)
            assert exp.starts.shape == got.starts.shape
        elif not pair.exact_live:
            assert _postings_per_token(pair, t, got) == \
                _postings_per_token(pair, j, exp)
        for f in dataclasses.fields(exp):
            if f.name in ranged and not pair.exact_live:
                continue
            e, g = getattr(exp, f.name), getattr(got, f.name)
            if isinstance(e, np.ndarray):
                assert isinstance(g, np.ndarray) and g.dtype == e.dtype, f.name
                np.testing.assert_array_equal(g, e, err_msg=f.name)
            else:
                assert g == e, f.name


def test_the_corpus_reaches_every_branch(monkeypatch):
    """The shrunk thresholds give champion rows, prefix blocks, bigram
    terms, several segments and a merged path."""
    t = build(tsi, STAGES["live"], monkeypatch)
    assert ("title", "heavy") in t._champ_map
    assert t._slab_prefix_ranges
    assert any(tsi.BIGRAM_SEP in term for _, term in t._slab_ranges)
    assert max(len(s) for s in t._committed.values()) == 2
    assert t._slab_live_arrays is not None and t.pending_ops() == 2 * 99


def test_range_truncations_count_and_warn(caplog):
    """_coalesce_and_cap cuts at MAX_RANGES after coalescing, counts the
    cut in the exported counter `query_range_truncations_total` and
    warns, as the JAX function does."""
    from oramacore_tpu_torch.metrics import RANGE_TRUNCATIONS

    def count():
        return RANGE_TRUNCATIONS._values.get((), 0.0)

    n = tsi.MAX_RANGES + 10
    ranges = [(10 * i, 5, 1.0, 0.75, 3.0) for i in range(n)]   # not adjacent
    before = count()
    got = tsi._coalesce_and_cap(ranges, "tok")
    assert got == jsi._coalesce_and_cap(ranges, "tok") == ranges[:tsi.MAX_RANGES]
    assert count() == before + 1
    assert "truncated" in caplog.text
    adjacent = [(5 * i, 5, 1.0, 0.75, 3.0) for i in range(n)]   # one run
    assert tsi._coalesce_and_cap(adjacent, "tok") == [(0, 5 * n, 1.0, 0.75, 3.0)]
    assert count() == before + 1
