"""The port's native host libraries (oramacore_tpu_torch/native/) against
their Python routes and the JAX package's (CPU; g++ builds the
libraries for these tests too):

- the tokenizer: stems and (token, variants) output equal exactly to the
  Python Porter2 route, and the wire payload to `pack_parsed`;
- the hash encoder: bit for bit equal to the JAX package's native
  encoder, within 1e-6 of the Python `hash_encode`, at dims 64, 128 and
  384;
- the live accumulator: slabs of the port's native-live StringIndex equal
  to its Python-live one and to the JAX package's, through index_text,
  index_text_packed, deletes, segment commits and a full merge, with and
  without adjacency bigrams;
- a failed build or load raises, and nothing goes to the Python route.
"""

import dataclasses
import stat

import numpy as np
import pytest

import oramacore_tpu.embeddings as jemb
import oramacore_tpu.index.string_index as jsi
import oramacore_tpu.native as jnative
import oramacore_tpu.utils.tokenizer as jtok
import oramacore_tpu_torch.embeddings as temb
import oramacore_tpu_torch.index.string_index as tsi
import oramacore_tpu_torch.native as tnative
from oramacore_tpu_torch.native import _build
from oramacore_tpu_torch.types import Locale
from oramacore_tpu_torch.utils.tokenizer import TextParser, pack_parsed, porter2_stem
from tests import jax_native_libs

SUFFIXES = ["", "s", "es", "ed", "ing", "ation", "ness", "ly", "ful", "ies",
            "ied", "er", "ment", "ize", "izer", "ational", "ousli", "fulness",
            "eed", "eedly", "ingly", "y", "'s", "able", "ive", "ion", "logy",
            "alli", "bli", "ss", "us"]


@pytest.fixture(scope="module", autouse=True)
def _jax_native_libs():
    """The JAX package's native routes, built once per process
    (see tests/jax_native_libs.py)."""
    jax_native_libs.bind()


def seeded_vocab(seed=0, n_stems=1500):
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    stems = {"".join(rng.choice(letters, int(rng.integers(1, 10))))
             for _ in range(n_stems)}
    return sorted({s + x for s in stems for x in SUFFIXES})


def seeded_ascii_texts(seed=1, n=300):
    rng = np.random.default_rng(seed)
    vocab = seeded_vocab(seed)
    texts = []
    for _ in range(n):
        words = [str(w).upper() if rng.random() < 0.1 else str(w)
                 for w in rng.choice(vocab, int(rng.integers(0, 40)))]
        sep = str(rng.choice([" ", ", ", " - ", "!? ", " 7 ", "'"]))
        texts.append(sep.join(words))
    return texts + [
        "The quick brown fox JUMPS over the lazy dog!",
        "Rating: 4.5 stars (genres: RPG, Action-Adventure)",
        "it's the user's choice... really?", "",
        "   whitespace\t\tand\nnewlines   ", "x" * 500,
        ("w " * 300).strip(), "MIXED Case And DIGITS 123 456seven",
        "a", "!!! ??? ---", "repeated repeated repeated words words"]


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

def test_native_stems_equal_porter2():
    lib = tnative.load_tokenizer()
    vocab = seeded_vocab()
    assert len(vocab) > 30_000
    bad = [(w, porter2_stem(w), tnative.native_stem(lib, w))
           for w in vocab if tnative.native_stem(lib, w) != porter2_stem(w)]
    assert bad == []
    assert all(porter2_stem(w) == jtok.porter2_stem(w) for w in vocab[::7])


def test_native_and_python_routes_agree():
    native = TextParser(Locale.EN)
    python = TextParser(Locale.EN, use_native=False)
    jparser = jtok.TextParser(jtok.Locale.EN)
    tnative.reset_routes()
    texts = seeded_ascii_texts()
    for text in texts:
        want = python.tokenize_and_stem(text)
        assert native.tokenize_and_stem(text) == want, text
        assert native.tokenize_and_stem_packed(text) == pack_parsed(want), text
        assert jparser.tokenize_and_stem_packed(text) == pack_parsed(want)
    assert tnative.ROUTES["tokenizer"] == {"native": 2 * len(texts),
                                           "python": len(texts)}


def test_non_ascii_text_takes_the_python_route():
    p = TextParser(Locale.EN)
    tnative.reset_routes()
    assert p.tokenize_and_stem("café running") == [("café", []),
                                                   ("running", ["run"])]
    assert p.tokenize_and_stem_packed("日本 runs") == pack_parsed(
        TextParser(Locale.EN, use_native=False).tokenize_and_stem("日本 runs"))
    assert p.tokenize_and_stem("plain runs") == [("plain", []),
                                                 ("runs", ["run"])]
    assert tnative.ROUTES["tokenizer"] == {"native": 1, "python": 3}
    # other locales never take the native route
    assert TextParser(Locale.IT)._native is None


# ---------------------------------------------------------------------------
# hash encoder
# ---------------------------------------------------------------------------

HASH_CASES = [
    "The quick brown fox jumps over the lazy dog",
    "action RPG with open world exploration and crafting 2024",
    "a", "", "!!! ??? ---", "repeated repeated repeated words words",
    "x" * 500,                       # one word > 128 bytes: multi-block blake2b
    "y" * 128 + " " + "z" * 129,     # block edges
    ("w " * 300).strip(),            # bigram-heavy
    " ".join(f"t{i % 17} t{i % 5}" for i in range(400)),
    "MIXED Case And DIGITS 123 456seven",
]


@pytest.mark.parametrize("dim", [64, 128, 384])
def test_hash_encoder_matches_jax_native_and_python(dim):
    texts = HASH_CASES + seeded_ascii_texts(seed=dim, n=120)
    got = tnative.native_hash_encode_batch(tnative.load_hash_encoder(),
                                           texts, dim)
    jlib = jnative.load_hash_encoder()
    assert jlib is not None, "the JAX package's native encoder must build"
    np.testing.assert_array_equal(
        got, jnative.native_hash_encode_batch(jlib, texts, dim))
    want = np.stack([temb.hash_encode(t, dim) for t in texts])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        want, np.stack([jemb.hash_encode(t, dim) for t in texts]))


def test_hash_backend_routes_and_counts():
    info = temb.MODELS["builtin-minihash-384"]
    texts = ["plain ascii text", "caffè è buonissimo", "日本語のテキスト",
             "x" * 300, ""]
    tnative.reset_routes()
    got = temb._hash_backend(texts, info)
    assert tnative.ROUTES["hash_encode"] == {"native": 3, "python": 2}
    want = jemb._hash_backend(texts, jemb.MODELS["builtin-minihash-384"])
    for t, g, w in zip(texts, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, temb.hash_encode(t, info.dim), atol=1e-6)
    svc = temb.EmbeddingsService()
    out = svc.calculate_embeddings(texts[:2], temb.Intent.PASSAGE)
    np.testing.assert_array_equal(out[0][0], got[0])


# ---------------------------------------------------------------------------
# live accumulator
# ---------------------------------------------------------------------------

VOCAB = [f"w{i}" for i in range(120)] + ["walk", "walks", "walked", "talk"]


def _docs(seed=3, n=900):
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n):
        fields = {}
        for path, lo, hi in (("title", 1, 5), ("body", 2, 14)):
            words = rng.choice(VOCAB, int(rng.integers(lo, hi)))
            fields[path] = [(str(w), ["s" + str(w)[1:]] if rng.random() < 0.3
                             else []) for w in words]
        out.append(fields)
    return out


DOCS = _docs()
# the write path step by step: (first doc, last doc + 1, what follows)
STEPS = ((0, 300, "commit"), (300, 500, "live deletes, commit"),
         (500, 650, "full merge"), (650, 800, "commit"), (800, 900, "live"))
STAGES = {"segments": 2, "merged": 3, "live": 5}


def build(module, stage, packed, bigrams):
    idx = module.StringIndex(index_bigrams=bigrams)
    for lo, hi, then in STEPS[:stage]:
        for d in range(lo, hi):
            for path, parsed in DOCS[d].items():
                if packed and d % 2:
                    idx.index_text_packed(d, path, *pack_parsed(parsed))
                else:
                    idx.index_text(d, path, parsed)
        if then == "live deletes, commit":
            for d in (310, 320, 480):
                idx.delete_doc_live(d)
            idx.commit()
        elif then == "full merge":
            idx.commit(deleted={3, 350})
        elif then == "commit":
            idx.commit()
        else:
            idx.delete_doc_live(850)
            idx.delete_doc_live(851)
    idx.slab_split()
    return idx


def _rows(idx):
    """The slab's postings as sorted (doc, tf, exact_tf, flen) rows."""
    return sorted(zip(*(a.tolist() for a in idx.slab())))


def _postings(idx, key, rs):
    cols = idx.slab()
    return sorted(p for s, n in rs for p in zip(*(c[s:s + n].tolist()
                                                   for c in cols)))


@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("bigrams", [True, False])
def test_live_accumulator_slabs(stage, packed, bigrams, monkeypatch):
    built = {}
    for live in ("native", "python"):
        monkeypatch.setenv("ORAMACORE_NATIVE_LIVE",
                           "1" if live == "native" else "0")
        for name, mod in (("jax", jsi), ("port", tsi)):
            built[name, live] = build(mod, STAGES[stage], packed, bigrams)
    assert built["port", "native"]._native_live is not None
    assert built["port", "python"]._native_live is None
    assert built["jax", "native"]._native_live is not None
    ref = built["jax", "python"]
    for (name, live), idx in built.items():
        # the committed slab is one layout whatever accumulated it
        for x, y in zip(idx.slab_split()[0], ref.slab_split()[0], strict=True):
            np.testing.assert_array_equal(x, y)
        assert idx._slab_ranges == ref._slab_ranges
        assert idx._slab_prefix_ranges == ref._slab_prefix_ranges
        assert idx._slab_terms_by_field == ref._slab_terms_by_field
        assert {p: dataclasses.astuple(s) for p, s in idx._stats.items()} == \
            {p: dataclasses.astuple(s) for p, s in ref._stats.items()}
        assert idx.pending_ops() == ref.pending_ops()
        # the live part holds the same postings per term; each route
        # numbers its live terms in its own order
        assert _rows(idx) == _rows(ref)
        assert idx._slab_live_ranges.keys() == ref._slab_live_ranges.keys()
        for key, rs in ref._slab_live_ranges.items():
            assert _postings(idx, key, idx._slab_live_ranges[key]) == \
                _postings(ref, key, rs)
    # within one route, the port and the JAX package agree exactly
    for live in ("native", "python"):
        j, t = built["jax", live], built["port", live]
        for x, y in zip(j.slab(), t.slab(), strict=True):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert j._slab_live_ranges == t._slab_live_ranges
        assert j._slab_live_terms == t._slab_live_terms
        assert j.term_count() == t.term_count()
        assert j.info() == t.info()
    if stage != "live":
        assert built["port", "native"].term_count() == \
            built["port", "python"].term_count()


def test_live_route_counts(monkeypatch):
    monkeypatch.setenv("ORAMACORE_NATIVE_LIVE", "1")
    tnative.reset_routes()
    idx = tsi.StringIndex()
    idx.index_text(0, "body", [("a", [])])
    idx.index_text_packed(1, "body", 1, "b")
    monkeypatch.setenv("ORAMACORE_NATIVE_LIVE", "0")
    tsi.StringIndex().index_text_packed(0, "body", 2, "a\x01x\x02b")
    assert tnative.ROUTES["live_accum"] == {"native": 2, "python": 1}


# ---------------------------------------------------------------------------
# a failed build or load raises
# ---------------------------------------------------------------------------

def _script(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture(params=["compiler fails", "no compiler", "library is junk"])
def broken_build(request, tmp_path, monkeypatch):
    if request.param == "compiler fails":
        cxx = _script(tmp_path / "cxx", "echo nope >&2; exit 1\n")
    elif request.param == "no compiler":
        cxx = str(tmp_path / "missing-cxx")
    else:  # writes a file that is no library where -o points
        cxx = _script(tmp_path / "cxx", 'while [ "$1" != -o ]; do shift; '
                      'done\necho junk > "$2"\n')
    monkeypatch.setattr(_build, "CXX", cxx)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("ORAMACORE_NATIVE_LIVE", "1")
    return request.param


def test_failed_build_raises_and_nothing_falls_back(broken_build, monkeypatch):
    err = OSError if broken_build == "library is junk" else RuntimeError
    for load in (tnative.load_tokenizer, tnative.load_hash_encoder,
                 tnative.load_live_accum):
        with pytest.raises(err):
            load()
    tnative.reset_routes()
    with pytest.raises(err):
        TextParser(Locale.EN)
    with pytest.raises(err):
        temb._hash_backend(["ascii text"], temb.MODELS["builtin-minihash-384"])
    with pytest.raises(err):
        temb.EmbeddingsService().calculate_embeddings(["x"], temb.Intent.QUERY)
    with pytest.raises(err):
        tsi.StringIndex()
    assert tnative.ROUTES["tokenizer"] == tnative.ROUTES["hash_encode"] == \
        {"native": 0, "python": 0}
    assert not any(_build._libs)
    # the Python routes are there when asked for, never in place of a
    # failed library
    assert TextParser(Locale.EN, use_native=False).tokenize_and_stem("runs") \
        == [("runs", ["run"])]
    monkeypatch.setenv("ORAMACORE_NATIVE_LIVE", "0")
    assert tsi.StringIndex()._native_live is None


def test_libraries_are_named_by_source_and_flags(tmp_path, monkeypatch):
    tok, he = (_build.SRC_DIR / f"{n}.cpp" for n in ("tokenizer", "hash_encode"))
    a = _build.library_path(tok)
    assert a.parent == _build.BUILD_DIR and a.name.startswith("libtokenizer_")
    monkeypatch.setattr(_build, "CXX_FLAGS", ("-O3", "-shared", "-fPIC"))
    assert _build.library_path(tok) != a
    assert _build.library_path(he) != _build.library_path(tok)
