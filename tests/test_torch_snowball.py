"""The port's Snowball stemmers (oramacore_tpu_torch/utils/snowball.py)
against NLTK's (`nltk.stem.snowball.SnowballStemmer`) for the 14 languages
both packages' text parsers stem with it (CPU).

Exact equality throughout (stems are strings): on each language's seeded
vocabulary (`benches/stem_vocab.py`, about 2,000 words), on the repo's
tokenizer-test pairs, and on hypothesis strings over the language's
alphabet and its stemmer's suffixes; one reused port instance against a
fresh NLTK instance a word (NLTK's own reused ArabicStemmer keeps a flag
from earlier words, which the port resets: the stem of a word depends on
the word alone); the committed digest table against NLTK's stems; and,
with `nltk` made unimportable, every one of the 14 locales of the port's
`TextParser` still stems with Snowball (where the port used NLTK's
stemmers, it took its light stemmers there).
"""

import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from nltk.stem.snowball import SnowballStemmer as NltkStemmer

import oramacore_tpu_torch.utils.tokenizer as ttok
from oramacore_tpu_torch.benches import stem_vocab as sv
from oramacore_tpu_torch.types import Locale
from oramacore_tpu_torch.utils import snowball

LANGS = list(snowball.LANGUAGES)


def _nltk_stem(language, word):
    """NLTK's stem of `word` by a fresh instance (or the exception)."""
    try:
        return NltkStemmer(language).stem(word)
    except Exception as e:  # noqa: BLE001 - compared with the port's
        return type(e)


def _port_stem(stemmer, word):
    try:
        return stemmer.stem(word)
    except Exception as e:  # noqa: BLE001
        return type(e)


def test_languages_and_factory():
    assert LANGS == sorted(set(NltkStemmer.languages)
                           - {"english", "porter"})
    assert set(LANGS) == ttok.TextParser._SNOWBALL_LANGS
    for lang in LANGS:
        s = snowball.SnowballStemmer(lang)
        assert type(s).__name__ == lang.capitalize() + "Stemmer"
        assert s.stopwords == set()
    for bad in ("english", "porter", "klingon"):
        with pytest.raises(ValueError):
            snowball.SnowballStemmer(bad)


@pytest.mark.parametrize("lang", LANGS)
def test_vocabulary_stems_equal_nltk(lang):
    words = sv.vocabulary(lang)
    assert len(words) >= sv.WORDS and len(set(words)) == len(words)
    port = snowball.SnowballStemmer(lang)
    got = [port.stem(w) for w in words]
    want = [_nltk_stem(lang, w) for w in words]
    bad = [(w, g, x) for w, g, x in zip(words, got, want) if g != x]
    assert not bad, bad[:10]
    # the vocabulary exercises the stemmer: most words lose a suffix
    assert sum(g != w for g, w in zip(got, words)) > 0.7 * len(words)


@pytest.mark.parametrize("lang", LANGS)
def test_tokenizer_test_pairs_equal_nltk(lang):
    port = snowball.SnowballStemmer(lang)
    for w in sv.TEST_WORDS[lang]:
        assert port.stem(w) == NltkStemmer(lang).stem(w), w
    parser = ttok.TextParser(Locale(lang), use_native=False)
    for w in sv.TEST_WORDS[lang]:
        assert parser.stem(w) == NltkStemmer(lang).stem(w), w


@pytest.mark.parametrize("lang", LANGS)
def test_hypothesis_strings_equal_nltk(lang):
    suffixes, prefixes = sv._affixes(lang)
    letters = sv.ALPHABETS[lang]
    words = st.tuples(
        st.lists(st.sampled_from(prefixes or [""]), max_size=1),
        st.text(alphabet=letters, max_size=9),
        st.lists(st.sampled_from(suffixes), max_size=3),
    ).map(lambda t: "".join(t[0]) + t[1] + "".join(t[2]))
    port = snowball.SnowballStemmer(lang)

    @settings(max_examples=300, deadline=None, database=None)
    @given(words | st.text(alphabet=letters + "'-0", max_size=12))
    def run(word):
        assert _port_stem(port, word) == _nltk_stem(lang, word), word

    run()


@pytest.mark.parametrize("lang", LANGS)
def test_reused_instance_equals_fresh_nltk(lang):
    """One port instance over the whole vocabulary, in order and
    reversed, against a fresh NLTK instance a word; NLTK's own reused
    ArabicStemmer differs (the flag the port resets)."""
    words = sv.vocabulary(lang)
    port = snowball.SnowballStemmer(lang)
    want = [_nltk_stem(lang, w) for w in words]
    assert [port.stem(w) for w in words] == want
    assert [port.stem(w) for w in reversed(words)] == want[::-1]
    nltk_reused = NltkStemmer(lang)
    differ = sum(nltk_reused.stem(w) != x for w, x in zip(words, want))
    assert (differ > 0) == (lang == "arabic"), differ


@pytest.mark.parametrize("lang", LANGS)
def test_digest_table_equals_nltk(lang):
    words = sv.vocabulary(lang)
    assert sv.digest(words, [_nltk_stem(lang, w) for w in words]) == \
        sv.DIGESTS[lang]
    assert sv.port_digests()[lang] == sv.DIGESTS[lang]


def test_digest_sees_a_changed_stem():
    words = sv.vocabulary("french")
    stems = [snowball.SnowballStemmer("french").stem(w) for w in words]
    assert sv.digest(words, stems) == sv.DIGESTS["french"]
    stems[7] += "x"
    assert sv.digest(words, stems) != sv.DIGESTS["french"]


def test_parser_stems_with_snowball_without_nltk(monkeypatch):
    """With every `nltk` module unimportable and the parser's Snowball
    cache (where it has one) cleared, the 14 locales still read
    "snowball" and stem the vocabulary as NLTK does."""
    for name in [m for m in sys.modules if m == "nltk" or
                 m.startswith("nltk.")] + ["nltk"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setattr(ttok.TextParser, "_snowball_cache", {},
                        raising=False)
    with pytest.raises(ImportError):
        from nltk.stem.snowball import SnowballStemmer  # noqa: F401
    kinds = {lang: ttok.TextParser(Locale(lang), use_native=False).stemmer
             for lang in LANGS}
    assert kinds == {lang: "snowball" for lang in LANGS}
    for lang in LANGS:
        parser = ttok.TextParser(Locale(lang), use_native=False)
        words = sv.vocabulary(lang)
        assert sv.digest(words, [parser.stem(w) for w in words]) == \
            sv.DIGESTS[lang], lang
        text = " ".join(words)
        stems = [v[0] if v else t for t, v in parser.tokenize_and_stem(text)]
        assert sv.digest(words, stems) == sv.DIGESTS[lang], lang
