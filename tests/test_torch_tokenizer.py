"""The port's text parser (oramacore_tpu_torch/utils/tokenizer.py) against
the JAX package's (CPU): `tokenize_and_stem` and `tokenize_and_stem_packed`
equal exactly for every Locale on seeded text in many scripts and on the
JAX tokenizer tests' cases, once as the environment is (NLTK's Snowball
stemmers where `nltk` imports) and once with Snowball blocked in both
packages, so every Snowball locale takes its light stemmer, as where nltk
is absent.
"""

import numpy as np
import pytest

import oramacore_tpu.utils.tokenizer as jtok
import oramacore_tpu_torch.utils.tokenizer as ttok
from oramacore_tpu.types import Locale as JLocale
from oramacore_tpu_torch.types import Locale

# tests/test_tokenizer.py's Porter2 vectors and per-locale pairs
PORTER2 = ["caresses", "flies", "dies", "mules", "denied", "died", "agreed",
           "owned", "humbled", "sized", "meeting", "stating", "itemization",
           "sensational", "traditional", "reference", "colonizer", "plotted",
           "running", "games", "fantasy", "adventure", "weapons",
           "generously", "dying", "skies", "news", "happy", "happiness",
           "cats", "christopher", "table", "domination"]
LOCALE_WORDS = [
    "huizen huis lopen loop boeken boek", "flickorna flickor husen hus bilarna",
    "husene hus bilerne biler bilene husets huset", "talossa talo kirjat kirja",
    "házban ház könyvek könyv", "majadele maja raamatud raamatu",
    "evlerde ev kitaplar kitap", "книгами книга домов дом красная красный",
    "будинків будинк", "книгите книги градът град",
    "namuose namas knygos knyga", "knjigama knjiga gradovima grad",
    "βιβλία βιβλίο δρόμος δρόμοι", "cărțile cărți orașului oraș",
    "किताबों किताब लड़कियों लड़की", "الكتاب كتاب مدرسات مدرس",
    "makanannya makan membaca baca", "The Foxes are running!", "AI & ChatGPT",
    "你好世界", "красная книга о животных", "синий дом у моря",
]
SCRIPTS = {
    "ascii": ("abcdefghijklmnopqrstuvwxyz", ["", "s", "es", "ed", "ing",
                                             "ation", "ness", "ly", "ful"]),
    "latin": ("abcdeéèêëàâäîïôöùûüçñåæøßõãíóúőű", ["", "en", "er", "es",
                                                   "ación", "ungen", "ées"]),
    "cyrillic": ("абвгдежзийклмнопрстуфхцчшщыьэюяіїє", ["", "ами", "ов",
                                                          "ая", "ого"]),
    "greek": ("αβγδεζηθικλμνξοπρστυφχψω", ["", "ος", "ων", "ματα"]),
    "arabic": ("ابتثجحخدذرزسشصضطظعغفقكلمنهوي", ["", "ات", "ون", "ها"]),
    "devanagari": ("कखगघचछजझटठडढणतथदधनपफबभमयरलवशसह", ["", "ों", "ता",
                                                             "ियों"]),
    "cjk": ("的一是不了人我在有他这中大来上个国和東京北日本語한국어가나다", [""]),
}


def _word(rng, script):
    letters, sufs = SCRIPTS[script]
    n = int(rng.integers(1, 4 if script == "cjk" else 9))
    w = "".join(rng.choice(list(letters), n))
    return w + str(rng.choice(sufs))


def seeded_texts(seed=0, n=60):
    """Texts of each script alone and mixed, with capitals, digits and
    punctuation, plus the JAX tests' words and an over-long word."""
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n):
        scripts = [list(SCRIPTS)[i % len(SCRIPTS)]]
        if i % 3 == 2:
            scripts = list(rng.choice(list(SCRIPTS), 3))
        words = [_word(rng, str(rng.choice(scripts)))
                 for _ in range(int(rng.integers(1, 12)))]
        words = [w.capitalize() if rng.random() < 0.2 else w for w in words]
        sep = str(rng.choice([" ", ", ", "-", "! ", " 42 ", "... "]))
        texts.append(sep.join(words))
    return texts + [" ".join(PORTER2)] + LOCALE_WORDS + [
        "", "   \t\n", "x" * 300, "Rating: 4.5 stars (genres: RPG, "
        "Action-Adventure)", "it's the user's choice... really?",
        "ｆｕｌｌｗｉｄｔｈ ＡＢＣ １２３", "ﬁne ligature café"]


TEXTS = seeded_texts()


@pytest.fixture(params=["as-is", "snowball-blocked"])
def snowball(request, monkeypatch):
    """As the environment is, or with each package's Snowball cache holding
    None for every Snowball locale (as where nltk is absent)."""
    if request.param == "snowball-blocked":
        for mod in (jtok, ttok):
            monkeypatch.setattr(mod.TextParser, "_snowball_cache", {
                lang: None for lang in mod.TextParser._SNOWBALL_LANGS})
    return request.param


@pytest.mark.parametrize("locale", [loc.value for loc in Locale])
def test_parser_matches_jax(locale, snowball):
    jp = jtok.TextParser(JLocale(locale))
    tp = ttok.TextParser(Locale(locale))
    for text in TEXTS:
        assert tp.tokenize(text) == jp.tokenize(text), text
        assert tp.tokenize_and_stem(text) == jp.tokenize_and_stem(text), text
        assert tp.tokenize_and_stem_packed(text) == \
            jp.tokenize_and_stem_packed(text), text
    # the stemmer each package applies, and the attribute that says which
    assert (tp._snowball is None) == (jp._snowball is None)
    if Locale(locale) == Locale.EN:
        expect = "porter2"
    elif jp._snowball is not None:
        expect = "snowball"
    elif JLocale(locale) in jtok._LIGHT_STEMMERS:
        expect = "light"
    else:
        expect = "none"
    assert tp.stemmer == expect
    if snowball == "snowball-blocked":
        assert expect != "snowball"


def test_stemmer_kinds_cover_every_locale():
    """Each locale's stemmer, as chip_smoke.py prints it: Porter2 for
    English, Snowball for the 14 NLTK locales where nltk imports, light
    stemmers for the other suffix-table locales, none for the rest."""
    kinds = {loc: ttok.TextParser(loc, use_native=False).stemmer
             for loc in Locale}
    assert kinds[Locale.EN] == "porter2"
    snow = {loc for loc in Locale if loc.value in ttok.TextParser._SNOWBALL_LANGS}
    assert len(snow) == 14
    assert all(kinds[loc] in ("snowball", "light") for loc in snow)
    assert {loc for loc, k in kinds.items() if k == "light"} >= \
        set(ttok._LIGHT_STEMMERS) - snow
    assert kinds[Locale.ZH] == kinds[Locale.JA] == kinds[Locale.TA] == "none"


def test_pack_parsed_and_nlp_service():
    p = ttok.TextParser(Locale.EN, use_native=False)
    parsed = p.tokenize_and_stem("The Foxes are running!")
    assert parsed == [("the", []), ("foxes", ["fox"]), ("are", []),
                      ("running", ["run"])]
    assert ttok.pack_parsed(parsed) == jtok.pack_parsed(parsed) == (
        4, "the\x02foxes\x01fox\x02are\x02running\x01run")
    assert ttok.pack_parsed([]) == (0, "")
    svc = ttok.NLPService()
    assert svc.get_parser(Locale.RU) is svc.get_parser(Locale.RU)
    assert svc.get_parser(Locale.RU).locale == Locale.RU


@pytest.mark.parametrize("word", PORTER2 + ["'tis", "y", "yes", "ied", "ties",
                                            "inning", "proceedingly", "ugly"])
def test_porter2_matches_jax(word):
    assert ttok.porter2_stem(word) == jtok.porter2_stem(word)


def test_locale_parse_matches_jax():
    for v in [None, "en", "EN ", "english", "pt", "sr", "uk", "klingon", ""]:
        assert Locale.parse(v).value == JLocale.parse(v).value
    assert [loc.value for loc in Locale] == [loc.value for loc in JLocale]
