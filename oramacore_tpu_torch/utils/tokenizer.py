"""Locale-aware tokenization + stemming (the port's copy of
oramacore_tpu/utils/tokenizer.py, with the same output for every locale).

`tokenize_and_stem(text)` returns a list of `(token, [variants])` pairs
where variants are stemmed forms differing from the surface token: exact
search uses only the surface token; non-exact chains token + variants.

English uses a full Porter2 (Snowball) stemmer implemented below. The 14
Snowball locales use the port's copy of NLTK's Snowball stemmers
(`utils/snowball.py`), always: the JAX package stems them with NLTK's
where `nltk` imports, as on the CPU hosts the tests run on, and with its
light stemmers where it does not; the port needs no `nltk`.
`TextParser.stemmer` says which stemmer a parser got. The other locales
with a suffix table use the light stemmer (`light_stem`), the rest none.
CJK locales emit character unigrams + bigrams.

English ASCII texts go to the native tokenizer (`native/tokenizer.cpp`),
whose output is byte-identical; every other text goes to the Python code
here. That split is the reference's own, not a fallback: a native
library that does not build or load raises. `native.ROUTES["tokenizer"]`
counts the texts of each route.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

from ..native import ROUTES, native_tokenize_and_stem, native_tokenize_wire
from ..types import Locale
from .snowball import LANGUAGES as _SNOWBALL_LANGUAGES
from .snowball import SnowballStemmer

_WORD_RE = re.compile(r"[0-9A-Za-zÀ-ɏͰ-ϿЀ-ӿ԰-֏֐-׿؀-ۿऀ-ॿ]+")
_CJK_RE = re.compile(r"[぀-ヿ㐀-䶿一-鿿가-힯]")


# ---------------------------------------------------------------------------
# Porter2 (Snowball English) stemmer
# ---------------------------------------------------------------------------

_VOWELS = frozenset("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDINGS = frozenset("cdeghkmnrt")

_EXCEPTION1 = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes",
}

_EXCEPTION2 = frozenset(
    ("inning", "outing", "canning", "herring", "earring",
     "proceed", "exceed", "succeed")
)

_STEP2_SUFFIXES = [
    ("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
    ("ousness", "ous"), ("iveness", "ive"), ("tional", "tion"),
    ("biliti", "ble"), ("lessli", "less"), ("entli", "ent"),
    ("ation", "ate"), ("alism", "al"), ("aliti", "al"),
    ("ousli", "ous"), ("iviti", "ive"), ("fulli", "ful"),
    ("enci", "ence"), ("anci", "ance"), ("abli", "able"),
    ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
    ("bli", "ble"),
]

_STEP3_SUFFIXES = [
    ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
    ("icate", "ic"), ("iciti", "ic"), ("ical", "ic"),
    ("ful", ""), ("ness", ""),
]

_STEP4_SUFFIXES = (
    "ement", "ance", "ence", "able", "ible", "ment",
    "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
    "al", "er", "ic",
)


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS


def _compute_r1(word: str) -> int:
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            return len(prefix)
    for i in range(1, len(word)):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            return i + 1
    return len(word)


def _compute_r2(word: str, r1: int) -> int:
    for i in range(r1 + 1, len(word)):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            return i + 1
    return len(word)


def _ends_short_syllable(word: str) -> bool:
    n = len(word)
    if n == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if n >= 3:
        # non-vowel, vowel, non-vowel (not w, x, Y)
        c = word[-1]
        return (
            not _is_vowel(word, n - 1)
            and c not in "wxY"
            and _is_vowel(word, n - 2)
            and not _is_vowel(word, n - 3)
        )
    return False


def _is_short(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_short_syllable(word)


def porter2_stem(token: str) -> str:
    """Stem an English token with the Porter2 / Snowball algorithm."""
    word = token.lower()
    if len(word) <= 2:
        return word
    word = word.lstrip("'")
    if word in _EXCEPTION1:
        return _EXCEPTION1[word]
    if len(word) <= 2:
        return word

    # Mark consonant-y as Y
    chars = list(word)
    if chars[0] == "y":
        chars[0] = "Y"
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    word = "".join(chars)

    r1 = _compute_r1(word)
    r2 = _compute_r2(word, r1)

    # Step 0: strip apostrophe suffixes
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break

    # Step 1a
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith("ied") or word.endswith("ies"):
        word = word[:-2] if len(word) <= 4 else word[:-2]
        # replace by i if preceded by more than one letter, else by ie
        if len(word) > 2:
            word = word[:-1]  # 'ie' -> 'i'
        # (len<=2 keeps 'ie': e.g. ties->tie, but 'ties' is len4 → word[:-2]='ti',
        #  then since len('ti')==2 keep 'ie'? handled below)
    elif word.endswith("ss") or word.endswith("us"):
        pass
    elif word.endswith("s"):
        if any(c in _VOWELS for c in word[:-2]):
            word = word[:-1]
    # fix the ied/ies short-word case precisely
    # (redone cleanly): the block above approximates; exact rule:
    #   ied/ies → ie if word (before suffix) is exactly one letter, else i
    # We re-derive from the token to be exact:
    lw = token.lower().lstrip("'")
    if lw.endswith(("ied", "ies")) and lw not in _EXCEPTION1:
        stemmed_base = lw[:-3]
        repl = "ie" if len(stemmed_base) <= 1 else "i"
        chars = list(stemmed_base + repl)
        if chars and chars[0] == "y":
            chars[0] = "Y"
        for i in range(1, len(chars)):
            if chars[i] == "y" and chars[i - 1] in _VOWELS:
                chars[i] = "Y"
        word = "".join(chars)
        r1 = min(_compute_r1(word), len(word))
        r2 = min(_compute_r2(word, r1), len(word))

    if word in _EXCEPTION2:
        return word

    # Step 1b
    if word.endswith("eedly"):
        if len(word) - 5 >= r1:
            word = word[:-3]
    elif word.endswith("eed"):
        if len(word) - 3 >= r1:
            word = word[:-1]
    else:
        for suf in ("ingly", "edly", "ing", "ed"):
            if word.endswith(suf):
                stem = word[: -len(suf)]
                if any(c in _VOWELS for c in stem):
                    word = stem
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                    elif word.endswith(_DOUBLES):
                        word = word[:-1]
                    elif _is_short(word, r1):
                        word += "e"
                break

    # Step 1c: y/Y → i if preceded by non-vowel which is not the first letter
    if len(word) > 2 and word[-1] in "yY" and word[-2] not in _VOWELS:
        word = word[:-1] + "i"

    r1 = min(r1, len(word))
    r2 = min(r2, len(word))

    # Step 2 (in R1)
    for suf, repl in _STEP2_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf == "bli":
                    # 'bli' handled via biliti/abli entries; standalone bli→ble
                    word = word[: -len(suf)] + repl
                else:
                    word = word[: -len(suf)] + repl
            break
    else:
        if word.endswith("ogi"):
            if len(word) - 3 >= r1 and len(word) >= 4 and word[-4] == "l":
                word = word[:-1]
        elif word.endswith("li"):
            if len(word) - 2 >= r1 and len(word) >= 3 and word[-3] in _LI_ENDINGS:
                word = word[:-2]

    # Step 3 (in R1; ative needs R2)
    for suf, repl in _STEP3_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + repl
            break
    else:
        if word.endswith("ative") and len(word) - 5 >= r2:
            word = word[:-5]

    # Step 4 (in R2)
    for suf in _STEP4_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r2:
                word = word[: -len(suf)]
            break
    else:
        if word.endswith("ion") and len(word) - 3 >= r2 and len(word) >= 4 and word[-4] in "st":
            word = word[:-3]

    # Step 5
    if word.endswith("e"):
        if len(word) - 1 >= r2:
            word = word[:-1]
        elif len(word) - 1 >= r1 and not _ends_short_syllable(word[:-1]):
            word = word[:-1]
    elif word.endswith("ll") and len(word) - 1 >= r2:
        word = word[:-1]

    return word.lower()


# ---------------------------------------------------------------------------
# Text parser
# ---------------------------------------------------------------------------

class TextParser:
    """Tokenizer + stemmer bound to one locale.

    English ASCII texts run through the native C++ tokenizer when
    `use_native` (the default); the pure-Python implementation is the
    semantic oracle and the route of every other text.
    """

    # full Snowball stemmers (the port's copy of NLTK's pure-Python
    # implementations, the same algorithm family the reference gets from
    # rust-stemmers). English stays on our Porter2 for parity with the
    # native C++ path.
    _SNOWBALL_LANGS = frozenset(_SNOWBALL_LANGUAGES)

    def __init__(self, locale: Locale = Locale.EN, use_native: bool = True):
        self.locale = locale
        self._is_cjk = locale in (Locale.ZH, Locale.JA, Locale.KO)
        self._snowball = (SnowballStemmer(locale.value)
                          if locale.value in self._SNOWBALL_LANGS else None)
        self._stem_memo: dict = {}
        # which stemmer `stem` applies: porter2, snowball, light or none
        if locale == Locale.EN:
            self.stemmer = "porter2"
        elif self._snowball is not None:
            self.stemmer = "snowball"
        elif locale in _LIGHT_STEMMERS:
            self.stemmer = "light"
        else:
            self.stemmer = "none"
        self._native = None
        if use_native and locale == Locale.EN:
            from ..native import load_tokenizer

            self._native = load_tokenizer()

    def tokenize(self, text: str) -> List[str]:
        if not text:
            return []
        text = unicodedata.normalize("NFKC", text).lower()
        tokens: List[str] = []
        if self._is_cjk or _CJK_RE.search(text):
            # mixed handling: latin words + CJK unigrams/bigrams
            pos = 0
            for m in _CJK_RE.finditer(text):
                pre = text[pos:m.start()]
                tokens.extend(_WORD_RE.findall(pre))
                tokens.append(m.group(0))
                pos = m.end()
            tokens.extend(_WORD_RE.findall(text[pos:]))
            # add CJK bigrams
            cjk_chars = _CJK_RE.findall(text)
            for a, b in zip(cjk_chars, cjk_chars[1:]):
                tokens.append(a + b)
            return tokens
        return _WORD_RE.findall(text)

    def stem(self, token: str) -> str:
        if self.locale == Locale.EN:
            return porter2_stem(token)
        if self._snowball is not None:
            s = self._stem_memo.get(token)
            if s is None:
                s = self._snowball.stem(token)
                if len(self._stem_memo) < 500_000:
                    self._stem_memo[token] = s
            return s
        if self.locale in _LIGHT_STEMMERS:
            return light_stem(token, self.locale)
        return token

    def _route(self, text: str) -> bool:
        """True when `text` goes to the native tokenizer (counted)."""
        native = self._native is not None and text.isascii()
        ROUTES["tokenizer"]["native" if native else "python"] += 1
        return native

    def tokenize_and_stem(self, text: str) -> List[Tuple[str, List[str]]]:
        """Return [(surface_token, [stem_variants])]."""
        if self._route(text):
            return native_tokenize_and_stem(self._native, text)
        return self._tokenize_and_stem_python(text)

    def _tokenize_and_stem_python(
        self, text: str
    ) -> List[Tuple[str, List[str]]]:
        out: List[Tuple[str, List[str]]] = []
        for tok in self.tokenize(text):
            stem = self.stem(tok)
            out.append((tok, [stem] if stem != tok else []))
        return out

    def tokenize_and_stem_packed(self, text: str) -> Tuple[int, str]:
        """(n_surface_tokens, packed op-body payload): the wire format
        the writer ships and the native live accumulator consumes
        (token := surface [\\x01 stem], joined by \\x02). The native
        tokenizer emits it in one pass, with no per-token Python
        objects."""
        if self._route(text):
            return native_tokenize_wire(self._native, text)
        return pack_parsed(self._tokenize_and_stem_python(text))


def pack_parsed(parsed: Sequence[Tuple[str, List[str]]]) -> Tuple[int, str]:
    """(n_surface_tokens, wire payload) for tokenize_and_stem output —
    the pure-Python packer (oracle for the native wire tokenizer)."""
    parts = []
    for tok, variants in parsed:
        parts.append(tok + "\x01" + "\x01".join(variants) if variants
                     else tok)
    return len(parsed), "\x02".join(parts)


class NLPService:
    """Registry of per-locale parsers (reference: oramacore_lib NLPService)."""

    def __init__(self):
        self._parsers: Dict[Locale, TextParser] = {}

    def get_parser(self, locale: Locale) -> TextParser:
        if locale not in self._parsers:
            self._parsers[locale] = TextParser(locale)
        return self._parsers[locale]


# ---------------------------------------------------------------------------
# Light stemmers for major Latin locales (Snowball-"light" style:
# plural/gender/verb-suffix stripping with minimum-stem guards). English
# uses the full Porter2 above; these cover the next most common locales
# so multi-locale collections get stem matching beyond exact tokens.
# ---------------------------------------------------------------------------

def _strip_suffixes(token: str, suffixes, min_stem: int = 3) -> str:
    for suf, repl in suffixes:
        if token.endswith(suf) and len(token) - len(suf) + len(repl) >= min_stem:
            return token[: len(token) - len(suf)] + repl
    return token


_IT_SUFFIXES = [
    ("azione", "a"), ("azioni", "a"), ("amento", "a"), ("amenti", "a"),
    ("imento", "i"), ("imenti", "i"), ("amente", ""), ("mente", ""),
    ("abile", ""), ("ibile", ""), ("ezza", ""), ("ismo", ""), ("ista", ""),
    ("oso", ""), ("osa", ""), ("osi", ""), ("ose", ""),
    ("are", "a"), ("ere", "e"), ("ire", "i"),
    ("iere", "ier"), ("iera", "ier"),
    ("zione", "z"), ("zioni", "z"),
    ("i", ""), ("e", ""), ("a", ""), ("o", ""),
]

_ES_SUFFIXES = [
    ("amiento", "a"), ("imiento", "i"), ("aciones", "a"), ("acion", "a"),
    ("ación", "a"), ("adora", "a"), ("adores", "a"), ("amente", ""),
    ("mente", ""), ("idad", ""), ("idades", ""), ("able", ""), ("ible", ""),
    ("ista", ""), ("ismo", ""), ("oso", ""), ("osa", ""),
    ("ar", "a"), ("er", "e"), ("ir", "i"),
    ("es", ""), ("as", "a"), ("os", "o"),
    ("s", ""), ("a", ""), ("o", ""), ("e", ""),
]

_FR_SUFFIXES = [
    ("issement", "i"), ("issements", "i"), ("atrice", "ateur"),
    ("ation", "a"), ("ations", "a"), ("ement", ""), ("ements", ""),
    ("euse", "eur"), ("euses", "eur"), ("ique", ""), ("iques", ""),
    ("able", ""), ("ables", ""), ("isme", ""), ("iste", ""),
    ("ance", ""), ("ence", ""), ("ment", ""),
    ("eaux", "eau"), ("aux", "al"),
    ("er", "e"), ("ir", "i"),
    ("es", ""), ("s", ""), ("e", ""),
]

_DE_SUFFIXES = [
    ("ungen", ""), ("ung", ""), ("heit", ""), ("heiten", ""),
    ("keit", ""), ("keiten", ""), ("isch", ""), ("lich", ""),
    ("igkeit", ""), ("schaft", ""),
    ("ern", ""), ("em", ""), ("en", ""), ("er", ""), ("es", ""),
    ("e", ""), ("s", ""), ("n", ""),
]

_PT_SUFFIXES = [
    ("amento", "a"), ("imento", "i"), ("adora", "a"), ("adores", "a"),
    ("ação", "a"), ("ações", "a"), ("acao", "a"), ("acoes", "a"),
    ("mente", ""), ("idade", ""), ("ista", ""), ("ismo", ""),
    ("oso", ""), ("osa", ""),
    ("ar", "a"), ("er", "e"), ("ir", "i"),
    ("es", ""), ("as", "a"), ("os", "o"),
    ("s", ""), ("a", ""), ("o", ""), ("e", ""),
]

# -- Germanic / Nordic --------------------------------------------------

_NL_SUFFIXES = [
    ("heden", "heid"), ("ingen", "ing"), ("eringen", "eer"),
    ("aties", "atie"), ("eren", "eer"), ("ende", ""), ("etje", ""),
    ("tje", ""), ("pje", ""), ("je", ""),
    ("en", ""), ("es", ""), ("s", ""), ("e", ""),
]

_SV_SUFFIXES = [
    ("heterna", "het"), ("heternas", "het"), ("heten", "het"),
    ("heter", "het"), ("arnas", ""), ("ernas", ""), ("ornas", ""),
    ("arna", ""), ("erna", ""), ("orna", ""), ("ande", ""), ("ende", ""),
    ("aste", ""), ("aren", "ar"), ("are", ""), ("ast", ""),
    ("ade", "a"), ("at", "a"), ("ad", "a"),
    ("en", ""), ("ar", ""), ("er", ""), ("or", ""), ("et", ""),
    ("a", ""), ("e", ""), ("s", ""),
]

_DA_SUFFIXES = [
    ("erendes", "er"), ("erende", "er"), ("hederne", "hed"),
    ("heden", "hed"), ("heder", "hed"), ("ernes", ""), ("endes", ""),
    ("erens", "er"), ("erne", ""), ("ende", ""), ("erer", "er"),
    ("ede", ""), ("ene", ""), ("ere", ""), ("ens", ""), ("ers", ""),
    ("ets", ""), ("en", ""), ("er", ""), ("es", ""), ("et", ""),
    ("e", ""), ("s", ""),
]

_NO_SUFFIXES = [
    ("hetene", "het"), ("hetens", "het"), ("heten", "het"),
    ("heter", "het"), ("endes", ""), ("ande", ""), ("ende", ""),
    ("edes", ""), ("enes", ""), ("erte", "er"), ("ede", ""),
    ("ane", ""), ("ene", ""), ("ens", ""), ("ers", ""), ("ets", ""),
    ("ert", "er"), ("en", ""), ("er", ""), ("es", ""), ("et", ""),
    ("a", ""), ("e", ""), ("s", ""),
]

# -- Uralic / agglutinative ----------------------------------------------

_FI_SUFFIXES = [
    ("issa", ""), ("issä", ""), ("ista", ""), ("istä", ""),
    ("illa", ""), ("illä", ""), ("ilta", ""), ("iltä", ""),
    ("ille", ""), ("iden", ""), ("ien", ""), ("ssa", ""), ("ssä", ""),
    ("sta", ""), ("stä", ""), ("lla", ""), ("llä", ""), ("lta", ""),
    ("ltä", ""), ("lle", ""), ("ksi", ""), ("nsa", ""), ("nsä", ""),
    ("in", ""), ("an", ""), ("än", ""), ("en", ""),
    ("t", ""), ("n", ""), ("a", ""), ("ä", ""),
]

_HU_SUFFIXES = [
    ("okkal", ""), ("ekkel", ""), ("akkal", ""), ("ökkel", ""),
    ("ban", ""), ("ben", ""), ("ból", ""), ("ből", ""), ("nak", ""),
    ("nek", ""), ("val", ""), ("vel", ""), ("tól", ""), ("től", ""),
    ("ról", ""), ("ről", ""), ("hoz", ""), ("hez", ""), ("höz", ""),
    ("nál", ""), ("nél", ""), ("ság", ""), ("ség", ""),
    ("ba", ""), ("be", ""), ("ra", ""), ("re", ""),
    ("ok", ""), ("ek", ""), ("ak", ""), ("ök", ""),
    ("on", ""), ("en", ""), ("ön", ""),
    ("t", ""), ("k", ""), ("i", ""),
]

_ET_SUFFIXES = [
    ("dele", ""), ("dest", ""), ("dega", ""), ("tele", ""), ("test", ""),
    ("tega", ""), ("sse", ""), ("ste", ""), ("sid", ""),
    ("ni", ""), ("na", ""), ("ta", ""), ("ga", ""), ("le", ""),
    ("lt", ""), ("st", ""), ("d", ""), ("t", ""), ("s", ""),
]

_TR_SUFFIXES = [
    ("lerinden", ""), ("larından", ""), ("lerinde", ""), ("larında", ""),
    ("lerine", ""), ("larına", ""), ("lerin", ""), ("ların", ""),
    ("lerde", ""), ("larda", ""), ("lerden", ""), ("lardan", ""),
    ("iniz", ""), ("ınız", ""), ("unuz", ""), ("ünüz", ""),
    ("ler", ""), ("lar", ""), ("nin", ""), ("nın", ""), ("nun", ""),
    ("nün", ""), ("in", ""), ("ın", ""), ("un", ""), ("ün", ""),
    ("im", ""), ("ım", ""), ("um", ""), ("üm", ""),
    ("da", ""), ("de", ""), ("ta", ""), ("te", ""),
    ("dan", ""), ("den", ""), ("tan", ""), ("ten", ""),
    ("si", ""), ("sı", ""), ("su", ""), ("sü", ""),
    ("a", ""), ("e", ""), ("i", ""), ("ı", ""), ("u", ""), ("ü", ""),
]

# -- Slavic / Baltic -----------------------------------------------------

_RU_SUFFIXES = [
    ("иями", ""), ("ями", ""), ("ами", ""), ("иях", ""), ("иям", ""),
    ("ием", ""), ("ost", ""),
    ("ого", ""), ("его", ""), ("ому", ""), ("ему", ""),
    ("ыми", ""), ("ими", ""), ("ами", ""),
    ("ует", "у"), ("уют", "у"),
    ("ать", "а"), ("ять", "я"), ("еть", "е"), ("ить", "и"),
    ("ал", "а"), ("ял", "я"), ("ел", "е"), ("ил", "и"),
    ("ая", ""), ("яя", ""), ("ое", ""), ("ее", ""), ("ую", ""),
    ("юю", ""), ("ый", ""), ("ий", ""), ("ой", ""),
    ("ия", ""), ("ие", ""), ("ии", ""), ("ые", ""),
    ("ах", ""), ("ях", ""), ("ам", ""), ("ям", ""),
    ("ем", ""), ("им", ""), ("ом", ""), ("ев", ""), ("ов", ""),
    ("ей", ""), ("ью", ""),
    ("ы", ""), ("и", ""), ("а", ""), ("я", ""), ("о", ""), ("е", ""),
    ("у", ""), ("ю", ""), ("ь", ""), ("й", ""),
]

_UK_SUFFIXES = [
    ("ами", ""), ("ями", ""), ("ові", ""), ("еві", ""),
    ("ого", ""), ("ому", ""), ("ими", ""),
    ("ати", "а"), ("яти", "я"), ("ити", "и"), ("іти", "і"),
    ("ах", ""), ("ях", ""), ("ам", ""), ("ям", ""), ("ів", ""),
    ("ою", ""), ("ею", ""), ("ій", ""), ("ий", ""),
    ("и", ""), ("і", ""), ("а", ""), ("я", ""), ("о", ""), ("е", ""),
    ("у", ""), ("ю", ""), ("ь", ""), ("й", ""),
]

_BG_SUFFIXES = [
    ("ията", ""), ("ията", ""), ("ите", ""), ("ове", ""), ("ът", ""),
    ("та", ""), ("то", ""), ("те", ""), ("ия", ""), ("ът", ""),
    ("а", ""), ("я", ""), ("о", ""), ("е", ""), ("и", ""),
]

_LT_SUFFIXES = [
    ("iuose", ""), ("uose", ""), ("omis", ""), ("ymas", "y"),
    ("imas", "i"), ("ams", ""), ("ais", ""), ("oms", ""),
    ("as", ""), ("is", ""), ("ys", ""), ("us", ""), ("ai", ""),
    ("ei", ""), ("ui", ""), ("io", ""), ("iu", ""), ("os", ""),
    ("ų", ""), ("ą", ""), ("ę", ""), ("į", ""), ("ū", ""),
    ("o", ""), ("a", ""), ("e", ""), ("i", ""), ("u", ""), ("s", ""),
]

_SR_SUFFIXES = [  # shared Serbian/Slovenian light endings
    ("ovima", ""), ("ijama", ""), ("ima", ""), ("ama", ""),
    ("om", ""), ("em", ""), ("og", ""), ("eg", ""), ("oj", ""),
    ("ih", ""), ("im", ""), ("ju", ""),
    ("a", ""), ("e", ""), ("i", ""), ("o", ""), ("u", ""),
]

# -- Hellenic ------------------------------------------------------------

_EL_SUFFIXES = [
    ("ματος", "μα"), ("ματα", "μα"), ("ουσα", ""), ("ουμε", ""),
    ("ετε", ""), ("ουν", ""), ("εις", ""), ("ει", ""),
    ("ος", ""), ("ης", ""), ("ας", ""), ("ων", ""), ("ου", ""),
    ("οι", ""), ("ες", ""), ("α", ""), ("η", ""), ("ο", ""),
    ("ι", ""), ("ε", ""),
]

# -- Romance (additional) --------------------------------------------------

_RO_SUFFIXES = [
    ("ătoare", "a"), ("atoare", "a"), ("ilor", ""), ("elor", ""),
    ("ului", ""), ("iile", ""), ("uri", ""), ("ile", ""),
    ("ea", ""), ("le", ""), ("ii", ""), ("ul", ""),
    ("ă", ""), ("a", ""), ("e", ""), ("i", ""),
]

# -- Indic / Semitic / Austronesian ---------------------------------------

_HI_SUFFIXES = [
    ("ियों", ""), ("ाओं", ""), ("ियां", ""), ("ों", ""), ("ें", ""),
    ("ता", ""), ("ते", ""), ("ती", ""), ("ना", ""), ("ने", ""),
    ("ी", ""), ("े", ""), ("ा", ""),
]

_AR_SUFFIXES = [
    ("ات", ""), ("ون", ""), ("ين", ""), ("ان", ""), ("ها", ""),
    ("هم", ""), ("كم", ""), ("نا", ""), ("ية", ""),
    ("ه", ""), ("ة", ""), ("ي", ""), ("ا", ""),
]

_ID_SUFFIXES = [
    ("kannya", ""), ("annya", ""), ("kan", ""), ("nya", ""),
    ("lah", ""), ("kah", ""), ("an", ""), ("i", ""),
]

# locales whose stemmer also strips a COMMON PREFIX set (prefix, min stem)
_LIGHT_PREFIXES = {
    Locale.AR: ["ال", "وال", "بال", "كال", "فال"],
    Locale.ID: ["meng", "meny", "mem", "men", "me", "peng", "peny",
                "pem", "pen", "ber", "ter", "di", "ke", "se"],
}

_LIGHT_STEMMERS = {
    Locale.IT: _IT_SUFFIXES,
    Locale.ES: _ES_SUFFIXES,
    Locale.FR: _FR_SUFFIXES,
    Locale.DE: _DE_SUFFIXES,
    Locale.PT: _PT_SUFFIXES,
    Locale.NL: _NL_SUFFIXES,
    Locale.SV: _SV_SUFFIXES,
    Locale.DA: _DA_SUFFIXES,
    Locale.NO: _NO_SUFFIXES,
    Locale.FI: _FI_SUFFIXES,
    Locale.HU: _HU_SUFFIXES,
    Locale.ET: _ET_SUFFIXES,
    Locale.TR: _TR_SUFFIXES,
    Locale.RU: _RU_SUFFIXES,
    Locale.UK: _UK_SUFFIXES,
    Locale.BG: _BG_SUFFIXES,
    Locale.LT: _LT_SUFFIXES,
    Locale.SR: _SR_SUFFIXES,
    Locale.SL: _SR_SUFFIXES,
    Locale.EL: _EL_SUFFIXES,
    Locale.RO: _RO_SUFFIXES,
    Locale.HI: _HI_SUFFIXES,
    Locale.AR: _AR_SUFFIXES,
    Locale.ID: _ID_SUFFIXES,
}


# agglutinative/short-root locales strip deeper (ev, ház, дом, ...)
_MIN_STEM_2 = (Locale.HI, Locale.AR, Locale.EL, Locale.TR, Locale.FI,
               Locale.HU, Locale.ET, Locale.RU, Locale.UK, Locale.BG)


def light_stem(token: str, locale: Locale) -> str:
    suffixes = _LIGHT_STEMMERS.get(locale)
    if suffixes is None or len(token) <= 3:
        return token
    # prefix strip first for prefixing morphologies (Arabic article,
    # Indonesian verb prefixes); both sides keep a min-stem guard
    prefixes = _LIGHT_PREFIXES.get(locale)
    if prefixes:
        for p in prefixes:
            if token.startswith(p) and len(token) - len(p) >= 3:
                token = token[len(p):]
                break
    min_stem = 2 if locale in _MIN_STEM_2 else 3
    # iterate to a fixpoint (max 3 rounds): base and inflected forms
    # converge ("kirjat"->"kirja"->"kirj" == "kirja"->"kirj"); essential
    # for agglutinative suffix chains ("evlerde"->"evler"->"ev")
    for _ in range(3):
        nxt = _strip_suffixes(token, suffixes, min_stem=min_stem)
        if nxt == token:
            break
        token = nxt
    return token
