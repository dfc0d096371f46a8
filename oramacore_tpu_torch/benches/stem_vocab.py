"""Seeded stem vocabularies of the 14 Snowball locales, and the digests of
their stems.

`vocabulary(language)` makes about `WORDS` distinct words a language:
seeded stems over the language's alphabet (vowels and other letters in
turn, as words alternate them), each joined to 0-2 suffixes drawn from
the suffix tuples of that language's stemmer class in
`utils/snowball.py` (Arabic also takes its prefixes and articles), then
the word pairs of the repo's tokenizer tests for the locale. Suffixes
are written as a text has them: lower case, Portuguese's `a~` / `o~` as
`ã` / `õ`, Russian's transliteration back in Cyrillic. Every word is
NFKC-normalized and lower-cased, so `TextParser.tokenize` returns it
whole.

`DIGESTS` holds the SHA-256 of NLTK 3.10.0's stems of each vocabulary
(a fresh `nltk.stem.snowball.SnowballStemmer` a word), as `digest`
computes it; the CPU tests recompute it with NLTK, so it cannot go
stale, and a machine without `nltk` checks the port's stems against it.
"""

from __future__ import annotations

import hashlib
import re
import unicodedata
from typing import Dict, List, Sequence

import numpy as np

from ..utils import snowball

WORDS = 2_000
SEED = 18

ALPHABETS = {
    "arabic": "ءآأؤإئابةتثجحخدذرزسشصضطظعغفقكلمنهوىي",
    "danish": "abcdefghijklmnopqrstuvwxyzæøå",
    "dutch": "abcdefghijklmnopqrstuvwxyzäëïöüáéíóúè",
    "finnish": "abcdefghijklmnopqrstuvwxyzäö",
    "french": "abcdefghijklmnopqrstuvwxyzàâëéèêïîôûùçœÿ",
    "german": "abcdefghijklmnopqrstuvwxyzäöüß",
    "hungarian": "abcdefghijklmnopqrstuvwxyzáéíóöőúüű",
    "italian": "abcdefghijklmnopqrstuvwxyzàèéìíòóùú",
    "norwegian": "abcdefghijklmnopqrstuvwxyzæøå",
    "portuguese": "abcdefghijklmnopqrstuvwxyzáéíóúâêôãõàç",
    "romanian": "abcdefghijklmnopqrstuvwxyzăâîșşțţ",
    "russian": "абвгдеёжзийклмнопрстуфхцчшщъыьэюя",
    "spanish": "abcdefghijklmnopqrstuvwxyzáéíóúüñ",
    "swedish": "abcdefghijklmnopqrstuvwxyzäåö",
}
VOWELS = {
    "arabic": "اويى",
    "russian": "аеёиоуыэюя",
}

# the inflected / base pairs of the repo's tokenizer tests, by language
TEST_WORDS = {
    "arabic": ["الكتاب", "كتاب", "مدرسات", "مدرس"],
    "danish": ["husene", "hus", "bilerne", "biler"],
    "dutch": ["huizen", "huis", "lopen", "loop", "boeken", "boek"],
    "finnish": ["talossa", "talo", "kirjat", "kirja"],
    "french": ["mangeaient", "manger", "nationalité", "national"],
    "german": ["häuser", "häusern"],
    "hungarian": ["házban", "ház", "könyvek", "könyv"],
    "italian": [],
    "norwegian": ["bilene", "bil", "husets", "huset"],
    "portuguese": [],
    "romanian": ["cărțile", "cărți", "orașului", "oraș"],
    "russian": ["книгами", "книга", "домов", "дом", "красная", "красный"],
    "spanish": [],
    "swedish": ["flickorna", "flickor", "husen", "hus", "bilarna", "bil"],
}

# one locale's words as TextParser.tokenize finds them
_WORD_RE = re.compile(r"[0-9A-Za-zÀ-ɏͰ-ϿЀ-ӿ԰-֏֐-׿؀-ۿऀ-ॿ]+")

# SHA-256 of NLTK 3.10.0's stems of vocabulary(language), per `digest`
DIGESTS = {
    "arabic": "86f000841d1776b4df7df34bb1d365f6306362a78924eb96474629eebd4bf8dd",
    "danish": "20133b25bb6dbef10c6d9ba46fd00a6981cae4cdb369c4e00db754d68101b67c",
    "dutch": "6d5b7d8755006f097b920cb7474e8927850ead3f3853a160b8e0eaa6f1419324",
    "finnish": "fceb5fe822b2f6439f1671d3c32dab24781a8fa8788a438a31e98eb6de599e98",
    "french": "19ecaab1118b5ebc6b439b89e48fdc720c5a0954a9f41cfde64bd34d11dd0e09",
    "german": "4d74756a51b19a29ef98337c2aeae94b049d3ed9c934fdc26488fff016fd7d97",
    "hungarian": "df8b5a0070961e4505e1855e77de0c7d44fdcba1f2785e4187bba54df5f31a34",
    "italian": "8ee89ad406dc54d2d9d37816b2c590e5e1b8b5711517ebe4e775246bae0dbbbe",
    "norwegian": "b18eea46866e2a829fb395f2a760c3c64ee05e3e13e0ca90fa00ebb384829a9b",
    "portuguese": "e001afa6ed00cac8337b04027c6136b04115a3cd609aebadc38c7fbb06bad2a6",
    "romanian": "c0258e2962e59816fc0b0d1e44f9b9d09510cc33474d3f860142be7fd891704d",
    "russian": "0987c9710c90d24912659fe838640aed65ecaaa8cc9d0a21f3ae1c245982a26a",
    "spanish": "706a13d156974e2df11a75bfb9c8e8e0d573deada86611c71576a8ed0f26d005",
    "swedish": "b09148aec6bd8539b79cc08d793152245b2e208d68419bdf4af862de7d9825d5",
}


def _affixes(language: str):
    """(suffixes, prefixes) of the language's stemmer class: its tuples
    and strings whose names say suffix (prefix, article), as a text
    writes them."""
    stemmer = snowball.SnowballStemmer(language)
    cls = type(stemmer)
    suffixes, prefixes = set(), set()
    for name in dir(cls):
        value = getattr(cls, name)
        if isinstance(value, str):
            value = (value,)
        if not (isinstance(value, tuple) and value
                and all(isinstance(v, str) for v in value)):
            continue
        key = name.rsplit("__", 1)[-1]
        if "suffix" in key:
            suffixes.update(value)
        elif "prefix" in key or "article" in key:
            prefixes.update(value)
    if language == "russian":
        suffixes = {stemmer._RussianStemmer__roman_to_cyrillic(s)
                    for s in suffixes}
    if language == "portuguese":
        suffixes = {s.replace("a~", "ã").replace("o~", "õ") for s in suffixes}
    return sorted(s.lower() for s in suffixes), sorted(prefixes)


def _normal(word: str) -> str:
    return unicodedata.normalize("NFKC", word).lower()


def vocabulary(language: str, n: int = WORDS, seed: int = SEED) -> List[str]:
    """About `n` distinct words of `language` (see the module doc), then
    its test words; the same list for the same seed."""
    rng = np.random.default_rng([seed, snowball.LANGUAGES.index(language)])
    letters = ALPHABETS[language]
    vowels = VOWELS.get(language) or getattr(
        snowball.SnowballStemmer(language),
        f"_{language.capitalize()}Stemmer__vowels")
    vowels = [c for c in letters if c in vowels]
    others = [c for c in letters if c not in vowels]
    suffixes, prefixes = _affixes(language)
    words: Dict[str, None] = {}
    while len(words) < n:
        size = int(rng.integers(2, 8))
        vowel = rng.random() < 0.5
        stem = []
        for _ in range(size):
            pool = vowels if vowel else others
            stem.append(pool[int(rng.integers(0, len(pool)))])
            vowel = not vowel if rng.random() < 0.8 else vowel
        word = "".join(stem)
        for _ in range(int(rng.choice(3, p=[0.1, 0.7, 0.2]))):
            word += suffixes[int(rng.integers(0, len(suffixes)))]
        if prefixes and rng.random() < 0.4:
            word = prefixes[int(rng.integers(0, len(prefixes)))] + word
        word = _normal(word)
        if _WORD_RE.fullmatch(word):
            words[word] = None
    for word in TEST_WORDS[language]:
        words[_normal(word)] = None
    return list(words)


def digest(words: Sequence[str], stems: Sequence[str]) -> str:
    """SHA-256 of the lines `word<TAB>stem`, joined by newlines."""
    text = "\n".join(f"{w}\t{s}" for w, s in zip(words, stems, strict=True))
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def port_digests() -> Dict[str, str]:
    """Each language's digest of the port's stems (one reused stemmer a
    language)."""
    out = {}
    for language in snowball.LANGUAGES:
        stem = snowball.SnowballStemmer(language).stem
        words = vocabulary(language)
        out[language] = digest(words, [stem(w) for w in words])
    return out

