"""BERT's WordPiece tokenizer over a checkpoint's `vocab.txt`, by hand (the
card's machine has no `transformers`).

It gives the tokens and ids of `transformers.BertTokenizer` with the
settings of the checkpoint's `tokenizer_config.json`, step by step:

1. The special tokens (`[CLS]`, `[SEP]`, `[PAD]`, `[UNK]`, `[MASK]`)
   written in the text stay tokens of their own. With `do_lower_case`,
   the rest is lower-cased one character at a time first (so a final
   sigma lower-cases to `σ`, as there).
2. Each piece between them is cleaned (NUL, U+FFFD and control
   characters dropped, whitespace made a space), CJK code points get
   spaces around them (`tokenize_chinese_chars`), the text is put in NFC
   and split on whitespace.
3. Each word is lower-cased; with `do_lower_case` and `strip_accents`
   not false, accents are stripped (NFD, then category `Mn` dropped);
   then it is split on punctuation (ASCII 33-47, 58-64, 91-96, 123-126
   and Unicode `P*`).
4. Greedy longest-match WordPiece with `##` continuations; a word of more
   than 100 characters, or one that cannot be covered, is `[UNK]`.

`__call__` adds `[CLS] ... [SEP]`, truncates to `max_len` with the two
specials, pads with `[PAD]` to the longest in the batch and returns int64
`input_ids` and `attention_mask`, as `tokenizer(texts, padding=True,
truncation=True, max_length=max_len)` does.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np


def load_vocab(path: str) -> Dict[str, int]:
    """token -> id, one token a line (text mode, so `\\r\\n` ends a line);
    a token listed twice keeps its last id."""
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    return {tok.rstrip("\n"): i for i, tok in enumerate(lines)}


def _whitespace_split(text: str) -> List[str]:
    return text.strip().split()


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _clean(text: str) -> str:
    out = []
    for ch in text:
        if ch == "\0" or ch == "\ufffd" or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    return "".join(out)


def _space_cjk(text: str) -> str:
    return "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)


def _strip_accents(text: str) -> str:
    return "".join(ch for ch in unicodedata.normalize("NFD", text)
                   if unicodedata.category(ch) != "Mn")


def _split_on_punctuation(word: str) -> List[str]:
    out: List[List[str]] = []
    new_word = True
    for ch in word:
        if _is_punctuation(ch):
            out.append([ch])
            new_word = True
        else:
            if new_word:
                out.append([])
            new_word = False
            out[-1].append(ch)
    return ["".join(x) for x in out]


# ASCII text takes a path of str builtins with the same result: controls
# dropped and whitespace made a space by one translate, ASCII punctuation
# split off by one regex; NFC, CJK spacing and accent stripping change no
# ASCII text.
_ASCII_CLEAN = {cp: (None if _is_control(chr(cp)) else " ")
                for cp in range(128)
                if _is_control(chr(cp)) or _is_whitespace(chr(cp))}
_ASCII_PUNCT = "".join(re.escape(chr(cp)) for cp in range(128)
                       if _is_punctuation(chr(cp)))
_ASCII_WORD_PIECES = re.compile(f"[{_ASCII_PUNCT}]|[^{_ASCII_PUNCT}]+")
# words whose WordPiece split is kept (the vocabulary's words repeat)
_CACHE_WORDS = 1_000_000


class WordPieceTokenizer:
    """BERT's tokenizer; see the module doc."""

    def __init__(self, vocab: Dict[str, int], *, do_lower_case: bool = True,
                 tokenize_chinese_chars: bool = True, strip_accents=None,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 mask_token: str = "[MASK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.strip_accents = strip_accents
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word
        self.specials = [cls_token, mask_token, pad_token, sep_token,
                         unk_token]
        for tok in (unk_token, cls_token, sep_token, pad_token):
            if tok not in vocab:
                raise ValueError(f"special token {tok!r} is not in the vocab")
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.unk_id = vocab[unk_token]
        alts = "|".join(re.escape(s) for s in
                        sorted(set(self.specials), key=len, reverse=True))
        self._special_split = re.compile(f"({alts})")
        self._lower_keep_specials = re.compile(f"({alts})|(.+?)")
        self._pieces: Dict[str, List[str]] = {}

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "WordPieceTokenizer":
        """The tokenizer of a checkpoint directory: `vocab.txt`, with the
        settings and special tokens of `tokenizer_config.json` where it
        has them."""
        vocab = load_vocab(os.path.join(model_dir, "vocab.txt"))
        cfg = {}
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
        kw = {k: cfg[k] for k in ("do_lower_case", "tokenize_chinese_chars",
                                  "strip_accents", "unk_token", "cls_token",
                                  "sep_token", "pad_token", "mask_token")
              if k in cfg}
        return cls(vocab, **kw)

    # -- text -> tokens ----------------------------------------------------

    def _basic(self, text: str) -> List[str]:
        if text.isascii():
            words = []
            for word in text.translate(_ASCII_CLEAN).split():
                if word in self.specials:
                    words.append(word)
                else:
                    if self.do_lower_case:
                        word = word.lower()
                    words.extend(_ASCII_WORD_PIECES.findall(word))
            return words
        text = _clean(text)
        if self.tokenize_chinese_chars:
            text = _space_cjk(text)
        text = unicodedata.normalize("NFC", text)
        words = []
        for word in _whitespace_split(text):
            if word not in self.specials:
                if self.do_lower_case:
                    word = word.lower()
                    if self.strip_accents is not False:
                        word = _strip_accents(word)
                elif self.strip_accents:
                    word = _strip_accents(word)
                words.extend(_split_on_punctuation(word))
            else:
                words.append(word)
        return _whitespace_split(" ".join(words))

    def _wordpiece(self, word: str) -> List[str]:
        pieces = self._pieces.get(word)
        if pieces is None:
            pieces = self._split_word(word)
            if len(self._pieces) < _CACHE_WORDS:
                self._pieces[word] = pieces
        return pieces

    def _split_word(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    break
                end -= 1
            else:
                return [self.unk_token]
            pieces.append(sub)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        if self.do_lower_case:
            # str.lower() depends on context only for a capital sigma
            # (final form at a word's end); elsewhere one call is the same
            # as lower-casing character by character
            if "\u03a3" in text or self._special_split.search(text):
                text = self._lower_keep_specials.sub(
                    lambda m: m.group(1) or m.group(2).lower(), text)
            else:
                text = text.lower()
        tokens: List[str] = []
        for piece in self._special_split.split(text):
            if not piece:
                continue
            if piece in self.specials:
                tokens.append(piece)
                continue
            for word in self._basic(piece):
                tokens.extend(self._wordpiece(word))
        return tokens

    def ids(self, text: str) -> List[int]:
        """The ids of `tokenize(text)`, without the specials around them."""
        return [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]

    def __call__(self, texts: Sequence[str],
                 max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask), int64[B, L] with L the longest
        `[CLS] ids [SEP]` of the batch after truncation to `max_len`."""
        if max_len < 3:
            raise ValueError("max_len must leave room for [CLS], [SEP] and "
                             "a token")
        rows = [[self.cls_id] + self.ids(t)[:max_len - 2] + [self.sep_id]
                for t in texts]
        L = max((len(r) for r in rows), default=0)
        ids = np.full((len(rows), L), self.pad_id, np.int64)
        mask = np.zeros((len(rows), L), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask
