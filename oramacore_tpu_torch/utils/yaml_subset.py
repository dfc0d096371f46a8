"""A reader of the YAML subset that the server's config files use.

The JAX package reads its config with `yaml.safe_load`; the port does
without `yaml`. `loads` reads:

- block mappings and block sequences, nested by indentation, including
  a sequence at its parent key's own indentation (`key:` then `- a`);
- comments (`#` at the start of a line or after a space, outside quotes);
- plain, single-quoted and double-quoted scalars, resolved as YAML 1.1
  resolves them (`yaml.safe_load`'s rules): null (`~`, `null`, empty),
  bool (`true`, `yes`, `on`, ... in their three spellings), int
  (decimal, `0x`, `0b`, a leading-0 octal, `_` separators), float
  (`1.5`, `1.0e+3`, `.inf`, `.nan`), and str otherwise;
- flow sequences and mappings (`[a, b]`, `{k: v}`) on one line.

Everything else raises `YamlSubsetError` naming the line: anchors and
aliases, tags, document markers and directives (so no multi-document
stream), block scalars (`|`, `>`), complex keys (`?`), merge keys,
timestamps, sexagesimal numbers, multi-line plain or quoted scalars,
flow collections that span lines and characters YAML does not print. Nothing outside the subset is read in
some other way without a word.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple


class YamlSubsetError(ValueError):
    pass


# YAML 1.1 implicit resolvers, as yaml.safe_load applies them to plain
# scalars
_BOOL = {
    **{s: True for s in ("yes", "Yes", "YES", "true", "True", "TRUE",
                         "on", "On", "ON")},
    **{s: False for s in ("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF")},
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_SEXAGESIMAL = re.compile(
    r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(
    r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?$")

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# YAML's white space and line breaks (str.strip and str.splitlines take
# more: a no-break space is part of a plain scalar, a form feed is not
# printable)
_WS = " \t"
_BREAK = re.compile("\r\n|[\r\n\x85\u2028\u2029]")
_NON_PRINTABLE = re.compile("[^\t\n\r\x20-\x7e\x85\xa0-\ud7ff"
                            "\ue000-\ufffd\U00010000-\U0010ffff]")


def _fail(line: int, what: str):
    raise YamlSubsetError(f"line {line}: {what} is outside the YAML subset "
                          f"this reader takes")


def _int(text: str) -> int:
    s = text.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    if s[0] in "+-":
        s = s[1:]
    if s == "0":
        return 0
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s.startswith("0"):
        return sign * int(s, 8)
    return sign * int(s)


def _float(text: str) -> float:
    s = text.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    if s[0] in "+-":
        s = s[1:]
    if s == ".inf":
        return sign * float("inf")
    if s == ".nan":
        return float("nan")
    return sign * float(s)


def plain_scalar(text: str, line: int) -> Any:
    """A plain scalar's value under YAML 1.1's implicit resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text == "<<":
        _fail(line, "a merge key")
    if text[0] in "&*!|>%@`" or text[0] == "?" and text[1:2] in ("", " ",
                                                                 "\t"):
        what = {"&": "an anchor", "*": "an alias", "!": "a tag",
                "|": "a block scalar", ">": "a block scalar",
                "%": "a directive", "?": "a complex key"}.get(
                    text[0], f"a plain scalar starting with {text[0]!r}")
        _fail(line, what)
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _SEXAGESIMAL.match(text):
        _fail(line, "a sexagesimal number")
    if _TIMESTAMP.match(text):
        _fail(line, "a timestamp")
    return text


def _single_quoted(s: str, i: int, line: int) -> Tuple[str, int]:
    """The single-quoted scalar opening at s[i]; (value, index after)."""
    out = []
    j = i + 1
    while True:
        k = s.find("'", j)
        if k < 0:
            _fail(line, "a quoted scalar that spans lines")
        out.append(s[j:k])
        if k + 1 < len(s) and s[k + 1] == "'":
            out.append("'")
            j = k + 2
            continue
        return "".join(out), k + 1


def _double_quoted(s: str, i: int, line: int) -> Tuple[str, int]:
    out = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if c == '"':
            return "".join(out), j + 1
        if c == "\\":
            if j + 1 >= len(s):
                _fail(line, "a quoted scalar that spans lines")
            e = s[j + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[j + 2:j + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+",
                                                        digits):
                    _fail(line, f"the escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                j += 2 + n
                continue
            _fail(line, f"the escape \\{e}")
        out.append(c)
        j += 1
    _fail(line, "a quoted scalar that spans lines")


def _quoted(s: str, i: int, line: int) -> Tuple[str, int]:
    return (_single_quoted if s[i] == "'" else _double_quoted)(s, i, line)


def _strip_comment(text: str, line: int) -> str:
    """`text` without its comment. A quote opens a quoted scalar only
    where a node starts (the line's start, after `- `, `: `, or a flow
    collection's `[`, `{`, `,`), and that scalar is skipped whole; a
    quote inside a plain scalar is one of its characters."""
    i = 0
    n = len(text)
    at_node = True
    depth = 0   # open flow collections
    while i < n:
        c = text[i]
        if c in "'\"" and at_node:
            _, i = _quoted(text, i, line)
            at_node = False
            continue
        if c == "#" and (i == 0 or text[i - 1] in _WS):
            return text[:i].rstrip(_WS)
        nxt = text[i + 1] if i + 1 < n else " "
        if c in _WS:
            pass
        elif c in "[{" and (at_node or depth):
            depth += 1
            at_node = True
        elif c in "]}" and depth:
            depth -= 1
        elif c == "," and depth:
            at_node = True
        elif c == ":" and (nxt in _WS or depth and (
                nxt in ",[]{}" or text[i - 1] in "'\"")):
            at_node = True
        elif c == "-" and at_node and nxt in _WS:
            pass
        else:
            at_node = False
        i += 1
    return text.rstrip(_WS)


class _Flow:
    """A one-line flow collection or scalar: `[a, {b: c}]`."""

    def __init__(self, s: str, line: int):
        self.s = s
        self.i = 0
        self.line = line

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self, in_flow: bool) -> Any:
        self.ws()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in "'\"":
            v, self.i = _quoted(self.s, self.i, self.line)
            return v
        return plain_scalar(self.plain(in_flow), self.line)

    def plain(self, in_flow: bool) -> str:
        start = self.i
        stops = ",[]{}" if in_flow else ""
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in stops:
                break
            if c == ":" and in_flow and (
                    self.i + 1 >= len(self.s) or self.s[self.i + 1] in " ,]}"):
                break
            self.i += 1
        return self.s[start:self.i].strip(_WS)

    def seq(self) -> List[Any]:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.i >= len(self.s):
                _fail(self.line, "a flow collection that spans lines")
            if self.s[self.i] == "]":
                self.i += 1
                return out
            out.append(self.node(True))
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i < len(self.s) and self.s[self.i] != "]":
                _fail(self.line, f"{self.s[self.i]!r} inside a flow sequence")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.i >= len(self.s):
                _fail(self.line, "a flow collection that spans lines")
            if self.s[self.i] == "}":
                self.i += 1
                return out
            key = self.node(True)
            self.ws()
            value = None
            if self.i < len(self.s) and self.s[self.i] == ":":
                self.i += 1
                self.ws()
                if self.i < len(self.s) and self.s[self.i] not in ",}":
                    value = self.node(True)
            if isinstance(key, (list, dict)):
                _fail(self.line, "a collection as a mapping key")
            out[key] = value
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i < len(self.s) and self.s[self.i] != "}":
                _fail(self.line, f"{self.s[self.i]!r} inside a flow mapping")

    def whole(self) -> Any:
        v = self.node(False)
        self.ws()
        if self.i != len(self.s):
            _fail(self.line, f"text after a value ({self.s[self.i:]!r})")
        return v


def _inline_value(text: str, line: int) -> Any:
    """The value written after `key: ` or `- ` on the same line."""
    if text[0] in "[{'\"":
        return _Flow(text, line).whole()
    if re.search(r":(?:[ \t]|$)", text):
        _fail(line, "a mapping inside a plain scalar")
    return plain_scalar(text, line)


def _split_key(text: str, line: int) -> Optional[Tuple[Any, str]]:
    """(key, rest) of a `key: rest` line, or None when the line holds no
    mapping key."""
    if text[0] in "'\"":
        key, j = _quoted(text, 0, line)
        rest = text[j:].lstrip(_WS)
        if not rest.startswith(":"):
            return None
        if len(rest) > 1 and rest[1] not in " \t":
            return None
        return key, rest[1:].strip(_WS)
    if text[0] in "[{":
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    key_text = text[:m.start()].rstrip(_WS)
    return plain_scalar(key_text, line), text[m.end():].strip(_WS)


class _Block:
    def __init__(self, lines: List[Tuple[int, int, str]]):
        self.lines = lines  # (line number, indent, content)

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        no, ind, text = self.lines[i]
        if _is_item(text):
            return self.seq(i, indent)
        if _split_key(text, no) is not None:
            return self.mapping(i, indent)
        if i + 1 < len(self.lines) and self.lines[i + 1][1] >= indent:
            _fail(self.lines[i + 1][0], "a multi-line plain scalar")
        return _inline_value(text, no), i + 1

    def nested(self, i: int, indent: int, no: int) -> Tuple[Any, int]:
        """The value of a `key:` or `-` with nothing after it: the block
        indented below it, a sequence at the key's own indentation, or
        null."""
        if i < len(self.lines):
            nno, nind, ntext = self.lines[i]
            if nind > indent:
                return self.block(i, nind)
        return None, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines):
            no, ind, text = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                _fail(no, "a line indented deeper than its mapping")
            if _is_item(text):
                break
            kv = _split_key(text, no)
            if kv is None:
                _fail(no, f"a line that is not `key: value` ({text!r})")
            key, rest = kv
            i += 1
            if rest:
                value = _inline_value(rest, no)
            elif i < len(self.lines) and self.lines[i][1] == indent \
                    and _is_item(self.lines[i][2]):
                value, i = self.seq(i, indent)   # `key:` then `- a`
            else:
                value, i = self.nested(i, indent, no)
            out[key] = value
        return out, i

    def seq(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines):
            no, ind, text = self.lines[i]
            if ind < indent or not _is_item(text):
                if ind > indent:
                    _fail(no, "a line indented deeper than its sequence")
                break
            if ind > indent:
                _fail(no, "a line indented deeper than its sequence")
            rest = text[1:].lstrip(" ")
            if not rest:
                value, i = self.nested(i + 1, indent, no)
            else:
                # the item's text starts a block at its own column
                col = ind + len(text) - len(rest)
                self.lines[i] = (no, col, rest)
                value, i = self.block(i, col)
            out.append(value)
        return out, i


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def loads(text: str) -> Any:
    """The value of a YAML document of the subset (None when empty)."""
    lines: List[Tuple[int, int, str]] = []
    for no, raw in enumerate(_BREAK.split(text), 1):
        bad = _NON_PRINTABLE.search(raw)
        if bad:
            _fail(no, f"the non-printable character {bad.group()!r}")
        body = raw.lstrip(_WS)
        content = _strip_comment(body, no)
        if not content:
            continue
        if "\t" in raw[:len(raw) - len(body)]:
            _fail(no, "a tab in the indentation")
        indent = len(raw) - len(body)
        if indent == 0 and (content.startswith(("---", "...", "%"))):
            _fail(no, "a document marker or directive")
        lines.append((no, indent, content))
    if not lines:
        return None
    if lines[0][1] != 0:
        _fail(lines[0][0], "an indented first line")
    value, i = _Block(lines).block(0, 0)
    if i != len(lines):
        _fail(lines[i][0], "a line after the document's top-level value")
    return value


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as fh:
        return loads(fh.read())
