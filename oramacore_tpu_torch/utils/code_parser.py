"""Code-aware parsing for TS/TSX/JS sources (the port's copy of
oramacore_tpu/utils/code_parser.py, unchanged; as there, no module of
the package imports it).

Reference: src/code_parser/ — tree-sitter TSX parsing → `CodeToken`s
(Comment / Imported / FunctionDeclaration / GlobalIdentifier / GlobalJsx,
code_parser/mod.rs:44-50) and an oxc-based `tool_parser` extracting tool
parameters from a JS `export default` (tool_parser.rs:1-5).

No tree-sitter/oxc in this image, so this is a REAL hand-rolled lexer +
structural pass rather than a grepping classifier: the lexer tokenizes
strings (incl. template literals with nested ${} expressions), comments,
regex literals (disambiguated from division by the preceding token),
numbers, identifiers and punctuation — so extraction can never misfire
on code-looking text inside strings or comments. The structural pass
walks the token stream to recover imports (default/named/namespace +
source), function declarations (decls, assigned arrows, class methods)
with their parameter lists, classes with extends clauses, JSX elements
with attribute names, top-level identifiers, and comments. Identifier
splitting (camelCase/snake_case/kebab-case) feeds sub-word search.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_KEYWORDS = {
    "import", "export", "default", "from", "function", "class", "extends",
    "const", "let", "var", "async", "await", "return", "if", "else", "for",
    "while", "do", "switch", "case", "new", "typeof", "instanceof", "in",
    "of", "this", "super", "static", "public", "private", "protected",
    "interface", "type", "enum", "implements", "abstract", "yield",
    "try", "catch", "finally", "throw", "delete", "void", "null", "true",
    "false", "undefined", "require",
}

_IDENT_START = re.compile(r"[A-Za-z_$]")
_IDENT_RE = re.compile(r"[A-Za-z_$][\w$]*")
_NUM_RE = re.compile(r"(?:0[xXbBoO][\da-fA-F_]+|\d[\d_]*(?:\.\d+)?(?:[eE][+-]?\d+)?n?)")

_CAMEL_SPLIT_RE = re.compile(r"[A-Z]+(?=[A-Z][a-z])|[A-Z]?[a-z]+|[A-Z]+|\d+")


def split_identifier(ident: str) -> List[str]:
    """fooBarBaz / foo_bar / foo-bar → [foo, bar, baz] (lowercased)."""
    out: List[str] = []
    for chunk in re.split(r"[_\-.]", ident):
        out.extend(m.group(0).lower() for m in _CAMEL_SPLIT_RE.finditer(chunk))
    return [p for p in out if p]


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

@dataclass
class Tok:
    kind: str   # ident | kw | string | template | regex | num | punct | comment
    value: str
    pos: int


# a regex literal can only START where an expression is expected
_REGEX_ALLOWED_AFTER_PUNCT = set("=([{,;:!?&|^+-*%<>~")
_REGEX_ALLOWED_AFTER_KW = {
    "return", "typeof", "instanceof", "in", "of", "new", "case", "do",
    "else", "yield", "await", "delete", "void",
}


class Lexer:
    def __init__(self, src: str):
        self.src = src
        self.i = 0
        self.n = len(src)
        self.out: List[Tok] = []

    def _prev_significant(self) -> Optional[Tok]:
        for t in reversed(self.out):
            if t.kind != "comment":
                return t
        return None

    def _regex_can_start(self) -> bool:
        p = self._prev_significant()
        if p is None:
            return True
        if p.kind == "punct":
            return p.value[-1] in _REGEX_ALLOWED_AFTER_PUNCT
        if p.kind == "kw":
            return p.value in _REGEX_ALLOWED_AFTER_KW
        return False  # after ident/num/string/regex it's a division

    def _scan_string(self, quote: str) -> str:
        i = self.i + 1
        src, n = self.src, self.n
        buf = []
        while i < n:
            c = src[i]
            if c == "\\" and i + 1 < n:
                buf.append(src[i:i + 2])
                i += 2
                continue
            if c == quote:
                i += 1
                break
            if c == "\n" and quote != "`":
                break  # unterminated: stop at EOL
            buf.append(c)
            i += 1
        self.i = i
        return "".join(buf)

    def _scan_template(self) -> str:
        """Template literal; ${...} expressions are sub-lexed in place so
        identifiers inside them are still seen by the structural pass."""
        i = self.i + 1
        src, n = self.src, self.n
        buf = []
        while i < n:
            c = src[i]
            if c == "\\" and i + 1 < n:
                buf.append(src[i:i + 2])
                i += 2
                continue
            if c == "`":
                i += 1
                break
            if c == "$" and i + 1 < n and src[i + 1] == "{":
                depth = 1
                j = i + 2
                while j < n and depth:
                    if src[j] == "{":
                        depth += 1
                    elif src[j] == "}":
                        depth -= 1
                    j += 1
                inner = src[i + 2:j - 1]
                sub = Lexer(inner)
                sub.run()
                self.out.extend(
                    Tok(t.kind, t.value, i + 2 + t.pos) for t in sub.out
                )
                i = j
                continue
            buf.append(c)
            i += 1
        self.i = i
        return "".join(buf)

    def _scan_regex(self) -> str:
        i = self.i + 1
        src, n = self.src, self.n
        in_class = False
        while i < n:
            c = src[i]
            if c == "\\":
                i += 2
                continue
            if c == "[":
                in_class = True
            elif c == "]":
                in_class = False
            elif c == "/" and not in_class:
                i += 1
                while i < n and src[i].isalpha():  # flags
                    i += 1
                break
            elif c == "\n":
                break
            i += 1
        body = src[self.i:i]
        self.i = i
        return body

    def run(self) -> List[Tok]:
        src, n = self.src, self.n
        while self.i < n:
            c = src[self.i]
            start = self.i
            if c in " \t\r\n":
                self.i += 1
                continue
            if c == "/" and self.i + 1 < n:
                nxt = src[self.i + 1]
                if nxt == "/":
                    end = src.find("\n", self.i)
                    end = n if end == -1 else end
                    self.out.append(
                        Tok("comment", src[self.i + 2:end].strip(), start)
                    )
                    self.i = end
                    continue
                if nxt == "*":
                    end = src.find("*/", self.i + 2)
                    end = n if end == -1 else end + 2
                    text = " ".join(
                        src[self.i + 2:end - 2 if end < n else end].split()
                    )
                    self.out.append(Tok("comment", text, start))
                    self.i = end
                    continue
                if self._regex_can_start():
                    self.out.append(Tok("regex", self._scan_regex(), start))
                    continue
            if c in "'\"":
                self.out.append(Tok("string", self._scan_string(c), start))
                continue
            if c == "`":
                self.out.append(Tok("template", self._scan_template(), start))
                continue
            if _IDENT_START.match(c):
                m = _IDENT_RE.match(src, self.i)
                word = m.group(0)
                self.i = m.end()
                self.out.append(
                    Tok("kw" if word in _KEYWORDS else "ident", word, start)
                )
                continue
            m = _NUM_RE.match(src, self.i)
            if m and c.isdigit():
                self.out.append(Tok("num", m.group(0), start))
                self.i = m.end()
                continue
            # multi-char operators kept whole where it matters
            for op in ("=>", "...", "?.", "**", "&&", "||", "??", "==", "!=",
                       "<=", ">=", "</"):
                if src.startswith(op, self.i):
                    self.out.append(Tok("punct", op, start))
                    self.i += len(op)
                    break
            else:
                self.out.append(Tok("punct", c, start))
                self.i += 1
        return self.out


# ---------------------------------------------------------------------------
# Structural pass → CodeTokens (reference CodeToken taxonomy mod.rs:44-50)
# ---------------------------------------------------------------------------

@dataclass
class CodeToken:
    kind: str   # import | function | class | jsx | comment | identifier | param
    value: str
    parts: List[str] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)


def _match_bracket(toks: List[Tok], i: int, open_: str, close: str) -> int:
    """Index just past the matching close bracket; toks[i] must be open."""
    depth = 0
    while i < len(toks):
        v = toks[i].value
        if toks[i].kind == "punct":
            if v == open_:
                depth += 1
            elif v == close:
                depth -= 1
                if depth == 0:
                    return i + 1
        i += 1
    return i


def _param_names(toks: List[Tok], i: int) -> Tuple[List[str], int]:
    """Parse a parenthesized parameter list starting at toks[i] == '('.
    Returns (names, index past ')'). Handles destructuring, defaults
    with nested commas, rest params, and TS type annotations."""
    end = _match_bracket(toks, i, "(", ")")
    names: List[str] = []
    j = i + 1
    depth_curly = depth_square = depth_paren = 0
    expecting = True     # at a position where a parameter name can start
    skipping = False     # inside a default value / type annotation
    while j < end - 1:
        t = toks[j]
        v = t.value
        if t.kind == "punct":
            if v == "{":
                depth_curly += 1
                if depth_curly == 1 and expecting:
                    expecting = True  # destructured: names are inside
            elif v == "}":
                depth_curly -= 1
            elif v == "[":
                depth_square += 1
            elif v == "]":
                depth_square -= 1
            elif v == "(":
                depth_paren += 1
            elif v == ")":
                depth_paren -= 1
            elif v == "," and depth_square == 0 and depth_paren == 0 \
                    and depth_curly <= 1:
                expecting = True
                skipping = False
            elif v in ("=", ":") and depth_paren == 0:
                skipping = True  # default value or type annotation
            elif v == "...":
                pass
        elif t.kind in ("ident", "kw") and expecting and not skipping:
            if depth_paren == 0 and depth_square == 0:
                names.append(v)
                expecting = False
        j += 1
    return names, end


class CodeParser:
    """Extract typed tokens from TS/TSX/JS source (lexer-backed)."""

    def parse(self, source: str) -> List[CodeToken]:
        toks = Lexer(source).run()
        out: List[CodeToken] = []
        n = len(toks)

        def emit(kind, value, **extra):
            out.append(CodeToken(kind, value, split_identifier(value), extra))

        i = 0
        while i < n:
            t = toks[i]
            if t.kind == "comment":
                if t.value:
                    out.append(CodeToken("comment", t.value))
                i += 1
                continue
            if t.kind == "kw" and t.value == "import":
                i = self._parse_import(toks, i, emit)
                continue
            if t.kind == "kw" and t.value == "require":
                if i + 1 < n and toks[i + 1].value == "(" and \
                        i + 2 < n and toks[i + 2].kind == "string":
                    emit("import", toks[i + 2].value)
                    i += 3
                    continue
            if t.kind == "kw" and t.value == "function":
                j = i + 1
                if j < n and toks[j].value == "*":
                    j += 1
                name = None
                if j < n and toks[j].kind == "ident":
                    name = toks[j].value
                    j += 1
                params: List[str] = []
                if j < n and toks[j].value == "(":
                    params, j = _param_names(toks, j)
                if name:
                    emit("function", name, params=params)
                    for p in params:
                        emit("param", p)
                i = j
                continue
            if t.kind == "kw" and t.value == "class":
                if i + 1 < n and toks[i + 1].kind == "ident":
                    extends = None
                    if i + 2 < n and toks[i + 2].value == "extends" and \
                            i + 3 < n and toks[i + 3].kind == "ident":
                        extends = toks[i + 3].value
                    emit("class", toks[i + 1].value, extends=extends)
                i += 2
                continue
            if t.kind == "kw" and t.value in ("const", "let", "var"):
                # const NAME = [async] (params) => / identifier =>
                if i + 1 < n and toks[i + 1].kind == "ident":
                    name = toks[i + 1].value
                    j = i + 2
                    # skip TS annotation up to '='
                    while j < n and toks[j].value != "=" and \
                            toks[j].value not in (";", ","):
                        j += 1
                    if j < n and toks[j].value == "=":
                        k = j + 1
                        if k < n and toks[k].kind == "kw" and \
                                toks[k].value == "async":
                            k += 1
                        if k < n and toks[k].value == "(":
                            params, k2 = _param_names(toks, k)
                            if k2 < n and toks[k2].value == "=>":
                                emit("function", name, params=params)
                                i = k2
                                continue
                        elif k < n and toks[k].kind == "ident" and \
                                k + 1 < n and toks[k + 1].value == "=>":
                            emit("function", name, params=[toks[k].value])
                            i = k + 2
                            continue
                    emit("identifier", name)
                    i = j
                    continue
            # JSX opening / self-closing elements: <Name attr=...>
            if t.kind == "punct" and t.value == "<" and i + 1 < n and \
                    toks[i + 1].kind == "ident" and \
                    toks[i + 1].value[0].isupper():
                name = toks[i + 1].value
                attrs: List[str] = []
                j = i + 2
                while j < n and toks[j].value not in (">", "/"):
                    if toks[j].kind == "ident" and j + 1 < n and \
                            toks[j + 1].value == "=":
                        attrs.append(toks[j].value)
                    j += 1
                emit("jsx", name, attributes=attrs)
                i = j + 1
                continue
            i += 1
        return out

    @staticmethod
    def _parse_import(toks: List[Tok], i: int, emit) -> int:
        """import Default, { a as b, c } from 'mod' | import * as ns ...
        | import 'mod' — emits each local name + the module source."""
        n = len(toks)
        j = i + 1
        if j < n and toks[j].kind == "kw" and toks[j].value == "type":
            j += 1
        names: List[str] = []
        module = None
        while j < n:
            t = toks[j]
            if t.kind == "string":
                module = t.value
                j += 1
                break
            if t.kind == "ident":
                # handle "as": the local binding is what matters
                if t.value == "as":
                    j += 1
                    continue
                prev_as = j >= 1 and toks[j - 1].value == "as"
                nxt_as = j + 1 < n and toks[j + 1].value == "as"
                if prev_as:
                    names[-1] = t.value  # replace imported with local alias
                elif not nxt_as:
                    names.append(t.value)
                else:
                    names.append(t.value)  # replaced when alias arrives
                j += 1
                continue
            if t.kind == "kw" and t.value == "from":
                j += 1
                continue
            if t.kind == "punct" and t.value in ("{", "}", ",", "*", ";"):
                j += 1
                continue
            break
        for nm in names:
            emit("import", nm)
        if module:
            emit("import", module)
        return j

    def tokens_for_indexing(self, source: str) -> List[str]:
        """Flat token stream for the string index."""
        out: List[str] = []
        for tok in self.parse(source):
            if tok.kind == "comment":
                out.extend(w.lower() for w in re.findall(r"[\w$]+", tok.value))
            else:
                out.append(tok.value.lower())
                out.extend(tok.parts)
        return out


# ---------------------------------------------------------------------------
# Tool parameter extraction (reference tool_parser.rs, oxc-based)
# ---------------------------------------------------------------------------

def extract_tool_params(code: str) -> Optional[Dict[str, Any]]:
    """Parameter names of the `export default` function as a minimal JSON
    schema — token-stream based, so nested destructuring defaults,
    commas inside default expressions and TS annotations all parse."""
    toks = Lexer(code).run()
    sig = [t for t in toks if t.kind != "comment"]
    n = len(sig)
    for i in range(n - 1):
        if sig[i].kind == "kw" and sig[i].value == "export" and \
                sig[i + 1].kind == "kw" and sig[i + 1].value == "default":
            j = i + 2
            if j < n and sig[j].kind == "kw" and sig[j].value == "async":
                j += 1
            if j < n and sig[j].kind == "kw" and sig[j].value == "function":
                j += 1
                if j < n and sig[j].kind == "ident":
                    j += 1
                if j < n and sig[j].value == "(":
                    names, _ = _param_names(sig, j)
                    return _schema(names)
                return None
            if j < n and sig[j].value == "(":
                names, k = _param_names(sig, j)
                if k < n and sig[k].value == "=>":
                    return _schema(names)
            if j < n and sig[j].kind == "ident" and j + 1 < n and \
                    sig[j + 1].value == "=>":
                return _schema([sig[j].value])
    return None


def _schema(names: List[str]) -> Dict[str, Any]:
    return {
        "type": "object",
        "properties": {nm: {"type": "string"} for nm in names},
    }
