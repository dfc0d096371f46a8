"""Minimal hurl-script runner: HTTP smoke scripts as data, not code.

The reference ships `.hurl` API test scripts (src/tests/hurl/*.hurl,
disabled in its CI — tests/mod.rs:27). This module implements the subset
of the hurl language those scripts use, so the same style of scripts run
HERE, in CI, against the real server:

  POST {{base_url}}/v1/collections/create
  Authorization: Bearer {{master_key}}
  { "id": "{{collection_id}}" }
  HTTP 201
  [Captures]
  write_key: jsonpath "$.write_api_key"
  [Asserts]
  jsonpath "$.id" == "smoke"

Supported: GET/POST/PUT/DELETE/PATCH, headers, JSON bodies, `{{var}}`
templating, `HTTP <code>` expectations, `[Options]` retry/retry-interval,
`[Captures]` and `[Asserts]` with the `jsonpath` subset the reference
scripts use (`$.a.b[0].c`, `==`, `count ==`, `exists`).

The port's copy of `oramacore_tpu/utils/hurl.py`, with the same names and
behaviour.
"""

from __future__ import annotations

import json
import re
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_METHODS = ("GET", "POST", "PUT", "DELETE", "PATCH")
_SECTIONS = ("[Options]", "[Captures]", "[Asserts]", "[QueryStringParams]")


class HurlError(AssertionError):
    pass


@dataclass
class HurlEntry:
    method: str
    url: str
    headers: List[Tuple[str, str]] = field(default_factory=list)
    body: Optional[str] = None
    expect_status: Optional[int] = None
    captures: List[Tuple[str, str]] = field(default_factory=list)  # name, path
    asserts: List[Tuple[str, str, Any]] = field(default_factory=list)
    retry: int = 0
    retry_interval_s: float = 0.5
    line: int = 0


def jsonpath_get(doc: Any, path: str) -> Any:
    """Evaluate the `$.a.b[0].c` / `$[0]` subset. Missing -> _MISSING."""
    if not path.startswith("$"):
        raise HurlError(f"jsonpath must start with $: {path!r}")
    cur = doc
    i = 1
    n = len(path)
    while i < n:
        if cur is _MISSING:
            return _MISSING
        c = path[i]
        if c == ".":
            m = re.match(r"\.([A-Za-z0-9_-]+)", path[i:])
            if not m:
                raise HurlError(f"bad jsonpath segment at {path[i:]!r}")
            key = m.group(1)
            cur = cur.get(key, _MISSING) if isinstance(cur, dict) else _MISSING
            i += m.end()
        elif c == "[":
            m = re.match(r"\[(-?\d+)\]", path[i:])
            if not m:
                raise HurlError(f"bad jsonpath index at {path[i:]!r}")
            idx = int(m.group(1))
            if isinstance(cur, list) and -len(cur) <= idx < len(cur):
                cur = cur[idx]
            else:
                cur = _MISSING
            i += m.end()
        else:
            raise HurlError(f"bad jsonpath at {path[i:]!r}")
    return cur


class _Missing:
    def __repr__(self):
        return "<missing>"


_MISSING = _Missing()


def _parse_duration(s: str) -> float:
    s = s.strip()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    return float(s)


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    try:
        return json.loads(tok)
    except json.JSONDecodeError:
        return tok  # bare word -> string


_ASSERT_RE = re.compile(
    r'^jsonpath\s+"([^"]+)"\s*(?:(count)\s*)?'
    r'(==|!=|>=|<=|>|<|exists|includes)?\s*(.*)$'
)


def parse_hurl(text: str) -> List[HurlEntry]:
    entries: List[HurlEntry] = []
    cur: Optional[HurlEntry] = None
    section: Optional[str] = None
    in_body = False
    body_lines: List[str] = []
    after_status = False

    def flush_body():
        nonlocal in_body, body_lines
        if cur is not None and body_lines:
            cur.body = "\n".join(body_lines).strip()
        in_body = False
        body_lines = []

    for ln_no, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        stripped = line.strip()
        if not in_body and (not stripped or stripped.startswith("#")):
            continue
        first_word = stripped.split(" ", 1)[0] if stripped else ""
        # new request entry
        if first_word in _METHODS and not in_body:
            flush_body()
            if cur is not None:
                entries.append(cur)
            cur = HurlEntry(
                method=first_word,
                url=stripped.split(" ", 1)[1].strip(),
                line=ln_no,
            )
            section = None
            after_status = False
            continue
        if cur is None:
            raise HurlError(f"line {ln_no}: content before first request")
        # status expectation ends the body
        if re.match(r"^HTTP\s+\d+$", stripped) and (
            in_body is False or _balanced(body_lines)
        ):
            flush_body()
            cur.expect_status = int(stripped.split()[1])
            after_status = True
            section = None
            continue
        if in_body:
            body_lines.append(raw)
            continue
        if stripped in _SECTIONS:
            section = stripped
            continue
        # a JSON body ends any request-side section (e.g. [Options])
        if not after_status and stripped[0] in "{[":
            section = None
            in_body = True
            body_lines = [raw]
            continue
        if section == "[Options]":
            k, _, v = stripped.partition(":")
            k = k.strip()
            if k == "retry":
                cur.retry = int(v.strip())
            elif k == "retry-interval":
                cur.retry_interval_s = _parse_duration(v)
            continue
        if section == "[Captures]":
            name, _, rest = stripped.partition(":")
            m = re.match(r'^jsonpath\s+"([^"]+)"$', rest.strip())
            if not m:
                raise HurlError(f"line {ln_no}: bad capture {stripped!r}")
            cur.captures.append((name.strip(), m.group(1)))
            continue
        if section == "[Asserts]":
            m = _ASSERT_RE.match(stripped)
            if not m:
                raise HurlError(f"line {ln_no}: bad assert {stripped!r}")
            path, count_kw, op, rhs = m.groups()
            op = op or "exists"
            if count_kw:
                op = "count" + op
            cur.asserts.append((path, op, rhs.strip()))
            continue
        if after_status:
            raise HurlError(f"line {ln_no}: unexpected {stripped!r}")
        # header or body start
        if stripped[0] in "{[":
            in_body = True
            body_lines = [raw]
            continue
        if ":" in stripped:
            k, _, v = stripped.partition(":")
            cur.headers.append((k.strip(), v.strip()))
            continue
        raise HurlError(f"line {ln_no}: cannot parse {stripped!r}")
    flush_body()
    if cur is not None:
        entries.append(cur)
    return entries


def _balanced(lines: List[str]) -> bool:
    text = "\n".join(lines)
    depth = 0
    in_str = False
    esc = False
    for ch in text:
        if esc:
            esc = False
            continue
        if ch == "\\":
            esc = True
        elif in_str:
            if ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
        elif ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
    return depth <= 0


def _subst(s: str, variables: Dict[str, Any]) -> str:
    def rep(m):
        name = m.group(1)
        if name not in variables:
            raise HurlError(f"undefined hurl variable {{{{{name}}}}}")
        return str(variables[name])

    return re.sub(r"\{\{([A-Za-z0-9_]+)\}\}", rep, s)


def _check(entry: HurlEntry, status: int, payload: Any,
           variables: Dict[str, Any]) -> Optional[str]:
    """Returns an error string or None; applies captures on success."""
    if entry.expect_status is not None and status != entry.expect_status:
        return (
            f"line {entry.line}: expected HTTP {entry.expect_status}, "
            f"got {status}: {str(payload)[:200]}"
        )
    for path, op, rhs in entry.asserts:
        actual = jsonpath_get(payload, path)
        if op == "exists":
            if actual is _MISSING:
                return f"line {entry.line}: {path} does not exist"
            continue
        if op.startswith("count"):
            if actual is _MISSING or not isinstance(actual, (list, dict, str)):
                return f"line {entry.line}: {path} not countable: {actual!r}"
            actual = len(actual)
            op = op[len("count"):]
        expected = _parse_value(_subst(rhs, variables))
        ok = {
            "==": lambda a, e: a == e,
            "!=": lambda a, e: a != e,
            ">=": lambda a, e: a is not _MISSING and a >= e,
            "<=": lambda a, e: a is not _MISSING and a <= e,
            ">": lambda a, e: a is not _MISSING and a > e,
            "<": lambda a, e: a is not _MISSING and a < e,
            "includes": lambda a, e: a is not _MISSING and e in a,
        }[op](None if actual is _MISSING else actual, expected)
        if not ok:
            return (
                f"line {entry.line}: jsonpath {path} {op} {expected!r} "
                f"failed (actual {actual!r})"
            )
    for name, path in entry.captures:
        v = jsonpath_get(payload, path)
        if v is _MISSING:
            return f"line {entry.line}: capture {name}: {path} missing"
        variables[name] = v
    return None


def run_hurl(
    text: str,
    variables: Optional[Dict[str, Any]] = None,
    timeout_s: float = 10.0,
) -> Dict[str, Any]:
    """Execute a hurl script; raises HurlError on the first failure.
    Returns the final variable map (including captures)."""
    variables = dict(variables or {})
    for entry in parse_hurl(text):
        attempts = entry.retry + 1
        err = None
        for attempt in range(attempts):
            url = _subst(entry.url, variables)
            body = (
                _subst(entry.body, variables).encode()
                if entry.body is not None else None
            )
            headers = {
                _subst(k, variables): _subst(v, variables)
                for k, v in entry.headers
            }
            if body is not None and not any(
                h.lower() == "content-type" for h in headers
            ):
                headers["Content-Type"] = "application/json"
            req = urllib.request.Request(
                url, data=body, headers=headers, method=entry.method
            )
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as r:
                    status = r.status
                    raw = r.read()
            except urllib.error.HTTPError as e:
                status = e.code
                raw = e.read()
            except OSError as e:
                err = f"line {entry.line}: {entry.method} {url}: {e}"
                if attempt + 1 < attempts:
                    time.sleep(entry.retry_interval_s)
                continue
            try:
                payload = json.loads(raw.decode()) if raw else None
            except json.JSONDecodeError:
                payload = raw.decode(errors="replace")
            err = _check(entry, status, payload, variables)
            if err is None:
                break
            if attempt + 1 < attempts:
                time.sleep(entry.retry_interval_s)
        if err is not None:
            raise HurlError(err)
    return variables


def run_hurl_file(path: str, variables: Optional[Dict[str, Any]] = None,
                  timeout_s: float = 10.0) -> Dict[str, Any]:
    with open(path) as fh:
        return run_hurl(fh.read(), variables, timeout_s)
