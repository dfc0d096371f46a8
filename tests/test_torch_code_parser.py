"""The port's code parser (oramacore_tpu_torch/utils/code_parser.py)
against the JAX package's (CPU): the code-parser test bodies of
tests/test_aux_components.py run with the port's names, and the two
modules give equal output (exact: tokens, positions, parameter lists,
schemas are compared as values; an input that raises must raise the same
exception type in both) for `Lexer(...).run()`, `CodeParser().parse`,
`tokens_for_indexing`, `extract_tool_params` and `split_identifier` on
seeded snippets (identifiers, strings, template and regex literals,
comments, JSX, brackets) and on hypothesis text.
"""

import dataclasses
import inspect
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import oramacore_tpu.utils.code_parser as jcp
import oramacore_tpu_torch.utils.code_parser as tcp
from tests import test_aux_components as aux

# the code-parser tests of test_aux_components.py
AUX_TESTS = ["test_code_parser_token_classes", "test_identifier_splitting",
             "test_tool_param_extraction", "test_code_parser_lexer_robustness",
             "test_code_parser_jsx_attributes_and_class_extends",
             "test_tool_params_hard_cases"]


def _port_body(name):
    """The test body of `name` with the port's code-parser names in its
    globals."""
    g = dict(vars(aux))
    g.update(CodeParser=tcp.CodeParser,
             extract_tool_params=tcp.extract_tool_params,
             split_identifier=tcp.split_identifier)
    f = getattr(aux, name)
    return types.FunctionType(f.__code__, g, f.__name__, f.__defaults__,
                              f.__closure__)


@pytest.mark.parametrize("name", AUX_TESTS)
def test_aux_bodies_on_the_port(name):
    body = _port_body(name)
    assert body.__globals__["CodeParser"] is tcp.CodeParser
    assert not inspect.signature(body).parameters
    body()


def _value(x):
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, dataclasses.astuple(x))
    if isinstance(x, list):
        return [_value(v) for v in x]
    return x


def _outputs(mod, src):
    """Every entry point's output on `src` (or the exception's type)."""
    out = {}
    for name, fn in (
            ("lexer", lambda: mod.Lexer(src).run()),
            ("parse", lambda: mod.CodeParser().parse(src)),
            ("index", lambda: mod.CodeParser().tokens_for_indexing(src)),
            ("tool", lambda: mod.extract_tool_params(src)),
            ("split", lambda: mod.split_identifier(src))):
        try:
            out[name] = _value(fn())
        except Exception as e:  # noqa: BLE001 - compared across packages
            out[name] = type(e).__name__
    return out


FRAGMENTS = [
    "import React, { useState as useS } from 'react';",
    "import * as ns from \"@scope/pkg\";", "import def from './x.js';",
    "export default function run({ city, opts = { a: 1, b: [2, 3] } }, n) {",
    "export default async (query: string, limit: number = 10) => 1",
    "export default x => x * 2", "export const f = async ({ a = 1 }, b) => b;",
    "function fooBar_baz(a, [b, c], ...rest) { return a / b / 2; }",
    "class HTTPServer2 extends BaseWidget { static make(x) { return x; } }",
    "const re = /fun\\(ction\\)[/]x/gi;", "const r = a / b / c;",
    "const s = \"function fake() { import x from 'y' }\";",
    "const t = `pre ${ compute(`in ${deep}`) } function no() {}`;",
    "// function commented() {}", "/* block\n function gone() {} */",
    "return <ResultGrid items={items} pageSize={20} onSelect={go} />;",
    "<div className=\"x\"><Inner a={1}>text</Inner></div>",
    "if (a < b && c > d) { x = y ? /re/ : z; }", "let n = 0x1F + 1_000 + 2e-3 + 10n;",
    "}", ")", "]", "{", "(", "[", "'unterminated", "`open ${", "/* open",
    "snake_case_name kebab-case-name camelCaseName HTTPRequest2Go",
]


def seeded_snippets(seed=0, n=300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 7))
        parts = [FRAGMENTS[int(i)] for i in rng.integers(0, len(FRAGMENTS), k)]
        sep = str(rng.choice(["\n", " ", "", ";\n"]))
        out.append(sep.join(parts))
    return out + FRAGMENTS + [aux.TSX]


@pytest.mark.parametrize("chunk", range(4))
def test_seeded_snippets_equal_jax(chunk):
    snippets = seeded_snippets()[chunk::4]
    parsed = 0
    for src in snippets:
        want = _outputs(jcp, src)
        assert _outputs(tcp, src) == want, src
        parsed += isinstance(want["parse"], list) and bool(want["parse"])
    assert parsed > len(snippets) // 2


CODE_CHARS = "abcXYZ_$019 \n\t'\"`/\\*{}()[]<>=,.;:!?+-&|^%~#@"


@settings(max_examples=400, deadline=None, database=None)
@given(st.text(alphabet=CODE_CHARS, max_size=80)
       | st.lists(st.sampled_from(FRAGMENTS), max_size=5).map("".join))
def test_hypothesis_text_equals_jax(src):
    assert _outputs(tcp, src) == _outputs(jcp, src)


def test_chip_smoke_pins_the_jax_outputs():
    """chip_smoke.py's code-parser sources are the aux tests' own, and its
    pinned digest is that of the JAX package's outputs on them (the card's
    machine checks the port against it)."""
    import hashlib

    import chip_smoke

    consts = {c for name in AUX_TESTS
              for c in getattr(aux, name).__code__.co_consts
              if isinstance(c, str)}
    assert chip_smoke.CODE_SOURCES["tsx"] == aux.TSX
    for src in list(chip_smoke.CODE_SOURCES.values())[1:]:
        assert src in consts, src
    assert all(src in consts for src in chip_smoke.TOOL_SOURCES)
    want = chip_smoke.code_parser_outputs(jcp)
    assert chip_smoke.code_parser_outputs(tcp) == want
    assert hashlib.sha256(want.encode("utf-8")).hexdigest() == \
        chip_smoke.CODE_PARSER_DIGEST
    chip_smoke.code_parser_checks()
