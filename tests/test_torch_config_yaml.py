"""The port's reader of the YAML subset (`oramacore_tpu_torch.utils.
yaml_subset`) held to `yaml.safe_load`, and the port's `load_config` of a
YAML file held to the JAX package's."""

from __future__ import annotations

import dataclasses
import math
import os

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from oramacore_tpu import config as jax_config
from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch.utils import yaml_subset
from oramacore_tpu_torch.utils.yaml_subset import YamlSubsetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "config.example.yaml")


def test_example_config_reads_as_safe_load():
    with open(EXAMPLE) as fh:
        text = fh.read()
    assert yaml_subset.loads(text) == yaml.safe_load(text)


HAND_WRITTEN = [
    "a: 1\nb: -2\nc: 0x1F\nd: 017\ne: 1_000\nf: 0b101\n",
    "f: 1.5\ng: -.5e+3\nh: .inf\ni: -.Inf\nj: 3.\nk: 1e3\n",
    "t: [yes, No, ON, off, TRUE, false, ~, null, '', \"\"]\n",
    "s1: 'it''s # not a comment'\ns2: \"tab\\there \\u00e9 \\x41\"\n"
    "s3: plain text, colons:inside # and a comment\n",
    "outer:\n  inner:\n    - 1\n    - two\n    -\n      deep: true\n"
    "  list_at_key_indent:\n  - a\n  - b: c\n    d: e\n",
    "- - 1\n  - 2\n- {a: [1, {b: c}], 'd e': f}\n- []\n- {}\n",
    "# only comments\n\n# and blank lines\nk: v   # trailing\n",
    "key with spaces: value\n'quoted key': 1\n\"dq key\": 2\n",
    "empty:\nnested:\n  also_empty:\n",
    "url: https://example.com/a#frag\npattern: \"{collection}\"\n",
    "scalar at top level\n",
    "",
    # YAML's white space is a space or a tab: other spaces stay in a
    # plain scalar
    "'0': \xa0\nb: \u3000x\u3000\nc: x\u2003\n",
    # a quote opens a quoted scalar only where a node starts
    "'0': :\"\na: b \"c\nd: x, \"y\ne: -\"x\nf: [a\"b, 'c']\n",
    "a: ?0\nb: -x\nc: :y\n",
    "a: b\r\nc:\r\n  - d\r\n",
]


@pytest.mark.parametrize("text", HAND_WRITTEN)
def test_hand_written_documents(text):
    assert yaml_subset.loads(text) == yaml.safe_load(text)


REFUSED = {
    "anchor": "a: &x 1\nb: 2\n",
    "alias": "a: 1\nb: *x\n",
    "tag": "a: !!str 1\n",
    "local tag": "a: !custom 1\n",
    "document start": "---\na: 1\n",
    "multi-document stream": "a: 1\n---\nb: 2\n",
    "document end": "a: 1\n...\n",
    "directive": "%YAML 1.1\na: 1\n",
    "literal block scalar": "a: |\n  x\n",
    "folded block scalar": "a: >\n  x\n",
    "complex key": "? a\n: b\n",
    "merge key": "base: {a: 1}\nderived:\n  <<: x\n",
    "timestamp": "a: 2001-12-14\n",
    "timestamp with time": "a: 2001-12-14t21:59:43.10-05:00\n",
    "sexagesimal": "a: 1:30\n",
    "multi-line plain scalar": "a: b\n  c\n",
    "multi-line quoted scalar": "a: 'b\n  c'\n",
    "multi-line flow sequence": "a: [1,\n  2]\n",
    "multi-line flow mapping": "a: {b: 1,\n  c: 2}\n",
    "mapping inside a plain value": "a: b: c\n",
    "tab indentation": "a:\n\tb: 1\n",
    "bad indentation": "a: 1\n   b: 2\n",
    "reserved indicator": "a: @x\n",
    "non-printable character": "a: b\x0bc\n",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_constructs_outside_the_subset_raise_naming_the_line(name):
    text = REFUSED[name]
    with pytest.raises(YamlSubsetError, match=r"^line \d+: "):
        yaml_subset.loads(text)


_KEY = st.text(alphabet=st.characters(whitelist_categories=("Ll", "Lu",
                                                            "Nd"),
                                      whitelist_characters="_-. "),
               min_size=1, max_size=12)
_TEXT = st.text(alphabet=st.characters(
    blacklist_categories=("Cs", "Cc", "Co", "Cn", "Zl", "Zp"),
    blacklist_characters="\ufeff\x85\u2028\u2029"), max_size=20)
_SCALAR = st.one_of(
    st.none(), st.booleans(), st.integers(-10**12, 10**12),
    st.floats(allow_nan=False, width=64), _TEXT,
    st.sampled_from(["yes", "No", "on", "0x10", "017", "1e3", "1.0",
                     ".inf", "~", "null", "", "- a", "a: b", "#x", "'q'",
                     "2001-01-01", "1:30", "&a", "*b", "!t", "|", ">"]))
_DOC = st.recursive(
    _SCALAR,
    lambda inner: st.one_of(st.lists(inner, max_size=4),
                            st.dictionaries(_KEY, inner, max_size=4)),
    max_leaves=24)


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(doc=st.dictionaries(_KEY, _DOC, max_size=6),
       flow=st.sampled_from([False, None]))
def test_documents_of_the_subset_read_as_safe_load(doc, flow):
    text = yaml.safe_dump(doc, default_flow_style=flow, allow_unicode=True,
                          sort_keys=False, width=float("inf"))
    expected = yaml.safe_load(text)
    assert _same(expected, doc)
    assert _same(yaml_subset.loads(text), expected), text


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_load_config_of_the_example_equals_jax(monkeypatch):
    assert _asdict(port_config.load_config(EXAMPLE)) == \
        _asdict(jax_config.load_config(EXAMPLE))
    for k, v in {"ORAMACORE_HTTP_PORT": "9191",
                 "ORAMACORE_ROLE": "reader",
                 "ORAMACORE_HOOKS_ALLOW": "true",
                 "ORAMACORE_AUTH_MASTER": "k"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("ORAMACORE_DATA", "/tmp/elsewhere")
    port = port_config.load_config(EXAMPLE)
    assert _asdict(port) == _asdict(jax_config.load_config(EXAMPLE))
    assert port.http.port == 9191 and port.role == "reader"


def test_load_config_dispatches_on_the_extension(tmp_path):
    y = tmp_path / "c.yml"
    y.write_text("role: writer\nhttp:\n  port: 81\n")
    j = tmp_path / "c.json"
    j.write_text('{"role": "writer", "http": {"port": 81}}')
    a, b = port_config.load_config(str(y)), port_config.load_config(str(j))
    assert _asdict(a) == _asdict(b) and a.http.port == 81
    bad = tmp_path / "bad.yaml"
    bad.write_text("role: &r writer\n")
    with pytest.raises(YamlSubsetError, match="line 1: an anchor"):
        port_config.load_config(str(bad))
