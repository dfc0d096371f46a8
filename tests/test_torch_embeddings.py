"""The port's embeddings service, safetensors reader and WordPiece
tokenizer against the JAX package's service, `safetensors` and
`transformers.BertTokenizer` (CPU).

Tolerances: the registry, chunking, spans, prefixes, tensors and tokens
are compared exactly; `hash_encode` is bit-equal (same numpy code)."""

import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import oramacore_tpu.embeddings as jemb
import oramacore_tpu_torch.embeddings as temb
from oramacore_tpu_torch.embeddings import safetensors_io
from oramacore_tpu_torch.embeddings.wordpiece import WordPieceTokenizer

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"SemanticBase": os.path.join(REPO, "models", "semantic-base"),
          "SemanticMini": os.path.join(REPO, "models", "semantic-mini")}


@pytest.fixture(autouse=True)
def _restore_registries():
    """Backends and models registered by a test are dropped after it, in
    both packages."""
    saved = [(m, dict(m._BACKENDS), dict(m.MODELS)) for m in (jemb, temb)]
    yield
    for m, backends, models in saved:
        m._BACKENDS.clear()
        m._BACKENDS.update(backends)
        m.MODELS.clear()
        m.MODELS.update(models)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

def test_registry_matches_the_jax_package():
    assert list(temb.MODELS) == list(jemb.MODELS)
    for name, info in jemb.MODELS.items():
        assert dataclasses.astuple(temb.MODELS[name]) == \
            dataclasses.astuple(info), name
    assert temb.DEFAULT_MODEL == jemb.DEFAULT_MODEL
    assert [i.value for i in temb.Intent] == [i.value for i in jemb.Intent]


LONG = " ".join(f"w{i}" for i in range(1100))


@pytest.mark.parametrize("text", ["", "one", "a  b\tc\n d", LONG,
                                  " ".join(["x"] * 512), " ".join(["y"] * 513)])
@pytest.mark.parametrize("seq_len,overlap", [(512, 0.02), (128, 0.02),
                                             (64, 0.02), (7, 0.5), (1, 0.0)])
def test_chunk_text_matches(text, seq_len, overlap):
    assert temb.chunk_text(text, seq_len, overlap) == \
        jemb.chunk_text(text, seq_len, overlap)


HASH_TEXTS = ["", "hello", "Hello, World! hello world", "naïve café 東京",
              "a b c d e f g h", "   ", LONG[:3000], "x" * 300 + " yz"]


@pytest.mark.parametrize("dim", [16, 128, 384, 768])
def test_hash_encode_bit_equal(dim):
    for text in HASH_TEXTS:
        np.testing.assert_array_equal(temb.hash_encode(text, dim),
                                      jemb.hash_encode(text, dim))
    h = np.arange(1, 1000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(temb._mix64(h), jemb._mix64(h))
    for s in ("w:abc", "c:xyz", ""):
        assert temb._hash64(s) == jemb._hash64(s)


def _recording_backend(log):
    def backend(texts, info):
        log.append((list(texts), info.name))
        return [np.full(info.dim, float(i), np.float32)
                for i in range(len(texts))]
    return backend


@pytest.mark.parametrize("model", ["MultilingualE5Small", "BGESmall",
                                   "MultilingualMiniLML12V2",
                                   "builtin-minihash-384"])
@pytest.mark.parametrize("intent", ["query", "passage"])
def test_calculate_embeddings_spans_and_prefixes(model, intent):
    """The chunks each backend receives (intent prefixes included) and
    the per-text spans of vectors are the JAX package's."""
    texts = ["short text", "", LONG, " ".join(["t"] * 130), "last"]
    got = []
    for m in (jemb, temb):
        log = []
        m.register_backend("hash", _recording_backend(log))
        m.register_backend("flax", _recording_backend(log))
        out = m.EmbeddingsService().calculate_embeddings(
            texts, m.Intent(intent), model)
        got.append((log, [[float(v[0]) for v in vs] for vs in out]))
    assert got[0] == got[1]
    assert len(got[1][1]) == len(texts) and got[1][1][1] == []


def test_backend_resolution_order():
    """`<backend>:<name>` wins over `<backend>`, which wins over `hash`."""
    order = []
    for m in (jemb, temb):
        seen = []

        def tag(name):
            def backend(texts, info):
                seen.append(name)
                return [np.zeros(info.dim, np.float32) for _ in texts]
            return backend

        svc = m.EmbeddingsService()
        m.register_backend("hash", tag("hash"))
        svc.calculate_embeddings(["a"], m.Intent.QUERY, "BGESmall")
        m.register_backend("flax", tag("flax"))
        svc.calculate_embeddings(["a"], m.Intent.QUERY, "BGESmall")
        m.register_backend("flax:BGESmall", tag("flax:BGESmall"))
        svc.calculate_embeddings(["a"], m.Intent.QUERY, "BGESmall")
        svc.calculate_embeddings(["a"], m.Intent.QUERY, "BGEBase")
        order.append(seen)
        with pytest.raises(ValueError):
            svc.calculate_embeddings(["a"], m.Intent.QUERY, "no-such-model")
    assert order[0] == order[1] == ["hash", "flax", "flax:BGESmall", "flax"]


def test_hash_backend_vectors_match():
    texts = ["alpha beta", "", "gamma " * 40, "ünïcode text"]
    for model in ("builtin-minihash-384", "builtin-minihash-768"):
        got = temb.EmbeddingsService().calculate_embeddings(
            texts, temb.Intent.PASSAGE, model)
        want = jemb.EmbeddingsService().calculate_embeddings(
            texts, jemb.Intent.PASSAGE, model)
        assert [len(v) for v in got] == [len(v) for v in want]
        for text, gv, wv in zip(texts, got, want):
            for g, w in zip(gv, wv):
                # ASCII texts take the native encoder, as in the JAX
                # package: Python's output within f32 rounding; the others
                # take Python's hash_encode itself
                py = jemb.hash_encode(text, len(g))
                if text.isascii():
                    np.testing.assert_allclose(g, py, rtol=0, atol=1e-6)
                else:
                    np.testing.assert_array_equal(g, py)
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_safetensors_reader_matches_on_the_checkpoints(name):
    from safetensors.numpy import load_file

    path = os.path.join(MODELS[name], "model.safetensors")
    want = load_file(path)
    got = safetensors_io.load_numpy(path)
    assert sorted(got) == sorted(want)
    n_layers = 4 if name == "SemanticBase" else 2
    assert len(got) == 5 + 16 * n_layers + 2
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    tt = safetensors_io.load_torch(path)
    for k in want:
        assert torch.equal(tt[k], torch.from_numpy(want[k]))


def _synthetic(rng):
    return {
        "f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.normal(size=(7,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(
            np.float32)).to(torch.bfloat16),
        "i64": torch.from_numpy(rng.integers(-2**40, 2**40, (4, 2))),
        "i32": torch.from_numpy(rng.integers(-2**30, 2**30, (9,)).astype(
            np.int32)),
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros((0, 4)),
    }


def test_safetensors_reader_every_dtype(tmp_path):
    from safetensors.torch import load_file, save_file

    tensors = _synthetic(np.random.default_rng(0))
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    want = load_file(path)
    got = safetensors_io.load_torch(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    arrs = safetensors_io.load_numpy(path)
    for k in want:
        np.testing.assert_array_equal(
            arrs[k], want[k].float().numpy() if k == "bf16"
            else want[k].numpy())
    assert arrs["bf16"].dtype == np.float32


def _write(path, header, data):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["truncated", "overlap", "past_end",
                                  "size", "dtype", "header_len", "tiny",
                                  "not_json", "bad_entry"])
def test_safetensors_reader_refuses_bad_files(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    ok = {"__metadata__": {"format": "pt"},
          "a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
          "b": {"dtype": "I32", "shape": [2], "data_offsets": [8, 16]}}
    data = bytes(16)
    _write(path, ok, data)
    assert sorted(safetensors_io.load_numpy(path)) == ["a", "b"]
    if case == "truncated":
        blob = open(path, "rb").read()
        open(path, "wb").write(blob[:-3])
    elif case == "overlap":
        ok["b"]["data_offsets"] = [4, 12]
        _write(path, ok, data)
    elif case == "past_end":
        ok["b"]["data_offsets"] = [8, 24]
        ok["b"]["shape"] = [4]
        _write(path, ok, data)
    elif case == "size":
        ok["a"]["shape"] = [3]
        _write(path, ok, data)
    elif case == "dtype":
        ok["a"]["dtype"] = "F64"
        _write(path, ok, data)
    elif case == "header_len":
        open(path, "wb").write(struct.pack("<Q", 1 << 20) + b"{}")
    elif case == "tiny":
        open(path, "wb").write(b"\x01\x02")
    elif case == "not_json":
        open(path, "wb").write(struct.pack("<Q", 3) + b"{x]")
    elif case == "bad_entry":
        ok["a"] = {"dtype": "F32", "shape": [2]}
        _write(path, ok, data)
    with pytest.raises(ValueError):
        safetensors_io.load_numpy(path)
    with pytest.raises(ValueError):
        safetensors_io.load_torch(path)


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------

# the vocabulary of tests/test_flax_encoder.py, with ## pieces
PIECES_VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] the quick brown fox jumps over lazy "
    "dog search engine vector hybrid orange banana apple fruit salad "
    "wireless headphones noise cancelling price cheap expensive "
    "##s ##ing ##ed a an of to in is was un ##aff ##able jump ##e"
).split()


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """(name, the port's tokenizer, transformers.BertTokenizer) for both
    bundled vocabularies and one with ## pieces."""
    out = []
    for name, path in MODELS.items():
        out.append((name, WordPieceTokenizer.from_pretrained(path),
                    transformers.BertTokenizer.from_pretrained(path)))
    d = tmp_path_factory.mktemp("pieces")
    (d / "vocab.txt").write_text("\n".join(PIECES_VOCAB))
    out.append(("pieces", WordPieceTokenizer.from_pretrained(str(d)),
                transformers.BertTokenizer(str(d / "vocab.txt"))))
    return out


FIXED = [
    "", " ", "car", "The Quick brown FOX jumps!", "automobile purchase",
    "jumping jumped jumps unaffable unjumped",
    "北京大学 car 東京タワー 한국어", "Café ÉLAN naïve façade señor Ångström",
    "ΟΔΟΣ Σίσυφος ὀδυσσεύς", "İstanbul ǅemal ﬁnance Straße",
    "tab\there\nnew\rline\x00nul\ufffdrepl\x07bell\u200bzw\u2028ls\xa0nbsp",
    "e\u0301 n\u0303 combining",
    "punct: a,b.c;d!e?f(g)h[i]j{k}l<m>n@o#p$q%r^s&t*u-v_w=x+y/z\\|~`'\"",
    "«quoted» ¿qué? 「日本」 — dash … ellipsis",
    "a" * 101, "b" * 100, "jump" * 30,
    "[CLS] car [SEP] doctor [MASK] [UNK] [PAD]", "[cls] [Sep] [MASK][SEP]",
    "1234 5678.90 car-park e-mail",
    "😀 emoji 🚗 car", "\u0000\u0001\u001f", "x" + "\u0300" * 5,
]


def test_tokenizer_equals_bert_tokenizer_on_fixed_strings(tokenizers):
    for name, ours, ref in tokenizers:
        for text in FIXED:
            assert ours.tokenize(text) == ref.tokenize(text), (name, text)
            assert ours.ids(text) == ref.encode(
                text, add_special_tokens=False), (name, text)


@pytest.mark.parametrize("max_len", [3, 5, 16, 64])
def test_tokenizer_batches_equal_bert_tokenizer(tokenizers, max_len):
    texts = FIXED + [" ".join(["doctor car"] * 40)]
    for name, ours, ref in tokenizers:
        ids, mask = ours(texts, max_len)
        enc = ref(texts, padding=True, truncation=True, max_length=max_len,
                  return_tensors="np")
        np.testing.assert_array_equal(ids, enc["input_ids"], err_msg=name)
        np.testing.assert_array_equal(mask, enc["attention_mask"],
                                      err_msg=name)
        assert ids.dtype == np.int64 and mask.dtype == np.int64


def test_tokenizer_equals_the_fast_tokenizer_the_jax_encoder_loads(tokenizers):
    """`FlaxTextEncoder` loads the checkpoint through AutoTokenizer (the
    Rust one); on these strings it agrees too."""
    for name, ours, _ in tokenizers[:2]:
        fast = transformers.AutoTokenizer.from_pretrained(MODELS[name])
        ids, mask = ours(FIXED, 64)
        enc = fast(FIXED, padding=True, truncation=True, max_length=64,
                   return_tensors="np")
        np.testing.assert_array_equal(ids, enc["input_ids"], err_msg=name)
        np.testing.assert_array_equal(mask, enc["attention_mask"])


_ALPHABET = st.characters(codec="utf-8", exclude_categories=("Cs",))
_WORDS = st.sampled_from(["car", "Doctor", "AUTOMOBILE", "jump", "##s",
                          "[CLS]", "[SEP]", "unaffable", "ing", "naïve",
                          "東京", " ", "\t", ".", "-", "fox", "Jumps"])


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.one_of(st.text(_ALPHABET, max_size=60),
                      st.text(st.characters(max_codepoint=127), max_size=60),
                      st.lists(_WORDS, max_size=20).map("".join)))
def test_tokenizer_equals_bert_tokenizer_on_any_text(tokenizers, text):
    """Any text, ASCII (the port's fast path) or not."""
    for name, ours, ref in tokenizers:
        assert ours.tokenize(text) == ref.tokenize(text), (name, text)
