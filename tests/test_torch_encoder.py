"""The port's text encoder against the JAX package's (CPU): the attention
math, the forward pass, `TorchTextEncoder.encode` on both bundled
checkpoints, the bucketing, the synonym and phrase checks, the backend
bindings, and the golden vectors that the card compares with.

Tolerances: attention 1e-5 (f32 sums in another order), forward and
encode 1e-5 / 2e-5 absolute on unit vectors (f32 products of up to 4
layers in another order); the golden file within 1e-6 of a fresh JAX
run (XLA's CPU code may differ with the host's vector ISA).

Regenerate the golden file with

    JAX_PLATFORMS=cpu python tests/test_torch_encoder.py
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oramacore_tpu.embeddings as jemb
import oramacore_tpu_torch.embeddings as temb
from oramacore_tpu.embeddings.flax_encoder import (
    FlaxTextEncoder,
    bert_forward,
    load_flax_encoder,
)
from oramacore_tpu.ops.bm25 import round_up_pow2 as jax_round_up_pow2
from oramacore_tpu_torch.embeddings import encoder as tenc
from oramacore_tpu_torch.benches import H100_TF32X3_OPS_PER_S, bound_ms
from oramacore_tpu_torch.ops import attention as at

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"SemanticBase": os.path.join(REPO, "models", "semantic-base"),
          "SemanticMini": os.path.join(REPO, "models", "semantic-mini")}
GOLDEN = os.path.join(REPO, "oramacore_tpu_torch", "embeddings",
                      "golden_semantic.npz")

# tests/test_semantic_encoder.py's synonym and phrase lists, its engine
# test's documents, then out-of-vocabulary, accented, empty, CJK,
# punctuation, special-token, over-long and truncated cases
SYNONYMS = ["car", "automobile", "doctor", "physician", "storm"]
PHRASE_Q = ["buy car", "fast boat trip", "doctor visit", "cold storm night"]
PHRASE_T = ["automobile purchase", "rapid vessel voyage",
            "physician appointment", "icy tempest evening"]
GOLDEN_TEXTS = SYNONYMS + PHRASE_Q + PHRASE_T + [
    "storm warning tonight",
    "joyful melody collection",
    "",
    "Café au lait, NAÏVE façade",
    "ÉLAN résumé señor Ångström",
    "qzxv blorf wibble",
    "The quick brown fox jumps over the lazy dog",
    "BUY CAR!!! now?",
    "北京 car 東京",
    "doctor\tvisit\x00\nstorm",
    " ".join(["ancient ballad anthem automobile"] * 20),
    "automobile-purchase/physician's appointment",
    "ancient ballad anthem",
    "bargain battle beam avenue",
    "a" * 120,
    "[CLS] car [SEP]",
    "stormy stormier storms",
    "1234 5678 car",
    "affluent aged ailing ally alp amble amusing",
]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@jax.jit
def _jax_attention(qkv, mask, n_heads_marker):
    """flax_encoder.py:97-105 on a (B, L, 3D) projection, as there."""
    H = n_heads_marker.shape[0]
    B, L, D3 = qkv.shape
    D = D3 // 3
    hd = D // H
    q = qkv[..., :D].reshape(B, L, H, hd)
    k = qkv[..., D:2 * D].reshape(B, L, H, hd)
    v = qkv[..., 2 * D:].reshape(B, L, H, hd)
    neg = jnp.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    att = jax.nn.softmax(att + neg, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, L, D)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("L", [1, 16, 64, 512])
def test_attention_plain_matches_jax(hd, L):
    """Rows with a prefix of their keys attended, and one batch row with
    none (the JAX math gives it the mean of V; so does the port)."""
    rng = np.random.default_rng(L + hd)
    B, H = 3, 2
    qkv = rng.normal(size=(B, L, 3 * H * hd)).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    lens[-1] = 0
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    want = np.asarray(_jax_attention(qkv, mask, np.zeros(H)))
    got = at.encoder_attention_plain(torch.from_numpy(qkv),
                                     torch.from_numpy(mask), H).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    v_mean = qkv[-1, :, 2 * H * hd:].mean(axis=0)
    np.testing.assert_allclose(got[-1], np.broadcast_to(v_mean, got[-1].shape),
                               rtol=1e-5, atol=1e-5)
    # on the CPU the wrapper is its plain version
    np.testing.assert_array_equal(
        at.encoder_attention(torch.from_numpy(qkv), torch.from_numpy(mask),
                             H).numpy(), got)


@pytest.mark.parametrize("shape,mask_shape,H", [
    ((2, 16, 3 * 32), (2, 16), 4),       # head width 8
    ((2, 16, 3 * 192), (2, 16), 2),      # head width 96
    ((1, 513, 3 * 256), (1, 513), 8),    # longer than 512
    ((2, 16, 3 * 256 + 1), (2, 16), 8),  # not 3D wide
    ((2, 16, 3 * 256), (2, 15), 8),      # mask of another shape
    ((2, 16, 3 * 256), (2, 16), 3),      # width not a multiple of H
    ((2, 0, 3 * 256), (2, 0), 8),        # no tokens
    ((16, 3 * 256), (16,), 8),           # not batched
])
def test_attention_refuses_unsupported_shapes(shape, mask_shape, H):
    """The wrapper and its plain version refuse every malformed case on
    every device; head widths outside HEAD_DIMS (8, 96) are no longer
    refused: the wrapper takes them (zero-padded to a kernel width on the
    card) and equals its plain version on the CPU."""
    qkv = torch.zeros(shape)
    mask = torch.ones(mask_shape, dtype=torch.int32)
    D = shape[-1] // 3
    if len(shape) == 3 and shape[-1] % 3 == 0 and D % H == 0 \
            and D // H not in at.HEAD_DIMS and 1 <= shape[1] <= at.MAX_LEN \
            and mask_shape == shape[:2]:
        assert at.route(D // H) == "padded"
        want = at.encoder_attention_plain(qkv, mask, H)
        assert want.shape == (*shape[:2], D)
        torch.testing.assert_close(at.encoder_attention(qkv, mask, H), want,
                                   rtol=0, atol=0)
    else:
        with pytest.raises(ValueError):
            at.encoder_attention(qkv, mask, H)
        with pytest.raises(ValueError):
            at.encoder_attention_plain(qkv, mask, H)


def test_attention_launch_refuses_cpu_tensors():
    """The kernel's launcher never runs the plain version: CPU tensors
    raise (the wrapper takes the plain version before it)."""
    qkv = torch.zeros((2, 16, 3 * 256))
    mask = torch.ones((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        at.launch(qkv, mask, 8)


@pytest.mark.parametrize("B,H,L,hd,W,KT,stages,grid,smem", [
    # the points of the kernel's cases: bundled checkpoints at B=1024,
    # BGEBase at L=512 and 128, the B=1 query, L=1, a long batch, BGESmall,
    # a ragged L=77 and a 32-token batch
    (1024, 8, 64, 32, 4, 64, 1, 8192, 54784),
    (1024, 8, 16, 32, 1, 16, 1, 2048, 54784),
    (1024, 4, 64, 32, 4, 64, 1, 4096, 54784),
    (8, 12, 512, 64, 4, 32, 2, 768, 68480),
    (8, 12, 128, 64, 4, 32, 2, 192, 68480),
    (1, 8, 16, 32, 1, 16, 1, 2, 54784),
    (2, 8, 1, 32, 1, 16, 1, 4, 54784),
    (2048, 12, 512, 64, 4, 32, 2, 196608, 68480),
    (8, 12, 512, 32, 4, 64, 2, 768, 71424),
    (4, 12, 77, 64, 4, 32, 2, 96, 68480),
    (128, 8, 32, 32, 2, 32, 1, 512, 54784),
    # head widths 16 and 128 (no registry model has them): the cases
    # chip_smoke.py times, and both short tilings at hd 128
    (1024, 16, 64, 16, 4, 64, 1, 16384, 30208),
    (8, 8, 512, 128, 4, 16, 2, 512, 67008),
    (64, 8, 16, 128, 1, 16, 1, 128, 202240),
    (64, 8, 32, 128, 2, 32, 1, 256, 202240)])
def test_attention_tile_policy(B, H, L, hd, W, KT, stages, grid, smem):
    """tiles_for: warps a (b, h), key tile, ring depth, grid and dynamic
    shared memory, and the budgets the kernel's launch bound assumes (168
    registers a thread, 3 blocks of 128 threads an SM; at hd 128, 255
    registers and 2 blocks, or 1 where the shared memory of the short
    tilings allows no more)."""
    t = at.tiles_for(B, H, L, hd)
    assert (t.warps, t.key_tile, t.stages, t.grid, t.smem) == (
        W, KT, stages, grid, smem)
    assert t.pairs * t.warps == 4 and t.rows == 16 * W
    assert t.q_tiles * t.rows >= L > (t.q_tiles - 1) * t.rows
    assert t.stages == 1 or L > KT            # a second stage only to fill
    if hd == 128:
        assert t.max_regs == 255 and t.blocks_per_sm == (2 if W == 4 else 1)
    else:
        assert t.max_regs == 168 and t.blocks_per_sm == 3
    assert t.blocks_per_sm * t.smem <= 227 * 1024


def test_attention_work():
    # the bound's terms at SemanticBase B=1024, L=64 and BGEBase B=8, L=512
    assert at.attention_work(1024, 64, 8, 32) == (268_697_600, 4_294_967_296)
    assert at.attention_work(8, 512, 12, 64)[1] == 6_442_450_944
    # the bound at the 3xTF32 tensor-core rate (495 / 3 TFLOP/s): BGEBase
    # L=512 falls from 0.0962 ms (FFMA rate) to 0.039 ms; SemanticBase
    # stays bound by its bytes
    assert H100_TF32X3_OPS_PER_S == 165e12
    ms, by = bound_ms(*at.attention_work(8, 512, 12, 64),
                      H100_TF32X3_OPS_PER_S)
    assert by == "operations" and abs(ms - 0.039045) < 1e-5
    assert abs(bound_ms(*at.attention_work(8, 512, 12, 64))[0] - 0.09616) < 1e-4
    ms, by = bound_ms(*at.attention_work(1024, 64, 8, 32),
                      H100_TF32X3_OPS_PER_S)
    assert by == "bytes" and abs(ms - 0.080208) < 1e-5


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

def _seeded_params(rng, vocab, D, F_, n_layers, max_pos=64):
    def n(*shape, s=0.2):
        return (rng.normal(size=shape) * s).astype(np.float32)

    params = {"tok_emb": n(vocab, D, s=1.0), "pos_emb": n(max_pos, D),
              "type_emb": n(2, D), "emb_ln_g": 1 + n(D, s=0.1),
              "emb_ln_b": n(D, s=0.1), "layers": []}
    for _ in range(n_layers):
        params["layers"].append({
            "q_w": n(D, D), "q_b": n(D, s=0.1), "k_w": n(D, D),
            "k_b": n(D, s=0.1), "v_w": n(D, D), "v_b": n(D, s=0.1),
            "o_w": n(D, D), "o_b": n(D, s=0.1), "attn_ln_g": 1 + n(D, s=0.1),
            "attn_ln_b": n(D, s=0.1), "ffn_w1": n(D, F_), "ffn_b1": n(F_),
            "ffn_w2": n(F_, D), "ffn_b2": n(D, s=0.1),
            "ffn_ln_g": 1 + n(D, s=0.1), "ffn_ln_b": n(D, s=0.1)})
    return params


@pytest.mark.parametrize("D,H,n_layers", [(128, 4, 2), (128, 2, 1),
                                          (64, 2, 2), (64, 4, 2), (256, 2, 1),
                                          (64, 8, 1), (192, 2, 1),
                                          (320, 2, 1)])
def test_forward_matches_bert_forward(D, H, n_layers):
    """Seeded numpy weights through params_from_jax against bert_forward,
    with padded tokens and a batch row with no token, at head widths 32,
    64, 16 and 128 (the kernel's), 8 and 96 (which the card runs
    zero-padded) and 160 (above 128, the card's wide route: on the CPU
    the plain attention, counted once a layer in PLAIN_WIDTH_CALLS)."""
    rng = np.random.default_rng(D + H + n_layers)
    params = _seeded_params(rng, 50, D, 2 * D, n_layers)
    B, L = 4, 16
    ids = rng.integers(0, 50, (B, L)).astype(np.int32)
    lens = np.array([16, 9, 1, 0])
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    want = np.asarray(jax.jit(bert_forward, static_argnames="n_heads")(
        jax.tree_util.tree_map(jnp.asarray, params), ids, mask, n_heads=H))
    model = tenc.BertEncoder.from_state(tenc.params_from_jax(params), H)
    before = at.PLAIN_WIDTH_CALLS["encoder_attention_plain"]
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask)).numpy()
    plain = at.route(D // H) == "wide"
    assert at.PLAIN_WIDTH_CALLS["encoder_attention_plain"] - before == \
        (n_layers if plain else 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.all(np.abs(np.linalg.norm(got[:3], axis=1) - 1) < 1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_state_from_safetensors_matches_params_from_jax(name):
    """The checkpoint read by hand gives the state that the JAX package's
    weights (converted by `_convert_bert_weights`) give."""
    enc = FlaxTextEncoder(MODELS[name])
    want = tenc.params_from_jax(jax.tree_util.tree_map(np.asarray, enc.params))
    got = tenc.state_from_safetensors(
        os.path.join(MODELS[name], "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# the encoder on the bundled checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def encoders():
    return {name: (FlaxTextEncoder(path), tenc.TorchTextEncoder(path, "cpu"))
            for name, path in MODELS.items()}


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("n", [1, 5, 32])
def test_encode_matches_flax_encoder(encoders, name, n):
    jax_enc, port = encoders[name]
    texts = GOLDEN_TEXTS[-n:]
    want = np.stack(jax_enc.encode(texts))
    got = port.encode(texts)
    assert len(got) == n and all(v.dtype == np.float32 for v in got)
    np.testing.assert_allclose(np.stack(got), want, rtol=0, atol=2e-5)
    assert port.encode([]) == jax_enc.encode([]) == []


@pytest.mark.parametrize("B", [1, 2, 3, 5, 100, 128, 129])
@pytest.mark.parametrize("L", [1, 2, 16, 17, 33, 64])
def test_bucketing_matches_the_jax_encoder(B, L):
    max_len = 64
    want = (jax_round_up_pow2(B, 1),
            min(jax_round_up_pow2(L, 16), max_len))
    assert tenc.bucket_shape(B, L, max_len) == want
    assert tenc.bucket_shape(B, L, 512)[1] == min(jax_round_up_pow2(L, 16), 512)


@pytest.mark.parametrize("texts", [["car"], GOLDEN_TEXTS[:5],
                                   GOLDEN_TEXTS[10:27]])
def test_padded_shapes_match_the_jax_encoder(encoders, texts):
    """The (ids, mask) arrays the JAX encoder hands its jitted forward
    equal the port's, bucket padding included."""
    jax_enc, port = encoders["SemanticBase"]
    seen = []
    jax_enc._forward = lambda ids, mask: seen.append(
        (np.asarray(ids), np.asarray(mask))) or jnp.zeros((ids.shape[0], 4))
    try:
        jax_enc.encode(texts)
    finally:
        del jax_enc._forward
    ids, mask = port.tokenize(texts)
    np.testing.assert_array_equal(ids, seen[0][0])
    np.testing.assert_array_equal(mask, seen[0][1])


@pytest.mark.parametrize("name", list(MODELS))
def test_port_encodes_synonyms_close(encoders, name):
    """tests/test_semantic_encoder.py's synonym check, with the port."""
    v = dict(zip(SYNONYMS, encoders[name][1].encode(SYNONYMS)))
    assert float(v["car"] @ v["automobile"]) > 0.8
    assert float(v["doctor"] @ v["physician"]) > 0.8
    assert float(v["car"] @ v["doctor"]) < 0.6
    assert float(v["automobile"] @ v["storm"]) < 0.6


def _phrase_margin(enc) -> float:
    S = np.array(enc.encode(PHRASE_Q)) @ np.array(enc.encode(PHRASE_T)).T
    n = len(PHRASE_Q)
    assert (np.argmax(S, axis=1) == np.arange(n)).all(), S
    return float(np.mean(np.diag(S) - np.max(S - np.eye(n) * 9.0, axis=1)))


def test_port_semantic_base_beats_mini_on_phrase_separation(encoders):
    m_mini = _phrase_margin(encoders["SemanticMini"][1])
    m_base = _phrase_margin(encoders["SemanticBase"][1])
    assert m_base > m_mini + 0.02, (m_base, m_mini)
    assert m_base > 0.4, m_base
    # and the JAX package's margins, within the encode tolerance
    assert abs(m_base - _phrase_margin(encoders["SemanticBase"][0])) < 1e-4


# ---------------------------------------------------------------------------
# backends and the service
# ---------------------------------------------------------------------------

@pytest.fixture
def registries():
    saved = [(m, dict(m._BACKENDS), dict(m.MODELS)) for m in (jemb, temb)]
    yield
    for m, backends, models in saved:
        m._BACKENDS.clear()
        m._BACKENDS.update(backends)
        m.MODELS.clear()
        m.MODELS.update(models)


def test_service_embeds_through_the_bundled_checkpoints(registries, encoders):
    """register_bundled_checkpoints binds SemanticBase / SemanticMini
    lazily; calculate_embeddings then gives the JAX encoder's vectors."""
    assert tenc.register_bundled_checkpoints("cpu") == ["SemanticBase",
                                                        "SemanticMini"]
    svc = temb.EmbeddingsService()
    texts = ["buy car", "", "doctor visit " * 40]   # 80 words: 2 chunks
    for name in MODELS:
        out = svc.calculate_embeddings(texts, temb.Intent.PASSAGE, name)
        chunks = [temb.chunk_text(t, 64, 0.02) for t in texts]
        assert [len(v) for v in out] == [len(c) for c in chunks] == [1, 0, 2]
        want = encoders[name][0].encode([c for cs in chunks for c in cs])
        np.testing.assert_allclose(np.stack([v for vs in out for v in vs]),
                                   np.stack(want), rtol=0, atol=2e-5)


def test_register_torch_backend(registries, tmp_path):
    assert tenc.register_torch_backend(MODELS["SemanticMini"], "SemanticMini",
                                       device="cpu")
    assert ("flax:SemanticMini", "cpu") in temb._BACKENDS
    assert tenc.register_torch_backend(MODELS["SemanticMini"], device="cpu")
    assert ("flax", "cpu") in temb._BACKENDS
    # a directory without the checkpoint's files: False, hash stays
    assert not tenc.register_torch_backend(str(tmp_path / "absent"),
                                           "BGESmall", device="cpu")
    assert not any(n == "flax:BGESmall" for n, _ in temb._BACKENDS)


def test_lazy_binding_falls_back_to_hash_only_for_missing_files(
        registries, tmp_path):
    svc = temb.EmbeddingsService()
    absent = str(tmp_path / "absent")
    tenc.register_torch_backend_lazy(absent, "SemanticMini", device="cpu")
    out = svc.calculate_embeddings(["buy car"], temb.Intent.QUERY,
                                   "SemanticMini")
    np.testing.assert_array_equal(out[0][0], temb.hash_encode("buy car", 128))
    # a checkpoint whose weights are corrupt raises, and so does a CUDA
    # device on a host without one
    bad = tmp_path / "bad"
    shutil.copytree(MODELS["SemanticMini"], bad)
    (bad / "model.safetensors").write_bytes(b"\x10\x00\x00\x00" + bytes(12))
    tenc.register_torch_backend_lazy(str(bad), "SemanticMini", device="cpu")
    with pytest.raises(ValueError):
        svc.calculate_embeddings(["buy car"], temb.Intent.QUERY,
                                 "SemanticMini")
    if not torch.cuda.is_available():
        tenc.register_torch_backend_lazy(MODELS["SemanticMini"],
                                         "SemanticMini", device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            svc.calculate_embeddings(["buy car"], temb.Intent.QUERY,
                                     "SemanticMini")


def test_encoder_needs_an_explicit_device():
    with pytest.raises(TypeError):
        tenc.TorchTextEncoder(MODELS["SemanticMini"])
    with pytest.raises(ValueError):
        tenc.TorchTextEncoder(MODELS["SemanticMini"], "meta")


# ---------------------------------------------------------------------------
# the slice as a whole: passage text -> vectors -> vector search
# ---------------------------------------------------------------------------

def test_text_to_vector_search_matches_the_jax_package(registries):
    """Passages embedded through each package's service (SemanticBase)
    go into each package's VectorIndex; queries embedded the same way
    give the same top hits and scores (bf16 slab products)."""
    from oramacore_tpu.embeddings.flax_encoder import register_flax_backend
    from oramacore_tpu.index.vector_index import (
        VectorIndex as JaxVectorIndex,
        VectorIndexConfig as JaxConfig,
    )
    from oramacore_tpu_torch.benches.encoder_bench import (
        passages,
        vocab_words,
    )
    from oramacore_tpu_torch.index.vector_index import (
        VectorIndex,
        VectorIndexConfig,
    )

    words = vocab_words(os.path.join(MODELS["SemanticBase"], "vocab.txt"))
    docs = passages(words, 120, seed=3)
    queries = PHRASE_Q + ["ancient ballad", "storm"]
    assert register_flax_backend(MODELS["SemanticBase"], "SemanticBase")
    tenc.register_bundled_checkpoints("cpu")
    hits = []
    for emb, vidx in ((jemb, JaxVectorIndex(JaxConfig(dim=256))),
                      (temb, VectorIndex(VectorIndexConfig(dim=256), "cpu"))):
        svc = emb.EmbeddingsService()
        vecs = svc.calculate_embeddings(docs, emb.Intent.PASSAGE,
                                        "SemanticBase")
        for d, vs in enumerate(vecs):
            vidx.insert(d, vs)
        vidx.commit()
        qv = svc.calculate_embeddings(queries, emb.Intent.QUERY,
                                      "SemanticBase")
        hits.append(vidx.search_many(np.stack([v[0] for v in qv]), 5,
                                     [-1.0] * len(queries)))
    for j, p in zip(*hits):
        top_j = sorted(j.items(), key=lambda kv: (-kv[1], kv[0]))
        top_p = sorted(p.items(), key=lambda kv: (-kv[1], kv[0]))
        assert [d for d, _ in top_p[:3]] == [d for d, _ in top_j[:3]]
        np.testing.assert_allclose([s for _, s in top_p], [s for _, s in top_j],
                                   rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the golden vectors the card compares with
# ---------------------------------------------------------------------------

def golden_vectors() -> dict:
    """The JAX encoder's vectors of GOLDEN_TEXTS for both checkpoints."""
    out = {"texts": np.array(GOLDEN_TEXTS)}
    for name, path in MODELS.items():
        out[name] = np.stack(load_flax_encoder(path).encode(GOLDEN_TEXTS))
    return out


def test_golden_file_is_the_jax_encoders_output():
    with np.load(GOLDEN, allow_pickle=False) as f:
        stored = {k: f[k] for k in f.files}
    fresh = golden_vectors()
    assert sorted(stored) == sorted(fresh)
    assert stored["texts"].tolist() == GOLDEN_TEXTS
    for name in MODELS:
        assert stored[name].dtype == np.float32
        assert stored[name].shape == (len(GOLDEN_TEXTS),
                                      256 if name == "SemanticBase" else 128)
        np.testing.assert_allclose(stored[name], fresh[name], rtol=0,
                                   atol=1e-6)


def test_port_matches_the_golden_file(encoders):
    with np.load(GOLDEN, allow_pickle=False) as f:
        for name in MODELS:
            got = np.stack(encoders[name][1].encode(f["texts"].tolist()))
            np.testing.assert_allclose(got, f[name], rtol=0, atol=2e-5)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDEN, **golden_vectors())
    print(f"wrote {GOLDEN}", file=sys.stderr)
