"""The port's trainer (`oramacore_tpu_torch/train/semantic_encoder.py`)
against `scripts/train_semantic_encoder_v2.py` and its JAX step (CPU):
the word lists and sampler, the batches, the tokenization and the written
vocabulary, the schedule, one step's loss and gradients against
`jax.value_and_grad` of the script's loss over `bert_forward`, five AdamW
updates against `optax.adamw`, and the saved checkpoint in both packages'
encoders.

Tolerances: loss 1e-5; each gradient within 1e-4 of its largest
magnitude (f32 products and sums in another order, through 2 layers and
two encoder calls); parameters after five updates: 99.9% of the entries
within 1e-6 and all within 1e-4, 4% of the rates' sum (2.5e-3). Adam
divides each gradient by its own running magnitude, so where a gradient
is at f32 noise level its step follows the noise: the key bias, whose
gradient is zero in exact arithmetic (a constant added to a row of
scores leaves the softmax as it is), and token-embedding entries whose
contributions cancel. The schedule within 2 f32 ulps (XLA's f32
cosine is not correctly rounded); encoder vectors 2e-5 (unit vectors, as
`test_torch_encoder.py`).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import scripts.train_semantic_encoder_v2 as script
from oramacore_tpu.embeddings.flax_encoder import FlaxTextEncoder, bert_forward
from oramacore_tpu_torch.embeddings import encoder as tenc
from oramacore_tpu_torch.embeddings import safetensors_io, wordpiece
from oramacore_tpu_torch.train import semantic_encoder as se

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = se.TrainConfig(steps=5, batch=8, seq=16, layers=2, hidden=64,
                       heads=2, ffn=128)


def _script_make_batch(rng, names, batch):
    """The texts of the script's `make_batch` closure
    (`train_semantic_encoder_v2.py:317-346`), transcribed: it is local to
    `main` and tokenizes with `transformers`."""
    CONCEPTS = script.CONCEPTS
    a_texts, b_texts = [], []
    for _ in range(batch):
        ta, tb, seq = script.sample_pair(rng, names)
        if rng.random() < 0.25 and len(a_texts) + 2 <= batch:
            swapped = seq.copy()
            pos = rng.integers(0, len(swapped))
            choices = [c for c in range(len(names))
                       if c not in swapped]
            swapped[pos] = choices[rng.integers(0, len(choices))]
            _, tneg, _ = script.sample_pair(rng, names)
            tneg = " ".join(
                CONCEPTS[names[c]][rng.integers(
                    0, len(CONCEPTS[names[c]])
                )] for c in swapped
            )
            a_texts.append(ta)
            b_texts.append(tb)
            a_texts.append(tneg)
            b_texts.append(tneg)
        else:
            a_texts.append(ta)
            b_texts.append(tb)
    return a_texts[:batch], b_texts[:batch]


@pytest.fixture(scope="module")
def script_tokenizer(tmp_path_factory):
    """The script's `build_tokenizer` output directory and tokenizer."""
    out = str(tmp_path_factory.mktemp("script_tok"))
    return out, script.build_tokenizer(out)


def test_word_lists_and_sampler_equal_the_script():
    assert se.CONCEPTS == script.CONCEPTS and se.FILLER == script.FILLER
    names = list(se.CONCEPTS)
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(200):
        ta, tb, seq = se.sample_pair(a, names)
        wa, wb, wseq = script.sample_pair(b, names)
        assert (ta, tb) == (wa, wb) and np.array_equal(seq, wseq)


@pytest.mark.parametrize("batch", [64, 8])
def test_batches_equal_the_script(batch):
    names = list(se.CONCEPTS)
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    hard = 0
    for _ in range(20):
        got = se.make_batch(a, names, batch)
        want = _script_make_batch(b, names, batch)
        assert got == want
        assert len(got[0]) == len(got[1]) == batch
        hard += sum(x == y for x, y in zip(*got))
    assert hard > 0   # hard negatives enter as self-pairs
    assert a.random() == b.random()   # the same number of draws


def test_vocab_and_tokenizer_files_equal_the_script(tmp_path, script_tokenizer):
    out, _ = script_tokenizer
    wordpiece.save_pretrained(str(tmp_path), se.vocab_tokens())
    for name in ("vocab.txt",):
        with open(os.path.join(out, name), "rb") as f:
            want = f.read()
        with open(tmp_path / name, "rb") as f:
            assert f.read() == want, name
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        with open(os.path.join(out, name)) as f:
            want = json.load(f)
        with open(tmp_path / name) as f:
            got = json.load(f)
        assert {k: v for k, v in got.items()} == {
            k: v for k, v in want.items() if k in got}, name
    # the bundled checkpoint's tokenizer config has the same keys
    with open(os.path.join(REPO, "models", "semantic-base",
                           "tokenizer_config.json")) as f:
        assert set(json.load(f)) == set(json.loads(
            (tmp_path / "tokenizer_config.json").read_text()))


def test_ids_and_masks_equal_bert_tokenizer(script_tokenizer):
    """padding="max_length" to L=16, as the script's encode_batch
    (`:311-315`), over 20 batches and texts longer than L."""
    _, tok = script_tokenizer
    trainer_tok = wordpiece.WordPieceTokenizer(
        {t: i for i, t in enumerate(se.vocab_tokens())})
    rng = np.random.default_rng(0)
    names = list(se.CONCEPTS)
    texts = []
    for _ in range(20):
        texts += sum(se.make_batch(rng, names, 64), [])
    texts += [" ".join(["automobile doctor filler001"] * 8), "car", ""]
    enc = tok(texts, padding="max_length", truncation=True, max_length=16,
              return_tensors="np")
    ids, mask = trainer_tok(texts, 16, padding="max_length")
    assert ids.shape == (len(texts), 16)
    np.testing.assert_array_equal(ids, enc["input_ids"])
    np.testing.assert_array_equal(mask, enc["attention_mask"])
    with pytest.raises(ValueError):
        trainer_tok(texts, 16, padding="longest_first")


@pytest.mark.parametrize("steps", [10, 1500])
def test_schedule_equals_optax(steps):
    cfg = se.TrainConfig(steps=steps)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, warmup_steps=cfg.warmup, decay_steps=cfg.decay_steps)
    counts = np.arange(steps + 3)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(counts)), np.float32)
    got = np.array([se.warmup_cosine_decay(int(k), cfg.lr, cfg.warmup,
                                           cfg.decay_steps) for k in counts],
                   np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, (ulps.max(), np.argmax(ulps))
    np.testing.assert_array_equal(got[:cfg.warmup + 1], want[:cfg.warmup + 1])
    assert got[0] == 0.0 and got[-1] == 0.0


# ---------------------------------------------------------------------------
# the step against JAX
# ---------------------------------------------------------------------------

def _jax_params(cfg):
    p = script.init_params(jax.random.PRNGKey(0), vocab=len(se.vocab_tokens()),
                           D=cfg.hidden, layers=cfg.layers, H=cfg.heads,
                           FF=cfg.ffn, max_pos=se.MAX_POS)
    return jax.tree_util.tree_map(np.asarray, p)


def _jax_loss_fn(heads):
    """The script's `loss_fn` (`:283-301`)."""
    def loss_fn(p, ids_a, m_a, ids_b, m_b):
        za = bert_forward(p, ids_a, m_a, n_heads=heads)
        zb = bert_forward(p, ids_b, m_b, n_heads=heads)
        logits = za @ zb.T / se.TEMP
        labels = jnp.arange(logits.shape[0])
        l1 = optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
        l2 = optax.softmax_cross_entropy_with_integer_labels(
            logits.T, labels).mean()
        acc = jnp.mean(jnp.argmax(logits, axis=1) == labels)
        return (l1 + l2) / 2, acc
    return loss_fn


def _batches(trainer, n):
    return [trainer.next_batch() for _ in range(n)]


def _numpy_batch(batch):
    return [jnp.asarray(t.numpy()) for t in batch]


def _port_grads(trainer, batch):
    trainer.opt.zero_grad(set_to_none=True)
    loss, acc = trainer.loss(*batch)
    loss.backward()
    return float(loss.detach()), float(acc), {
        k: p.grad.clone() for k, p in trainer.model.named_parameters()}


@pytest.mark.parametrize("cfg", [
    SMALL, se.TrainConfig(steps=5, batch=8, seq=16, layers=1, hidden=64,
                          heads=4, ffn=128)], ids=["hd32", "hd16"])
def test_one_step_equals_jax_value_and_grad(cfg):
    params = _jax_params(cfg)
    trainer = se.SemanticTrainer(cfg, "cpu", state=tenc.params_from_jax(params))
    batch = trainer.next_batch()
    (jloss, jacc), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(cfg.heads), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), *_numpy_batch(batch))
    loss, acc, grads = _port_grads(trainer, batch)
    assert abs(loss - float(jloss)) <= 1e-5, (loss, float(jloss))
    assert acc == float(jacc)
    want = tenc.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(want) == sorted(grads)
    for k, g in want.items():
        scale = float(g.abs().max())
        err = float((grads[k] - g).abs().max())
        assert err <= 1e-4 * max(scale, 1e-12), (k, err, scale)


def test_five_updates_equal_optax_adamw():
    cfg = SMALL
    params = _jax_params(cfg)
    trainer = se.SemanticTrainer(cfg, "cpu", state=tenc.params_from_jax(params))
    batches = _batches(trainer, cfg.steps)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, warmup_steps=cfg.warmup, decay_steps=cfg.decay_steps)
    opt = optax.adamw(sched, weight_decay=0.01)
    loss_fn = _jax_loss_fn(cfg.heads)

    @jax.jit
    def train_step(p, st, ids_a, m_a, ids_b, m_b):   # the script's :303-309
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, ids_a, m_a, ids_b, m_b)
        upd, st = opt.update(grads, st, p)
        return optax.apply_updates(p, upd), st, loss, acc

    p = jax.tree_util.tree_map(jnp.asarray, params)
    st = opt.init(p)
    for batch in batches:
        p, st, jloss, _ = train_step(p, st, *_numpy_batch(batch))
        loss, _ = trainer.step(batch)
        assert abs(float(loss) - float(jloss)) <= 1e-5
    assert trainer.updates == cfg.steps
    want = tenc.params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    got = trainer.model.state_dict()
    start = tenc.params_from_jax(params)
    diff = torch.cat([(got[k] - w).abs().flatten() for k, w in want.items()])
    assert float(diff.max()) <= 1e-4
    assert float((diff > 1e-6).double().mean()) <= 1e-3
    moved = max(float((w - start[k]).abs().max()) for k, w in want.items())
    assert moved > 1e-4   # the updates moved the parameters


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two CPU updates at the small geometry, saved by the port and (the
    same parameters) by the script's `save_hf_checkpoint`."""
    cfg = SMALL
    trainer = se.SemanticTrainer(cfg, "cpu", state=tenc.params_from_jax(
        _jax_params(cfg)))
    trainer.run(steps=2, log=lambda s: None)
    port_dir = tmp_path_factory.mktemp("port_ckpt")
    trainer.save(port_dir)
    state = {k: t.detach() for k, t in trainer.model.state_dict().items()}
    script_dir = tmp_path_factory.mktemp("script_ckpt")
    params = {k: state[k].numpy() for k in ("tok_emb", "pos_emb", "type_emb",
                                            "emb_ln_g", "emb_ln_b")}
    params["layers"] = []
    for i in range(cfg.layers):
        lay = {k: state[f"layers.{i}.{k}"].numpy() for k in tenc._LAYER}
        w, b = state[f"layers.{i}.qkv_w"].numpy(), state[f"layers.{i}.qkv_b"].numpy()
        D = cfg.hidden
        for j, n in enumerate("qkv"):
            lay[f"{n}_w"] = w[:, j * D:(j + 1) * D]
            lay[f"{n}_b"] = b[j * D:(j + 1) * D]
        params["layers"].append(lay)
    script.save_hf_checkpoint(params, str(script_dir), H=cfg.heads,
                              max_pos=se.MAX_POS,
                              vocab_size=len(se.vocab_tokens()))
    return trainer, port_dir, script_dir


def test_checkpoint_matches_the_scripts(trained):
    from safetensors.numpy import load_file

    _, port_dir, script_dir = trained
    got = load_file(str(port_dir / "model.safetensors"))
    want = load_file(str(script_dir / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if not k.startswith("pooler."):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(script_dir / "config.json") as f:
        want_cfg = json.load(f)
    with open(port_dir / "config.json") as f:
        got_cfg = json.load(f)
    with open(os.path.join(REPO, "models", "semantic-base", "config.json")) as f:
        assert set(got_cfg) == set(json.load(f))
    for k in ("hidden_size", "num_hidden_layers", "num_attention_heads",
              "intermediate_size", "max_position_embeddings", "vocab_size",
              "type_vocab_size", "layer_norm_eps", "model_type"):
        assert got_cfg[k] == want_cfg[k], k


def test_checkpoint_loads_in_both_encoders(trained):
    trainer, port_dir, _ = trained
    texts = ["car", "automobile purchase", "doctor visit tonight", "",
             "storm " * 30]
    flax = FlaxTextEncoder(str(port_dir)).encode(texts)
    torch_enc = tenc.TorchTextEncoder(str(port_dir), "cpu")
    got = torch_enc.encode(texts)
    np.testing.assert_allclose(np.stack(got), np.stack(flax), rtol=0,
                               atol=2e-5)
    # the trainer's own vectors (texts padded to seq) agree with the
    # served ones for texts that fit
    np.testing.assert_allclose(trainer.embed(texts[:3]), np.stack(got[:3]),
                               rtol=0, atol=2e-5)
    assert torch_enc.n_heads == SMALL.heads and torch_enc.max_len == se.MAX_POS


def test_save_numpy_round_trips_through_safetensors(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(2)
    arrays = {"a.weight": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.integers(-9, 9, 7).astype(np.int64),
              "c": np.arange(4, dtype=np.int32), "empty": np.zeros((0, 3),
                                                                   np.float32),
              "big_endian": rng.normal(size=4).astype(">f4")}
    safetensors_io.save_numpy(str(tmp_path / "port.safetensors"), arrays)
    back = load_file(str(tmp_path / "port.safetensors"))
    assert sorted(back) == sorted(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a)
        assert back[k].dtype == a.dtype.newbyteorder("=")
    # and the port's reader reads both writers' files
    save_file({k: np.ascontiguousarray(a, a.dtype.newbyteorder("="))
               for k, a in arrays.items()}, str(tmp_path / "lib.safetensors"))
    for name in ("port", "lib"):
        got = safetensors_io.load_numpy(str(tmp_path / f"{name}.safetensors"))
        for k, a in arrays.items():
            np.testing.assert_array_equal(got[k], a)
    with pytest.raises(ValueError):
        safetensors_io.save_numpy(str(tmp_path / "x.safetensors"),
                                  {"f64": np.zeros(2)})


def test_out_under_models_is_refused(tmp_path):
    for out in ("models/semantic-base", "models", "models/new/deeper",
                os.path.join(REPO, "models", "x")):
        with pytest.raises(ValueError, match="under"):
            se.main(["--out", out, "--steps", "1", "--device", "cpu"])
    assert se.check_out_dir(tmp_path / "ok") == (tmp_path / "ok").resolve()
    # the default lies under build/, which git ignores
    assert se.DEFAULT_OUT.parent.parent.name == "build"


def test_cuda_trainer_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        se.SemanticTrainer(SMALL, "cuda")


def test_validation_probes_raise_on_an_untrained_model():
    """The probes raise (not assert) when the concepts are not apart: an
    untrained model with every word embedding equal gives equal vectors."""
    trainer = se.SemanticTrainer(SMALL, "cpu")
    with torch.no_grad():
        trainer.model.tok_emb.copy_(trainer.model.tok_emb[5:6].expand_as(
            trainer.model.tok_emb))
    with pytest.raises(se.TrainingFailed):
        trainer.validate()
