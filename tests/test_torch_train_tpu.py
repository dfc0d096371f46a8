"""The port's trainer of `scripts/train_semantic_encoder_tpu.py`
(`oramacore_tpu_torch/train/semantic_encoder_tpu.py`) against the script
and its JAX step (CPU), at 2 layers, width 64, 2 heads, B=8 pairs, L=32:
the word lists and 1,000 sampler draws, the batches, the vocabulary and
the ids / masks of `build_tokenizer`'s `BertTokenizer`, the schedule,
one step's loss and gradients against `jax.value_and_grad` of the
script's loss over its own `forward` from its `init_params`, five AdamW
updates against `optax.adamw`, the port's init, the checkpoint in both
packages' encoders, the refused `--out` and the probes.

Tolerances, those of `tests/test_torch_train.py` where they apply: loss
1e-5; each gradient within 1e-4 of its largest magnitude; parameters
after five updates: 99.9% of the entries within 1e-6. Adam divides each
gradient by its own running magnitude, so an entry whose gradient is at
f32 noise level steps by up to the rate with the noise's sign; at 5
steps the script's warm-up is 0 and the first update takes the full
rate, so such entries differ by up to twice the rates' sum (the bound on
all entries), and the key bias, whose gradient is 0 in exact arithmetic
(128 entries, 0.14% of this model), is held apart: in each package it
moves no more than the rates' sum. The schedule within 2 f32 ulps plus one ulp of the
cosine carried through (XLA's f32 cosine is not correctly rounded: 3
ulps of the rate at 1,200 steps); encoder vectors 2e-5.

The script's `main` sets `scripts.train_semantic_encoder.CONCEPTS` to the
merged concepts before `build_tokenizer` reads it; the tests do the same
with `monkeypatch`, so no other test sees it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import scripts.train_semantic_encoder as v1
import scripts.train_semantic_encoder_tpu as script
from oramacore_tpu.embeddings.flax_encoder import FlaxTextEncoder
from oramacore_tpu_torch.embeddings import encoder as tenc
from oramacore_tpu_torch.embeddings import wordpiece
from oramacore_tpu_torch.train import semantic_encoder as se
from oramacore_tpu_torch.train import semantic_encoder_tpu as tpu

SMALL = tpu.TpuTrainConfig(steps=5, batch=8, layers=2, hidden=64, heads=2,
                           ffn=128)


@pytest.fixture
def merged_v1(monkeypatch):
    """The v1 module's CONCEPTS as the script's main leaves it."""
    monkeypatch.setattr(v1, "CONCEPTS", script.all_concepts())


@pytest.fixture
def script_tokenizer(merged_v1, tmp_path):
    return tmp_path, v1.build_tokenizer(str(tmp_path))


def test_word_lists_equal_the_script():
    assert tpu.CONCEPTS_V1 == v1.CONCEPTS and tpu.FILLER == v1.FILLER
    assert tpu.CONCEPTS_EXTRA == script.CONCEPTS_EXTRA
    assert tpu.CONCEPTS == script.all_concepts()
    assert list(tpu.CONCEPTS) == list(script.all_concepts())
    assert len(tpu.CONCEPTS) == 64
    # not the v2 lists of the other trainer
    assert tpu.CONCEPTS["vehicle"] != se.CONCEPTS["vehicle"]


def test_sampler_equals_the_script():
    names = sorted(script.all_concepts())
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(1000):
        assert tpu.sample_pair(a, tpu.CONCEPTS, names) == \
            script.sample_pair(b, script.all_concepts(), names)
    assert a.random() == b.random()   # the same number of draws


def test_vocab_and_tokenizer_files_equal_the_script(script_tokenizer,
                                                    tmp_path_factory):
    out, tok = script_tokenizer
    assert tok.vocab_size == len(tpu.vocab_tokens())
    mine = tmp_path_factory.mktemp("port_tok")
    wordpiece.save_pretrained(str(mine), tpu.vocab_tokens())
    with open(out / "vocab.txt", "rb") as f:
        assert (mine / "vocab.txt").read_bytes() == f.read()


def test_batches_ids_and_masks_equal_bert_tokenizer(script_tokenizer):
    """The trainer's batches equal the script's `make_batch` (`:284-292`:
    a-sides then b-sides of B pairs from default_rng(0), BertTokenizer at
    padding="max_length", truncation, max_length=32) over 20 steps, and
    texts longer than L truncate alike."""
    _, tok = script_tokenizer
    trainer = tpu.TpuScriptTrainer(SMALL, "cpu")
    rng = np.random.default_rng(0)
    concepts = script.all_concepts()
    names = sorted(concepts)
    for _ in range(20):
        pairs = [script.sample_pair(rng, concepts, names)
                 for _ in range(SMALL.batch)]
        texts = [p[0] for p in pairs] + [p[1] for p in pairs]
        enc = tok(texts, padding="max_length", truncation=True,
                  max_length=tpu.SEQ, return_tensors="np")
        ids, mask = trainer.next_batch()
        assert ids.shape == (2 * SMALL.batch, tpu.SEQ)
        np.testing.assert_array_equal(ids.numpy(), enc["input_ids"])
        np.testing.assert_array_equal(mask.numpy(), enc["attention_mask"])
    long = [" ".join(["automobile doctor filler001 stroll"] * 12), "car", ""]
    enc = tok(long, padding="max_length", truncation=True, max_length=32,
              return_tensors="np")
    ids, mask = trainer.tokenize(long)
    np.testing.assert_array_equal(ids.numpy(), enc["input_ids"])
    np.testing.assert_array_equal(mask.numpy(), enc["attention_mask"])


@pytest.mark.parametrize("steps", [5, 50, 1200])
def test_schedule_equals_optax(steps):
    """optax's schedule as the script builds it (`:298-303`): warm-up
    min(100, steps // 10), 0 at 5 steps, where it starts at the peak."""
    cfg = tpu.TpuTrainConfig(steps=steps)
    assert cfg.warmup == min(100, steps // 10) and cfg.decay_steps == steps
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, warmup_steps=min(100, steps // 10), decay_steps=steps)
    counts = np.arange(steps + 3)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(counts)), np.float32)
    got = np.array([se.warmup_cosine_decay(int(k), cfg.lr, cfg.warmup,
                                           cfg.decay_steps) for k in counts],
                   np.float32)
    # one ulp of XLA's f32 cosine, carried through lr * 0.5 * (1 + cos),
    # is up to 3 ulps of the rate at 1,200 steps: 2 ulps of the rate plus
    # that
    t = np.clip(counts - cfg.warmup, 0, steps - cfg.warmup)
    cos = np.cos(np.pi * t / max(steps - cfg.warmup, 1)).astype(np.float32)
    tol = 2 * np.spacing(want) + 0.5 * cfg.lr * np.spacing(np.abs(cos))
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= tol).all(), (err.max(), np.argmax(err - tol))
    np.testing.assert_array_equal(got[:cfg.warmup + 1], want[:cfg.warmup + 1])
    assert got[-1] == 0.0
    assert (got[0] == 0.0) == (cfg.warmup > 0)


# ---------------------------------------------------------------------------
# the step against JAX
# ---------------------------------------------------------------------------

def _jax_params(cfg):
    p = script.init_params(jax.random.PRNGKey(0), vocab=len(tpu.vocab_tokens()),
                           dim=cfg.hidden, layers=cfg.layers, heads=cfg.heads,
                           inter=cfg.ffn, max_len=cfg.max_len)
    return jax.tree_util.tree_map(np.asarray, p)


def _jax_loss_fn(heads):
    """The script's `loss_fn` (`:307-320`) over its `forward`."""
    def loss_fn(p, ids, mask):
        emb = script.forward(p, ids, mask, heads=heads)
        B = emb.shape[0] // 2
        a, b = emb[:B], emb[B:]
        logits = (a @ b.T) / 0.05
        labels = jnp.arange(B)
        loss = (optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
            + optax.softmax_cross_entropy_with_integer_labels(
                logits.T, labels).mean()) / 2
        acc = jnp.mean(jnp.argmax(logits, axis=1) == labels)
        return loss, acc
    return loss_fn


def _jnp(batch):
    return [jnp.asarray(t.numpy().astype(np.int32)) for t in batch]


def test_one_step_equals_jax_value_and_grad():
    cfg = SMALL
    params = _jax_params(cfg)
    trainer = tpu.TpuScriptTrainer(cfg, "cpu",
                                   state=tenc.params_from_jax(params))
    batch = trainer.next_batch()
    (jloss, jacc), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(cfg.heads), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), *_jnp(batch))
    trainer.opt.zero_grad(set_to_none=True)
    loss, acc = trainer.loss(*batch)
    loss.backward()
    loss, acc = float(loss.detach()), float(acc)
    assert abs(loss - float(jloss)) <= 1e-5, (loss, float(jloss))
    assert acc == float(jacc)
    want = tenc.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {k: p.grad for k, p in trainer.model.named_parameters()}
    assert sorted(want) == sorted(grads)
    for k, g in want.items():
        scale = float(g.abs().max())
        err = float((grads[k] - g).abs().max())
        assert err <= 1e-4 * max(scale, 1e-12), (k, err, scale)


def test_five_updates_equal_optax_adamw():
    cfg = SMALL
    params = _jax_params(cfg)
    trainer = tpu.TpuScriptTrainer(cfg, "cpu",
                                   state=tenc.params_from_jax(params))
    batches = [trainer.next_batch() for _ in range(cfg.steps)]
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.lr, warmup_steps=min(100, cfg.steps // 10),
        decay_steps=cfg.steps)
    opt = optax.adamw(sched, weight_decay=0.01)
    loss_fn = _jax_loss_fn(cfg.heads)

    @jax.jit
    def train_step(p, s, ids, mask):   # the script's :322-327
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, ids, mask)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, acc

    p = jax.tree_util.tree_map(jnp.asarray, params)
    st = opt.init(p)
    for batch in batches:
        p, st, jloss, _ = train_step(p, st, *_jnp(batch))
        loss, _ = trainer.step(batch)
        assert abs(float(loss) - float(jloss)) <= 1e-5
    assert trainer.updates == cfg.steps
    rates = sum(float(sched(k)) for k in range(cfg.steps))
    want = tenc.params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    got = trainer.model.state_dict()
    start = tenc.params_from_jax(params)
    D = cfg.hidden
    key_bias = {f"layers.{i}.qkv_b" for i in range(cfg.layers)}
    diff, kb = [], []
    for k, w in want.items():
        d = (got[k] - w).abs()
        if k in key_bias:
            # the key bias's gradient is 0 in exact arithmetic (it adds a
            # constant to a row of scores): Adam steps it by up to the
            # rate, with the sign of f32 noise, in both packages alike
            for t in (got[k], w):
                kb.append(float((t - start[k])[D:2 * D].abs().max()))
            d = torch.cat([d[:D], d[2 * D:]])
        diff.append(d.flatten())
    diff = torch.cat(diff)
    assert max(kb) <= 1.01 * rates, (kb, rates)
    assert float((diff > 1e-6).double().mean()) <= 1e-3
    assert float(diff.max()) <= 2 * rates, (float(diff.max()), rates)
    moved = max(float((w - start[k]).abs().max()) for k, w in want.items())
    assert moved > 0.5 * cfg.lr   # the updates moved the parameters


def test_init_has_the_scripts_scales():
    """The port's init draws other numbers than jax.random, in the same
    scheme: Xavier-normal dense weights, normal(0.02) embeddings, zero
    biases and type embeddings, unit gains; the names and shapes of the
    script's parameters."""
    cfg = tpu.TpuTrainConfig(steps=5, layers=2)
    vocab = len(tpu.vocab_tokens())
    state = tpu.init_state(cfg, vocab, torch.Generator().manual_seed(0))
    ref = tenc.params_from_jax(_jax_params(cfg))
    assert {k: v.shape for k, v in state.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert torch.equal(state["type_emb"], torch.zeros(2, cfg.hidden))
    D, FF = cfg.hidden, cfg.ffn

    def std_ok(t, std):
        return abs(float(t.std()) / std - 1) < 0.05

    for name in ("tok_emb", "pos_emb"):
        assert std_ok(state[name], 0.02), name
    for i in range(cfg.layers):
        p = f"layers.{i}."
        for j in range(3):
            assert std_ok(state[p + "qkv_w"][:, j * D:(j + 1) * D],
                          (2 / (D + D)) ** 0.5)
        assert std_ok(state[p + "o_w"], (2 / (D + D)) ** 0.5)
        assert std_ok(state[p + "ffn_w1"], (2 / (D + FF)) ** 0.5)
        assert std_ok(state[p + "ffn_w2"], (2 / (FF + D)) ** 0.5)
        for b in ("qkv_b", "o_b", "ffn_b1", "ffn_b2", "attn_ln_b",
                  "ffn_ln_b"):
            assert not state[p + b].any(), b
        for g in ("attn_ln_g", "ffn_ln_g"):
            assert torch.equal(state[p + g], torch.ones(D)), g
    # and JAX's own init has the same scales
    for name in ("tok_emb", "pos_emb"):
        assert std_ok(ref[name], 0.02), name
    assert std_ok(ref["layers.0.ffn_w1"], (2 / (D + FF)) ** 0.5)
    assert not ref["type_emb"].any()
    # the trainer seeds its generator: two trainers start equal
    a = tpu.TpuScriptTrainer(SMALL, "cpu").model.state_dict()
    b = tpu.TpuScriptTrainer(SMALL, "cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the checkpoint, the CLI, the probes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two CPU updates at the small geometry from JAX's init, saved by
    the port."""
    trainer = tpu.TpuScriptTrainer(SMALL, "cpu", state=tenc.params_from_jax(
        _jax_params(SMALL)))
    trainer.run(steps=2, log=lambda s: None)
    out = tmp_path_factory.mktemp("port_tpu_ckpt")
    trainer.save(out)
    return trainer, out


def test_checkpoint_loads_in_both_encoders(trained):
    trainer, out = trained
    with open(out / "config.json") as f:
        cfg = json.load(f)
    assert cfg["max_position_embeddings"] == 64
    assert cfg["num_hidden_layers"] == SMALL.layers
    assert cfg["vocab_size"] == len(tpu.vocab_tokens())
    texts = tpu.PROBES + ["walk stroll filler003 rain", "", "storm " * 40]
    flax = FlaxTextEncoder(str(out)).encode(texts)
    torch_enc = tenc.TorchTextEncoder(str(out), "cpu")
    got = torch_enc.encode(texts)
    np.testing.assert_allclose(np.stack(got), np.stack(flax), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(trainer.embed(texts[:7]), np.stack(got[:7]),
                               rtol=0, atol=2e-5)
    assert torch_enc.max_len == 64 and torch_enc.n_heads == SMALL.heads


def test_checkpoint_matches_the_scripts_save(trained, merged_v1, tmp_path):
    """The same parameters through the script's `save_hf_checkpoint`:
    every tensor equal (the pooler aside, which neither encoder reads)."""
    from safetensors.numpy import load_file

    trainer, out = trained
    state = {k: t.detach() for k, t in trainer.model.state_dict().items()}
    hf = tenc.state_to_hf(state)
    params = {name: hf[k] for k, name in tenc._HF_EMB.items()}
    params["layers"] = []
    for i in range(SMALL.layers):
        params["layers"].append({
            name: (hf[f"encoder.layer.{i}.{k}"].T if tr
                   else hf[f"encoder.layer.{i}.{k}"])
            for k, (name, tr) in tenc._HF_LAYER.items()})
    tok = v1.build_tokenizer(str(tmp_path / "tok"))
    script.save_hf_checkpoint(
        params, tok, str(tmp_path / "script"), dim=SMALL.hidden,
        layers=SMALL.layers, heads=SMALL.heads, inter=SMALL.ffn,
        max_len=SMALL.max_len)
    got = load_file(str(out / "model.safetensors"))
    want = load_file(str(tmp_path / "script" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        if not k.startswith("pooler."):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reload_check_and_probes(trained, tmp_path):
    trainer, out = trained
    with pytest.raises(se.TrainingFailed):
        tpu.reload_check(out, "cpu")   # two updates do not separate them
    with pytest.raises(se.TrainingFailed):
        trainer.validate()
    # the probes raise on an untrained model whose word embeddings are equal
    t = tpu.TpuScriptTrainer(SMALL, "cpu")
    with torch.no_grad():
        t.model.tok_emb.copy_(t.model.tok_emb[5:6].expand_as(t.model.tok_emb))
    with pytest.raises(se.TrainingFailed):
        t.validate()
    # and pass when both tiers separate: the check itself
    tpu.check_probes({"car~automobile": 0.9, "car~doctor": 0.5,
                      "walk~stroll": 0.8, "walk~rain": 0.1})
    with pytest.raises(se.TrainingFailed):
        tpu.check_probes({"car~automobile": 0.9, "car~doctor": 0.5,
                          "walk~stroll": 0.8, "walk~rain": 0.7})


def test_cli_refuses_models_and_runs_on_the_cpu(tmp_path, capsys):
    for out in ("models/semantic-base", "models", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "models", "x")):
        with pytest.raises(ValueError, match="under"):
            tpu.main(["--out", out, "--steps", "1", "--device", "cpu"])
    # five steps run end to end; the probes then fail and nothing is saved
    rc = tpu.main(["--device", "cpu", "--steps", "5", "--layers", "2",
                   "--dim", "64", "--batch", "8", "--out",
                   str(tmp_path / "ckpt")])
    out, err = capsys.readouterr()
    assert rc == 1 and "step 4:" in out and "failed to separate" in err
    assert not (tmp_path / "ckpt").exists()
    assert tpu.DEFAULT_OUT.parent.parent.name == "build"


def test_cuda_trainer_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpu.TpuScriptTrainer(SMALL, "cuda")
