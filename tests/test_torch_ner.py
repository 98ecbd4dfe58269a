"""The port's token classification (meant_tpu_torch/train/ner.py) on the CPU
against the JAX package: `ner_ce_loss`, `align_labels`, `join_examples`,
`TokenClassifier` in fp32 and bf16, the 130-row position table at s=140
(forward and gradients), one `ner_trainer` step against JAX's jitted step
(per-example and flat token means, no clipping, dropout off) and
`token_f1`.

Sizes: TokenClassifier at 2 layers, width 32 in 4 heads, vocab 200, 5
tags, b=4, s=16 (s=140 for the clamp). Bars: the losses 1e-6 relative;
logits, gradients and a step's parameters 1e-5 (the key biases, whose
gradient is zero in exact arithmetic, within 2 lr: Adam turns their
rounding noise into a step of up to lr either way, as in
test_torch_vqa.py); bf16 logits 2e-2 (the port's bf16 bar for the HF
models: one bf16 step near 1 is 7.8e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.data import ArrayLoader as JArrayLoader
from meant_tpu.train import ner as jner
from meant_tpu_torch.data.loader import ArrayLoader, host_tensor
from meant_tpu_torch.train import ner
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

import torch_threads

torch_threads.share_cores()

GEOMETRY = dict(num_labels=5, vocab_size=200, hidden_size=32, num_layers=2,
                num_heads=4, dropout=0.0)
B, S = 4, 16
LR = 1e-3


def _batch(seed=0, s=S):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 200, (B, s)).astype(np.int32)
    mask = np.ones((B, s), np.float32)
    ids[1, s - 5:] = 1
    mask[1, s - 5:] = 0
    labels = rng.randint(0, 5, (B, s)).astype(np.int32)
    labels[rng.rand(B, s) >= 0.45] = -100
    labels[:, 0] = -100
    labels[2] = -100                       # a row with no label
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def _port_model(params, dtype=None):
    model = ner.TokenClassifier(**GEOMETRY, dtype=dtype, device="cpu")
    load_jax_params(model, params)
    return model


@pytest.fixture(scope="module")
def jax_params():
    b = _batch()
    jm = jner.TokenClassifier(**GEOMETRY)
    return jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), b["input_ids"], b["attention_mask"])[
            "params"])


def test_ner_ce_loss_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(B, S, 5).astype(np.float32)
    labels = _batch(1)["labels"]
    labels[3, 1:] = 0                      # rows of unequal label counts
    want = float(jner.ner_ce_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = ner.ner_ce_loss(torch.as_tensor(logits), torch.as_tensor(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_align_labels_and_join_examples_match_jax():
    word_ids = [[None, 0, 0, 1, 2, 2, None, None],
                [None, 0, 1, 1, 1, 2, 3, None]]
    tags = [[3, 1, 4], [0, 2, 1, 4]]
    np.testing.assert_array_equal(ner.align_labels(word_ids, tags),
                                  jner.align_labels(word_ids, tags))
    toks = [[f"w{i}", f"x{i}"] for i in range(7)]
    tag_lists = [[i, i + 1] for i in range(7)]
    for size in (1, 2, 3):
        assert ner.join_examples(toks, tag_lists, size) == \
            jner.join_examples(toks, tag_lists, size)


@pytest.mark.parametrize("bf16", [False, True])
def test_token_classifier_logits_match_jax(jax_params, bf16):
    b = _batch(2)
    dtype = jnp.bfloat16 if bf16 else None
    jm = jner.TokenClassifier(**GEOMETRY, dtype=dtype)
    want = np.asarray(jax.jit(jm.apply)(
        {"params": jax_params}, b["input_ids"], b["attention_mask"]),
        np.float32)
    model = _port_model(jax_params, torch.bfloat16 if bf16 else None)
    with torch.no_grad():
        got = model(host_tensor(b["input_ids"]),
                    torch.as_tensor(b["attention_mask"]))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    tol = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_position_clamp_at_s140_forward_and_gradients(jax_params):
    """Position ids past the 130-row table read its last row in both
    packages, and pass it no gradient."""
    b = _batch(3, s=140)
    jm = jner.TokenClassifier(**GEOMETRY)

    def loss(p):
        out = jm.apply({"params": p}, b["input_ids"], b["attention_mask"])
        return jner.ner_ce_loss(out, b["labels"]), out

    (want, out_j), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax_params)
    model = _port_model(jax_params)
    out = model(host_tensor(b["input_ids"]),
                torch.as_tensor(b["attention_mask"]))
    got = ner.ner_ce_loss(out, host_tensor(b["labels"]))
    got.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    table = model.roberta.embeddings.position_embeddings.weight
    assert table.shape[0] == 130 and table.grad[129].abs().sum() > 0


@pytest.fixture(scope="module")
def jax_trainers(jax_params):
    """JAX's ner_trainer per loss after one jitted step from
    `jax_params`, with its loss."""
    b = _batch(4)
    out = {}
    for flat in (False, True):
        tr = jner.ner_trainer({
            "model": jner.TokenClassifier(**GEOMETRY),
            "train_data": JArrayLoader(b, B), "lr": LR, "lrst": "constant",
            "flat_token_mean": flat, "init_params": jax_params})
        tr._init_state(b)
        start = tr.state
        tr._build_steps()
        state, loss = tr._jit_train(start, jax.tree.map(jnp.asarray, b))
        out[flat] = (tr, start, state, float(loss))
    return b, out


@pytest.mark.parametrize("flat", [False, True])
def test_trainer_step_matches_jax(jax_params, jax_trainers, flat):
    b, runs = jax_trainers
    _, _, state, want = runs[flat]
    trainer = ner.ner_trainer({
        "model": _port_model(jax_params), "train_data": ArrayLoader(b, B),
        "lr": LR, "lrst": "constant", "flat_token_mean": flat})
    loss = trainer.train_step({k: host_tensor(v) for k, v in b.items()})
    assert trainer.optimizer.clip_norm is None
    np.testing.assert_allclose(loss.item(), want, rtol=1e-6)
    want_p = state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    for name, p in trainer.model.state_dict().items():
        # a key bias's gradient is zero in exact arithmetic (a shift of
        # every key moves no softmax): Adam's m / sqrt(v) turns its rounding
        # noise into a step of up to lr either way
        tol = (dict(rtol=0, atol=2 * LR) if name.endswith("key.bias")
               else dict(rtol=1e-5, atol=1e-6))
        np.testing.assert_allclose(p.numpy(), want_p[name].numpy(),
                                   err_msg=name, **tol)


def test_token_f1_matches_jax(jax_trainers):
    b, runs = jax_trainers
    tr, _, state, _ = runs[False]
    tr.state = state
    params = jax.tree.map(np.asarray, state.params)
    data = _batch(5)
    want = tr.token_f1(JArrayLoader(data, B), 5)
    trainer = ner.ner_trainer({"model": _port_model(params),
                               "train_data": ArrayLoader(b, B)})
    got = trainer.token_f1(ArrayLoader(data, B), 5)
    assert got["confusion"] == want["confusion"]
    assert sum(map(sum, got["confusion"])) == int((data["labels"] >= 0).sum())
    for key in ("accuracy", "f1_macro", "precision_macro", "recall_macro"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
