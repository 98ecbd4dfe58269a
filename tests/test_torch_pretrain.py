"""The pretraining path of the port against the JAX package, on the CPU:
masking, the hash tokenizer, the MLM/MIM losses, both pretrainers at shared
weights (flash off and on), one training step's gradients against
`jax.grad`, the gathered head against the full one, and the weight
transfer of the pretrainers' leaves.

Narrow geometry with the main path's head shape: dim 192 in 2 heads of 96,
2 encoders, s=48 tokens of a vocabulary of 100, 4-channel 64x64 charts (16
patches). The JAX side runs jitted, its flash path through the Pallas
kernels in interpret mode; the port's through the kernels' plain versions.
fp32 bars: 1e-4 on logits and reconstructions, 1e-4 relative L2 on each
parameter's gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu import native
from meant_tpu.data import hash_tokenize as j_hash_tokenize
from meant_tpu.data import masking as j_masking
from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models.pretrainers import \
    meant_language_pretrainer as j_language
from meant_tpu.models.pretrainers import meant_vision_pretrainer as j_vision
from meant_tpu.models.pretrainers import pixel_shuffle as j_pixel_shuffle
from meant_tpu.train import pretrain as j_pretrain
from meant_tpu_torch import models
from meant_tpu_torch.data import masking
from meant_tpu_torch.data.datasets import fnv1a_tokenize, hash_tokenize
from meant_tpu_torch.data.loader import host_tensor
from meant_tpu_torch.train import pretrain
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

import torch_threads

torch_threads.share_cores()

D, HEADS, ENC, B, S, VOCAB, SIZE = 192, 2, 2, 2, 48, 100, 64
EMB = dict(vocab_size=VOCAB, hidden_size=D, dropout=0.0)
LANG = dict(num_encoders=ENC, text_dim=D, num_heads=HEADS, ff_dropout=0.0)
VISION = dict(num_encoders=ENC, patch_res=16, channels=4, height=SIZE,
              width=SIZE, image_dim=D, num_heads=HEADS)


# ---- masking and the tokenizer ------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_masking_equals_jax(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 60, size=(6, 40)).astype(np.int32)
    for got, want in zip(
            masking.mask_tokens(ids, 59, [0, 1, 2], seed=seed),
            j_masking.mask_tokens(ids, 59, [0, 1, 2], seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(masking.shift_labels_clm(ids),
                                  j_masking.shift_labels_clm(ids))
    imgs = rng.rand(3, 4, 16, 16).astype(np.float32)
    for got, want in zip(masking.mask_image(imgs, 0.3, seed=seed),
                         j_masking.mask_image(imgs, 0.3, seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert masking.IGNORE_INDEX == j_masking.IGNORE_INDEX


TEXTS = ["", "one", "  two  spaced   words ", "w12 w7 w12 w999 " * 20,
         "naïve café, déjà-vu!", "$AAPL to the moon 🚀 #stocks"]


@pytest.mark.parametrize("path", ["native", "fallback"])
def test_tokenizer_ids_equal_jax(path, monkeypatch):
    """The same ids whichever path JAX takes: its C++ library or its Python
    fallback (text split by spaces; the C++ path splits on spaces only)."""
    if path == "fallback":
        monkeypatch.setattr(native, "_build", lambda: None)
    else:
        assert native._build() is not None
    for max_len in (5, 16, 128):
        want = j_hash_tokenize(63999, max_len)
        got = hash_tokenize(63999, max_len)
        for t in TEXTS:
            assert got(t) == want(t), (t, max_len)
        for g, w in zip(fnv1a_tokenize(TEXTS, max_len, 100),
                        native.fnv1a_tokenize(TEXTS, max_len, 100)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ---- losses --------------------------------------------------------------

def _labels(seed, b=4, s=32, p=0.15):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, VOCAB, size=(b, s)).astype(np.int32)
    labels[rng.rand(b, s) >= p] = -100
    return labels


@pytest.mark.parametrize("capacity", [8, 16, 32])
def test_masked_positions_equal_jax(capacity):
    labels = _labels(1, p=0.3)
    got = pretrain.masked_positions(host_tensor(labels), capacity)
    want = j_pretrain.masked_positions(jnp.asarray(labels), capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2]) == (capacity < (labels != -100).sum(-1).max())


@pytest.mark.parametrize("gathered", [False, True])
def test_mlm_loss_equals_jax(gathered):
    rng = np.random.RandomState(2)
    labels = _labels(2)
    if gathered:
        pos, labels, _ = pretrain.masked_positions(host_tensor(labels), 16)
        labels = labels.numpy()
    logits = rng.randn(*labels.shape, VOCAB).astype(np.float32) * 3
    got = pretrain.mlm_loss(torch.tensor(logits), host_tensor(labels))
    want = j_pretrain.mlm_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    ce = torch.nn.functional.cross_entropy(
        torch.tensor(logits).reshape(-1, VOCAB),
        host_tensor(labels).reshape(-1), ignore_index=-100)
    np.testing.assert_allclose(got.item(), ce.item(), rtol=1e-6)


@pytest.mark.parametrize("masked_only", [False, True])
def test_mim_l1_loss_equals_jax(masked_only):
    rng = np.random.RandomState(3)
    _, labels = masking.mask_image(rng.rand(2, 4, 16, 16).astype(np.float32),
                                   0.3, seed=4)
    pred = rng.randn(2, 3, 16, 16).astype(np.float32)
    got = pretrain.mim_l1_loss(torch.tensor(pred), torch.tensor(labels),
                               masked_only=masked_only)
    want = j_pretrain.mim_l1_loss(jnp.asarray(pred), jnp.asarray(labels),
                                  masked_only=masked_only)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # the reference's objective is dominated by the -100 markers
    assert (got.item() > 50.0) == (not masked_only)


def test_capacity_overflow_poisons_the_loss():
    """A row with more masked tokens than the capacity turns the MLM loss
    into NaN, in both packages, and the capacity at s=128 is 48."""
    assert pretrain.default_gather_capacity(128) == 48
    for s in (8, 12, 48, 100, 128, 512):
        assert (pretrain.default_gather_capacity(s)
                == j_pretrain.default_gather_capacity(s))
    labels = _labels(5, s=16, p=1.0)
    batch = {"input_ids": np.full((4, 16), 5, np.int32),
             "attention_mask": np.ones((4, 16), np.float32),
             "labels": labels}
    model = models.meant_language_pretrainer(
        embedding=models.EmbeddingConfig(**dict(EMB, hidden_size=32)),
        num_encoders=1, text_dim=32, num_heads=4, device="cpu")
    trainer = pretrain.mlm_pretrainer({"model": model, "train_data": [batch],
                                       "gather_capacity": 8})
    loss = trainer.train_step({k: host_tensor(v) for k, v in batch.items()})
    assert torch.isnan(loss)
    jt = j_pretrain.mlm_pretrainer({"model": None, "train_data": [batch],
                                    "gather_capacity": 8})
    out = (jnp.zeros((4, 8, VOCAB)),) + j_pretrain.masked_positions(
        jnp.asarray(labels), 8)[1:]
    assert bool(jnp.isnan(jt._loss(out, batch)))


# ---- the pretrainers at shared weights ------------------------------------

def _mlm_batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, VOCAB - 1, size=(B, S)).astype(np.int32)
    ids[1, 30:] = 1
    inputs, labels = masking.mask_tokens(ids, VOCAB - 1, [0, 1, 2],
                                         seed=seed)
    return {"input_ids": inputs, "labels": labels,
            "attention_mask": (ids != 1).astype(np.float32)}


def _mim_batch(seed=0):
    rng = np.random.RandomState(seed)
    inputs, labels = masking.mask_image(
        rng.rand(B, 4, SIZE, SIZE).astype(np.float32), seed=seed)
    return {"input_ids": inputs, "labels": labels}


def _j_language(**kw):
    return j_language(embedding=JEmb(**EMB), **dict(LANG, **kw))


def _p_language(**kw):
    return models.meant_language_pretrainer(
        embedding=models.EmbeddingConfig(**EMB), device="cpu",
        **dict(LANG, **kw))


@pytest.fixture(scope="module")
def mlm_params():
    """JAX params of the tied and the untied MLM pretrainer (drawn by the
    flash=False twin), as numpy; the tied head's decoder_bias, zero at
    init, is drawn at random so that it shows in the logits."""
    b = _mlm_batch()
    out = {}
    for tied in (True, False):
        m = _j_language(tie_word_embeddings=tied)
        p = jax.jit(m.init)(jax.random.PRNGKey(1),
                            jnp.asarray(b["input_ids"]),
                            jnp.asarray(b["attention_mask"]))
        out[tied] = jax.tree.map(np.asarray, p["params"])
    head = dict(out[True]["mlm_head"])
    head["decoder_bias"] = np.random.RandomState(9).randn(VOCAB).astype(
        np.float32)
    out[True] = dict(out[True], mlm_head=head)
    return out


@pytest.fixture(scope="module")
def mim_params():
    m = j_vision(**VISION)
    p = jax.jit(m.init)(jax.random.PRNGKey(2),
                        jnp.asarray(_mim_batch()["input_ids"]))
    return jax.tree.map(np.asarray, p["params"])


def _port(model, params):
    load_jax_params(model, params)
    return model.eval()


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("head", ["gathered", "full", "untied"])
def test_language_pretrainer_logits_equal_jax(flash, head, mlm_params):
    tied = head != "untied"
    b = _mlm_batch()
    pos = None
    if head == "gathered":
        pos = pretrain.masked_positions(host_tensor(b["labels"]), 24)[0]
    j_kw = {} if pos is None else {"positions": jnp.asarray(pos.numpy())}
    jm = _j_language(flash=flash, tie_word_embeddings=tied)
    want = jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(b["input_ids"]),
        jnp.asarray(b["attention_mask"]), **j_kw))(mlm_params[tied])
    model = _port(_p_language(flash=flash, tie_word_embeddings=tied),
                  mlm_params[tied])
    with torch.no_grad():
        got = model(host_tensor(b["input_ids"]),
                    host_tensor(b["attention_mask"]), positions=pos)
    assert tuple(got.shape) == want.shape
    assert want.shape[-1] == VOCAB and want.shape[1] == (24 if pos is not None
                                                         else S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_vision_pretrainer_reconstruction_equals_jax(flash, mim_params):
    images = _mim_batch()["input_ids"]
    jm = j_vision(**VISION, flash=flash)
    want = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(images)))(
        mim_params)
    model = _port(models.meant_vision_pretrainer(**VISION, flash=flash,
                                                 device="cpu"), mim_params)
    with torch.no_grad():
        got = model(torch.tensor(images))
    assert tuple(got.shape) == want.shape == (B, 3, SIZE, SIZE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_pixel_shuffle_equals_jax():
    x = np.random.RandomState(0).randn(2, 3 * 16, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        models.pixel_shuffle(torch.tensor(x), 4).numpy(),
        np.asarray(j_pixel_shuffle(jnp.asarray(x), 4)))


@pytest.mark.parametrize("kind", ["tied", "untied", "vision"])
def test_state_dict_from_jax_uses_every_pretrainer_leaf_once(
        kind, mlm_params, mim_params):
    """Every JAX leaf maps to one port key (the tied head's raw
    decoder_bias, the untied decoder, patchEmbed and the MIM decoder
    included); the tied table is one parameter of the port, registered
    once."""
    if kind == "vision":
        params = mim_params
        model = models.meant_vision_pretrainer(**VISION, device="cpu")
    else:
        params = mlm_params[kind == "tied"]
        model = _p_language(tie_word_embeddings=kind == "tied")
    sd = state_dict_from_jax(params)
    assert len(sd) == len(jax.tree.leaves(params))
    assert set(sd) == set(model.state_dict())
    named = dict(model.named_parameters())
    if kind == "tied":
        np.testing.assert_array_equal(sd["mlm_head.decoder_bias"].numpy(),
                                      params["mlm_head"]["decoder_bias"])
        assert not any("decoder." in k for k in sd)
        assert "mlm_head.decoder_bias" in named
    elif kind == "untied":
        assert "mlm_head.decoder.weight" in named
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    n_freqs = sum(v.numel() for k, v in sd.items() if k.endswith("freqs"))
    assert sum(p.numel() for p in named.values()) == n_jax - n_freqs


def _group(name):
    return "head" if name.startswith(("mlm_head", "decoder")) else "tower"


def _step_gradients(kind, params, flash):
    """One training step of each package's trainer at dropout 0: (JAX loss,
    JAX gradients as a port state_dict, port loss, port model)."""
    if kind == "mlm":
        batch = _mlm_batch(seed=3)
        jm, pm = _j_language(flash=flash), _p_language(flash=flash)
        j_cls, p_cls = j_pretrain.mlm_pretrainer, pretrain.mlm_pretrainer
    else:
        batch = _mim_batch(seed=3)
        jm = j_vision(**VISION, flash=flash)
        pm = models.meant_vision_pretrainer(**VISION, flash=flash,
                                            device="cpu")
        j_cls, p_cls = j_pretrain.mim_pretrainer, pretrain.mim_pretrainer
    jt = j_cls({"model": jm, "train_data": [batch]})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(jt._apply(p, jb, False, rng), jb)))(params)
    load_jax_params(pm, params)
    pt = p_cls({"model": pm, "train_data": [batch]})
    loss = pt.train_step({k: host_tensor(v) for k, v in batch.items()})
    return (float(value), state_dict_from_jax(jax.tree.map(np.asarray,
                                                           grads)),
            loss.item(), pm)


@pytest.mark.parametrize("kind", ["mlm", "mim"])
def test_step_gradients_equal_jax_grad(kind, mlm_params, mim_params):
    """One step's loss and every parameter's gradient, flash on, against
    jax.grad of the JAX trainer's objective: relative L2 1e-4 per parameter
    and per group, plus 1e-8 absolute for a gradient that is zero in exact
    arithmetic. The tied table's gradient is the sum of its two uses."""
    params = mlm_params[True] if kind == "mlm" else mim_params
    j_loss, want, p_loss, model = _step_gradients(kind, params, flash=True)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == {k for k in want if not k.endswith("freqs")}
    groups = {}
    for name, p in named.items():
        got, ref = p.grad.numpy(), want[name].numpy()
        assert (np.linalg.norm(got - ref)
                <= 1e-4 * np.linalg.norm(ref) + 1e-8), name
        g = groups.setdefault(_group(name), [[], []])
        g[0].append(got.ravel())
        g[1].append(ref.ravel())
    for name, (got, ref) in groups.items():
        got, ref = np.concatenate(got), np.concatenate(ref)
        assert np.linalg.norm(ref) > 0, name
        assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref), name
    if kind == "mlm":
        table = named["embedding.word_embeddings.weight"].grad
        assert float(table[VOCAB - 1].abs().sum()) > 0   # the mask token


def test_gathered_head_equals_full_head(mlm_params):
    """The gathered head gives the full head's loss and gradients (fp32)."""
    batch = {k: host_tensor(v) for k, v in _mlm_batch(seed=4).items()}
    out = {}
    for gather in (True, False):
        model = _port(_p_language(), mlm_params[True])
        trainer = pretrain.mlm_pretrainer({"model": model,
                                           "train_data": [batch],
                                           "gather_masked": gather})
        loss = trainer.loss(batch)
        loss.backward()
        out[gather] = (loss.item(), {n: p.grad.clone()
                                     for n, p in model.named_parameters()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for name, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], g, rtol=1e-5,
                                   atol=1e-7, msg=name)


def test_pretrainers_refuse_stack_levers_and_need_the_card(monkeypatch,
                                                         mlm_params,
                                                         mim_params):
    """The levers are ported (nn/stack.py): each pretrainer builds with
    remat="full" and with scan_layers=True (so "dots") and, in training
    mode at one seed, computes bit for bit what it computes without them,
    outputs and gradients. The card refusal stays; a mesh and fsdp are
    taken (a one-rank gloo group in this process, ended here)."""
    lang = _mlm_batch()
    imgs = host_tensor(_mim_batch()["input_ids"])
    for lever in (dict(remat="full"), dict(scan_layers=True)):
        for kind in ("mlm", "mim"):
            got = []
            for kw in ({}, lever):
                if kind == "mlm":
                    model = _port(_p_language(**kw), mlm_params[True])
                    model.train()
                    torch.manual_seed(3)
                    y = model(host_tensor(lang["input_ids"]),
                              host_tensor(lang["attention_mask"]))
                else:
                    model = _port(models.meant_vision_pretrainer(
                        **VISION, device="cpu", **kw), mim_params)
                    model.train()
                    y = model(imgs)
                y.float().square().mean().backward()
                got.append((y.detach(), {n: p.grad for n, p in
                                         model.named_parameters()}))
            assert model.remat == lever.get("remat", False)
            assert torch.equal(got[0][0], got[1][0]), (kind, lever)
            for name, g in got[0][1].items():
                assert torch.equal(got[1][1][name], g), (kind, lever, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        models.meant_language_pretrainer(**LANG)
    with pytest.raises(RuntimeError, match="CUDA"):
        models.meant_vision_pretrainer(**VISION)
    from meant_tpu_torch.parallel import make_mesh
    try:
        for key in ("mesh", "fsdp"):
            value = make_mesh(device="cpu") if key == "mesh" else True
            trainer = pretrain.mlm_pretrainer({"model": _p_language(),
                                               "train_data": [], key: value})
            assert trainer.layout.size == 1
            assert trainer.layout.fsdp == (key == "fsdp")
    finally:
        torch.distributed.destroy_process_group()
