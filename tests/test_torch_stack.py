"""remat and scan_layers in the port (`nn/stack.py`, the towers, the CLI)
against the JAX package's `nn/stack.py` on the CPU.

meant_src at 2 encoders, width 64 in 2 heads, s=12 on 32x32 charts, with
fixed_proj=True (at False no gradient reaches the towers): for every remat
and scan_layers setting the forward and every parameter gradient equal
`jax.grad` of the JAX model with the same flags at shared weights, within
1e-4 relative L2 per gradient, dropout off; a scanned
JAX model's weights come from its `languageEncoders_scan` /
`visionEncoders_scan` layout (`weights.state_dict_from_jax`). With dropout
on, gradients under remat equal those without, bit for bit, at one seed.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models.meant_src import meant_src as j_meant_src
from meant_tpu.models.pretrainers import (
    meant_language_pretrainer as j_language)
from meant_tpu.nn import stack as jstack
from meant_tpu_torch import models
from meant_tpu_torch.cli.common import base_parser, build_model
from meant_tpu_torch.nn import stack
from meant_tpu_torch.train.classify import seed_dropout
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

import torch_threads

torch_threads.share_cores()

D, ENC, S, LAG, B = 64, 2, 12, 3, 2
EMB = dict(vocab_size=100, hidden_size=D, max_position_embeddings=40,
           dropout=0.0)
GEOM = dict(text_dim=D, image_dim=D, price_dim=5, height=32, width=32,
            patch_res=16, lag=LAG, num_classes=2, num_heads=2,
            num_encoders=ENC, channels=3, seq_len=16, fixed_proj=True)
SETTINGS = [(False, False), ("full", False), ("dots", False),
            (False, True), ("full", True), ("dots", True)]


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 100, (B, LAG, S)).astype(np.int32)
    ids[0, 1, 8:] = 1
    return {"input_ids": ids,
            "pixels": rng.randn(B, LAG, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(B, LAG, 5).astype(np.float32),
            "attention_mask": (ids != 1).astype(np.float32)}


# a fixed cotangent: loss = sum(out * W)
W = np.random.RandomState(7).randn(B, 2).astype(np.float32)


class _FlashCount(TorchDispatchMode):
    """Counts the port's flash ops the dispatcher runs."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name.startswith("meant_tpu_torch::flash"):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _port_grads(model, batch):
    """Training-mode forward and backward of sum(out * W): (out, grads by
    state_dict key)."""
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(**{k: torch.as_tensor(v) for k, v in batch.items()})
    (out * torch.as_tensor(W)).sum().backward()
    return out.detach().numpy(), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


def _assert_grads(got, want, name):
    """Each gradient within 1e-4 relative L2, plus 1e-7: the temporal
    keys' bias has a true gradient of zero (a shift of every key leaves the
    softmax as it is) and reads fp32 noise of some 1e-8 in both packages."""
    assert sorted(got) == sorted(want), name
    for k, g in want.items():
        assert (np.linalg.norm(got[k] - g)
                <= 1e-4 * np.linalg.norm(g) + 1e-7), f"{name}: {k}"


@pytest.fixture(scope="module")
def jax_src():
    """JAX meant_src: params in the unrolled layout and the same params
    stacked into the scanned one, and one batch."""
    batch = _batch()
    model = j_meant_src(embedding=JEmb(**EMB), **GEOM)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), **{
        k: jnp.asarray(v) for k, v in batch.items()})["params"]
    params = jax.tree.map(np.asarray, dict(params))
    scanned = params
    for tower in ("languageEncoders", "visionEncoders"):
        scanned = jstack.stack_encoder_params(scanned, tower, ENC)
    return {False: params, True: jax.tree.map(np.asarray, scanned)}, batch


@pytest.mark.parametrize("remat,scan", SETTINGS,
                         ids=[f"remat_{r}-scan_{s}" for r, s in SETTINGS])
def test_forward_and_gradients_equal_jax_grad(remat, scan, jax_src):
    params_by_layout, batch = jax_src
    params = params_by_layout[scan]
    jmodel = j_meant_src(embedding=JEmb(**EMB), remat=remat,
                         scan_layers=scan, **GEOM)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        out = jmodel.apply({"params": p}, **jb)
        return jnp.sum(out * W), out

    (_, want_out), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, jgrads)).items() if not k.endswith("freqs")}
    port = models.meant_src(embedding=models.EmbeddingConfig(**EMB),
                            remat=remat, scan_layers=scan, device="cpu",
                            **GEOM)
    load_jax_params(port, params)
    assert port.languageEncoders.remat == stack.tower_remat(remat, scan)
    out, got = _port_grads(_no_dropout(port), batch)
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=1e-4,
                               atol=1e-5)
    _assert_grads(got, want, f"remat={remat} scan={scan}")


def test_scanned_pretrainer_equals_jax_grad():
    """The language pretrainer with scan_layers=True: JAX's scanned weights
    load into the port, and logits and gradients equal jax.grad's."""
    rng = np.random.RandomState(4)
    words = rng.randint(3, 100, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    kw = dict(num_encoders=ENC, text_dim=D, num_heads=2, ff_dropout=0.0,
              scan_layers=True)
    jmodel = j_language(embedding=JEmb(**EMB), **kw)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(5), jnp.asarray(words),
                                  jnp.asarray(mask))["params"]
    assert "languageEncoders_scan" in params
    cot = rng.randn(B, S, EMB["vocab_size"]).astype(np.float32)

    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(words),
                           jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, want_out), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, jgrads)).items() if not k.endswith("freqs")}
    port = models.meant_language_pretrainer(
        embedding=models.EmbeddingConfig(**EMB), device="cpu", **kw)
    load_jax_params(port, jax.tree.map(np.asarray, params))
    port.train()
    out = port(torch.as_tensor(words), torch.as_tensor(mask))
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-4, atol=1e-4)
    _assert_grads({n: p.grad.numpy() for n, p in port.named_parameters()},
                  want, "scanned pretrainer")


def test_stack_and_unstack_equal_jax():
    """The numpy stack/unstack of the port give JAX's trees."""
    rng = np.random.RandomState(0)
    f32 = lambda *shape: rng.randn(*shape).astype(np.float32)
    tree = {f"languageEncoders_{i}": {"attn": {"q": {"dense": {
        "kernel": f32(3, 4), "bias": f32(4)}}}} for i in range(3)}
    tree["embedding"] = {"x": f32(2)}
    got = stack.stack_encoder_params(tree, "languageEncoders", 3)
    want = jax.tree.map(np.asarray, jstack.stack_encoder_params(
        tree, "languageEncoders", 3))
    jax.tree.map(np.testing.assert_array_equal, got, want)
    back = stack.unstack_encoder_params(got, "languageEncoders")
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    with pytest.raises(KeyError):
        stack.unstack_encoder_params(dict(got, languageEncoders_0={}),
                                     "languageEncoders")


@pytest.mark.parametrize("remat,scan", [("full", False), ("dots", False),
                                        (False, True)])
def test_remat_gradients_are_bit_equal_with_dropout(remat, scan):
    """Dropout on (the embedding's 0.1, the blocks' 0.5) at one seed:
    gradients under remat are those without, bit for bit, and the flash
    forward runs again in the backward under either policy."""
    emb = models.EmbeddingConfig(**dict(EMB, dropout=0.1))
    batch = _batch(1)
    out = {}
    for key, kw in (("off", {}), ("on", dict(remat=remat,
                                             scan_layers=scan))):
        model = models.meant_src(embedding=emb, flash=True, device="cpu",
                                 seed=2, **kw, **GEOM)
        seed_dropout(torch.device("cpu"), 11)
        with _FlashCount() as count:
            out[key] = _port_grads(model, batch)
        out[key] += (count.n,)
    np.testing.assert_array_equal(out["on"][0], out["off"][0])
    for name, g in out["off"][1].items():
        np.testing.assert_array_equal(out["on"][1][name], g, err_msg=name)
    assert out["off"][2] == 2 * ENC and out["on"][2] == 4 * ENC


def test_remat_runs_only_in_training_with_gradients():
    model = models.meant_src(embedding=models.EmbeddingConfig(**EMB),
                             flash=True, remat="dots", device="cpu", **GEOM)
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    for train, grad in ((False, True), (True, False)):
        model.train(train)
        with torch.set_grad_enabled(grad), _FlashCount() as count:
            out = model(**batch)
            if out.requires_grad:
                out.sum().backward()
        assert count.n == 2 * ENC


def test_flash_per_tower_routes_as_jax():
    """flash_text=False, flash_vision=True: the language tower takes the
    plain attention (with its mask), the vision tower the flash op; None
    follows `flash` (meant_tpu/models/meant_src.py:102-105)."""
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    make = lambda **kw: models.meant_src(
        embedding=models.EmbeddingConfig(**EMB), device="cpu", seed=1,
        **kw, **GEOM).eval()
    split = make(flash=True, flash_text=False, flash_vision=True)
    assert [e.attn.flash for e in split.languageEncoders] == [False] * ENC
    assert [e.attn.flash for e in split.visionEncoders] == [True] * ENC
    with torch.no_grad(), _FlashCount() as count:
        got = split(**batch)
    assert count.n == ENC
    with torch.no_grad():
        want = make(flash=False)(**batch)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    follow = make(flash=True, flash_vision=False)
    assert [e.attn.flash for e in follow.languageEncoders] == [True] * ENC
    assert [e.attn.flash for e in follow.visionEncoders] == [False] * ENC


@pytest.mark.parametrize("spec", ["bogus", "Full", 2])
def test_bad_remat_spec_raises(spec):
    with pytest.raises(ValueError):
        stack.remat_spec(spec)
    with pytest.raises(ValueError):
        models.meant_src(embedding=models.EmbeddingConfig(**EMB),
                         remat=spec, device="cpu", **GEOM)
    with pytest.raises(ValueError):
        jstack._remat_kwargs(spec)


TINY = ["-rid", "t", "--device", "cpu", "-nec", "1", "--seq_len", "12",
        "--image_size", "32", "--text_dim", "32", "--image_dim", "32",
        "--num_heads", "4", "--vocab_size", "64"]


def test_cli_levers_reach_the_model():
    """As JAX's test_cli_plumbs_scan_layers_and_remat: the flags reach the
    model; a model outside SCAN_MODELS refuses them."""
    model = build_model(base_parser().parse_args(
        TINY + ["-mn", "meant_src", "--scan_layers", "--remat", "dots"]))
    assert model.scan_layers is True and model.remat == "dots"
    assert model.visionEncoders.remat == "dots"
    model = build_model(base_parser().parse_args(TINY + ["--remat"]))
    assert model.remat == "full" and model.languageEncoders.remat == "full"
    model = build_model(base_parser().parse_args(
        TINY + ["-mn", "meant_tweet", "--scan_layers"]))
    assert model.scan_layers is True
    assert model.languageEncoders.remat == "dots"
    with pytest.raises(SystemExit):
        build_model(base_parser().parse_args(
            TINY + ["-mn", "teanet", "--scan_layers"]))
