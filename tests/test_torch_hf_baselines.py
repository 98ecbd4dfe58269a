"""The port's VisualBERT and ViLT backbones and their wrappers
(meant_tpu_torch/nn/hf_baselines.py, nn/roberta.py) against the JAX package
on the CPU: the align-corners resize (12 -> 7, an equal grid, and against
`F.interpolate`), ViLT's patch conv against Flax's, BertTextEmbeddings,
VisualBertModel with the wrappers' all-zero text mask, ViltModel on a
resized position grid, vl_BERT_Wrapper and ViltWrapper probabilities, one
step's gradients of both wrappers,
ViLT's 40-token limit in both packages, and the CLI of `-mn bertweet`,
`vl_bert` and `vilt` (build_model against JAX's, a training epoch through
cli.in_loop_train, cli.serve against JAX's serving CLI).

The same numpy inputs and JAX's params (through `weights.load_jax_params`,
which must use every leaf) go through both packages in fp32. Bars: the
resize 1e-6, module outputs 1e-5, wrapper probabilities 1e-4, gradients
1e-4 relative L2 per parameter; in bf16 (products in bf16, norms in fp32
in both packages) probabilities 2e-2 absolute and finite gradients.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from meant_tpu.cli import serve as j_serve_cli
from meant_tpu.cli.common import base_parser as j_parser
from meant_tpu.cli.common import build_model as j_build_model
from meant_tpu.cli.serve import _synthetic_batch as j_synthetic_batch
from meant_tpu.nn import hf_baselines as JH
from meant_tpu.nn import roberta as JR
from meant_tpu.train.classify import model_inputs as j_model_inputs
from meant_tpu_torch.cli import in_loop_train
from meant_tpu_torch.cli import serve as serve_cli
from meant_tpu_torch.cli.common import (base_parser, build_model,
                                        synthetic_batch)
from meant_tpu_torch.nn import hf_baselines as PH
from meant_tpu_torch.nn import roberta as PR
from meant_tpu_torch.serve import Predictor
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.classify import model_inputs
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

B, S, D, H, VOCAB, IMG = 2, 16, 64, 4, 200, 64
SMALL = dict(input_dim=D, vocab_size=VOCAB, num_layers=2, num_heads=H)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ids(seed=0, s=S):
    return np.random.RandomState(seed).randint(2, VOCAB, (B, s)).astype(
        np.int32)


def _images(seed=0, size=IMG):
    return np.random.RandomState(seed).randn(B, 4, size, size).astype(
        np.float32)


def _jax(module, *args, **kwargs):
    a = [jnp.asarray(x) for x in args]
    params = jax.jit(lambda *t: module.init(jax.random.PRNGKey(2), *t,
                                            **kwargs))(*a)["params"]
    out = jax.jit(lambda p, *t: module.apply({"params": p}, *t,
                                             **kwargs))(params, *a)
    return _np(params), jax.tree.map(lambda t: np.asarray(t, np.float32),
                                     out)


def _port(module, params, *args, **kwargs):
    load_jax_params(module, params)
    module.eval()
    with torch.no_grad():
        out = module(*(torch.as_tensor(x) for x in args),
                     **{k: torch.as_tensor(v) for k, v in kwargs.items()})
    if isinstance(out, tuple):
        return tuple(o.float().numpy() for o in out)
    return out.float().numpy()


@pytest.mark.parametrize("grid,out", [((12, 12), (7, 7)), ((7, 7), (7, 7)),
                                      ((5, 9), (3, 1))])
def test_resize_align_corners_matches_jax(grid, out):
    x = np.random.RandomState(1).randn(D, *grid).astype(np.float32)
    want = np.asarray(JH._resize_bilinear_align_corners(jnp.asarray(x),
                                                        *out))
    got = PH._resize_bilinear_align_corners(torch.as_tensor(x), *out)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if out != (3, 1):       # torch's own resize, where its grid agrees
        lib = F.interpolate(torch.as_tensor(x)[None], size=out,
                            mode="bilinear", align_corners=True)[0]
        np.testing.assert_allclose(got.numpy(), lib.numpy(), atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 64), (70, 45)])
def test_patch_conv_matches_flax_conv(hw):
    """ViLT's patch projection: Flax's nn.Conv (k = s = 32, "SAME"
    padding, which pads a size that 32 does not divide) against the
    port's Conv on NCHW input at the carried-over kernel."""
    from flax import linen as nn
    x = np.random.RandomState(17).randn(B, 4, *hw).astype(np.float32)
    jm = nn.Conv(D, (32, 32), strides=(32, 32))
    params = _np(jm.init(jax.random.PRNGKey(0), x.transpose(0, 2, 3, 1))
                 ["params"])
    want = np.asarray(jm.apply({"params": params},
                               x.transpose(0, 2, 3, 1))).transpose(0, 3, 1, 2)
    holder = torch.nn.Module()
    holder.patch_projection = PH.Conv(D, 4, 32, device="cpu")
    load_jax_params(holder, {"patch_projection": params})
    with torch.no_grad():
        got = holder.patch_projection(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("apply_norm", [False, True])
def test_bert_text_embeddings_match_jax(apply_norm):
    ids = _ids(2)
    types = np.random.RandomState(3).randint(0, 2, ids.shape).astype(
        np.int32)
    jm = JH.BertTextEmbeddings(VOCAB, D, 40, apply_norm=apply_norm)
    params, want = _jax(jm, ids, types)
    pm = PH.BertTextEmbeddings(VOCAB, D, 40, apply_norm=apply_norm,
                               device="cpu")
    got = _port(pm, params, ids, types)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_visual_bert_model_with_zero_text_mask_matches_jax():
    """The wrapper's inputs: an all-zero text mask (text queries attend
    to the visual keys only) and token-type ones."""
    ids = _ids(4)
    visual = np.random.RandomState(5).randn(B, 16, 48).astype(np.float32)
    kw = dict(attention_mask=np.zeros(ids.shape, np.float32),
              token_type_ids=np.ones(ids.shape, np.int32),
              visual_embeds=visual)
    jm = JH.VisualBertModel(vocab_size=VOCAB, hidden_size=D, num_layers=2,
                            num_heads=H, intermediate_size=4 * D,
                            visual_embedding_dim=48)
    params, (hidden, pooled) = _jax(jm, ids, **kw)
    pm = PH.VisualBertModel(vocab_size=VOCAB, hidden_size=D, num_layers=2,
                            num_heads=H, intermediate_size=4 * D,
                            visual_embedding_dim=48, device="cpu")
    got_hidden, got_pooled = _port(pm, params, ids, **kw)
    np.testing.assert_allclose(got_hidden, hidden, atol=1e-5)
    np.testing.assert_allclose(got_pooled, pooled, atol=1e-5)


def test_vilt_model_on_a_resized_grid_matches_jax():
    """The position table is drawn for a 12 x 12 grid (384 / 32) and
    resized to the input's 2 x 2 (64 / 32); its zero init is replaced by a
    random one so the resize shows."""
    ids, images = _ids(6), _images(7)
    jm = JH.ViltModel(vocab_size=VOCAB, hidden_size=D, num_layers=2,
                      num_heads=H, intermediate_size=4 * D, num_channels=4)
    params, _ = _jax(jm, ids, images)
    rng = np.random.RandomState(8)
    params = dict(params, position_embeddings=rng.randn(
        *params["position_embeddings"].shape).astype(np.float32),
        cls_token=rng.randn(1, 1, D).astype(np.float32))
    assert params["position_embeddings"].shape == (1, 12 * 12 + 1, D)
    assert params["patch_projection"]["kernel"].shape == (32, 32, 4, D)
    hidden, pooled = (np.asarray(t) for t in jax.jit(
        lambda p: jm.apply({"params": p}, jnp.asarray(ids),
                           jnp.asarray(images)))(params))
    pm = PH.ViltModel(vocab_size=VOCAB, hidden_size=D, num_layers=2,
                      num_heads=H, intermediate_size=4 * D, num_channels=4,
                      device="cpu")
    got_hidden, got_pooled = _port(pm, params, ids, images)
    assert got_hidden.shape == (B, S + 2 * 2 + 1, D)
    np.testing.assert_allclose(got_hidden, hidden, atol=1e-5)
    np.testing.assert_allclose(got_pooled, pooled, atol=1e-5)


WRAPPERS = {
    "vl_bert": (lambda: JR.vl_BERT_Wrapper(visual_embed_dim=96, **SMALL),
                lambda **kw: PR.vl_BERT_Wrapper(visual_embed_dim=96,
                                                device="cpu", **SMALL, **kw)),
    "vilt": (lambda: JR.ViltWrapper(**SMALL),
             lambda **kw: PR.ViltWrapper(device="cpu", **SMALL, **kw)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_probabilities_match_jax(name):
    make_j, make_p = WRAPPERS[name]
    ids, images = _ids(9), _images(10)
    params, want = _jax(make_j(), ids, images)
    sd = state_dict_from_jax(params)
    assert set(sd) == set(make_p().state_dict())      # every leaf, one key
    got = _port(make_p(), params, ids, images)
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_gradients_match_jax_grad(name):
    """One step's gradients, dropout off, through the finfo.min masks: no
    NaN, and each within 1e-4 relative L2 of jax.grad's. The key biases'
    gradient is zero in exact arithmetic (the softmax ignores a shift
    shared by every key): both packages leave only rounding there."""
    make_j, make_p = WRAPPERS[name]
    ids, images = _ids(11), _images(12)
    jm = make_j()
    params = _np(jax.jit(lambda a, b: jm.init(jax.random.PRNGKey(4), a,
                                              b))(ids, images)["params"])
    grads = jax.jit(jax.grad(lambda p: jnp.sum(
        jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(images))
        * jnp.arange(1.0, 3.0))))(params)
    want = state_dict_from_jax(_np(grads))
    pm = make_p()
    load_jax_params(pm, params)
    pm.eval()
    (pm(torch.as_tensor(ids), torch.as_tensor(images))
     * torch.arange(1.0, 3.0)).sum().backward()
    for key, p in pm.named_parameters():
        got = p.grad.numpy()
        assert np.isfinite(got).all(), key
        ref = want[key].numpy()
        if key.endswith("key.bias"):
            assert max(np.abs(got).max(), np.abs(ref).max()) < 1e-6, key
            continue
        assert np.linalg.norm(got - ref) <= (
            1e-4 * np.linalg.norm(ref) + 1e-8), key


def test_vilt_takes_at_most_40_tokens_in_both_packages():
    """ViLT's text position table has 40 rows: 40 tokens run, 41 raise in
    JAX (a broadcast TypeError) and in the port (a ValueError naming the
    table)."""
    images = _images(13)
    jm = JR.ViltWrapper(**SMALL)
    params, _ = _jax(jm, _ids(14, 40), images)
    _port(PR.ViltWrapper(device="cpu", **SMALL), params, _ids(14, 40),
          images)
    with pytest.raises(TypeError):
        jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(
            params, _ids(14, 41), images)
    with pytest.raises(ValueError, match="40 rows"):
        _port(PR.ViltWrapper(device="cpu", **SMALL), params, _ids(14, 41),
              images)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_bf16_match_jax_with_finite_gradients(name):
    """dtype=bf16: the finfo.min fill of the zero text mask is bf16's
    lowest value; the softmax's gradient through it stays finite."""
    make_j, make_p = WRAPPERS[name]
    ids, images = _ids(15), _images(16)
    jm = make_j().clone(dtype=jnp.bfloat16)
    params, want = _jax(jm, ids, images)
    pm = make_p(dtype=torch.bfloat16)
    got = _port(pm, params, ids, images)
    np.testing.assert_allclose(got, want, atol=2e-2)
    pm.train()
    pm(torch.as_tensor(ids), torch.as_tensor(images)).float().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in pm.parameters())


# ---- the CLI ----------------------------------------------------------------

HF_NAMES = ["bertweet", "vl_bert", "vilt"]
CLI_TINY = ["-nec", "1", "--seq_len", "12", "--image_size", "64",
            "--text_dim", "32", "--image_dim", "32", "--vocab_size", "128",
            "--num_heads", "4", "--bf16", "false"]


def _jax_cli_params(name, argv):
    """JAX's build_model and the params its serving CLI draws (PRNGKey(0)
    over its synthetic batch), with that batch."""
    jargs = j_parser().parse_args(argv)
    jm = j_build_model(jargs)
    batch = j_synthetic_batch(jargs)
    a, kw = j_model_inputs(name, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    return jm, _np(jm.init(jax.random.PRNGKey(0), *a, **kw)["params"]), \
        batch


@pytest.mark.parametrize("name", HF_NAMES)
def test_build_model_matches_jax_cli(name):
    """build_model of both packages at the same flags: JAX's params load
    strictly into the port's model and the probabilities on the target
    day agree within 1e-4."""
    argv = CLI_TINY + ["-rid", "0", "-mn", name, "--synthetic_n", "3"]
    jm, params, batch = _jax_cli_params(name, argv)
    a, kw = j_model_inputs(name, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    want = np.asarray(jm.apply({"params": params}, *a, **kw))
    port = build_model(base_parser().parse_args(argv + ["--device", "cpu"]))
    assert type(port).__name__ == type(jm).__name__
    load_jax_params(port, params)
    port.eval()
    pa, pkw = model_inputs(name, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    with torch.no_grad():
        got = port(*pa, **pkw).numpy()
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("name", HF_NAMES)
def test_cli_trains_and_serves_its_checkpoint(name, tmp_path):
    """cli.in_loop_train trains one epoch of the synthetic TempStock set
    (the target day's tweets, and charts), saves and tests; cli.serve
    --checkpoint serves the trained model's own probabilities."""
    argv = CLI_TINY + ["-rid", "hf", "-mn", name, "--device", "cpu"]
    results = in_loop_train.main(argv + [
        "--synthetic_n", "20", "-tb", "4", "-ne", "1", "-fp", str(tmp_path),
        "-lrst", "constant"])
    trainer = results["trainer"]
    assert np.isfinite(results["history"][0]["train_loss"])
    assert trainer.optimizer.step_count == 3                # 12 rows / 4
    args = base_parser().parse_args(argv + ["--synthetic_n", "5"])
    batch = synthetic_batch(args, 5)
    del batch["y"]
    trained = Predictor(trainer.model, name, batch_size=4,
                        device="cpu")(batch)
    npz = tmp_path / "batch.npz"
    np.savez(npz, **batch)
    served = serve_cli.main(argv + ["--checkpoint", results["checkpoint"],
                                    "--input", str(npz), "--serve_batch",
                                    "4"])
    assert served.shape == (5, 2)
    np.testing.assert_array_equal(served, trained)


@pytest.mark.parametrize("name", HF_NAMES)
def test_serve_cli_matches_jax_serve_cli(name, tmp_path):
    """The JAX serving CLI's weights (PRNGKey(0)), written as a port
    checkpoint, served by the port's CLI on the same synthetic request:
    JAX's probabilities within 1e-4."""
    argv = CLI_TINY + ["-rid", "0", "-mn", name, "--synthetic_n", "5"]
    _, params, _ = _jax_cli_params(name, argv)
    argv += ["--serve_batch", "4"]
    want = j_serve_cli.main(argv)
    path = str(tmp_path / "models" / name / "jax")
    ckpt.save(path, {"params": state_dict_from_jax(params), "step": 0})
    got = serve_cli.main(argv + ["--device", "cpu", "--checkpoint", path])
    assert got.shape == want.shape == (5, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
