"""The rest of the src zoo in the port against the JAX package on the CPU:
meantTweetPrice, meant_price, mlpEncoder, LSTMEncoder, teanet, meant_v2,
the xPos attention's `causal` / `rot_dim`, LanguageEncoder's
`mask_in_flash`, TemporalAttention2, and the CLIs of all eight newly
ported --model_name values.

The same numpy inputs and JAX's params (carried over by
`weights.load_jax_params`) go through both packages in fp32. Bars:
probabilities and module outputs 1e-4 absolute (1e-4 relative and 1e-5
absolute where the flash path runs: JAX's interpret-mode Pallas kernel
against the port's plain version), one step's gradients 1e-4 relative L2
per parameter (plus 1e-8 absolute for an exactly zero gradient).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu import models as J
from meant_tpu.cli.common import base_parser as j_parser
from meant_tpu.cli.common import build_model as j_build_model
from meant_tpu.cli.serve import _synthetic_batch as j_synthetic_batch
from meant_tpu.nn.attention_modules import TemporalAttention2 as JTemporal2
from meant_tpu.nn.attention_modules import XPosAttention as JXPos
from meant_tpu.nn.encoders import LanguageEncoder as JLanguageEncoder
from meant_tpu.train.classify import model_inputs as j_model_inputs
from meant_tpu.train.classify import sigmoid_ce_loss as j_loss
from meant_tpu_torch import models as P
from meant_tpu_torch.cli import in_loop_train
from meant_tpu_torch.cli import serve as serve_cli
from meant_tpu_torch.cli.common import (SCAN_MODELS, base_parser,
                                        build_model, synthetic_batch)
from meant_tpu_torch.nn.attention_modules import (TemporalAttention2,
                                                  XPosAttention)
from meant_tpu_torch.nn.encoders import LanguageEncoder
from meant_tpu_torch.train.classify import (model_inputs, row_outputs,
                                            sigmoid_ce_loss)
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

B, LAG, S = 2, 5, 48
JEMB = J.EmbeddingConfig(vocab_size=100, hidden_size=192,
                         max_position_embeddings=40, dropout=0.0)
PEMB = P.EmbeddingConfig(vocab_size=100, hidden_size=192,
                         max_position_embeddings=40, dropout=0.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax(module, *args, **kwargs):
    """JAX params (numpy) and output of `module` on numpy inputs."""
    a = [jnp.asarray(x) for x in args]
    kw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    params = module.init(jax.random.PRNGKey(3), *a, **kw)["params"]
    out = jax.jit(lambda p: module.apply({"params": p}, *a, **kw))(params)
    return _np(params), np.asarray(out, np.float32)


def _port(module, params, *args, **kwargs):
    load_jax_params(module, params)
    module.eval()
    with torch.no_grad():
        out = module(*(torch.as_tensor(x) for x in args),
                     **{k: torch.as_tensor(v) for k, v in kwargs.items()})
    return out.float().numpy()


def _prices(seed=0, width=5):
    return np.random.RandomState(seed).randn(B, LAG, width).astype(
        np.float32)


def _tweets(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 100, (B, LAG, S)).astype(np.int32)
    ids[0, 1, 30:] = 1                          # padding: pad id 1
    return ids, (ids != 1).astype(np.float32)


PRICE_CASES = {
    "meant_price": (lambda: J.meant_price(5, LAG, 2),
                    lambda: P.meant_price(5, LAG, 2, device="cpu")),
    "mlp": (lambda: J.mlpEncoder(5, 2, 32, 3),
            lambda: P.mlpEncoder(5, 2, 32, 3, device="cpu")),
    "lstm_quirk": (lambda: J.LSTMEncoder(5, 2, 32, 2),
                   lambda: P.LSTMEncoder(5, 2, 32, 2, device="cpu")),
    "lstm_over_lag": (
        lambda: J.LSTMEncoder(5, 2, 32, 2, torch_axis_quirk=False),
        lambda: P.LSTMEncoder(5, 2, 32, 2, torch_axis_quirk=False,
                              device="cpu")),
}


@pytest.mark.parametrize("name", sorted(PRICE_CASES))
def test_price_models_match_jax(name):
    jcls, pcls = PRICE_CASES[name]
    prices = _prices()
    params, want = _jax(jcls(), prices=prices)
    got = _port(pcls(), params, prices=prices)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("quirk", [True, False])
def test_lstm_quirk_recurs_over_the_batch(quirk):
    """With the quirk the batch is the time axis: a change to row 0 (the
    first step) reaches row 1, and a change to row 1 never reaches row 0;
    over lag the rows are independent."""
    model = P.LSTMEncoder(5, 2, 16, 1, torch_axis_quirk=quirk,
                          device="cpu").eval()
    prices = torch.as_tensor(_prices())
    first, second = prices.clone(), prices.clone()
    first[0] += 1.0
    second[1] += 1.0
    with torch.no_grad():
        base, a, b = (model(prices=p) for p in (prices, first, second))
    assert torch.equal(base[1], a[1]) != quirk
    assert torch.equal(base[0], b[0])


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_tweet_price_matches_jax(flash):
    """meantTweetPrice at dim 192 in 2 heads of 96, 2 encoders, s=48 with
    padding (dropped on the flash path, as in JAX)."""
    tweets, mask = _tweets()
    kw = dict(embedding=None, num_heads=2, num_encoders=2, flash=flash)
    prices = _prices()
    params, want = _jax(J.meantTweetPrice(192, 5, LAG, 2, **dict(
        kw, embedding=JEMB)), tweets, prices, attention_mask=mask)
    got = _port(P.meantTweetPrice(192, 5, LAG, 2, device="cpu", **dict(
        kw, embedding=PEMB)), params, tweets, prices, attention_mask=mask)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_tweet_price_refuses_stacked_temporal_encoders():
    with pytest.raises(ValueError, match="one temporal encoder"):
        P.meantTweetPrice(32, 5, LAG, 2, num_temporal_encoders=2,
                          device="cpu")


@pytest.mark.parametrize("float_ids", [False, True], ids=["int", "float"])
def test_teanet_matches_jax(float_ids):
    tweets, _ = _tweets(1)
    if float_ids:
        tweets = tweets.astype(np.float32)
    macds = _prices(2, width=4)
    params, want = _jax(J.teanet(dim=64, num_heads=4, vocab_size=100,
                                 num_layers=2), tweets, macds)
    got = _port(P.teanet(dim=64, num_heads=4, vocab_size=100, num_layers=2,
                         device="cpu"), params, tweets, macds)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert {k for k in params["attn_0"]} == {"query", "key", "value", "out"}


def test_meant_v2_matches_jax():
    tweets, mask = _tweets(3)
    images = np.random.RandomState(4).randn(B, LAG, 4, 32, 32).astype(
        np.float32)
    geom = (192, 192, 4, 32, 32, 16, LAG, 2)
    params, want = _jax(J.meant_v2(*geom, embedding=JEMB, num_heads=2,
                                   num_encoders=2), tweets, images,
                        attention_mask=mask)
    got = _port(P.meant_v2(*geom, embedding=PEMB, num_heads=2,
                           num_encoders=2, device="cpu"), params, tweets,
                images, attention_mask=mask)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("rot_dim", [None, 30, 200])
def test_xpos_attention_causal_and_rot_dim(causal, rot_dim):
    """rot_dim follows min(rot_dim or 48, dh) (200 clamps to dh=96)."""
    x = np.random.RandomState(5).randn(B, S, 192).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[1, 20:] = 0
    params, want = _jax(JXPos(2, 192, causal=causal, rot_dim=rot_dim), x,
                        mask)
    module = XPosAttention(2, 192, causal=causal, rot_dim=rot_dim,
                           device="cpu")
    assert module.rot_dim == min(rot_dim or 48, 96)
    got = _port(module, params, x, mask)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mask_in_flash", [True, False],
                         ids=["mask_in_flash", "mask_dropped"])
def test_language_encoder_mask_in_flash(mask_in_flash, causal):
    """LanguageEncoder with flash=True and xPos on 30 features: JAX's
    interpret-mode kernel against the port's plain version, the padding
    mask handed to the kernel or dropped."""
    rng = np.random.RandomState(6)
    x = rng.randn(B * 2, S, 192).astype(np.float32)
    mask = np.ones((B * 2, S), np.float32)
    mask[0, 17:], mask[3, 40:] = 0, 0
    kw = dict(norm="layer", ff_norm2="rms", init_style="xavier", flash=True,
              mask_in_flash=mask_in_flash, causal=causal, rot_dim=30)
    params, want = _jax(JLanguageEncoder(192, 2, **kw), x, mask)
    got = _port(LanguageEncoder(192, 2, device="cpu", **kw), params, x, mask)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    unmasked = _port(LanguageEncoder(192, 2, device="cpu", **kw), params, x)
    assert np.allclose(unmasked, got) != mask_in_flash


def test_temporal_attention2_matches_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(B, LAG, 6, 40).astype(np.float32)
    mask = (rng.rand(B, LAG, 6) > 0.3).astype(np.float32)
    params, want = _jax(JTemporal2(4, 40, lag=LAG), x, mask)
    got = _port(TemporalAttention2(4, 40, lag=LAG, device="cpu"), params, x,
                mask)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_weights_refuse_an_unknown_or_extra_leaf():
    model = P.meant_price(5, LAG, 2, device="cpu")
    params, _ = _jax(J.meant_price(5, LAG, 2), prices=_prices())
    with pytest.raises(KeyError, match="no rule"):
        state_dict_from_jax(dict(params, stray={"thing": np.zeros(3)}))
    with pytest.raises(RuntimeError):
        load_jax_params(model, dict(params, extra={"kernel": np.zeros(
            (3, 2)), "bias": np.zeros(2)}))


def test_tweet_price_step_gradients_match_jax_grad():
    """One step's loss and gradients of meantTweetPrice (flash on, dropout
    off in both: JAX's deterministic apply, the port in eval mode) against
    jax.grad."""
    tweets, mask = _tweets(8)
    prices = _prices(9)
    y = np.array([0, 1], np.int32)
    kw = dict(num_heads=2, num_encoders=2, flash=True)
    jm = J.meantTweetPrice(192, 5, LAG, 2, embedding=JEMB, **kw)
    ja = (jnp.asarray(tweets), jnp.asarray(prices))
    params = jm.init(jax.random.PRNGKey(4), *ja,
                     attention_mask=jnp.asarray(mask))["params"]

    def loss_fn(p):
        return j_loss(jm.apply({"params": p}, *ja,
                               attention_mask=jnp.asarray(mask)),
                      jnp.asarray(y))

    j_value, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(_np(j_grads))
    model = P.meantTweetPrice(192, 5, LAG, 2, embedding=PEMB, device="cpu",
                              **kw)
    load_jax_params(model, _np(params))
    model.eval()
    loss = sigmoid_ce_loss(model(torch.as_tensor(tweets),
                                 torch.as_tensor(prices),
                                 attention_mask=torch.as_tensor(mask)),
                           torch.as_tensor(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=1e-6)
    named = dict(model.named_parameters())
    assert set(named) == {k for k in want if "freqs" not in k}
    for name, p in named.items():
        got, ref = p.grad.numpy(), want[name].numpy()
        assert (np.linalg.norm(got - ref)
                <= 1e-4 * np.linalg.norm(ref) + 1e-8), name


# ---- the CLI ----------------------------------------------------------------

NEW_NAMES = ["meant_tweet_price", "meant_price", "mlp", "lstm", "teanet",
             "meant_timesformer", "meant_mean_pooling", "meant_mosi"]
TINY = ["-nec", "1", "--seq_len", "12", "--image_size", "32", "--text_dim",
        "32", "--image_dim", "32", "--vocab_size", "128", "--num_heads",
        "4", "-di", "32", "-nl", "2", "--bf16", "false"]


@pytest.mark.parametrize("name", NEW_NAMES)
def test_build_model_matches_jax_cli(name):
    """build_model of both packages at the same flags: JAX's params load
    strictly into the port's model and the forwards agree within 1e-4 on
    the serving CLI's synthetic batch."""
    argv = TINY + ["-rid", "0", "-mn", name, "--synthetic_n", "3"]
    jargs = j_parser().parse_args(argv)
    jm = j_build_model(jargs)
    batch = j_synthetic_batch(jargs)
    a, kw = j_model_inputs(name, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    params = jm.init(jax.random.PRNGKey(0), *a, **kw)["params"]
    want = np.asarray(jm.apply({"params": params}, *a, **kw))
    port = build_model(base_parser().parse_args(argv + ["--device", "cpu"]))
    load_jax_params(port, _np(params))
    port.eval()
    pa, pkw = model_inputs(name, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    with torch.no_grad():
        got = port(*pa, **pkw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    sb = synthetic_batch(base_parser().parse_args(argv), 3)
    assert sorted(k for k in sb if k != "y") == sorted(batch)


@pytest.mark.parametrize("name", NEW_NAMES)
def test_scan_flags_refused_as_jax_refuses_them(name):
    argv = TINY + ["-rid", "0", "-mn", name, "--scan_layers", "--device",
                   "cpu"]
    jax_refuses = port_refuses = False
    try:
        j_build_model(j_parser().parse_args(argv[:-2]))
    except SystemExit:
        jax_refuses = True
    try:
        build_model(base_parser().parse_args(argv))
    except SystemExit:
        port_refuses = True
    assert jax_refuses == port_refuses == (name not in SCAN_MODELS)


@pytest.mark.parametrize("name", NEW_NAMES)
def test_cli_trains_and_serves(name, tmp_path):
    """cli.in_loop_train trains one epoch of the synthetic set, saves and
    tests on the CPU; cli.serve serves its synthetic batch."""
    argv = TINY + ["-rid", "z", "-mn", name, "--device", "cpu"]
    results = in_loop_train.main(argv + [
        "--synthetic_n", "20", "-tb", "4", "-ne", "1", "-fp", str(tmp_path),
        "-lrst", "constant"])
    assert np.isfinite(results["history"][0]["train_loss"])
    assert results["trainer"].optimizer.step_count == 3     # 12 rows / 4
    assert os.path.exists(results["checkpoint"])
    probs = serve_cli.main(argv + ["--synthetic_n", "5", "--serve_batch",
                                   "4"])
    lead = (5, 5) if name in ("mlp", "lstm") else (5,)
    assert probs.shape == lead + (2,) and np.isfinite(probs).all()


def test_row_outputs_read_the_target_day():
    """Only the price baselines are cut to their last day; another model's
    (b, x, c) output reaches the loss whole, so a wrongly shaped output
    still fails there."""
    out = torch.arange(12.0).reshape(2, 3, 2)
    for name in ("mlp", "lstm"):
        assert torch.equal(row_outputs(name, out), out[:, -1])
    assert torch.equal(row_outputs("meant_src", out), out)
    assert torch.equal(row_outputs("meant_src", out[:, 0]), out[:, 0])
    with pytest.raises(RuntimeError):
        sigmoid_ce_loss(row_outputs("meant_src", out),
                        torch.zeros(2, dtype=torch.int64))


def _write_tempstock(path, n=20, seq=12, size=32, seed=0):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, seq + 1, size=(n, LAG))
    masks = (np.arange(seq) < lengths[..., None]).astype(np.float32)
    arrays = {
        "graphs": rng.randn(n, LAG, 4, size, size).astype(np.float32),
        "tweets": np.where(masks > 0, rng.randint(2, 100, (n, LAG, seq)),
                           1).astype(np.int64),
        "attention_masks": masks,
        "macds": rng.randn(n, LAG, 4).astype(np.float32),
        "y_resampled": rng.randint(0, 2, (n,)).astype(np.int64)}
    for name, a in arrays.items():
        np.save(os.path.join(path, f"{name}_{LAG}.npy"), a)


def test_teanet_trains_on_tempstock_small(tmp_path):
    """-mn teanet --data_dir trains on the TempStock-small files (it reads
    their macds); meant_tweet_price needs prices they do not hold and
    raises a KeyError, as meantPrice does, and the kwargs family refuses
    --data_dir."""
    data = tmp_path / "data"
    data.mkdir()
    _write_tempstock(str(data))
    argv = TINY + ["-rid", "t", "--device", "cpu", "--data_dir", str(data),
                   "-tb", "4", "-ne", "1", "-fp", str(tmp_path), "-lrst",
                   "constant"]
    results = in_loop_train.main(argv + ["-mn", "teanet"])
    assert results["trainer"].optimizer.step_count == 3
    assert np.isfinite(results["history"][0]["train_loss"])
    with pytest.raises(KeyError):
        in_loop_train.main(argv + ["-mn", "meant_tweet_price"])
    with pytest.raises(ValueError, match="meant_price"):
        in_loop_train.main(argv + ["-mn", "meant_price"])
