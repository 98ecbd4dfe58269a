"""The port's TempStock-small data path on the CPU against the JAX
package: the loaders, the positional batch dispatch, and the CLIs
(`in_loop_train` / `eval` with `--data_dir`, `serve`) running the paper
generation end to end at a tiny width."""

import os

import numpy as np
import pytest
import torch

from meant_tpu.cli.serve import _synthetic_batch as j_synthetic_batch
from meant_tpu.data.datasets import load_tempstock_small as j_load
from meant_tpu.data.datasets import synthetic_tempstock as j_synthetic
from meant_tpu.train.classify import model_inputs as j_model_inputs
from meant_tpu_torch import models
from meant_tpu_torch.cli import eval as eval_cli
from meant_tpu_torch.cli import in_loop_train
from meant_tpu_torch.cli import serve as serve_cli
from meant_tpu_torch.cli.common import (PAPER_MODELS, base_parser,
                                        build_model, synthetic_batch)
from meant_tpu_torch.data.datasets import (load_tempstock_small,
                                           synthetic_tempstock)
from meant_tpu_torch.serve import Predictor
from meant_tpu_torch.train.classify import POSITIONAL_MODELS, model_inputs

TINY = ["-nec", "1", "--seq_len", "12", "--image_size", "32", "--text_dim",
        "32", "--image_dim", "32", "--vocab_size", "128", "--num_heads",
        "4", "-tb", "4", "--device", "cpu"]


def _write_tempstock(path, n=20, lag=5, seq=12, size=32, seed=0):
    """A TempStock-small set in its layout: graphs (n, lag, 4, size, size)
    fp32, tweets (n, lag, seq) int64 with trailing pad id 1 where the
    attention mask is 0, macds (n, lag, 4), y_resampled (n,)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, seq + 1, size=(n, lag))
    masks = (np.arange(seq) < lengths[..., None]).astype(np.float32)
    tweets = np.where(masks > 0, rng.randint(2, 100, (n, lag, seq)), 1)
    arrays = {"graphs": rng.randn(n, lag, 4, size, size).astype(np.float32)
              + 0.5,
              "tweets": tweets.astype(np.int64), "attention_masks": masks,
              "macds": rng.randn(n, lag, 4).astype(np.float32),
              "y_resampled": rng.randint(0, 2, (n,)).astype(np.int64)}
    for name, a in arrays.items():
        np.save(os.path.join(path, f"{name}_{lag}.npy"), a)
    return arrays


@pytest.mark.parametrize("normalize", [False, True])
def test_load_tempstock_small_matches_jax(tmp_path, normalize):
    _write_tempstock(str(tmp_path))
    got = load_tempstock_small(str(tmp_path), "_5", normalize=normalize)
    want = j_load(str(tmp_path), "_5", normalize=normalize)
    assert list(got) == list(want) == ["graphs", "tweets", "attention_masks",
                                       "macds", "y"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert abs(float(got["graphs"].mean())) < (1e-5 if normalize else 1.0)
    assert normalize or float(got["graphs"].mean()) > 0.4


@pytest.mark.parametrize("kw", [dict(n=8), dict(n=7, lag=3, seq=9, channels=2,
                                             size=16, vocab=50, seed=4),
                                dict(n=9, learnable=False, size=8)])
def test_synthetic_tempstock_bit_for_bit(kw):
    got, want = synthetic_tempstock(**kw), j_synthetic(**kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", POSITIONAL_MODELS + ("meant_src",))
def test_model_inputs_match_jax(name):
    batch = j_synthetic(n=3, seq=6, size=8)
    batch["prices"] = np.ones((3, 5, 4), np.float32)
    if name == "meant_src":
        batch = {"input_ids": batch["tweets"], "pixels": batch["graphs"],
                 "prices": batch["prices"],
                 "attention_mask": batch["attention_masks"], "y": batch["y"]}
    got_a, got_kw = model_inputs(name, batch)
    want_a, want_kw = j_model_inputs(name, batch)
    assert len(got_a) == len(want_a) and set(got_kw) == set(want_kw)
    for a, b in zip(got_a, want_a):
        np.testing.assert_array_equal(a, b)
    for k in want_kw:
        np.testing.assert_array_equal(got_kw[k], want_kw[k])


def test_meantPrice_reads_prices_that_tempstock_small_lacks():
    """As in JAX, meantPrice's inputs need `prices`, which TempStock-small
    does not hold: both dispatches raise a KeyError."""
    batch = j_synthetic(n=2, seq=4, size=8)
    with pytest.raises(KeyError):
        j_model_inputs("meantPrice", batch)
    with pytest.raises(KeyError):
        model_inputs("meantPrice", batch)


@pytest.mark.parametrize("name", PAPER_MODELS + ("meant_src",))
def test_serving_batch_is_jax_synthetic_batch(name):
    """The synthetic serving batch of each ported name is the JAX serving
    CLI's, array for array (the port adds labels `y`)."""
    args = base_parser().parse_args(TINY + ["-rid", "0", "-mn", name,
                                            "--synthetic_n", "6"])
    got = synthetic_batch(args, args.synthetic_n)
    assert got.pop("y").shape == (6,)
    want = j_synthetic_batch(args)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_trains_meant_on_data_dir_and_eval_agrees(tmp_path):
    """cli.in_loop_train -mn meant --flash true --data_dir trains one epoch
    on the CPU, saves and tests; cli.eval on its checkpoint gives the same
    confusion matrix, and Predictor serves the trained probabilities."""
    data = tmp_path / "data"
    data.mkdir()
    arrays = _write_tempstock(str(data))
    argv = TINY + ["-rid", "ts", "-mn", "meant", "--flash", "true",
                   "--data_dir", str(data), "-ne", "1", "-fp",
                   str(tmp_path), "-lrst", "constant", "-l", "1e-3"]
    results = in_loop_train.main(argv)
    trainer = results["trainer"]
    assert isinstance(trainer.model, models.meant)
    assert trainer.optimizer.step_count == 3      # 12 train rows / 4
    assert np.isfinite(results["history"][0]["train_loss"])
    path = results["checkpoint"]
    assert path == str(tmp_path / "models" / "meant" /
                       "meant_1_Tempstock_ts_1")
    assert sum(map(sum, results["test"]["confusion"])) == 4
    metrics = eval_cli.main(argv + ["-ptm", path])
    assert metrics["confusion"] == results["test"]["confusion"]
    assert metrics["f1_macro"] == results["test"]["f1_macro"]
    rows = {k: arrays[k][:6] for k in ("tweets", "graphs",
                                       "attention_masks")}
    trained = Predictor(trainer.model, "meant", batch_size=4,
                        device="cpu")(rows)
    served = Predictor(build_model(base_parser().parse_args(argv)), "meant",
                       checkpoint_path=path, batch_size=4,
                       device="cpu")(rows)
    assert trained.shape == (6, 2)
    np.testing.assert_array_equal(served, trained)


def test_cli_trains_meant_without_data_dir_on_synthetic_tempstock(tmp_path):
    argv = TINY + ["-rid", "syn", "-ne", "1", "--synthetic_n", "12",
                   "-fp", str(tmp_path), "-testm", "false"]
    results = in_loop_train.main(argv)
    assert isinstance(results["trainer"].model, models.meant)
    assert results["trainer"].optimizer.step_count == 1   # 7 rows / 4


def test_serve_cli_serves_meant_on_its_synthetic_batch_and_an_npz(tmp_path):
    argv = TINY + ["-rid", "s", "-mn", "meant", "--synthetic_n", "6",
                   "--serve_batch", "4"]
    probs = serve_cli.main(argv)
    assert probs.shape == (6, 2) and np.isfinite(probs).all()
    args = serve_cli.serve_parser().parse_args(argv)
    batch = j_synthetic_batch(args)
    path = tmp_path / "batch.npz"
    np.savez(path, **batch)
    np.testing.assert_array_equal(serve_cli.main(argv + ["--input",
                                                         str(path)]), probs)


def test_predictor_serves_meant_padded_as_direct():
    """Predictor needs no change beyond model_inputs: 7 rows at batch 4 (the
    last request padded) give the model's own outputs."""
    args = base_parser().parse_args(TINY + ["-rid", "p", "-mn", "meant"])
    model = build_model(args).eval()
    batch = synthetic_batch(args, 7)
    del batch["y"]
    probs = Predictor(model, "meant", batch_size=4, device="cpu")(batch)
    with torch.no_grad():
        direct = model(torch.as_tensor(batch["tweets"]).long(),
                       torch.as_tensor(batch["graphs"]),
                       attention_mask=torch.as_tensor(
                           batch["attention_masks"]))
    np.testing.assert_allclose(probs, direct.float().numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name,cls", [
    ("meant", models.meant), ("meant_vision", models.meant_vision),
    ("meant_tweet", models.meant_tweet),
    ("meant_tweet_no_lag", models.meant_tweet_no_lag),
    ("meantPrice", models.meantPrice), ("meant_vqa", models.meant_vqa)])
def test_build_model_builds_each_paper_name(name, cls):
    args = base_parser().parse_args(TINY + ["-rid", "b", "-mn", name])
    model = build_model(args)
    assert type(model) is cls
    assert next(model.parameters()).device.type == "cpu"


def test_default_model_is_meant_on_the_card(monkeypatch):
    """No -mn builds meant, the CLI's default; without --device it needs
    the card."""
    args = base_parser().parse_args(["-rid", "0"] + TINY[:-2])
    assert args.model_name == "meant" and args.device is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        in_loop_train.main(["-rid", "0"] + TINY[:-2])


def test_meant_src_refuses_data_dir(tmp_path):
    """TempStock-small holds no array meant_src reads."""
    _write_tempstock(str(tmp_path))
    argv = TINY + ["-rid", "x", "-mn", "meant_src", "--data_dir",
                   str(tmp_path)]
    with pytest.raises(ValueError, match="meant_src"):
        in_loop_train.main(argv)
    with pytest.raises(ValueError, match="meant_src"):
        eval_cli.main(argv)


def test_model_inputs_refuses_meant_vqa_in_both_packages():
    """meant_vqa builds, but trains only through its own harness
    (cli/vqa.py): the classification dispatch refuses it, as JAX's
    does."""
    args = base_parser().parse_args(TINY + ["-rid", "v", "-mn", "meant_vqa"])
    assert isinstance(build_model(args), models.meant_vqa)
    with pytest.raises(NotImplementedError):
        model_inputs("meant_vqa", synthetic_batch(args, 2))
    with pytest.raises(ValueError):
        j_model_inputs("meant_vqa", synthetic_batch(args, 2))
