"""The port's text-classification trainer and tweet_eval harness on the
CPU against the JAX package: `bce_loss`, the trainer's loss choice, one
step against the JAX trainer's loss, and `cli/tweet_eval.py` on its
synthetic set and on a `.csv` (read with the standard library where JAX
reads it with pandas: the same ids and labels on text split by spaces,
where JAX's native tokenizer and its numpy path agree).

Sizes: bertweet_wrapper at 2 layers, width 64 in 4 heads, s=12, vocab
200. Bars: the losses 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meant_tpu.cli.tweet_eval as j_cli
from meant_tpu.cli.common import base_parser as j_parser
from meant_tpu.nn.roberta import bertweet_wrapper as JBertweet
from meant_tpu.train.classify import sigmoid_ce_loss as j_ce
from meant_tpu.train.text_classify import bce_loss as j_bce
from meant_tpu_torch.cli import tweet_eval
from meant_tpu_torch.cli.common import base_parser
from meant_tpu_torch.data.loader import ArrayLoader, host_tensor
from meant_tpu_torch.models import bertweet_wrapper
from meant_tpu_torch.train.classify import sigmoid_ce_loss
from meant_tpu_torch.train.text_classify import (bce_loss,
                                                 text_classifier_trainer)
from meant_tpu_torch.weights import load_jax_params

import torch_threads

torch_threads.share_cores()

SMALL = dict(input_dim=64, output_dim=3, vocab_size=200, num_layers=2,
             num_heads=4)
CLI = ["-nec", "1", "--seq_len", "12", "--text_dim", "32", "--num_heads",
       "4", "--vocab_size", "128", "-nc", "3", "-tb", "4", "--bf16",
       "false"]


def _probs(seed=0, n=6, c=3):
    rng = np.random.RandomState(seed)
    out = rng.rand(n, c).astype(np.float32)
    out[0, 0], out[1, 1] = 0.0, 1.0                 # the clip is reached
    return out, rng.randint(0, c, n).astype(np.int32)


def test_bce_loss_matches_jax():
    out, y = _probs()
    want = float(j_bce(jnp.asarray(out), jnp.asarray(y)))
    got = float(bce_loss(torch.as_tensor(out), torch.as_tensor(y)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isfinite(got)


@pytest.mark.parametrize("name", ["Binary Cross Entropy", "Cross Entropy"])
def test_trainer_loss_choice_matches_jax(name):
    """BCE by default; any other name is the classification trainer's
    cross entropy over the sigmoid outputs."""
    out, y = _probs(1)
    model = bertweet_wrapper(device="cpu", **SMALL)
    kw = {} if name == "Binary Cross Entropy" else {"loss": name}
    trainer = text_classifier_trainer(dict(
        kw, model=model, train_loader=ArrayLoader({"y": y}, 2)))
    want = j_bce if name == "Binary Cross Entropy" else j_ce
    got = trainer.loss(torch.as_tensor(out), torch.as_tensor(y))
    np.testing.assert_allclose(float(got),
                               float(want(jnp.asarray(out), jnp.asarray(y))),
                               rtol=1e-6)
    assert trainer._opt_kwargs["lr_scheduler"] == "constant"


def test_first_step_loss_matches_jax_at_shared_weights():
    """The trainer's first loss is the loss of the weights it starts
    from: JAX's bertweet_wrapper at its params, dropout off."""
    rng = np.random.RandomState(2)
    ids = rng.randint(2, 200, (4, 12)).astype(np.int32)
    ids[1, 8:] = 1
    y = rng.randint(0, 3, 4).astype(np.int32)
    jm = JBertweet(**SMALL)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), ids)["params"])
    want = float(jax.jit(lambda p, i: j_ce(jm.apply({"params": p}, i),
                                           jnp.asarray(y)))(
        params, jnp.asarray(ids)))
    model = bertweet_wrapper(device="cpu", **SMALL)
    load_jax_params(model, params)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    trainer = text_classifier_trainer(dict(
        model=model, loss="Cross Entropy", num_classes=3,
        train_loader=ArrayLoader({"input_ids": ids, "y": y}, 4)))
    loss, cm = trainer.train_step({"input_ids": host_tensor(ids),
                                   "y": host_tensor(y)})
    np.testing.assert_allclose(loss.item(), want, rtol=1e-6)
    assert int(cm.sum()) == 4 and trainer.optimizer.step_count == 1


def test_cli_on_the_synthetic_set():
    argv = CLI + ["-rid", "0", "--synthetic_n", "16", "-ne", "2"]
    args = base_parser().parse_args(argv)
    got, want = tweet_eval.load_data(args), j_cli.load_data(args)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["input_ids"][:, 1] == 3 + got["y"]).all()
    results = tweet_eval.main(argv + ["--device", "cpu"])
    trainer = results["trainer"]
    assert len(results["history"]) == 2 and len(trainer.latencies) == 8
    assert all(np.isfinite(h["train_loss"]) for h in results["history"])
    assert trainer.optimizer.step_count == 8


CSV = ['text,label', 'good day for $AAPL,2', '"sell, sell, sell",0',
       '', 'flat,1', 'nothing here,1', '"a ""quoted"" tweet",2',
       'hello world,0', 'ok,1', 'another one,2']


def test_cli_on_a_csv_reads_as_jax_reads_with_pandas(tmp_path):
    (tmp_path / "tweets.csv").write_text("\n".join(CSV) + "\n",
                                         encoding="utf-8")
    argv = CLI + ["-rid", "0", "--data_dir", str(tmp_path), "-ne", "1"]
    got = tweet_eval.load_data(base_parser().parse_args(argv))
    want = j_cli.load_data(j_parser().parse_args(argv))
    assert got["input_ids"].shape == (8, 12)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    results = tweet_eval.main(argv + ["--device", "cpu"])
    assert results["trainer"].optimizer.step_count == 2


def test_cli_refuses_stack_flags_as_jax_does():
    argv = CLI + ["-rid", "0", "--remat", "--device", "cpu"]
    with pytest.raises(SystemExit):
        tweet_eval.main(argv)
    with pytest.raises(SystemExit):
        j_cli.main(argv[:-2])
