"""The port's training slice on the CPU against the JAX package.

A tiny meant_src (2 + 2 encoders, dim 64 in 2 heads of 32, s=16 tokens
against a 12-row position table so the clamped position ids run, 32x32
charts), flash=True and fixed_proj=True on both sides (at fixed_proj=False
every tower gradient is zero, DEFECTS #15), at shared weights
(`weights.load_jax_params`), dropout off on both sides. fp32 bars:

* every parameter's gradient vs `jax.grad` of the JAX loss: relative L2
  1e-4 per parameter, plus 1e-8 absolute for gradients that are zero in
  exact arithmetic (the temporal key bias: a shift of every key moves no
  softmax) and read 1e-10 of rounding on either side (the Pallas backward
  runs in interpret mode, the port runs K2's plain version);
* 3 steps of the port's train step vs the JAX trainer's jitted step
  (AdamW, clip 1.0, cosine_warm, lr 1e-3): losses 1e-5 relative, each
  parameter tensor 1e-4 relative L2 (read: at most 2e-5). Adam's
  m / sqrt(v) turns the rounding noise of a gradient entry near zero into
  a step of up to lr: single word-embedding entries move 5.6e-5 apart, and
  the key biases, whose gradient is zero in exact arithmetic (a shift of
  every key moves no softmax; in the towers only the rotation of the
  shift is left), read up to 7e-4. Those are held to 3 lr per element, the
  size of three Adam steps.

Then the trainer loop end to end on the CPU through the CLIs: train,
evaluate, save, Predictor(checkpoint_path=...), resume, the eval CLI, the
early-stop rule and the NaN guard; --mu_bf16 (a bf16 first moment through
train, save and resume) and accumulation_steps=2 (updates on every second
micro-step, a resume between the two, the leftover carried across
epochs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.data.loader import ArrayLoader as JArrayLoader
from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models.meant_src import meant_src as JMeantSrc
from meant_tpu.parallel import make_mesh
from meant_tpu.train.classify import meant_trainer as j_meant_trainer
from meant_tpu.train.classify import sigmoid_ce_loss as j_loss
from meant_tpu_torch.cli import eval as eval_cli
from meant_tpu_torch.cli import in_loop_train
from meant_tpu_torch.cli.common import (base_parser, build_model,
                                        synthetic_batch)
from meant_tpu_torch.data.loader import ArrayLoader, host_tensor
from meant_tpu_torch.models import EmbeddingConfig, meant_src
from meant_tpu_torch.serve import Predictor
from meant_tpu_torch.train.classify import meant_trainer, sigmoid_ce_loss
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

GEOM = dict(text_dim=64, image_dim=64, price_dim=5, height=32, width=32,
            patch_res=16, lag=5, num_classes=2, num_heads=2, num_encoders=2,
            channels=3, seq_len=16)
EMB = dict(vocab_size=100, hidden_size=64, max_position_embeddings=12,
           dropout=0.0)
B, S = 2, 16


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(2, 100, (B, 5, S)).astype(np.int32),
            "pixels": rng.randn(B, 5, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(B, 5, 5).astype(np.float32),
            "attention_mask": np.ones((B, 5, S), np.float32),
            "y": np.array([0, 1], np.int32)}


@pytest.fixture(scope="module")
def jax_model_and_params():
    """The flash model, and params drawn by its flash=False twin (the same
    tree; its init avoids tracing the interpret-mode kernels). Parameters
    initialised to zero (biases) start from N(0, 0.02) instead, so that
    after a few Adam steps no tensor is made only of the updates of a
    gradient that is zero in exact arithmetic (the key biases)."""
    def make(flash):
        return JMeantSrc(embedding=JEmb(**EMB), fixed_proj=True, flash=flash,
                         **GEOM)
    batch = {k: jnp.asarray(v) for k, v in _batch().items() if k != "y"}
    params = jax.jit(make(False).init)(jax.random.PRNGKey(1),
                                       **batch)["params"]
    rng = np.random.RandomState(6)
    params = jax.tree.map(
        lambda a: (a if np.any(a) else
                   rng.normal(0, 0.02, a.shape).astype(np.float32)),
        jax.tree.map(np.asarray, params))
    return make(True), params


def _port_model(params):
    model = meant_src(embedding=EmbeddingConfig(**EMB), fixed_proj=True,
                      flash=True, device="cpu", **GEOM)
    load_jax_params(model, params)
    for m in model.modules():          # dropout off in train() mode too
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def test_every_parameter_gradient_matches_jax_grad(jax_model_and_params):
    jm, params = jax_model_and_params
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jm.apply({"params": p}, **{k: v for k, v in jb.items()
                                         if k != "y"})
        return j_loss(out, jb["y"])

    j_value, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, j_grads))

    model = _port_model(params).eval()
    tb = {k: host_tensor(v) for k, v in batch.items()}
    loss = sigmoid_ce_loss(model(**{k: v for k, v in tb.items() if k != "y"}),
                           tb["y"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=1e-6)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    towers = {"languageEncoders": 0.0, "visionEncoders": 0.0}
    for name, p in named.items():
        got, ref = p.grad.numpy(), want[name].numpy()
        assert (np.linalg.norm(got - ref)
                <= 1e-4 * np.linalg.norm(ref) + 1e-8), name
        for t in towers:
            if name.startswith(t):
                towers[t] += float(np.abs(ref).sum())
    assert all(v > 0 for v in towers.values())   # the towers do learn


class _NoDropout:
    """The JAX model with dropout off inside the JAX trainer's train step
    (which applies the model with deterministic=False)."""

    def __init__(self, model):
        self.model = model

    def init(self, *args, **kwargs):
        return self.model.init(*args, **kwargs)

    def apply(self, variables, *args, deterministic=True, rngs=None,
              **kwargs):
        return self.model.apply(variables, *args, **kwargs)


def test_three_train_steps_match_the_jax_trainer(jax_model_and_params):
    jm, params = jax_model_and_params
    batches = [_batch(seed) for seed in (3, 4, 5)]
    common = dict(model_name="meant_src", lr=1e-3, decay=0.01,
                  lrst="cosine_warm", t0=2, seed=0)
    jt = j_meant_trainer(dict(
        common, model=_NoDropout(jm), init_params=params,
        train_loader=JArrayLoader(batches[0], B),
        mesh=make_mesh(devices=jax.devices()[:1])))
    jt._init_state({k: v for k, v in batches[0].items()})
    jt._build_steps()

    model = _port_model(params)
    pt = meant_trainer(dict(common, model=model,
                            train_loader=ArrayLoader(batches[0], B)))
    for batch in batches:
        jt.state, j_value, _ = jt._jit_train(jt.state,
                                             jt._device_batch(batch))
        loss, cm = pt.train_step({k: host_tensor(v)
                                  for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(j_value), rtol=1e-5)
        assert int(cm.sum()) == B
    want = state_dict_from_jax(jax.tree.map(np.asarray, jt.state.params))
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("k.bias"):
            assert np.abs(got - ref).max() <= 3 * common["lr"], name
        else:
            assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref), \
                name
    assert pt.optimizer.step_count == 3


TINY = ["-mn", "meant_src", "-nec", "1", "--synthetic_n", "20",
        "--seq_len", "12", "--image_size", "32", "--text_dim", "32",
        "--image_dim", "32", "--vocab_size", "128", "--num_heads", "4",
        "-tb", "4", "--device", "cpu", "-lrst", "cosine", "-l", "1e-3"]


def test_trainer_loop_end_to_end_on_cpu(tmp_path):
    argv = TINY + ["-rid", "e2e", "-ne", "2", "-fp", str(tmp_path)]
    results = in_loop_train.main(argv)
    trainer = results["trainer"]
    assert [h["epoch"] for h in results["history"]] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) for h in results["history"])
    path = results["checkpoint"]
    assert path == str(tmp_path / "models" / "meant_src" /
                       "meant_src_1_Tempstock_e2e_2")
    assert (tmp_path / "optimizers" / "meant_src" /
            "meant_src_1_Tempstock_e2e_2").exists()
    assert trainer.optimizer.step_count == 2 * 3   # 12 train rows / 4

    rows = {k: v[:6] for k, v in synthetic_batch(
        base_parser().parse_args(argv), 6, seed=9).items() if k != "y"}
    trained = Predictor(trainer.model, "meant_src", batch_size=4,
                        device="cpu")(rows)
    args = base_parser().parse_args(argv)
    served = Predictor(build_model(args), "meant_src", checkpoint_path=path,
                       batch_size=4, device="cpu")(rows)
    np.testing.assert_array_equal(served, trained)

    resumed = meant_trainer({"model": build_model(args),
                             "model_name": "meant_src",
                             "train_loader": trainer.train_loader,
                             "file_path": str(tmp_path), "run_id": "e2e",
                             "num_encoders": 1})
    resumed.resume(2)
    assert resumed.optimizer.step_count == trainer.optimizer.step_count
    for name in ("flat_p", "m", "v"):
        torch.testing.assert_close(getattr(resumed.optimizer, name),
                                   getattr(trainer.optimizer, name),
                                   rtol=0, atol=0)

    metrics = eval_cli.main(argv + ["-ptm", path])
    assert metrics["confusion"] == results["test"]["confusion"]
    assert metrics["f1_macro"] == results["test"]["f1_macro"]


@pytest.mark.parametrize("f1s,stop", [([0.5] * 8, 4),
                                      ([0.1, 0.2, 0.3, 0.4, 0.5, 0.6], None)])
def test_early_stop_patience_five_with_prev_f1_inf(f1s, stop, monkeypatch):
    """The reference's rule: prev_f1 starts at inf, so the first epoch
    counts as no improvement; five epochs without improvement stop."""
    args = base_parser().parse_args(TINY + ["-rid", "es"])
    loader = ArrayLoader(synthetic_batch(args, 4), 4)
    trainer = meant_trainer({"model": build_model(args),
                             "model_name": "meant_src",
                             "train_loader": loader, "val_loader": loader,
                             "epochs": len(f1s), "early_stopping": True,
                             "test_model": False})
    scripted = iter(f1s)
    monkeypatch.setattr(trainer, "evaluate",
                        lambda loader, name: (next(scripted), 0.0, {}))
    monkeypatch.setattr(trainer, "save", lambda epoch: None)
    history = trainer.train()["history"]
    assert len(history) == (len(f1s) if stop is None else stop + 1)


def test_nan_loss_raises(monkeypatch):
    args = base_parser().parse_args(TINY + ["-rid", "nan"])
    loader = ArrayLoader(synthetic_batch(args, 4), 4)
    model = build_model(args)
    with torch.no_grad():
        model.mlpHead.norm.weight.fill_(float("nan"))
    trainer = meant_trainer({"model": model, "model_name": "meant_src",
                             "train_loader": loader, "epochs": 1})
    with pytest.raises(FloatingPointError):
        trainer.train()


@pytest.mark.parametrize("flag", [["--fsdp"],
                                  ["--buckets", "128,512"],
                                  ["-mn", "meantTweetPrice"],
                                  ["--hf_cache", "somewhere"]])
def test_train_cli_refuses_what_is_not_ported(flag):
    with pytest.raises(NotImplementedError):
        in_loop_train.main(TINY + ["-rid", "x"] + flag)


@pytest.mark.parametrize("key", ["mesh", "fsdp"])
def test_trainer_refuses_what_is_not_ported(key):
    args = base_parser().parse_args(TINY + ["-rid", "x"])
    loader = ArrayLoader(synthetic_batch(args, 4), 4)
    with pytest.raises(NotImplementedError):
        meant_trainer({"model": build_model(args), "model_name": "meant_src",
                       "train_loader": loader, key: True})


def test_train_cli_mu_bf16_trains_with_a_bf16_first_moment(tmp_path):
    """--mu_bf16 reaches the optimizer as the JAX CLI hands it on
    (mu_dtype=bf16): the first moment is stored in bf16, the second in
    fp32, and the checkpoint and resume carry the bf16 moment."""
    argv = TINY + ["-rid", "mu", "-ne", "1", "-fp", str(tmp_path),
                   "--mu_bf16"]
    results = in_loop_train.main(argv)
    opt = results["trainer"].optimizer
    assert opt.m.dtype == torch.bfloat16 and opt.v.dtype == torch.float32
    assert opt.step_count == 3 and float(opt.m.float().abs().sum()) > 0
    assert all(np.isfinite(h["train_loss"]) for h in results["history"])
    args = base_parser().parse_args(argv)
    resumed = meant_trainer({"model": build_model(args),
                             "model_name": "meant_src",
                             "train_loader": results["trainer"].train_loader,
                             "file_path": str(tmp_path), "run_id": "mu",
                             "num_encoders": 1,
                             "mu_dtype": torch.bfloat16})
    resumed.resume(1)
    assert resumed.optimizer.m.dtype == torch.bfloat16
    torch.testing.assert_close(resumed.optimizer.m, opt.m, rtol=0, atol=0)


def _device_batches(loader):
    return [{k: host_tensor(v) for k, v in b.items()} for b in loader]


def test_trainer_accumulation_updates_every_second_step_and_resumes(
        tmp_path):
    """meant_trainer with accumulation_steps=2 (optax.MultiSteps):
    the parameters hold on the first micro-step of each pair and move on
    the second, a save between the two micro-steps of a pair carries the
    running mean and the micro-step through resume (the next micro-step
    then gives the same parameters bit for bit), and an epoch's leftover
    micro-step carries into the next."""
    from meant_tpu_torch.train.classify import seed_dropout
    args = base_parser().parse_args(TINY + ["-rid", "acc"])
    loader = ArrayLoader(synthetic_batch(args, 8, seed=3), 4)
    params = {"model_name": "meant_src", "train_loader": loader,
              "file_path": str(tmp_path), "run_id": "acc",
              "num_encoders": 1, "accumulation_steps": 2, "lr": 1e-3,
              "lrst": "constant"}
    trainer = meant_trainer({"model": build_model(args), **params})
    trainer._init_state()
    opt = trainer.optimizer
    b0, b1 = _device_batches(loader)
    before = opt.flat_p.clone()
    for i, batch in enumerate((b0, b1, b0)):
        trainer.train_step(batch)
        moved = not torch.equal(opt.flat_p, before)
        assert moved == (i == 1), i
        assert opt.step_count == (1 if i >= 1 else 0)
        assert opt.mini_step == (0 if i == 1 else 1)
        before = opt.flat_p.clone()
    trainer.save(1)
    resumed = meant_trainer({"model": build_model(args), **params})
    resumed.resume(1)
    ropt = resumed.optimizer
    assert (ropt.mini_step, ropt.step_count) == (1, 1)
    torch.testing.assert_close(ropt.acc, opt.acc, rtol=0, atol=0)
    torch.testing.assert_close(ropt.flat_p, opt.flat_p, rtol=0, atol=0)
    for t in (trainer, resumed):
        seed_dropout(torch.device("cpu"), 123)
        t.train_step(b1)
    assert opt.step_count == ropt.step_count == 2
    torch.testing.assert_close(ropt.flat_p, opt.flat_p, rtol=0, atol=0)
    torch.testing.assert_close(ropt.m, opt.m, rtol=0, atol=0)

    # three micro-steps an epoch: one update, the leftover carried over
    odd = ArrayLoader(synthetic_batch(args, 12, seed=4), 4)
    looped = meant_trainer({"model": build_model(args), **params,
                            "train_loader": odd, "epochs": 2,
                            "test_model": False})
    looped.train()
    assert (looped.optimizer.step_count, looped.optimizer.mini_step) == \
        (3, 0)
