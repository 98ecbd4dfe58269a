"""The port's VQA harness on the CPU against the JAX package: data/vqa.py
element for element, `soft_target_ce`, one `vqa_trainer` step against the
JAX trainer's jitted step, `meant_vqa` with flash on against JAX's
interpret-mode kernels, the CLI (synthetic, and from a `vqa_prepared.npz`)
and its raw `--flash` string, which takes the flash path in both packages
whatever it says.

Sizes: 2 encoders a tower, width 64 in 4 heads, s <= 24 question tokens,
vocab 200, 4 x 64 x 64 charts (16 patches of 16), 10 answers. The same
numpy inputs and JAX's params (through `weights.load_jax_params`) go
through both packages in fp32. Bars: the loss 1e-6 relative, a step's loss
1e-5 relative and its updated parameters 1e-5 absolute (the key biases,
whose gradient is zero in exact arithmetic outside the rotated features,
within 2 lr: Adam's m / sqrt(v) turns rounding there into a step of up to
lr either way), the flash forward 1e-4 (JAX's interpret-mode kernel
against the port's plain version).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meant_tpu.cli.vqa as j_cli_vqa
import meant_tpu.data.vqa as jdata
import meant_tpu.ops.flash as j_flash
from meant_tpu.data.loader import ArrayLoader as JArrayLoader
from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models import meant_vqa as JVqa
from meant_tpu.parallel import make_mesh
from meant_tpu.train.vqa import soft_target_ce as j_soft_target_ce
from meant_tpu.train.vqa import vqa_trainer as j_vqa_trainer
from meant_tpu_torch.cli import vqa as vqa_cli
from meant_tpu_torch.data import vqa as pdata
from meant_tpu_torch.data.loader import ArrayLoader, host_tensor
from meant_tpu_torch.models import EmbeddingConfig, meant_vqa
from meant_tpu_torch.nn import attention_modules
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.vqa import soft_target_ce, vqa_trainer
from meant_tpu_torch.weights import load_jax_params, state_dict_from_jax

import torch_threads

torch_threads.share_cores()

B, S, D, H, VOCAB, IMG, NC = 2, 24, 64, 4, 200, 64, 10
GEOM = (D, D, 4, IMG, IMG, 16, 1, NC)
KW = dict(num_heads=H, num_encoders=2, ff_dropout=0.0)
EMB = dict(vocab_size=VOCAB, hidden_size=D, max_position_embeddings=40,
           dropout=0.0)
LR = 5e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---- data/vqa.py ------------------------------------------------------------

def _records(seed=0, n=5, max_len=30, ncls=7):
    rng = np.random.RandomState(seed)
    records = []
    for _ in range(n):
        h, w = rng.randint(20, 50, size=2)
        target = np.zeros(ncls, np.float32)
        target[rng.randint(ncls)] = 1.0
        records.append({"input_ids": rng.randint(2, 90,
                                                  rng.randint(1, max_len)),
                        "image": rng.randn(4, h, w).astype(np.float32),
                        "soft_target": target})
    return records


def test_vqa_data_equals_jax_element_for_element():
    for count in range(6):
        assert pdata.get_score(count) == jdata.get_score(count)
    answers = [["yes", "no", "2"], ["no", "red"], ["blue", "yes"]]
    label2id = pdata.build_label2id(answers)
    assert label2id == jdata.build_label2id(answers)
    counts = {"yes": 1, "red": 4, "green": 2, "2": 2}
    np.testing.assert_array_equal(pdata.soft_targets(counts, label2id),
                                  jdata.soft_targets(counts, label2id))
    records = _records()
    ids = [r["input_ids"] for r in records]
    for got, want in zip(pdata.pad_text(ids, 16, pad_id=1),
                         jdata.pad_text(ids, 16, pad_id=1)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    images = [r["image"] for r in records]
    for got, want in zip(pdata.center_pad_images(images, 40, 36),
                         jdata.center_pad_images(images, 40, 36)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = pdata.vqa_collate(records, 7, 16, 40, 36)
    want = jdata.vqa_collate(records, 7, 16, 40, 36)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_soft_target_ce_matches_jax():
    rng = np.random.RandomState(1)
    out = rng.randn(6, NC).astype(np.float32) * 3
    targets = np.clip(rng.rand(6, NC), 0, 1).astype(np.float32)
    want = float(j_soft_target_ce(jnp.asarray(out), jnp.asarray(targets)))
    got = float(soft_target_ce(torch.as_tensor(out),
                               torch.as_tensor(targets)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    bf16 = soft_target_ce(torch.as_tensor(out).bfloat16(),
                          torch.as_tensor(targets))
    assert bf16.dtype == torch.float32


# ---- the model and one trainer step -----------------------------------------

def _batch(seed=0, s=S):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, VOCAB, (B, s)).astype(np.int32)
    labels = np.zeros((B, NC), np.float32)
    labels[np.arange(B), rng.randint(0, NC, B)] = 1.0
    labels[np.arange(B), rng.randint(0, NC, B)] = 1 / 3
    return {"language_input_ids": ids,
            "pixel_values": rng.randn(B, 4, IMG, IMG).astype(np.float32),
            "attention_mask": np.ones((B, s), np.float32),
            "pixel_mask": np.ones((B, IMG, IMG), np.float32),
            "labels": labels}


def _jax_params(seed=0):
    """Params of the flash=False twin (the same tree; its init traces no
    interpret-mode kernel)."""
    b = _batch(seed)
    jm = JVqa(*GEOM, embedding=JEmb(**EMB), **KW)
    return _np(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                b["language_input_ids"],
                                b["pixel_values"],
                                attention_mask=b["attention_mask"])
               ["params"])


def _port_model(params, flash=False):
    model = meant_vqa(*GEOM, embedding=EmbeddingConfig(**EMB), flash=flash,
                      device="cpu", **KW)
    load_jax_params(model, params)
    return model


def test_meant_vqa_flash_matches_jax_interpret_kernels():
    """s=24 questions (causal xPos) and 16 patches through the flash
    path: JAX's Pallas kernels in interpret mode against the port's plain
    versions of R1 + K1."""
    params = _jax_params(1)
    b = _batch(2)
    jm = JVqa(*GEOM, embedding=JEmb(**EMB), flash=True, **KW)
    want = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, b["language_input_ids"], b["pixel_values"],
        attention_mask=b["attention_mask"]))(params))
    model = _port_model(params, flash=True).eval()
    with torch.no_grad():
        got = model(host_tensor(b["language_input_ids"]),
                    torch.as_tensor(b["pixel_values"]),
                    attention_mask=torch.as_tensor(b["attention_mask"]))
    assert got.shape == (B, NC)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


class _NoDropout:
    """The JAX model applied without dropout inside the JAX trainer's
    train step (which applies it with deterministic=False)."""

    def __init__(self, model):
        self.model = model

    def init(self, *args, **kwargs):
        return self.model.init(*args, **kwargs)

    def apply(self, variables, *args, deterministic=True, rngs=None,
              **kwargs):
        return self.model.apply(variables, *args, **kwargs)


def test_one_trainer_step_matches_the_jax_trainer():
    params = _jax_params(3)
    batch = _batch(4)
    common = dict(model_name="meant_vqa", num_classes=NC, lr=LR,
                  decay=0.01, seed=0)
    jt = j_vqa_trainer(dict(
        common, model=_NoDropout(JVqa(*GEOM, embedding=JEmb(**EMB), **KW)),
        init_params=params, train_loader=JArrayLoader(batch, B),
        mesh=make_mesh(devices=jax.devices()[:1])))
    jt._init_state(batch)
    jt._build_steps()
    jt.state, j_loss, j_cm = jt._jit_train(jt.state,
                                           jt._device_batch(batch))

    model = _port_model(params)
    pt = vqa_trainer(dict(common, model=model,
                          train_loader=ArrayLoader(batch, B)))
    loss, cm = pt.train_step({k: host_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(j_cm))
    want = state_dict_from_jax(_np(jt.state.params))
    before = state_dict_from_jax(params)
    moved = 0
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        moved += int(np.any(ref != before[name].numpy()))
        bar = 2 * LR if name.endswith("k.bias") else 1e-5
        assert np.abs(got - ref).max() <= bar, name
    assert moved > 0 and pt.optimizer.step_count == 1


# ---- the CLI ----------------------------------------------------------------

CLI = ["-nec", "1", "--image_size", str(IMG), "--text_dim", "32",
       "--image_dim", "32", "--vocab_size", "128", "--num_heads", "4",
       "-nc", "5", "-tb", "4", "-ne", "1", "--bf16", "false",
       "--device", "cpu"]


def test_cli_trains_the_synthetic_set_and_saves(tmp_path):
    results = vqa_cli.main(CLI + ["-rid", "vq", "--synthetic_n", "24",
                                  "-fp", str(tmp_path)])
    trainer = results["trainer"]
    assert isinstance(trainer.model, meant_vqa)
    assert trainer.optimizer.step_count == 4        # 16 train rows / 4
    assert np.isfinite(results["history"][0]["train_loss"])
    assert "val_f1_macro" in results["history"][0] and "test" in results
    path = results["checkpoint"]
    assert path == str(tmp_path / "models" / "meant" / "meant_1_vqa_vq_1")
    restored = ckpt.restore(path)
    assert restored["step"] == 4
    sd = trainer.model.state_dict()
    assert all(torch.equal(restored["params"][k], sd[k]) for k in sd)


def test_cli_reads_a_prepared_npz_and_splits_as_jax(tmp_path):
    n, s = 30, 40
    rng = np.random.RandomState(5)
    targets = np.zeros((n, 5), np.float32)
    targets[np.arange(n), rng.randint(0, 5, n)] = 1.0
    arrays = dict(input_ids=rng.randint(2, 120, (n, s)).astype(np.int32),
                  images=rng.randn(n, 4, IMG, IMG).astype(np.float32),
                  attention_mask=np.ones((n, s), np.float32),
                  pixel_mask=np.ones((n, IMG, IMG), np.float32),
                  soft_targets=targets)
    np.savez(tmp_path / "vqa_prepared.npz", **arrays)
    argv = CLI + ["-rid", "npz", "--data_dir", str(tmp_path), "-fp",
                  str(tmp_path)]
    args = vqa_cli.base_parser().parse_args(argv)
    got, want = vqa_cli.load_vqa(args), j_cli_vqa.load_vqa(args)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    train, val, test = vqa_cli.split(got, 4)
    assert len(val["labels"]) == len(test["labels"]) == 4    # max(3, 4)
    np.testing.assert_array_equal(test["labels"], targets[4:8])
    results = vqa_cli.main(argv)
    assert results["trainer"].optimizer.step_count == 5     # 22 rows / 4
    assert os.path.exists(results["checkpoint"])


def test_synthetic_set_equals_jax():
    args = vqa_cli.base_parser().parse_args(CLI + ["-rid", "0",
                                                   "--synthetic_n", "8"])
    got, want = vqa_cli.load_vqa(args), j_cli_vqa.load_vqa(args)
    assert got["language_input_ids"].shape == (8, 24)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


class _Captured:
    """Stands in for the trainer class: keeps its params, trains none."""
    params = None

    def __init__(self, p):
        type(self).params = p
        self.checkpoint = None

    def train(self):
        return {}


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("flash", ["false", "auto"])
def test_cli_flash_string_takes_the_flash_path_in_both_packages(
        flash, monkeypatch):
    """The JAX harness hands the raw --flash string to meant_vqa, so
    "false" and the default "auto" take the flash path (one flash call per
    encoder of each tower); the port reproduces it."""
    argv = CLI[:-2] + ["-rid", "0", "--flash", flash, "--synthetic_n", "12"]
    monkeypatch.setattr(j_cli_vqa, "vqa_trainer", type("J", (_Captured,),
                                                       {}))
    monkeypatch.setattr(vqa_cli, "vqa_trainer", type("P", (_Captured,), {}))
    j_cli_vqa.main(argv)
    vqa_cli.main(argv + ["--device", "cpu"])
    jp, pp = j_cli_vqa.vqa_trainer.params, vqa_cli.vqa_trainer.params
    assert jp["model"].flash == flash
    assert pp["model"].languageEncoders[0].flash is True
    batch = next(iter(jp["train_loader"]))
    j_calls = _spy(monkeypatch, j_flash, "flash_attention")
    p_calls = _spy(monkeypatch, attention_modules, "flash_attention")
    args = (batch["language_input_ids"], batch["pixel_values"])
    jax.eval_shape(jp["model"].init, jax.random.PRNGKey(0),
                   *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        pp["model"](*(torch.as_tensor(a) for a in args))
    assert len(j_calls) == len(p_calls) == 2
