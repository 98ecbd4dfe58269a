"""The port's token-classification harnesses and the last CLI harnesses on
the CPU against the JAX package: in_loop_genia, tweet7, checkpoint_train,
hug_train, hug_pretrain_mlm, run_other_models and train_legacy, each on
`--device cpu` at a tiny geometry, with its data arrays and its split
equal to JAX's; tweet7's `--crf` without `--impl_crf` raising in both
packages and `--crf --impl_crf` decoding only paths the BIO mask allows;
run_other_models' name domain, seed and recall quirk; checkpoint_train's
`--epoch` resume; hug_train `--pretrained` from a `.bin` (the grafted
entries equal the file's before the first step, a missing file trains from
scratch with JAX's message, and a 514-row position table raises in both
packages: the backbone's table has 130 rows); the configs copy equal to
the JAX package's.

Sizes: 2 layers, width 32 in 4 heads, vocab 128, s=16, batch 4.
"""

import io
import json
import os
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax.errors import ScopeParamShapeError

import meant_tpu.cli.checkpoint_train as j_ckpt_cli
import meant_tpu.cli.common as j_common
import meant_tpu.cli.hug_pretrain_mlm as j_hug_mlm
import meant_tpu.cli.hug_train as j_hug
import meant_tpu.cli.in_loop_genia as j_genia
import meant_tpu.cli.run_other_models as j_other
import meant_tpu.cli.tweet7 as j_tweet7
from meant_tpu.train.ner import TokenClassifier as JTokenClassifier
from meant_tpu.utils.port import import_hf_roberta as j_import
from meant_tpu_torch.cli import (checkpoint_train, common, hug_pretrain_mlm,
                                 hug_train, in_loop_genia, run_other_models,
                                 train_legacy, tweet7)
from meant_tpu_torch.data.datasets import synthetic_tempstock
from meant_tpu_torch.nn.crf import bio_constraint_mask

import torch_threads

torch_threads.share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.listdir(os.path.join(ROOT, "meant_tpu", "configs")))
TINY = ["-nec", "2", "--seq_len", "16", "--text_dim", "32", "--num_heads",
        "4", "--vocab_size", "128", "-tb", "4", "--synthetic_n", "24",
        "-ne", "1", "--bf16", "false"]
D, LAYERS, HEADS, VOCAB = 32, 2, 4, 128
TINY_CONFIG = {"vocab_size": VOCAB, "hidden_size": D,
               "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
               "num_labels": 15, "hidden_dropout_prob": 0.0}


def _run(main, argv):
    """main(argv) with its printed lines."""
    out = io.StringIO()
    with redirect_stdout(out):
        results = main(argv)
    return results, out.getvalue()


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_copy_equals_jax(name):
    with open(os.path.join(ROOT, "meant_tpu", "configs", name)) as f:
        want = json.load(f)
    assert common.load_config(name[:-5]) == want == \
        j_common.load_config(name[:-5])


def _jax_argv(argv):
    """argv without the port's --device flag, which JAX's parsers lack."""
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


def _same_split(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("source", ["synthetic", "tokens", "npz"])
def test_genia_data_and_split_equal_jax(tmp_path, source):
    extra = ["-js", "2"]
    if source == "tokens":
        rows = [{"tokens": ["a", "bb", "c"], "ner_tags": [1, 0, 2]},
                {"tokens": ["dd", "e"], "tags": [3, 3]},
                {"tokens": ["f"] * 20, "ner_tags": [4] * 20}] * 4
        (tmp_path / "ner_tokens.json").write_text(json.dumps(rows))
        extra += ["--data_dir", str(tmp_path)]
    elif source == "npz":
        rng = np.random.RandomState(0)
        np.savez(tmp_path / "ner_prepared.npz",
                 input_ids=rng.randint(2, 100, (13, 16)),
                 attention_mask=np.ones((13, 16), np.float32),
                 labels=rng.randint(-1, 9, (13, 16)))
        extra += ["--data_dir", str(tmp_path)]
    argv = TINY + ["-rid", "0"] + extra
    args = in_loop_genia.genia_parser().parse_args(argv)
    got, want = in_loop_genia.load_data(args), j_genia.load_data(args)
    _same_split([got], [want])
    _same_split(common.split_train_val_test(got),
                j_common.split_train_val_test(want))


def test_genia_trains_and_reports(tmp_path):
    results, out = _run(in_loop_genia.main,
                        TINY + ["-rid", "0", "-js", "2", "--device", "cpu",
                                "-fp", str(tmp_path)])
    assert np.isfinite(results["history"][0]["train_loss"])
    assert os.path.exists(results["checkpoint"])
    assert "/models/biobert/" in results["checkpoint"]
    assert "Macro test f1:" in out and results["trainer"].crf is False


def test_tweet7_crf_without_impl_raises_in_both():
    argv = TINY + ["-rid", "0", "--crf"]
    for main, extra in ((tweet7.main, ["--device", "cpu"]),
                        (j_tweet7.main, [])):
        with pytest.raises(NotImplementedError):
            main(argv + extra)


def test_tweet7_crf_decodes_only_allowed_paths(tmp_path):
    argv = TINY + ["-rid", "0", "--crf", "--impl_crf", "-lrwp", "0.5",
                   "-lrst", "linear_warmup", "-fp", str(tmp_path),
                   "--synthetic_n", "40"]
    results, _ = _run(tweet7.main, argv + ["--device", "cpu"])
    trainer = results["trainer"]
    args = j_tweet7.tweet7_parser().parse_args(argv)
    train, _, test = j_common.split_train_val_test(j_genia.load_data(args))
    total = max(len(train["labels"]) // 4, 1) * args.num_epochs
    assert trainer._opt_kwargs["total_steps"] == total
    assert trainer._opt_kwargs["warmup_steps"] == int(total * 0.5)
    cm = trainer.constraint_mask
    np.testing.assert_array_equal(cm, bio_constraint_mask(
        {int(k): v for k, v in
         common.load_config("roberta_tweet")["id2label"].items()}))
    mask = torch.as_tensor(test["attention_mask"])
    paths, _ = trainer.model.decode(torch.as_tensor(test["input_ids"]).long(),
                                    mask, constraint_mask=cm)
    T = trainer.model.crf.num_tags
    for row, m in zip(paths.numpy(), mask.numpy()):
        tags = row[m > 0]
        assert cm[T, tags[0]] and cm[tags[-1], T + 1]
        assert all(cm[a, b] for a, b in zip(tags, tags[1:]))
    assert np.isfinite(results["history"][0]["train_loss"])
    # another tag count decodes unconstrained, with the warning (no epoch
    # needed to see it)
    results, out = _run(tweet7.main,
                        argv + ["-nc", "5", "-ne", "0", "--device", "cpu"])
    assert results["trainer"].constraint_mask is None
    assert "WITHOUT the BIO transition constraint" in out


def test_checkpoint_train_resumes_from_its_epoch(tmp_path):
    argv = TINY + ["-rid", "7", "--device", "cpu", "-fp", str(tmp_path)]
    args = common.base_parser().parse_args(argv)
    _same_split([checkpoint_train.load_data(args)],
                [j_ckpt_cli.load_data(args)])
    first, _ = _run(checkpoint_train.main, argv)
    path = first["checkpoint"]
    assert path == checkpoint_train.resume_path(args, 1)
    trained = torch.load(path, weights_only=True)["params"]
    # --epoch 1 with no epoch to run saves what it restored
    resumed, out = _run(checkpoint_train.main,
                        argv + ["--epoch", "1", "-ne", "0"])
    assert f"resumed from {path}" in out
    again = torch.load(resumed["checkpoint"], weights_only=True)["params"]
    assert all(torch.equal(again[k], v) for k, v in trained.items())
    with pytest.raises(FileNotFoundError):
        checkpoint_train.main(argv + ["--epoch", "2"])


def _hf_roberta_bin(path, maxpos=130, seed=0):
    """An HF-layout RoBERTa state dict (`roberta.` keys, a pooler) at the
    tiny config's geometry, seeded, saved with torch.save."""
    rng = np.random.RandomState(seed)
    r = lambda *shape: torch.tensor(rng.randn(*shape).astype(np.float32))
    sd = {"roberta.embeddings.word_embeddings.weight": r(VOCAB, D),
          "roberta.embeddings.position_embeddings.weight": r(maxpos, D),
          "roberta.embeddings.token_type_embeddings.weight": r(1, D),
          "roberta.embeddings.LayerNorm.weight": r(D),
          "roberta.embeddings.LayerNorm.bias": r(D),
          "roberta.pooler.dense.weight": r(D, D),
          "roberta.pooler.dense.bias": r(D)}
    for i in range(LAYERS):
        p = f"roberta.encoder.layer.{i}."
        for name, shape in (("attention.self.query", (D, D)),
                            ("attention.self.key", (D, D)),
                            ("attention.self.value", (D, D)),
                            ("attention.output.dense", (D, D)),
                            ("intermediate.dense", (4 * D, D)),
                            ("output.dense", (D, 4 * D))):
            sd[p + name + ".weight"] = r(*shape)
            sd[p + name + ".bias"] = r(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"] = r(D)
            sd[p + name + ".bias"] = r(D)
    torch.save(sd, path)
    return sd


def _hug_argv(tmp_path, *extra):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_CONFIG))
    return TINY + ["-rid", "0", "--config_json", str(cfg), "-nc", "15",
                   "--device", "cpu", "-fp", str(tmp_path), *extra]


def test_hug_train_data_split_and_pretrained_bin(tmp_path):
    sd = _hf_roberta_bin(tmp_path / "bert_ner.bin")
    argv = _hug_argv(tmp_path, "--pretrained", "true", "-cl", str(tmp_path))
    (args, trainer, test_loader, num_labels), out = _run(
        hug_train.prepare, argv)
    assert "grafted local HF cache weights for bert_ner" in out
    assert num_labels == 15 and args.vocab_size == VOCAB
    jargs = j_hug.hug_parser().parse_args(_jax_argv(argv))
    jargs.vocab_size = VOCAB
    _same_split([dict(test_loader.arrays)],
                [j_common.split_train_val_test(j_genia.load_data(jargs))[2]])
    trainer._init_state()
    model = trainer.model.state_dict()
    pairs = {"embeddings.LayerNorm": "embeddings.layer_norm",
             "attention.self.": "attention.", "attention.output.dense":
             "attention.out", "attention.output.LayerNorm":
             "attention_norm", "intermediate.dense": "intermediate",
             "output.dense": "output", "output.LayerNorm": "output_norm",
             "encoder.layer.": "layer_"}
    for key, value in sd.items():
        if "pooler" in key:
            assert not any("pooler" in k for k in model)
            continue
        mine = key
        for a, b in pairs.items():
            mine = mine.replace(a, b)
        assert torch.equal(model[mine], value), key
    hist = trainer.train()
    assert np.isfinite(hist[0]["train_loss"])
    assert os.path.exists(trainer.checkpoint)


def test_hug_train_without_the_file_trains_from_scratch(tmp_path):
    results, out = _run(hug_train.main, _hug_argv(
        tmp_path, "--pretrained", "true", "-cl", str(tmp_path / "none")))
    assert "no local HF cache (no bert_ner.bin/.pt under" in out
    assert "training from scratch" in out
    assert np.isfinite(results["history"][0]["train_loss"])


def test_position_table_of_514_rows_raises_in_both(tmp_path):
    """The backbone's table has 130 rows whatever the config says, so a
    checkpoint's 514-row table is refused by Flax's shape check and by the
    port's load_state_dict."""
    sd = _hf_roberta_bin(tmp_path / "bert_ner.bin", maxpos=514)
    params = {"roberta": j_import(sd, LAYERS, num_heads=HEADS),
              "classifier": {"kernel": np.zeros((D, 15), np.float32),
                             "bias": np.zeros(15, np.float32)}}
    params["roberta"].pop("pooler")
    jm = JTokenClassifier(num_labels=15, vocab_size=VOCAB, hidden_size=D,
                          num_layers=LAYERS, num_heads=HEADS)
    with pytest.raises(ScopeParamShapeError, match="130, 32"):
        jm.apply({"params": params}, jnp.ones((1, 8), jnp.int32))
    (_, trainer, _, _), _ = _run(hug_train.prepare, _hug_argv(
        tmp_path, "--pretrained", "true", "-cl", str(tmp_path)))
    with pytest.raises(RuntimeError, match="size mismatch"):
        trainer._init_state()


def test_hug_train_classification_task(tmp_path):
    argv = _hug_argv(tmp_path, "-t", "classification", "-nc", "3")
    args = hug_train.hug_parser().parse_args(argv)
    args.vocab_size = VOCAB
    _same_split([hug_train.load_sequence_data(args)],
                [j_hug.load_sequence_data(args)])
    results, _ = _run(hug_train.main, argv)
    assert results["metrics"] is None and len(results["history"]) == 1
    assert results["trainer"].optimizer.step_count == 5   # 21 rows at 4


@pytest.mark.parametrize("fixed", [False, True])
def test_hug_pretrain_mlm_loss_matches_jax(tmp_path, fixed):
    argv = TINY + ["-rid", "3", "-b", "4", "--device", "cpu", "-fp",
                   str(tmp_path)] + (["--fixed_loss"] if fixed else [])
    results, _ = _run(hug_pretrain_mlm.main, argv)
    trainer = results["trainer"]
    assert trainer.fixed_loss is fixed and os.path.exists(trainer.checkpoint)
    assert np.isfinite(results["history"][0]["train_loss"])
    batch = next(iter(trainer.train_data))
    out = np.random.RandomState(1).randn(*batch["labels"].shape).astype(
        np.float32)
    want = j_hug_mlm.hug_mlm_pretrainer._loss(
        SimpleNamespace(fixed_loss=fixed), jnp.asarray(out),
        {"labels": jnp.asarray(batch["labels"])})
    got = trainer._loss(torch.as_tensor(out),
                        {"labels": torch.as_tensor(batch["labels"])})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_run_other_models_domain_seed_and_recall_quirk(tmp_path):
    with pytest.raises(ValueError, match="Pass a valid model name."):
        run_other_models.main(["-rid", "0", "-mn", "lstm"])
    metrics = {"accuracy": 0.5, "f1_macro": 0.4, "f1_micro": 0.5,
               "precision_macro": 0.3, "precision_micro": 0.5,
               "recall_macro": 0.7, "recall_micro": 0.5}
    for fixed in (False, True):
        got, _ = _run(lambda a: run_other_models._reference_metrics_block(
            metrics, "test", fixed), None)
        want, _ = _run(lambda a: j_other._reference_metrics_block(
            metrics, "test", fixed), None)
        assert got == want
        assert got[5][1] == (0.7 if fixed else 0.3)
    argv = ["-rid", "0", "-mn", "meant_tweet", "-nec", "1", "--text_dim",
            "32", "--num_heads", "4", "--vocab_size", "128", "--seq_len",
            "12", "--image_size", "32", "-tb", "4", "--synthetic_n", "20",
            "-ne", "1", "--device", "cpu", "-fp", str(tmp_path),
            "--fixed_metrics", "true"]
    assert run_other_models.forwarded(argv) == argv[:-2]
    results, out = _run(run_other_models.main, argv)
    assert results["trainer"].seed == 42
    assert "Macro test recall:" in out


def test_train_legacy_streams_npz_shards(tmp_path):
    sizes = (6, 9)
    for i, n in enumerate(sizes):
        arrays = synthetic_tempstock(n=n, lag=5, seq=12, channels=4, size=32,
                                     vocab=127)
        np.savez(tmp_path / f"ticker{i}.npz", **arrays)
    stream = train_legacy.ShardStream(
        train_legacy.shard_paths(str(tmp_path)), 4)
    assert len(stream) == sum(n // 4 for n in sizes) == len(list(stream))
    argv = ["-rid", "0", "-nec", "1", "--text_dim", "32", "--image_dim",
            "32", "--num_heads", "4", "--vocab_size", "128", "--seq_len",
            "12", "--image_size", "32", "-tb", "4", "-ne", "1",
            "--device", "cpu", "--data_dir", str(tmp_path), "-fp",
            str(tmp_path / "out")]
    results, _ = _run(train_legacy.main, argv)
    trainer = results["trainer"]
    assert trainer.optimizer.step_count == len(stream)
    assert trainer.optimizer.coupled and trainer.val_loader is None
    assert trainer._opt_kwargs["lr_scheduler"] == "cosine"
    assert os.path.exists(results["checkpoint"])
