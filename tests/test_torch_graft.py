"""The pretrain-then-finetune workflow of the port on the CPU: `graft`
against the JAX package's, the pretraining CLIs (their `--flash` string,
the CSV reader against pandas, the loop and its checkpoint; the parquet
reader is tests/test_torch_parquet.py's), and `pretrain_mlm` /
`pretrain_mim` -> `in_loop_train -p true -ptm` end to end at a tiny
width."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import meant_tpu.cli.pretrain_mim as j_cli_mim
import meant_tpu.cli.pretrain_mlm as j_cli_mlm
import meant_tpu.ops.flash as j_flash
from meant_tpu.cli.common import base_parser as j_base_parser
from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models.pretrainers import meant_language_pretrainer
from meant_tpu.train import checkpoint as j_ckpt
from meant_tpu_torch.cli import in_loop_train, pretrain_mim, pretrain_mlm
from meant_tpu_torch.cli.common import base_parser
from meant_tpu_torch.data.loader import ArrayLoader
from meant_tpu_torch.nn import attention_modules
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train import pretrain
from meant_tpu_torch.weights import state_dict_from_jax

import torch_threads

torch_threads.share_cores()

# flags both packages' parsers take; the port's runs add --device cpu
WIDTHS = ["-nec", "2", "--seq_len", "12", "--image_size", "32",
          "--text_dim", "32", "--image_dim", "32", "--num_heads", "4",
          "--vocab_size", "101", "-tb", "4", "--synthetic_n", "24"]
CPU = ["--device", "cpu"]


# ---- graft ---------------------------------------------------------------

def _jax_lang_params(depth, dim=32, seed=0):
    m = meant_language_pretrainer(
        num_encoders=depth, embedding=JEmb(vocab_size=50, hidden_size=dim),
        text_dim=dim, num_heads=4)
    p = jax.jit(m.init)(jax.random.PRNGKey(seed),
                        jnp.ones((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, p["params"])


@pytest.mark.parametrize("source_depth", [1, 3], ids=["shallower",
                                                      "deeper"])
def test_graft_equals_jax(source_depth):
    """Per layer, as JAX grafts: a deeper source gives its first layers, a
    shallower one leaves the target's deeper layers; the head, outside the
    prefixes, stays the target's."""
    target, source = _jax_lang_params(2, seed=0), _jax_lang_params(
        source_depth, seed=1)
    want = state_dict_from_jax(j_ckpt.graft(target, source))
    got = ckpt.graft(state_dict_from_jax(target), state_dict_from_jax(source))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    t, s = state_dict_from_jax(target), state_dict_from_jax(source)
    key1 = "languageEncoders.1.ff_in.weight"
    assert torch.equal(got[key1], (s if source_depth > 1 else t)[key1])
    assert torch.equal(got["languageEncoders.0.attn.q.weight"],
                       s["languageEncoders.0.attn.q.weight"])
    assert torch.equal(got["mlm_head.dense.weight"],
                       t["mlm_head.dense.weight"])


def test_graft_refuses_a_shape_mismatch_and_skips_missing_keys():
    target, source = _jax_lang_params(1), _jax_lang_params(1, dim=64)
    with pytest.raises(ValueError):
        j_ckpt.graft(target, source)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.graft(state_dict_from_jax(target), state_dict_from_jax(source))
    t = state_dict_from_jax(target)
    src = {"embedding.word_embeddings.weight":
           torch.ones_like(t["embedding.word_embeddings.weight"]),
           "visionEncoders.0.q.weight": torch.ones(3)}   # the target has none
    out = ckpt.graft(t, src)
    assert set(out) == set(t)
    assert torch.equal(out["embedding.word_embeddings.weight"],
                       src["embedding.word_embeddings.weight"])
    assert all(torch.equal(out[k], t[k]) for k in t
               if k != "embedding.word_embeddings.weight")


def test_bare_pretrained_flag_is_false_in_both_packages():
    for parser in (base_parser(), j_base_parser()):
        assert parser.parse_args(["-rid", "0", "-p"]).pretrained is False
        assert parser.parse_args(["-rid", "0", "-p", "true"]).pretrained


# ---- the pretraining CLIs -------------------------------------------------

class _Captured:
    """Stands in for a pretrainer class: keeps its params, trains nothing."""
    params = None

    def __init__(self, p):
        type(self).params = p
        self.checkpoint = None

    def train(self):
        return []


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(kwargs.get("attention_mask"))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("flash", ["auto", "false", "true"])
@pytest.mark.parametrize("kind", ["mlm", "mim"])
def test_cli_flash_string_turns_flash_on_in_both_packages(kind, flash,
                                                          monkeypatch):
    """The JAX pretraining CLIs hand the raw --flash string to the model,
    so every value, "false" and the default "auto" included, takes the
    flash path (one flash call per encoder; the MLM drops its padding
    mask). The port's CLIs reproduce it."""
    # the synthetic texts are 30 words: at 40 tokens the rows are padded
    argv = ["-rid", "0", "--flash", flash] + WIDTHS + ["--seq_len", "40"]
    j_cli, p_cli = ((j_cli_mlm, pretrain_mlm) if kind == "mlm"
                    else (j_cli_mim, pretrain_mim))
    cls = "mlm_pretrainer" if kind == "mlm" else "mim_pretrainer"
    monkeypatch.setattr(j_cli, cls, type("J", (_Captured,), {}))
    monkeypatch.setattr(p_cli, cls, type("P", (_Captured,), {}))
    j_cli.main(argv)
    p_cli.main(argv + CPU)
    jp, pp = getattr(j_cli, cls).params, getattr(p_cli, cls).params
    batch = next(iter(jp["train_data"]))
    assert jp["model"].flash == flash
    j_calls = _spy(monkeypatch, j_flash, "flash_attention")
    p_calls = _spy(monkeypatch, attention_modules, "flash_attention")
    args = [jnp.asarray(batch["input_ids"])]
    if kind == "mlm":
        args.append(jnp.asarray(batch["attention_mask"]))
        assert batch["attention_mask"].min() == 0   # padding to drop
    jax.eval_shape(jp["model"].init, jax.random.PRNGKey(0), *args)
    with torch.no_grad():
        pp["model"](*(torch.tensor(np.asarray(a)) for a in args))
    assert len(j_calls) == len(p_calls) == 2
    assert p_calls == [None, None]


CSV_ROWS = ['text,label', 'hello world,1', ',2', '"a, quoted ""x""",3',
            '', 'NA,4', '  spaced  ,5', '"",6', '"multi\nline",7',
            'None,8', 'naïve café 🚀,9', '1.50,10']


def test_csv_reader_equals_pandas(tmp_path):
    """The port reads the first column of a .csv as the JAX harness does
    with pandas (header row, blank line skipped, quoting, an empty cell and
    "NA" / "None" as missing). pandas 3's astype(str) leaves a missing
    value as NaN, pandas 2's gives "nan"; the port gives "nan"."""
    (tmp_path / "texts.csv").write_text("\n".join(CSV_ROWS) + "\n",
                                        encoding="utf-8")
    args = base_parser().parse_args(["-rid", "0", "--data_dir",
                                     str(tmp_path)])
    want = [str(t) for t in j_cli_mlm.load_text(args)]
    got = pretrain_mlm.load_text(args)
    assert got == want
    assert got[1] == "nan" and got[2] == 'a, quoted "x"' and len(got) == 10


def test_mlm_arrays_equal_the_jax_harness(monkeypatch):
    """Text -> ids -> mask_tokens -> split as the JAX harness does it."""
    monkeypatch.setattr(j_cli_mlm, "mlm_pretrainer",
                        type("J", (_Captured,), {}))
    argv = ["-rid", "3"] + WIDTHS
    j_cli_mlm.main(argv)
    jp = j_cli_mlm.mlm_pretrainer.params
    args = base_parser().parse_args(argv)
    train, val = pretrain_mlm.split(
        pretrain_mlm.mlm_arrays(pretrain_mlm.load_text(args), args), 4)
    for name, got in (("train_data", train), ("val_data", val)):
        want = jp[name].arrays
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pretrainer_loop_patience_and_checkpoint(tmp_path):
    """At lr 0 the val loss never improves: epoch 0 sets the best, epochs
    1-2 lose patience, and with patience 1 the loop leaves after epoch 2;
    the checkpoint of epoch 3 holds the params and, under optimizers/, the
    optimizer state."""
    args = base_parser().parse_args(["-rid", "0"] + WIDTHS + CPU)
    data = pretrain_mlm.mlm_arrays(pretrain_mlm.load_text(args), args)
    train, val = pretrain_mlm.split(data, 4)
    model = pretrain_mlm.build_model(args)
    trainer = pretrain.mlm_pretrainer({
        "model": model, "model_name": "mlm", "train_data":
        ArrayLoader(train, 4, shuffle=True), "val_data": ArrayLoader(val, 4),
        "epochs": 6, "patience": 1, "lr": 0.0, "file_path": str(tmp_path),
        "num_encoders": 2})
    hist = trainer.train()
    assert [h["epoch"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               for h in hist)
    name = "mlm_2_pretrain_0_3"
    assert trainer.checkpoint == str(tmp_path / "models" / "mlm" / name)
    saved = ckpt.restore(trainer.checkpoint)
    assert saved["step"] == 3 * len(trainer.train_data)
    assert set(saved["params"]) == set(model.state_dict())
    opt = ckpt.restore(str(tmp_path / "optimizers" / "mlm" / name))
    assert opt["opt_state"]["m"].numel() == trainer.optimizer.flat_p.numel()


def test_pretrainer_init_params_override_the_fresh_init():
    """`init_params` (a partial state_dict) overrides those entries of the
    fresh init before the first step and leaves the rest; a key the model
    lacks raises."""
    args = base_parser().parse_args(["-rid", "0"] + WIDTHS + CPU)
    host = pretrain_mlm.mlm_arrays(pretrain_mlm.load_text(args), args)
    model = pretrain_mlm.build_model(args)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    key = "languageEncoders.1.ff_in.weight"
    init = {key: torch.full_like(fresh[key], 0.25)}
    trainer = pretrain.mlm_pretrainer({"model": model, "train_data": [host],
                                       "init_params": init})
    trainer._init_state()
    for k, v in model.state_dict().items():
        assert torch.equal(v, init[k] if k == key else fresh[k]), k
    with pytest.raises(KeyError, match="visionEncoders"):
        pretrain.mlm_pretrainer({
            "model": model, "train_data": [host], "init_params":
            {"visionEncoders.0.attn.q.weight": fresh[key]}})._init_state()


def test_pretraining_clis_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in (pretrain_mlm, pretrain_mim):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["-rid", "0"] + WIDTHS)


# ---- pretrain, then finetune meant from the checkpoint --------------------

def _run(tmp_path, kind):
    cli = pretrain_mlm if kind == "mlm" else pretrain_mim
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    rng = np.random.RandomState(0)
    if kind == "mlm":
        texts = [" ".join(f"w{i}" for i in rng.randint(0, 50, 8))
                 for _ in range(24)]
        (data_dir / "texts.csv").write_text(
            "text\n" + "\n".join(texts) + "\n")
    else:
        np.save(data_dir / "charts.npy",
                rng.rand(24, 4, 32, 32).astype(np.float32))
    return cli.main(["-rid", "0", "-ne", "1", "-fp", str(tmp_path),
                     "--data_dir", str(data_dir)] + WIDTHS + CPU)


@pytest.mark.parametrize("kind", ["mlm", "mim"])
def test_pretrain_then_in_loop_train_grafts_and_trains(kind, tmp_path):
    """`pretrain_* -ne 1` on a file it is given, then `in_loop_train -mn
    meant -p true -ptm <checkpoint>`: before the first step the pretrained
    tower (and the MLM's embedding) equal the checkpoint's, the other tower
    is the fresh init; then one epoch trains and saves."""
    res = _run(tmp_path, kind)
    assert len(res["history"]) == 1 and res["checkpoint"]
    params = ckpt.restore(res["checkpoint"])["params"]
    argv = ["-rid", "1", "-mn", "meant", "-ne", "1", "--flash", "true",
            "-fp", str(tmp_path / "ft"), "-p", "true", "-ptm",
            res["checkpoint"]] + WIDTHS + CPU
    trainer = in_loop_train.prepare(argv)
    fresh = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer._init_state()
    sd = trainer.model.state_dict()
    grafted = (("embedding.", "languageEncoders.") if kind == "mlm"
               else ("visionEncoders.",))
    n = 0
    for k, v in sd.items():
        if k.startswith(grafted):
            assert torch.equal(v, params[k]), k
            n += 1
        else:
            assert torch.equal(v, fresh[k]), k
    assert n > 0
    assert any(not torch.equal(fresh[k], params[k]) for k in params
               if k.startswith(grafted))
    out = in_loop_train.main(argv)
    assert np.isfinite(out["history"][0]["train_loss"])
    assert os.path.exists(out["checkpoint"])
