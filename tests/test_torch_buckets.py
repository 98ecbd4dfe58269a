"""Length-bucketed training in the port against the JAX package, on the
CPU: `BucketedLoader` (the same batches in the same order, bit for bit, at
three seeds, shuffled and not, with per-bucket batch sizes; the same
refusals), a narrow meant_src (2 + 2 encoders, 64 wide in 2 heads) at
shared weights fed one batch of each of two buckets (probabilities within
1e-4 of JAX's, fp32: the text tower's output is zero-padded from the
bucket's length to seq_len in both), and `cli.in_loop_train --buckets` for
one epoch on TempStock-small `.npy` rows whose masks vary, whose batches
are those of JAX's CLI's loader."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meant_tpu.data.datasets import split_arrays as j_split_arrays
from meant_tpu.data.loader import BucketedLoader as JBucketed
from meant_tpu.models import EmbeddingConfig as JEmb
from meant_tpu.models.meant_src import meant_src as JMeantSrc
from meant_tpu_torch.cli import in_loop_train
from meant_tpu_torch.data.loader import BucketedLoader
from meant_tpu_torch.models import EmbeddingConfig, meant_src
from meant_tpu_torch.weights import load_jax_params

import torch_threads

torch_threads.share_cores()

GEOM = dict(text_dim=64, image_dim=64, price_dim=5, height=32, width=32,
            patch_res=16, lag=5, num_classes=2, num_heads=2, num_encoders=2,
            channels=3, seq_len=32)
EMB = dict(vocab_size=100, hidden_size=64, max_position_embeddings=40,
           dropout=0.0)
SRC_KEYS = dict(seq_keys=("input_ids", "attention_mask"),
                length_key="attention_mask")


def _lengths(rng, n, s, lo):
    """(n, 5) day lengths: a row's longest day (its last) holds lo..s
    tokens, its other days lo up to that many."""
    top = rng.randint(lo, s + 1, size=(n, 1))
    lengths = np.minimum(rng.randint(lo, s + 1, size=(n, 5)), top)
    lengths[:, -1] = top[:, 0]
    return lengths


def _rows(n=60, s=32, seed=0, lo=1):
    """kwargs-family rows whose days hold lo..s tokens (pad id 1 after)."""
    rng = np.random.RandomState(seed)
    lengths = _lengths(rng, n, s, lo)
    mask = (np.arange(s) < lengths[..., None]).astype(np.float32)
    ids = np.where(mask > 0, rng.randint(2, 100, (n, 5, s)), 1)
    return {"input_ids": ids.astype(np.int32),
            "pixels": rng.randn(n, 5, 3, 32, 32).astype(np.float32),
            "prices": rng.randn(n, 5, 5).astype(np.float32),
            "attention_mask": mask,
            "y": rng.randint(0, 2, n).astype(np.int32)}


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("bucket_batches", [None, {8: 6, 16: 4}],
                         ids=["one_size", "per_bucket"])
def test_bucketed_loader_yields_jax_batches(seed, shuffle, bucket_batches):
    rows = _rows(seed=seed)
    kw = dict(buckets=(8, 16, 24, 40), shuffle=shuffle, seed=seed,
              bucket_batches=bucket_batches, **SRC_KEYS)
    got, want = BucketedLoader(rows, 5, **kw), JBucketed(rows, 5, **kw)
    assert got.buckets == want.buckets == [8, 16, 24, 32]
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert len(got) == len(want)
    for _ in range(2):             # the second epoch draws on from the rng
        _assert_same_batches(got, want)


@pytest.mark.parametrize("kw", [dict(bucket_batches={9: 4}),
                                dict(bucket_batches={16: 3},
                                     batch_divisor=2),
                                dict(batch_divisor=4)],
                         ids=["stray_key", "indivisible_entry",
                              "indivisible_default"])
def test_bucketed_loader_refusals_raise_in_both(kw):
    rows = _rows()
    with pytest.raises(ValueError):
        BucketedLoader(rows, 6, buckets=(8, 16), **SRC_KEYS, **kw)
    with pytest.raises(ValueError):
        JBucketed(rows, 6, buckets=(8, 16), **SRC_KEYS, **kw)


@pytest.fixture(scope="module")
def two_buckets():
    """JAX's narrow meant_src, its params, and its probabilities on the
    first batch of the 16- and 32-token buckets (one jit per length)."""
    rows = _rows(n=40, seed=3, lo=4)
    loader = JBucketed(rows, 4, buckets=(16, 32), **SRC_KEYS)
    firsts = {}
    for batch in loader:
        firsts.setdefault(batch["input_ids"].shape[-1], batch)
    assert sorted(firsts) == [16, 32]
    model = JMeantSrc(embedding=JEmb(**EMB), fixed_proj=True, **GEOM)
    inputs = lambda b: {k: jnp.asarray(b[k]) for k in
                        ("input_ids", "pixels", "prices", "attention_mask")}
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 **inputs(firsts[32]))["params"]
    apply = jax.jit(lambda p, b: model.apply({"params": p}, **b))
    probs = {s: np.asarray(apply(params, inputs(b)))
             for s, b in firsts.items()}
    return jax.tree.map(np.asarray, params), firsts, probs, rows


def test_narrow_src_on_two_buckets_matches_jax(two_buckets):
    params, firsts, probs, rows = two_buckets
    model = meant_src(embedding=EmbeddingConfig(**EMB), fixed_proj=True,
                      device="cpu", **GEOM).eval()
    load_jax_params(model, params)
    batches = {}
    for batch in BucketedLoader(rows, 4, buckets=(16, 32), **SRC_KEYS):
        batches.setdefault(batch["input_ids"].shape[-1], batch)
    for s, batch in batches.items():
        np.testing.assert_array_equal(batch["input_ids"],
                                      firsts[s]["input_ids"])
        with torch.no_grad():
            got = model(**{k: torch.as_tensor(batch[k]) for k in
                           ("input_ids", "pixels", "prices",
                            "attention_mask")}).numpy()
        assert got.shape == (4, 2)
        np.testing.assert_allclose(got, probs[s], rtol=1e-4, atol=1e-4,
                                   err_msg=f"s={s}")


def _write_tempstock(path, n=40, seq=16, size=32, seed=0):
    """TempStock-small `.npy` files whose rows' longest day holds 2-16
    tokens."""
    rng = np.random.RandomState(seed)
    lengths = _lengths(rng, n, seq, 2)
    masks = (np.arange(seq) < lengths[..., None]).astype(np.float32)
    arrays = {"graphs": rng.randn(n, 5, 4, size, size).astype(np.float32),
              "tweets": np.where(masks > 0, rng.randint(2, 100,
                                                        (n, 5, seq)), 1),
              "attention_masks": masks,
              "macds": rng.randn(n, 5, 4).astype(np.float32),
              "y_resampled": rng.randint(0, 2, n)}
    for name, a in arrays.items():
        np.save(os.path.join(path, f"{name}_5.npy"), a)


def test_cli_buckets_trains_an_epoch_on_jax_cli_batches(tmp_path):
    """`cli.in_loop_train -mn meant --data_dir --buckets 4,8,12 --device
    cpu`: the trainer's loader is JAX's CLI's (meant_tpu/cli/
    in_loop_train.py:49-59) on the same split, batch for batch, and one
    epoch trains a step at each bucket."""
    data = tmp_path / "data"
    data.mkdir()
    _write_tempstock(str(data))
    argv = ["-rid", "b", "-mn", "meant", "-nec", "1", "--seq_len", "16",
            "--image_size", "32", "--text_dim", "32", "--image_dim", "32",
            "--num_heads", "4", "--vocab_size", "128", "-tb", "2", "-ne",
            "1", "--device", "cpu", "--data_dir", str(data), "--buckets",
            "4,8,12", "-fp", str(tmp_path), "--flash", "true"]
    trainer = in_loop_train.prepare(argv)
    loader = trainer.train_loader
    from meant_tpu.data.datasets import load_tempstock_small
    train, _, _ = j_split_arrays(load_tempstock_small(str(data)))
    want = JBucketed(train, 2, buckets=(4, 8, 12), shuffle=True,
                     seq_keys=("tweets", "input_ids", "attention_masks"))
    assert loader.buckets == want.buckets == [4, 8, 12, 16]
    _assert_same_batches(loader, want)
    loader.rng = np.random.RandomState(0)          # the epoch's own draw
    lengths = []
    step = trainer.train_step
    trainer.train_step = lambda b: lengths.append(
        b["tweets"].shape[-1]) or step(b)
    results = trainer.train()
    assert sorted(set(lengths)) == [4, 8, 12, 16]
    assert len(lengths) == len(loader)
    assert np.isfinite(results["history"][0]["train_loss"])
    assert results["checkpoint"] and os.path.exists(results["checkpoint"])
