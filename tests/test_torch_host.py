"""Host-side pieces of the training slice against the JAX package, on the
CPU: metrics from the same confusion counts and scores, the loss, the
batch loader and its prefetcher, the deterministic splits and the
checkpoint names. Exact where the arithmetic is the same; the loss at
rtol 1e-6 (fp32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meant_tpu.data.datasets import split_arrays as j_split_arrays
from meant_tpu.data.loader import ArrayLoader as JArrayLoader
from meant_tpu.train.checkpoint import checkpoint_name as j_checkpoint_name
from meant_tpu.train.classify import sigmoid_ce_loss as j_sigmoid_ce_loss
from meant_tpu.utils import metrics as jm
from meant_tpu_torch.data.datasets import split_arrays
from meant_tpu_torch.data.loader import ArrayLoader, Prefetcher
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.classify import sigmoid_ce_loss
from meant_tpu_torch.utils import metrics as tm

import torch_threads

torch_threads.share_cores()


@pytest.mark.parametrize("num_classes", [2, 3])
def test_metrics_match_jax(num_classes):
    rng = np.random.RandomState(num_classes)
    probs = rng.rand(50, num_classes).astype(np.float32)
    labels = rng.randint(0, num_classes, 50).astype(np.int32)
    got = tm.confusion_delta(torch.tensor(probs), torch.tensor(labels),
                             num_classes)
    want = np.asarray(jm.confusion_delta(jnp.asarray(probs),
                                         jnp.asarray(labels), num_classes))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tm.metrics_from_confusion(want) == jm.metrics_from_confusion(want)
    scores = np.round(probs[:, -1], 1)               # ties in the ranks
    binary = (labels > 0).astype(np.int32)
    assert tm.binary_auroc(scores, binary) == jm.binary_auroc(scores,
                                                              binary)
    metrics = tm.F1Metrics(num_classes, "validation")
    metrics.update_cm(got)
    metrics.update_cm(got)
    assert metrics.compute() == jm.metrics_from_confusion(2 * want)


def test_sigmoid_ce_loss_matches_jax():
    rng = np.random.RandomState(1)
    out = rng.rand(6, 2).astype(np.float32)
    labels = rng.randint(0, 2, 6).astype(np.int32)
    weight = np.array([1, 1, 1, 1, 0, 0], np.float32)
    for w in (None, weight):
        got = sigmoid_ce_loss(torch.tensor(out), torch.tensor(labels),
                              None if w is None else torch.tensor(w))
        want = j_sigmoid_ce_loss(jnp.asarray(out), jnp.asarray(labels),
                                 None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
def test_array_loader_matches_jax(shuffle, drop):
    rng = np.random.RandomState(2)
    arrays = {"x": rng.randn(11, 3).astype(np.float32),
              "y": rng.randint(0, 2, 11).astype(np.int32)}
    got = list(ArrayLoader(arrays, 4, shuffle=shuffle, seed=5,
                           drop_remainder=drop))
    want = list(JArrayLoader(arrays, 4, shuffle=shuffle, seed=5,
                             drop_remainder=drop))
    assert len(got) == len(want) == (2 if drop else 3)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if not drop:
        np.testing.assert_array_equal(got[-1]["_weight"], [1, 1, 1, 0])


def test_prefetcher_keeps_order_converts_ints_and_reraises():
    arrays = {"x": np.arange(12, dtype=np.float32).reshape(6, 2),
              "y": np.arange(6, dtype=np.int32)}
    batches = list(Prefetcher(ArrayLoader(arrays, 2), "cpu"))
    assert [b["y"].tolist() for b in batches] == [[0, 1], [2, 3], [4, 5]]
    assert batches[0]["y"].dtype == torch.int64
    assert batches[0]["x"].dtype == torch.float32

    def broken():
        yield {"x": np.zeros(2, np.float32)}
        raise OSError("corrupt read")

    it = iter(Prefetcher(broken(), "cpu"))
    next(it)
    with pytest.raises(OSError, match="corrupt read"):
        next(it)


def test_splits_and_checkpoint_names_match_jax(tmp_path):
    arrays = {"x": np.arange(23), "y": np.arange(23) * 2}
    for a, b in zip(split_arrays(arrays), j_split_arrays(arrays)):
        for k in arrays:
            np.testing.assert_array_equal(a[k], b[k])
    assert ckpt.checkpoint_name("meant_src", 12, "Tempstock", "3", 7) == \
        j_checkpoint_name("meant_src", 12, "Tempstock", "3", 7)
    path = tmp_path / "models" / "m" / "name"
    ckpt.save(str(path), {"params": {"w": torch.arange(3.0)}, "step": 4})
    back = ckpt.restore(str(path))
    assert back["step"] == 4 and torch.equal(back["params"]["w"],
                                             torch.arange(3.0))
    assert [p.name for p in path.parent.iterdir()] == ["name"]
