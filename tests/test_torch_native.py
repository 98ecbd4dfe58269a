"""The port's native data-path library (meant_tpu_torch/native: a copy of
JAX's collate.cpp built with g++, bound with ctypes) against the JAX
package's meant_tpu.native, bit for bit, on the CPU: the tokenizer (texts
with tabs and newlines included, which the library keeps inside a token
where a whitespace split would cut them), the lag collator and the image
centring, each through the library and through its numpy path; and the
CLIs that tokenize (tweet_eval, hug_train, in_loop_genia) reaching it."""

import numpy as np
import pytest

from meant_tpu import native as j_native
from meant_tpu_torch import native
from meant_tpu_torch.cli import hug_train, in_loop_genia, tweet_eval
from meant_tpu_torch.data import datasets

import torch_threads

torch_threads.share_cores()

TEXTS = ["", "one", "  two  spaced   words ", "a\tb", "line\nbreak here",
         "tab\t and\r\nCRLF", "\t\n", "w12 w7 w12 w999 " * 20,
         "naïve café, déjà-vu!", "$AAPL to the moon 🚀 #stocks"]


@pytest.fixture(params=["library", "numpy"])
def path(request, monkeypatch):
    """Both packages on their C++ library, or both on their numpy path."""
    if request.param == "numpy":
        monkeypatch.setattr(j_native, "_build", lambda: None)
        monkeypatch.setattr(native, "_build", lambda: None)
    else:
        assert native.available() and j_native.available()
    return request.param


@pytest.mark.parametrize("max_len", [2, 5, 16, 128])
def test_tokenizer_matches_jax(path, max_len):
    for vocab in (100, 64001):
        got = native.fnv1a_tokenize(TEXTS, max_len, vocab)
        want = j_native.fnv1a_tokenize(TEXTS, max_len, vocab)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_tab_and_newline_stay_inside_a_token_as_in_jax():
    """The repaired departure: JAX's library splits on spaces only, so
    "a\\tb" is one token (BOS, one id, EOS), where a whitespace split
    gives two. The port's tokenizer, its `hash_tokenize` and the name
    `data.datasets.fnv1a_tokenize` all go through the library."""
    assert native.available() and j_native.available()
    ids, mask = native.fnv1a_tokenize(["a\tb", "a b"], 8, 1000)
    assert mask.sum(1).tolist() == [3.0, 4.0]
    want = j_native.fnv1a_tokenize(["a\tb", "a b"], 8, 1000)
    np.testing.assert_array_equal(ids, want[0])
    assert datasets.fnv1a_tokenize is native.fnv1a_tokenize
    tok = datasets.hash_tokenize(1000, 8)
    assert tok("line\nbreak") == ids_of("line\nbreak", 1000, 8)
    assert len(tok("line\nbreak")) == 3


def ids_of(text, vocab, max_len):
    ids, mask = j_native.fnv1a_tokenize([text], max_len, vocab)
    return ids[0, : int(mask[0].sum())].tolist()


@pytest.mark.parametrize("cli", [tweet_eval, hug_train, in_loop_genia])
def test_tokenizing_clis_use_the_library(cli):
    assert cli.fnv1a_tokenize is native.fnv1a_tokenize


def test_pad_two_level_matches_jax(path):
    rng = np.random.RandomState(0)
    lists = [[rng.randint(0, 500, size=rng.randint(0, 12)).tolist()
              for _ in range(5)] for _ in range(6)]
    for max_len in (1, 7, 16):
        for g, w in zip(native.pad_two_level(lists, max_len, pad_id=1),
                        j_native.pad_two_level(lists, max_len, pad_id=1)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_center_pad_images_matches_jax(path):
    rng = np.random.RandomState(1)
    images = [rng.rand(3, h, w).astype(np.float32)
              for h, w in ((5, 7), (12, 12), (3, 16), (17, 9))]
    for g, w in zip(native.center_pad_images(images, 12, 14),
                    j_native.center_pad_images(images, 12, 14)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_library_builds_into_the_build_dir_keyed_by_source_and_flags(
        monkeypatch):
    assert native.available()
    path = native.library_path()
    assert path.parent.name == "_build" and path.exists()
    assert path.parent.parent.name == "meant_tpu_torch"
    monkeypatch.setenv("MEANT_NATIVE_ARCH", "native")
    assert native.library_path() != path
