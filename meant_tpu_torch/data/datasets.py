"""TempStock-small loading, the synthetic TempStock set and deterministic
splits (counterpart of meant_tpu/data/datasets.py), numpy only.

* `load_tempstock_small` reads the SMOTE-resampled `.npy` arrays
  (graphs, tweets, attention_masks, macds, y_resampled, each with the lag
  suffix), optionally shifting the graphs by their global mean.
* `synthetic_tempstock` draws a TempStock-shaped set from a seed, with a
  learnable token planted on the target day.
* Splits are the reference's two sklearn train_test_split(random_state=42)
  calls, reproduced with numpy so index membership and order are identical
  to sklearn's.
* `hash_tokenize` is the JAX package's whitespace FNV-1a tokenizer in pure
  Python (its numpy fallback; JAX's native library gives the same ids on
  text split by spaces), and `read_csv_texts` reads the pretraining text
  column of a `.csv` with the standard library, as the JAX MLM harness
  reads it with pandas.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Tuple

import numpy as np


def load_tempstock_small(dir_path: str, lag_suffix: str = "_5",
                         normalize: bool = False) -> Dict[str, np.ndarray]:
    """`graphs{lag}.npy, tweets{lag}.npy, attention_masks{lag}.npy,
    macds{lag}.npy, y_resampled{lag}.npy` of `dir_path`, keyed graphs,
    tweets, attention_masks, macds, y."""
    def load(name):
        return np.load(os.path.join(dir_path, f"{name}{lag_suffix}.npy"))

    graphs = load("graphs")
    if normalize:
        graphs = graphs - graphs.mean()
    return {"graphs": graphs, "tweets": load("tweets"),
            "attention_masks": load("attention_masks"),
            "macds": load("macds"), "y": load("y_resampled")}


def synthetic_tempstock(n: int = 64, lag: int = 5, seq: int = 128,
                        channels: int = 4, size: int = 224,
                        vocab: int = 64000, seed: int = 0,
                        learnable: bool = True) -> Dict[str, np.ndarray]:
    """A TempStock-shaped set from `seed`; with `learnable`, the target
    day's first token is 3 for label 1 and 5 for label 0."""
    rng = np.random.RandomState(seed)
    tweets = rng.randint(4, vocab, size=(n, lag, seq)).astype(np.int32)
    graphs = rng.randn(n, lag, channels, size, size).astype(np.float32)
    macds = rng.randn(n, lag, 4).astype(np.float32)
    y = rng.randint(0, 2, size=(n,)).astype(np.int32)
    if learnable:
        tweets[y == 1, -1, 0] = 3
        tweets[y == 0, -1, 0] = 5
    masks = np.ones((n, lag, seq), np.float32)
    return {"graphs": graphs, "tweets": tweets, "attention_masks": masks,
            "macds": macds, "y": y}


def _sklearn_shuffle_split(n: int, test_size: float,
                           seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn `train_test_split(test_size=..., random_state=seed)`:
    `RandomState(seed).permutation(n)`, the first `ceil(test_size * n)`
    entries are the test part."""
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(math.ceil(test_size * n))
    return perm[n_test:], perm[:n_test]


def train_val_test_split(n: int, seed: int = 42, test_size: float = 0.2,
                         val_size: float = 0.25) -> Tuple[np.ndarray, ...]:
    """60/20/20: test carved off first, the rest split into train/val."""
    train_val, test = _sklearn_shuffle_split(n, test_size, seed)
    tr, va = _sklearn_shuffle_split(len(train_val), val_size, seed)
    return train_val[tr], train_val[va], test


def split_arrays(arrays: Dict[str, np.ndarray], seed: int = 42):
    """(train, val, test) dicts of the same keys."""
    n = len(next(iter(arrays.values())))
    tr, va, te = train_val_test_split(n, seed)
    pick = lambda sel: {k: v[sel] for k, v in arrays.items()}
    return pick(tr), pick(va), pick(te)


def _fnv1a(b: bytes) -> int:
    h = 1469598103934665603
    for c in b:
        h = ((h ^ c) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def fnv1a_tokenize(texts: List[str], max_len: int, vocab: int,
                   pad_id: int = 1):
    """Whitespace tokenizer: BOS/EOS id 2 around the first max_len - 2
    words, each hashed into [4, vocab). Returns (ids (n, max_len) int32,
    mask (n, max_len) f32)."""
    n = len(texts)
    ids = np.full((n, max_len), pad_id, np.int32)
    mask = np.zeros((n, max_len), np.float32)
    for i, t in enumerate(texts):
        toks = [2] + [4 + _fnv1a(w.encode("utf-8", "ignore")) % (vocab - 4)
                      for w in t.split()][: max_len - 2] + [2]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1.0
    return ids, mask


def hash_tokenize(vocab_size: int = 64000, max_len: int = 128):
    """text -> list of ids, BOS and EOS included (`fnv1a_tokenize`): the
    no-network stand-in for an HF tokenizer."""

    def tok(text: str):
        ids, mask = fnv1a_tokenize([text], max_len, vocab_size)
        return ids[0, : int(mask[0].sum())].tolist()

    return tok


# pandas.read_csv's default missing-value strings (`na_values`)
_CSV_NA = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def read_csv_texts(path: str) -> List[str]:
    """The first column of a `.csv` as `pd.read_csv(path).iloc[:,
    0].astype(str)` reads it: the first row is the header, blank lines are
    skipped, quoted fields may hold commas and newlines, and a missing
    value (an empty cell, "NA", ...) reads "nan", as pandas 2 gives it.
    A column pandas would parse as numbers keeps its text here."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [row for row in csv.reader(f) if row]
    return ["nan" if row[0] in _CSV_NA else row[0] for row in rows[1:]]
