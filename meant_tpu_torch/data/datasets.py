"""Deterministic dataset splits (counterpart of the split functions of
meant_tpu/data/datasets.py): the reference's two sklearn
train_test_split(random_state=42) calls, reproduced with numpy so index
membership and order are identical to sklearn's."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np


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
