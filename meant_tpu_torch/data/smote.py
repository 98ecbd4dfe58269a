"""SMOTE oversampling, numpy only (counterpart of meant_tpu/data/smote.py;
the neighbour draws make the same RandomState calls in the same order).

Rebuild of `smote.py:44-156`: lag-window feature vectors (graphs + tweets +
macds flattened per window) are class-rebalanced by synthesizing minority
samples on segments between a minority sample and one of its k nearest
minority neighbors — the standard SMOTE algorithm imblearn implements.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def smote(X: np.ndarray, y: np.ndarray, k_neighbors: int = 5,
          seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Binary SMOTE: oversample the minority class to match the majority.
    X: (n, d); y: (n,) in {0, 1}. Returns (X_resampled, y_resampled)."""
    rng = np.random.RandomState(seed)
    classes, counts = np.unique(y, return_counts=True)
    if len(classes) < 2 or counts.min() == counts.max():
        return X, y
    minority = classes[np.argmin(counts)]
    need = counts.max() - counts.min()
    Xm = X[y == minority]
    if len(Xm) < 2:
        return X, y
    k = min(k_neighbors, len(Xm) - 1)
    # pairwise distances within the minority class (small n — fine on host)
    d2 = ((Xm[:, None, :] - Xm[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn_idx = np.argsort(d2, axis=1)[:, :k]          # (m, k)

    base = rng.randint(0, len(Xm), size=need)
    neigh = nn_idx[base, rng.randint(0, k, size=need)]
    gaps = rng.random_sample(need)[:, None]
    synth = Xm[base] + gaps * (Xm[neigh] - Xm[base])
    X_out = np.concatenate([X, synth.astype(X.dtype)], axis=0)
    y_out = np.concatenate([y, np.full(need, minority, y.dtype)], axis=0)
    return X_out, y_out


def smote_lag_windows(graphs: np.ndarray, tweets: np.ndarray,
                      macds: np.ndarray, y: np.ndarray, seed: int = 42):
    """`smote.py:44-75,125-156`: flatten per-window (graphs, tweets, macds),
    resample, reshape back. Returns (graphs, tweets, macds, y) resampled."""
    n = len(y)
    g_shape, t_shape, m_shape = graphs.shape[1:], tweets.shape[1:], \
        macds.shape[1:]
    g = graphs.reshape(n, -1)
    t = tweets.reshape(n, -1)
    m = macds.reshape(n, -1)
    X = np.concatenate([g, t, m], axis=1)
    X_res, y_res = smote(X, y, seed=seed)
    gn, tn = g.shape[1], t.shape[1]
    n2 = len(y_res)
    return (X_res[:, :gn].reshape((n2,) + g_shape),
            X_res[:, gn:gn + tn].reshape((n2,) + t_shape),
            X_res[:, gn + tn:].reshape((n2,) + m_shape), y_res)
