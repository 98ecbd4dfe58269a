"""MACD / RSI technical-indicator labeling, numpy only (counterpart of
meant_tpu/data/macd.py).

Rebuilds the offline labeling pipeline of `meant_data/macd.py:43-217` and
`src/macd.py` (which used the `ta` library — not available here, so EMA/RSI
are implemented directly with the same math ta uses):

  * EMA(span) = pandas ewm(span, adjust=False):
      e_t = alpha * x_t + (1 - alpha) * e_{t-1},  alpha = 2 / (span + 1)
  * MACD = EMA12 - EMA26; Signal = EMA9(MACD); Histogram = MACD - Signal.
  * RSI(14), Wilder smoothing: avg gains/losses via ewm(alpha=1/14,
    adjust=False); RSI = 100 - 100 / (1 + gain/loss).
  * Buy label rule (`meant_data/macd.py:150-152`): label=1 iff
      macd[t-1] < signal[t-1]  AND  macd[t] > signal[t]  AND  macd[t] > 0
    (signal-line crossover into positive territory); one-hot labels.
  * Per-day 4-feature vector [macd_{t-1}, signal_{t-1}, macd_t, signal_t]
    (`meant_data/macd.py:156`); the TempStockLarge CSVs instead carry the
    5-feature [EMA12, EMA26, Signal_Line, MACD_Histogram, MACD] per day
    (`src/utils/custom_datasets.py:446-470`) — both layouts are provided.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def ema(x: np.ndarray, span: int) -> np.ndarray:
    """pandas ewm(span=span, adjust=False).mean() semantics."""
    alpha = 2.0 / (span + 1.0)
    out = np.empty_like(x, dtype=np.float64)
    out[0] = x[0]
    for i in range(1, len(x)):
        out[i] = alpha * x[i] + (1 - alpha) * out[i - 1]
    return out


def macd_signal(close: np.ndarray, fast: int = 12, slow: int = 26,
                signal_span: int = 9):
    """Returns (macd, signal, histogram)."""
    close = np.asarray(close, dtype=np.float64)
    macd = ema(close, fast) - ema(close, slow)
    signal = ema(macd, signal_span)
    return macd, signal, macd - signal


def rsi(close: np.ndarray, window: int = 14) -> np.ndarray:
    """Wilder RSI (ta.momentum.rsi semantics, fillna 50 at the start)."""
    close = np.asarray(close, dtype=np.float64)
    delta = np.diff(close, prepend=close[0])
    gain = np.where(delta > 0, delta, 0.0)
    loss = np.where(delta < 0, -delta, 0.0)
    alpha = 1.0 / window
    avg_gain = np.empty_like(gain)
    avg_loss = np.empty_like(loss)
    avg_gain[0] = gain[0]
    avg_loss[0] = loss[0]
    for i in range(1, len(close)):
        avg_gain[i] = alpha * gain[i] + (1 - alpha) * avg_gain[i - 1]
        avg_loss[i] = alpha * loss[i] + (1 - alpha) * avg_loss[i - 1]
    rs = np.divide(avg_gain, avg_loss,
                   out=np.full_like(avg_gain, np.inf), where=avg_loss > 0)
    out = 100.0 - 100.0 / (1.0 + rs)
    out[avg_loss == 0] = 100.0
    out[(avg_gain == 0) & (avg_loss == 0)] = 50.0
    return out


def crossover_labels(macd: np.ndarray, signal: np.ndarray,
                     start: int = 27) -> Tuple[np.ndarray, np.ndarray]:
    """Buy-signal labels + per-day 4-vectors from day `start` on
    (`meant_data/macd.py:135-165` starts at 27 to skip fill-in values).
    Returns (features (n, 4), labels one-hot (n, 2))."""
    n = len(macd)
    feats, labels = [], []
    for x in range(start, n):
        buy = (macd[x - 1] < signal[x - 1]) and \
            (macd[x] > signal[x]) and (macd[x] > 0)
        feats.append([macd[x - 1], signal[x - 1], macd[x], signal[x]])
        labels.append([0, 1] if buy else [1, 0])
    return (np.asarray(feats, np.float32), np.asarray(labels, np.float32))


def tempstock_price_features(close: np.ndarray) -> np.ndarray:
    """TempStockLarge per-day 5-vector [EMA12, EMA26, Signal, Histogram,
    MACD] (`src/utils/custom_datasets.py:446-470` column layout)."""
    close = np.asarray(close, dtype=np.float64)
    e12 = ema(close, 12)
    e26 = ema(close, 26)
    macd = e12 - e26
    sig = ema(macd, 9)
    hist = macd - sig
    return np.stack([e12, e26, sig, hist, macd], axis=1).astype(np.float32)


def lag_windows(features: np.ndarray, labels: np.ndarray, lag: int = 5):
    """Slide a lag window over day-indexed features; the label of a window is
    the label of its LAST day (`smote.py:66-75` window construction).
    features: (days, ...); returns (windows (n, lag, ...), labels (n, ...))."""
    n = len(features)
    if n <= lag:
        return (np.empty((0, lag) + features.shape[1:], features.dtype),
                np.empty((0,) + labels.shape[1:], labels.dtype))
    idx = np.arange(lag)[None, :] + np.arange(n - lag + 1)[:, None]
    return features[idx], labels[lag - 1:]
