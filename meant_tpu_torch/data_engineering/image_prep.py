"""Chart-image preparation (counterpart of
meant_tpu/data_engineering/image_prep.py; the reference's
`meant_data/image.py:12-48`).

Per-ticker PNG chart images -> resize(224, 224) -> CHW float arrays in [0,1]
(torchvision ToTensor semantics), concatenated per ticker, only for dates
that also have tweets. Output: one (days, c, 224, 224) .npy per ticker.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def load_chart(path: str, size: int = 224) -> np.ndarray:
    """PNG -> (c, size, size) float32 in [0, 1] (Resize + ToTensor)."""
    from PIL import Image
    img = Image.open(path)
    img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr.transpose(2, 0, 1)


def prepare_ticker(graph_dir: str, tweet_dir: str, out_path: str,
                   size: int = 224) -> Optional[np.ndarray]:
    """Stack charts for every tweet-dated day that has a graph
    (`meant_data/image.py:31-48`)."""
    files = sorted(os.listdir(tweet_dir))
    charts = []
    for f in files:
        date = f.split(".")[0]
        image_path = os.path.join(graph_dir, f"{date}.png")
        if os.path.isfile(image_path):
            charts.append(load_chart(image_path, size))
    if not charts:
        return None
    stacked = np.stack(charts)
    np.save(out_path, stacked)
    return stacked


def align_dates(tweet_arrays: dict, graph_dates: set) -> dict:
    """Re-index tweet arrays to dates that have graphs
    (`tweets_2.py:42-66`)."""
    return {d: v for d, v in tweet_arrays.items() if d in graph_dates}
