"""CMU-MOSI preparation (counterpart of
meant_tpu/data_engineering/mosi_prep.py; the reference's `src/mosi.py:19-47`).

Loads the aligned_50 pickle (splits of dicts with raw_text / vision / audio /
labels), drops entries with empty text (`drop_entry`), and packs fixed-shape
arrays for the mosi trainer (text features or ids, 20-dim vision frames,
audio features, binary sentiment labels from the regression score sign).
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np


def drop_entry(split: Dict) -> Dict:
    """Remove samples whose raw text is empty (`src/mosi.py:24-36`)."""
    keep = [i for i, t in enumerate(split["raw_text"])
            if str(t).strip() != ""]
    return {k: (np.asarray(v)[keep] if hasattr(v, "__len__")
                and len(v) == len(split["raw_text"]) else v)
            for k, v in split.items()}


def load_aligned(path: str) -> Dict[str, Dict]:
    with open(path, "rb") as f:
        data = pickle.load(f)
    return {split: drop_entry(data[split]) for split in data}


def to_arrays(split: Dict, binary: bool = True) -> Dict[str, np.ndarray]:
    """Pack a split into the mosi trainer's batch keys. Labels: sign of the
    sentiment regression score for binary classification."""
    labels = np.asarray(split["labels"], np.float32).reshape(len(
        split["labels"]), -1)[:, 0]
    y = (labels > 0).astype(np.int32) if binary else labels
    return {
        "input_ids": np.asarray(split["text"], np.float32),
        "pixels": np.asarray(split["vision"], np.float32),
        "audio": np.asarray(split["audio"], np.float32),
        "audio_mask": np.ones(np.asarray(split["audio"]).shape[:2],
                              np.float32),
        "y": y,
    }
