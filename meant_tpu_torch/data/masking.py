"""MLM / CLM / MIM masking (counterpart of meant_tpu/data/masking.py),
numpy, fixed shapes, the same `RandomState` draws as the JAX package.

  * `mask_tokens`: Bernoulli(p=0.15) over the non-special tokens; masked
    inputs become mask_id; labels are -100 everywhere except at masked
    positions. There is no 80/10/10 split, as in the reference.
  * `shift_labels_clm`: labels shifted left, the last position -100.
  * `mask_image`: a per-PIXEL (not per-patch) Bernoulli mask; masked pixels
    become mask_value; labels are -100 on the unmasked pixels.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

IGNORE_INDEX = -100


def mask_tokens(input_ids: np.ndarray, mask_token_id: int,
                special_ids: Sequence[int], mlm_probability: float = 0.15,
                seed: int = 0):
    """Returns (masked_inputs, labels)."""
    rng = np.random.RandomState(seed)
    labels = input_ids.copy()
    prob = np.full(labels.shape, mlm_probability)
    special = np.isin(input_ids, np.asarray(list(special_ids)))
    prob[special] = 0.0
    masked = rng.random_sample(labels.shape) < prob
    labels[~masked] = IGNORE_INDEX
    inputs = input_ids.copy()
    inputs[masked] = mask_token_id
    return inputs, labels


def shift_labels_clm(input_ids: np.ndarray):
    labels = input_ids.copy()
    labels[..., :-1] = input_ids[..., 1:]
    labels[..., -1] = IGNORE_INDEX
    return labels


def mask_image(images: np.ndarray, mask_probability: float = 0.15,
               mask_value: float = 0.0, seed: int = 0):
    """Returns (masked, labels); labels are IGNORE_INDEX on the unmasked
    pixels."""
    rng = np.random.RandomState(seed)
    labels = images.copy()
    mask = rng.random_sample(images.shape) < mask_probability
    inputs = np.where(mask, mask_value, images)
    labels[~mask] = IGNORE_INDEX
    return inputs.astype(images.dtype), labels
