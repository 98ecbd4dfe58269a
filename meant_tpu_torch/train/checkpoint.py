"""Checkpoints (counterpart of meant_tpu/train/checkpoint.py).

`checkpoint_name` keeps the reference's schema. The port's own format is
`torch.save` of a dict of tensors and ints: the model's state_dict under
`{file_path}/models/{model_name}/{name}` and the optimizer state (m, v,
step) under `{file_path}/optimizers/{model_name}/{name}`. Saves are
synchronous (the JAX package writes in the background; a later slice may
too). `graft` carries the encoder towers and the embedding of one
state_dict (a pretraining checkpoint) into another.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import torch


def checkpoint_name(model_name: str, num_encoders: int, dataset: str,
                    run_id: str, epoch: int) -> str:
    """Reference filename schema (`in_loop_train.py:331`)."""
    return f"{model_name}_{num_encoders}_{dataset}_{run_id}_{epoch}"


def save(path: str, tree: dict) -> None:
    """Write `tree` to `path` (directories made as needed), through a
    temporary file renamed into place, so a reader never sees half a
    checkpoint."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore(path: str, map_location=None) -> dict:
    """Read a checkpoint written by `save`, onto `map_location`."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


def graft(target: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor],
          prefixes: Sequence[str] = ("languageEncoders.", "visionEncoders.",
                                     "embedding.")) -> Dict[str, torch.Tensor]:
    """A copy of the `target` state_dict with each entry under one of
    `prefixes` taken from `source` (the reference's encoder grafting,
    `in_loop_train.py:496-507`). Keyed per entry, so per layer: a deeper
    source gives its first layers, a shallower one leaves the target's
    deeper layers as they were; an entry the source lacks is skipped; a
    shape that differs raises ValueError. The JAX package also grafts
    across its scanned (layer-stacked) layouts; those wait here with
    `--scan_layers`."""
    out = dict(target)
    for key, tgt in target.items():
        if not key.startswith(tuple(prefixes)) or key not in source:
            continue
        src = source[key]
        if src.shape != tgt.shape:
            raise ValueError(f"graft shape mismatch under {key}: source "
                             f"{tuple(src.shape)}, target {tuple(tgt.shape)}")
        out[key] = src
    return out
