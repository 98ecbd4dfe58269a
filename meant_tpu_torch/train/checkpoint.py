"""Checkpoints (counterpart of meant_tpu/train/checkpoint.py).

`checkpoint_name` keeps the reference's schema. The port's own format is
`torch.save` of a dict of tensors and ints: the model's state_dict under
`{file_path}/models/{model_name}/{name}` and the optimizer state (m, v,
step) under `{file_path}/optimizers/{model_name}/{name}`. Saves are
synchronous (the JAX package writes in the background; a later slice may
too). Grafting encoder stacks between checkpoints (`graft`) is not ported
yet.
"""

from __future__ import annotations

import os

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
