"""Checkpoints (counterpart of meant_tpu/train/checkpoint.py).

`checkpoint_name` keeps the reference's schema. The port's own format is
`torch.save` of a dict of tensors and ints: the model's state_dict under
`{file_path}/models/{model_name}/{name}` and the optimizer state (m, v,
step) under `{file_path}/optimizers/{model_name}/{name}`.

`save(..., block=False)` copies every tensor of the tree to host memory
before it returns and writes the file on a background thread of its
`lane`, as the JAX package's orbax saves do: the optimizer's update
kernel changes the parameter and moment buffers in place, so a write
that read the live tensors later could hold a mixture of two steps.
Saves on one lane run one after another, saves on two lanes overlap;
`wait_for_saves` is the barrier (it raises a failed write's error) and
`restore` waits first. `graft` carries the encoder towers and the
embedding of one state_dict (a pretraining checkpoint) into another.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Sequence

import torch


def checkpoint_name(model_name: str, num_encoders: int, dataset: str,
                    run_id: str, epoch: int) -> str:
    """Reference filename schema (`in_loop_train.py:331`)."""
    return f"{model_name}_{num_encoders}_{dataset}_{run_id}_{epoch}"


_LANES: Dict[str, ThreadPoolExecutor] = {}
_PENDING: List[Future] = []
_LOCK = threading.Lock()


def _lane(name: str) -> ThreadPoolExecutor:
    with _LOCK:
        if name not in _LANES:
            _LANES[name] = ThreadPoolExecutor(
                1, thread_name_prefix=f"checkpoint-{name}")
        return _LANES[name]


def _snapshot(tree):
    """A copy of `tree` whose tensors are host tensors that share no
    memory with the originals; a CUDA tensor is copied in stream order,
    so the copy holds what the kernels enqueued before this call left."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.to("cpu", copy=True) if t.is_cuda else t.clone()
    if isinstance(tree, dict):
        return type(tree)((k, _snapshot(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return tree


def _write(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def save(path: str, tree: dict, block: bool = True,
         lane: str = "default") -> None:
    """Write `tree` to `path` (directories made as needed), through a
    temporary file renamed into place, so a reader never sees half a
    checkpoint. With block=False the tree is snapshotted to host memory
    now and written in the background on `lane`; with block=True this
    returns once the file (and every earlier save on `lane`) is written,
    and raises its error."""
    future = _lane(lane).submit(_write, os.path.abspath(path),
                                _snapshot(tree))
    if block:
        future.result()
    else:
        with _LOCK:
            _PENDING.append(future)


def wait_for_saves() -> None:
    """Wait for every background save of every lane; raise the first
    failed write's error once all have ended."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    errors = [f.exception() for f in pending]
    for e in errors:
        if e is not None:
            raise e


def restore(path: str, map_location=None) -> dict:
    """Read a checkpoint written by `save`, onto `map_location`, once the
    background saves have ended."""
    wait_for_saves()
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
