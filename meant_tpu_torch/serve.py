"""Batch inference (counterpart of meant_tpu/serve.py `Predictor`).

The model runs at a fixed batch size: a partial last batch is padded by
repeating its first row and the padded rows are dropped from the result.
`checkpoint_path` restores the params of a checkpoint the port's trainer
wrote (`train/checkpoint.py`). Mesh, tensor-parallel and int8 serving and
export are not ported yet (see ROADMAP).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from meant_tpu_torch.data.loader import host_tensor
from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.train import checkpoint as ckpt
from meant_tpu_torch.train.classify import model_inputs


class Predictor:
    """predictor = Predictor(model, model_name, batch_size=32)
    probs = predictor(batch_dict)  # numpy arrays with leading dim N

    The model serves the weights it holds (JAX weights can be loaded into
    it with `weights.load_jax_params`), or those of `checkpoint_path`, a
    checkpoint of the port's trainer for the same architecture. It is moved
    to `device` (the card unless named) and put in eval mode."""

    def __init__(self, model: nn.Module, model_name: str,
                 checkpoint_path: Optional[str] = None, batch_size: int = 32,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if checkpoint_path is not None:
            self.model.load_state_dict(
                ckpt.restore(checkpoint_path, self.device)["params"])
        self.model_name = model_name
        self.batch_size = batch_size

    def _device_batch(self, batch: Dict[str, np.ndarray]):
        return {k: host_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    @torch.inference_mode()
    def forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One fixed-size batch through the model; returns the device
        tensor of probabilities."""
        args, kwargs = model_inputs(self.model_name,
                                    self._device_batch(batch))
        return self.model(*args, **kwargs)

    def __call__(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(batch.values())))
        bs = self.batch_size
        outs = []
        for start in range(0, n, bs):
            chunk = {k: v[start:start + bs] for k, v in batch.items()}
            pad = bs - len(next(iter(chunk.values())))
            if pad:
                chunk = {k: np.concatenate(
                    [v, np.repeat(v[:1], pad, axis=0)], axis=0)
                    for k, v in chunk.items()}
            out = self.forward(chunk).float().cpu().numpy()
            outs.append(out[: bs - pad] if pad else out)
        return np.concatenate(outs, axis=0)
