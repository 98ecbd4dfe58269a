"""Batch-to-forward dispatch (counterpart of the `KWARGS_MODELS` /
`model_inputs` part of meant_tpu/train/classify.py). Only the kwargs
family is ported; the trainer and the positional paper-era dispatch are
later slices (see ROADMAP)."""

from __future__ import annotations

from typing import Any, Dict

# kwargs-era models consume the batch dict directly (`forward(**batch)`).
KWARGS_MODELS = ("meant_src", "meant_price", "meant_timesformer",
                 "meant_mean_pooling", "meant_mosi", "mlp", "lstm")
_NON_INPUT_KEYS = ("y", "_weight", "labels")


def model_inputs(model_name: str, batch: Dict[str, Any]) -> tuple:
    """(args, kwargs) for `model(*args, **kwargs)`."""
    if model_name in KWARGS_MODELS:
        return (), {k: v for k, v in batch.items()
                    if k not in _NON_INPUT_KEYS}
    raise NotImplementedError(
        f"model {model_name} is not yet ported to meant_tpu_torch "
        f"(see ROADMAP)")
