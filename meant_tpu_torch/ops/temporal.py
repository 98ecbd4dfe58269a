"""Temporal antecedent-lag attention (counterpart of
meant_tpu/ops/temporal.py). Lag is 5, so this is a skinny matmul pair in
plain PyTorch, as the JAX package leaves it to XLA."""

from __future__ import annotations

import torch

from meant_tpu_torch.ops.attention import attend


def lag_attend(q_last: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               scale: float) -> torch.Tensor:
    """q_last: (b, h, 1, d) target-day query; k, v: (b, h, lag, d).
    Returns (b, h, 1, d)."""
    return attend(q_last, k, v, scale=scale, causal=False)
