"""Rotary / xPos positional embeddings (counterpart of meant_tpu/ops/rotary.py).

Conventions kept exactly (they decide logit parity):

* Frequencies use the *interleaved-pair* layout ``[f0, f0, f1, f1, ...]`` and
  ``rotate_half`` maps each pair ``(x1, x2) -> (-x2, x1)``.
* The xPos decay scale uses the *block* layout ``cat(scale, scale)``.
* xPos power is centred: ``(pos - len(positions) // 2) / scale_base``;
  queries are scaled by ``scale``, keys by ``scale ** -1``.
* Rotation touches ``t[..., :rot_dim]`` only; the tail passes through.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

# Frequency tables are built with numpy in float64 and truncated to fp32,
# the same constants the JAX package folds at trace time.


def lang_freqs(dim: int, theta: float = 10000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Language-modality inverse frequencies, shape (dim // 2,)."""
    exponents = np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim
    return torch.tensor(1.0 / (theta ** exponents), dtype=torch.float32,
                        device=device)


def pixel_freqs(dim: int, max_freq: float = 10.0,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Pixel-modality frequencies, shape (dim // 2,)."""
    return torch.tensor(np.linspace(1.0, max_freq / 2.0, dim // 2) * math.pi,
                        dtype=torch.float32, device=device)


def rope_angles(positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Outer product of positions and freqs, each freq repeated twice
    consecutively (interleaved pairs). Output (..., 2 * len(freqs))."""
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.repeat_interleave(ang, 2, dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation: (x1, x2) -> (-x2, x1)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def apply_rotary(t: torch.Tensor, angles: torch.Tensor, scale=1.0,
                 start_index: int = 0) -> torch.Tensor:
    """Rotate t[..., start:start+rot_dim] by angles in fp32 and cast back;
    `scale` multiplies both the cos and sin terms (xPos)."""
    rot_dim = angles.shape[-1]
    end_index = start_index + rot_dim
    if rot_dim > t.shape[-1]:
        raise ValueError(f"feature dim {t.shape[-1]} too small to rotate "
                         f"{rot_dim} positions")
    t_left = t[..., :start_index]
    t_mid = t[..., start_index:end_index].to(torch.float32)
    t_right = t[..., end_index:]
    cos = torch.cos(angles) * scale
    sin = torch.sin(angles) * scale
    t_mid = (t_mid * cos + rotate_half(t_mid) * sin).to(t.dtype)
    return torch.cat((t_left, t_mid, t_right), dim=-1)


def xpos_scale(dim: int, positions: torch.Tensor,
               scale_base: float = 512.0) -> torch.Tensor:
    """xPos decay scale for a full sequence, shape (len(positions), dim):
    concat(base ** power, base ** power) with
    base = (arange(0, dim, 2) + 0.4 dim) / (1.4 dim) and
    power = (positions - len(positions) // 2) / scale_base."""
    base = (torch.arange(0, dim, 2, dtype=torch.float32,
                         device=positions.device) + 0.4 * dim) / (1.4 * dim)
    power = (positions.to(torch.float32) - positions.shape[-1] // 2) \
        / scale_base
    scale = base ** power[..., None]
    return torch.cat((scale, scale), dim=-1)


def rotate_queries_or_keys(t: torch.Tensor, freqs: torch.Tensor
                           ) -> torch.Tensor:
    """Plain RoPE over the sequence axis (-2). t: (..., s, d)."""
    angles = rope_angles(torch.arange(t.shape[-2], device=t.device), freqs)
    return apply_rotary(t, angles)


def rotate_queries_and_keys(q: torch.Tensor, k: torch.Tensor,
                            freqs: torch.Tensor, rot_dim: int,
                            scale_base: float = 512.0):
    """xPos rotation: q scaled by `scale`, k by `scale ** -1`, shared angles
    from q's length."""
    positions = torch.arange(q.shape[-2], device=q.device)
    angles = rope_angles(positions, freqs)
    scale = xpos_scale(rot_dim, positions, scale_base)
    return (apply_rotary(q, angles, scale=scale),
            apply_rotary(k, angles, scale=scale ** -1))
