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
                            scale_base: float = 512.0, offset: int = 0,
                            seq_len: Optional[int] = None):
    """xPos rotation: q scaled by `scale`, k by `scale ** -1`, shared angles
    from q's length. A chunk of a longer sequence (ring attention) passes
    its first position `offset` and the whole length `seq_len`: its rows of
    the whole sequence's angles and scale rotate it."""
    s = q.shape[-2]
    positions = torch.arange(seq_len or s, device=q.device)
    angles = rope_angles(positions, freqs)[offset:offset + s]
    scale = xpos_scale(rot_dim, positions, scale_base)[offset:offset + s]
    return (apply_rotary(q, angles, scale=scale),
            apply_rotary(k, angles, scale=scale ** -1))


# ---- the TimeSformer family's rotary -------------------------------------
#
# These take precomputed (sin, cos) tables, and the frame table is in the
# block layout cat(freqs, freqs) while `rotate_half` turns interleaved pairs
# (the reference's own mix). R1 rotates interleaved-pair tables only, so
# these stay plain PyTorch and never feed the flash kernels.


def axial_rotary_sincos(dim: int, h: int, w: int, max_freq: float = 10.0,
                        device=None):
    """2-D axial (sin, cos) tables for h*w patch tokens, each (h*w, dim):
    dim/4 log-spaced scales from 1 to max_freq/2 times pi over linspace(-1,
    1) rows (h) and columns (w), the two halves concatenated, then every
    element repeated twice."""
    f32 = torch.float32
    scales = torch.logspace(0.0, math.log(max_freq / 2) / math.log(2),
                            dim // 4, base=2.0, dtype=f32, device=device)
    h_seq = torch.linspace(-1.0, 1.0, h, dtype=f32,
                           device=device)[:, None] * scales * math.pi
    w_seq = torch.linspace(-1.0, 1.0, w, dtype=f32,
                           device=device)[:, None] * scales * math.pi
    x_sinu = h_seq[:, None, :].expand(h, w, dim // 4)
    y_sinu = w_seq[None, :, :].expand(h, w, dim // 4)
    sin = torch.cat((torch.sin(x_sinu), torch.sin(y_sinu)), dim=-1)
    cos = torch.cat((torch.cos(x_sinu), torch.cos(y_sinu)), dim=-1)
    sin = sin.reshape(h * w, dim // 2).repeat_interleave(2, dim=-1)
    cos = cos.reshape(h * w, dim // 2).repeat_interleave(2, dim=-1)
    return sin, cos


def frame_rotary_sincos(dim: int, n: int, device=None):
    """1-D (sin, cos) tables for n frames, each (n, dim), in the block
    layout cat(angles, angles)."""
    f32 = torch.float32
    inv_freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=f32,
                                                device=device) / dim))
    ang = torch.arange(n, dtype=f32, device=device)[:, None] * inv_freqs
    ang = torch.cat((ang, ang), dim=-1)
    return torch.sin(ang), torch.cos(ang)


def apply_rot_emb_sincos(q: torch.Tensor, k: torch.Tensor, sin: torch.Tensor,
                         cos: torch.Tensor):
    """Rotate the leading sin.shape[-1] features of q and k:
    t * cos + rotate_half(t) * sin, the tail passed through; the result is
    promoted with the fp32 tables."""
    rot_dim = sin.shape[-1]

    def rot(t):
        t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
        t_rot = t_rot * cos + rotate_half(t_rot) * sin
        return torch.cat((t_rot, t_pass.to(t_rot.dtype)), dim=-1)

    return rot(q), rot(k)
