"""Normalization primitives (counterpart of meant_tpu/ops/norms.py).

Both compute in fp32 and cast back to the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             offset: Optional[torch.Tensor] = None, p: float = -1.0,
             eps: float = 1e-8) -> torch.Tensor:
    """x / (rms(x) + eps) * scale [+ offset]; eps is added to the RMS, not
    inside the sqrt. With 0 <= p <= 1 only the first int(d * p) features
    enter the norm (partial RMSNorm)."""
    d = x.shape[-1]
    xf = x.to(torch.float32)
    if p < 0.0 or p > 1.0:
        norm_sq = torch.sum(xf * xf, dim=-1, keepdim=True)
        d_x = d
    else:
        d_x = int(d * p)
        norm_sq = torch.sum(xf[..., :d_x] ** 2, dim=-1, keepdim=True)
    rms = torch.sqrt(norm_sq) * (d_x ** -0.5)
    out = xf / (rms + eps) * scale.to(torch.float32)
    if offset is not None:
        out = out + offset.to(torch.float32)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.LayerNorm semantics (biased variance, eps inside sqrt)."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + offset.to(torch.float32)
    return out.to(x.dtype)
