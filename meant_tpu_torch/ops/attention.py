"""Scaled dot-product attention, plain PyTorch (counterpart of
meant_tpu/ops/attention.py `attend`, `split_heads`, `merge_heads`).

Order of operations kept from the reference: fp32 scores times `scale`, the
causal -inf fill, then the additive `(1 - mask) * -1e9`, an fp32 softmax
cast to v's dtype, and P @ V accumulated in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, causal: bool = False,
           attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (..., s_q, d), k/v: (..., s_k, d); attention_mask (batch, s_k) of
    {0, 1} broadcast over heads and queries. Returns (..., s_q, d) in q's
    dtype. The products take fp32 operands (exact for bf16 inputs, whose
    fp32 products are exact) so the sums accumulate in fp32."""
    scores = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        row = torch.arange(s_q, device=q.device)[:, None]
        col = torch.arange(s_k, device=q.device)[None, :]
        scores = scores.masked_fill(col > row + (s_k - s_q), NEG_INF)
    if attention_mask is not None:
        bias = (1.0 - attention_mask.to(torch.float32)) * -1e9
        scores = scores + bias[:, None, None, :]
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(weights.to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, s, h*d) -> (b, h, s, d)."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, h, s, d) -> (b, s, h*d)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
