"""MEANT encoder blocks (counterpart of meant_tpu/nn/encoders.py).

Block skeleton shared by the language and vision encoders:

    inter = proj_out(dropout?(norm2(attn(proj_in(norm1(x))))))
    x1    = inter + x
    inter = ff_out(dropout2?(norm4(gelu(ff_in(norm3(x1))))))
    out   = inter + x1

The reference passes the padding mask only to its non-flash attention, so
with `flash=True` the mask is dropped, as in the JAX package at its default
`mask_in_flash=False`; `mask_in_flash=True` hands it to the flash kernels
(K1 / K2, or the streaming ones) as their key mask.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from meant_tpu_torch.nn.attention_modules import (RotaryAttention,
                                                  TemporalAttention,
                                                  XPosAttention)
from meant_tpu_torch.nn.layers import Linear, SeededInit, gelu, make_norm


class _Block(nn.Module):
    """norm1..norm4 and the four projections of an encoder block."""

    def __init__(self, dim: int, norm: str, ff_norm2: Optional[str],
                 init_style: str, dtype, device):
        super().__init__()
        kw = dict(init_style=init_style, dtype=dtype, device=device)
        self.norm1 = make_norm(norm, dim, device)
        self.proj_in = Linear(dim, dim, **kw)
        self.norm2 = make_norm(norm, dim, device)
        self.proj_out = Linear(dim, dim, **kw)
        self.norm3 = make_norm(norm, dim, device)
        self.ff_in = Linear(dim, dim, **kw)
        self.norm4 = make_norm(ff_norm2 or norm, dim, device)
        self.ff_out = Linear(dim, dim, **kw)

    def _feed_forward(self, x1, drop: Optional[nn.Module] = None):
        inter = self.norm4(gelu(self.ff_in(self.norm3(x1))))
        if drop is not None:
            inter = drop(inter)
        return self.ff_out(inter) + x1


class LanguageEncoder(_Block):
    """ff_dropout defaults to the reference's nn.Dropout() p=0.5; `causal`,
    `rot_dim` and the ring options (`ring_mesh`, `ring_axis`,
    `ring_flash`: x and the output are this rank's chunk of a sequence
    split over the mesh axis) reach the xPos attention (MOSI rotates 30
    features)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 ff_dropout: float = 0.5, norm: str = "rms",
                 ff_norm2: Optional[str] = None, init_style: str = "torch",
                 flash: bool = False, mask_in_flash: bool = False,
                 causal: bool = True, rot_dim: Optional[int] = None,
                 ring_mesh=None, ring_axis: str = "data",
                 ring_flash: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(dim, norm, ff_norm2, init_style, dtype, device)
        self.flash, self.mask_in_flash = flash, mask_in_flash
        self.attn = XPosAttention(num_heads, dim, init_style=init_style,
                                  flash=flash, causal=causal,
                                  rot_dim=rot_dim, ring_mesh=ring_mesh,
                                  ring_axis=ring_axis, ring_flash=ring_flash,
                                  dtype=dtype, device=device)
        self.drop1 = nn.Dropout(dropout)
        self.drop2 = nn.Dropout(ff_dropout)

    def forward(self, x, attention_mask=None):
        mask = (None if self.flash and not self.mask_in_flash
                else attention_mask)
        inter = self.attn(self.proj_in(self.norm1(x)), mask)
        inter = self.proj_out(self.drop1(self.norm2(inter)))
        return self._feed_forward(inter + x, self.drop2)


class VisionEncoder(_Block):
    def __init__(self, dim: int, num_heads: int, norm: str = "rms",
                 ff_norm2: Optional[str] = None, init_style: str = "torch",
                 flash: bool = False, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(dim, norm, ff_norm2, init_style, dtype, device)
        self.attn = RotaryAttention(num_heads, dim, init_style=init_style,
                                    flash=flash, dtype=dtype, device=device)

    def forward(self, x):
        inter = self.attn(self.proj_in(self.norm1(x)))
        inter = self.proj_out(self.norm2(inter))
        return self._feed_forward(inter + x)


_TEMPORAL_STYLES = {
    # style: (norm_kind, use_temp_embedding, attn_variant, init_style)
    # paper: positional param + RMSNorm sandwich, paper temporal (b, 1, d).
    "paper": ("rms", True, "paper", "torch"),
    # slim (meant_tweet, meant_vision, meantPrice): paper without the norms.
    "slim": (None, True, "paper", "torch"),
    # src (meant_src): no positional param, LayerNorms, xavier init, src
    # temporal (flat (b, d) output).
    "src": ("layer", False, "src", "xavier"),
    # meant_price: src without the LayerNorms.
    "src_slim": (None, False, "src", "xavier"),
    # meantTweetPrice: positional param + RMSNorm sandwich, src temporal.
    "tweet_price": ("rms", True, "src", "torch"),
}


class TemporalEncoder(SeededInit, nn.Module):
    """temporalEncoder around the antecedent-lag attention, wired per
    generation by `_TEMPORAL_STYLES`:

        x = x + temp_embedding              # styles with the embedding
        x = proj_out(drop(norm2(temporal(proj_in(norm1(x))))))

    `temp_embedding` (1, lag, dim) is drawn N(0, 1) from the model's
    generator. A bf16 `x` plus this fp32 parameter is fp32, as in JAX."""

    def __init__(self, dim: int, num_heads: int, lag: int,
                 style: str = "paper", dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        norm_kind, use_embed, variant, init_style = _TEMPORAL_STYLES[style]
        kw = dict(init_style=init_style, dtype=dtype, device=device)
        self.temp_embedding = (nn.Parameter(torch.empty(
            (1, lag, dim), device=device)) if use_embed else None)
        self.norm1 = make_norm(norm_kind, dim, device) if norm_kind else None
        self.proj_in = Linear(dim, dim, **kw)
        self.temporal = TemporalAttention(num_heads, dim, variant=variant,
                                          **kw)
        self.norm2 = make_norm(norm_kind, dim, device) if norm_kind else None
        self.drop = nn.Dropout(dropout)
        self.proj_out = Linear(dim, dim, **kw)

    def reset_parameters(self, generator):
        if self.temp_embedding is not None:
            self.temp_embedding.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        if self.temp_embedding is not None:
            x = x + self.temp_embedding
        if self.norm1 is not None:
            x = self.norm1(x)
        x = self.temporal(self.proj_in(x))
        if self.norm2 is not None:
            x = self.norm2(x)
        return self.proj_out(self.drop(x))
