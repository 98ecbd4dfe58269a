"""teanet, the external baseline the reference harnesses compare against
(counterpart of meant_tpu/models/teanet.py, itself rebuilt from the TEANet
design): per-day token embedding mean-pooled, concatenated with the day's
price features, a post-norm transformer over the lag axis, the 'src'
target-day attention readout and a sigmoid classifier.

forward(tweets (b, lag, s) token ids, possibly float-cast; prices (b, lag,
price_dim)) -> (b, num_classes).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.nn.attention_modules import (
    MultiHeadDotProductAttention, TemporalAttention)
from meant_tpu_torch.nn.layers import Embed, Linear, gelu, init_weights, \
    make_norm


class teanet(nn.Module):

    def __init__(self, dim: int = 128, num_heads: int = 4,
                 num_classes: int = 2, vocab_size: int = 64001,
                 price_dim: int = 4, num_layers: int = 2,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        kw = dict(dtype=dtype, device=device)
        self.embedding = Embed(vocab_size, dim, std=0.02, device=device)
        self.fuse = Linear(dim, dim + price_dim, **kw)
        for i in range(num_layers):
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(
                dim, num_heads, **kw))
            self.add_module(f"norm1_{i}", make_norm("layer", dim, device))
            self.add_module(f"ff_in_{i}", Linear(dim, dim, **kw))
            self.add_module(f"ff_{i}", Linear(dim, dim, **kw))
            self.add_module(f"norm2_{i}", make_norm("layer", dim, device))
        self.temporal = TemporalAttention(num_heads, dim, variant="src", **kw)
        self.head = Linear(num_classes, dim, **kw)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, tweets, prices):
        text = self.embedding(tweets).mean(dim=2)          # (b, lag, d)
        x = self.fuse(torch.cat((text, prices.to(text.dtype)), dim=-1))
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")
            x = layer("norm1")(x + layer("attn")(x))
            h = layer("ff")(gelu(layer("ff_in")(x)))
            x = layer("norm2")(x + h)
        return torch.sigmoid(self.head(self.temporal(x)))
