"""Attention modules of the MEANT family (counterpart of
meant_tpu/nn/attention_modules.py: XPosAttention, RotaryAttention and
TemporalAttention in its 'src' and 'paper' variants).

Each module owns its q/k/v/output projections and its rotary frequency
table, a non-trainable buffer carried over from the JAX params so a weight
transfer keeps the exact fp32 table. `flash=True` sends the attention
through `ops.flash.flash_attention` (the CUDA kernel on the card, its plain
version on the CPU); `flash=False` rotates in PyTorch and calls `attend`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from meant_tpu_torch import ops
from meant_tpu_torch.nn.layers import Linear
from meant_tpu_torch.ops.flash import flash_attention


class _QKVO(nn.Module):
    """q, k, v and multi_mad (output) projections of width dim, and the
    cache of the fused rotation tables built from the `freqs` buffer,
    emptied whenever a state dict is loaded."""

    def __init__(self, dim: int, init_style: str, dtype, device):
        super().__init__()
        kw = dict(init_style=init_style, dtype=dtype, device=device)
        self.q = Linear(dim, dim, **kw)
        self.k = Linear(dim, dim, **kw)
        self.v = Linear(dim, dim, **kw)
        self.multi_mad = Linear(dim, dim, **kw)
        self.rotation_tables: dict = {}
        self.register_load_state_dict_post_hook(
            lambda module, _: module.rotation_tables.clear())


class XPosAttention(_QKVO):
    """Causal language MHA with xPos rotary on the leading 48 features of
    each head (fewer when the head is narrower), scale 1/sqrt(dim), additive
    -1e9 padding mask."""

    def __init__(self, num_heads: int, dim: int, init_style: str = "torch",
                 flash: bool = False, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(dim, init_style, dtype, device)
        self.num_heads = num_heads
        self.rot_dim = min(48, dim // num_heads)
        self.scale = 1.0 / math.sqrt(dim)
        self.flash = flash
        self.register_buffer("freqs", ops.lang_freqs(self.rot_dim,
                                                     device=device))

    def forward(self, x, attention_mask=None):
        h = self.num_heads
        q, k, v = (ops.split_heads(p(x), h) for p in (self.q, self.k, self.v))
        if self.flash:
            out = flash_attention(q, k, v, scale=self.scale, causal=True,
                                  attention_mask=attention_mask,
                                  rope_freqs=self.freqs, xpos=True,
                                  tables_cache=self.rotation_tables)
        else:
            q, k = ops.rotate_queries_and_keys(q, k, self.freqs,
                                               rot_dim=self.rot_dim)
            out = ops.attend(q, k, v, scale=self.scale, causal=True,
                             attention_mask=attention_mask)
        return self.multi_mad(ops.merge_heads(out))


class RotaryAttention(_QKVO):
    """Vision MHA with pixel-frequency rotary on q and k, scale
    1/sqrt(dim), no causal mask, no padding mask. pixel_freqs((dim/heads)//2)
    gives 24 frequencies and 48 rotated features at dh=96."""

    def __init__(self, num_heads: int, dim: int, init_style: str = "torch",
                 flash: bool = False, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(dim, init_style, dtype, device)
        self.num_heads = num_heads
        self.scale = 1.0 / math.sqrt(dim)
        self.flash = flash
        self.register_buffer("freqs", ops.pixel_freqs(
            (dim // num_heads) // 2, device=device))

    def forward(self, x):
        h = self.num_heads
        q, k, v = (ops.split_heads(p(x), h) for p in (self.q, self.k, self.v))
        if self.flash:
            out = flash_attention(q, k, v, scale=self.scale, causal=False,
                                  rope_freqs=self.freqs, xpos=False,
                                  tables_cache=self.rotation_tables)
        else:
            q = ops.rotate_queries_or_keys(q, self.freqs)
            k = ops.rotate_queries_or_keys(k, self.freqs)
            out = ops.attend(q, k, v, scale=self.scale, causal=False)
        return self.multi_mad(ops.merge_heads(out))


class TemporalAttention(nn.Module):
    """Antecedent-lag attention: the query comes from the target (last) lag
    step only; keys and values span every lag step.

    variant='paper': scale 1/sqrt(dh*h), output (b, 1, dim).
    variant='src': scale 1/sqrt(dh), output flattened (b, dim); its xPos
    rotation is an exact identity (q_len == 1) and is omitted.
    With dim not divisible by heads (1541 = 8*192 + 5 in meant_src) the
    attention width is dh*h (1536) and the projections are uneven.
    """

    def __init__(self, num_heads: int, dim: int, variant: str = "paper",
                 init_style: str = "torch",
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if variant not in ("paper", "src"):
            raise ValueError(f"unknown variant {variant!r}")
        self.num_heads, self.variant = num_heads, variant
        self.dh = dim // num_heads if dim >= num_heads else 1
        self.atten_size = self.dh * num_heads
        kw = dict(init_style=init_style, dtype=dtype, device=device)
        self.q = Linear(self.atten_size, dim, **kw)
        self.k = Linear(self.atten_size, dim, **kw)
        self.v = Linear(self.atten_size, dim, **kw)
        self.multi_mad = Linear(dim, self.atten_size, **kw)

    def forward(self, x):
        b, lag, _ = x.shape
        h, dh = self.num_heads, self.dh
        scale = 1.0 / math.sqrt(dh if self.variant == "src" else dh * h)
        q = self.q(x[:, -1, :]).reshape(b, 1, h, dh).transpose(1, 2)
        k = self.k(x).reshape(b, lag, h, dh).transpose(1, 2)
        v = self.v(x).reshape(b, lag, h, dh).transpose(1, 2)
        out = ops.lag_attend(q, k, v, scale=scale)        # (b, h, 1, dh)
        out = out.transpose(1, 2).reshape(b, self.atten_size)
        if self.variant == "paper":
            out = out.reshape(b, 1, self.atten_size)
        return self.multi_mad(out)
