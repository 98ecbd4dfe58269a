"""Attention modules of the MEANT family (counterpart of
meant_tpu/nn/attention_modules.py: XPosAttention, RotaryAttention,
TemporalAttention in its 'src' and 'paper' variants, and TemporalAttention2),
and Flax's `nn.MultiHeadDotProductAttention`, which teanet and MOSI's audio
encoder use.

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
from meant_tpu_torch.nn.layers import Dense, Linear
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
    """Language MHA with xPos rotary on the leading `rot_dim` features of
    each head (48 unless named, fewer when the head is narrower; MOSI's
    encoder rotates 30), scale 1/sqrt(dim), additive -1e9 padding mask;
    causal unless `causal=False`."""

    def __init__(self, num_heads: int, dim: int, init_style: str = "torch",
                 flash: bool = False, causal: bool = True,
                 rot_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(dim, init_style, dtype, device)
        self.num_heads = num_heads
        self.rot_dim = min(rot_dim or 48, dim // num_heads)
        self.scale = 1.0 / math.sqrt(dim)
        self.flash, self.causal = flash, causal
        self.register_buffer("freqs", ops.lang_freqs(self.rot_dim,
                                                     device=device))

    def forward(self, x, attention_mask=None):
        h = self.num_heads
        q, k, v = (ops.split_heads(p(x), h) for p in (self.q, self.k, self.v))
        if self.flash:
            out = flash_attention(q, k, v, scale=self.scale,
                                  causal=self.causal,
                                  attention_mask=attention_mask,
                                  rope_freqs=self.freqs, xpos=True,
                                  tables_cache=self.rotation_tables)
        else:
            q, k = ops.rotate_queries_and_keys(q, k, self.freqs,
                                               rot_dim=self.rot_dim)
            out = ops.attend(q, k, v, scale=self.scale, causal=self.causal,
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


class TemporalAttention2(nn.Module):
    """temporal_2: lag attention over (b, lag, s, d). The query comes from
    the last lag step (every position), keys and values from every lag
    step; scale 1/sqrt(dh), fp32 softmax with an additive -1e9 mask over
    the keys; the output (b, s, lag * h * dh) goes through `multi_mad`,
    which the reference sizes by `lag`. A library module: no CLI model
    reaches it."""

    def __init__(self, num_heads: int, dim: int, lag: int = 5,
                 init_style: str = "xavier",
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dh = max(dim // num_heads, 1)
        atten = self.dh * num_heads
        kw = dict(init_style=init_style, dtype=dtype, device=device)
        self.q = Linear(atten, dim, **kw)
        self.k = Linear(atten, dim, **kw)
        self.v = Linear(atten, dim, **kw)
        self.multi_mad = Linear(dim, lag * atten, **kw)

    def forward(self, x, attention_mask=None):
        b, l, s, _ = x.shape
        h, dh = self.num_heads, self.dh
        f32 = torch.float32
        q = self.q(x[:, -1]).reshape(b, 1, s, h, dh).permute(0, 1, 3, 2, 4)
        k = self.k(x).reshape(b, l, s, h, dh).permute(0, 1, 3, 2, 4)
        v = self.v(x).reshape(b, l, s, h, dh).permute(0, 1, 3, 2, 4)
        scores = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) \
            / math.sqrt(dh)
        if attention_mask is not None:
            bias = (1.0 - attention_mask.to(f32)) * -1e9
            scores = scores + bias[:, :, None, None, :]
        inter = torch.matmul(torch.softmax(scores, dim=-1),
                             v.to(f32)).to(x.dtype)
        inter = inter.permute(0, 3, 1, 2, 4).reshape(b, s, l * h * dh)
        return self.multi_mad(inter)


class MultiHeadDotProductAttention(nn.Module):
    """Flax `nn.MultiHeadDotProductAttention(num_heads)` self-attention at
    its defaults: q, k, v projections to (heads, dim // heads) and the
    output projection back to `dim`, each with a bias (Flax's
    `DenseGeneral`, kept here as (out, in) matrices that stay in floating
    point under int8, as JAX's interceptor leaves `DenseGeneral` alone);
    q scaled by 1/sqrt(dh) before the product, a boolean `mask` (True
    attends) filling the scores with the dtype's lowest value, a softmax
    in the compute dtype, no dropout."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        kw = dict(quantize=False, dtype=dtype, device=device)
        self.query = Dense(dim, dim, **kw)
        self.key = Dense(dim, dim, **kw)
        self.value = Dense(dim, dim, **kw)
        self.out = Dense(dim, dim, **kw)

    def forward(self, x, mask=None):
        h = self.num_heads
        q, k, v = (ops.split_heads(p(x), h)
                   for p in (self.query, self.key, self.value))
        dt = q.dtype
        q = q / torch.sqrt(torch.tensor(q.shape[-1], dtype=dt))
        scores = torch.matmul(q, k.transpose(-1, -2))
        if mask is not None:
            scores = torch.where(mask, scores,
                                 torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1).to(dt)
        return self.out(ops.merge_heads(torch.matmul(weights, v)))
