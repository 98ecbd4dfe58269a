"""VisualBERT and ViLT backbones (counterpart of meant_tpu/nn/hf_baselines.py),
the architectures the reference's HF baselines wrap.

VisualBERT: text word + position (arange) + token-type embeddings; visual
embeds through `visual_projection` plus visual position (ids 0) and visual
token-type (ids 1) embeddings; one LayerNorm and dropout over the
concatenated stream; post-LN `RobertaLayer`s at eps 1e-12; a tanh pooler on
token 0.

ViLT: BERT text embeddings (normed); a conv patch embedding (k = s = patch
over NCHW, Flax's "SAME" padding), a cls token and a position table drawn
for the config grid and resized bilinearly (align_corners) to the input's
grid; modality embeddings added after each stream; pre-LN `ViltLayer`s; a
final LayerNorm and a tanh pooler on token 0. Patches stay in their natural
order, as in JAX.

Raw JAX params (the embedding tables, ViLT's position table) are `Table`
modules holding `weight`, so `weights.py` maps each leaf to one key.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.nn.attention_modules import MultiHeadDotProductAttention
from meant_tpu_torch.nn.embeddings import clamped_lookup, lookup_words
from meant_tpu_torch.nn.layers import (Dense, FlaxLayerNorm, SeededInit,
                                       gelu)
from meant_tpu_torch.nn.roberta import RobertaLayer, padding_mask, seeded


def _resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int):
    """Bilinear resize with align_corners=True over the last two axes of
    (c, h, w), by JAX's own gathers and lerps (the same arithmetic as
    `F.interpolate(..., mode="bilinear", align_corners=True)`)."""
    c, h, w = x.shape
    if (h, w) == (out_h, out_w):
        return x

    def axis_weights(src, dst):
        if dst == 1:
            zero = torch.zeros(1, dtype=torch.int64, device=x.device)
            return zero, zero, torch.zeros(1, device=x.device)
        pos = torch.arange(dst, device=x.device) * (src - 1) / (dst - 1)
        lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, src - 1)
        hi = torch.clamp(lo + 1, 0, src - 1)
        return lo, hi, pos - lo

    hlo, hhi, hw = axis_weights(h, out_h)
    wlo, whi, ww = axis_weights(w, out_w)
    top = x[:, hlo][:, :, wlo] * (1 - ww) + x[:, hlo][:, :, whi] * ww
    bot = x[:, hhi][:, :, wlo] * (1 - ww) + x[:, hhi][:, :, whi] * ww
    return top * (1 - hw[:, None]) + bot * hw[:, None]


class Table(SeededInit, nn.Module):
    """A raw parameter of the JAX module (`self.param(name, init,
    shape)`), held as `weight`: drawn N(0, 0.02^2) or zeros."""

    def __init__(self, *shape: int, init: str = "normal", device=None):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.empty(shape, device=device))

    def reset_parameters(self, generator):
        if self.init == "zeros":
            self.weight.zero_()
        else:
            self.weight.normal_(0.0, 0.02, generator=generator)


class Conv(SeededInit, nn.Module):
    """Flax `nn.Conv(features, (k, k), strides=(k, k))` over NCHW input:
    "SAME" padding, a lecun-normal kernel (fan-in cin k k) and a zero bias,
    computed in `dtype` when given. weight (cout, cin, k, k)."""

    def __init__(self, features: int, in_channels: int, kernel: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.kernel, self.dtype = kernel, dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_channels, kernel, kernel), device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator):
        std = 1.0 / math.sqrt(self.weight[0].numel()) / .87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        self.bias.zero_()

    def forward(self, x):
        k = self.kernel
        pads = []
        for size in (x.shape[3], x.shape[2]):      # F.pad: last axis first
            total = -size % k                      # up to ceil(size / k) k
            pads += [total // 2, total - total // 2]
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv2d(F.pad(x.to(dt), pads), self.weight.to(dt),
                        self.bias.to(dt), stride=k)


class BertTextEmbeddings(nn.Module):
    """word + position (arange) + token-type embeddings, then LayerNorm and
    dropout when `apply_norm` (VisualBERT norms the joint stream instead);
    cast to `dtype` last. More tokens than the position table's rows
    raise."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 layer_norm_eps: float = 1e-12, dropout: float = 0.1,
                 apply_norm: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.word_embeddings = Table(vocab_size, hidden_size, device=device)
        self.position_embeddings = Table(max_position_embeddings,
                                         hidden_size, device=device)
        self.token_type_embeddings = Table(type_vocab_size, hidden_size,
                                           device=device)
        self.norm = (FlaxLayerNorm(hidden_size, layer_norm_eps,
                                   device=device) if apply_norm else None)
        self.drop = nn.Dropout(dropout)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = self.position_embeddings.weight
        if s > pos.shape[0]:
            raise ValueError(f"{s} tokens exceed the text position table's "
                             f"{pos.shape[0]} rows (max_position_embeddings)")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (lookup_words(self.word_embeddings, input_ids)
             + pos[None, :s]
             + clamped_lookup(self.token_type_embeddings.weight,
                              token_type_ids))
        if self.norm is not None:
            x = self.drop(self.norm(x))
        if self.dtype is not None:
            x = x.to(self.dtype)
        return x


class VisualBertModel(nn.Module):
    """HF `VisualBertModel`: forward(input_ids, attention_mask,
    token_type_ids, visual_embeds, visual_attention_mask,
    visual_token_type_ids) -> (hidden, pooled)."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072,
                 visual_embedding_dim: int = 2048,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 layer_norm_eps: float = 1e-12, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        kw = dict(dtype=dtype, device=device)
        self.text_embeddings = BertTextEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            type_vocab_size, layer_norm_eps, apply_norm=False, **kw)
        self.visual_projection = Dense(hidden_size, visual_embedding_dim,
                                       **kw)
        self.visual_position_embeddings = Table(
            max_position_embeddings, hidden_size, device=device)
        self.visual_token_type_embeddings = Table(
            type_vocab_size, hidden_size, device=device)
        self.embeddings_norm = FlaxLayerNorm(hidden_size, layer_norm_eps,
                                             device=device)
        self.embeddings_drop = nn.Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", RobertaLayer(
                hidden_size, num_heads, intermediate_size, dropout,
                layer_norm_eps, **kw))
        self.pooler = Dense(hidden_size, hidden_size, **kw)
        seeded(self, device, seed)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                visual_embeds=None, visual_attention_mask=None,
                visual_token_type_ids=None):
        f32 = torch.float32
        text = self.text_embeddings(input_ids, token_type_ids)
        if visual_embeds is not None:
            b, n_vis = visual_embeds.shape[:2]
            vis = self.visual_projection(visual_embeds)
            if visual_token_type_ids is None:
                visual_token_type_ids = torch.ones(
                    (b, n_vis), dtype=torch.int64, device=vis.device)
            # visual position ids are zeros (no image-text alignment)
            vis = (vis + self.visual_position_embeddings.weight[None, :1]
                   + clamped_lookup(self.visual_token_type_embeddings.weight,
                                    visual_token_type_ids))
            x = torch.cat((text, vis.to(text.dtype)), dim=1)
            if attention_mask is None:
                attention_mask = torch.ones(input_ids.shape, dtype=f32,
                                            device=x.device)
            if visual_attention_mask is None:
                visual_attention_mask = torch.ones((b, n_vis), dtype=f32,
                                                   device=x.device)
            mask = torch.cat((attention_mask.to(f32),
                              visual_attention_mask.to(f32)), dim=1)
        else:
            x, mask = text, attention_mask
        x = self.embeddings_drop(self.embeddings_norm(x))
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class ViltLayer(nn.Module):
    """Pre-LN ViT block: x + drop(MHA(LN(x))), then x + drop(FF(LN(x)))."""

    def __init__(self, hidden_size: int, num_heads: int = 12,
                 intermediate_size: int = 3072, dropout: float = 0.0,
                 layer_norm_eps: float = 1e-12,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.layernorm_before = FlaxLayerNorm(hidden_size, layer_norm_eps,
                                              device=device)
        self.attention = MultiHeadDotProductAttention(hidden_size, num_heads,
                                                      **kw)
        self.attn_drop = nn.Dropout(dropout)
        self.layernorm_after = FlaxLayerNorm(hidden_size, layer_norm_eps,
                                             device=device)
        self.intermediate = Dense(intermediate_size, hidden_size, **kw)
        self.output = Dense(hidden_size, intermediate_size, **kw)
        self.out_drop = nn.Dropout(dropout)

    def forward(self, x, attention_mask=None):
        h = self.attention(self.layernorm_before(x),
                           padding_mask(attention_mask))
        x = x + self.attn_drop(h)
        h = self.output(gelu(self.intermediate(self.layernorm_after(x))))
        return x + self.out_drop(h)


class ViltModel(nn.Module):
    """HF `ViltModel`: forward(input_ids (b, s), pixel_values (b, c, H, W),
    attention_mask, token_type_ids) -> (hidden, pooled)."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072,
                 max_position_embeddings: int = 40, type_vocab_size: int = 2,
                 modality_type_vocab_size: int = 2, image_size: int = 384,
                 patch_size: int = 32, num_channels: int = 3,
                 layer_norm_eps: float = 1e-12, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.num_layers, self.hidden_size = num_layers, hidden_size
        self.grid = image_size // patch_size
        kw = dict(dtype=dtype, device=device)
        self.text_embeddings = BertTextEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            type_vocab_size, layer_norm_eps, dropout, apply_norm=True, **kw)
        self.patch_projection = Conv(hidden_size, num_channels, patch_size,
                                     **kw)
        self.position_embeddings = Table(1, self.grid ** 2 + 1, hidden_size,
                                         init="zeros", device=device)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, hidden_size),
                                                  device=device))
        self.img_drop = nn.Dropout(dropout)
        self.token_type_embeddings = Table(modality_type_vocab_size,
                                           hidden_size, device=device)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ViltLayer(
                hidden_size, num_heads, intermediate_size, dropout,
                layer_norm_eps, **kw))
        self.layernorm = FlaxLayerNorm(hidden_size, layer_norm_eps,
                                       device=device)
        self.pooler = Dense(hidden_size, hidden_size, **kw)
        seeded(self, device, seed)

    def forward(self, input_ids, pixel_values, attention_mask=None,
                token_type_ids=None):
        b, d, g = input_ids.shape[0], self.hidden_size, self.grid
        text = self.text_embeddings(input_ids, token_type_ids)
        patches = self.patch_projection(pixel_values)      # (b, d, gh, gw)
        gh, gw = patches.shape[2:]
        pos = self.position_embeddings.weight
        spatial = pos[0, 1:].T.reshape(d, g, g)
        spatial = _resize_bilinear_align_corners(spatial, gh, gw)
        spatial = spatial.reshape(d, gh * gw).T
        img = patches.flatten(2).transpose(1, 2) + spatial[None]
        cls = (self.cls_token + pos[:, :1]).expand(b, 1, d).to(img.dtype)
        img = self.img_drop(torch.cat((cls, img), dim=1))
        modality = self.token_type_embeddings.weight
        text = text + modality[0]
        img = img + modality[1].to(img.dtype)
        x = torch.cat((text, img.to(text.dtype)), dim=1)
        f32 = torch.float32
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=f32,
                                        device=x.device)
        mask = torch.cat((attention_mask.to(f32),
                          torch.ones((b, img.shape[1]), dtype=f32,
                                     device=x.device)), dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        x = self.layernorm(x)
        return x, torch.tanh(self.pooler(x[:, 0]))
