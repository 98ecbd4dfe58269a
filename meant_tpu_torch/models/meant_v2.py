"""meant_v2 (counterpart of meant_tpu/models/meant_v2.py): the repaired
form of the reference's experimental variant, which folds the token
embedding into the first language encoder (`LanguageEncoderV2`); the rest
is `meant`'s. A library model: no --model_name builds it.

forward(tweets (b, lag, s), images (b, lag, c, H, W), attention_mask
(b, lag, s)) -> (b, num_classes).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.models.meant import (EmbeddingConfig, MlpHead,
                                          _patch_tokens, make_embedding)
from meant_tpu_torch.nn.encoders import (LanguageEncoder, TemporalEncoder,
                                         VisionEncoder)
from meant_tpu_torch.nn.layers import Linear, init_weights


class LanguageEncoderV2(nn.Module):
    """The first language block with the embedding folded in."""

    def __init__(self, dim: int, num_heads: int, embedding: EmbeddingConfig,
                 flash: bool = False, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.embedding = make_embedding(embedding, dtype, device)
        self.encoder = LanguageEncoder(dim, num_heads, flash=flash,
                                       dtype=dtype, device=device)

    def forward(self, input_ids, attention_mask=None):
        return self.encoder(self.embedding(input_ids), attention_mask)


class meant_v2(nn.Module):

    def __init__(self, text_dim: int, image_dim: int, price_dim: int,
                 height: int, width: int, patch_res: int, lag: int,
                 num_classes: int,
                 embedding: EmbeddingConfig = EmbeddingConfig(),
                 flash: bool = False, num_heads: int = 8,
                 num_encoders: int = 1, channels: int = 4,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.text_dim, self.image_dim, self.patch_res = (text_dim, image_dim,
                                                         patch_res)
        kw = dict(flash=flash, dtype=dtype, device=device)
        self.languageEncoders = nn.ModuleList(
            [LanguageEncoderV2(text_dim, num_heads, embedding, **kw)]
            + [LanguageEncoder(text_dim, num_heads, **kw)
               for _ in range(1, num_encoders)])
        self.patchEmbed = Linear(image_dim, channels * patch_res ** 2,
                                 dtype=dtype, device=device)
        self.visionEncoders = nn.ModuleList(
            VisionEncoder(image_dim, num_heads, **kw)
            for _ in range(num_encoders))
        dim = text_dim + image_dim
        self.temporal_encoding_0 = TemporalEncoder(
            dim, num_heads, lag, style="paper", dtype=dtype, device=device)
        self.mlpHead = MlpHead(dim, num_classes, norm="rms", dtype=dtype,
                               device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, tweets, images, attention_mask=None):
        b = images.shape[0]
        lag, s = tweets.shape[1], tweets.shape[2]
        if attention_mask is not None:
            attention_mask = attention_mask.reshape(b * lag, s)
        words = tweets.reshape(b * lag, s)
        for enc in self.languageEncoders:
            words = enc(words, attention_mask)
        words = words.reshape(b, lag, s, self.text_dim)
        imgs = _patch_tokens(self, images.reshape(b * lag, *images.shape[2:]))
        for enc in self.visionEncoders:
            imgs = enc(imgs)
        imgs = imgs.reshape(b, lag, imgs.shape[1], self.image_dim)
        fused = torch.cat((words.mean(dim=2), imgs.mean(dim=2)), dim=2)
        return self.mlpHead(self.temporal_encoding_0(fused)).squeeze(1)
