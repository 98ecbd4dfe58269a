"""Pretraining models (counterpart of meant_tpu/models/pretrainers.py).

meant_language_pretrainer: embeddings -> N languageEncoders -> a
RoBERTa-style LM head (dense -> gelu -> LayerNorm -> vocabulary decoder)
for MLM with CE over the vocabulary.

meant_vision_pretrainer: patchEmbed -> N visionEncoders -> the tokens as a
(b, √n, √n, dim) map -> a per-position Linear dim -> patch²·3 (the
reference's 1x1 conv) -> pixel shuffle, reconstructing RGB.

Depth is `num_encoders` in both, as the JAX package builds them (the
reference's vision pretrainer builds one encoder at any depth, DEFECTS
#29). Each model takes `device` (the card unless named) and `seed`, and
the levers `remat` and `scan_layers` of its tower (nn/stack.py), like the
port's other models.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.functional import pixel_shuffle

from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.models.meant import (EmbeddingConfig, LanguageTower,
                                          VisionTower, make_embedding)
from meant_tpu_torch.nn.layers import (LayerNorm, Linear, SeededInit, gelu,
                                       init_weights)
from meant_tpu_torch.ops.patch import patchify

__all__ = ["RobertaLMHead", "meant_language_pretrainer",
           "meant_vision_pretrainer", "pixel_shuffle"]


class RobertaLMHead(SeededInit, nn.Module):
    """dense -> gelu -> LayerNorm -> decoder(vocab) (HF RobertaLMHead).

    `tied=True` (HF `tie_word_embeddings`, the reference's default) owns
    only an fp32 `decoder_bias`; the forward takes the (vocab, hidden)
    word-embedding table as `shared_kernel`, so the model registers the
    table once and its gradient is the sum of both uses. `tied=False`
    builds a standalone `decoder` Linear."""

    def __init__(self, hidden_size: int, vocab_size: int, tied: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.dense = Linear(hidden_size, hidden_size, dtype=dtype,
                            device=device)
        self.norm = LayerNorm(hidden_size, device=device)
        if tied:
            self.decoder_bias = nn.Parameter(torch.empty(vocab_size,
                                                         device=device))
        else:
            self.decoder = Linear(vocab_size, hidden_size, dtype=dtype,
                                  device=device)

    def reset_parameters(self, generator):
        if hasattr(self, "decoder_bias"):
            self.decoder_bias.zero_()

    def forward(self, x, shared_kernel=None):
        x = self.norm(gelu(self.dense(x)))
        if shared_kernel is None:
            return self.decoder(x)
        if self.dtype is not None:
            x, shared_kernel = x.to(self.dtype), shared_kernel.to(self.dtype)
        out = F.linear(x, shared_kernel)
        return out + self.decoder_bias.to(out.dtype)


class meant_language_pretrainer(nn.Module):
    """forward(words (b, s), attention_mask (b, s), positions=None) ->
    (b, s, vocab) logits; with `positions` (b, k) the head runs on those
    token rows only and gives (b, k, vocab). MLM's CE ignores every
    unmasked position, so gathering the masked ones before the vocabulary
    projection leaves the loss and its gradients unchanged.

    With flash=True the tower drops the padding mask, as the reference's
    encoders do. `ff_dropout` defaults to the reference's nn.Dropout()
    p=0.5 (DEFECTS #22)."""

    def __init__(self, num_encoders: int,
                 embedding: EmbeddingConfig = EmbeddingConfig(),
                 flash: bool = False, lag: int = 5, text_dim: int = 768,
                 num_heads: int = 8, ff_dropout: float = 0.5,
                 scan_layers: bool = False, remat: Any = False,
                 tie_word_embeddings: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        self.remat, self.scan_layers = remat, scan_layers
        device = resolve_device(device)
        self.tie_word_embeddings = tie_word_embeddings
        self.embedding = make_embedding(embedding, dtype, device)
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads, flash=flash,
            ff_dropout=ff_dropout, dtype=dtype, device=device, remat=remat,
            scan_layers=scan_layers)
        self.mlm_head = RobertaLMHead(text_dim, embedding.vocab_size,
                                      tied=tie_word_embeddings, dtype=dtype,
                                      device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, words, attention_mask=None, positions=None):
        x = self.languageEncoders(self.embedding(words), attention_mask)
        if positions is not None:
            x = x.gather(1, positions[:, :, None].expand(-1, -1, x.shape[-1]))
        shared = (self.embedding.word_embeddings.weight
                  if self.tie_word_embeddings else None)
        return self.mlm_head(x, shared_kernel=shared)


class meant_vision_pretrainer(nn.Module):
    """forward(images (b, c, H, W)) -> (b, 3, H, W) reconstruction."""

    def __init__(self, num_encoders: int, patch_res: int = 16,
                 channels: int = 4, height: int = 224, width: int = 224,
                 image_dim: int = 768, num_heads: int = 8,
                 flash: bool = False, scan_layers: bool = False,
                 remat: Any = False, dtype: Optional[torch.dtype] = None,
                 device=None, seed: int = 0):
        super().__init__()
        self.remat, self.scan_layers = remat, scan_layers
        device = resolve_device(device)
        self.patch_res = patch_res
        self.patchEmbed = Linear(image_dim, channels * patch_res ** 2,
                                 dtype=dtype, device=device)
        self.visionEncoders = VisionTower(
            num_encoders, dim=image_dim, num_heads=num_heads, flash=flash,
            dtype=dtype, device=device, remat=remat, scan_layers=scan_layers)
        self.decoder = Linear(patch_res ** 2 * 3, image_dim, dtype=dtype,
                              device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, images):
        r = self.patch_res
        x = self.visionEncoders(self.patchEmbed(patchify(images, r)))
        b, n, d = x.shape
        hw = math.floor(n ** 0.5)
        # the (b, d, hw, hw) map read per position: a 1x1 conv is a Linear
        dec = self.decoder(x.reshape(b, hw, hw, d))      # (b, hw, hw, r²·3)
        return pixel_shuffle(dec.permute(0, 3, 1, 2), r)
