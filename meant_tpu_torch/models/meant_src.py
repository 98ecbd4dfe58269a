"""src-era MEANT (counterpart of meant_tpu/models/meant_src.py `meant_src`).

Reference defect kept behind a flag: the learned sequence projection is
`Linear(seq_len, 1) -> LayerNorm(1) -> GELU`, and a LayerNorm over one
feature maps every input to its bias, so at `fixed_proj=False` (the
default, bug-faithful) both towers reach the temporal stage as a constant.
`fixed_proj=True` drops the LayerNorm.

`flash_text` / `flash_vision` override `flash` per tower (None follows
`flash`); `remat` and `scan_layers` are the towers' levers (nn/stack.py).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.models.meant import (EmbeddingConfig, LanguageTower,
                                          MlpHead, VisionTower,
                                          make_embedding)
from meant_tpu_torch.nn.encoders import TemporalEncoder
from meant_tpu_torch.nn.layers import Linear, gelu, init_weights, make_norm
from meant_tpu_torch.ops.patch import patchify


class SeqProjection(nn.Module):
    """lang_proj / image_proj: project the sequence axis to 1.
    (b, l, d, s) -> (b, l, d)."""

    def __init__(self, seq_len: int, fixed: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.proj = Linear(1, seq_len, init_style="torch", dtype=dtype,
                           device=device)
        self.norm = None if fixed else make_norm("layer", 1, device)

    def forward(self, x):
        x = self.proj(x)
        if self.norm is not None:
            x = self.norm(x)
        return gelu(x).squeeze(-1)


class meant_src(nn.Module):
    """src-era meant: LayerNorm + xavier encoders, sequence-projection
    fusion, src temporal stage, LayerNorm + sigmoid head.

    forward(input_ids (b, lag, s), pixels (b, lag, c, H, W),
            prices (b, lag, price_dim), attention_mask (b, lag, s))
    -> (b, num_classes).

    Built on `device` (the card unless named) with weights drawn from
    `torch.Generator(device).manual_seed(seed)`. The constructor keeps the
    JAX package's positional order and fields; `lag` is read from the
    inputs.
    """

    def __init__(self, text_dim: int, image_dim: int, price_dim: int,
                 height: int, width: int, patch_res: int, lag: int,
                 num_classes: int, embedding: EmbeddingConfig = EmbeddingConfig(),
                 flash: bool = False, num_heads: int = 8,
                 num_encoders: int = 1, channels: int = 3, seq_len: int = 512,
                 fixed_proj: bool = False, logits_head: bool = False,
                 remat: Any = False, scan_layers: bool = False,
                 flash_text: Optional[bool] = None,
                 flash_vision: Optional[bool] = None,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.remat, self.scan_layers = remat, scan_layers
        flash_text = flash if flash_text is None else flash_text
        flash_vision = flash if flash_vision is None else flash_vision
        self.text_dim, self.image_dim = text_dim, image_dim
        self.patch_res, self.seq_len, self.dtype = patch_res, seq_len, dtype
        n_patches = (height // patch_res) * (width // patch_res)
        tower = dict(norm="layer", ff_norm2="rms", init_style="xavier",
                     dtype=dtype, device=device, remat=remat,
                     scan_layers=scan_layers)
        self.embedding = make_embedding(embedding, dtype, device)
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads,
            flash=flash_text, **tower)
        self.lang_proj = SeqProjection(seq_len, fixed=fixed_proj,
                                       dtype=dtype, device=device)
        self.patchEmbed = Linear(image_dim, channels * patch_res ** 2,
                                 init_style="torch", dtype=dtype,
                                 device=device)
        self.visionEncoders = VisionTower(
            num_encoders, dim=image_dim, num_heads=num_heads,
            flash=flash_vision, **tower)
        self.image_proj = SeqProjection(n_patches, fixed=fixed_proj,
                                        dtype=dtype, device=device)
        dim = text_dim + price_dim + image_dim
        self.temporal_encoding_0 = TemporalEncoder(dim, num_heads, lag,
                                                   style="src", dtype=dtype,
                                                   device=device)
        self.mlpHead = MlpHead(dim, num_classes, norm="layer",
                               logits=logits_head, dtype=dtype,
                               device=device)
        generator = torch.Generator(device=device).manual_seed(seed)
        init_weights(self, generator)

    def forward(self, input_ids=None, pixels=None, prices=None,
                attention_mask=None, labels=None, **_):
        b = pixels.shape[0]
        lag, s = input_ids.shape[1], input_ids.shape[2]
        words = self.embedding(input_ids.reshape(b * lag, s))
        if attention_mask is not None:
            attention_mask = attention_mask.reshape(b * lag, s)
        words = self.languageEncoders(words, attention_mask)
        # (b*l, s, d) -> (b, l, d, s), zero-padded along s to seq_len
        words = words.reshape(b, lag, s, self.text_dim).permute(0, 1, 3, 2)
        if s < self.seq_len:
            words = F.pad(words, (0, self.seq_len - s))
        words = self.lang_proj(words)

        imgs = patchify(pixels.reshape(b * lag, *pixels.shape[2:]),
                        self.patch_res)
        imgs = self.visionEncoders(self.patchEmbed(imgs))
        n = imgs.shape[1]
        imgs = imgs.reshape(b, lag, n, self.image_dim).permute(0, 1, 3, 2)
        imgs = self.image_proj(imgs)

        fused = torch.cat((words, imgs, prices.to(words.dtype)), dim=2)
        if self.dtype is not None:
            fused = fused.to(self.dtype)
        return self.mlpHead(self.temporal_encoding_0(fused))
