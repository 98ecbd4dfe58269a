"""The MEANT family of the paper generation (counterpart of
meant_tpu/models/meant.py): EmbeddingConfig, MlpHead, the unrolled encoder
towers, and the models `meant`, `meant_vision`, `meant_tweet`,
`meant_tweet_no_lag`, `meantPrice` and `meant_vqa`.

Lag is folded into the batch for the per-day encoders, so each tower sees
(b * lag, s, d); the temporal stage then sees (b, lag, d). Each model keeps
the JAX constructor's positional order and field names, adds `device` (the
card unless named) and `seed` (weights drawn from
`torch.Generator(device).manual_seed(seed)`), and takes the JAX levers
`remat` (False, True / "full", "dots") and `scan_layers` (nn/stack.py: a
scanned tower keeps one module per block and rematerialises with "dots"
when `remat` is off, as JAX's scanned body does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.nn.embeddings import RobertaEmbeddings
from meant_tpu_torch.nn.encoders import (LanguageEncoder, TemporalEncoder,
                                         VisionEncoder)
from meant_tpu_torch.nn.layers import (Linear, SeededInit, init_weights,
                                       make_norm)
from meant_tpu_torch.nn.stack import run_block, tower_remat
from meant_tpu_torch.ops.patch import patchify


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    vocab_size: int = 64001
    hidden_size: int = 768
    max_position_embeddings: int = 130
    type_vocab_size: int = 1
    padding_idx: int = 1
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1


def make_embedding(cfg: EmbeddingConfig, dtype, device) -> RobertaEmbeddings:
    return RobertaEmbeddings(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=cfg.type_vocab_size, padding_idx=cfg.padding_idx,
        layer_norm_eps=cfg.layer_norm_eps, dropout=cfg.dropout, dtype=dtype,
        device=device)


class LanguageTower(nn.ModuleList):
    """`num_encoders` LanguageEncoders, one module each; in training each
    block rematerialises per `tower_remat(remat, scan_layers)`."""

    def __init__(self, num_encoders: int, remat: Any = False,
                 scan_layers: bool = False, **enc_kwargs):
        super().__init__([LanguageEncoder(**enc_kwargs)
                          for _ in range(num_encoders)])
        self.remat = tower_remat(remat, scan_layers)

    def forward(self, x, attention_mask=None):
        for enc in self:
            x = run_block(enc, self.remat, x, attention_mask)
        return x


class VisionTower(nn.ModuleList):
    """`num_encoders` VisionEncoders, as LanguageTower."""

    def __init__(self, num_encoders: int, remat: Any = False,
                 scan_layers: bool = False, **enc_kwargs):
        super().__init__([VisionEncoder(**enc_kwargs)
                          for _ in range(num_encoders)])
        self.remat = tower_remat(remat, scan_layers)

    def forward(self, x):
        for enc in self:
            x = run_block(enc, self.remat, x)
        return x


class MlpHead(nn.Module):
    """[norm, Linear(dim, classes), sigmoid]. The reference feeds these
    sigmoid outputs to its CE loss; logits=True skips the sigmoid."""

    def __init__(self, dim: int, num_classes: int, norm: str = "rms",
                 logits: bool = False, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.logits = logits
        self.norm = make_norm(norm, dim, device)
        self.proj = Linear(num_classes, dim, dtype=dtype, device=device)

    def forward(self, x):
        x = self.proj(self.norm(x))
        return x if self.logits else torch.sigmoid(x)


def _patch_tokens(model, images):
    """(n, c, H, W) charts -> patchEmbed(patchify) (n, patches, image_dim)."""
    return model.patchEmbed(patchify(images, model.patch_res))


def _cls_token(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device))


class meant(nn.Module):
    """Full text + image MEANT, mean-pool fusion: RMSNorm towers, the
    'paper' temporal encoder over the concatenated day means, an RMSNorm
    head.

    forward(tweets (b, lag, s) int, images (b, lag, c, H, W),
            attention_mask (b, lag, s)) -> (b, num_classes).

    With flash=True the language tower drops the padding mask, as the
    reference does. `ff_dropout` defaults to the reference's nn.Dropout()
    p=0.5 (DEFECTS #22).
    """

    def __init__(self, text_dim: int, image_dim: int, price_dim: int,
                 height: int, width: int, patch_res: int, lag: int,
                 num_classes: int,
                 embedding: EmbeddingConfig = EmbeddingConfig(),
                 flash: bool = False, num_heads: int = 8,
                 num_encoders: int = 1, channels: int = 4, remat: Any = False,
                 scan_layers: bool = False, ff_dropout: float = 0.5,
                 logits_head: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        stack = dict(remat=remat, scan_layers=scan_layers)
        self.remat, self.scan_layers = remat, scan_layers
        device = resolve_device(device)
        self.text_dim, self.image_dim, self.patch_res = (text_dim, image_dim,
                                                         patch_res)
        self.embedding = make_embedding(embedding, dtype, device)
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads, flash=flash,
            ff_dropout=ff_dropout, dtype=dtype, device=device, **stack)
        self.patchEmbed = Linear(image_dim, channels * patch_res ** 2,
                                 dtype=dtype, device=device)
        self.visionEncoders = VisionTower(
            num_encoders, dim=image_dim, num_heads=num_heads, flash=flash,
            dtype=dtype, device=device, **stack)
        dim = text_dim + image_dim
        self.temporal_encoding_0 = TemporalEncoder(
            dim, num_heads, lag, style="paper", dtype=dtype, device=device)
        self.mlpHead = MlpHead(dim, num_classes, norm="rms",
                               logits=logits_head, dtype=dtype, device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, tweets, images, attention_mask=None):
        b = images.shape[0]
        lag, s = tweets.shape[1], tweets.shape[2]
        words = self.embedding(tweets.reshape(b * lag, s))
        if attention_mask is not None:
            attention_mask = attention_mask.reshape(b * lag, s)
        words = self.languageEncoders(words, attention_mask)
        words = words.reshape(b, lag, s, self.text_dim)
        imgs = self.visionEncoders(_patch_tokens(
            self, images.reshape(b * lag, *images.shape[2:])))
        imgs = imgs.reshape(b, lag, imgs.shape[1], self.image_dim)
        fused = torch.cat((words.mean(dim=2), imgs.mean(dim=2)), dim=2)
        return self.mlpHead(self.temporal_encoding_0(fused)).squeeze(1)


class meant_vision(nn.Module):
    """Image-only MEANT: RMSNorm vision tower, mean pool, 'slim' temporal
    encoder, LayerNorm head. forward(images (b, lag, c, H, W)) ->
    (b, num_classes)."""

    def __init__(self, image_dim: int, price_dim: int, height: int,
                 width: int, patch_res: int, lag: int, num_classes: int,
                 flash: bool = False, num_heads: int = 8,
                 num_encoders: int = 1, channels: int = 4,
                 scan_layers: bool = False, remat: Any = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        stack = dict(remat=remat, scan_layers=scan_layers)
        self.remat, self.scan_layers = remat, scan_layers
        device = resolve_device(device)
        self.image_dim, self.patch_res = image_dim, patch_res
        self.patchEmbed = Linear(image_dim, channels * patch_res ** 2,
                                 dtype=dtype, device=device)
        self.visionEncoders = VisionTower(
            num_encoders, dim=image_dim, num_heads=num_heads, flash=flash,
            dtype=dtype, device=device, **stack)
        self.temporal_encoding_0 = TemporalEncoder(
            image_dim, num_heads, lag, style="slim", dtype=dtype,
            device=device)
        self.mlpHead = MlpHead(image_dim, num_classes, norm="layer",
                               dtype=dtype, device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, images):
        b, lag = images.shape[0], images.shape[1]
        imgs = self.visionEncoders(_patch_tokens(
            self, images.reshape(b * lag, *images.shape[2:])))
        fused = imgs.reshape(b, lag, imgs.shape[1], self.image_dim).mean(dim=2)
        return self.mlpHead(self.temporal_encoding_0(fused)).squeeze(1)


class meant_tweet(nn.Module):
    """Text-only MEANT: RMSNorm language tower, mean pool, 'slim' temporal
    encoder, LayerNorm head. forward(tweets (b, lag, s), attention_mask) ->
    (b, num_classes)."""

    def __init__(self, text_dim: int, price_dim: int, lag: int,
                 num_classes: int,
                 embedding: EmbeddingConfig = EmbeddingConfig(),
                 flash: bool = False, num_heads: int = 8,
                 num_encoders: int = 1, channels: int = 4,
                 ff_dropout: float = 0.5, scan_layers: bool = False,
                 remat: Any = False, dtype: Optional[torch.dtype] = None,
                 device=None, seed: int = 0):
        super().__init__()
        stack = dict(remat=remat, scan_layers=scan_layers)
        self.remat, self.scan_layers = remat, scan_layers
        device = resolve_device(device)
        self.text_dim = text_dim
        self.embedding = make_embedding(embedding, dtype, device)
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads, flash=flash,
            ff_dropout=ff_dropout, dtype=dtype, device=device, **stack)
        self.temporal_encoding_0 = TemporalEncoder(
            text_dim, num_heads, lag, style="slim", dtype=dtype,
            device=device)
        self.mlpHead = MlpHead(text_dim, num_classes, norm="layer",
                               dtype=dtype, device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, tweets, attention_mask=None):
        b, lag, s = tweets.shape
        if attention_mask is not None:
            attention_mask = attention_mask.reshape(b * lag, s)
        words = self.languageEncoders(
            self.embedding(tweets.reshape(b * lag, s)), attention_mask)
        fused = words.reshape(b, lag, s, self.text_dim).mean(dim=2)
        return self.mlpHead(self.temporal_encoding_0(fused)).squeeze(1)


class meant_tweet_no_lag(SeededInit, nn.Module):
    """Single-day text ablation: a cls token (`txt_classtkn`, drawn N(0, 1))
    prepended, LayerNorm encoders without flash, mask or ff dropout, the
    head reads token 0. forward(tweets (b, s)) -> (b, num_classes)."""

    def __init__(self, text_dim: int, price_dim: int, height: int,
                 width: int, patch_res: int, num_classes: int,
                 embedding: EmbeddingConfig = EmbeddingConfig(),
                 num_heads: int = 8, num_encoders: int = 1,
                 channels: int = 4, scan_layers: bool = False,
                 remat: Any = False, dtype: Optional[torch.dtype] = None,
                 device=None, seed: int = 0):
        super().__init__()
        stack = dict(remat=remat, scan_layers=scan_layers)
        self.remat, self.scan_layers = remat, scan_layers
        device = resolve_device(device)
        self.embedding = make_embedding(embedding, dtype, device)
        self.txt_classtkn = _cls_token((1, 1, text_dim), device)
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads, norm="layer",
            ff_dropout=0.0, dtype=dtype, device=device, **stack)
        self.mlpHead = MlpHead(text_dim, num_classes, norm="layer",
                               dtype=dtype, device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def reset_parameters(self, generator):
        self.txt_classtkn.normal_(0.0, 1.0, generator=generator)

    def forward(self, tweets):
        words = self.embedding(tweets)
        cls = self.txt_classtkn.expand(words.shape[0], 1, -1)
        words = torch.cat((cls.to(words.dtype), words), dim=1)
        return self.mlpHead(self.languageEncoders(words)[:, 0, :])


class meantPrice(SeededInit, nn.Module):
    """"Vanilla paper meant" with cls-token fusion and price features:
    LayerNorm encoders without flash, per-day cls tokens (`txt_classtkn`,
    `img_classtkn`, (1, lag, 1, d), drawn N(0, 1)); the day's two cls
    outputs and its prices are concatenated (text + image + price dims,
    1540 at 768 + 768 + 4) and run in fp32 through the 'slim' temporal
    encoder and a LayerNorm head, neither given the dtype.

    forward(tweets (b, lag, s), images (b, lag, c, H, W),
            prices (b, lag, price_dim)) -> (b, num_classes).
    """

    def __init__(self, text_dim: int, image_dim: int, price_dim: int,
                 height: int, width: int, patch_res: int, lag: int,
                 num_classes: int,
                 embedding: EmbeddingConfig = EmbeddingConfig(),
                 num_heads: int = 8, num_encoders: int = 1, channels: int = 4,
                 scan_layers: bool = False, remat: Any = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        stack = dict(remat=remat, scan_layers=scan_layers)
        self.remat, self.scan_layers = remat, scan_layers
        device = resolve_device(device)
        self.text_dim, self.image_dim, self.patch_res = (text_dim, image_dim,
                                                         patch_res)
        self.embedding = make_embedding(embedding, dtype, device)
        self.txt_classtkn = _cls_token((1, lag, 1, text_dim), device)
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads, norm="layer",
            ff_dropout=0.0, dtype=dtype, device=device, **stack)
        self.patchEmbed = Linear(image_dim, channels * patch_res ** 2,
                                 dtype=dtype, device=device)
        self.img_classtkn = _cls_token((1, lag, 1, image_dim), device)
        self.visionEncoders = VisionTower(
            num_encoders, dim=image_dim, num_heads=num_heads, norm="layer",
            dtype=dtype, device=device, **stack)
        dim = text_dim + image_dim + price_dim
        self.temporal_encoding_0 = TemporalEncoder(dim, num_heads, lag,
                                                   style="slim",
                                                   device=device)
        self.mlpHead = MlpHead(dim, num_classes, norm="layer", device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def reset_parameters(self, generator):
        self.txt_classtkn.normal_(0.0, 1.0, generator=generator)
        self.img_classtkn.normal_(0.0, 1.0, generator=generator)

    @staticmethod
    def _with_cls(x, cls):
        """(b, lag, n, d) -> (b * lag, n + 1, d), the day's cls first."""
        b, lag, n, d = x.shape
        cls = cls.expand(b, lag, 1, d).to(x.dtype)
        return torch.cat((cls, x), dim=2).reshape(b * lag, n + 1, d)

    def forward(self, tweets, images, prices):
        b, lag, s = tweets.shape
        words = self.embedding(tweets.reshape(b * lag, s))
        words = self.languageEncoders(self._with_cls(
            words.reshape(b, lag, s, self.text_dim), self.txt_classtkn))
        words = words.reshape(b, lag, s + 1, self.text_dim)
        imgs = _patch_tokens(self, images.reshape(b * lag, *images.shape[2:]))
        n = imgs.shape[1]
        imgs = self.visionEncoders(self._with_cls(
            imgs.reshape(b, lag, n, self.image_dim), self.img_classtkn))
        imgs = imgs.reshape(b, lag, n + 1, self.image_dim)
        fused = torch.cat((words[:, :, 0, :], imgs[:, :, 0, :],
                           prices.to(words.dtype)), dim=2).float()
        return self.mlpHead(self.temporal_encoding_0(fused)).squeeze(1)


class meant_vqa(nn.Module):
    """VQA transfer model: single-frame text + image, mean-pool both,
    concatenate, RMSNorm head; no temporal stage. forward(tweets (b, s),
    images (b, c, H, W), attention_mask (b, s)) -> (b, num_classes)."""

    def __init__(self, text_dim: int, image_dim: int, price_dim: int,
                 height: int, width: int, patch_res: int, lag: int,
                 num_classes: int,
                 embedding: EmbeddingConfig = EmbeddingConfig(),
                 flash: bool = False, num_heads: int = 8,
                 num_encoders: int = 1, channels: int = 4,
                 scan_layers: bool = False, remat: Any = False,
                 ff_dropout: float = 0.5, dtype: Optional[torch.dtype] = None,
                 device=None, seed: int = 0):
        super().__init__()
        stack = dict(remat=remat, scan_layers=scan_layers)
        self.remat, self.scan_layers = remat, scan_layers
        device = resolve_device(device)
        self.patch_res = patch_res
        self.embedding = make_embedding(embedding, dtype, device)
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads, flash=flash,
            ff_dropout=ff_dropout, dtype=dtype, device=device, **stack)
        self.patchEmbed = Linear(image_dim, channels * patch_res ** 2,
                                 dtype=dtype, device=device)
        self.visionEncoders = VisionTower(
            num_encoders, dim=image_dim, num_heads=num_heads, flash=flash,
            dtype=dtype, device=device, **stack)
        self.mlpHead = MlpHead(text_dim + image_dim, num_classes, norm="rms",
                               dtype=dtype, device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, tweets, images, attention_mask=None):
        words = self.languageEncoders(self.embedding(tweets), attention_mask)
        imgs = self.visionEncoders(_patch_tokens(self, images))
        return self.mlpHead(torch.cat((words.mean(dim=1), imgs.mean(dim=1)),
                                      dim=1))
