"""src-era MEANT (counterpart of meant_tpu/models/meant_src.py): `meant_src`,
`meantTweetPrice`, `meant_price` and the price baselines `mlpEncoder` and
`LSTMEncoder`.

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
from meant_tpu_torch.nn.layers import (Dense, Linear, gelu, init_weights,
                                       make_norm)
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


class meantTweetPrice(nn.Module):
    """Text + price model: RMSNorm language encoders (dropout 0.4 in both
    blocks), mean-pooled text beside the prices, the 'tweet_price' temporal
    encoder (one: the reference's stacking is shape-incompatible past one),
    a LayerNorm head.

    forward(tweets (b, lag, s), prices (b, lag, price_dim),
            attention_mask (b, lag, s)) -> (b, num_classes).
    """

    def __init__(self, text_dim: int, price_dim: int, lag: int,
                 num_classes: int,
                 embedding: EmbeddingConfig = EmbeddingConfig(),
                 flash: bool = False, num_heads: int = 8,
                 num_encoders: int = 1, num_temporal_encoders: int = 1,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        if num_temporal_encoders != 1:
            raise ValueError(
                "meantTweetPrice supports one temporal encoder: the "
                "reference's temporal stacking is shape-incompatible for "
                "more")
        device = resolve_device(device)
        self.text_dim = text_dim
        self.embedding = make_embedding(embedding, dtype, device)
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads, dropout=0.4,
            ff_dropout=0.4, norm="rms", flash=flash, dtype=dtype,
            device=device)
        dim = text_dim + price_dim
        self.temporal_encoding_0 = TemporalEncoder(
            dim, num_heads, lag, style="tweet_price", dtype=dtype,
            device=device)
        self.mlpHead = MlpHead(dim, num_classes, norm="layer", dtype=dtype,
                               device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, tweets, prices, attention_mask=None):
        b, lag, s = tweets.shape
        if attention_mask is not None:
            attention_mask = attention_mask.reshape(b * lag, s)
        words = self.languageEncoders(
            self.embedding(tweets.reshape(b * lag, s)), attention_mask)
        words = words.reshape(b, lag, s, self.text_dim)
        fused = torch.cat((words.mean(dim=2), prices.to(words.dtype)), dim=2)
        return self.mlpHead(self.temporal_encoding_0(fused))


class meant_price(nn.Module):
    """Price-only temporal model: the norm-free 'src_slim' temporal encoder
    over the price features and a LayerNorm head. At price_dim 5 and 8
    heads the head dim clamps to 1 and the attention is 8 wide.
    forward(prices (b, lag, price_dim)) -> (b, num_classes)."""

    def __init__(self, price_dim: int, lag: int, num_classes: int,
                 num_heads: int = 8, dtype: Optional[torch.dtype] = None,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.temporal_encoding_0 = TemporalEncoder(
            price_dim, num_heads, lag, style="src_slim", dtype=dtype,
            device=device)
        self.mlpHead = MlpHead(price_dim, num_classes, norm="layer",
                               dtype=dtype, device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, prices=None, **_):
        return self.mlpHead(self.temporal_encoding_0(prices))


def _price_input(model, prices):
    """input_layer, input_norm, ReLU of the price baselines."""
    return F.relu(model.input_norm(model.input_layer(prices)))


class mlpEncoder(nn.Module):
    """Deep-MLP price baseline: [Linear, LayerNorm, ReLU] x (1 +
    num_hidden_layers), a Linear and a sigmoid, applied to every lag step:
    forward(prices (b, lag, input_dim)) -> (b, lag, output_dim)."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int,
                 num_hidden_layers: int = 3,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(init_style="xavier", dtype=dtype, device=device)
        self.num_hidden_layers = num_hidden_layers
        self.input_layer = Linear(hidden_dim, input_dim, **kw)
        self.input_norm = make_norm("layer", hidden_dim, device)
        for i in range(num_hidden_layers):
            self.add_module(f"hidden_{i}", Linear(hidden_dim, hidden_dim,
                                                  **kw))
            self.add_module(f"hidden_norm_{i}",
                            make_norm("layer", hidden_dim, device))
        self.output_layer = Linear(output_dim, hidden_dim, **kw)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, prices=None, **_):
        x = _price_input(self, prices)
        for i in range(self.num_hidden_layers):
            x = F.relu(getattr(self, f"hidden_norm_{i}")(
                getattr(self, f"hidden_{i}")(x)))
        return torch.sigmoid(self.output_layer(x))


_GATES = ("i", "f", "g", "o")


class OptimizedLSTMCell(nn.Module):
    """Flax `nn.OptimizedLSTMCell(features)` over a whole sequence: input
    gates `ii`, `if`, `ig`, `io` without bias, hidden gates `hi`, `hf`,
    `hg`, `ho` with bias, gate order i, f, g, o, carry (c, h) from zeros.
    The gates are stacked into one LSTM call (`torch.lstm`; cuDNN's on the
    card), its input bias zero. The gates stay in floating point under int8,
    as JAX's interceptor leaves the cell alone."""

    def __init__(self, features: int, in_features: int, device=None):
        super().__init__()
        kw = dict(quantize=False, device=device)
        for g in _GATES:
            self.add_module(f"i{g}", Dense(features, in_features,
                                           use_bias=False, **kw))
            self.add_module(f"h{g}", Dense(features, features, **kw))

    def forward(self, x, batch_first: bool):
        """x (time, batch, in) or, batch_first, (batch, time, in)."""
        gate = lambda name: getattr(self, name)
        w_ih = torch.cat([gate(f"i{g}").weight for g in _GATES])
        w_hh = torch.cat([gate(f"h{g}").weight for g in _GATES])
        b_hh = torch.cat([gate(f"h{g}").bias for g in _GATES])
        hidden = w_hh.shape[1]
        rows = x.shape[0 if batch_first else 1]
        zeros = x.new_zeros((1, rows, hidden))
        out, _, _ = torch.lstm(x, (zeros, zeros),
                               [w_ih.to(x.dtype), w_hh.to(x.dtype),
                                torch.zeros_like(b_hh).to(x.dtype),
                                b_hh.to(x.dtype)],
                               True, 1, 0.0, self.training, False,
                               batch_first)
        return out


class LSTMEncoder(nn.Module):
    """LSTM price baseline: [Linear, LayerNorm, ReLU], `num_hidden_layers`
    stacked LSTM cells, a Linear and a sigmoid; forward(prices (b, lag,
    input_dim)) -> (b, lag, output_dim).

    Reference defect kept by default (`torch_axis_quirk=True`): the
    reference hands (b, lag, hidden) to `nn.LSTM` without `batch_first`, so
    the recurrence runs over the BATCH axis with the lag steps as its
    batch. `torch_axis_quirk=False` runs it over lag."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int,
                 num_hidden_layers: int = 3, torch_axis_quirk: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(init_style="xavier", dtype=dtype, device=device)
        self.num_hidden_layers = num_hidden_layers
        self.torch_axis_quirk = torch_axis_quirk
        self.input_layer = Linear(hidden_dim, input_dim, **kw)
        self.input_norm = make_norm("layer", hidden_dim, device)
        for i in range(num_hidden_layers):
            self.add_module(f"lstm_{i}", OptimizedLSTMCell(
                hidden_dim, hidden_dim, device=device))
        self.output_layer = Linear(output_dim, hidden_dim, **kw)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, prices=None, **_):
        x = _price_input(self, prices)
        for i in range(self.num_hidden_layers):
            x = getattr(self, f"lstm_{i}")(
                x, batch_first=not self.torch_axis_quirk)
        return torch.sigmoid(self.output_layer(x))
