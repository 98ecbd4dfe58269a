"""The TimeSformer family of MEANT (counterpart of
meant_tpu/models/meant_timesformer.py): `meant_timesformer`,
`meant_mean_pooling` and `meant_mosi`.

Reference quirks kept, as the JAX package keeps them:
  * `lang_prep` pools the text by attention over the token axis:
    Linear(d, d) -> LayerNorm -> GELU -> Linear(d, 1) -> softmax;
  * `image_prep` is the same stack over the TimeSformer's tokens, but its
    softmax runs over the singleton projection axis: every weight is 1 and
    the image pooling is a token SUM;
  * meant_mean_pooling's `image_proj` is the degenerate
    Linear(981, 1) -> LayerNorm(1) -> GELU (a constant; `fixed_proj=True`
    drops the LayerNorm);
  * meant_mosi mean-pools the last frame's tokens (the reference's own
    concatenation is shape-invalid), max-pools the text, and computes its
    audio branch only to discard it unless `use_audio_in_fusion`.

The text tower is `LanguageTower` (LayerNorm + xavier encoders, the flash
kernels with `flash=True`: R1 + K1 forward, K2 backward); `scan_layers` and
`remat` reach both the tower and the TimeSformer (nn/stack.py,
nn/timesformer.py). `head=False` TimeSformers: these models ask only for
its tokens, so JAX builds no classifier head for it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.models.meant import (EmbeddingConfig, LanguageTower,
                                          MlpHead, make_embedding)
from meant_tpu_torch.models.meant_src import SeqProjection
from meant_tpu_torch.nn.attention_modules import MultiHeadDotProductAttention
from meant_tpu_torch.nn.encoders import TemporalEncoder
from meant_tpu_torch.nn.layers import (Dense, FlaxLayerNorm, Linear,
                                       SeededInit, gelu, init_weights,
                                       make_norm)
from meant_tpu_torch.nn.timesformer import TimeSformer


class AttnPool(nn.Module):
    """lang_prep / image_prep: Linear(d, d) -> LayerNorm(d) -> GELU ->
    Linear(d, 1) -> softmax over `softmax_axis`; (..., tokens, d) ->
    weights (..., tokens, 1)."""

    def __init__(self, dim: int, softmax_axis: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.softmax_axis = softmax_axis
        self.proj1 = Linear(dim, dim, dtype=dtype, device=device)
        self.norm = make_norm("layer", dim, device)
        self.proj2 = Linear(1, dim, dtype=dtype, device=device)

    def forward(self, x):
        w = self.proj2(gelu(self.norm(self.proj1(x))))
        return torch.softmax(w, dim=self.softmax_axis)


class _TimesformerBase(nn.Module):
    """The text tower and the depth-1 TimeSformer (8 heads of 64, dropout
    0.1) both family members share; forward(**batch) with input_ids (b,
    lag, s), pixels (b, lag, c, H, W), prices (b, lag, price_dim),
    attention_mask (b, lag, s) -> (b, num_classes)."""

    def __init__(self, text_dim: int, image_dim: int, price_dim: int,
                 height: int, width: int, patch_res: int, lag: int,
                 num_classes: int,
                 embedding: EmbeddingConfig = EmbeddingConfig(),
                 flash: bool = False, num_heads: int = 8,
                 num_encoders: int = 1, channels: int = 3,
                 seq_len: int = 512, fixed_proj: bool = False,
                 scan_layers: bool = False, remat: Any = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.device_ = device
        self.text_dim, self.image_dim = text_dim, image_dim
        self.seq_len, self.dtype, self.fixed_proj = seq_len, dtype, fixed_proj
        self.remat, self.scan_layers = remat, scan_layers
        self.n_tokens = 1 + lag * (height // patch_res) * (width // patch_res)
        self.embedding = make_embedding(embedding, dtype, device)
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads, norm="layer",
            ff_norm2="rms", init_style="xavier", flash=flash, dtype=dtype,
            device=device, remat=remat, scan_layers=scan_layers)
        self.timesformer = TimeSformer(
            dim=image_dim, image_size=height, patch_size=patch_res,
            num_frames=lag, num_classes=num_classes, depth=1, heads=8,
            dim_head=64, attn_dropout=0.1, ff_dropout=0.1, channels=channels,
            flash=flash, scan_layers=scan_layers, remat=remat, head=False,
            dtype=dtype, device=device, seed=None)
        dim = text_dim + price_dim
        self.temporal_encoding_0 = TemporalEncoder(dim, num_heads, lag,
                                                   style="src", dtype=dtype,
                                                   device=device)
        self.mlpHead = MlpHead(dim + image_dim, num_classes, norm="layer",
                               dtype=dtype, device=device)

    def _encode_text(self, input_ids, attention_mask):
        b, lag, s = input_ids.shape
        words = self.embedding(input_ids.reshape(b * lag, s))
        if attention_mask is not None:
            attention_mask = attention_mask.reshape(b * lag, s)
        words = self.languageEncoders(words, attention_mask)
        return words.reshape(b, lag, s, self.text_dim)

    def _fuse(self, words, prices, images):
        """The 'src' temporal stage over text + price, the image features
        beside its output, the head."""
        fused = torch.cat((words, prices.to(words.dtype)), dim=2)
        if self.dtype is not None:
            fused = fused.to(self.dtype)
        fused = self.temporal_encoding_0(fused)
        return self.mlpHead(torch.cat((fused, images.to(fused.dtype)),
                                      dim=1))


class meant_timesformer(_TimesformerBase):
    """Attention-weighted text pooling, the TimeSformer's tokens summed
    (image_prep's softmax over a singleton axis); head dim 1541 at the
    CLI's widths."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        kw = dict(dtype=self.dtype, device=self.device_)
        self.lang_prep = AttnPool(self.text_dim, softmax_axis=2, **kw)
        self.image_prep = AttnPool(self.image_dim, softmax_axis=2, **kw)
        init_weights(self, torch.Generator(device=self.device_).manual_seed(
            seed))

    def forward(self, input_ids=None, pixels=None, prices=None,
                attention_mask=None, labels=None, pixel_mask=None, **_):
        words = self._encode_text(input_ids, attention_mask)
        s = words.shape[2]
        if s < self.seq_len:
            words = F.pad(words, (0, 0, 0, self.seq_len - s))
        tokens = self.timesformer(pixels, return_tokens=True)
        w = self.lang_prep(words).squeeze(-1)              # (b, lag, S)
        words = torch.einsum("blsd,bls->bld", words, w)
        i_w = self.image_prep(tokens).squeeze(-1)          # all ones
        images = torch.einsum("bpd,bp->bd", tokens, i_w)
        return self._fuse(words, prices, images)


class meant_mean_pooling(_TimesformerBase):
    """Mean-pooled text; the TimeSformer's tokens through the degenerate
    `image_proj` (SeqProjection over 1 + lag * patches tokens)."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.image_proj = SeqProjection(self.n_tokens, fixed=self.fixed_proj,
                                        dtype=self.dtype, device=self.device_)
        init_weights(self, torch.Generator(device=self.device_).manual_seed(
            seed))

    def forward(self, input_ids=None, pixels=None, prices=None,
                attention_mask=None, labels=None, **_):
        words = self._encode_text(input_ids, attention_mask).mean(dim=2)
        tokens = self.timesformer(pixels, return_tokens=True)
        images = self.image_proj(tokens.transpose(1, 2))   # (b, d)
        return self._fuse(words, prices, images)


def permute1d_pe(seq_plus_cls: int, d_model: int) -> torch.Tensor:
    """The reference's positional encoding with its quirk: the library's
    PositionalEncodingPermute1D(s + 1) applied to a channels-last (b, s + 1,
    d) tensor runs its interleaved sin/cos table over the FEATURE axis as
    positions, so the encoding lands transposed. Returns (s + 1, d_model)
    fp32, built in fp64 with numpy and rounded."""
    ch = -(-seq_plus_cls // 2) * 2
    inv_freq = (1.0 / (10000 ** (np.arange(0, ch, 2, dtype=np.float32)
                                 / ch))).astype(np.float32)
    ang = np.arange(d_model, dtype=np.float32)[:, None] * inv_freq[None, :]
    table = np.stack((np.sin(ang), np.cos(ang)), axis=-1).reshape(d_model,
                                                                  ch)
    return torch.tensor(table[:, :seq_plus_cls].T.copy(),
                        dtype=torch.float32)


class AudioEncoder(SeededInit, nn.Module):
    """MOSI's audio branch: a learned cls embedding (`cls_emb`, drawn
    N(0, 1)) in front, the transposed positional encoding (`permute1d_pe`),
    then `num_layers` post-norm transformer layers (torch's
    TransformerEncoderLayer: attention, add, LayerNorm, ReLU feed forward,
    add, LayerNorm).

    Reference defect kept by default (`torch_mask_quirk=True`): the
    collator's 1 = valid mask goes to torch's `src_key_padding_mask`, where
    True means PAD, so the reference attends exactly the padding (and the
    cls, always kept). `torch_mask_quirk=False` attends the valid steps."""

    def __init__(self, d_model: int = 130, nhead: int = 2,
                 num_layers: int = 3, dim_feedforward: int = 512,
                 torch_mask_quirk: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.d_model, self.num_layers = d_model, num_layers
        self.torch_mask_quirk = torch_mask_quirk
        self.cls_emb = nn.Parameter(torch.empty((1, 1, d_model),
                                                device=device))
        kw = dict(dtype=dtype, device=device)
        for i in range(num_layers):
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(
                d_model, nhead, **kw))
            self.add_module(f"norm1_{i}", FlaxLayerNorm(d_model,
                                                        device=device))
            self.add_module(f"ff1_{i}", Dense(dim_feedforward, d_model,
                                              **kw))
            self.add_module(f"ff2_{i}", Dense(d_model, dim_feedforward,
                                              **kw))
            self.add_module(f"norm2_{i}", FlaxLayerNorm(d_model,
                                                        device=device))

    def reset_parameters(self, generator):
        self.cls_emb.normal_(0.0, 1.0, generator=generator)

    def forward(self, audio, audio_mask=None):
        b, s, _ = audio.shape
        cls = self.cls_emb.expand(b, 1, self.d_model).to(audio.dtype)
        x = torch.cat((cls, audio), dim=1)
        mask = None
        if audio_mask is not None:
            keep = audio_mask.to(torch.float32)
            if self.torch_mask_quirk:
                keep = 1.0 - keep
            keep = torch.cat((keep.new_ones((b, 1)), keep), dim=1)
            mask = (keep > 0)[:, None, None, :]
        x = x + permute1d_pe(s + 1, self.d_model).to(x.device, x.dtype)
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")
            x = layer("norm1")(x + layer("attn")(x, mask))
            h = layer("ff2")(F.relu(layer("ff1")(x)))
            x = layer("norm2")(x + h)
        return x


class meant_mosi(nn.Module):
    """CMU-MOSI sentiment: text (pre-embedded float features when
    `embedding` is None, else token ids) through the language tower with
    xPos on 30 features and a max-pooled output; 20-feature video frames
    through a patch-1 TimeSformer, the last frame's tokens mean-pooled; the
    audio branch computed (when the batch holds audio) and discarded unless
    `use_audio_in_fusion`.

    forward(input_ids (b, s, text_dim) or (b, s), pixels (b, lag, 20),
            audio (b, lag, 130), audio_mask (b, lag),
            attention_mask (b, s)) -> (b, num_classes).
    """

    def __init__(self, text_dim: int = 768, image_dim: int = 768,
                 lag: int = 50, num_classes: int = 2,
                 embedding: Optional[EmbeddingConfig] = None,
                 flash: bool = False, num_heads: int = 8,
                 num_encoders: int = 1,
                 use_audio_in_fusion: bool = False,
                 scan_layers: bool = False, remat: Any = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.lag, self.image_dim = lag, image_dim
        self.use_audio_in_fusion = use_audio_in_fusion
        self.remat, self.scan_layers = remat, scan_layers
        self.embedding = (None if embedding is None
                          else make_embedding(embedding, dtype, device))
        self.languageEncoders = LanguageTower(
            num_encoders, dim=text_dim, num_heads=num_heads, norm="layer",
            ff_norm2="rms", init_style="xavier", flash=flash, rot_dim=30,
            dtype=dtype, device=device, remat=remat,
            scan_layers=scan_layers)
        self.audio_encoder = AudioEncoder(dtype=dtype, device=device)
        self.timesformer = TimeSformer(
            dim=image_dim, image_size=20, patch_size=1, num_frames=lag,
            num_classes=num_classes, depth=num_encoders, heads=8,
            dim_head=64, attn_dropout=0.1, ff_dropout=0.1, channels=1,
            flash=flash, scan_layers=scan_layers, remat=remat, head=False,
            dtype=dtype, device=device, seed=None)
        other = text_dim + image_dim + (
            self.audio_encoder.d_model if use_audio_in_fusion else 0)
        self.mlpHead = MlpHead(other, num_classes, norm="layer", dtype=dtype,
                               device=device)
        init_weights(self, torch.Generator(device=device).manual_seed(seed))

    def forward(self, input_ids=None, pixels=None, audio=None,
                audio_mask=None, attention_mask=None, labels=None, **_):
        words = input_ids
        if self.embedding is not None:
            words = self.embedding(words)
        words = self.languageEncoders(words, attention_mask)
        audio_repr = None
        if audio is not None:
            audio_repr = self.audio_encoder(audio, audio_mask)
        video = pixels[:, :, None, None, :]                # (b, f, 1, 1, 20)
        tokens = self.timesformer(video, return_tokens=True)[:, 1:]
        n = tokens.shape[1] // self.lag
        tokens = tokens.reshape(-1, self.lag, n, self.image_dim)
        images = tokens[:, -1].mean(dim=1)
        text = words.amax(dim=1)
        parts = [text, images.to(text.dtype)]
        if self.use_audio_in_fusion and audio_repr is not None:
            parts.append(audio_repr[:, 0].to(text.dtype))
        return self.mlpHead(torch.cat(parts, dim=1))
