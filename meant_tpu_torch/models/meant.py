"""Shared pieces of the MEANT family (counterpart of
meant_tpu/models/meant.py): EmbeddingConfig, MlpHead and the unrolled
encoder towers. The paper-generation models themselves, remat and the
scanned towers are not ported yet (see ROADMAP)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from meant_tpu_torch.nn.embeddings import RobertaEmbeddings
from meant_tpu_torch.nn.encoders import LanguageEncoder, VisionEncoder
from meant_tpu_torch.nn.layers import Linear, make_norm


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
    """`num_encoders` LanguageEncoders, unrolled."""

    def __init__(self, num_encoders: int, **enc_kwargs):
        super().__init__([LanguageEncoder(**enc_kwargs)
                          for _ in range(num_encoders)])

    def forward(self, x, attention_mask=None):
        for enc in self:
            x = enc(x, attention_mask)
        return x


class VisionTower(nn.ModuleList):
    """`num_encoders` VisionEncoders, unrolled."""

    def __init__(self, num_encoders: int, **enc_kwargs):
        super().__init__([VisionEncoder(**enc_kwargs)
                          for _ in range(num_encoders)])

    def forward(self, x):
        for enc in self:
            x = enc(x)
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
