"""RoBERTa-style embeddings (counterpart of meant_tpu/nn/embeddings.py):
word + position + token-type, LayerNorm, dropout.

Position ids follow RoBERTa: pad tokens get `padding_idx`, real tokens
`padding_idx + running count`. Ids past the table are CLAMPED to its last
row, as JAX's gather does: the main path runs s=512 against a 130-row
position table, so ids reach 513 (torch's own lookup would raise on the CPU
and trip a device assert on CUDA). Like JAX's gather, whose transpose is a
scatter that drops out-of-range updates, the clamped ids send no gradient
to that last row.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from meant_tpu_torch.nn.layers import LayerNorm, SeededInit


def clamped_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup with out-of-range ids clamped into [0, rows - 1]; ids past
    the last row read it but pass no gradient to it, as in JAX."""
    rows = table.shape[0]
    out = F.embedding(ids.clamp(0, rows - 1), table)
    if torch.is_grad_enabled() and table.requires_grad:
        out = torch.where((ids >= rows)[..., None], out.detach(), out)
    return out


def lookup_words(embedding: nn.Module, ids: torch.Tensor) -> torch.Tensor:
    """`clamped_lookup` of the word table, or, where tensor parallelism
    cut it on the vocab axis (`embedding.vocab_shard` = (group, first row,
    whole vocab), parallel/sharding_rules.py), the rows this rank owns,
    zero elsewhere, summed over the group by reduce_out: the rows it does
    not own get a zero gradient here, and ids past the vocab read its last
    row and pass it no gradient, as `clamped_lookup`."""
    shard = getattr(embedding, "vocab_shard", None)
    if shard is None:
        return clamped_lookup(embedding.weight, ids)
    from meant_tpu_torch.parallel.sharding_rules import reduce_out
    group, start, vocab = shard
    rows = embedding.weight.shape[0]
    local = ids.clamp(0, vocab - 1) - start
    inside = (local >= 0) & (local < rows)
    out = F.embedding(local.clamp(0, rows - 1), embedding.weight)
    out = torch.where(inside[..., None], out, 0.0)
    if torch.is_grad_enabled() and embedding.weight.requires_grad:
        out = torch.where((ids >= vocab)[..., None], out.detach(), out)
    return reduce_out(out, group)


class RobertaEmbeddings(SeededInit, nn.Module):

    def __init__(self, vocab_size: int = 64001, hidden_size: int = 768,
                 max_position_embeddings: int = 130, type_vocab_size: int = 1,
                 padding_idx: int = 1, layer_norm_eps: float = 1e-5,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.padding_idx = padding_idx
        self.dtype = dtype
        # skip_init: the tables are drawn in reset_parameters from the
        # caller's generator, not from torch's global one
        self.word_embeddings = skip_init(nn.Embedding, vocab_size,
                                         hidden_size, device=device)
        self.position_embeddings = skip_init(
            nn.Embedding, max_position_embeddings, hidden_size, device=device)
        self.token_type_embeddings = skip_init(
            nn.Embedding, type_vocab_size, hidden_size, device=device)
        self.layer_norm = LayerNorm(hidden_size, eps=layer_norm_eps,
                                    device=device)
        self.drop = nn.Dropout(dropout)

    def reset_parameters(self, generator):
        for emb in (self.word_embeddings, self.position_embeddings,
                    self.token_type_embeddings):
            emb.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, input_ids, token_type_ids=None):
        mask = (input_ids != self.padding_idx).to(input_ids.dtype)
        position_ids = torch.cumsum(mask, dim=-1) * mask + self.padding_idx
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (lookup_words(self.word_embeddings, input_ids)
             + clamped_lookup(self.position_embeddings.weight, position_ids)
             + clamped_lookup(self.token_type_embeddings.weight,
                              token_type_ids))
        x = self.drop(self.layer_norm(x))
        if self.dtype is not None:
            x = x.to(self.dtype)
        return x
