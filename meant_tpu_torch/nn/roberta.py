"""RoBERTa-style encoder and the HF-wrapper baselines (counterpart of
meant_tpu/nn/roberta.py): `RobertaLayer`, `RobertaModel`,
`bertweet_wrapper`, `roberta_mlm_wrapper`, `hug_roberta_mlm_wrapper`,
`vl_BERT_Wrapper` and `ViltWrapper`.

Post-LN BERT encoder: embeddings -> N x [MHA -> Add & LN -> FF(exact GELU)
-> Add & LN] -> tanh pooler over token 0. The attention is Flax's
`nn.MultiHeadDotProductAttention` (`nn.attention_modules`), in plain
PyTorch as in JAX, where no Pallas kernel runs in it; the only hand-written
kernel these models reach is the optimizer's (A1). Every norm is Flax's
`nn.LayerNorm` (`FlaxLayerNorm`) at the JAX module's epsilon: fp32 out of a
bf16 input, so under `dtype=bf16` the stream alternates between bf16 (the
products) and fp32 (after each norm) exactly as it does in JAX. Module
names follow the JAX param tree (`layer_3`, `attention_norm`, ...), so
`weights.load_jax_params` carries JAX weights over.

Each wrapper adds `device` (the card unless named) and `seed` (weights
drawn from `torch.Generator(device).manual_seed(seed)`). Dropout draws from
the default generator of the device, which the trainers seed.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from meant_tpu_torch.device import resolve_device
from meant_tpu_torch.nn.attention_modules import MultiHeadDotProductAttention
from meant_tpu_torch.nn.embeddings import RobertaEmbeddings
from meant_tpu_torch.nn.layers import Dense, FlaxLayerNorm, gelu, init_weights


def seeded(module: nn.Module, device, seed: Optional[int]) -> None:
    """Draw `module`'s weights from `seed` on `device`; None leaves them to
    the enclosing model, which draws its own."""
    if seed is not None:
        init_weights(module, torch.Generator(device=device).manual_seed(seed))


def padding_mask(attention_mask):
    """(b, s) attention mask -> the (b, 1, 1, s) boolean mask Flax's MHA
    takes (True attends), or None."""
    if attention_mask is None:
        return None
    return attention_mask[:, None, None, :] > 0


class RobertaLayer(nn.Module):
    """Post-LN block: LN(x + drop(MHA(x))), then LN(x + drop(FF(x)))."""

    def __init__(self, hidden_size: int, num_heads: int = 12,
                 intermediate_size: int = 3072, dropout: float = 0.1,
                 layer_norm_eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attention = MultiHeadDotProductAttention(hidden_size, num_heads,
                                                      **kw)
        self.attn_drop = nn.Dropout(dropout)
        self.attention_norm = FlaxLayerNorm(hidden_size, layer_norm_eps,
                                            device=device)
        self.intermediate = Dense(intermediate_size, hidden_size, **kw)
        self.output = Dense(hidden_size, intermediate_size, **kw)
        self.out_drop = nn.Dropout(dropout)
        self.output_norm = FlaxLayerNorm(hidden_size, layer_norm_eps,
                                         device=device)

    def forward(self, x, attention_mask=None):
        h = self.attn_drop(self.attention(x, padding_mask(attention_mask)))
        x = self.attention_norm(x + h)
        h = self.out_drop(self.output(gelu(self.intermediate(x))))
        return self.output_norm(x + h)


class RobertaModel(nn.Module):
    """RoBERTa embeddings (pad id 1, position ids clamped at the table's
    last row) and `num_layers` RobertaLayers; forward returns (hidden,
    tanh(pooler(hidden[:, 0]))), or the hidden states alone with
    `return_pooled=False`. `pooler=False` builds no pooler, as the JAX
    module creates none when it is only called with
    `return_pooled=False` (the MLM wrappers)."""

    def __init__(self, vocab_size: int = 64001, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072,
                 max_position_embeddings: int = 130, dropout: float = 0.1,
                 pooler: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None, seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        self.embeddings = RobertaEmbeddings(
            vocab_size=vocab_size, hidden_size=hidden_size,
            max_position_embeddings=max_position_embeddings,
            dropout=dropout, dtype=dtype, device=device)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", RobertaLayer(
                hidden_size, num_heads, intermediate_size, dropout,
                dtype=dtype, device=device))
        self.pooler = (Dense(hidden_size, hidden_size, dtype=dtype,
                             device=device) if pooler else None)
        seeded(self, device, seed)

    def forward(self, input_ids=None, attention_mask=None,
                inputs_embeds=None, return_pooled: bool = True):
        x = (self.embeddings(input_ids) if inputs_embeds is None
             else inputs_embeds)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, attention_mask)
        if not return_pooled:
            return x
        return x, torch.tanh(self.pooler(x[:, 0]))


def _roberta(input_dim, vocab_size, num_layers, num_heads, dtype, device,
             pooler=True):
    return RobertaModel(vocab_size=vocab_size, hidden_size=input_dim,
                        num_layers=num_layers, num_heads=num_heads,
                        intermediate_size=4 * input_dim, pooler=pooler,
                        dtype=dtype, device=device, seed=None)


class bertweet_wrapper(nn.Module):
    """bertweet -> pooler -> dropout -> [LayerNorm (Flax's, eps 1e-6),
    GELU, Linear, Sigmoid]; the attention mask is `tweets != 1` (the pad
    id). forward(tweets (b, s)) -> (b, output_dim)."""

    def __init__(self, input_dim: int = 768, output_dim: int = 2,
                 vocab_size: int = 64001, num_layers: int = 12,
                 num_heads: int = 12, dtype: Optional[torch.dtype] = None,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.bertweet = _roberta(input_dim, vocab_size, num_layers,
                                 num_heads, dtype, device)
        self.drop = nn.Dropout(0.1)
        self.head_norm = FlaxLayerNorm(input_dim, device=device)
        self.head = Dense(output_dim, input_dim, dtype=dtype, device=device)
        seeded(self, device, seed)

    def forward(self, tweets):
        mask = (tweets != 1).to(torch.float32)
        _, pooled = self.bertweet(tweets, mask)
        x = gelu(self.head_norm(self.drop(pooled)))
        return torch.sigmoid(self.head(x))


class roberta_mlm_wrapper(nn.Module):
    """roberta last hidden state -> Linear(hidden, 1) -> squeeze:
    forward(input_ids (b, s), attention_mask) -> (b, s)."""

    def __init__(self, input_dim: int = 768, output_dim: int = 512,
                 vocab_size: int = 64001, num_layers: int = 12,
                 num_heads: int = 12, dtype: Optional[torch.dtype] = None,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.roberta = _roberta(input_dim, vocab_size, num_layers, num_heads,
                                dtype, device, pooler=False)
        self.mlm_output_head = Dense(1, input_dim, dtype=dtype,
                                     device=device)
        seeded(self, device, seed)

    def head_input(self, hidden):
        return hidden

    def forward(self, input_ids, attention_mask=None):
        hidden = self.roberta(input_ids, attention_mask, return_pooled=False)
        return self.mlm_output_head(self.head_input(hidden)).squeeze(-1)


class hug_roberta_mlm_wrapper(roberta_mlm_wrapper):
    """The `src/hug` variant: GELU before the (hidden, 1) head, one scalar
    per token."""

    def __init__(self, input_dim: int = 768, vocab_size: int = 64001,
                 num_layers: int = 12, num_heads: int = 12,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__(input_dim, 1, vocab_size, num_layers, num_heads,
                         dtype, device, seed)

    def head_input(self, hidden):
        return gelu(hidden)


def _zero_text_mask(tweets):
    """The reference wrappers' text inputs: an all-zero attention mask and
    token-type ones."""
    return (torch.zeros(tweets.shape, dtype=torch.float32,
                        device=tweets.device),
            torch.ones_like(tweets))


class vl_BERT_Wrapper(nn.Module):
    """4-channel 16x16 patches -> Linear(patch_dim, 2048) visual embeds ->
    VisualBERT -> pooler -> dropout -> [Linear, Sigmoid], with the
    reference's I/O quirks: an all-zero text attention mask (text queries
    attend to the visual keys only) and token-type ones.
    forward(tweets (b, s), images (b, 4, H, W)) -> (b, output_dim)."""

    def __init__(self, input_dim: int = 768, output_dim: int = 2,
                 vocab_size: int = 30522, num_layers: int = 12,
                 num_heads: int = 12, visual_embed_dim: int = 2048,
                 patch_res: int = 16, channels: int = 4,
                 dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0):
        super().__init__()
        from meant_tpu_torch.nn.hf_baselines import VisualBertModel
        device = resolve_device(device)
        self.patch_res = patch_res
        kw = dict(dtype=dtype, device=device)
        self.patches = Dense(visual_embed_dim,
                             channels * patch_res * patch_res, **kw)
        self.model = VisualBertModel(
            vocab_size=vocab_size, hidden_size=input_dim,
            num_layers=num_layers, num_heads=num_heads,
            intermediate_size=4 * input_dim,
            visual_embedding_dim=visual_embed_dim, seed=None, **kw)
        self.drop = nn.Dropout(0.1)
        self.mlp_head = Dense(output_dim, input_dim, **kw)
        seeded(self, device, seed)

    def forward(self, tweets, images):
        from meant_tpu_torch.ops.patch import patchify
        visual = self.patches(patchify(images, self.patch_res))
        mask, token_types = _zero_text_mask(tweets)
        _, pooled = self.model(tweets, attention_mask=mask,
                               token_type_ids=token_types,
                               visual_embeds=visual)
        return torch.sigmoid(self.mlp_head(self.drop(pooled)))


class ViltWrapper(nn.Module):
    """ViltModel with its patch conv taking 4 channels -> pooler -> dropout
    -> [Linear, Sigmoid]; the same zero text mask and token-type ones.
    `image_size` is the config grid the position table is drawn for (384,
    a 12 x 12 grid at patch 32), resized to the input's grid. The text
    position table has `max_position_embeddings` (40) rows, so at most 40
    tokens. forward(tweets (b, s), images (b, 4, H, W)) -> (b,
    output_dim)."""

    def __init__(self, input_dim: int = 768, output_dim: int = 2,
                 vocab_size: int = 30522, num_layers: int = 12,
                 num_heads: int = 12, max_position_embeddings: int = 40,
                 image_size: int = 384, patch_res: int = 32,
                 channels: int = 4, dtype: Optional[torch.dtype] = None,
                 device=None, seed: int = 0):
        super().__init__()
        from meant_tpu_torch.nn.hf_baselines import ViltModel
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.vilt = ViltModel(
            vocab_size=vocab_size, hidden_size=input_dim,
            num_layers=num_layers, num_heads=num_heads,
            intermediate_size=4 * input_dim,
            max_position_embeddings=max_position_embeddings,
            image_size=image_size, patch_size=patch_res,
            num_channels=channels, seed=None, **kw)
        self.drop = nn.Dropout(0.1)
        self.mlp_head = Dense(output_dim, input_dim, **kw)
        seeded(self, device, seed)

    def forward(self, tweets, images):
        mask, token_types = _zero_text_mask(tweets)
        _, pooled = self.vilt(tweets, images, attention_mask=mask,
                              token_type_ids=token_types)
        return torch.sigmoid(self.mlp_head(self.drop(pooled)))
