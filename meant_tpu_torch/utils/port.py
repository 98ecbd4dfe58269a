"""Reference and HF state dicts onto the port's models, and the port's
`meant` back to the reference's layout (counterpart of
meant_tpu/utils/port.py).

Each importer maps a state dict into the JAX package's param layout
(nested dicts of numpy arrays, Flax's per-head (d, heads, dh) attention
kernels included); `weights.state_dict_from_jax` (or `load_jax_params`)
then carries that layout onto the port's modules, so one set of rules
names every key. The MEANT-family importers read the reference's own
module trees (`meant/meant.py`, `src/meant/meant.py` and their siblings):

  * torch Linear weight (out, in) -> the package's Linear
    `{"dense": {"kernel": (in, out), "bias"}}`; RMSNorm `scale` (and
    `offset`), LayerNorm `weight` / `bias` -> `scale` / `offset`;
  * the reference's projection-naming quirk: its xPosAttention, attention
    and paper-era temporal modules compute (q(x), v(x), k(x)), so its `v`
    Linear computes keys and its `k` Linear values; `attention_params`
    maps `v` -> `k` and `k` -> `v` there (`swap_kv`), and the src-era
    temporals keep the straight order;
  * the encoders' `encode` / `encode2` ModuleList indices -> named
    submodules (the final Linears at index 5 behind a Dropout, else 4);
  * the rotary `freqs` buffers carried exactly.

`export_meant` inverts `import_meant` from the port's own `meant` state
dict (its checkpoints have one layout).

  * torch Linear weight (out, in) -> Flax kernel (in, out);
  * the attention's q / k / v projections -> (d, heads, dh) kernels and
    (heads, dh) biases, the output projection -> (heads, dh, d), split
    with the checkpoint's own head count;
  * HF RobertaEmbeddings -> the embedding's tables and `ln_scale` /
    `ln_bias`; VisualBERT and ViLT as their JAX modules name them, ViLT's
    patch conv (out, in, kh, kw) -> (kh, kw, in, out).

A bf16 tensor is widened to fp32 exactly (numpy has no bf16; the JAX
package's `_t` raises a TypeError on one).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x)


def roberta_embedding_params(sd: Mapping, prefix: str = "") -> Dict:
    """HF RobertaEmbeddings -> RobertaEmbeddings params; `prefix` such as
    'embeddings.'."""
    p = prefix
    return {
        "word_embeddings": _t(sd[f"{p}word_embeddings.weight"]),
        "position_embeddings": _t(sd[f"{p}position_embeddings.weight"]),
        "token_type_embeddings": _t(sd[f"{p}token_type_embeddings.weight"]),
        "ln_scale": _t(sd[f"{p}LayerNorm.weight"]),
        "ln_bias": _t(sd[f"{p}LayerNorm.bias"]),
    }


def _mha_proj(sd: Mapping, prefix: str, num_heads: int) -> Dict:
    """torch (d, d) q / k / v projection -> Flax MHA per-head kernel."""
    w = _t(sd[f"{prefix}.weight"]).T
    b = _t(sd[f"{prefix}.bias"])
    d = w.shape[0]
    dh = d // num_heads
    return {"kernel": w.reshape(d, num_heads, dh),
            "bias": b.reshape(num_heads, dh)}


def _mha_out(sd: Mapping, prefix: str, num_heads: int) -> Dict:
    w = _t(sd[f"{prefix}.weight"]).T
    d = w.shape[1]
    dh = d // num_heads
    return {"kernel": w.reshape(num_heads, dh, d),
            "bias": _t(sd[f"{prefix}.bias"])}


def _dense(sd: Mapping, prefix: str) -> Dict:
    return {"kernel": _t(sd[f"{prefix}.weight"]).T,
            "bias": _t(sd[f"{prefix}.bias"])}


def _layer_norm(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def roberta_layer_params(sd: Mapping, prefix: str, num_heads: int) -> Dict:
    """HF RobertaLayer (or BertLayer) -> RobertaLayer params."""
    a = f"{prefix}.attention"
    return {
        "attention": {
            "query": _mha_proj(sd, f"{a}.self.query", num_heads),
            "key": _mha_proj(sd, f"{a}.self.key", num_heads),
            "value": _mha_proj(sd, f"{a}.self.value", num_heads),
            "out": _mha_out(sd, f"{a}.output.dense", num_heads),
        },
        "attention_norm": _layer_norm(sd, f"{a}.output.LayerNorm"),
        "intermediate": _dense(sd, f"{prefix}.intermediate.dense"),
        "output": _dense(sd, f"{prefix}.output.dense"),
        "output_norm": _layer_norm(sd, f"{prefix}.output.LayerNorm"),
    }


def import_hf_roberta(sd: Mapping, num_layers: int, num_heads: int = 12,
                      prefix: str = "roberta.") -> Dict:
    """HF RobertaModel state dict -> RobertaModel params (embeddings,
    `num_layers` layers, and the pooler when the checkpoint has one)."""
    p = prefix
    params = {"embeddings": roberta_embedding_params(sd, f"{p}embeddings.")}
    for i in range(num_layers):
        params[f"layer_{i}"] = roberta_layer_params(
            sd, f"{p}encoder.layer.{i}", num_heads)
    if f"{p}pooler.dense.weight" in sd:
        params["pooler"] = _dense(sd, f"{p}pooler.dense")
    return params


def import_visual_bert(sd: Mapping, num_layers: int,
                       num_heads: int = 12) -> Dict:
    """HF VisualBertModel state dict -> VisualBertModel params (text and
    visual embeddings, BERT layers, pooler)."""
    e = "embeddings."
    params = {
        "text_embeddings": {
            "word_embeddings": _t(sd[f"{e}word_embeddings.weight"]),
            "position_embeddings": _t(sd[f"{e}position_embeddings.weight"]),
            "token_type_embeddings":
                _t(sd[f"{e}token_type_embeddings.weight"]),
        },
        "visual_projection": _dense(sd, f"{e}visual_projection"),
        "visual_position_embeddings":
            _t(sd[f"{e}visual_position_embeddings.weight"]),
        "visual_token_type_embeddings":
            _t(sd[f"{e}visual_token_type_embeddings.weight"]),
        "embeddings_norm": _layer_norm(sd, f"{e}LayerNorm"),
        "pooler": _dense(sd, "pooler.dense"),
    }
    for i in range(num_layers):
        params[f"layer_{i}"] = roberta_layer_params(
            sd, f"encoder.layer.{i}", num_heads)
    return params


def import_vilt(sd: Mapping, num_layers: int, num_heads: int = 12) -> Dict:
    """HF ViltModel state dict -> ViltModel params: attention.attention.
    {query,key,value} and attention.output.dense, pre-LN layers
    (layernorm_before / layernorm_after), the patch conv as (kh, kw, in,
    out)."""
    e = "embeddings."
    te = f"{e}text_embeddings."
    params = {
        "text_embeddings": {
            "word_embeddings": _t(sd[f"{te}word_embeddings.weight"]),
            "position_embeddings":
                _t(sd[f"{te}position_embeddings.weight"]),
            "token_type_embeddings":
                _t(sd[f"{te}token_type_embeddings.weight"]),
            "norm": _layer_norm(sd, f"{te}LayerNorm"),
        },
        "cls_token": _t(sd[f"{e}cls_token"]),
        "position_embeddings": _t(sd[f"{e}position_embeddings"]),
        "token_type_embeddings": _t(sd[f"{e}token_type_embeddings.weight"]),
        "patch_projection": {
            "kernel": _t(sd[f"{e}patch_embeddings.projection.weight"])
            .transpose(2, 3, 1, 0),
            "bias": _t(sd[f"{e}patch_embeddings.projection.bias"]),
        },
        "layernorm": _layer_norm(sd, "layernorm"),
        "pooler": _dense(sd, "pooler.dense"),
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "query": _mha_proj(sd, f"{p}.attention.attention.query",
                                   num_heads),
                "key": _mha_proj(sd, f"{p}.attention.attention.key",
                                 num_heads),
                "value": _mha_proj(sd, f"{p}.attention.attention.value",
                                   num_heads),
                "out": _mha_out(sd, f"{p}.attention.output.dense",
                                num_heads),
            },
            "layernorm_before": _layer_norm(sd, f"{p}.layernorm_before"),
            "layernorm_after": _layer_norm(sd, f"{p}.layernorm_after"),
            "intermediate": _dense(sd, f"{p}.intermediate.dense"),
            "output": _dense(sd, f"{p}.output.dense"),
        }
    return params


# ---- the MEANT family (meant_tpu/utils/port.py:40-124, :125-158,
# :220-642, :751-785) -------------------------------------------------------

def linear_params(sd: Mapping, prefix: str) -> Dict:
    """torch Linear -> the package's Linear ({"dense": kernel, bias})."""
    out = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return {"dense": out}


def norm_params(sd: Mapping, prefix: str, kind: str) -> Dict:
    """RMSNorm (`scale`, optional `offset`) or LayerNorm (`weight`,
    `bias`) -> `scale` / `offset`."""
    if kind == "rms":
        out = {"scale": _t(sd[f"{prefix}.scale"])}
        if f"{prefix}.offset" in sd:
            out["offset"] = _t(sd[f"{prefix}.offset"])
        return out
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "offset": _t(sd[f"{prefix}.bias"])}


def attention_params(sd: Mapping, prefix: str, swap_kv: bool = True,
                     freqs_key: str = None) -> Dict:
    """q / k / v / multi_mad of an xPosAttention, attention or temporal
    module; with swap_kv the reference's `v` Linear is the keys' and its
    `k` the values'."""
    k_src = "v" if swap_kv else "k"
    v_src = "k" if swap_kv else "v"
    out = {
        "q": linear_params(sd, f"{prefix}.q"),
        "k": linear_params(sd, f"{prefix}.{k_src}"),
        "v": linear_params(sd, f"{prefix}.{v_src}"),
        "multi_mad": linear_params(sd, f"{prefix}.multi_mad"),
    }
    if freqs_key and freqs_key in sd:
        out["freqs"] = _t(sd[freqs_key])
    return out


def encoder_params(sd: Mapping, prefix: str, norm: str = "rms",
                   ff_norm2: str = None, xpos_prefix: str = None) -> Dict:
    """One languageEncoder / visionEncoder: `encode` and `encode2` by
    index, the final Linears at index 5 where a Dropout precedes them (the
    index that holds a Linear is probed)."""
    ff_norm2 = ff_norm2 or norm
    proj_out_idx = 5 if f"{prefix}.encode.5.weight" in sd else 4
    ff_out_idx = 5 if f"{prefix}.encode2.5.weight" in sd else 4
    freqs_key = f"{xpos_prefix}.freqs" if xpos_prefix else None
    return {
        "norm1": norm_params(sd, f"{prefix}.encode.0", norm),
        "proj_in": linear_params(sd, f"{prefix}.encode.1"),
        "attn": attention_params(sd, f"{prefix}.encode.2", swap_kv=True,
                                 freqs_key=freqs_key),
        "norm2": norm_params(sd, f"{prefix}.encode.3", norm),
        "proj_out": linear_params(sd, f"{prefix}.encode.{proj_out_idx}"),
        "norm3": norm_params(sd, f"{prefix}.encode2.0", norm),
        "ff_in": linear_params(sd, f"{prefix}.encode2.1"),
        "norm4": norm_params(sd, f"{prefix}.encode2.3", ff_norm2),
        "ff_out": linear_params(sd, f"{prefix}.encode2.{ff_out_idx}"),
    }


def lm_head_params(sd: Mapping, prefix: str = "lm_head.") -> Dict:
    """HF RobertaLMHead -> RobertaLMHead params."""
    p = prefix
    return {
        "dense": linear_params(sd, f"{p}dense"),
        "norm": {"scale": _t(sd[f"{p}layer_norm.weight"]),
                 "offset": _t(sd[f"{p}layer_norm.bias"])},
        "decoder": linear_params(sd, f"{p}decoder"),
    }


def _head(sd: Mapping, kind: str) -> Dict:
    """mlpHead: Sequential(norm, Linear)."""
    return {"norm": norm_params(sd, "mlpHead.0", kind),
            "proj": linear_params(sd, "mlpHead.1")}


def _encoders(sd: Mapping, num_encoders: int, tower: str, rotary: str,
              norm: str, ff_norm2: str = None) -> Dict:
    """`num_encoders` encoders of one tower, their rotary tables at
    `<tower>.<i>.<rotary>.freqs`."""
    return {f"{tower}_{i}": encoder_params(
                sd, f"{tower}.{i}", norm=norm, ff_norm2=ff_norm2,
                xpos_prefix=f"{tower}.{i}.{rotary}")
            for i in range(num_encoders)}


def _temporal(sd: Mapping, prefix: str, norm: str, swap_kv: bool,
              proj_out: int = 4, temp_embedding: bool = False) -> Dict:
    """A temporalEncoder [norm, Linear, temporal, norm, (Dropout,) Linear]
    (and its temp_embedding)."""
    e = f"{prefix}.temp_encode"
    out = {}
    if temp_embedding:
        out["temp_embedding"] = _t(sd[f"{prefix}.temp_embedding"])
    out.update({
        "norm1": norm_params(sd, f"{e}.0", norm),
        "proj_in": linear_params(sd, f"{e}.1"),
        "temporal": attention_params(sd, f"{e}.2", swap_kv=swap_kv),
        "norm2": norm_params(sd, f"{e}.3", norm),
        "proj_out": linear_params(sd, f"{e}.{proj_out}"),
    })
    return out


def _slim_temporal_params(sd: Mapping, prefix: str) -> Dict:
    """The slim temporalEncoder (`meant/meant_vision.py:81-106`):
    temp_embedding + [Linear, temporal, Linear], its norms commented
    out."""
    return {
        "temp_embedding": _t(sd[f"{prefix}.temp_embedding"]),
        "proj_in": linear_params(sd, f"{prefix}.temp_encode.0"),
        "temporal": attention_params(sd, f"{prefix}.temp_encode.1",
                                     swap_kv=True),
        "proj_out": linear_params(sd, f"{prefix}.temp_encode.2"),
    }


def _seq_projection_params(sd: Mapping, prefix: str) -> Dict:
    """lang_proj / image_proj, Sequential(Linear, LayerNorm(1), GELU)."""
    return {"proj": linear_params(sd, f"{prefix}.0"),
            "norm": norm_params(sd, f"{prefix}.1", "layer")}


def _attn_pool_params(sd: Mapping, prefix: str) -> Dict:
    """lang_prep / image_prep, Sequential(Linear, LayerNorm, GELU, Linear,
    Softmax)."""
    return {"proj1": linear_params(sd, f"{prefix}.0"),
            "norm": norm_params(sd, f"{prefix}.1", "layer"),
            "proj2": linear_params(sd, f"{prefix}.3")}


def import_meant(sd: Mapping, num_encoders: int) -> Dict:
    """The paper generation's `meant` (`meant/meant.py`) -> its params;
    the rotary tables are those inside the attention modules
    (`encode.2.xPos`, `encode.2.pos_emb`)."""
    return {
        "embedding": roberta_embedding_params(sd, "embedding.0."),
        "patchEmbed": linear_params(sd, "patchEmbed.1"),
        "temporal_encoding_0": _temporal(sd, "temporal_encoding.0", "rms",
                                         swap_kv=True, temp_embedding=True),
        "mlpHead": _head(sd, "rms"),
        **_encoders(sd, num_encoders, "languageEncoders", "encode.2.xPos",
                    "rms"),
        **_encoders(sd, num_encoders, "visionEncoders", "encode.2.pos_emb",
                    "rms"),
    }


def import_meant_vision(sd: Mapping, num_encoders: int) -> Dict:
    """`meant/meant_vision.py` -> meant_vision params."""
    return {
        "patchEmbed": linear_params(sd, "patchEmbed.1"),
        "temporal_encoding_0": _slim_temporal_params(sd,
                                                     "temporal_encoding.0"),
        "mlpHead": _head(sd, "layer"),
        **_encoders(sd, num_encoders, "visionEncoders", "posEmbed", "rms"),
    }


def import_language_pretrainer(sd: Mapping, num_encoders: int,
                               tie: bool = True) -> Dict:
    """meant_language_pretrainer (`pretrain_mlm.py:74-88`): the RoBERTa
    embedding, paper-generation languageEncoders and bertweet's LM head;
    with `tie` (the RobertaForMaskedLM default) only the decoder's bias,
    its weight being the word-embedding table on both sides."""
    if tie:
        head = {
            "dense": linear_params(sd, "mlm_head.dense"),
            "norm": {"scale": _t(sd["mlm_head.layer_norm.weight"]),
                     "offset": _t(sd["mlm_head.layer_norm.bias"])},
            "decoder_bias": _t(sd["mlm_head.decoder.bias"]),
        }
    else:
        head = lm_head_params(sd, "mlm_head.")
    return {
        "embedding": roberta_embedding_params(sd, "embedding.0."),
        "mlm_head": head,
        **_encoders(sd, num_encoders, "languageEncoders", "encode.2.xPos",
                    "rms"),
    }


def import_vision_pretrainer(sd: Mapping, num_encoders: int) -> Dict:
    """meant_vision_pretrainer (`pretrain_mim.py:77-99`): the decoder's 1x1
    conv (out, in, 1, 1) onto the per-position Linear. The reference builds
    one visionEncoder whatever num_encoders says (DEFECTS #29): pass the
    depth the checkpoint holds."""
    conv_w = _t(sd["decoder.0.weight"])
    return {
        "patchEmbed": linear_params(sd, "patchEmbed.1"),
        "decoder": {"dense": {"kernel": conv_w[:, :, 0, 0].T,
                              "bias": _t(sd["decoder.0.bias"])}},
        **_encoders(sd, num_encoders, "visionEncoders", "encode.2.pos_emb",
                    "rms"),
    }


def import_meant_tweet_no_lag(sd: Mapping, num_encoders: int) -> Dict:
    """`meant/meant_tweet_no_lag.py` -> its params (LayerNorm encoders, a
    cls token, LayerNorm head)."""
    return {
        "embedding": roberta_embedding_params(sd, "embedding.0."),
        "txt_classtkn": _t(sd["txt_classtkn"]).reshape(1, 1, -1),
        "mlpHead": _head(sd, "layer"),
        **_encoders(sd, num_encoders, "languageEncoders", "xPos", "layer"),
    }


def import_meant_src(sd: Mapping, num_encoders: int) -> Dict:
    """The src-era `meant` (`src/meant/meant.py:197-311`) -> meant_src
    params: LayerNorm encoders with an RMSNorm ff norm, the temporal in the
    straight q / k / v order, separate projections."""
    return {
        "embedding": roberta_embedding_params(sd, "embedding.0."),
        "patchEmbed": linear_params(sd, "patchEmbed.1"),
        "lang_proj": _seq_projection_params(sd, "lang_proj"),
        "image_proj": _seq_projection_params(sd, "image_proj"),
        "temporal_encoding_0": _temporal(sd, "temporal_encoding.0", "layer",
                                         swap_kv=False),
        "mlpHead": _head(sd, "layer"),
        **_encoders(sd, num_encoders, "languageEncoders", "xPos", "layer",
                    "rms"),
        **_encoders(sd, num_encoders, "visionEncoders", "posEmbed", "layer",
                    "rms"),
    }


def import_meant_vqa(sd: Mapping, num_encoders: int) -> Dict:
    """`meant/meant_vqa.py` -> meant_vqa params (RMSNorm generation; the
    reference's unused multimodal blocks, dead in its forward, skipped)."""
    return {
        "embedding": roberta_embedding_params(sd, "embedding.0."),
        "patchEmbed": linear_params(sd, "patchEmbed.1"),
        "mlpHead": _head(sd, "rms"),
        **_encoders(sd, num_encoders, "languageEncoders", "xPos", "rms"),
        **_encoders(sd, num_encoders, "visionEncoders", "posEmbed", "rms"),
    }


def import_timesformer(sd: Mapping, depth: int, prefix: str = "") -> Dict:
    """The TimeSformer (`src/meant/timesformer_pytorch.py:150-265`):
    layers.{i}.{0, 1, 2} = PreNorm(time attention / space attention / feed
    forward), `.norm` and `.fn` (to_qkv without a bias, to_out.0; net.0 and
    net.3); the optional output head to_out.{0, 1}."""
    p = prefix
    params = {
        "to_patch_embedding": _dense(sd, f"{p}to_patch_embedding"),
        "cls_token": _t(sd[f"{p}cls_token"]),
    }
    for i in range(depth):
        for slot, kind in ((0, "time"), (1, "space")):
            base = f"{p}layers.{i}.{slot}"
            params[f"{kind}_norm_{i}"] = _layer_norm(sd, f"{base}.norm")
            params[f"{kind}_attn_{i}"] = {
                "to_qkv": {"kernel": _t(sd[f"{base}.fn.to_qkv.weight"]).T},
                "to_out": _dense(sd, f"{base}.fn.to_out.0"),
            }
        base = f"{p}layers.{i}.2"
        params[f"ff_norm_{i}"] = _layer_norm(sd, f"{base}.norm")
        params[f"ff_{i}"] = {"proj_in": _dense(sd, f"{base}.fn.net.0"),
                             "proj_out": _dense(sd, f"{base}.fn.net.3")}
    if f"{p}to_out.0.weight" in sd:
        params["out_norm"] = _layer_norm(sd, f"{p}to_out.0")
        params["out_proj"] = _dense(sd, f"{p}to_out.1")
    return params


def import_meant_timesformer(sd: Mapping, num_encoders: int,
                             ts_depth: int = 1) -> Dict:
    """The src-era meant_timesformer (`src/meant/meant_timesformer.py:
    200-358`); the reference's unused visionEncoders, patchEmbed and
    lang_red, dead in its forward, skipped."""
    return {
        "embedding": roberta_embedding_params(sd, "embedding.0."),
        "timesformer": import_timesformer(sd, ts_depth,
                                          prefix="timesformer."),
        "lang_prep": _attn_pool_params(sd, "lang_prep"),
        "image_prep": _attn_pool_params(sd, "image_prep"),
        "temporal_encoding_0": _temporal(sd, "temporal_encoding.0", "layer",
                                         swap_kv=False),
        "mlpHead": _head(sd, "layer"),
        **_encoders(sd, num_encoders, "languageEncoders", "xPos", "layer",
                    "rms"),
    }


def import_meant_mean_pooling(sd: Mapping, num_encoders: int,
                              ts_depth: int = 1) -> Dict:
    """The src-era meant_mean_pooling (`src/meant/meant_mean_pooling.py`):
    mean-pooled text and a TimeSformer image branch through the degenerate
    image_proj (Linear(981, 1), LayerNorm(1), GELU)."""
    return {
        "embedding": roberta_embedding_params(sd, "embedding.0."),
        "timesformer": import_timesformer(sd, ts_depth,
                                          prefix="timesformer."),
        "image_proj": _seq_projection_params(sd, "image_proj"),
        "temporal_encoding_0": _temporal(sd, "temporal_encoding.0", "layer",
                                         swap_kv=False),
        "mlpHead": _head(sd, "layer"),
        **_encoders(sd, num_encoders, "languageEncoders", "xPos", "layer",
                    "rms"),
    }


def import_meant_tweet_price(sd: Mapping, num_encoders: int) -> Dict:
    """meantTweetPrice (`src/meant/meant_tweet_price.py:139-219`): RMSNorm
    languageEncoders; a temporalEncoder with its temp_embedding, RMSNorms,
    the straight q / k / v order and proj_out at temp_encode.5 (behind a
    Dropout)."""
    return {
        "embedding": roberta_embedding_params(sd, "embedding.0."),
        "temporal_encoding_0": _temporal(sd, "temporal_encoding.0", "rms",
                                         swap_kv=False, proj_out=5,
                                         temp_embedding=True),
        "mlpHead": _head(sd, "layer"),
        **_encoders(sd, num_encoders, "languageEncoders", "xPos", "rms"),
    }


def import_meant_tweet(sd: Mapping, num_encoders: int) -> Dict:
    """meant_tweet (`meant/meant_tweet.py:114-166`): RMSNorm
    languageEncoders, the slim temporalEncoder (swapped k / v naming),
    LayerNorm head."""
    return {
        "embedding": roberta_embedding_params(sd, "embedding.0."),
        "temporal_encoding_0": _slim_temporal_params(sd,
                                                     "temporal_encoding.0"),
        "mlpHead": _head(sd, "layer"),
        **_encoders(sd, num_encoders, "languageEncoders", "xPos", "rms"),
    }


def import_meant_price(sd: Mapping) -> Dict:
    """meant_price (`src/meant/meantPrice.py:67-100`): a norm-free
    temporalEncoder [Linear, temporal, Linear] in the straight order, a
    LayerNorm head."""
    e = "temporal_encoding.0.temp_encode"
    return {
        "temporal_encoding_0": {
            "proj_in": linear_params(sd, f"{e}.0"),
            "temporal": attention_params(sd, f"{e}.1", swap_kv=False),
            "proj_out": linear_params(sd, f"{e}.2"),
        },
        "mlpHead": _head(sd, "layer"),
    }


def import_temporal2(sd: Mapping, prefix: str = "") -> Dict:
    """temporal_2 (`src/meant/temporal_new.py:7-69`) -> TemporalAttention2
    params, in the straight order."""
    p = prefix
    return {"q": linear_params(sd, f"{p}q"), "k": linear_params(sd, f"{p}k"),
            "v": linear_params(sd, f"{p}v"),
            "multi_mad": linear_params(sd, f"{p}multi_mad.0")}


def _mlp_stem(sd: Mapping) -> Dict:
    return {"input_layer": linear_params(sd, "input_layer.0"),
            "input_norm": norm_params(sd, "input_layer.1", "layer"),
            "output_layer": linear_params(sd, "output_layer.0")}


def import_mlp_encoder(sd: Mapping, num_hidden_layers: int = 3) -> Dict:
    """mlpEncoder (`src/meant/simple_mlp.py:5-28`)."""
    params = _mlp_stem(sd)
    for i in range(num_hidden_layers):
        params[f"hidden_{i}"] = linear_params(sd, f"hidden.{i}.0")
        params[f"hidden_norm_{i}"] = norm_params(sd, f"hidden.{i}.1",
                                                 "layer")
    return params


def import_lstm_encoder(sd: Mapping, num_hidden_layers: int = 3) -> Dict:
    """LSTMEncoder (`src/meant/simple_mlp.py:31-49`): torch's nn.LSTM gates
    [input, forget, cell (g), output] stacked in weight_ih / weight_hh ->
    one Dense a gate and side (ii / if / ig / io without a bias, hi / hf /
    hg / ho whose bias is bias_ih + bias_hh)."""
    params = _mlp_stem(sd)
    for layer in range(num_hidden_layers):
        w_ih = _t(sd[f"hidden.weight_ih_l{layer}"])
        w_hh = _t(sd[f"hidden.weight_hh_l{layer}"])
        b = (_t(sd[f"hidden.bias_ih_l{layer}"])
             + _t(sd[f"hidden.bias_hh_l{layer}"]))
        h = w_hh.shape[1]
        cell = {}
        for gi, gate in enumerate(("i", "f", "g", "o")):
            rows = slice(gi * h, (gi + 1) * h)
            cell[f"i{gate}"] = {"kernel": w_ih[rows].T}
            cell[f"h{gate}"] = {"kernel": w_hh[rows].T, "bias": b[rows]}
        params[f"lstm_{layer}"] = cell
    return params


def import_audio_encoder(sd: Mapping, num_layers: int = 3, nhead: int = 2,
                         emb_prefix: str = "audio_emb.",
                         enc_prefix: str = "audio_encoder.") -> Dict:
    """The MOSI audio branch (`src/meant/meant_mosi.py:294-307`): torch's
    nn.TransformerEncoder (the packed in_proj q / k / v) and the cls
    nn.Embedding -> AudioEncoder params."""
    params = {"cls_emb": _t(sd[f"{emb_prefix}weight"]).reshape(1, 1, -1)}
    for i in range(num_layers):
        p = f"{enc_prefix}layers.{i}."
        w = _t(sd[f"{p}self_attn.in_proj_weight"])
        b = _t(sd[f"{p}self_attn.in_proj_bias"])
        d = w.shape[1]
        attn = {}
        for j, name in enumerate(("query", "key", "value")):
            rows = slice(j * d, (j + 1) * d)
            attn[name] = {"kernel": w[rows].T.reshape(d, nhead, d // nhead),
                          "bias": b[rows].reshape(nhead, d // nhead)}
        attn["out"] = _mha_out(sd, f"{p}self_attn.out_proj", nhead)
        params[f"attn_{i}"] = attn
        params[f"ff1_{i}"] = _dense(sd, f"{p}linear1")
        params[f"ff2_{i}"] = _dense(sd, f"{p}linear2")
        params[f"norm1_{i}"] = _layer_norm(sd, f"{p}norm1")
        params[f"norm2_{i}"] = _layer_norm(sd, f"{p}norm2")
    return params


# ---- the reverse: the port's `meant` -> the reference's state dict
# (meant_tpu/utils/port.py:788-898) ---------------------------------------

_EMBED_TABLES = ("word_embeddings", "position_embeddings",
                 "token_type_embeddings")
_TOWER_KEY = re.compile(r"^(languageEncoders|visionEncoders)\.(\d+)\.")


def _meant_params(state_dict: Mapping) -> Dict:
    """The port's `meant` state dict -> the JAX package's param tree (the
    inverse of `weights.state_dict_from_jax` on the leaves a `meant`
    holds): a 2-D `weight` is a Linear's (transposed back to a kernel) or
    an embedding table, a 1-D one a norm's scale (the embedding's
    `layer_norm` its ln_scale); `freqs` and `temp_embedding` as they are;
    `languageEncoders.3` back to `languageEncoders_3`."""
    linears = {k[:-len(".weight")] for k, v in state_dict.items()
               if k.endswith(".weight") and v.dim() == 2}
    tree: Dict = {}
    for key, value in state_dict.items():
        a = _t(value)
        parts = _TOWER_KEY.sub(r"\1_\2.", key).split(".")
        owner, leaf = parts[:-1], parts[-1]
        base = key[:-len(leaf) - 1]
        if leaf in ("weight", "bias") and owner and owner[-1] in _EMBED_TABLES:
            path = owner
        elif leaf in ("weight", "bias") and base in linears:
            path = owner + ["dense", "kernel" if leaf == "weight" else "bias"]
            a = a.T if leaf == "weight" else a
        elif leaf in ("weight", "bias") and owner and owner[-1] == "layer_norm":
            path = owner[:-1] + ["ln_scale" if leaf == "weight"
                                 else "ln_bias"]
        elif leaf in ("weight", "bias"):
            path = owner + ["scale" if leaf == "weight" else "offset"]
        elif leaf in ("freqs", "temp_embedding"):
            path = parts
        else:
            raise KeyError(f"no rule maps {key} of a meant state dict")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    return tree


def _unlinear(tree: Mapping, out: Dict, prefix: str) -> None:
    d = tree["dense"]
    out[f"{prefix}.weight"] = np.asarray(d["kernel"]).T
    if "bias" in d:
        out[f"{prefix}.bias"] = np.asarray(d["bias"])


def _unnorm(tree: Mapping, out: Dict, prefix: str, kind: str) -> None:
    if kind == "rms":
        out[f"{prefix}.scale"] = np.asarray(tree["scale"])
        if "offset" in tree:
            out[f"{prefix}.offset"] = np.asarray(tree["offset"])
    else:
        out[f"{prefix}.weight"] = np.asarray(tree["scale"])
        out[f"{prefix}.bias"] = np.asarray(tree["offset"])


def _unattention(tree: Mapping, out: Dict, prefix: str,
                 swap_kv: bool = True) -> None:
    """attention_params inverted: the true q / k / v back to the
    reference's swapped naming."""
    _unlinear(tree["q"], out, f"{prefix}.q")
    _unlinear(tree["k"], out, f"{prefix}.{'v' if swap_kv else 'k'}")
    _unlinear(tree["v"], out, f"{prefix}.{'k' if swap_kv else 'v'}")
    _unlinear(tree["multi_mad"], out, f"{prefix}.multi_mad")


def _unencoder(tree: Mapping, out: Dict, prefix: str, norm: str,
               final: int, xpos_prefix: str) -> None:
    """encoder_params inverted; `final` the index of the last Linears (5
    in a languageEncoder, behind its Dropouts; 4 in a visionEncoder)."""
    _unnorm(tree["norm1"], out, f"{prefix}.encode.0", norm)
    _unlinear(tree["proj_in"], out, f"{prefix}.encode.1")
    _unattention(tree["attn"], out, f"{prefix}.encode.2", swap_kv=True)
    _unnorm(tree["norm2"], out, f"{prefix}.encode.3", norm)
    _unlinear(tree["proj_out"], out, f"{prefix}.encode.{final}")
    _unnorm(tree["norm3"], out, f"{prefix}.encode2.0", norm)
    _unlinear(tree["ff_in"], out, f"{prefix}.encode2.1")
    _unnorm(tree["norm4"], out, f"{prefix}.encode2.3", norm)
    _unlinear(tree["ff_out"], out, f"{prefix}.encode2.{final}")
    if "freqs" in tree["attn"]:
        out[f"{xpos_prefix}.freqs"] = np.asarray(tree["attn"]["freqs"])


def export_meant(state_dict: Mapping, num_encoders: int) -> Dict:
    """The port's `meant` state dict -> the reference's torch state dict
    (`meant/meant.py`; numpy values, `import_meant`'s inverse), both
    aliases of each encoder's rotary table included: torch registers the
    shared rotary module on the encoder and inside its attention."""
    params = _meant_params(state_dict)
    out: Dict = {}
    emb = params["embedding"]
    for name in _EMBED_TABLES:
        out[f"embedding.0.{name}.weight"] = np.asarray(emb[name])
    out["embedding.0.LayerNorm.weight"] = np.asarray(emb["ln_scale"])
    out["embedding.0.LayerNorm.bias"] = np.asarray(emb["ln_bias"])
    _unlinear(params["patchEmbed"], out, "patchEmbed.1")
    t, e = params["temporal_encoding_0"], "temporal_encoding.0"
    out[f"{e}.temp_embedding"] = np.asarray(t["temp_embedding"])
    _unnorm(t["norm1"], out, f"{e}.temp_encode.0", "rms")
    _unlinear(t["proj_in"], out, f"{e}.temp_encode.1")
    _unattention(t["temporal"], out, f"{e}.temp_encode.2", swap_kv=True)
    _unnorm(t["norm2"], out, f"{e}.temp_encode.3", "rms")
    _unlinear(t["proj_out"], out, f"{e}.temp_encode.4")
    _unnorm(params["mlpHead"]["norm"], out, "mlpHead.0", "rms")
    _unlinear(params["mlpHead"]["proj"], out, "mlpHead.1")
    for i in range(num_encoders):
        for tower, final, inner, alias in (
                ("languageEncoders", 5, "xPos", "xPos"),
                ("visionEncoders", 4, "pos_emb", "posEmbed")):
            _unencoder(params[f"{tower}_{i}"], out, f"{tower}.{i}", "rms",
                       final, f"{tower}.{i}.encode.2.{inner}")
            key = f"{tower}.{i}.encode.2.{inner}.freqs"
            if key in out:
                out[f"{tower}.{i}.{alias}.freqs"] = out[key]
    return out
