"""HF state dicts onto the port's models (counterpart of the importers of
meant_tpu/utils/port.py that the CLI's pretrained flows use).

Each importer maps a HuggingFace state dict into the JAX package's param
layout (nested dicts of numpy arrays, Flax's per-head (d, heads, dh)
attention kernels included); `weights.state_dict_from_jax` then carries
that layout onto the port's modules, so one set of rules names every key.

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
