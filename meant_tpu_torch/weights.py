"""Carry JAX parameters of the MEANT models over to the port.

`state_dict_from_jax(params)` takes the Flax param tree as a nested dict of
numpy arrays and returns the port's `state_dict`:

* Flax `Dense` kernels are (in, out): `X/dense/kernel` (the package's
  `Linear`) and a raw Flax `X/kernel` (`nn.Dense`, the LSTM cell's gates)
  become `X.weight` transposed to (out, in); `X/dense/bias` and `X/bias`
  become `X.bias`.
* The attention's `DenseGeneral` kernels (`query` / `key` / `value` (in,
  heads, dh), `out` (heads, dh, out)) become (out, in) matrices, their
  (heads, dh) biases vectors.
* A Flax `Conv` kernel (kh, kw, cin, cout) becomes torch's (cout, cin, kh,
  kw) (ViLT's patch projection).
* Norm `scale` / `offset` (the package's norms) and `scale` / `bias`
  (Flax's `nn.LayerNorm`) become `weight` / `bias` (the embedding's
  `ln_scale` / `ln_bias` become `layer_norm.weight` / `.bias`).
* Embedding tables (the RoBERTa and BERT ones, VisualBERT's visual
  position and token-type tables, ViLT's (1, g^2 + 1, d) position table,
  and Flax `nn.Embed`'s `embedding`) become `<name>.weight`; `freqs`
  buffers, `temp_embedding`, the cls tokens and embeddings
  (`txt_classtkn`, `img_classtkn`, `cls_token`, `cls_emb`), the
  TimeSformer's `pos_emb` and the tied MLM head's `decoder_bias` copy as
  they are.
* `languageEncoders_3` becomes `languageEncoders.3` (a ModuleList), and a
  TimeSformer layer's `time_attn_3` (and its other components) becomes
  `layers.3.time_attn`.
* The scanned layout of a tower, `languageEncoders_scan/enc/...` (and
  `visionEncoders_scan`), and of a TimeSformer, `layers_scan/enc/...`,
  every leaf with a leading layer axis, is unstacked first
  (`nn.stack.unstack_encoder_params`, `unstack_timesformer_params`): a
  scanned JAX model and an unrolled one load into the same port model,
  whose checkpoints have one layout.

Every leaf maps to exactly one key; a leaf no rule knows raises.
`load_jax_params` then loads strictly, so a missing or unused key, or a
shape that differs, fails.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from meant_tpu_torch.nn.stack import (TS_COMPONENTS, unstack_encoder_params,
                                      unstack_timesformer_params)

_EMBED_TABLES = ("word_embeddings", "position_embeddings",
                 "token_type_embeddings", "visual_position_embeddings",
                 "visual_token_type_embeddings")
# leaves whose torch key is their JAX path: rotary buffers, the temporal
# encoder's positional parameter, the cls tokens and embeddings, the
# TimeSformer's positional parameter and the tied MLM head's bias
_AS_THEY_ARE = ("freqs", "temp_embedding", "txt_classtkn", "img_classtkn",
                "cls_token", "cls_emb", "pos_emb", "decoder_bias")
_TOWERS = ("languageEncoders", "visionEncoders")
_LIST_RE = re.compile(r"^(languageEncoders|visionEncoders)_(\d+)$")
_TS_RE = re.compile(r"^(%s)_(\d+)$" % "|".join(TS_COMPONENTS))


def _timesformer_layers(tree: Mapping[str, Any]) -> dict:
    """A TimeSformer subtree, unrolled or scanned, with its layers under
    `layers/{i}/<component>`."""
    out = dict(unstack_timesformer_params(tree) if "layers_scan" in tree
               else tree)
    layers: Dict[str, dict] = {}
    for key in list(out):
        if m := _TS_RE.match(key):
            layers.setdefault(m.group(2), {})[m.group(1)] = out.pop(key)
    if layers:
        out["layers"] = layers
    return out


def _unrolled(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    """`tree` with every scanned tower, at any depth, in the unrolled
    `<tower>_{i}` layout, and every TimeSformer's layers (a subtree that
    holds `time_attn_0` or `layers_scan`) under `layers`."""
    out = {k: _unrolled(v) if isinstance(v, Mapping) else v
           for k, v in tree.items()}
    for tower in _TOWERS:
        if f"{tower}_scan" in out:
            out = unstack_encoder_params(out, tower)
    if "layers_scan" in out or "time_attn_0" in out:
        out = _timesformer_layers(out)
    return out


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def _as_matrix(kernel: np.ndarray, projection: str) -> np.ndarray:
    """A Flax kernel as the port's weight: a Dense kernel (in, out)
    transposed to (out, in); a DenseGeneral one, (in, heads, dh) or for
    `out` (heads, dh, out), flattened to (in, out) first; a Conv kernel
    (kh, kw, cin, cout) as (cout, cin, kh, kw)."""
    if kernel.ndim == 4:
        return kernel.transpose(3, 2, 0, 1)
    if kernel.ndim == 3:
        kernel = (kernel.reshape(-1, kernel.shape[-1]) if projection == "out"
                  else kernel.reshape(kernel.shape[0], -1))
    return kernel.T


def _torch_key(path: tuple, a: np.ndarray) -> tuple:
    """JAX param path and value -> (torch key, the value in the port's
    layout)."""
    parts = [(f"{m.group(1)}.{m.group(2)}" if (m := _LIST_RE.match(p))
              else p) for p in path]
    leaf = parts[-1]
    if leaf in ("kernel", "bias"):
        owner = parts[:-2] if len(parts) >= 2 and parts[-2] == "dense" \
            else parts[:-1]
        if leaf == "kernel":
            return ".".join(owner + ["weight"]), _as_matrix(a, parts[-2])
        return ".".join(owner + ["bias"]), a.reshape(-1)
    if leaf in ("scale", "offset"):
        return ".".join(parts[:-1] + ["weight" if leaf == "scale"
                                      else "bias"]), a
    if leaf in ("ln_scale", "ln_bias"):
        return ".".join(parts[:-1] + ["layer_norm",
                                      "weight" if leaf == "ln_scale"
                                      else "bias"]), a
    if leaf in _EMBED_TABLES:
        return ".".join(parts + ["weight"]), a
    if leaf == "embedding":             # Flax nn.Embed's table
        return ".".join(parts[:-1] + ["weight"]), a
    if leaf in _AS_THEY_ARE:
        return ".".join(parts), a
    raise KeyError(f"no rule maps JAX param {'/'.join(path)}")


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (JAX layout) -> port state_dict (CPU
    tensors, dtypes kept)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(_unrolled(params)).items():
        key, value = _torch_key(path, np.asarray(arr))
        if key in out:
            raise KeyError(f"two JAX params map to {key}")
        out[key] = torch.tensor(np.ascontiguousarray(value))
    return out


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """Load JAX params into `model` strictly: every model key filled, every
    JAX leaf used, every shape equal."""
    sd = state_dict_from_jax(params)
    own = model.state_dict()
    bad = [f"{k}: jax {tuple(v.shape)} vs port {tuple(own[k].shape)}"
           for k, v in sd.items() if k in own and own[k].shape != v.shape]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    model.load_state_dict(sd, strict=True)
