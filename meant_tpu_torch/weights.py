"""Carry JAX parameters of the MEANT models over to the port.

`state_dict_from_jax(params)` takes the Flax param tree as a nested dict of
numpy arrays and returns the port's `state_dict`:

* Flax `Dense` kernels are (in, out): `X/dense/kernel` becomes `X.weight`
  transposed to (out, in); `X/dense/bias` becomes `X.bias`.
* Norm `scale` / `offset` become `weight` / `bias` (the embedding's
  `ln_scale` / `ln_bias` become `layer_norm.weight` / `.bias`).
* Embedding tables become `<name>.weight`; `freqs` buffers,
  `temp_embedding`, the cls tokens (`txt_classtkn`, `img_classtkn`) and the
  tied MLM head's `decoder_bias` copy as they are.
* `languageEncoders_3` becomes `languageEncoders.3` (a ModuleList).
* The scanned layout of a tower, `languageEncoders_scan/enc/...` (and
  `visionEncoders_scan`), every leaf with a leading layer axis, is
  unstacked first (`nn.stack.unstack_encoder_params`): a scanned JAX model
  and an unrolled one load into the same port model, whose checkpoints have
  one layout.

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

from meant_tpu_torch.nn.stack import unstack_encoder_params

_EMBED_TABLES = ("word_embeddings", "position_embeddings",
                 "token_type_embeddings")
# leaves whose torch key is their JAX path: rotary buffers, the temporal
# encoder's positional parameter, the cls tokens and the tied MLM head's bias
_AS_THEY_ARE = ("freqs", "temp_embedding", "txt_classtkn", "img_classtkn",
                "decoder_bias")
_TOWERS = ("languageEncoders", "visionEncoders")
_LIST_RE = re.compile(r"^(languageEncoders|visionEncoders)_(\d+)$")


def _unrolled(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    """`tree` with every scanned tower, at any depth, in the unrolled
    `<tower>_{i}` layout."""
    out = {k: _unrolled(v) if isinstance(v, Mapping) else v
           for k, v in tree.items()}
    for tower in _TOWERS:
        if f"{tower}_scan" in out:
            out = unstack_encoder_params(out, tower)
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


def _torch_key(path: tuple) -> tuple:
    """JAX param path -> (torch key, transpose?)."""
    parts = [(f"{m.group(1)}.{m.group(2)}" if (m := _LIST_RE.match(p))
              else p) for p in path]
    leaf = parts[-1]
    if len(parts) >= 2 and parts[-2] == "dense" and leaf in ("kernel",
                                                               "bias"):
        return ".".join(parts[:-2] + ["weight" if leaf == "kernel"
                                      else "bias"]), leaf == "kernel"
    if leaf in ("scale", "offset"):
        return ".".join(parts[:-1] + ["weight" if leaf == "scale"
                                      else "bias"]), False
    if leaf in ("ln_scale", "ln_bias"):
        return ".".join(parts[:-1] + ["layer_norm",
                                      "weight" if leaf == "ln_scale"
                                      else "bias"]), False
    if leaf in _EMBED_TABLES:
        return ".".join(parts + ["weight"]), False
    if leaf in _AS_THEY_ARE:
        return ".".join(parts), False
    raise KeyError(f"no rule maps JAX param {'/'.join(path)}")


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (JAX layout) -> port state_dict (CPU
    tensors, dtypes kept)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(_unrolled(params)).items():
        key, transpose = _torch_key(path)
        if key in out:
            raise KeyError(f"two JAX params map to {key}")
        a = np.asarray(arr)
        out[key] = torch.tensor(a.T if transpose else a)
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
