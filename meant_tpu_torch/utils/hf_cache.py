"""Local HuggingFace cache reader and pretrained-weight grafting
(counterpart of meant_tpu/utils/hf_cache.py). Nothing is downloaded.

`resolve_snapshot` finds a model's snapshot directory: a plain directory
holding config.json and weights, or the hub layout
`<root>/models--{org}--{name}/snapshots/<rev>/` (the revision `refs/main`
names, else the newest snapshot), searched under an explicit `cache_dir`,
$HF_HUB_CACHE, $HUGGINGFACE_HUB_CACHE, $HF_HOME/hub and
~/.cache/huggingface/hub. `load_state_dict` reads a sharded index first,
then a single `model.safetensors` or `pytorch_model.bin`. The safetensors
format is read here, with numpy and torch (the `safetensors` package is not
needed): an 8-byte little-endian header length, a JSON header naming each
tensor's dtype, shape and byte range, then the raw bytes; BF16 is read as
uint16 and viewed as torch.bfloat16.

`hf_graft` runs the reference's pretrained-init flows on a model's
state_dict and returns the entries to replace, under the port's keys.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from meant_tpu_torch.utils import port
from meant_tpu_torch.weights import state_dict_from_jax

WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")
SHARD_INDEXES = ("model.safetensors.index.json",
                 "pytorch_model.bin.index.json")
# safetensors dtype names -> (numpy dtype of the raw bytes, torch view)
_SAFETENSORS_DTYPES = {
    "F64": ("<f8", None), "F32": ("<f4", None), "F16": ("<f2", None),
    "BF16": ("<u2", torch.bfloat16), "I64": ("<i8", None),
    "I32": ("<i4", None), "I16": ("<i2", None), "I8": ("i1", None),
    "U8": ("u1", None), "BOOL": ("?", None)}


def _cache_roots(cache_dir: Optional[str]):
    roots = [cache_dir] if cache_dir else []
    for env in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE"):
        if os.environ.get(env):
            roots.append(os.environ[env])
    if os.environ.get("HF_HOME"):
        roots.append(os.path.join(os.environ["HF_HOME"], "hub"))
    roots.append(os.path.expanduser("~/.cache/huggingface/hub"))
    return roots


def _has_weights(d: str) -> bool:
    return any(os.path.exists(os.path.join(d, f))
               for f in WEIGHT_FILES + SHARD_INDEXES)


def _pick_snapshot(model_dir: str) -> Optional[str]:
    snaps = os.path.join(model_dir, "snapshots")
    if not os.path.isdir(snaps):
        return None
    ref = os.path.join(model_dir, "refs", "main")
    if os.path.exists(ref):
        with open(ref) as f:
            d = os.path.join(snaps, f.read().strip())
        if os.path.isdir(d) and _has_weights(d):
            return d
    cands = [os.path.join(snaps, r) for r in sorted(os.listdir(snaps))]
    cands = [d for d in cands if os.path.isdir(d) and _has_weights(d)]
    return max(cands, key=os.path.getmtime) if cands else None


def resolve_snapshot(name_or_dir: str, cache_dir: Optional[str] = None) -> str:
    """A model name ('vinai/bertweet-base') or a directory -> the snapshot
    directory holding config.json and the weights. Raises
    FileNotFoundError naming the searched roots when nothing resolves."""
    if os.path.isdir(name_or_dir):
        if _has_weights(name_or_dir):
            return name_or_dir
        snap = _pick_snapshot(name_or_dir)
        if snap:
            return snap
        raise FileNotFoundError(
            f"{name_or_dir} is a directory but holds no model.safetensors/"
            f"pytorch_model.bin (or hub-layout snapshots)")
    folder = "models--" + name_or_dir.replace("/", "--")
    searched = []
    for root in _cache_roots(cache_dir):
        d = os.path.join(root, folder)
        searched.append(d)
        if os.path.isdir(d):
            snap = _pick_snapshot(d)
            if snap:
                return snap
    raise FileNotFoundError(
        f"no local cache for {name_or_dir}; searched: {searched}. Nothing "
        f"is downloaded: place an HF-layout cache there or pass --hf_cache "
        f"pointing at one.")


def load_config(snap_dir: str) -> dict:
    with open(os.path.join(snap_dir, "config.json")) as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file as a CPU tensor of its dtype;
    the tensors share one buffer of the file's bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        np_dtype, view = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        dt = np.dtype(np_dtype)
        if (end - begin) != dt.itemsize * int(np.prod(info["shape"])):
            raise ValueError(f"{path}: {name} holds {end - begin} bytes for "
                             f"shape {info['shape']} of {info['dtype']}")
        a = np.frombuffer(data, dtype=dt, count=(end - begin) // dt.itemsize,
                          offset=begin)
        if begin % dt.itemsize:
            a = a.copy()                 # torch takes aligned buffers only
        t = torch.from_numpy(a.reshape(info["shape"]))
        out[name] = t.view(view) if view is not None else t
    return out


def _load_weight_file(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_dict(snap_dir: str) -> Dict[str, torch.Tensor]:
    """The snapshot's weights: a sharded index first (every shard merged),
    then a single safetensors or bin file."""
    for index in SHARD_INDEXES:
        ipath = os.path.join(snap_dir, index)
        if os.path.exists(ipath):
            with open(ipath) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            sd = {}
            for shard in shards:
                sd.update(_load_weight_file(os.path.join(snap_dir, shard)))
            return sd
    for fname in WEIGHT_FILES:
        path = os.path.join(snap_dir, fname)
        if os.path.exists(path):
            return _load_weight_file(path)
    raise FileNotFoundError(f"{snap_dir} holds no weight file "
                            f"({WEIGHT_FILES + SHARD_INDEXES})")


def load_pretrained(name_or_dir: str, cache_dir: Optional[str] = None
                    ) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """The no-network `from_pretrained`: (config dict, flat state dict)."""
    snap = resolve_snapshot(name_or_dir, cache_dir)
    return load_config(snap), load_state_dict(snap)


def _strip_prefix(sd: Mapping, prefix: str) -> Dict:
    """Backbone-relative keys: a task-model export carries a prefix
    ('roberta.embeddings...'), a backbone export does not."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    return dict(sd)


def _check_heads(cfg: dict, num_heads: int, name: str) -> int:
    """The cache's head count, which must be the model's: the JAX package
    splits each projection into the cache's heads and Flax then refuses a
    model of another count; the port's (d, d) matrices would load without
    complaint and compute with the model's heads."""
    heads = cfg.get("num_attention_heads", 12)
    if heads != num_heads:
        raise ValueError(f"the cached {name} has {heads} attention heads, "
                         f"the model {num_heads}")
    return heads


def _checked(grafted: Dict[str, torch.Tensor], target: Mapping,
             whole: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """`grafted` after checking it against the model's state_dict: every
    key the model's, every shape equal, and with `whole` every entry under
    that prefix replaced (JAX replaces the subtree whole)."""
    unknown = sorted(set(grafted) - set(target))
    if unknown:
        raise KeyError(f"grafted keys the model lacks: {unknown[:8]}")
    bad = [f"{k}: cache {tuple(v.shape)} vs model {tuple(target[k].shape)}"
           for k, v in grafted.items() if v.shape != target[k].shape]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    if whole is not None:
        missing = sorted(k for k in target
                         if k.startswith(whole) and k not in grafted)
        if missing:
            raise KeyError(f"the cache leaves {missing[:8]} unset")
    return grafted


def hf_graft(model_name: str, target: Mapping[str, torch.Tensor],
             num_encoders: int, num_heads: int,
             cache_dir: Optional[str] = None,
             bertweet: str = "vinai/bertweet-base",
             vilt: str = "dandelin/vilt-b32-mlm",
             visualbert: str = "uclanlp/visualbert-vqa-coco-pre"
             ) -> Dict[str, torch.Tensor]:
    """The reference's pretrained init (`in_loop_train.py:440-507`) on a
    model's state_dict `target`; returns the entries to load over it (CPU
    tensors, the port's keys):

      * bertweet is read first, for every model;
      * `bertweet`: its whole backbone (`bertweet.`);
      * `vilt` / `vl_bert`: their checkpoints (under `vilt.` / `model.`),
        the word-embedding table then replaced by bertweet's;
      * the meant family (a model with an `embedding.`): bertweet's
        embedding.

    A missing cache raises FileNotFoundError; a head count or a shape that
    differs from the model's raises ValueError."""
    bcfg, bsd = load_pretrained(bertweet, cache_dir)
    bsd = _strip_prefix(bsd, "roberta.")
    words = port._t(bsd["embeddings.word_embeddings.weight"])
    if model_name == "bertweet":
        heads = _check_heads(bcfg, num_heads, bertweet)
        tree = port.import_hf_roberta(bsd, num_encoders, num_heads=heads,
                                      prefix="")
        return _checked(state_dict_from_jax({"bertweet": tree}), target,
                        whole="bertweet.")
    if model_name == "vilt":
        vcfg, vsd = load_pretrained(vilt, cache_dir)
        tree = port.import_vilt(_strip_prefix(vsd, "vilt."), num_encoders,
                                num_heads=_check_heads(vcfg, num_heads, vilt))
        tree["text_embeddings"]["word_embeddings"] = words
        return _checked(state_dict_from_jax({"vilt": tree}), target)
    if model_name == "vl_bert":
        vcfg, vsd = load_pretrained(visualbert, cache_dir)
        tree = port.import_visual_bert(
            _strip_prefix(vsd, "visual_bert."), num_encoders,
            num_heads=_check_heads(vcfg, num_heads, visualbert))
        tree["text_embeddings"]["word_embeddings"] = words
        # vl_BERT_Wrapper names its VisualBertModel `model`
        return _checked(state_dict_from_jax({"model": tree}), target)
    if any(k.startswith("embedding.") for k in target):
        tree = port.roberta_embedding_params(bsd, "embeddings.")
        return _checked(state_dict_from_jax({"embedding": tree}), target,
                        whole="embedding.")
    raise ValueError(f"hf_graft has no flow for model {model_name}")
