"""Megatron-style tensor-parallel rules over a mesh's 'model' axis
(counterpart of meant_tpu/parallel/sharding_rules.py).

JAX's rules annotate Flax kernels (in, out); XLA inserts the collectives. A
torch `Linear.weight` is (out, in), so here:
  * column-parallel (q/k/v/qkv/to_qkv/ff_in/proj_in/intermediate):
    weight dim 0 and the bias sharded;
  * row-parallel (multi_mad/ff_out/proj_out/to_out/output): weight dim 1
    sharded, the bias added once (by the axis' rank 0, before the sum);
  * embeddings: sharded on the vocab axis.
A spec whose sharded dim does not divide replicates, as in JAX.

`param_shardings` gives each parameter's placements; `shard_params` cuts a
state dict to this rank's slices; `parallelize_model` (the Predictor's
`tensor_parallel=True`) cuts a model's parameters in place and writes out
the collectives JAX leaves to XLA: a column-parallel layer all-gathers its
output features, a row-parallel one takes its slice of the input features
and all-reduces its output, and a vocab-parallel lookup all-reduces rows
that only the owning rank fills. In an attention module whose q, k, v and
output projection are all sharded (XPosAttention, RotaryAttention) the
heads stay whole per rank (heads % tp == 0, else it raises): q, k, v stay
local with heads / tp heads, the attention (the flash kernels included)
runs on those plain local tensors, and the output projection takes them
as its slice. Inference only: the collectives carry no gradient.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from meant_tpu_torch.parallel.mesh import axis_rank, axis_size

# (name regex, placement on the 'model' axis); the rest replicates
DEFAULT_TP_RULES: Sequence[Tuple[str, object]] = (
    # column-parallel: the OUTPUT features (TimeSformer's fused to_qkv
    # included; heads stay whole per shard when heads % tp == 0)
    (r"\b(q|k|v|qkv|to_qkv|ff_in|proj_in|intermediate)\b.*\b(weight|bias)$",
     Shard(0)),
    # row-parallel: the INPUT features
    (r"\b(multi_mad|ff_out|proj_out|to_out|output)\b.*\bweight$", Shard(1)),
    # embeddings: vocab axis
    (r"word_embeddings\.weight$", Shard(0)),
)
AXIS = "model"


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_shardings(params, mesh, rules=DEFAULT_TP_RULES) -> dict:
    """{name: placements (one per mesh axis)} for a module's parameters or
    a state dict: the first matching rule on the 'model' axis, where its
    dim divides; otherwise replicated. Without a 'model' axis everything
    replicates; on one of size 1 the rules still place their shards (each
    the whole tensor), so the layout runs with trivial collectives."""
    names = mesh.mesh_dim_names
    tp = axis_size(mesh, AXIS) if AXIS in names else 0

    def spec_for(name: str, t: torch.Tensor):
        for pattern, placement in rules if tp else ():
            if re.search(pattern, name):
                if (placement.dim < t.dim()
                        and t.shape[placement.dim] % tp == 0):
                    return tuple(placement if a == AXIS else Replicate()
                                 for a in names)
                break
        return tuple(Replicate() for _ in names)
    return {name: spec_for(name, t) for name, t in _named(params).items()}


def _model_shard(placements, mesh):
    if AXIS not in mesh.mesh_dim_names:
        return None
    p = placements[mesh.mesh_dim_names.index(AXIS)]
    return p if isinstance(p, Shard) else None


def _slice(t: torch.Tensor, dim: int, tp: int, r: int) -> torch.Tensor:
    k = t.shape[dim] // tp
    return t.narrow(dim, r * k, k).contiguous()


def shard_params(params, mesh, rules=DEFAULT_TP_RULES) -> dict:
    """This rank's slice of each tensor of a state dict (or a module's
    parameters) under `param_shardings`."""
    tp, r = axis_size(mesh, AXIS), axis_rank(mesh, AXIS)
    out = {}
    for name, t in _named(params).items():
        shard = _model_shard(param_shardings({name: t}, mesh, rules)[name],
                             mesh)
        out[name] = t if shard is None else _slice(t, shard.dim, tp, r)
    return out


class _Collective:
    """The hooks of one sharded Linear on the model axis' group."""

    def __init__(self, group, tp: int, r: int):
        self.group, self.tp, self.r = group, tp, r

    def gather_features(self, module, args, out):
        parts = out.new_empty((self.tp * out.shape[0], *out.shape[1:]))
        dist.all_gather_into_tensor(parts, out.contiguous(),
                                    group=self.group)
        parts = parts.reshape(self.tp, *out.shape)
        return torch.movedim(parts, 0, -2).reshape(*out.shape[:-1], -1)

    def slice_features(self, module, args):
        x = args[0]
        k = x.shape[-1] // self.tp
        return (x[..., self.r * k:(self.r + 1) * k], *args[1:])

    def reduce(self, module, args, out):
        dist.all_reduce(out, group=self.group)
        return out


def _attention_modules(model):
    from meant_tpu_torch.nn.attention_modules import (RotaryAttention,
                                                      XPosAttention)
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (XPosAttention, RotaryAttention))]


@torch.no_grad()
def parallelize_model(model: nn.Module, mesh, rules=DEFAULT_TP_RULES):
    """Cut `model`'s parameters to this rank's tensor-parallel slices in
    place and install the collectives (see the module's notes). A mesh
    without a 'model' axis leaves the model as it is; on one of size 1
    every rule applies, each slice is the whole and each collective a
    copy."""
    from meant_tpu_torch.nn.layers import Linear
    if AXIS not in mesh.mesh_dim_names:
        return model
    tp, r = axis_size(mesh, AXIS), axis_rank(mesh, AXIS)
    hooks = _Collective(mesh.get_group(AXIS), tp, r)
    specs = param_shardings(model, mesh, rules)

    def shard_of(name):
        return _model_shard(specs[name], mesh) if name in specs else None

    local_in, local_out = set(), set()
    for name, attn in _attention_modules(model):
        qkv = [shard_of(f"{name}.{p}.weight") for p in ("q", "k", "v")]
        out = shard_of(f"{name}.multi_mad.weight")
        if all(s is not None and s.dim == 0 for s in qkv) and \
                out is not None and out.dim == 1:
            if attn.num_heads % tp:
                raise ValueError(f"{name}: {attn.num_heads} heads do not "
                                 f"split over {tp} tensor-parallel ranks")
            attn.num_heads //= tp
            local_out |= {f"{name}.{p}" for p in ("q", "k", "v")}
            local_in.add(f"{name}.multi_mad")
    for name, module in model.named_modules():
        weight = f"{name}.weight"
        shard = shard_of(weight)
        if isinstance(module, Linear) and shard is not None:
            module.weight = nn.Parameter(_slice(module.weight, shard.dim, tp,
                                                r), requires_grad=False)
            if shard.dim == 0:
                if module.bias is not None:
                    module.bias = nn.Parameter(_slice(module.bias, 0, tp, r),
                                               requires_grad=False)
                if name not in local_out:
                    module.register_forward_hook(hooks.gather_features)
            else:
                if module.bias is not None and r:
                    module.bias.zero_()
                if name not in local_in:
                    module.register_forward_pre_hook(hooks.slice_features)
                module.register_forward_hook(hooks.reduce)
        elif name.endswith("word_embeddings") and shard is not None:
            rows = module.weight.shape[0]
            module.weight = nn.Parameter(_slice(module.weight, 0, tp, r),
                                         requires_grad=False)
            module.vocab_shard = (hooks.group, r * (rows // tp), rows)
        elif shard is not None:
            raise NotImplementedError(f"{name}: no tensor-parallel form for "
                                      f"{type(module).__name__}")
    return model

