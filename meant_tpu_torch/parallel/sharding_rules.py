"""Megatron-style tensor-parallel rules over a mesh's 'model' axis
(counterpart of meant_tpu/parallel/sharding_rules.py).

JAX's rules annotate Flax kernels (in, out); XLA inserts the collectives
and differentiates through them. A torch `Linear.weight` is (out, in), so
here:
  * column-parallel (q/k/v/qkv/to_qkv/ff_in/proj_in/intermediate):
    weight dim 0 and the bias sharded;
  * row-parallel (multi_mad/ff_out/proj_out/to_out/output): weight dim 1
    sharded, the bias replicated and added after the sum, on every rank;
  * embeddings: sharded on the vocab axis.
A spec whose sharded dim does not divide replicates, as in JAX.

`param_shardings` gives each parameter's placements; `shard_params` cuts a
state dict to this rank's slices; `parallelize_model` cuts a model's
parameters in place (they keep `requires_grad`) and writes out the
collectives JAX leaves to XLA, as four autograd Functions on the model
axis' group (Megatron's f and g, and their gather / scatter pair):

    copy_in     identity           all_reduce     replicated input of a
                                                  column-parallel layer
    gather_out  all_gather of the  this rank's    after a column-parallel
                features           slice, no sum  layer
    slice_in    this rank's        all_gather of  replicated input of a
                features           the slices     row-parallel layer
    reduce_out  all_reduce         identity       after a row-parallel
                                                  layer or the vocab-
                                                  parallel lookup

Every rank of the model axis computes the same loss from the same
replicated tensors, so the gradient a rank receives at a replicated tensor
is already the whole one: gather_out's adjoint takes its slice without a
sum, reduce_out's passes it on, and only copy_in's (the sum of the ranks'
partial input gradients) and slice_in's (the slices put together)
communicate. A replicated parameter's gradient is the same on every rank of
the axis; a sharded one's is its slice of the whole.

In an attention module whose q, k, v and output projection are all sharded
(XPosAttention, RotaryAttention) the heads stay whole per rank (heads % tp
== 0, else it raises): copy_in runs once on the module's input, q, k, v
stay local with heads / tp heads, the attention (the flash kernels
included) runs on those plain local tensors, and the output projection
takes them as its slice. The vocab-parallel lookup fills the rows this
rank owns, zero elsewhere, and sums them with reduce_out (rows it does not
own get a zero gradient here).

Each parameter `parallelize_model` shards carries the model axis' group as
its `MODEL_GROUP` attribute; FlatAdam reads it to form the global gradient
norm (train/optim.py). Dropout in the replicated parts draws the same mask
on every rank of the model axis as long as the ranks seed their generators
alike (the trainers seed from `seed`).
"""

from __future__ import annotations

import functools
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


MODEL_GROUP = "tensor_parallel_group"


def _gather_features(x: torch.Tensor, group, tp: int) -> torch.Tensor:
    """The ranks' (..., k) slices put together as (..., tp * k)."""
    parts = x.new_empty((tp * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(parts, x.contiguous(), group=group)
    parts = parts.reshape(tp, *x.shape)
    return torch.movedim(parts, 0, -2).reshape(*x.shape[:-1], -1)


def _own_features(x: torch.Tensor, tp: int, r: int) -> torch.Tensor:
    k = x.shape[-1] // tp
    return x.narrow(-1, r * k, k).contiguous()


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, in a new tensor (an in-place collective
    must not overwrite a tensor autograd or a remat policy saved)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tp, r):
        ctx.tp, ctx.r = tp, r
        return _gather_features(x, group, tp)

    @staticmethod
    def backward(ctx, g):
        return _own_features(g, ctx.tp, ctx.r), None, None, None


class _SliceIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tp, r):
        ctx.group, ctx.tp = group, tp
        return _own_features(x, tp, r)

    @staticmethod
    def backward(ctx, g):
        return _gather_features(g, ctx.group, ctx.tp), None, None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x, group):
    """Identity; the gradient summed over `group`."""
    return _CopyIn.apply(x, group)


def gather_out(x, group, tp: int, r: int):
    """The (..., k) features of the group's tp ranks gathered (..., tp *
    k); the gradient's slice r comes back, not summed."""
    return _GatherOut.apply(x, group, tp, r)


def slice_in(x, group, tp: int, r: int):
    """Slice r of the (..., tp * k) features; the gradient's slices are
    gathered back whole."""
    return _SliceIn.apply(x, group, tp, r)


def reduce_out(x, group):
    """The sum over `group`; the gradient passes unchanged."""
    return _ReduceOut.apply(x, group)


class LinearParallel:
    """How one sharded `nn.layers.Linear` meets the replicated tensors
    around it (its `parallel` attribute). Column-parallel: copy_in, the
    local product (bias slice included), gather_out. Row-parallel:
    slice_in (unless its input is already this rank's slice), the local
    product without the bias, reduce_out, then the whole bias."""

    def __init__(self, group, tp: int, r: int, row: bool,
                 local_input: bool = False):
        self.group, self.tp, self.r = group, tp, r
        self.row, self.local_input = row, local_input

    def enter(self, x):
        if self.row:
            return x if self.local_input else slice_in(x, self.group,
                                                       self.tp, self.r)
        return copy_in(x, self.group)

    def leave(self, y):
        if self.row:
            return reduce_out(y, self.group)
        return gather_out(y, self.group, self.tp, self.r)


def _attention_modules(model):
    from meant_tpu_torch.nn.attention_modules import (RotaryAttention,
                                                      XPosAttention)
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (XPosAttention, RotaryAttention))]


def _sharded(module: nn.Module, name: str, t: torch.Tensor, group):
    p = nn.Parameter(t)
    setattr(p, MODEL_GROUP, group)
    setattr(module, name, p)


@torch.no_grad()
def parallelize_model(model: nn.Module, mesh, rules=DEFAULT_TP_RULES):
    """Cut `model`'s parameters to this rank's tensor-parallel slices in
    place and install the collectives (see the module's notes). Every rank
    must hold the same weights first (one seed, or `replicate_tree`). A
    mesh without a 'model' axis leaves the model as it is; on one of size
    1 every rule applies, each slice is the whole and each collective a
    copy. Build the optimizer after this call: the sharded parameters are
    new tensors."""
    from meant_tpu_torch.nn.layers import Linear
    if AXIS not in mesh.mesh_dim_names:
        return model
    tp, r = axis_size(mesh, AXIS), axis_rank(mesh, AXIS)
    group = mesh.get_group(AXIS)
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
            attn.parallel_input = functools.partial(copy_in, group=group)
            local_out |= {f"{name}.{p}" for p in ("q", "k", "v")}
            local_in.add(f"{name}.multi_mad")
    for name, module in model.named_modules():
        shard = shard_of(f"{name}.weight")
        if isinstance(module, Linear) and shard is not None:
            _sharded(module, "weight", _slice(module.weight, shard.dim, tp,
                                              r), group)
            if shard.dim == 0:
                if module.bias is not None:
                    _sharded(module, "bias", _slice(module.bias, 0, tp, r),
                             group)
                if name not in local_out:
                    module.parallel = LinearParallel(group, tp, r, row=False)
            else:
                module.parallel = LinearParallel(
                    group, tp, r, row=True, local_input=name in local_in)
        elif name.endswith("word_embeddings") and shard is not None:
            rows = module.weight.shape[0]
            _sharded(module, "weight", _slice(module.weight, 0, tp, r),
                     group)
            module.vocab_shard = (group, r * (rows // tp), rows)
        elif shard is not None:
            raise NotImplementedError(f"{name}: no tensor-parallel form for "
                                      f"{type(module).__name__}")
    return model
