"""GPipe-style pipeline parallelism over a mesh axis (counterpart of
meant_tpu/parallel/pipeline.py).

A stack of L identical layers is cut over the n stages of a `pipe` axis
(stage s holds layers s * L/n ... (s + 1) * L/n - 1), the batch into m
microbatches, and the activations move one stage along the axis each tick
of JAX's static schedule:

    m + n - 1 ticks; on tick t every stage runs its L/n layers (bubble
    ticks included), stage 0 first takes microbatch t while t < m, and
    stage n - 1 writes output t - (n - 1) once t >= n - 1; then the
    state moves to the next stage.

JAX's `ppermute` is `RingShift` here (ops/ring.py: P2P to rank + 1,
its gradient back to rank - 1), and the last stage's outputs are summed
over the axis by `reduce_out` (parallel/sharding_rules.py), so every rank
returns them whole. The schedule's choices (inject, take, the last-stage
mask on the outputs) are tensor selects, as JAX's `jnp.where`, never
Python branches that differ by stage: every rank builds the same autograd
graph, so every P2P of the backward meets its partner. (A shift whose
output one rank dropped from its graph while another kept it would hang
the backward.) The shift after the last tick, whose state nothing reads,
is not made on any rank.

Without a mesh, `stages` stages are played in one process: each tick runs
every stage in turn, and the shift hands stage s the state stage s - 1
held; the last stage's outputs are the sum. One card or one CPU then runs
the schedule, its kernel launches included (n * L/n layers a tick).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from meant_tpu_torch.ops.ring import RingShift
from meant_tpu_torch.parallel.mesh import (_map, _placements, axis_rank,
                                           axis_size)
from meant_tpu_torch.parallel.sharding_rules import reduce_out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map_n(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_n(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_n(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


def stack_layer_params(param_trees):
    """Per-layer parameter trees (dicts of tensors, or modules, whose named
    parameters are taken) stacked along a new leading 'layer' axis: the
    axis `pipeline_apply` cuts over the stages. Gradients reach the
    per-layer tensors through the stack."""
    trees = [dict(t.named_parameters()) if isinstance(t, nn.Module) else t
             for t in param_trees]
    return _map_n(lambda *xs: torch.stack(xs), *trees)


def _stage_layers(stacked, stage: int, per: int) -> list:
    """Stage `stage`'s layers, one tree each, from each leaf's DTensor
    local part (as `pipeline_stage_shardings` places it) or its rows. Each
    leaf is unbound once, so a layer's gradient accumulates at its own
    size, not the whole stack's, on every tick that runs it."""
    def take(leaf):
        if isinstance(leaf, DTensor):
            local = leaf.to_local()
            if local.shape[0] != per:
                raise ValueError(f"a placed leaf holds {local.shape[0]} "
                                 f"layers a stage, want {per}")
            return local
        return leaf[stage * per:(stage + 1) * per]
    layers = [take(leaf).unbind(0) for leaf in _leaves(stacked)]
    return [_unflatten(stacked, [layer[j] for layer in layers])
            for j in range(per)]


def pipeline_apply(layer_fn: Callable, stacked_params, x, *, mesh=None,
                   axis: str = "pipe", microbatches: Optional[int] = None,
                   stages: Optional[int] = None):
    """Run x through L stacked layers pipelined over the `axis` stages.

    layer_fn(params_i, x) -> x applies ONE layer (for example through
    `torch.func.functional_call`); `stacked_params` leaves have a leading
    layer axis L divisible by the stage count (each stage runs its L/n
    layers and takes gradients for those only). x: a (B, ...) tensor or a
    tree of such tensors, e.g. (hidden, attention_mask), which layer_fn
    returns in the same structure (a leaf that needs no gradient, such as
    the mask, travels without one); B must divide into the microbatches
    (default: the stage count). With `mesh`, this rank plays its stage of
    `axis` over P2P; without one, `stages` stages are played in this
    process (the module's notes). Returns the output whole, in x's
    structure, on every rank."""
    if mesh is not None:
        n = axis_size(mesh, axis)
        group = mesh.get_group(axis)
        positions = [axis_rank(mesh, axis)]

        def shift(states):
            if n == 1:      # the ring of one stage hands it its own state
                return states
            (s, tree), = states.items()
            moved = RingShift.apply(group, *_leaves(tree))
            return {s: _unflatten(tree, moved)}

        def total(parts):
            (tree,) = parts
            return _map(lambda o: reduce_out(o, group), tree)
    else:
        if not stages:
            raise ValueError("pipeline_apply takes a mesh, or the number of "
                             "stages to play in this process")
        n = stages
        positions = list(range(n))

        def shift(states):
            return {s: states[(s - 1) % n] for s in positions}

        def total(parts):
            return _map_n(lambda *o: sum(o[1:], o[0]), *parts)
    m = microbatches or n
    B = _leaves(x)[0].shape[0]
    if B % m:
        raise ValueError(f"batch {B} does not divide into {m} microbatches")
    L = _leaves(stacked_params)[0].shape[0]     # a DTensor's: global
    if L % n:
        raise ValueError(f"{L} layers do not divide over {n} stages")
    per = L // n
    micro = _map(lambda a: a.reshape(m, B // m, *a.shape[1:]), x)
    device = _leaves(x)[0].device
    flag = (torch.tensor(False, device=device),
            torch.tensor(True, device=device))
    local = {s: _stage_layers(stacked_params, s, per) for s in positions}
    states = {s: _map(lambda a: torch.zeros_like(a[0]), micro)
              for s in positions}
    outs = {s: [_map(lambda a: torch.zeros_like(a[0]), micro)
                for _ in range(m)] for s in positions}
    for t in range(m + n - 1):
        inject = _map(lambda a: a[min(t, m - 1)], micro)
        idx = min(max(t - (n - 1), 0), m - 1)
        for s in positions:
            put = flag[s == 0 and t < m]
            state = _map_n(lambda i, c: torch.where(put, i, c), inject,
                           states[s])
            for params in local[s]:
                state = layer_fn(params, state)
            take = flag[s == n - 1 and t >= n - 1]
            outs[s][idx] = _map_n(lambda c, o: torch.where(take, c, o),
                                  state, outs[s][idx])
            states[s] = state
        if t < m + n - 2:
            states = shift(states)
    parts = []
    for s in positions:
        last = flag[s == n - 1]
        stacked = _map_n(lambda *o: torch.stack(o), *outs[s])
        parts.append(_map(lambda o: torch.where(last, o,
                                                torch.zeros_like(o)),
                          stacked))
    return _map_n(lambda o, a: o.reshape(B, *a.shape[1:]), total(parts), x)


def pipeline_stage_shardings(stacked_params, mesh, axis: str = "pipe"):
    """Placements (one per mesh axis) putting each leaf's leading layer
    axis over the pipe stages: `distribute_tensor(leaf, mesh, placements)`
    leaves each rank its stage's layers, which `pipeline_apply` takes as
    they are."""
    return _map(lambda _: _placements(mesh, axis, Shard(0)), stacked_params)
